"""
The port's connectivity (xugrid_tpu_torch.ugrid.connectivity) and the
Ugrid2d members the Laplace fill reads, held on the CPU against the JAX
package's Ugrid2d on seeded quad, triangle and mixed (fill-padded)
meshes: integer connectivity exactly, centroids and inverse-distance
weights at rtol 1e-12.
"""

import numpy as np
import pytest
from scipy.spatial import Delaunay

import xugrid_tpu as xu
import xugrid_tpu_torch as xt
from xugrid_tpu.ugrid import connectivity as jax_connectivity
from xugrid_tpu_torch.ugrid import connectivity


def quad_mesh(n, seed):
    """n x n jittered quads."""
    rng = np.random.default_rng(seed)
    x = np.arange(n + 1.0)
    yy, xx = np.meshgrid(x, x, indexing="ij")
    verts = np.column_stack([xx.ravel(), yy.ravel()]) + rng.uniform(-0.2, 0.2, ((n + 1) ** 2, 2))
    j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    nid = lambda ii, jj: jj * (n + 1) + ii  # noqa: E731
    faces = np.stack([nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)], -1).reshape(-1, 4)
    return verts, faces


def triangle_mesh(n_points, seed):
    rng = np.random.default_rng(seed)
    verts = rng.uniform(0.0, 10.0, (n_points, 2))
    return verts, Delaunay(verts).simplices.astype(np.int64)


def mixed_mesh(n, seed):
    """Quads with every third one split into two triangles, padded to
    four columns with -1."""
    verts, quads = quad_mesh(n, seed)
    split = np.arange(len(quads)) % 3 == 0
    tri_a = np.column_stack([quads[split][:, [0, 1, 2]], np.full(split.sum(), -1)])
    tri_b = np.column_stack([quads[split][:, [0, 2, 3]], np.full(split.sum(), -1)])
    return verts, np.concatenate([quads[~split], tri_a, tri_b])


def separate_triangles():
    """Two triangles sharing no edge: every edge borders one face, so
    the inverted face-edge table has a single column."""
    verts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [3.0, 0.0], [4.0, 0.0], [3.0, 1.0]])
    return verts, np.array([[0, 1, 2], [3, 4, 5]])


MESHES = {
    "quad": lambda: quad_mesh(9, 1),
    "triangle": lambda: triangle_mesh(150, 2),
    "mixed": lambda: mixed_mesh(8, 3),
    "separate": separate_triangles,
}


@pytest.fixture(scope="module", params=sorted(MESHES))
def grids(request):
    verts, faces = MESHES[request.param]()
    return (
        xu.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces, name="mesh"),
        xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces, name="mesh"),
    )


def assert_same_csr(got, want, rtol=0.0):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    if rtol:
        np.testing.assert_allclose(got.data, want.data, rtol=rtol, atol=0.0)
    else:
        np.testing.assert_array_equal(got.data, want.data)


def test_dimensions_and_sizes(grids):
    jg, tg = grids
    assert (tg.node_dimension, tg.edge_dimension, tg.face_dimension) == (
        jg.node_dimension, jg.edge_dimension, jg.face_dimension,
    )
    assert (tg.n_node, tg.n_edge, tg.n_face) == (jg.n_node, jg.n_edge, jg.n_face)


@pytest.mark.parametrize(
    "member", ["edge_node_connectivity", "face_edge_connectivity", "edge_face_connectivity"]
)
def test_dense_connectivity_matches(grids, member):
    jg, tg = grids
    got, want = getattr(tg, member), getattr(jg, member)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("member", ["face_face_connectivity", "node_node_connectivity"])
def test_sparse_connectivity_matches(grids, member):
    jg, tg = grids
    assert_same_csr(getattr(tg, member), getattr(jg, member))


def test_centroids_match(grids):
    jg, tg = grids
    np.testing.assert_allclose(tg.centroids, jg.centroids, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("xy_weights", [False, True])
@pytest.mark.parametrize("dim", ["node", "face"])
def test_connectivity_matrix_matches(grids, dim, xy_weights):
    jg, tg = grids
    got = tg.get_connectivity_matrix(getattr(tg, f"{dim}_dimension"), xy_weights=xy_weights)
    want = jg.get_connectivity_matrix(getattr(jg, f"{dim}_dimension"), xy_weights=xy_weights)
    assert_same_csr(got, want, rtol=1e-12 if xy_weights else 0.0)
    with pytest.raises(ValueError, match="Expected"):
        tg.get_connectivity_matrix(tg.edge_dimension, xy_weights=xy_weights)


def test_prior_edge_numbering_is_kept():
    verts, faces = mixed_mesh(5, 4)
    edges = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces).edge_node_connectivity
    prior = edges[np.random.default_rng(0).permutation(len(edges))][:, ::-1]
    jg = xu.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces, edge_node_connectivity=prior)
    tg = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces, edge_node_connectivity=prior)
    np.testing.assert_array_equal(tg.edge_node_connectivity, prior)
    np.testing.assert_array_equal(tg.face_edge_connectivity, jg.face_edge_connectivity)
    with pytest.raises(ValueError, match="Invalid edge_node_connectivity"):
        xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces, edge_node_connectivity=prior[1:]).face_edge_connectivity


@pytest.mark.parametrize("sort_indices", [True, False])
def test_dense_sparse_conversions_match(sort_indices):
    _, faces = mixed_mesh(6, 5)
    assert_same_csr(
        connectivity.to_sparse(faces, sort_indices), jax_connectivity.to_sparse(faces, sort_indices)
    )
    assert_same_csr(
        connectivity.invert_dense_to_sparse(faces, sort_indices),
        jax_connectivity.invert_dense_to_sparse(faces, sort_indices),
    )
    np.testing.assert_array_equal(
        connectivity.invert_dense(faces, sort_indices), jax_connectivity.invert_dense(faces, sort_indices)
    )
    sparse = connectivity.to_sparse(faces, sort_indices)
    np.testing.assert_array_equal(connectivity.to_dense(sparse), jax_connectivity.to_dense(sparse))
    np.testing.assert_array_equal(
        connectivity.to_dense(sparse.tocoo(), n_columns=6), jax_connectivity.to_dense(sparse.tocoo(), n_columns=6)
    )
    with pytest.raises(ValueError, match="too small"):
        connectivity.to_dense(sparse, n_columns=2)


def test_centroid_fallback_matches_native(monkeypatch):
    from xugrid_tpu_torch.utils import native

    verts, faces = mixed_mesh(6, 6)
    with_lib = connectivity.centroids(faces, verts[:, 0], verts[:, 1])
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    without = connectivity.centroids(faces, verts[:, 0], verts[:, 1])
    np.testing.assert_allclose(without, with_lib, rtol=1e-12, atol=1e-12)
