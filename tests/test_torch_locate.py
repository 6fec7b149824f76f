"""
The port's point location, point candidate join, segment clip and
barycentric (mean-value) weights (``spatial/celltree.py``,
``spatial/grid_hash.py``) held on the CPU against the JAX package's.

``locate_points`` has two paths: the fused native scan, and the
candidate join (``query_points``) plus the exact point-in-polygon test,
taken when the grid hash holds oversize faces, which bypass its bins.
Both must give the lowest-index face holding each point.  Indices are
held exactly, weights at rtol 1e-12.
"""

import numpy as np
import pytest

import chip_smoke
import xugrid_tpu as xu
import xugrid_tpu_torch as xt
from xugrid_tpu_torch.regrid.unstructured import UnstructuredGrid2d
from xugrid_tpu_torch.utils import native


def meshes():
    """A jittered 16 x 16 quad mesh, the same with one 40 x 40 face
    appended (last) and prepended (first), and a Delaunay triangle mesh."""
    (verts, faces), _ = chip_smoke.bench_meshes(16, 2, np.random.default_rng(8))
    big = np.array([[-12.0, -12.0], [28.0, -12.0], [28.0, 28.0], [-12.0, 28.0]])
    verts_big = np.concatenate([verts, big])
    big_face = len(verts) + np.arange(4)[None, :]
    nodes, tris = chip_smoke.delaunay_mesh(12, seed=3)
    return {
        "quads": (verts, faces),
        "big_last": (verts_big, np.concatenate([faces, big_face])),
        "big_first": (verts_big, np.concatenate([big_face, faces])),
        "delaunay": (nodes / 100.0 * 16.0, tris),
    }


MESHES = meshes()


def points(verts, faces, rng):
    """Random points over and beyond the mesh, its nodes, its edge
    midpoints and points just off them."""
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    pad = 0.1 * (hi - lo)
    random = rng.uniform(lo - pad, hi + pad, (400, 2))
    mids = 0.5 * (verts[faces[:, 0]] + verts[faces[:, 1]])
    return np.concatenate([random, verts, mids, mids + 1e-13, [[np.nan, 0.5]]])


def grids(name):
    verts, faces = MESHES[name]
    return (xu.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces), xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces))


@pytest.mark.parametrize("tolerance", [None, 1e-6])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_locate_points_matches_jax(name, tolerance):
    jgrid, tgrid = grids(name)
    pts = points(*MESHES[name], np.random.default_rng(1))
    want = jgrid.celltree.locate_points(pts, tolerance)
    got = tgrid.locate_points(pts, tolerance)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() > 300
    if name.startswith("big"):
        # The oversize face sends every point to the candidate path.
        assert len(tgrid.celltree.grid_hash.oversize) == 1
        assert native.locate_points_hash_native(pts, 0.0, tgrid.celltree.grid_hash, tgrid.celltree._poly_xy_host) is None


@pytest.mark.parametrize("name", ["quads", "delaunay"])
def test_locate_points_paths_agree(name, monkeypatch):
    """The candidate path gives what the fused scan gives."""
    _, tgrid = grids(name)
    pts = points(*MESHES[name], np.random.default_rng(2))
    fused = tgrid.locate_points(pts)
    monkeypatch.setattr(native, "locate_points_hash_native", lambda *args: None)
    np.testing.assert_array_equal(tgrid.locate_points(pts), fused)


def test_big_face_takes_the_lowest_index():
    pts = points(*MESHES["quads"], np.random.default_rng(3))
    inner = grids("quads")[1].locate_points(pts)
    last = grids("big_last")[1].locate_points(pts)
    first = grids("big_first")[1].locate_points(pts)
    inside_big = (np.abs(pts - 8.0) < 20.0).all(axis=1)
    np.testing.assert_array_equal(last, np.where(inner >= 0, inner, np.where(inside_big, 256, -1)))
    np.testing.assert_array_equal(first, np.where(inside_big, 0, -1))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_query_points_matches_jax(name):
    jgrid, tgrid = grids(name)
    pts = points(*MESHES[name], np.random.default_rng(4))
    tol = 1e-9
    want = jgrid.celltree.grid_hash.query_points(pts, tol)
    got = tgrid.celltree.grid_hash.query_points(pts, tol)
    assert sorted(zip(*got)) == sorted(zip(*want))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_compute_barycentric_weights_matches_jax(name):
    jgrid, tgrid = grids(name)
    pts = points(*MESHES[name], np.random.default_rng(5))
    jface, jweights = jgrid.compute_barycentric_weights(pts)
    tface, tweights = tgrid.compute_barycentric_weights(pts)
    np.testing.assert_array_equal(tface, jface)
    np.testing.assert_allclose(tweights, jweights, rtol=1e-12, atol=0)
    # A new array, safe to write (the barycentric join zeroes rows in it).
    assert tweights.flags.writeable and tweights.flags.owndata
    inside = tface >= 0
    np.testing.assert_allclose(tweights[inside].sum(axis=1), 1.0, rtol=0, atol=1e-12)
    assert (tweights[~inside] == 0).all()


def test_barycentric_weights_survive_a_rotation():
    """Weights belong to vertices: rotating the vertex order of every
    tessellation polygon (as a rounding of the angle sort near +-pi may
    do) moves each weight with its vertex and changes it at most in the
    last bits."""
    _, tgrid = grids("quads")
    tess, *_ = UnstructuredGrid2d(tgrid)._voronoi_support("cpu")
    conn = tess.face_node_connectivity
    rng = np.random.default_rng(6)
    rotated = np.full_like(conn, -1)
    for i, row in enumerate(conn):
        ids = row[row >= 0]
        rotated[i, : len(ids)] = np.roll(ids, rng.integers(0, len(ids)))
    other = xt.Ugrid2d(tess.node_x, tess.node_y, -1, rotated)
    pts = rng.uniform(0.0, 16.0, (500, 2))
    face, weights = tess.compute_barycentric_weights(pts)
    face_r, weights_r = other.compute_barycentric_weights(pts)
    np.testing.assert_array_equal(face_r, face)
    hit = face >= 0
    by_vertex = lambda c, f, w: {  # noqa: E731
        (p, int(v)): w[p, k] for p in np.flatnonzero(hit) for k, v in enumerate(c[f[p]]) if v >= 0
    }
    a, b = by_vertex(conn, face, weights), by_vertex(rotated, face_r, weights_r)
    assert a.keys() == b.keys()
    np.testing.assert_allclose([b[k] for k in a], [a[k] for k in a], rtol=1e-12, atol=1e-15)


def test_intersect_edges_matches_jax():
    jgrid, tgrid = grids("quads")
    nodes, edges = chip_smoke.random_network(4, 60, 16.0, np.random.default_rng(7))
    segments = nodes[edges]
    want = jgrid.celltree.intersect_edges(segments)
    got = tgrid.celltree.intersect_edges(segments)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) > len(edges)


def test_exact_geometry_needs_the_native_library(monkeypatch):
    _, tgrid = grids("big_last")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    with pytest.raises(RuntimeError, match="native host library"):
        tgrid.locate_points(np.array([[1.5, 1.5]]))
    with pytest.raises(RuntimeError, match="native host library"):
        tgrid.celltree.intersect_edges(np.array([[[0.5, 0.5], [3.5, 2.5]]]))
