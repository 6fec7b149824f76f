"""
Faces above the native host kernels' sizes, and regridders made from
weights without a method, held on the CPU against the JAX package.

The native overlap clip gathering tree faces from the connectivity takes
tree faces of at most 32 nodes; the clip over padded buffers takes
polygons of at most 96 nodes together; the native mean-value weights
take faces of at most 64 nodes.  Above those sizes the JAX package runs
its device kernels (here on the CPU) and the port its batched torch
geometry (``spatial/geometry.py``), here with ``device="cpu"``: weights
agree within 1e-12 relative, areas as set out below.  Faces of 33-48
nodes beside quads
take the padded native clip in both packages: bit-equal.

The port's torch geometry runs the JAX geometry's arithmetic in the
same order: against ``xugrid_tpu/spatial/geometry.py`` evaluated op by op
(``jax.vmap`` outside ``jit``) it is bit-equal.  The JAX package's
jitted kernel is not: XLA's fused kernel rounds differently, up to
1.07e-12 absolute on an area of 0.4 against its own op-by-op value on
these meshes, so the regridders' areas are held at rtol 1e-12 with an
atol of 2e-12 (areas of order 1 on an [0, 8]^2 domain).
"""

import numpy as np
import pytest
import torch

import xugrid_tpu as xu
import xugrid_tpu_torch as xt
from tests.test_torch_regrid import quad_mesh
from xugrid_tpu_torch.spatial import celltree as torch_celltree
from xugrid_tpu_torch.spatial import geometry
from xugrid_tpu_torch.utils import native


def regular_polygon(n, center, radius, phase=0.1):
    angle = phase + 2.0 * np.pi * np.arange(n) / n
    return np.column_stack([center[0] + radius * np.cos(angle), center[1] + radius * np.sin(angle)])


def mesh_with_faces(sizes):
    """8 x 8 unit quads on [0, 8]^2 plus one regular polygon per entry of
    ``sizes`` ((n_nodes, center, radius)), padded with -1."""
    verts, quads = quad_mesh(8, 8)
    n_max = max([4] + [n for n, _, _ in sizes])
    faces = [np.pad(quads, ((0, 0), (0, n_max - 4)), constant_values=-1)]
    nodes = [verts]
    offset = len(verts)
    for n, center, radius in sizes:
        nodes.append(regular_polygon(n, center, radius))
        faces.append(np.pad(offset + np.arange(n), (0, n_max - n), constant_values=-1)[None, :])
        offset += n
    nodes = np.concatenate(nodes)
    return nodes, np.concatenate(faces)


OVERCAP = [(40, (2.0, 2.0), 1.2), (120, (5.5, 5.5), 1.5)]
PADDED_ONLY = [(40, (2.0, 2.0), 1.2), (45, (5.5, 5.5), 1.5)]


def grids(nodes, faces):
    return (xu.Ugrid2d(nodes[:, 0], nodes[:, 1], -1, faces), xt.Ugrid2d(nodes[:, 0], nodes[:, 1], -1, faces))


def raster_grids(n=7):
    verts, faces = quad_mesh(n, n, dx=8.0 / n)
    verts = verts + 0.013
    return grids(verts, faces)


def assert_triplets_close(tw, jw, rtol, atol=0.0):
    assert (tw.n, tw.m, tw.nnz) == (jw.n, jw.m, jw.nnz) and tw.nnz > 0
    np.testing.assert_array_equal(tw.indptr, jw.indptr)
    np.testing.assert_array_equal(tw.indices, jw.indices)
    np.testing.assert_allclose(tw.data, jw.data, rtol=rtol, atol=atol)


def candidate_pairs(tree_grid, query_grid):
    from xugrid_tpu_torch.spatial.bvh import face_bounding_boxes

    boxes = face_bounding_boxes(query_grid.face_node_connectivity, query_grid.node_x, query_grid.node_y)
    return tree_grid.celltree.grid_hash.query_boxes(boxes)


@pytest.mark.parametrize("over_cap", ["tree", "query"])
def test_overlap_geometry_equals_jax_op_by_op(over_cap):
    import jax
    import jax.numpy as jnp

    from xugrid_tpu.spatial import geometry as jax_geometry

    _, mesh = grids(*mesh_with_faces(OVERCAP))
    _, raster = raster_grids()
    tree, query = (mesh, raster) if over_cap == "tree" else (raster, mesh)
    qi, ti = candidate_pairs(tree, query)
    subject = geometry.pad_polygons(query.face_node_connectivity, query.node_x, query.node_y)[qi]
    clip = tree.celltree._poly_xy_host[ti]
    got = geometry.convex_overlap_areas(torch.from_numpy(subject), torch.from_numpy(clip)).numpy()
    want = np.asarray(jax.vmap(jax_geometry.convex_overlap_area)(jnp.asarray(subject), jnp.asarray(clip)))
    assert (got > 0).sum() > 50
    np.testing.assert_array_equal(got, want)


def test_mean_value_geometry_equals_jax_op_by_op():
    import jax
    import jax.numpy as jnp

    from xugrid_tpu.spatial import geometry as jax_geometry

    nodes, faces = mesh_with_faces(OVERCAP)
    _, mesh = grids(nodes, faces)
    points = np.concatenate([np.random.default_rng(1).uniform(0.5, 7.5, (200, 2)), nodes[-120:][:4]])
    face = mesh.locate_points(points)
    polys = mesh.celltree._poly_xy_host[np.maximum(face, 0)]
    tol = mesh.celltree.default_tolerance()
    got = geometry.mean_value_weights(torch.from_numpy(points), torch.from_numpy(polys), tol).numpy()
    want = np.asarray(
        jax.vmap(lambda p, q: jax_geometry.mean_value_weights(p, q, tol))(jnp.asarray(points), jnp.asarray(polys))
    )
    # The normalising sum of up to 120 terms runs in another order: one
    # ulp of a weight at most.
    np.testing.assert_allclose(got, want, rtol=0, atol=2.3e-16)


@pytest.mark.parametrize("over_cap", ["source", "target"])
@pytest.mark.parametrize("cls", ["OverlapRegridder", "RelativeOverlapRegridder"])
def test_overlap_above_the_native_caps_matches_jax(cls, over_cap, monkeypatch):
    """A 40-node and a 120-node face: every native clip declines by size;
    both packages compute on the device path, the port in torch."""
    mesh = grids(*mesh_with_faces(OVERCAP))
    raster = raster_grids()
    src, tgt = (mesh, raster) if over_cap == "source" else (raster, mesh)
    calls = []
    device_path = torch_celltree.overlap_areas_device
    monkeypatch.setattr(
        torch_celltree, "overlap_areas_device", lambda *a, **k: calls.append(1) or device_path(*a, **k)
    )
    jr = getattr(xu, cls)(src[0], tgt[0])
    tr = getattr(xt, cls)(src[1], tgt[1], device="cpu")
    assert calls, "the device geometry did not run"
    assert_triplets_close(tr._weights, jr._weights, rtol=1e-12, atol=2e-12)


def test_overlap_padded_native_tier_matches_jax(monkeypatch):
    """40- and 45-node faces beside quads: the connectivity clip declines,
    the padded clip takes them, bit-equal to the JAX package's."""
    mesh = grids(*mesh_with_faces(PADDED_ONLY))
    raster = raster_grids()
    monkeypatch.setattr(torch_celltree, "overlap_areas_device", None)  # must not be reached
    jr = xu.OverlapRegridder(mesh[0], raster[0])
    tr = xt.OverlapRegridder(mesh[1], raster[1])
    assert_triplets_close(tr._weights, jr._weights, rtol=0)


def test_overlap_areas_of_a_regular_polygon():
    """The device geometry's areas against closed forms: a quad inside
    the 120-gon, the 120-gon inside a large square, and disjoint pairs."""
    poly = regular_polygon(120, (0.0, 0.0), 2.0)
    square = np.array([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]])
    big = 10.0 * square
    pad = lambda p, n: np.concatenate([p, np.repeat(p[:1], n - len(p), axis=0)])  # noqa: E731
    subject = torch.from_numpy(np.stack([pad(square, 120), poly, pad(square + 9.0, 120)]))
    clip = torch.from_numpy(np.stack([poly, pad(big, 120), poly]))
    areas = geometry.convex_overlap_areas(subject, clip).numpy()
    polygon_area = 0.5 * 120 * 4.0 * np.sin(2.0 * np.pi / 120)
    np.testing.assert_allclose(areas, [1.0, polygon_area, 0.0], rtol=1e-12, atol=1e-14)


def test_mean_value_weights_above_the_native_cap_match_jax():
    """Points in the 40- and 120-node faces and in quads: the 120-node
    face makes the native kernel decline for every point."""
    nodes, faces = mesh_with_faces(OVERCAP)
    jgrid, tgrid = grids(nodes, faces)
    rng = np.random.default_rng(4)
    centers = np.array([[2.0, 2.0], [5.5, 5.5], [0.5, 7.5]])
    points = np.concatenate([c + rng.uniform(-0.8, 0.8, (20, 2)) * [[1.0, 1.0]] for c in centers])
    points = np.concatenate([points, nodes[-120:][:3], [[20.0, 20.0]]])  # on vertices; outside
    assert native.mean_value_weights_native(points, np.zeros(len(points), np.int64), np.zeros((1, 120, 2)), 0.0) is None
    jface, jw = jgrid.compute_barycentric_weights(points)
    tface, tw = tgrid.compute_barycentric_weights(points, device="cpu")
    np.testing.assert_array_equal(tface, jface)
    np.testing.assert_allclose(tw, np.asarray(jw), rtol=1e-12, atol=1e-15)
    inside = tface >= 0
    np.testing.assert_allclose(tw[inside].sum(axis=1), 1.0, rtol=0, atol=1e-12)
    assert not tw[~inside].any()


def fan_mesh(n_fan=72):
    """A disk of radius 2 about (4, 4) fanned into ``n_fan`` triangles
    about its centre node, inside a ring of 8 x 8 unit quads cut away
    there: the centroidal voronoi cell about the centre node has
    ``n_fan`` nodes."""
    ring = regular_polygon(n_fan, (4.0, 4.0), 2.0, phase=0.0)
    nodes = np.concatenate([[[4.0, 4.0]], ring])
    tri = np.column_stack([np.zeros(n_fan, int), 1 + np.arange(n_fan), 1 + (np.arange(n_fan) + 1) % n_fan])
    return nodes, tri


def test_barycentric_interpolator_above_the_native_cap_matches_jax():
    nodes, tri = fan_mesh()
    jsource, tsource = grids(nodes, tri)
    tverts, tfaces = quad_mesh(6, 6, dx=0.5)
    jtarget, ttarget = grids(tverts + 2.5, tfaces)
    jr = xu.BarycentricInterpolator(jsource, jtarget)
    tr = xt.BarycentricInterpolator(tsource, ttarget, device="cpu")
    assert_triplets_close(tr._weights, jr._weights, rtol=1e-12)


def test_missing_library_still_raises(monkeypatch):
    """Only a decline by size takes the device path: without the native
    library the exact geometry raises."""
    nodes, faces = mesh_with_faces(OVERCAP)
    _, mesh = grids(nodes, faces)
    _, raster = raster_grids()
    mesh.celltree, raster.celltree  # build the indexes with the library
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    with pytest.raises(RuntimeError, match="native host library"):
        mesh.celltree.intersect_faces(raster.node_coordinates, raster.face_node_connectivity, device="cpu")
    with pytest.raises(RuntimeError, match="native host library"):
        mesh.compute_barycentric_weights(np.array([[2.0, 2.0]]), device="cpu")


def test_device_geometry_runs_on_the_card_by_default():
    """The device path of an over-cap face resolves like every entry
    point: the card unless the caller asks for the CPU."""
    _, mesh = grids(*mesh_with_faces(OVERCAP))
    _, raster = raster_grids()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xt.OverlapRegridder(mesh, raster)
    # Quads alone never reach the device path: no card needed.
    assert xt.OverlapRegridder(raster, raster)._weights.nnz > 0


REGRIDDER_DEFAULTS = [
    ("OverlapRegridder", "mean"),
    ("RelativeOverlapRegridder", "first_order_conservative"),
    ("BarycentricInterpolator", "mean"),
    ("NetworkGridder", "mean"),
]


@pytest.mark.parametrize("cls, default", REGRIDDER_DEFAULTS)
def test_from_csr_arrays_defaults_to_the_class_method(cls, default):
    """Left out, the method is the class's own default, as the JAX
    package's ``from_weights`` gives it; stated, it is taken."""
    _, raster = raster_grids(5)
    _, source = raster_grids(4)
    rng = np.random.default_rng(2)
    w = xt.RelativeOverlapRegridder(source, raster)._weights
    regridder = getattr(xt, cls).from_csr_arrays(w.data, w.indices, w.indptr, w.n, w.m, raster)
    explicit = getattr(xt, cls).from_csr_arrays(w.data, w.indices, w.indptr, w.n, w.m, raster, default)
    assert regridder._reduction is explicit._reduction
    values = rng.normal(size=(2, w.m))
    torch.testing.assert_close(
        regridder.regrid(values, device="cpu"), explicit.regrid(values, device="cpu"), rtol=0, atol=0, equal_nan=True
    )


def test_centroid_locator_from_coo_arrays_takes_no_method():
    _, raster = raster_grids(5)
    _, source = raster_grids(4)
    w = xt.CentroidLocatorRegridder(source, raster)._weights
    regridder = xt.CentroidLocatorRegridder.from_coo_arrays(w.data, w.row, w.col, w.n, w.m, raster)
    values = np.arange(2.0 * w.m).reshape(2, w.m)
    want = np.full((2, w.n), np.nan)
    want[:, w.row] = values[:, w.col]
    np.testing.assert_array_equal(regridder.regrid(values, device="cpu").numpy(), want)
