"""
The BVH queries (``xugrid_tpu_torch/spatial/queries.py``, torch ops) and
the single-primitive geometry (``spatial/geometry.py``) held on the CPU
against the JAX package's jitted functions (x64, as ``conftest.py`` sets
it) on the same inputs: face and edge ids, candidate buffers, counts and
overflow flags equal; clip parameters, areas and weights within rtol
1e-12 (XLA's fused kernels may round the last bits differently).

The inputs: a 13 x 13 quad mesh with jittered interior nodes, points
drawn over it and around it (outside), at its nodes and on its edges'
midpoints (shared edges and nodes), boxes of up to 3 x 3 cells, a
random-walk network; frontiers small enough to overflow (then a rerun
through the skip-link walk), a tree with empty leaves and NaN boxes, and
an emit capacity below the largest count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xugrid_tpu.spatial import bvh as jax_bvh
from xugrid_tpu.spatial import geometry as jax_geo
from xugrid_tpu.spatial import queries as jq
from xugrid_tpu_torch.spatial import bvh as torch_bvh
from xugrid_tpu_torch.spatial import geometry as geo
from xugrid_tpu_torch.spatial import queries as tq
from xugrid_tpu_torch.spatial.geometry import pad_polygons

N = 13
TOL = 1e-9


def jittered_mesh(n, rng):
    x = np.arange(n + 1.0)
    yy, xx = np.meshgrid(x, x, indexing="ij")
    verts = np.column_stack([xx.ravel(), yy.ravel()])
    inner = ((verts > 0) & (verts < n)).all(axis=1)
    verts[inner] += rng.uniform(-0.2, 0.2, (int(inner.sum()), 2))
    j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    nid = lambda a, b: b * (n + 1) + a  # noqa: E731
    faces = np.stack([nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)], axis=-1).reshape(-1, 4)
    return verts, faces


@pytest.fixture(scope="module")
def mesh():
    rng = np.random.default_rng(3)
    verts, faces = jittered_mesh(N, rng)
    poly = pad_polygons(faces, verts[:, 0], verts[:, 1])
    boxes = torch_bvh.face_bounding_boxes(faces, verts[:, 0], verts[:, 1])
    midpoints = 0.5 * (verts[faces] + verts[faces[:, [1, 2, 3, 0]]]).reshape(-1, 2)
    points = np.concatenate([rng.uniform(-1.0, N + 1.0, (300, 2)), verts, midpoints])
    return verts, faces, poly, boxes, points


def trees(boxes, leaf_size):
    host = torch_bvh.build_bvh(boxes, leaf_size)
    return host, jq.bvh_to_device(jax_bvh.build_bvh(boxes, leaf_size)), tq.bvh_to_device(host, device="cpu")


def depth_of(host):
    return host.n_leaves.bit_length() - 1


def equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())


@pytest.mark.parametrize("leaf_size, frontier", [(4, 2), (8, 8)])
def test_locate_points_frontier_then_walk(mesh, leaf_size, frontier):
    _, _, poly, boxes, points = mesh
    host, jtree, ttree = trees(boxes, leaf_size)
    args = (host.n_internal, leaf_size, depth_of(host), frontier, TOL)
    j_found, j_over = jq.locate_points_kernel(jnp.asarray(points), jtree, jnp.asarray(poly), *args)
    t_found, t_over = tq.locate_points_kernel(points, ttree, torch.from_numpy(poly), *args)
    assert t_found.dtype == torch.int32 and t_over.dtype == torch.bool
    equal(j_found, t_found)
    equal(j_over, t_over)
    if frontier == 2:
        assert bool(t_over.any())
    # Overflowed queries again through the exact walk, as the facade would.
    rerun = np.flatnonzero(t_over.numpy())
    walk_args = (host.n_internal, leaf_size, TOL)
    j_walk = jq.locate_points_while_kernel(jnp.asarray(points[rerun]), jtree, jnp.asarray(poly), *walk_args)
    t_walk = tq.locate_points_while_kernel(points[rerun], ttree, poly, *walk_args)
    equal(j_walk, t_walk)
    # The whole batch through the walk: points outside find nothing,
    # points on shared edges and nodes the JAX package's face.
    j_all = jq.locate_points_while_kernel(jnp.asarray(points), jtree, jnp.asarray(poly), *walk_args)
    t_all = tq.locate_points_while_kernel(points, ttree, poly, *walk_args)
    equal(j_all, t_all)
    outside = ((points < -1e-6) | (points > N + 1e-6)).any(axis=1)
    assert (t_all.numpy()[outside] == -1).all() and (t_all.numpy()[~outside] >= 0).all()


def test_locate_points_on_edges(mesh):
    rng = np.random.default_rng(5)
    steps = rng.uniform(0.5, 1.5, (60, 1)) * np.column_stack([np.cos(np.cumsum(rng.normal(0, 0.4, 60))),
                                                               np.sin(np.cumsum(rng.normal(0, 0.4, 60)))])
    nodes = np.cumsum(np.vstack([[3.0, 3.0], steps]), axis=0)
    edges = np.column_stack([np.arange(60), np.arange(1, 61)])
    edge_xy = nodes[edges]
    t = rng.uniform(0.0, 1.0, (80, 1))
    on = edge_xy[rng.integers(0, 60, 80), 0] * (1 - t) + edge_xy[rng.integers(0, 60, 80), 1] * t
    points = np.concatenate([nodes, 0.5 * (edge_xy[:, 0] + edge_xy[:, 1]), on, rng.uniform(0, 20, (80, 2))])
    boxes = torch_bvh.edge_bounding_boxes(edges, nodes[:, 0], nodes[:, 1])
    host, jtree, ttree = trees(boxes, 4)
    for frontier in (2, 8):
        args = (host.n_internal, 4, depth_of(host), frontier, 1e-9)
        j_found, j_over = jq.locate_points_on_edges_kernel(jnp.asarray(points), jtree, jnp.asarray(edge_xy), *args)
        t_found, t_over = tq.locate_points_on_edges_kernel(points, ttree, torch.from_numpy(edge_xy), *args)
        equal(j_found, t_found)
        equal(j_over, t_over)
    assert (t_found.numpy()[:121] >= 0).all()


def query_boxes(rng, n):
    lo = rng.uniform(-1.0, N, (n, 2))
    return np.column_stack([lo, lo + rng.uniform(0.0, 3.0, (n, 2))])


@pytest.mark.parametrize("frontier", [4, 16])
def test_box_candidates(mesh, frontier):
    _, _, _, boxes, _ = mesh
    qb = query_boxes(np.random.default_rng(7), 200)
    host, jtree, ttree = trees(boxes, 4)
    args = (host.n_internal, 4, depth_of(host), frontier)
    j_c, j_over = jq.box_candidates_kernel(jnp.asarray(qb), jtree, jnp.asarray(boxes), *args)
    t_c, t_over = tq.box_candidates_kernel(qb, ttree, boxes, *args)
    assert t_c.dtype == torch.int32
    equal(j_c, t_c)
    equal(j_over, t_over)
    assert bool(t_over.any()) == (frontier == 4)


def test_count_and_emit_box_overlaps(mesh):
    _, _, _, boxes, _ = mesh
    qb = query_boxes(np.random.default_rng(9), 200)
    host, jtree, ttree = trees(boxes, 4)
    args = (host.n_internal, 4)
    j_n = jq.count_box_overlaps_kernel(jnp.asarray(qb), jtree, jnp.asarray(boxes), *args)
    t_n = tq.count_box_overlaps_kernel(qb, ttree, boxes, *args)
    equal(j_n, t_n)
    most = int(t_n.max())
    for capacity in (most // 2, most):
        j_out, j_count = jq.emit_box_overlaps_kernel(jnp.asarray(qb), jtree, jnp.asarray(boxes), *args, capacity)
        t_out, t_count = tq.emit_box_overlaps_kernel(qb, ttree, boxes, *args, capacity)
        equal(j_out, t_out)
        equal(j_count, t_count)
    # Every box's set is the brute-force AABB overlap.
    hit = ((boxes[None, :, 0] <= qb[:, None, 2]) & (boxes[None, :, 2] >= qb[:, None, 0])
           & (boxes[None, :, 1] <= qb[:, None, 3]) & (boxes[None, :, 3] >= qb[:, None, 1]))
    for row, mask in zip(t_out.numpy(), hit):
        assert set(row[row >= 0]) == set(np.flatnonzero(mask))


def test_empty_leaves_and_nan_boxes_never_hit():
    rng = np.random.default_rng(11)
    lo = rng.uniform(0.0, 10.0, (21, 2))
    boxes = np.column_stack([lo, lo + 1.0])
    boxes[[2, 9]] = np.nan
    host, jtree, ttree = trees(boxes, 4)  # 8 leaves for 21 primitives: empty ones
    assert (host.prim_index == -1).sum() > 4 and np.isinf(host.node_bbox).any()
    qb = np.array([[-1e9, -1e9, 1e9, 1e9], [2.0, 2.0, 5.0, 5.0], [20.0, 20.0, 21.0, 21.0]])
    args = (host.n_internal, 4)
    t_n = tq.count_box_overlaps_kernel(qb, ttree, boxes, *args)
    equal(jq.count_box_overlaps_kernel(jnp.asarray(qb), jtree, jnp.asarray(boxes), *args), t_n)
    assert int(t_n[0]) == 19 and int(t_n[2]) == 0
    t_out, _ = tq.emit_box_overlaps_kernel(qb, ttree, boxes, *args, 21)
    equal(jq.emit_box_overlaps_kernel(jnp.asarray(qb), jtree, jnp.asarray(boxes), *args, 21)[0], t_out)
    assert not np.isin([2, 9], t_out.numpy()).any()
    t_c, _ = tq.box_candidates_kernel(qb, ttree, boxes, *args, depth_of(host), 8)
    equal(jq.box_candidates_kernel(jnp.asarray(qb), jtree, jnp.asarray(boxes), *args, depth_of(host), 8)[0], t_c)


def test_exact_passes(mesh):
    verts, faces, poly, boxes, points = mesh
    rng = np.random.default_rng(13)
    n = len(points)
    face_index = rng.integers(-1, len(faces), n)
    tol = 1e-9
    equal(
        jq.points_in_polygons_kernel(jnp.asarray(points), jnp.asarray(face_index), jnp.asarray(poly), tol),
        tq.points_in_polygons_kernel(points, face_index, torch.from_numpy(poly), tol),
    )
    tri_xy = poly[:, :3]
    equal(
        jq.points_in_triangles_kernel(jnp.asarray(points), jnp.asarray(face_index), jnp.asarray(tri_xy), tol),
        tq.points_in_triangles_kernel(points, face_index, torch.from_numpy(tri_xy), tol),
    )
    # Segments against candidate faces, -1 padded.
    p0 = rng.uniform(-1.0, N + 1.0, (60, 2))
    p1 = p0 + rng.normal(0.0, 3.0, (60, 2))
    cands = rng.integers(-1, len(faces), (60, 7))
    jv, jt0, jt1 = jq.clip_segments_by_faces_kernel(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(cands), jnp.asarray(poly))
    tv, tt0, tt1 = tq.clip_segments_by_faces_kernel(p0, p1, cands, torch.from_numpy(poly))
    equal(jv, tv)
    assert bool(tv.any())
    np.testing.assert_allclose(tt0.numpy(), np.asarray(jt0), rtol=1e-12, atol=0)
    np.testing.assert_allclose(tt1.numpy(), np.asarray(jt1), rtol=1e-12, atol=0)
    # Overlap areas of (subject, clip) pairs and mean-value weights.
    si = rng.integers(-1, len(faces), 80)
    ci = np.where(rng.random(80) < 0.8, si, rng.integers(-1, len(faces), 80))
    shifted = poly + 0.37
    j_area = jq.polygon_overlap_areas_kernel(jnp.asarray(si), jnp.asarray(ci), jnp.asarray(poly), jnp.asarray(shifted))
    t_area = tq.polygon_overlap_areas_kernel(si, ci, torch.from_numpy(poly), torch.from_numpy(shifted))
    np.testing.assert_allclose(t_area.numpy(), np.asarray(j_area), rtol=1e-12, atol=1e-14)
    assert (t_area.numpy() > 0).sum() > 40
    # Mean-value weights of points inside their faces (centroids pulled
    # towards a vertex), -1 rows zero.
    inner = 0.6 * poly.mean(axis=1) + 0.4 * poly[:, 1]
    located = np.where(rng.random(len(faces)) < 0.9, np.arange(len(faces)), -1)
    j_w = jq.barycentric_weights_kernel(jnp.asarray(inner), jnp.asarray(located), jnp.asarray(poly), tol)
    t_w = tq.barycentric_weights_kernel(inner, located, torch.from_numpy(poly), tol)
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), rtol=1e-12, atol=1e-14)
    assert (t_w.numpy()[located < 0] == 0).all()


def test_tolerance_and_next_pow2():
    bounds = (0.0, -2.0, 3.0, 2.0)
    for dtype in (np.float64, np.float32):
        assert tq.default_tolerance(bounds, dtype) == jq.default_tolerance(bounds, dtype)
    assert tq.default_tolerance(bounds, torch.float32) == jq.default_tolerance(bounds, np.float32)
    assert [tq.next_pow2(n) for n in (0, 1, 2, 3, 1000)] == [jq.next_pow2(n) for n in (0, 1, 2, 3, 1000)]


# ---------------------------------------------------------------------------
# Single-primitive geometry: one call equals the JAX function, a batch its
# vmap.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def shapes():
    rng = np.random.default_rng(17)
    verts, faces = jittered_mesh(4, rng)
    poly = pad_polygons(faces, verts[:, 0], verts[:, 1])
    tri = np.concatenate([poly[:, :3], poly[:, :1]], axis=1)  # a padded triangle
    polys = np.concatenate([poly, tri])
    clips = np.roll(polys, 3, axis=0) + rng.uniform(-0.4, 0.4, (1, 1, 2))
    points = np.concatenate([rng.uniform(-0.5, 4.5, (len(polys) - 2, 2)), verts[5:7]])
    return polys, clips, points


def close(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14, equal_nan=True)


GEOMETRY = {
    "polygon_edges": lambda p, c, q: (p,),
    "point_in_polygon": lambda p, c, q: (q, p, TOL),
    "point_on_segment_param": lambda p, c, q: (q, p[..., 0, :], p[..., 1, :], 0.3),
    "clip_segment_by_convex_polygon": lambda p, c, q: (q, q + 1.7, p),
    "segment_segment_intersection": lambda p, c, q: (p[..., 0, :], p[..., 2, :], c[..., 1, :], c[..., 3, :]),
    "polygon_area": lambda p, c, q: (p,),
    "clip_polygons_area": lambda p, c, q: (p, c),
    "convex_overlap_area": lambda p, c, q: (p, c),
    "mean_value_weights": lambda p, c, q: (q, p, TOL),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_single_primitive_geometry(shapes, name):
    polys, clips, points = shapes
    args_of = GEOMETRY[name]
    jax_fn, torch_fn = getattr(jax_geo, name), getattr(geo, name)

    def as_torch(args):
        return [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]

    def flat(out):
        return out if isinstance(out, tuple) else (out,)

    # One primitive.
    for i in (0, len(polys) - 1):
        args = args_of(polys[i], clips[i], points[i])
        want = flat(jax.jit(jax_fn)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))
        got = flat(torch_fn(*as_torch(args)))
        for g, w in zip(got, want):
            close(g, w)
    # The batch against the vmap.
    args = args_of(polys, clips, points)
    mapped = [0 if isinstance(a, np.ndarray) else None for a in args]
    want = flat(jax.jit(jax.vmap(jax_fn, in_axes=mapped))(*[jnp.asarray(a) if m == 0 else a for a, m in zip(args, mapped)]))
    got = flat(torch_fn(*as_torch(args)))
    for g, w in zip(got, want):
        close(g, w)
