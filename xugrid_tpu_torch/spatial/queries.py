"""
Batched BVH queries as torch ops on the device of the tree's tensors.

The counterparts of ``xugrid_tpu/spatial/queries.py``'s jitted XLA
functions, under the same names.  Each runs over all queries at once:

* The frontier descents (``box_candidates_kernel``,
  ``locate_points_kernel``, ``locate_points_on_edges_kernel``) go down
  the complete tree level by level, keeping up to ``frontier`` hit nodes
  per query (packed left by cumsum offsets; a query with more raises its
  overflow flag), then test the leaves' primitives exactly, one frontier
  slot at a time, so that the first hit is the JAX package's.
* The skip-link walks (``locate_points_while_kernel``,
  ``count_box_overlaps_kernel``, ``emit_box_overlaps_kernel``) step
  every query still walking in lock step; every ``CHECK_EVERY`` steps the
  host drops the queries that finished.
* The exact passes over candidate pairs (``clip_segments_by_faces_kernel``,
  ``points_in_polygons_kernel``, ``points_in_triangles_kernel``,
  ``polygon_overlap_areas_kernel``, ``barycentric_weights_kernel``) are
  the primitives of ``spatial/geometry.py`` over gathered polygons.

Queries run in passes of at most ``CHUNK`` rows, fewer where one gather
of a pass would hold more than ``GATHER_BUDGET`` values.  Ids come back
as int32 and flags as bool, as in the JAX package; inputs may be numpy
arrays or tensors, and are moved to the device of the tree (or of the
polygon buffer), the card where none is a tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from xugrid_tpu_torch.spatial import geometry as geo
from xugrid_tpu_torch.spatial.bvh import BVH
from xugrid_tpu_torch.utils.device import resolve_device
from xugrid_tpu_torch.xdata.variable import torch_dtype

#: Queries per pass: the JAX facade's launch size (``CellTree2d.CHUNK``).
CHUNK = 1 << 19
#: Values that one gather of a pass may hold (256 MB of float64).
GATHER_BUDGET = 1 << 25
#: Lock-step walk steps between two host checks for finished queries.
CHECK_EVERY = 8


class DeviceBVH(NamedTuple):
    node_bbox: torch.Tensor  # (n_nodes, 4)
    skip: torch.Tensor  # (n_nodes,) int64
    prim_index: torch.Tensor  # (n_leaves * leaf_size,) int64, -1 padded


def bvh_to_device(bvh: BVH, dtype=None, device=None) -> DeviceBVH:
    """Upload a host BVH: boxes in ``dtype`` (numpy or torch; None keeps
    float64), ids as int64 for indexing, on ``device`` (None: the card)."""
    device = resolve_device(None, device)
    box = torch.from_numpy(np.ascontiguousarray(bvh.node_bbox))
    return DeviceBVH(
        node_bbox=box.to(device=device, dtype=box.dtype if dtype is None else torch_dtype(dtype)),
        skip=torch.from_numpy(bvh.skip.astype(np.int64)).to(device),
        prim_index=torch.from_numpy(bvh.prim_index.astype(np.int64)).to(device),
    )


def _device_of(*arrays) -> torch.device:
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(None, None)


def _on(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device, dtype=dtype)


def _passes(n: int, values_per_row: int):
    """Row slices of at most CHUNK rows and GATHER_BUDGET gathered values."""
    rows = max(1, min(CHUNK, GATHER_BUDGET // max(1, values_per_row)))
    return [slice(start, min(start + rows, n)) for start in range(0, n, rows)]


def _bbox_contains_point(bbox, p, tol):
    return (
        (p[..., 0] >= bbox[..., 0] - tol)
        & (p[..., 0] <= bbox[..., 2] + tol)
        & (p[..., 1] >= bbox[..., 1] - tol)
        & (p[..., 1] <= bbox[..., 3] + tol)
    )


def _bbox_overlaps_box(bbox, qbox, tol):
    return (
        (bbox[..., 0] <= qbox[..., 2] + tol)
        & (bbox[..., 2] >= qbox[..., 0] - tol)
        & (bbox[..., 1] <= qbox[..., 3] + tol)
        & (bbox[..., 3] >= qbox[..., 1] - tol)
    )


def _first_hit(prim_ids, hit):
    """Per row: (any hit, the primitive of the first hit).  ``argmax`` of a
    boolean row is its first True, as ``jnp.argmax``'s."""
    first = hit.to(torch.uint8).argmax(dim=1, keepdim=True)
    return hit.any(dim=1), torch.gather(prim_ids, 1, first)[:, 0]


def _leaf_prims(tree: DeviceBVH, leaf_ids, leaf_size: int):
    """Primitive ids of leaves (...,) -> (..., leaf_size), -1 for leaf -1
    (``dynamic_slice`` of ``prim_index`` as ``start + arange``)."""
    lanes = torch.arange(leaf_size, device=leaf_ids.device)
    prims = tree.prim_index[torch.clamp(leaf_ids, min=0)[..., None] * leaf_size + lanes]
    return torch.where((leaf_ids >= 0)[..., None], prims, -1)


# ---------------------------------------------------------------------------
# Skip-link walk
# ---------------------------------------------------------------------------
def _traverse(tree: DeviceBVH, n_internal: int, leaf_size: int, n_q: int, hit_fn, leaf_fn) -> None:
    """
    Skip-link traversal of ``n_q`` queries in lock step.

    hit_fn(ids (k,), node bboxes (k, 4)) -> (k,) bool: do the queries
    ``ids`` overlap their nodes?
    leaf_fn(ids (k,), prim_ids (k, leaf_size), active (k,)) -> (k,) bool
    or None: called every step with the prims of the hit leaves (-1
    elsewhere); it masks its own work by ``active``, updates its results
    at ``ids`` and may end a query (True).
    Adds its lock-step iterations to ``_traverse.steps``.
    """
    device = tree.node_bbox.device
    n_nodes = tree.node_bbox.shape[0]
    ids = torch.arange(n_q, device=device)
    node = torch.zeros(n_q, dtype=torch.int64, device=device)
    done = torch.zeros(n_q, dtype=torch.bool, device=device)
    steps = 0
    while ids.numel():
        for _ in range(CHECK_EVERY):
            live = (node < n_nodes) & ~done
            safe = torch.clamp(node, max=n_nodes - 1)
            hit = live & hit_fn(ids, tree.node_bbox[safe])
            is_leaf = safe >= n_internal
            active = hit & is_leaf
            prim_ids = torch.where(active[:, None], _leaf_prims(tree, safe - n_internal, leaf_size), -1)
            leaf_done = leaf_fn(ids, prim_ids, active)
            if leaf_done is not None:
                done = done | (leaf_done & active)
            node = torch.where(live, torch.where(hit & ~is_leaf, 2 * node + 1, tree.skip[safe]), node)
        steps += CHECK_EVERY
        keep = (node < n_nodes) & ~done
        ids, node, done = ids[keep], node[keep], done[keep]
    _traverse.steps += steps


#: Lock-step iterations of every skip-link walk, a counter its caller
#: resets (``_traverse.steps = 0``) and reads.
_traverse.steps = 0


# ---------------------------------------------------------------------------
# Frontier descent
# ---------------------------------------------------------------------------
def _descend_frontier(hit_fn, node_bbox, depth: int, frontier: int, n_q: int):
    """
    Frontier descent of ``n_q`` queries: level by level over the complete
    tree, keeping up to ``frontier`` hit nodes per query, packed left.
    hit_fn(bboxes (n_q, k, 4)) -> (n_q, k) bool.
    Returns (node ids at the leaf level (n_q, frontier) int64, -1 padded;
    overflow flags (n_q,)).  Only the slots some query fills are expanded.
    """
    device = node_bbox.device
    f = torch.zeros((n_q, 1), dtype=torch.int64, device=device)
    overflow = torch.zeros(n_q, dtype=torch.bool, device=device)
    for _ in range(depth):
        width = f.shape[1]
        children = torch.stack([2 * f + 1, 2 * f + 2], dim=-1).reshape(n_q, 2 * width)
        cvalid = (f >= 0).repeat_interleave(2, dim=1)
        hit = cvalid & hit_fn(node_bbox[torch.clamp(children, min=0)])
        n_hit = hit.sum(dim=1)
        overflow |= n_hit > frontier
        new_width = min(frontier, int(n_hit.max())) if n_q else 0
        # Hit children packed left by cumsum offsets; the extra slot takes
        # misses and what exceeds the frontier.
        pos = torch.cumsum(hit, dim=1) - 1
        target = torch.where(hit & (pos < new_width), pos, new_width)
        packed = torch.full((n_q, new_width + 1), -1, dtype=torch.int64, device=device)
        f = packed.scatter_(1, target, torch.where(hit, children, -1))[:, :new_width]
        if new_width == 0:
            break
    pad = torch.full((n_q, frontier - f.shape[1]), -1, dtype=torch.int64, device=device)
    return torch.cat([f, pad], dim=1), overflow


def _descend_to_leaf_ids(points, tree, n_internal, depth, frontier, tolerance):
    """Leaf ids (n_q, frontier) whose boxes hold each point within the
    tolerance, -1 padded, and the overflow flags."""
    p = points[:, None, :]
    leaves, overflow = _descend_frontier(
        lambda bbox: _bbox_contains_point(bbox, p, tolerance), tree.node_bbox, depth, frontier, len(points)
    )
    return torch.where(leaves >= 0, leaves - n_internal, -1), overflow


def _first_in_slots(leaf_ids, tree, leaf_size, test):
    """Frontier slot by slot, for the queries not yet found that have a
    leaf in the slot: the first primitive of that leaf passing
    ``test(rows, prim_ids (r, leaf_size)) -> (r, leaf_size) bool``.
    Slots are packed left, so the first slot with no such query ends it."""
    found = torch.full((leaf_ids.shape[0],), -1, dtype=torch.int64, device=leaf_ids.device)
    for slot in range(leaf_ids.shape[1]):
        rows = torch.nonzero((found < 0) & (leaf_ids[:, slot] >= 0)).squeeze(1)
        if rows.numel() == 0:
            break
        prim_ids = _leaf_prims(tree, leaf_ids[rows, slot], leaf_size)
        any_hit, hit_prim = _first_hit(prim_ids, test(rows, prim_ids) & (prim_ids >= 0))
        found[rows] = torch.where(any_hit, hit_prim, -1)
    return found


def box_candidates_kernel(query_boxes, tree: DeviceBVH, prim_bbox, n_internal, leaf_size, depth, frontier):
    """
    Frontier-descent candidate join for box queries (torch ops): for each
    query box, the primitives whose AABB overlaps it, in a dense
    (n_q, frontier * leaf_size) int32 buffer (-1 padded, in frontier and
    leaf order), plus overflow flags.
    """
    device = tree.node_bbox.device
    query_boxes = _on(query_boxes, device, tree.node_bbox.dtype)
    prim_bbox = _on(prim_bbox, device, tree.node_bbox.dtype)
    n_q = len(query_boxes)
    cands = torch.empty((n_q, frontier * leaf_size), dtype=torch.int32, device=device)
    overflow = torch.empty(n_q, dtype=torch.bool, device=device)
    for part in _passes(n_q, 4 * frontier * max(2, leaf_size)):
        qbox = query_boxes[part]
        q = qbox[:, None, :]
        leaves, overflow[part] = _descend_frontier(
            lambda bbox: _bbox_overlaps_box(bbox, q, 0.0), tree.node_bbox, depth, frontier, len(qbox)
        )
        leaf_ids = torch.where(leaves >= 0, leaves - n_internal, -1)
        prim_ids = _leaf_prims(tree, leaf_ids, leaf_size).reshape(len(qbox), -1)
        ok = (prim_ids >= 0) & _bbox_overlaps_box(prim_bbox[torch.clamp(prim_ids, min=0)], q, 0.0)
        cands[part] = torch.where(ok, prim_ids, -1).to(torch.int32)
    return cands, overflow


def locate_points_kernel(points, tree: DeviceBVH, poly_xy, n_internal, leaf_size, depth, frontier, tolerance):
    """
    For every point, the index of the containing face (-1 if none), int32,
    plus an overflow flag marking queries whose candidate set was
    truncated (rerun them through ``locate_points_while_kernel``).  Torch
    ops.

    points: (n_q, 2); poly_xy: (n_face, n_max, 2) padded polygons.
    """
    device = tree.node_bbox.device
    points = _on(points, device, tree.node_bbox.dtype)
    poly_xy = _on(poly_xy, device, tree.node_bbox.dtype)
    n_q = len(points)
    found = torch.empty(n_q, dtype=torch.int32, device=device)
    overflow = torch.empty(n_q, dtype=torch.bool, device=device)
    per_row = max(8 * frontier, leaf_size * poly_xy.shape[1] * 2)
    for part in _passes(n_q, per_row):
        p = points[part]
        leaf_ids, overflow[part] = _descend_to_leaf_ids(p, tree, n_internal, depth, frontier, tolerance)

        def inside(rows, prim_ids):
            polys = poly_xy[torch.clamp(prim_ids, min=0)]
            return geo.point_in_polygon(p[rows, None, :], polys, tolerance)

        found[part] = _first_in_slots(leaf_ids, tree, leaf_size, inside).to(torch.int32)
    return found, overflow


def locate_points_while_kernel(points, tree: DeviceBVH, poly_xy, n_internal, leaf_size, tolerance):
    """Exact skip-link walk for the frontier-overflow queries: the first
    face in the walk's order holding each point, -1 if none; int32.
    Torch ops."""
    device = tree.node_bbox.device
    points = _on(points, device, tree.node_bbox.dtype)
    poly_xy = _on(poly_xy, device, tree.node_bbox.dtype)
    found = torch.full((len(points),), -1, dtype=torch.int64, device=device)
    for part in _passes(len(points), leaf_size * poly_xy.shape[1] * 2):
        p = points[part]
        out = found[part]

        def leaf_fn(ids, prim_ids, active):
            polys = poly_xy[torch.clamp(prim_ids, min=0)]
            inside = geo.point_in_polygon(p[ids, None, :], polys, tolerance) & (prim_ids >= 0)
            any_in, hit_prim = _first_hit(prim_ids, inside)
            out[ids] = torch.where(any_in, hit_prim, out[ids])
            return any_in

        _traverse(
            tree, n_internal, leaf_size, len(p),
            lambda ids, bbox: _bbox_contains_point(bbox, p[ids], tolerance), leaf_fn,
        )
    return found.to(torch.int32)


# ---------------------------------------------------------------------------
# Point location on edges (1D networks)
# ---------------------------------------------------------------------------
def locate_points_on_edges_kernel(
    points, tree: DeviceBVH, edge_xy, n_internal, leaf_size, depth, frontier, tolerance
):
    """
    For every point, the index of an edge within tolerance (-1 if none),
    int32, plus a frontier-overflow flag.  edge_xy: (n_edge, 2, 2).
    Torch ops.
    """
    device = tree.node_bbox.device
    points = _on(points, device, tree.node_bbox.dtype)
    edge_xy = _on(edge_xy, device, tree.node_bbox.dtype)
    n_q = len(points)
    found = torch.empty(n_q, dtype=torch.int32, device=device)
    overflow = torch.empty(n_q, dtype=torch.bool, device=device)
    for part in _passes(n_q, max(8 * frontier, leaf_size * 4)):
        p = points[part]
        leaf_ids, overflow[part] = _descend_to_leaf_ids(p, tree, n_internal, depth, frontier, tolerance)

        def on_edge(rows, prim_ids):
            segs = edge_xy[torch.clamp(prim_ids, min=0)]
            on, _ = geo.point_on_segment_param(p[rows, None, :], segs[..., 0, :], segs[..., 1, :], tolerance)
            return on

        found[part] = _first_in_slots(leaf_ids, tree, leaf_size, on_edge).to(torch.int32)
    return found, overflow


# ---------------------------------------------------------------------------
# Box-overlap counting / emission (two-pass pattern)
# ---------------------------------------------------------------------------
def _box_walk(query_boxes, tree, prim_bbox, n_internal, leaf_size, on_leaf):
    """Walk every query box; ``on_leaf(part, ids, prim_ids, ok)`` gets the
    prims of each hit leaf whose own AABB overlaps the box."""
    device = tree.node_bbox.device
    query_boxes = _on(query_boxes, device, tree.node_bbox.dtype)
    prim_bbox = _on(prim_bbox, device, tree.node_bbox.dtype)
    for part in _passes(len(query_boxes), leaf_size * 4):
        qbox = query_boxes[part]

        def leaf_fn(ids, prim_ids, active):
            q = qbox[ids][:, None, :]
            ok = (prim_ids >= 0) & _bbox_overlaps_box(prim_bbox[torch.clamp(prim_ids, min=0)], q, 0.0)
            on_leaf(part, ids, prim_ids, ok)

        _traverse(
            tree, n_internal, leaf_size, len(qbox),
            lambda ids, bbox: _bbox_overlaps_box(bbox, qbox[ids], 0.0), leaf_fn,
        )


def count_box_overlaps_kernel(query_boxes, tree: DeviceBVH, prim_bbox, n_internal, leaf_size):
    """Count the primitives whose own AABB overlaps each query box (int32).
    Torch ops."""
    device = tree.node_bbox.device
    counts = torch.zeros(len(query_boxes), dtype=torch.int64, device=device)

    def on_leaf(part, ids, prim_ids, ok):
        counts[ids + part.start] += ok.sum(dim=1)

    _box_walk(query_boxes, tree, prim_bbox, n_internal, leaf_size, on_leaf)
    return counts.to(torch.int32)


def emit_box_overlaps_kernel(query_boxes, tree: DeviceBVH, prim_bbox, n_internal, leaf_size, capacity):
    """
    For each query box: indices of primitives whose AABB overlaps it, in
    the walk's order, written into a fixed (n_q, capacity) int32 buffer
    padded with -1, and their full count (int32, which may exceed
    ``capacity``).  Torch ops.
    """
    device = tree.node_bbox.device
    n_q = len(query_boxes)
    out = torch.full((n_q, capacity + 1), -1, dtype=torch.int64, device=device)
    count = torch.zeros(n_q, dtype=torch.int64, device=device)

    def on_leaf(part, ids, prim_ids, ok):
        rows = ids + part.start
        okl = ok.to(torch.int64)
        offs = count[rows][:, None] + torch.cumsum(okl, dim=1) - okl
        # Misses and what exceeds the capacity go to the extra column.
        pos = torch.where(ok & (offs < capacity), offs, capacity)
        out[rows[:, None], pos] = torch.where(ok, prim_ids, -1)
        count[rows] += okl.sum(dim=1)

    _box_walk(query_boxes, tree, prim_bbox, n_internal, leaf_size, on_leaf)
    return out[:, :capacity].to(torch.int32), count.to(torch.int32)


# ---------------------------------------------------------------------------
# Exact geometry passes over candidate sets
# ---------------------------------------------------------------------------
def clip_segments_by_faces_kernel(p0, p1, candidates, poly_xy):
    """
    Clip segments against candidate convex faces (torch ops).

    p0, p1: (n_q, 2); candidates: (n_q, capacity) face ids (-1 padded).
    Returns (valid (n_q, capacity), t0, t1) parameter intervals.
    """
    device = _device_of(poly_xy, p0, candidates)
    poly_xy = _on(poly_xy, device)
    p0, p1 = _on(p0, device, poly_xy.dtype), _on(p1, device, poly_xy.dtype)
    candidates = _on(candidates, device).to(torch.int64)
    shape = candidates.shape
    valid = torch.empty(shape, dtype=torch.bool, device=device)
    t0 = torch.empty(shape, dtype=poly_xy.dtype, device=device)
    t1 = torch.empty(shape, dtype=poly_xy.dtype, device=device)
    for part in _passes(shape[0], shape[1] * poly_xy.shape[1] * 2):
        faces = candidates[part]
        polys = poly_xy[torch.clamp(faces, min=0)]
        v, a, b = geo.clip_segment_by_convex_polygon(p0[part, None, :], p1[part, None, :], polys)
        valid[part], t0[part], t1[part] = v & (faces >= 0), a, b
    return valid, t0, t1


def polygon_overlap_areas_kernel(subject_ids, clip_ids, subject_xy, clip_xy):
    """
    Area of overlap for candidate (subject, clip) polygon pairs (torch
    ops; the arithmetic of ``geometry.convex_overlap_areas``, which the
    celltree's over-cap path runs).

    subject_ids, clip_ids: (n_pairs,) indices; subject_xy/clip_xy padded
    polygon buffers.  Returns (n_pairs,) areas, 0 where an id is -1.
    """
    device = _device_of(subject_xy, clip_xy, subject_ids)
    subject_xy, clip_xy = _on(subject_xy, device), _on(clip_xy, device)
    subject_ids = _on(subject_ids, device).to(torch.int64)
    clip_ids = _on(clip_ids, device).to(torch.int64)
    m, k = subject_xy.shape[1], clip_xy.shape[1]
    areas = torch.empty(len(subject_ids), dtype=subject_xy.dtype, device=device)
    for part in _passes(len(subject_ids), 2 * (m + k + m * k)):
        si, ci = subject_ids[part], clip_ids[part]
        area = geo.convex_overlap_areas(subject_xy[torch.clamp(si, min=0)], clip_xy[torch.clamp(ci, min=0)])
        areas[part] = torch.where((si >= 0) & (ci >= 0), area, 0.0)
    return areas


def barycentric_weights_kernel(points, face_index, poly_xy, tolerance):
    """
    Mean-value coordinates of each point within its located face (torch
    ops; ``geometry.mean_value_weights``, as the celltree's over-cap path).

    Returns (n_q, n_max) weights; zero rows for face_index == -1.
    """
    device = _device_of(poly_xy, points, face_index)
    poly_xy = _on(poly_xy, device)
    points = _on(points, device, poly_xy.dtype)
    face_index = _on(face_index, device).to(torch.int64)
    weights = torch.empty((len(points), poly_xy.shape[1]), dtype=poly_xy.dtype, device=device)
    for part in _passes(len(points), poly_xy.shape[1] * 2):
        fi = face_index[part]
        w = geo.mean_value_weights(points[part], poly_xy[torch.clamp(fi, min=0)], tolerance)
        weights[part] = torch.where((fi >= 0)[:, None], w, 0.0)
    return weights


def points_in_polygons_kernel(points, face_index, poly_xy, tolerance):
    """Pairwise exact test (torch ops): is points[i] inside
    poly_xy[face_index[i]], or within ``tolerance`` of its boundary?"""
    device = _device_of(poly_xy, points, face_index)
    poly_xy = _on(poly_xy, device)
    points = _on(points, device, poly_xy.dtype)
    face_index = _on(face_index, device).to(torch.int64)
    inside = torch.empty(len(points), dtype=torch.bool, device=device)
    for part in _passes(len(points), poly_xy.shape[1] * 2):
        fi = face_index[part]
        inside[part] = geo.point_in_polygon(points[part], poly_xy[torch.clamp(fi, min=0)], tolerance) & (fi >= 0)
    return inside


def points_in_triangles_kernel(points, triangle_index, tri_xy, tolerance):
    """points: (n, 2); triangle_index: (n,); tri_xy: (n_tri, 3, 2).
    The pairwise test of ``points_in_polygons_kernel`` on triangles."""
    return points_in_polygons_kernel(points, triangle_index, tri_xy, tolerance)


def default_tolerance(bounds, dtype=np.float64) -> float:
    """Tolerance heuristic: bbox diagonal scaled by dtype epsilon."""
    xmin, ymin, xmax, ymax = bounds
    diag = float(np.hypot(xmax - xmin, ymax - ymin))
    double = dtype == torch.float64 if isinstance(dtype, torch.dtype) else np.dtype(dtype) == np.float64
    return diag * (1e-12 if double else 1e-6)


def next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1)).bit_length()
