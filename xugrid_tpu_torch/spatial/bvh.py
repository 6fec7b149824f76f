"""
Flat bounding-volume hierarchy (BVH) over 2D primitives, built on the
host (numpy), and the bounding boxes of mesh faces and network edges.

The batched queries over it are torch ops on the device of the tree's
tensors (``spatial/queries.py``).

Layout
------
* Primitives (faces or edges) are ordered by recursive alternating-axis
  splits of their AABB centres (``kd_order``).
* Leaves hold ``leaf_size`` consecutive primitives of that order.
* The tree is a complete binary tree in heap order: node ``i`` has
  children ``2i+1``/``2i+2``; leaf ``j`` lives at ``n_leaves - 1 + j``.
* ``skip[i]`` is the preorder escape: the next node to visit after
  skipping node ``i``'s entire subtree.  Traversal is then a single
  loop:  hit→descend (2i+1), miss/leaf→skip[i].
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np


def morton_encode2d(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Interleave 16-bit quantized x/y into 32-bit Morton codes."""

    def spread(v: np.ndarray) -> np.ndarray:
        v = v.astype(np.uint32) & 0xFFFF
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    return (spread(y) << 1) | spread(x)


def morton_order(xy: np.ndarray, bounds=None) -> np.ndarray:
    """Return the permutation sorting 2D points along the Morton curve."""
    if bounds is None:
        lo = xy.min(axis=0)
        hi = xy.max(axis=0)
    else:
        lo = np.asarray(bounds[:2])
        hi = np.asarray(bounds[2:])
    extent = np.maximum(hi - lo, 1e-300)
    quant = ((xy - lo) / extent * 65535.0).astype(np.uint32)
    codes = morton_encode2d(quant[:, 0], quant[:, 1])
    return np.argsort(codes, kind="stable")


def kd_order(xy: np.ndarray, n_levels: int, capacity: int) -> np.ndarray:
    """
    Order points by recursive alternating-axis splits (a balanced kd-tree
    order).  Pairing consecutive ``capacity >> level`` blocks of this
    order yields a complete tree whose sibling bounding boxes barely
    overlap, unlike the Morton order, whose Z-curve jumps create large
    overlapping internal boxes.

    The split point per segment is the left subtree's slot capacity (not
    the median), so the order aligns exactly with the complete-tree leaf
    blocks.  The native host library partitions each segment in place
    (``std::nth_element``); without it, one lexsort per level over
    (segment, coordinate).  The two may order a segment's points
    differently.
    """
    from xugrid_tpu_torch.utils.native import kd_order_native

    native = kd_order_native(xy, n_levels, capacity)
    if native is not None:
        return native

    n = len(xy)
    order = np.arange(n)
    seg = np.zeros(n, dtype=np.int64)
    for level in range(n_levels):
        axis = level % 2
        coords = xy[order, axis]
        perm = np.lexsort((coords, seg))
        order = order[perm]
        seg = seg[perm]
        counts = np.bincount(seg)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos_in_seg = np.arange(n) - starts[seg]
        left_capacity = capacity >> (level + 1)
        half = np.minimum(counts[seg], left_capacity)
        seg = seg * 2 + (pos_in_seg >= half)
    return order


class BVH(NamedTuple):
    """Host-side flat BVH arrays; ``queries.bvh_to_device`` uploads them."""

    node_bbox: np.ndarray  # (n_nodes, 4) xmin, ymin, xmax, ymax
    skip: np.ndarray  # (n_nodes,) int32 preorder escape; sentinel == n_nodes
    prim_index: np.ndarray  # (n_leaves * leaf_size,) int32, -1 padded
    n_leaves: int
    leaf_size: int

    @property
    def n_nodes(self) -> int:
        return len(self.node_bbox)

    @property
    def n_internal(self) -> int:
        return self.n_leaves - 1


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def build_bvh(prim_bboxes: np.ndarray, leaf_size: int = 8) -> BVH:
    """
    Build a complete-binary-tree BVH from primitive AABBs.

    Parameters
    ----------
    prim_bboxes: (n_prim, 4) float array: xmin, ymin, xmax, ymax per
        primitive.  NaN rows (degenerate primitives) are kept but never
        matched.
    leaf_size: primitives per leaf.

    Returns
    -------
    bvh: BVH
    """
    prim_bboxes = np.asarray(prim_bboxes, dtype=np.float64)
    n_prim = len(prim_bboxes)
    if n_prim == 0:
        raise ValueError("cannot build a BVH over zero primitives")

    centers = 0.5 * (prim_bboxes[:, :2] + prim_bboxes[:, 2:])
    safe_centers = np.where(np.isfinite(centers), centers, 0.0)

    n_leaves = _next_pow2(max(1, -(-n_prim // leaf_size)))
    n_nodes = 2 * n_leaves - 1
    n_internal = n_leaves - 1
    order = kd_order(safe_centers, n_leaves.bit_length() - 1, n_leaves * leaf_size)

    # Primitives in their kd-aligned slots: segment boundaries align with
    # leaf blocks by construction (see kd_order).
    prim_index = np.full(n_leaves * leaf_size, -1, dtype=np.int32)
    prim_index[:n_prim] = order

    # Leaf bboxes: union over each leaf's primitives.
    sorted_boxes = np.full((n_leaves * leaf_size, 4), np.nan)
    sorted_boxes[:n_prim] = prim_bboxes[order]
    grouped = sorted_boxes.reshape(n_leaves, leaf_size, 4)
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN empty leaves
        leaf_bbox = np.concatenate(
            [np.nanmin(grouped[:, :, :2], axis=1), np.nanmax(grouped[:, :, 2:], axis=1)], axis=1
        )
    # Empty leaves: inverted boxes that can never overlap anything.
    empty = np.isnan(leaf_bbox).any(axis=1)
    leaf_bbox[empty] = [np.inf, np.inf, -np.inf, -np.inf]

    node_bbox = np.empty((n_nodes, 4), dtype=np.float64)
    node_bbox[n_internal:] = leaf_bbox
    # Bottom-up union per tree level: level k holds nodes
    # [2^k - 1, 2^(k+1) - 1); internal node i covers children 2i+1, 2i+2.
    n_levels = n_leaves.bit_length()  # leaves live at level n_levels - 1
    for k in range(n_levels - 2, -1, -1):
        idx = np.arange((1 << k) - 1, (1 << (k + 1)) - 1)
        left = node_bbox[2 * idx + 1]
        right = node_bbox[2 * idx + 2]
        node_bbox[idx, :2] = np.minimum(left[:, :2], right[:, :2])
        node_bbox[idx, 2:] = np.maximum(left[:, 2:], right[:, 2:])

    # Preorder escape links per level (top-down):
    # skip[left] = right sibling; skip[right] = skip[parent].
    skip = np.empty(n_nodes, dtype=np.int32)
    skip[0] = n_nodes
    for k in range(n_levels - 1):
        idx = np.arange((1 << k) - 1, (1 << (k + 1)) - 1)
        skip[2 * idx + 1] = 2 * idx + 2
        skip[2 * idx + 2] = skip[idx]

    return BVH(node_bbox=node_bbox, skip=skip, prim_index=prim_index, n_leaves=n_leaves, leaf_size=leaf_size)


def face_bounding_boxes(
    face_node_connectivity: np.ndarray, node_x: np.ndarray, node_y: np.ndarray
) -> np.ndarray:
    """AABB per face (n, 4) as (xmin, ymin, xmax, ymax), honoring -1 fills."""
    from xugrid_tpu_torch.utils.native import face_bbox_native

    if face_node_connectivity.ndim == 2 and len(face_node_connectivity) > 0:
        native = face_bbox_native(face_node_connectivity, node_x, node_y)
        if native is not None:
            return native
    x = node_x[face_node_connectivity]
    y = node_y[face_node_connectivity]
    isfill = face_node_connectivity == -1
    x = np.where(isfill, np.nan, x)
    y = np.where(isfill, np.nan, y)
    with np.errstate(invalid="ignore"):
        return np.column_stack(
            [
                np.nanmin(x, axis=1),
                np.nanmin(y, axis=1),
                np.nanmax(x, axis=1),
                np.nanmax(y, axis=1),
            ]
        )


def edge_bounding_boxes(
    edge_node_connectivity: np.ndarray, node_x: np.ndarray, node_y: np.ndarray
) -> np.ndarray:
    """AABB per edge (n, 4) as (xmin, ymin, xmax, ymax)."""
    x = node_x[edge_node_connectivity]
    y = node_y[edge_node_connectivity]
    return np.column_stack([x.min(axis=1), y.min(axis=1), x.max(axis=1), y.max(axis=1)])
