"""
Centroidal voronoi tessellation from a mesh of convex cells (host,
numpy; the angle sort of large meshes on a torch device).

The functions are those of ``xugrid_tpu/ugrid/voronoi.py``, copied so
that the port imports nothing of the JAX package.  The tessellation is
one dense padded candidate table:

* every mesh node gets a row of candidate voronoi-vertex ids
  ``(n_node, C)`` with -1 padding: its face centroids (slots ``[0:K]``),
  the projections of boundary-face centroids onto its boundary edges
  (slots ``[K:K+P]``), and optionally one substitute boundary vertex
  (last slot);
* the polygons are assembled by one row-wise angle argsort over that
  table (``angle_sort_rows``), on the caller's torch device for large
  tables and in numpy for small ones;
* the concave/convex choice (``skip_concave``) is a vectorized shoelace
  over the sorted rows.

Three exterior modes: add_exterior x add_vertices x skip_concave.  When
a degenerate projection (one that coincides with its face centroid) is
dropped, ``interpolation_map`` points at that centroid.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from scipy import sparse

from xugrid_tpu_torch.constants import FILL_VALUE, X_EPSILON
from xugrid_tpu_torch.ugrid.connectivity import renumber, to_dense
from xugrid_tpu_torch.utils.device import resolve_device
from xugrid_tpu_torch.utils.profiling import timed

#: Size of the (R, C, 2) table of candidate offsets from which the angle
#: sort runs on the torch device; smaller tables sort in numpy.
DEVICE_MIN = 65536


def boundary_projections(
    edge_face_connectivity: np.ndarray,
    edge_node_connectivity: np.ndarray,
    vertices: np.ndarray,
    centroids: np.ndarray,
):
    """
    Per boundary edge: the projection of its face's centroid onto the
    edge, plus per-node slot tables assigning each projection to both
    endpoint nodes.

    Returns a dict with:

    - ``proj`` (B, 2): projected coordinates (unfiltered);
    - ``face`` (B,): the face each projection came from;
    - ``keep`` (B,): False where the projection coincides with the
      centroid itself (degenerate, e.g. circumcenters on the edge);
    - ``node_slots`` (n_node, P): per node, the indices of its adjacent
      boundary projections into ``proj`` (-1 padded, P = max boundary
      edges per node, 2 for well-formed meshes);
    - ``is_boundary_node`` (n_node,): mask.
    """
    n_node = len(vertices)
    is_bedge = edge_face_connectivity[:, 1] == FILL_VALUE
    bnodes = edge_node_connectivity[is_bedge]  # (B, 2)
    bface = edge_face_connectivity[is_bedge, 0]  # (B,)

    a = vertices[bnodes[:, 0]]
    b = vertices[bnodes[:, 1]]
    c = centroids[bface]
    ab = b - a
    t = ((c - a) * ab).sum(axis=1) / (ab * ab).sum(axis=1)
    proj = a + t[:, None] * ab
    keep = np.linalg.norm(proj - c, axis=1) > (X_EPSILON * X_EPSILON)

    # Slot table: scatter each projection to both endpoints, packed
    # left with a running in-group offset (sort-based group-by).
    flat = bnodes.ravel()
    order = np.argsort(flat, kind="stable")
    sorted_nodes = flat[order]
    group_start = np.flatnonzero(
        np.diff(sorted_nodes, prepend=sorted_nodes[0] - 1 if len(sorted_nodes) else 0)
        != 0
    )
    counts = np.diff(np.append(group_start, len(sorted_nodes)))
    pos = np.arange(len(sorted_nodes)) - np.repeat(group_start, counts)
    P = int(counts.max()) if len(counts) else 0
    node_slots = np.full((n_node, max(P, 1)), -1, dtype=np.int64)
    node_slots[sorted_nodes, pos] = np.repeat(np.arange(len(bnodes)), 2)[order]
    is_boundary_node = np.zeros(n_node, dtype=bool)
    is_boundary_node[flat] = True
    return {
        "proj": proj,
        "face": bface,
        "keep": keep,
        "node_slots": node_slots,
        "is_boundary_node": is_boundary_node,
    }


def _trim_padding(ids: np.ndarray) -> np.ndarray:
    """Drop trailing all-fill columns of a padded connectivity."""
    valid_cols = (ids >= 0).any(axis=0)
    if valid_cols.all():
        return ids
    last = int(np.flatnonzero(valid_cols).max()) + 1 if valid_cols.any() else 1
    return ids[:, :last]


def angle_sort_rows(
    cand: np.ndarray, coords: np.ndarray, anchors: np.ndarray, device=None
) -> np.ndarray:
    """
    Sort each row's valid candidates counter-clockwise by polar angle
    around the row's anchor; padding moves to the row tail.

    cand: (R, C) candidate ids into ``coords`` (-1 padded).
    coords: (V, 2); anchors: (R, 2).
    device: where the sort runs when the (R, C, 2) offsets hold at least
        ``DEVICE_MIN`` values (torch ``atan2`` and a stable ``argsort``);
        None means the CUDA card, and raises without one.  Smaller tables
        sort in numpy, and resolve no device.
    """
    valid = cand >= 0
    pts = coords[np.maximum(cand, 0)]
    # Subtract the anchors in float64 on the host first, so that the
    # angles keep their relative precision at large coordinates (UTM).
    deltas = pts - anchors[:, None, :]
    with timed("voronoi.angle_sort"):
        if deltas.size >= DEVICE_MIN:
            device = resolve_device(None, device)
            d = torch.from_numpy(deltas).to(device)
            ang = torch.atan2(d[..., 1], d[..., 0])
            key = torch.where(torch.from_numpy(valid).to(device), ang, torch.inf)
            order = torch.argsort(key, dim=1, stable=True).cpu().numpy()
        else:
            ang = np.arctan2(deltas[..., 1], deltas[..., 0])
            key = np.where(valid, ang, np.inf)
            order = np.argsort(key, axis=1)
    return np.take_along_axis(np.where(valid, cand, -1), order, axis=1)


def padded_row_areas(ids_sorted: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Signed shoelace area per padded polygon row (pads repeat the
    first vertex, contributing zero)."""
    valid = ids_sorted >= 0
    first = np.where(valid[:, 0], ids_sorted[:, 0], 0)
    filled = np.where(valid, ids_sorted, first[:, None])
    xy = coords[filled]
    nxt = np.roll(xy, -1, axis=1)
    return 0.5 * (xy[:, :, 0] * nxt[:, :, 1] - xy[:, :, 1] * nxt[:, :, 0]).sum(axis=1)


def voronoi_topology(
    node_face_connectivity: sparse.csr_matrix,
    vertices: np.ndarray,
    centroids: np.ndarray,
    edge_face_connectivity: Optional[np.ndarray] = None,
    edge_node_connectivity: Optional[np.ndarray] = None,
    add_exterior: bool = False,
    add_vertices: bool = False,
    skip_concave: bool = False,
    *,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """
    Centroidal voronoi tessellation of a mesh of convex cells.

    Parameters
    ----------
    node_face_connectivity: csr_matrix (n_node, n_face)
    vertices: (n_vertex, 2)
    centroids: (n_centroid, 2)
    edge_face_connectivity, edge_node_connectivity: required when
        add_exterior is True.
    add_exterior: include exterior edges (boundary-centroid projections).
    add_vertices: include the original exterior vertices (may produce
        concave cells).
    skip_concave: with add_vertices, keep the convex substitute where the
        original vertex would create a concave cell.
    device: where the angle sort of a large table runs
        (``angle_sort_rows``); None means the CUDA card.

    Returns
    -------
    nodes: (n_vor_vertex, 2)
    face_node_connectivity: padded dense int array (one row per emitted
        mesh node, CCW sorted)
    face_index: (n_vor_vertex,) original face per voronoi node (-1 for
        interpolated exterior vertices belonging to two faces)
    interpolation_map: (n_interpolated, 2) voronoi-vertex ids each
        substitute was interpolated from, or None
    """
    if add_exterior and (edge_face_connectivity is None or edge_node_connectivity is None):
        raise ValueError(
            "edge_face_connectivity, edge_node_connectivity must be "
            "provided if add_exterior is True."
        )

    node_face = to_dense(node_face_connectivity)  # (n_node, K)
    n_node, K = node_face.shape
    n_face = node_face_connectivity.shape[1]
    n_per_node = (node_face >= 0).sum(axis=1)

    if not add_exterior:
        # Interior cells only: nodes fully surrounded by >= 3 faces.
        rows = np.flatnonzero(n_per_node >= 3)
        sorted_ids = angle_sort_rows(node_face[rows], centroids, vertices[rows], device)
        used = np.unique(sorted_ids[sorted_ids >= 0])
        faces = renumber(_trim_padding(sorted_ids))
        return centroids[used], faces, used, None

    bp = boundary_projections(edge_face_connectivity, edge_node_connectivity, vertices, centroids)
    keep = bp["keep"]
    n_kept = int(keep.sum())
    # Global voronoi-vertex ids: [centroids | kept projections | subs].
    proj_vid = np.full(len(keep), -1, dtype=np.int64)
    proj_vid[keep] = n_face + np.arange(n_kept)

    ext_nodes = np.flatnonzero(bp["is_boundary_node"])
    P = bp["node_slots"].shape[1]
    C = K + P + (1 if add_vertices else 0)
    cand = np.full((n_node, C), -1, dtype=np.int64)
    cand[:, :K] = node_face
    slots = bp["node_slots"]  # (n_node, P) -> projection index or -1
    cand[:, K : K + P] = np.where(slots >= 0, proj_vid[np.maximum(slots, 0)], -1)

    n_sub = len(ext_nodes) if add_vertices else 0
    interpolation_map = None
    sub_coords = np.zeros((0, 2))
    if add_vertices:
        # Substitute vertex per boundary node: midpoint of its first two
        # adjacent projections, a convex placement used for the angle
        # sort; restored to the original vertex afterwards (everywhere,
        # or only where convexity survives).
        p0 = slots[ext_nodes, 0]
        p1 = slots[ext_nodes, 1] if P > 1 else p0
        p1 = np.where(p1 >= 0, p1, p0)
        sub_coords = 0.5 * (bp["proj"][p0] + bp["proj"][p1])
        cand[ext_nodes, K + P] = n_face + n_kept + np.arange(n_sub)
        # Map each substitute to the voronoi vertices it interpolates:
        # the kept projection, or the coinciding face centroid when the
        # projection was dropped as degenerate.
        m0 = np.where(keep[p0], proj_vid[p0], bp["face"][p0])
        m1 = np.where(keep[p1], proj_vid[p1], bp["face"][p1])
        interpolation_map = np.column_stack([m0, m1])

    vor_vertices = np.concatenate([centroids, bp["proj"][keep], sub_coords])
    face_index = np.concatenate(
        [np.arange(n_face), bp["face"][keep], np.full(n_sub, -1, dtype=np.int64)]
    )

    # One polygon per node that has any candidates.  Interior rows
    # anchor on the node itself; boundary rows anchor on the candidate
    # mean (the node lies ON the hull, where angles degenerate).
    rows = np.flatnonzero(n_per_node >= 1)
    cand = cand[rows]
    valid = cand >= 0
    xy = vor_vertices[np.maximum(cand, 0)]
    counts = valid.sum(axis=1)
    mean = np.where(valid[..., None], xy, 0.0).sum(axis=1) / counts[:, None]
    anchors = np.where(bp["is_boundary_node"][rows][:, None], mean, vertices[rows])
    sorted_ids = angle_sort_rows(cand, vor_vertices, anchors, device)

    if add_vertices and n_sub > 0:
        orig = vertices[ext_nodes]
        if skip_concave:
            # Signed area with the midpoint substitute against with the
            # original vertex, in the same sorted order.
            sub_rows = np.searchsorted(rows, ext_nodes)
            convex_area = padded_row_areas(sorted_ids[sub_rows], vor_vertices)
            modified = vor_vertices.copy()
            modified[n_face + n_kept :] = orig
            modified_area = padded_row_areas(sorted_ids[sub_rows], modified)
            use_original = np.abs(modified_area) >= np.abs(convex_area)
            vor_vertices[n_face + n_kept :][use_original] = orig[use_original]
        else:
            vor_vertices[n_face + n_kept :] = orig

    return vor_vertices, _trim_padding(sorted_ids), face_index, interpolation_map
