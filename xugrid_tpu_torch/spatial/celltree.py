"""
CellTree2d: the spatial index over the faces of a 2D mesh, reduced to
the joins of the regridders: area of overlap, point location, segment
clip and mean-value (barycentric) weights.  EdgeCellTree2d: the index
over the edges of a 1D network: points on edges within a tolerance, and
segment-edge intersections (host numpy over the grid hash).

The candidate joins run on the host grid hash (``spatial/grid_hash.py``)
and the exact geometry on the native host kernels
(``csrc/host_kernels.cpp``), as on ``xugrid_tpu``'s default path.  Where
the native kernels decline faces by size (overlap areas above 32 tree
nodes, then above 96 nodes of both polygons; mean-value weights above
64 nodes), the geometry runs as batched torch ops on a device
(``spatial/geometry.py``), in chunks, as ``xugrid_tpu`` runs its device
kernels there.  Without the native library everything raises.

Convention: joins return ``(query_index, tree_index, payload)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from xugrid_tpu_torch.spatial import geometry, queries
from xugrid_tpu_torch.spatial.bvh import edge_bounding_boxes, face_bounding_boxes
from xugrid_tpu_torch.spatial.geometry import pad_polygons
from xugrid_tpu_torch.spatial.grid_hash import GridHash
from xugrid_tpu_torch.utils.device import resolve_device
from xugrid_tpu_torch.utils.profiling import timed

#: Candidate values per chunk of the device geometry: a pair of polygons
#: of m and k nodes holds m + k + m k candidate points.
DEVICE_CHUNK = 1 << 22


def _bb_distances(bb_coords: np.ndarray) -> np.ndarray:
    dx = bb_coords[:, 2] - bb_coords[:, 0]
    dy = bb_coords[:, 3] - bb_coords[:, 1]
    return np.column_stack([dx, dy, np.hypot(dx, dy)])


def _require_native_library() -> None:
    """Raise where the native host library cannot be built: only a
    decline by size takes the device geometry."""
    from xugrid_tpu_torch.utils.native import get_lib

    if get_lib() is None:
        raise RuntimeError("the exact geometry needs the native host library (g++)")


def overlap_areas_device(query_index, tree_index, query_xy, tree_xy, device) -> np.ndarray:
    """Convex overlap area of query_xy[query_index[i]] and
    tree_xy[tree_index[i]] per pair, on ``device`` in chunks: float64."""
    device = resolve_device(None, device)
    m, k = query_xy.shape[1], tree_xy.shape[1]
    chunk = max(1, DEVICE_CHUNK // (m + k + m * k))
    areas = np.empty(len(query_index), dtype=np.float64)
    for start in range(0, len(query_index), chunk):
        stop = start + chunk
        subject = torch.from_numpy(query_xy[query_index[start:stop]]).to(device)
        clip = torch.from_numpy(tree_xy[tree_index[start:stop]]).to(device)
        areas[start:stop] = geometry.convex_overlap_areas(subject, clip).cpu().numpy()
    return areas


def mean_value_weights_device(points, face_index, poly_xy, tolerance: float, device) -> np.ndarray:
    """Mean-value weights of points[i] in poly_xy[face_index[i]], a zero
    row where face_index[i] < 0, on ``device`` in chunks: (n, n_max)."""
    device = resolve_device(None, device)
    n_max = poly_xy.shape[1]
    chunk = max(1, DEVICE_CHUNK // n_max)
    weights = np.zeros((len(points), n_max), dtype=np.float64)
    for start in range(0, len(points), chunk):
        stop = start + chunk
        face = face_index[start:stop]
        w = geometry.mean_value_weights(
            torch.from_numpy(points[start:stop]).to(device),
            torch.from_numpy(poly_xy[np.maximum(face, 0)]).to(device),
            tolerance,
        )
        weights[start:stop] = np.where((face >= 0)[:, None], w.cpu().numpy(), 0.0)
    return weights


class CellTree2d:
    """Spatial index over the faces of a 2D unstructured grid."""

    #: Queries per pass of the device query kernels (``spatial/queries.py``).
    CHUNK = queries.CHUNK

    def __init__(self, vertices: np.ndarray, faces: np.ndarray, fill_value: int = -1, leaf_size: int = 8):
        """``leaf_size`` is taken, and unused, as in ``xugrid_tpu``: the
        grid hash has no leaves (``spatial/bvh.py:build_bvh`` takes one)."""
        vertices = np.asarray(vertices, dtype=np.float64)
        faces = np.asarray(faces)
        if fill_value != -1:
            faces = np.where(faces == fill_value, -1, faces)
        self.vertices = vertices
        self.faces = faces
        self.n_face = len(faces)
        self.bb_coords = face_bounding_boxes(faces, vertices[:, 0], vertices[:, 1])
        self.grid_hash = GridHash(self.bb_coords)
        dx = self.bb_coords[:, 2] - self.bb_coords[:, 0]
        dy = self.bb_coords[:, 3] - self.bb_coords[:, 1]
        self._diag2 = dx * dx + dy * dy
        self._poly_xy_cache = None

    @property
    def _poly_xy_host(self) -> np.ndarray:
        """(n_face, n_max, 2) padded face vertices, built on first use:
        the overlap join gathers from the connectivity and never needs it."""
        if self._poly_xy_cache is None:
            self._poly_xy_cache = pad_polygons(self.faces, self.vertices[:, 0], self.vertices[:, 1])
        return self._poly_xy_cache

    @property
    def bb_distances(self) -> np.ndarray:
        """(n_face, 3): bounding box width, height and diagonal."""
        return _bb_distances(self.bb_coords)

    @property
    def bounds(self):
        """(xmin, ymin, xmax, ymax) of the grid hash's bins."""
        gh = self.grid_hash
        return (gh.xmin, gh.ymin, gh.xmin + gh.nx * gh.dx, gh.ymin + gh.ny * gh.dy)

    def default_tolerance(self) -> float:
        """On-edge tolerance of point location: 1e-12 of the largest face
        bounding-box diagonal."""
        return float(np.sqrt(np.nanmax(self._diag2))) * 1e-12

    def default_area_tolerance(self) -> float:
        """Threshold separating real overlap slivers from the FP noise of
        boundary-grazing polygon pairs: 1e-12 of the largest face
        bounding-box diagonal squared."""
        return float(np.sqrt(np.nanmax(self._diag2))) ** 2 * 1e-12

    def _tol(self, tolerance: Optional[float]) -> float:
        return self.default_tolerance() if tolerance is None else float(tolerance)

    def _pair_area_tolerance(self, query_boxes, query_index, tree_index):
        """Per-pair sliver threshold: scales with the SMALLER of the two
        polygons' bbox diagonals, so genuine overlaps of small faces are
        not discarded on meshes that also contain very large faces."""
        qdx = query_boxes[:, 2] - query_boxes[:, 0]
        qdy = query_boxes[:, 3] - query_boxes[:, 1]
        q_diag2 = qdx * qdx + qdy * qdy
        return np.minimum(q_diag2[query_index], self._diag2[tree_index]) * 1e-12

    def intersect_faces(self, vertices: np.ndarray, faces: np.ndarray, fill_value: int = -1, device=None):
        """
        Area-of-overlap join between query polygons and tree faces.

        The native clips take polygons up to their sizes; larger ones go
        to ``device`` (None: the CUDA card, which must be present unless
        ``device="cpu"``).  Returns (query_face_index, tree_face_index,
        area).
        """
        vertices = np.asarray(vertices, dtype=np.float64)
        faces = np.asarray(faces)
        if fill_value != -1:
            faces = np.where(faces == fill_value, -1, faces)
        boxes = face_bounding_boxes(faces, vertices[:, 0], vertices[:, 1])
        query_index, tree_index = self.grid_hash.query_boxes(boxes)
        if len(query_index) == 0:
            return query_index, tree_index, np.empty(0, dtype=np.float64)
        query_xy = pad_polygons(faces, vertices[:, 0], vertices[:, 1])

        from xugrid_tpu_torch.utils.native import polygon_clip_areas_conn_native, polygon_clip_areas_native

        _require_native_library()
        with timed("celltree.exact_overlap_areas"):
            # Gather the tree polygons from the connectivity; then from the
            # padded buffer, which takes larger tree faces.
            areas = polygon_clip_areas_conn_native(
                query_index, tree_index, query_xy,
                self.faces, self.vertices[:, 0], self.vertices[:, 1],
            )
            if areas is None:
                areas = polygon_clip_areas_native(query_index, tree_index, query_xy, self._poly_xy_host)
        if areas is None:
            with timed("celltree.exact_overlap_areas_device"):
                areas = overlap_areas_device(query_index, tree_index, query_xy, self._poly_xy_host, device)
        keep = areas > self._pair_area_tolerance(boxes, query_index, tree_index)
        return query_index[keep], tree_index[keep], areas[keep]

    def locate_faces(self, vertices: np.ndarray, faces: np.ndarray, fill_value: int = -1, device=None):
        """(query polygon, tree face) pairs with positive overlap."""
        qi, ti, _ = self.intersect_faces(vertices, faces, fill_value, device=device)
        return qi, ti

    def locate_points(self, points: np.ndarray, tolerance: Optional[float] = None) -> np.ndarray:
        """Index of the face holding each point, the lowest one where
        several do (within the on-edge tolerance), -1 where none does."""
        from xugrid_tpu_torch.utils.native import locate_points_hash_native, points_in_polygons_native

        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        n = len(points)
        tol = self._tol(tolerance)
        # Fused native path: candidate scan and exact test in one pass.
        # It refuses a hash with oversize faces, which bypass the bins.
        with timed("celltree.locate_points"):
            fused = locate_points_hash_native(points, tol, self.grid_hash, self._poly_xy_host)
        if fused is not None:
            return fused.astype(np.int32)
        pair_q, pair_p = self.grid_hash.query_points(points, tol)
        out = np.full(n, -1, dtype=np.int32)
        if len(pair_q) == 0:
            return out
        with timed("celltree.exact_point_in_face"):
            inside = points_in_polygons_native(points[pair_q], pair_p, self._poly_xy_host, tol)
        if inside is None:
            raise RuntimeError("point location needs the native host library (g++)")
        hit_q, hit_p = pair_q[inside], pair_p[inside]
        big = np.iinfo(np.int32).max
        best = np.full(n, big, dtype=np.int64)
        np.minimum.at(best, hit_q, hit_p)
        found = best != big
        out[found] = best[found]
        return out

    def intersect_edges(self, edges: np.ndarray):
        """
        Clip line segments (n, 2, 2) by the faces.

        Returns (edge_index, face_index, intersections (k, 2, 2)): the
        part of each segment inside each face it crosses.
        """
        from xugrid_tpu_torch.utils.native import clip_segments_by_faces_native

        edges = np.asarray(edges, dtype=np.float64)
        boxes = np.concatenate([edges.min(axis=1), edges.max(axis=1)], axis=1)
        edge_index, face_index = self.grid_hash.query_boxes(boxes)
        if len(edge_index) == 0:
            return edge_index, face_index, np.empty((0, 2, 2), dtype=np.float64)
        with timed("celltree.clip_segments"):
            native = clip_segments_by_faces_native(
                edges[edge_index, 0], edges[edge_index, 1], face_index, self._poly_xy_host
            )
        if native is None:
            raise RuntimeError("segment clipping needs the native host library (g++)")
        return self._intersect_edges_finish(edges, edge_index, face_index, *native)

    @staticmethod
    def _intersect_edges_finish(edges, edge_index, face_index, valid, t0, t1):
        edge_index = edge_index[valid]
        face_index = face_index[valid]
        a = edges[edge_index, 0]
        d = edges[edge_index, 1] - a
        start_xy = a + t0[valid][:, None] * d
        end_xy = a + t1[valid][:, None] * d
        return edge_index, face_index, np.stack([start_xy, end_xy], axis=1)

    def compute_barycentric_weights(self, points: np.ndarray, tolerance: Optional[float] = None, device=None):
        """
        Locate points and compute the mean-value (generalized barycentric)
        weights of the vertices of the face holding each.  Faces above
        the native kernel's 64 nodes go to ``device`` (None: the CUDA
        card, which must be present unless ``device="cpu"``).

        Returns (face_index (n,), weights (n, n_max_node)); the weights
        are a new array, zero in the rows of points outside every face.
        """
        from xugrid_tpu_torch.utils.native import mean_value_weights_native

        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        face_index = self.locate_points(points, tolerance)
        _require_native_library()
        with timed("celltree.mean_value_weights"):
            weights = mean_value_weights_native(
                points, face_index.astype(np.int64), self._poly_xy_host, self._tol(tolerance)
            )
        if weights is None:
            with timed("celltree.mean_value_weights_device"):
                weights = mean_value_weights_device(
                    points, face_index, self._poly_xy_host, self._tol(tolerance), device
                )
        return face_index, weights


class EdgeCellTree2d:
    """Spatial index over the edges of a 1D network."""

    CHUNK = CellTree2d.CHUNK

    def __init__(self, vertices: np.ndarray, edge_node_connectivity: np.ndarray, leaf_size: int = 8):
        """``leaf_size`` is taken, and unused, as in ``xugrid_tpu``."""
        vertices = np.asarray(vertices, dtype=np.float64)
        conn = np.asarray(edge_node_connectivity)
        self.vertices = vertices
        self.edges = conn
        self.n_edge = len(conn)
        self.bb_coords = edge_bounding_boxes(conn, vertices[:, 0], vertices[:, 1])
        self.grid_hash = GridHash(self.bb_coords)
        self._edge_xy = vertices[conn]

    @property
    def bb_distances(self) -> np.ndarray:
        """(n_edge, 3): bounding box width, height and diagonal."""
        return _bb_distances(self.bb_coords)

    def default_tolerance(self) -> float:
        """On-edge tolerance: 1e-12 of the largest bounding-box diagonal."""
        return float(np.nanmax(self.bb_distances[:, 2])) * 1e-12

    def _tol(self, tolerance: Optional[float]) -> float:
        return self.default_tolerance() if tolerance is None else float(tolerance)

    def locate_points(self, points: np.ndarray, tolerance: Optional[float] = None) -> np.ndarray:
        """Index of the edge each point lies on within the tolerance, the
        lowest one where several do, -1 where none does."""
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        n = len(points)
        tol = self._tol(tolerance)
        boxes = np.column_stack([points - tol, points + tol])
        pair_q, pair_p = self.grid_hash.query_boxes(boxes)
        out = np.full(n, -1, dtype=np.int32)
        if len(pair_q) == 0:
            return out
        # Distance of each point to each candidate segment.
        seg = self._edge_xy[pair_p]
        a = seg[:, 0]
        d = seg[:, 1] - a
        len2 = np.maximum((d * d).sum(axis=1), 1e-300)
        t = np.clip(((points[pair_q] - a) * d).sum(axis=1) / len2, 0.0, 1.0)
        closest = a + t[:, None] * d
        dist2 = ((points[pair_q] - closest) ** 2).sum(axis=1)
        on = dist2 <= tol * tol
        big = np.iinfo(np.int32).max
        best = np.full(n, big, dtype=np.int64)
        np.minimum.at(best, pair_q[on], pair_p[on])
        found = best != big
        out[found] = best[found]
        return out

    def intersect_edges(self, edges: np.ndarray):
        """
        Intersect query segments (n, 2, 2) with the network's edges.

        Returns (query_index, tree_edge_index, intersections (k, 2)).
        """
        edges = np.asarray(edges, dtype=np.float64)
        boxes = np.concatenate([edges.min(axis=1), edges.max(axis=1)], axis=1)
        query_index, tree_index = self.grid_hash.query_boxes(boxes)
        if len(query_index) == 0:
            return query_index, tree_index, np.empty((0, 2), dtype=np.float64)
        p0 = edges[query_index, 0]
        p1 = edges[query_index, 1]
        q0 = self._edge_xy[tree_index, 0]
        q1 = self._edge_xy[tree_index, 1]
        hits, pts = _segment_intersections(p0, p1, q0, q1)
        return query_index[hits], tree_index[hits], pts[hits]


def _segment_intersections(p0, p1, q0, q1):
    """Segments p0-p1 against q0-q1, pair by pair: (hit (k,), the point
    on p (k, 2)).  A collinear overlap reports its entry point on p."""
    r = p1 - p0
    s = q1 - q0
    denom = r[:, 0] * s[:, 1] - r[:, 1] * s[:, 0]
    qp = q0 - p0
    t_num = qp[:, 0] * s[:, 1] - qp[:, 1] * s[:, 0]
    u_num = qp[:, 0] * r[:, 1] - qp[:, 1] * r[:, 0]
    parallel = denom == 0.0
    safe = np.where(parallel, 1.0, denom)
    t = t_num / safe
    u = u_num / safe
    hit = ~parallel & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u <= 1.0)

    # Collinear overlap (parallel and q0 on p's line): intersect the
    # projected parameter intervals; the q0-side entry point represents
    # the overlap.
    rr = np.einsum("ij,ij->i", r, r)
    safe_rr = np.where(rr == 0.0, 1.0, rr)
    s0 = np.einsum("ij,ij->i", q0 - p0, r) / safe_rr
    s1 = np.einsum("ij,ij->i", q1 - p0, r) / safe_rr
    lo = np.maximum(np.minimum(s0, s1), 0.0)
    hi = np.minimum(np.maximum(s0, s1), 1.0)
    # t_num == 0 is NOT sufficient: a degenerate tree edge (q0 == q1,
    # s == 0) zeroes t_num wherever q0 lies.  q0 is on p's line iff
    # qp x r == 0 (u_num), which also implies t_num == 0 when r ∥ s.
    collinear = parallel & (t_num == 0.0) & (u_num == 0.0) & (rr > 0.0)
    col_hit = collinear & (lo <= hi)
    t = np.where(col_hit, lo, t)
    hit = hit | col_hit
    return hit, p0 + t[:, None] * r
