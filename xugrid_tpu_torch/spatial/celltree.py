"""
CellTree2d: the spatial index over the faces of a 2D mesh, reduced to
the joins of the regridders: area of overlap, point location, segment
clip and mean-value (barycentric) weights.

The candidate joins run on the host grid hash (``spatial/grid_hash.py``)
and the exact geometry on the native host kernels
(``csrc/host_kernels.cpp``), as on ``xugrid_tpu``'s default path.  Where
``xugrid_tpu`` falls back to a device kernel without the native library,
these raise.

Convention: joins return ``(query_index, tree_index, payload)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from xugrid_tpu_torch.spatial.bvh import face_bounding_boxes
from xugrid_tpu_torch.spatial.geometry import pad_polygons
from xugrid_tpu_torch.spatial.grid_hash import GridHash
from xugrid_tpu_torch.utils.profiling import timed


class CellTree2d:
    """Spatial index over the faces of a 2D unstructured grid."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray, fill_value: int = -1):
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

    def default_tolerance(self) -> float:
        """On-edge tolerance of point location: 1e-12 of the largest face
        bounding-box diagonal."""
        return float(np.sqrt(np.nanmax(self._diag2))) * 1e-12

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

    def intersect_faces(self, vertices: np.ndarray, faces: np.ndarray, fill_value: int = -1):
        """
        Area-of-overlap join between query polygons and tree faces.

        Returns (query_face_index, tree_face_index, area).
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

        from xugrid_tpu_torch.utils.native import polygon_clip_areas_conn_native

        with timed("celltree.exact_overlap_areas"):
            areas = polygon_clip_areas_conn_native(
                query_index, tree_index, query_xy,
                self.faces, self.vertices[:, 0], self.vertices[:, 1],
            )
        if areas is None:
            raise RuntimeError(
                "overlap areas need the native host library (g++) and "
                "faces of at most 32 nodes"
            )
        keep = areas > self._pair_area_tolerance(boxes, query_index, tree_index)
        return query_index[keep], tree_index[keep], areas[keep]

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

    def compute_barycentric_weights(self, points: np.ndarray, tolerance: Optional[float] = None):
        """
        Locate points and compute the mean-value (generalized barycentric)
        weights of the vertices of the face holding each.

        Returns (face_index (n,), weights (n, n_max_node)); the weights
        are a new array, zero in the rows of points outside every face.
        """
        from xugrid_tpu_torch.utils.native import mean_value_weights_native

        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        face_index = self.locate_points(points, tolerance)
        with timed("celltree.mean_value_weights"):
            weights = mean_value_weights_native(
                points, face_index.astype(np.int64), self._poly_xy_host, self._tol(tolerance)
            )
        if weights is None:
            raise RuntimeError(
                "barycentric weights need the native host library (g++) and faces of at most 64 nodes"
            )
        return face_index, weights
