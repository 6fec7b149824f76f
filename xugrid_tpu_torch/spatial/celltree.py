"""
CellTree2d: the spatial index over the faces of a 2D mesh, reduced to
the area-of-overlap join of the overlap regridders.

The candidate join runs on the host grid hash (``spatial/grid_hash.py``)
and the exact overlap areas on the native host polygon clip
(``csrc/host_kernels.cpp``), as on ``xugrid_tpu``'s default path.

Convention: joins return ``(query_index, tree_index, payload)``.
"""

from __future__ import annotations

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
