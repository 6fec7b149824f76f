"""
Ugrid2d: topology of a 2D unstructured mesh (UGRID conventions),
reduced to what the overlap regridders read.

The canonical storage is a padded dense int64 ``face_node_connectivity``
(fill -1, 0-based) plus float64 node x/y; face areas and the spatial
index are computed on first use and cached.
"""

from __future__ import annotations

import numpy as np

from xugrid_tpu_torch.constants import FILL_VALUE, FloatDType, IntDType
from xugrid_tpu_torch.ugrid import connectivity


class Ugrid2d:
    """
    Topological data of a 2-D unstructured grid.

    Parameters
    ----------
    node_x, node_y: ndarray of floats
    fill_value: int
        Fill value of the provided face_node_connectivity.
    face_node_connectivity: ndarray of integers
    start_index: 0 or 1, default 0
    """

    def __init__(self, node_x, node_y, fill_value: int, face_node_connectivity, start_index: int = 0):
        self.node_x = np.ascontiguousarray(node_x, dtype=FloatDType)
        self.node_y = np.ascontiguousarray(node_y, dtype=FloatDType)
        self.fill_value = fill_value
        if not isinstance(face_node_connectivity, np.ndarray):
            raise TypeError(
                "face_node_connectivity should be an array of integers, "
                f"received: {type(face_node_connectivity).__name__}"
            )
        conn = face_node_connectivity.copy()
        # Normalize to -1 fill and 0-based indices.
        if fill_value != FILL_VALUE or start_index != 0:
            is_fill = conn == fill_value
            if start_index != 0:
                conn[~is_fill] -= start_index
            if fill_value != FILL_VALUE:
                conn[is_fill] = FILL_VALUE
        self.face_node_connectivity = conn.astype(IntDType, copy=False)
        self._area = None
        self._celltree = None

    @property
    def n_face(self) -> int:
        return len(self.face_node_connectivity)

    @property
    def node_coordinates(self) -> np.ndarray:
        """(n_node, 2) node x and y."""
        return np.column_stack([self.node_x, self.node_y])

    @property
    def area(self) -> np.ndarray:
        """Area of every face."""
        if self._area is None:
            self._area = connectivity.area(
                self.face_node_connectivity, self.node_x, self.node_y
            )
        return self._area

    @property
    def celltree(self):
        """The spatial index over the faces."""
        if self._celltree is None:
            from xugrid_tpu_torch.spatial.celltree import CellTree2d

            self._celltree = CellTree2d(
                self.node_coordinates, self.face_node_connectivity, FILL_VALUE
            )
        return self._celltree
