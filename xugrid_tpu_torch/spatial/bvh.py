"""Bounding boxes of mesh faces and network edges (host, numpy)."""

from __future__ import annotations

import numpy as np


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
