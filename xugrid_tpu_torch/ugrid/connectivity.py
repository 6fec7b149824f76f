"""Face geometry from connectivity (host, numpy)."""

from __future__ import annotations

import numpy as np

from xugrid_tpu_torch.constants import FILL_VALUE, IntDType


def cross2d(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """z-component of the cross product of 2D vectors (..., 2)."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def close_polygons(face_node_connectivity: np.ndarray):
    """
    Append the first node to every row and replace fills by the first
    node, yielding closed polygons.  Returns (closed, isfill), where
    isfill marks the replaced entries (shape (n, m+1)).
    """
    n, m = face_node_connectivity.shape
    closed = np.full((n, m + 1), FILL_VALUE, dtype=IntDType)
    closed[:, :-1] = face_node_connectivity
    isfill = closed == FILL_VALUE
    first = np.broadcast_to(face_node_connectivity[:, :1], (n, m + 1))
    closed = np.where(isfill, first, closed)
    return closed, isfill


def area_from_coordinates(coordinates: np.ndarray) -> np.ndarray:
    """Shoelace area of closed polygon rows (n, m+1, 2)."""
    xy0 = coordinates[:, :1]
    a = coordinates[:, :-1] - xy0
    b = coordinates[:, 1:] - xy0
    return 0.5 * np.abs(cross2d(a, b).sum(axis=1))


def area(face_node_connectivity, node_x, node_y) -> np.ndarray:
    """Area of every face."""
    nodes = np.column_stack([node_x, node_y])
    closed, _ = close_polygons(face_node_connectivity)
    return area_from_coordinates(nodes[closed])
