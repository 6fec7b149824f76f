"""Padded polygon buffers for the exact geometry tests (host, numpy)."""

from __future__ import annotations

import numpy as np


def pad_polygons(face_node_connectivity, node_x, node_y):
    """
    Gather per-face vertex buffers, replacing -1 fills with the first
    valid vertex so padding edges have zero length.

    Returns (n_face, n_max, 2) float64.
    """
    from xugrid_tpu_torch.utils.native import pad_and_bbox_native

    native = pad_and_bbox_native(face_node_connectivity, node_x, node_y)
    if native is not None:
        return native[0]
    conn = np.asarray(face_node_connectivity)
    # First VALID node per row: a malformed row may lead with a fill.
    valid = conn >= 0
    rows = np.arange(len(conn))
    first = np.where(
        valid.any(axis=1), conn[rows, np.argmax(valid, axis=1)], 0
    )[:, None]
    filled = np.where(conn < 0, first, conn)
    x = np.asarray(node_x, dtype=np.float64)
    y = np.asarray(node_y, dtype=np.float64)
    out = np.empty(filled.shape + (2,), dtype=np.float64)
    out[..., 0] = x[filled]
    out[..., 1] = y[filled]
    return out
