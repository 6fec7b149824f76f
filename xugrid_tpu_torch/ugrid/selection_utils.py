"""
Cross-section coordinates: the samples of a line selection ordered by
their distance along the line, with the ``{name}_x``, ``{name}_y`` and
``{name}_s`` coordinates the selection attaches.  A copy of
``xugrid_tpu/ugrid/selection_utils.py`` (host numpy).
"""

from __future__ import annotations

import numpy as np


def section_coordinates(edges: np.ndarray, xy: np.ndarray, dim: str, index: np.ndarray, name: str):
    """
    Order section samples by distance from the line's first vertex and
    build their coordinates.

    Parameters
    ----------
    edges: (n_segment, 2, 2) the section line's segments; ``s`` is
        measured from the first vertex.
    xy: (n, 2) sample points, or (n, 2, 2) sampled sub-segments
        (collapsed to their midpoints).
    dim, index, name: the output dimension, the entity index per sample,
        and the coordinates' name prefix.

    Returns
    -------
    coords: {f"{name}_x", f"{name}_y", f"{name}_s"} mapped to
        ``(dim, values)``, sorted by ``s``; and the entity indices in
        that order.
    """
    pts = np.asarray(xy)
    if pts.ndim == 3:
        pts = pts.mean(axis=1)
    origin = np.asarray(edges)[0, 0]
    delta = pts - origin
    s = np.hypot(delta[:, 0], delta[:, 1])
    order = np.argsort(s, kind="stable")
    return (
        {
            f"{name}_x": (dim, pts[order, 0]),
            f"{name}_y": (dim, pts[order, 1]),
            f"{name}_s": (dim, s[order]),
        },
        np.asarray(index)[order],
    )


def get_sorted_section_coords(s: np.ndarray, xy: np.ndarray, dim: str, index: np.ndarray, name: str):
    """``section_coordinates`` of samples whose distance ``s`` along the
    line is given."""
    order = np.argsort(s, kind="stable")
    return (
        {
            f"{name}_x": (dim, xy[order, 0]),
            f"{name}_y": (dim, xy[order, 1]),
            f"{name}_s": (dim, s[order]),
        },
        np.asarray(index)[order],
    )


section_coordinates_1d = section_coordinates
section_coordinates_2d = section_coordinates
