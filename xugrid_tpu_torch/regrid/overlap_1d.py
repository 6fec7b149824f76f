"""
1D interval-overlap joins for structured regridding (host, numpy).

A searchsorted join over NaN-compacted bounds, O((n + m) log n), copied
from ``xugrid_tpu/regrid/overlap_1d.py``.  Bounds are monotonic
ascending; NaN rows are inactive cells.
"""

from __future__ import annotations

import numpy as np

from xugrid_tpu_torch.constants import IntDType
from xugrid_tpu_torch.regrid.utils import alt_cumsum


def vectorized_overlap(bounds_a, bounds_b):
    """Length of interval overlap per row pair."""
    return np.maximum(0.0, np.minimum(bounds_a[:, 1], bounds_b[:, 1]) - np.maximum(bounds_a[:, 0], bounds_b[:, 0]))


def _overlap_1d_single(source_bounds, target_bounds):
    """
    Join one pair of bounds rows.  Returns (source_pos, target_pos,
    overlap) with positions of the *input* rows (NaN rows never match).
    """
    source_valid = ~np.isnan(source_bounds).any(axis=1)
    src = source_bounds[source_valid]
    src_pos = np.flatnonzero(source_valid)

    target_valid = ~np.isnan(target_bounds).any(axis=1)
    tgt = target_bounds[target_valid]
    tgt_pos = np.flatnonzero(target_valid)

    empty = np.empty(0, dtype=IntDType), np.empty(0, dtype=IntDType), np.empty(0, dtype=np.float64)
    if len(src) == 0 or len(tgt) == 0:
        return empty

    # Source cells [lower, upper) overlapping each target interval: the
    # first source whose upper edge exceeds the target's lower edge, up
    # to the first source whose lower edge reaches the target's upper.
    lower = np.searchsorted(src[:, 1], tgt[:, 0], side="left")
    upper = np.searchsorted(src[:, 0], tgt[:, 1], side="left")
    upper = np.maximum(upper, lower)

    n_overlap = upper - lower
    n_total = int(n_overlap.sum())
    if n_total == 0:
        return empty

    target_take = np.repeat(np.arange(len(tgt)), n_overlap)
    increment = np.arange(n_total) - np.repeat(alt_cumsum(n_overlap), n_overlap)
    source_take = np.repeat(lower, n_overlap) + increment

    overlap = vectorized_overlap(src[source_take], tgt[target_take])
    valid = overlap > 0.0
    return src_pos[source_take[valid]], tgt_pos[target_take[valid]], overlap[valid]


def overlap_1d(source_bounds, target_bounds):
    """
    Interval-overlap join of two (n, 2) bounds arrays.

    Returns (source_index, target_index, overlap_length).
    """
    return _overlap_1d_single(
        np.asarray(source_bounds, dtype=np.float64), np.asarray(target_bounds, dtype=np.float64)
    )


def overlap_1d_nd(source_bounds, target_bounds, source_index, target_index):
    """
    Batched interval join: rows of (n, size, 2) bounds stacks paired by
    (source_index[k], target_index[k]).

    Returns flat indices into the bounds stacks, the overlap lengths and
    the pair k of each.
    """
    source_bounds = np.asarray(source_bounds, dtype=np.float64)
    target_bounds = np.asarray(target_bounds, dtype=np.float64)
    source_size = source_bounds.shape[1]
    target_size = target_bounds.shape[1]

    out_source, out_target, out_overlap, out_pair = [], [], [], []
    for k, (i, j) in enumerate(zip(np.asarray(source_index), np.asarray(target_index))):
        s_pos, t_pos, overlap = _overlap_1d_single(source_bounds[i], target_bounds[j])
        out_source.append(i * source_size + s_pos)
        out_target.append(j * target_size + t_pos)
        out_overlap.append(overlap)
        out_pair.append(np.full(len(overlap), k, dtype=IntDType))

    if not out_source:
        empty = np.empty(0, dtype=IntDType)
        return empty, empty, np.empty(0, dtype=np.float64), empty
    return (
        np.concatenate(out_source),
        np.concatenate(out_target),
        np.concatenate(out_overlap),
        np.concatenate(out_pair),
    )
