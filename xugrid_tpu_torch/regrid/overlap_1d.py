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


#: Column pairs per block of ``overlap_1d_nd``, bounding its scratch.
ND_BLOCK_PAIRS = 1 << 18


def overlap_1d_nd(source_bounds, target_bounds, source_index, target_index):
    """
    Batched interval join: rows of (n, size, 2) bounds stacks paired by
    (source_index[k], target_index[k]).

    Returns flat indices into the bounds stacks, the overlap lengths and
    the pair k of each, in the order of ``_overlap_1d_single`` applied to
    every pair in turn (pair, then target row, then source row), which is
    the pair-by-pair loop of ``xugrid_tpu/regrid/overlap_1d.py``.

    The pairs are joined in blocks, all at once: each source row is
    compacted once (valid cells first, in order, then +inf), and one
    batched ``torch.searchsorted`` per block gives every pair's window
    bounds, the positions ``np.searchsorted`` finds in the compacted
    rows.
    """
    import torch

    source_bounds = np.asarray(source_bounds, dtype=np.float64)
    target_bounds = np.asarray(target_bounds, dtype=np.float64)
    source_index = np.asarray(source_index, dtype=IntDType)
    target_index = np.asarray(target_index, dtype=IntDType)
    source_size = source_bounds.shape[1]
    target_size = target_bounds.shape[1]

    source_valid = ~np.isnan(source_bounds).any(axis=2)
    target_valid = ~np.isnan(target_bounds).any(axis=2)
    # compact[r, c]: the position of row r's c-th valid cell.
    compact = np.argsort(~source_valid, axis=1, kind="stable")
    compacted = np.take_along_axis(source_bounds, compact[..., None], axis=1)
    compacted[~np.take_along_axis(source_valid, compact, axis=1)] = np.inf
    upper_edges = np.ascontiguousarray(compacted[..., 1])
    lower_edges = np.ascontiguousarray(compacted[..., 0])

    out_source, out_target, out_overlap, out_pair = [], [], [], []
    for start in range(0, len(source_index), ND_BLOCK_PAIRS):
        i = source_index[start : start + ND_BLOCK_PAIRS]
        j = target_index[start : start + ND_BLOCK_PAIRS]
        tgt = target_bounds[j]  # (k, T, 2)
        # Source cells [lower, upper) of each target, as in the single join.
        lower = torch.searchsorted(
            torch.from_numpy(upper_edges[i]), torch.from_numpy(np.ascontiguousarray(tgt[..., 0])), side="left"
        ).numpy()
        upper = torch.searchsorted(
            torch.from_numpy(lower_edges[i]), torch.from_numpy(np.ascontiguousarray(tgt[..., 1])), side="left"
        ).numpy()
        n_overlap = np.where(target_valid[j], np.maximum(upper, lower) - lower, 0).ravel()
        n_total = int(n_overlap.sum())
        if n_total == 0:
            continue
        cell = np.repeat(np.arange(len(n_overlap)), n_overlap)  # (pair, target) cell
        increment = np.arange(n_total) - np.repeat(alt_cumsum(n_overlap), n_overlap)
        k, t = np.divmod(cell, target_size)
        s_pos = compact[i[k], lower.ravel()[cell] + increment]
        overlap = vectorized_overlap(source_bounds[i[k], s_pos], tgt[k, t])
        valid = overlap > 0.0
        k, t, s_pos = k[valid], t[valid], s_pos[valid]
        out_source.append(i[k] * source_size + s_pos)
        out_target.append(j[k] * target_size + t)
        out_overlap.append(overlap[valid])
        out_pair.append(start + k)

    if not out_source:
        empty = np.empty(0, dtype=IntDType)
        return empty, empty, np.empty(0, dtype=np.float64), empty
    return (
        np.concatenate(out_source).astype(IntDType, copy=False),
        np.concatenate(out_target).astype(IntDType, copy=False),
        np.concatenate(out_overlap),
        np.concatenate(out_pair).astype(IntDType, copy=False),
    )
