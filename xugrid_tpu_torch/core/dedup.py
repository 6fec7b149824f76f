"""
Row deduplication by exact (bytewise) equality, the kernel of
``merge_partitions``: stacked node coordinates and connectivity rows of
the partitions become one set, in first-seen order.

Two paths, the port of ``xugrid_tpu/core/dedup.py``:

* the host path (the default): the native hashed pass of
  ``csrc/host_kernels.cpp`` (``unique_rows_hash``), one probe per row
  in first-seen order, with no sort;
* the grouping on a device, when ``device`` is given: the rows as u32
  key columns (a float64 column is two, so -0.0 and +0.0, and NaNs of
  different payloads, stay apart), stable sorts from the last key to the
  first, a cumulative sum over the neighbour inequality for the group
  labels, the inverse scattered back, and each group's first occurrence
  by a scatter minimum, as torch ops.

``unique_rows_plain`` is the same grouping in numpy, the reference the
tests hold both paths to.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_u32_columns(rows: np.ndarray) -> np.ndarray:
    """Each row viewed as uint32 key columns (bytewise equality)."""
    rows = np.ascontiguousarray(rows)
    if rows.ndim != 2:
        raise ValueError(f"expected 2D rows, got shape {rows.shape}")
    if rows.dtype.itemsize % 4 != 0:
        # Promote sub-4-byte ints; exact for all practical connectivity.
        rows = rows.astype(np.int32)
    return rows.view(np.uint32).reshape(rows.shape[0], -1)


def _group_rows_device(cols: torch.Tensor):
    """
    Group equal rows of ``cols``, (n, k) u32 key values held in int64:
    (inverse (n,), rep (n_unique,), n_unique), ``inverse`` each row's
    group in the lexicographic order of the keys and ``rep`` each
    group's smallest row index.

    Two u32 keys make one int64 sort key, (hi - 2^31) * 2^32 + lo, whose
    signed order is the pair's lexicographic order, so k keys take
    ceil(k / 2) stable sorts.
    """
    n, n_cols = cols.shape
    device = cols.device
    order = torch.arange(n, device=device)
    for c in range(n_cols - 1, -1, -2):
        key = cols[order, c]
        if c > 0:
            key = (cols[order, c - 1] - (1 << 31)) * (1 << 32) + key
        order = order[torch.sort(key, stable=True).indices]
    s = cols[order]
    is_first = torch.ones(n, dtype=torch.bool, device=device)
    is_first[1:] = (s[1:] != s[:-1]).any(dim=1)
    group = torch.cumsum(is_first, 0) - 1
    inverse = torch.empty(n, dtype=torch.int64, device=device).scatter_(0, order, group)
    n_unique = int(group[-1]) + 1
    rep = torch.full((n_unique,), n, dtype=torch.int64, device=device)
    rep = rep.scatter_reduce(0, group, order, "amin", include_self=True)
    return inverse, rep, n_unique


def _first_seen(rep, inverse_group):
    """Groups renumbered by their first occurrence: (index, inverse)."""
    if isinstance(rep, torch.Tensor):
        order = torch.argsort(rep, stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(len(order), device=order.device)
        return rep[order], rank[inverse_group]
    order = np.argsort(rep, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rep[order], rank[inverse_group]


def unique_rows(rows: np.ndarray, device=None):
    """
    Deduplicate rows by exact (bytewise) equality.

    Returns ``(index, inverse)``, int64 numpy: ``index`` holds the
    ascending positions of first occurrences (``rows[index]`` is the
    unique set in first-seen order) and ``inverse`` maps every row to
    its position in that ordering.  With ``device`` None the native
    hashed pass runs on the host (it raises without the native library);
    else the torch grouping runs on ``device``.
    """
    n = len(rows)
    if n == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    if device is None:
        from xugrid_tpu_torch.utils.native import unique_rows_hash_native

        native = unique_rows_hash_native(np.ascontiguousarray(rows))
        if native is None:
            raise RuntimeError("unique_rows needs the native host library (g++)")
        rep, inverse, _ = native
        return rep, inverse
    cols = torch.from_numpy(_to_u32_columns(rows).astype(np.int64)).to(device)
    inverse_group, rep, _ = _group_rows_device(cols)
    index, inverse = _first_seen(rep, inverse_group)
    return index.cpu().numpy(), inverse.cpu().numpy()


def unique_rows_plain(rows: np.ndarray):
    """``unique_rows`` in numpy: a stable lexsort over the u32 key
    columns and the neighbour grouping, the reference of both paths."""
    n = len(rows)
    if n == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    cols = _to_u32_columns(rows)
    order = np.lexsort(tuple(cols[:, c] for c in range(cols.shape[1] - 1, -1, -1)))
    s = cols[order]
    is_first = np.empty(n, dtype=bool)
    is_first[0] = True
    np.any(s[1:] != s[:-1], axis=1, out=is_first[1:])
    group = np.cumsum(is_first) - 1
    inverse_group = np.empty(n, dtype=np.int64)
    inverse_group[order] = group
    # The lexsort is stable: each group's first sorted row is its
    # smallest position.
    return _first_seen(order[is_first], inverse_group)
