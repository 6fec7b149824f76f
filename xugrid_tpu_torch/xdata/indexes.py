"""Label-based indexing helpers (pandas, on the host)."""

from __future__ import annotations

from typing import Any

import numpy as np
import pandas as pd


def as_index(values) -> pd.Index:
    return pd.Index(np.asarray(values))


def stacked_multiindex(dim, encoding, coords) -> "pd.MultiIndex | None":
    """The pandas MultiIndex of a stacked dim, from the ``_stacked_<dim>``
    entry of ``encoding`` (its level names) and the level coordinates; None
    when the dim is not stacked or a level coordinate was dropped.  The
    level coordinates are host numpy, so this never touches a device."""
    key = "_stacked_" + dim
    if key not in encoding:
        return None
    levels, _sizes = encoding[key]
    arrays = []
    for name in levels:
        var = coords.get(name)
        if var is None or tuple(var.dims) != (dim,):
            return None
        arrays.append(np.asarray(var.data))
    return pd.MultiIndex.from_arrays(arrays, names=list(levels))


def resolve_label_indexer(index: pd.Index, indexer: Any, method=None, tolerance=None):
    """
    Translate a label-based indexer (scalar, slice, or array of labels)
    into positional indices along one dimension.  ``tolerance`` bounds
    the label distance of inexact ``method`` matches: farther matches
    raise KeyError.
    """
    if isinstance(indexer, slice):
        return index.slice_indexer(indexer.start, indexer.stop, indexer.step)
    if np.ndim(indexer) == 0:
        if method is None:
            loc = index.get_loc(indexer)
        else:
            loc = index.get_indexer([indexer], method=method, tolerance=tolerance)[0]
            if loc == -1:
                raise KeyError(indexer)
        return int(loc) if np.isscalar(loc) or isinstance(loc, (int, np.integer)) else loc
    labels = np.asarray(indexer)
    locs = index.get_indexer(labels, method=method, tolerance=tolerance)
    if (locs == -1).any():
        missing = labels[locs == -1]
        raise KeyError(f"not all values found in index: {missing[:10]}")
    return locs
