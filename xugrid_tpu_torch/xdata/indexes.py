"""Label-based indexing helpers (pandas, on the host)."""

from __future__ import annotations

from typing import Any

import numpy as np
import pandas as pd


def as_index(values) -> pd.Index:
    return pd.Index(np.asarray(values))


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
