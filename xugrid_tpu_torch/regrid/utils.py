"""Outer-product helpers for structured regridding (host, numpy).

Structured regridders join each axis on its own (a 1-D source and target
index pair plus a 1-D weight per axis); the N-D join is the outer
product of the per-axis joins, folded left to right with row-major
strides so that no intermediate N-D grid exists.  Copied from
``xugrid_tpu/regrid/utils.py``.
"""

from __future__ import annotations

import numpy as np


def _row_major_strides(shape) -> list[int]:
    # strides in elements (not bytes): last axis is contiguous.
    strides = [1]
    for extent in reversed(shape[1:]):
        strides.append(strides[-1] * int(extent))
    return strides[::-1]


def _fold_outer(columns, combine):
    """Left fold of 1-D ``columns`` under ``combine`` with outer-product
    (row-major) enumeration: the result's fastest-varying axis is the
    last column."""
    acc = None
    for col in columns:
        col = np.asarray(col)
        if acc is None:
            acc = col
        else:
            acc = combine(acc[:, None], col[None, :]).ravel()
    return acc


def linearize(per_axis_indices, shape):
    """Flat row-major indices of the outer product of per-axis indices."""
    strides = _row_major_strides(shape)
    scaled = [np.asarray(ix, dtype=np.int64) * s for ix, s in zip(per_axis_indices, strides)]
    return _fold_outer(scaled, np.add)


def product_weights(per_axis_weights):
    """Separable weights: outer product of the per-axis weight columns."""
    # np.array (not asarray): the single-axis fold returns its input
    # unchanged, and callers may scale the result in place.
    columns = [np.array(w, dtype=np.float64) for w in per_axis_weights]
    return _fold_outer(columns, np.multiply)


def broadcast(source_shape, target_shape, source_indices, target_indices, weights):
    """Combine per-axis (index, weight) joins into linear-index triplets."""
    return (
        linearize(source_indices, source_shape),
        linearize(target_indices, target_shape),
        product_weights(weights),
    )


def alt_cumsum(a):
    """Exclusive cumsum: starts at 0, omits the final total."""
    out = np.cumsum(a)
    if out.size:
        out = np.roll(out, 1)
        out[0] = 0
    return out.astype(a.dtype, copy=False)
