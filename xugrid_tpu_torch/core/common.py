"""
Combination functions over UgridDataArrays and UgridDatasets: the
xdata ones, with the grids carried over (``xugrid_tpu/core/common.py``;
its file readers are not ported).
"""

from __future__ import annotations

from xugrid_tpu_torch import xdata
from xugrid_tpu_torch.core.wrap import UgridDataArray, UgridDataset, maybe_xdata


def _unwrap_grids(objects):
    """The distinct grids of the wrapped objects, in order."""
    grids = []
    for obj in objects:
        if isinstance(obj, (UgridDataArray, UgridDataset)):
            grids.extend(g for g in obj.grids if not any(g.equals(other) for other in grids))
    return grids


def concat(objs, dim: str):
    """Concatenate UgridDataArrays or UgridDatasets along ``dim``."""
    grids = _unwrap_grids(objs)
    result = xdata.concat([maybe_xdata(o) for o in objs], dim)
    if isinstance(result, xdata.DataArray):
        return UgridDataArray(result, grids[0])
    return UgridDataset(result, grids)


def merge(objs, compat: str = "no_conflicts"):
    """Merge UgridDataArrays and UgridDatasets into a UgridDataset."""
    grids = _unwrap_grids(objs)
    return UgridDataset(xdata.merge([maybe_xdata(o) for o in objs], compat=compat), grids)


def full_like(other, fill_value, dtype=None):
    """A UgridDataArray or UgridDataset like ``other``, filled with
    ``fill_value`` (a tensor payload gives one on its device)."""
    result = xdata.full_like(maybe_xdata(other), fill_value, dtype=dtype)
    if isinstance(other, UgridDataArray):
        return UgridDataArray(result, other.grid)
    if isinstance(other, UgridDataset):
        return UgridDataset(result, other.grids)
    return result


def zeros_like(other, dtype=None):
    return full_like(other, 0, dtype=dtype)


def ones_like(other, dtype=None):
    return full_like(other, 1, dtype=dtype)
