"""
xdata: the labelled-array core of the port, a copy of ``xugrid_tpu``'s
xarray stand-in reduced to what the UGRID wrappers and the regridders
read: DataArray, Dataset, Variable, concat/merge,
full_like/zeros_like/ones_like and where, and the eager netCDF and zarr
readers and writers (``io_netcdf.py``, ``io_zarr.py``).

Coordinates and indexes are numpy on the host.  A data payload may be a
numpy array or a torch tensor; a tensor stays on its device through
indexing, transposes, arithmetic, reductions and regridding, and only
``.values`` and ``.to_numpy()`` copy it to the host.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from xugrid_tpu_torch.xdata.dataarray import DataArray
from xugrid_tpu_torch.xdata.dataset import Dataset
from xugrid_tpu_torch.xdata.io_netcdf import open_dataset, to_netcdf
from xugrid_tpu_torch.xdata.io_zarr import open_zarr, to_zarr
from xugrid_tpu_torch.xdata.variable import (
    Variable,
    as_tensor_like,
    broadcast_variables,
    common_operands,
    concat_variables,
    is_tensor,
    torch_dtype,
)

__all__ = [
    "DataArray",
    "Dataset",
    "Variable",
    "open_dataset",
    "open_zarr",
    "to_netcdf",
    "to_zarr",
    "broadcast_variables",
    "concat",
    "concat_variables",
    "merge",
    "full_like",
    "zeros_like",
    "ones_like",
    "where",
]


def _vars_equiv(a: Variable, b: Variable) -> bool:
    from xugrid_tpu_torch.xdata.dataarray import _array_equiv

    return a.dims == b.dims and a.shape == b.shape and _array_equiv(a.data, b.data)


def concat(objs: Sequence, dim: str):
    """Concatenate DataArrays or Datasets along ``dim``."""
    objs = list(objs)
    first = objs[0]
    if isinstance(first, DataArray):
        var = concat_variables([o.variable for o in objs], dim)
        coords: dict = {}
        for k in first._coords:
            if all(k in o._coords for o in objs):
                cvars = [o._coords[k] for o in objs]
                if dim in cvars[0].dims or k == dim:
                    coords[k] = concat_variables(cvars, dim)
                else:
                    coords[k] = cvars[0]
        return DataArray._construct(var, coords, first.name)
    if isinstance(first, Dataset):
        out = Dataset(attrs=dict(first.attrs))
        for name in dict.fromkeys(k for o in objs for k in o._variables):
            vars_ = [o._variables[name] for o in objs if name in o._variables]
            if len(vars_) < len(objs):
                raise ValueError(f"variable {name!r} missing from some datasets")
            if dim in vars_[0].dims or any(not _vars_equiv(vars_[0], v) for v in vars_[1:]):
                out._variables[name] = concat_variables(vars_, dim)
            else:
                out._variables[name] = vars_[0]
        out._coord_names = set(first._coord_names)
        return out
    raise TypeError(f"cannot concatenate {type(first)}")


def merge(objs: Sequence, compat: str = "no_conflicts") -> Dataset:
    out = Dataset()
    for obj in objs:
        if isinstance(obj, DataArray):
            obj = obj.to_dataset()
        elif isinstance(obj, dict):
            obj = Dataset(obj)
        out = out.merge(obj, compat=compat)
    return out


def _full(like, fill_value, dtype):
    """An array or tensor of ``like``'s shape (and device) filled with
    ``fill_value``."""
    if is_tensor(like):
        dtype = like.dtype if dtype is None else torch_dtype(dtype)
        return torch.full(tuple(like.shape), fill_value, dtype=dtype, device=like.device)
    return np.full(like.shape, fill_value, dtype=dtype or like.dtype)


def full_like(other, fill_value, dtype=None):
    if isinstance(other, DataArray):
        var = Variable(other.dims, _full(other.data, fill_value, dtype), dict(other.attrs))
        return DataArray._construct(var, dict(other._coords), other.name)
    if isinstance(other, Dataset):
        out = Dataset(attrs=dict(other.attrs))
        out._coord_names = set(other._coord_names)
        for name, var in other._variables.items():
            if name in other._coord_names:
                out._variables[name] = var
            else:
                out._variables[name] = Variable(var.dims, _full(var.data, fill_value, dtype), dict(var.attrs))
        return out
    raise TypeError(f"cannot create full_like of {type(other)}")


def zeros_like(other, dtype=None):
    return full_like(other, 0, dtype=dtype)


def ones_like(other, dtype=None):
    return full_like(other, 1, dtype=dtype)


def where(cond, x, y):
    """``x`` where ``cond`` holds, else ``y``."""
    if isinstance(x, DataArray):
        return x.where(cond, y)
    if isinstance(cond, DataArray):
        mask, xv = common_operands(cond.data, x)
        if is_tensor(mask):
            data = torch.where(mask, xv, as_tensor_like(y, mask))
        else:
            data = np.where(mask, xv, y)
        return DataArray._construct(Variable(cond.dims, data), dict(cond._coords), cond.name)
    return np.where(cond, x, y)
