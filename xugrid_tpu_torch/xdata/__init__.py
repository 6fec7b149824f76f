"""
xdata: the labelled-array core of the port, a copy of ``xugrid_tpu``'s
xarray stand-in: DataArray, Dataset, Variable, concat/merge,
full_like/zeros_like/ones_like, where, align, broadcast, apply_ufunc,
polyval and ``testing``, the grouped and windowed methods
(``grouped.py``: groupby, resample, rolling, coarsen, weighted), and the
netCDF and zarr readers and writers (``io_netcdf.py``, ``io_zarr.py``),
whose lazy reads leave large variables in their files as ``LazyArray``s
(``lazy.py``).

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
    to_numpy,
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
    "align",
    "broadcast",
    "apply_ufunc",
    "polyval",
    "testing",
]


def _vars_equiv(a: Variable, b: Variable) -> bool:
    from xugrid_tpu_torch.xdata.dataarray import _array_equiv

    return a.dims == b.dims and a.shape == b.shape and _array_equiv(a.data, b.data)


def concat(objs: Sequence, dim: str, **kwargs):
    """Concatenate DataArrays or Datasets along ``dim``; further keyword
    arguments (xarray's ``join``, ``coords``, ...) are accepted and
    ignored, as the reference does."""
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


def merge(objs: Sequence, compat: str = "no_conflicts", **kwargs) -> Dataset:
    """Merge DataArrays, Datasets and dicts into one Dataset; further
    keyword arguments are accepted and ignored, as the reference does."""
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


def where(cond, x, y, keep_attrs=None):
    """``x`` where ``cond`` holds, else ``y``.  ``keep_attrs`` is
    accepted and ignored, as the reference does."""
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


def align(*objs, join: str = "inner"):
    """The objects unchanged, once their shared dimensions are checked to
    have equal sizes (no label-based join)."""
    sizes: dict = {}
    for obj in objs:
        for d, s in obj.sizes.items():
            if d in sizes and sizes[d] != s:
                raise ValueError(
                    f"cannot align: conflicting size for dim {d!r}: {sizes[d]} vs {s} "
                    "(label-based joins not supported)"
                )
            sizes.setdefault(d, s)
    return objs


def broadcast(*objs):
    """Every DataArray expanded to all the objects' dimensions."""
    sizes: dict = {}
    for obj in objs:
        for d, s in obj.sizes.items():
            sizes.setdefault(d, s)
    dims = list(sizes)
    return tuple(
        DataArray._construct(obj.variable.broadcast_to(dims, sizes), dict(obj._coords), obj.name)
        if isinstance(obj, DataArray) else obj
        for obj in objs
    )


def _signature(input_core_dims, output_core_dims) -> str:
    def fmt(dims_list):
        return ",".join("(" + ",".join(str(d) for d in dims) + ")" for dims in dims_list)

    return fmt(input_core_dims) + "->" + fmt(output_core_dims)


def _vectorized(func, n_core_in, n_out):
    """np.vectorize over the leading (broadcast) axes of tensor inputs:
    ``func`` gets each input's core-dimension slice, a tensor on its
    device, one call per broadcast position (a Python loop), and the
    results are stacked there."""

    def call(*inputs, **kwargs):
        tensors = [i for i in inputs if is_tensor(i)]
        loop_shapes = [tuple(i.shape[: i.ndim - c]) for i, c in zip(inputs, n_core_in) if hasattr(i, "shape")]
        loop = torch.broadcast_shapes(*loop_shapes)
        expanded = []
        for i, c in zip(inputs, n_core_in):
            if hasattr(i, "shape"):
                i = as_tensor_like(i, tensors[0])
                i = i.reshape((1,) * (len(loop) - (i.ndim - c)) + tuple(i.shape)).expand(loop + tuple(i.shape[i.ndim - c:]))
            expanded.append(i)
        results = [[] for _ in range(n_out)]
        for index in np.ndindex(*loop):
            out = func(*[e[index] if is_tensor(e) else e for e in expanded], **kwargs)
            for r, o in zip(results, out if n_out > 1 else (out,)):
                r.append(as_tensor_like(o, tensors[0]) if not is_tensor(o) else o)
        stacked = tuple(torch.stack(r).reshape(loop + tuple(r[0].shape)) for r in results)
        return stacked if n_out > 1 else stacked[0]

    return call


def apply_ufunc(
    func,
    *args,
    input_core_dims=None,
    output_core_dims=None,
    exclude_dims=frozenset(),
    vectorize: bool = False,
    dask: str = "forbidden",
    output_dtypes=None,
    keep_attrs=None,
    kwargs=None,
    dask_gufunc_kwargs=None,
):
    """
    ``func`` on the payloads of DataArrays, each with its core dims moved
    last and its other ("broadcast") dims inserted in first-seen order;
    the outputs are labelled with the broadcast dims and the output core
    dims.  ``vectorize`` calls ``func`` once per broadcast position with
    the core-dimension slices (np.vectorize's semantics; for tensor
    payloads, slices of the tensors on their device).
    """
    kwargs = kwargs or {}
    if input_core_dims is None:
        input_core_dims = [()] * len(args)
    if output_core_dims is None:
        output_core_dims = [()]
    broadcast_dims: list = []
    for a, core in zip(args, input_core_dims):
        if isinstance(a, DataArray):
            broadcast_dims += [d for d in a.dims if d not in core and d not in broadcast_dims]
    raw_inputs = []
    for a, core in zip(args, input_core_dims):
        if not isinstance(a, DataArray):
            raw_inputs.append(a)
            continue
        target = broadcast_dims + list(core)
        var = a.variable
        for d in target:
            if d not in var.dims:
                if d in core and d in exclude_dims:
                    raise ValueError(f"missing core dim {d}")
                var = var.expand_dims(d, axis=0)
        raw_inputs.append(var.transpose(*[d for d in target if d in var.dims]).data)
    if vectorize and any(is_tensor(r) for r in raw_inputs):
        func = _vectorized(func, [len(c) for c in input_core_dims], len(output_core_dims))
    elif vectorize:
        func = np.vectorize(func, signature=_signature(input_core_dims, output_core_dims))
    results = func(*raw_inputs, **kwargs)
    if len(output_core_dims) == 1:
        results = (results,)
    template = next((a for a in args if isinstance(a, DataArray)), None)
    outputs = []
    for res, core in zip(results, output_core_dims):
        out_dims = tuple(broadcast_dims) + tuple(core)
        # Leading size-1 axes inserted for missing broadcast dims go.
        while res.ndim > len(out_dims):
            res = res[0]
        var = Variable(out_dims[: res.ndim] if res.ndim < len(out_dims) else out_dims, res)
        coords = {}
        if template is not None:
            coords = {k: v for k, v in template._coords.items() if set(v.dims) <= set(var.dims)}
        outputs.append(DataArray._construct(var, coords, None if template is None else template.name))
    return outputs[0] if len(outputs) == 1 else tuple(outputs)


def polyval(coord, coeffs, degree_dim: str = "degree"):
    """The polynomial of ``coeffs`` (a ``polyfit`` layout) at the values of
    ``coord``: the sum over ``degree_dim`` of coeff * coord ** degree, in
    float64, on the device of a tensor ``coord`` or ``coeffs``."""
    if isinstance(coeffs, Dataset):
        out = Dataset(attrs=dict(coeffs.attrs))
        for name, da in coeffs.data_vars.items():
            if degree_dim in da.dims:
                out[name.replace("_polyfit_coefficients", "")] = polyval(coord, da, degree_dim)
        return out
    degrees = to_numpy(coeffs.coords[degree_dim].data)
    x = coord.data if isinstance(coord, DataArray) else np.asarray(coord)
    axis = coeffs.dims.index(degree_dim)
    x, c = common_operands(x, coeffs.data)
    if is_tensor(x):
        x, c = torch.as_tensor(x).double(), torch.movedim(torch.as_tensor(c).double(), axis, 0)
        result = torch.zeros(tuple(x.shape) + tuple(c.shape[1:]), dtype=torch.float64, device=x.device)
        for d, cd in zip(degrees, c):
            result += (x ** float(d)).reshape(tuple(x.shape) + (1,) * cd.ndim) * cd
    else:
        x, c = np.asarray(x, dtype=np.float64), np.moveaxis(np.asarray(c, dtype=np.float64), axis, 0)
        result = np.zeros(x.shape + c.shape[1:])
        for d, cd in zip(degrees, c):
            result += np.multiply.outer(x**d, cd)
    coord_dims = coord.dims if isinstance(coord, DataArray) else ("x",)
    coords = dict(coord._coords) if isinstance(coord, DataArray) else {}
    var = Variable(tuple(coord_dims) + tuple(d for d in coeffs.dims if d != degree_dim), result)
    return DataArray._construct(var, coords, None)


class _Testing:
    """``assert_equal``, ``assert_identical`` and ``assert_allclose`` of
    DataArrays and Datasets over numpy or tensor payloads on any device
    (compared on the host)."""

    @staticmethod
    def assert_equal(a, b):
        assert a.equals(b), f"objects not equal:\n{a}\n{b}"

    @staticmethod
    def assert_identical(a, b):
        assert a.identical(b), f"objects not identical:\n{a}\n{b}"

    @staticmethod
    def assert_allclose(a, b, rtol=1e-5, atol=1e-8):
        np.testing.assert_allclose(
            to_numpy(a.data if hasattr(a, "data") else a),
            to_numpy(b.data if hasattr(b, "data") else b),
            rtol=rtol,
            atol=atol,
        )


testing = _Testing()
