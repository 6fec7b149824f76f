"""
DataArray: a Variable plus coordinates and a name.

The subset of xarray's DataArray that the UGRID wrappers and the
regridders read.  Coordinates are numpy on the host; the payload may be
a torch tensor, which stays on its device (``variable.py``).
"""

from __future__ import annotations

import operator
from typing import Hashable, Mapping

import numpy as np
import torch

from xugrid_tpu_torch.xdata.indexes import as_index, resolve_label_indexer
from xugrid_tpu_torch.xdata.variable import (
    Variable,
    as_compatible_data,
    as_tensor_like,
    broadcast_variables,
    common_operands,
    is_tensor,
    to_numpy,
)


class Coordinates(Mapping):
    """Read-through mapping of coordinate name -> DataArray."""

    def __init__(self, owner):
        self._owner = owner

    def __getitem__(self, key) -> "DataArray":
        var = self._owner._coords[key]
        coords = {k: v for k, v in self._owner._coords.items() if set(v.dims) <= set(var.dims)}
        return DataArray._construct(var, coords, key)

    def __iter__(self):
        return iter(self._owner._coords)

    def __len__(self):
        return len(self._owner._coords)

    def __contains__(self, key):
        return key in self._owner._coords

    def __repr__(self):
        lines = [f"  {k}: {tuple(v.dims)} {v.dtype}" for k, v in self._owner._coords.items()]
        return "Coordinates:\n" + "\n".join(lines)

    @property
    def variables(self):
        return dict(self._owner._coords)


def _normalize_coords(coords, dims, shape) -> dict:
    out: dict = {}
    if coords is None:
        return out
    if isinstance(coords, (list, tuple)):
        # positional: one coordinate array per dim
        for dim, values in zip(dims, coords):
            out[dim] = Variable((dim,), values)
        return out
    for name, values in coords.items():
        if isinstance(values, Variable):
            out[name] = values
        elif isinstance(values, DataArray):
            out[name] = values.variable
        elif isinstance(values, tuple) and len(values) in (2, 3):
            out[name] = Variable(values[0], values[1])
        else:
            arr = as_compatible_data(values)
            if arr.ndim == 0:
                out[name] = Variable((), arr)
            elif name in dims:
                out[name] = Variable((name,), arr)
            elif arr.ndim == 1 and len(dims) == 1:
                out[name] = Variable((dims[0],), arr)
            else:
                raise ValueError(f"cannot infer dimensions for coordinate {name!r}")
    return out


def _array_equiv(a, b) -> bool:
    """Equal shapes and values, NaN equal to NaN; a tensor is compared on
    its device, with a numpy operand moved there."""
    if tuple(a.shape) != tuple(b.shape):
        return False
    if is_tensor(a) or is_tensor(b):
        a, b = common_operands(a, b)
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        if a.dtype.is_floating_point or b.dtype.is_floating_point:
            return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
        return bool((a == b).all())
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "fc" or b.dtype.kind in "fc":
        return bool(((a == b) | (np.isnan(a) & np.isnan(b))).all())
    return bool((a == b).all())


def _merge_coords(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        if k in out:
            if out[k].dims != v.dims or not _array_equiv(out[k].data, v.data):
                del out[k]  # conflicting coordinate: drop
        else:
            out[k] = v
    return out


class DataArray:
    __slots__ = ("variable", "_coords", "name")

    def __init__(
        self,
        data=None,
        coords=None,
        dims=None,
        name: Hashable | None = None,
        attrs: Mapping | None = None,
    ):
        if isinstance(data, DataArray):
            variable = data.variable.copy(deep=False)
            if attrs:
                variable.attrs.update(attrs)
            merged_coords = dict(data._coords)
            if coords:
                merged_coords.update(_normalize_coords(coords, data.dims, data.shape))
            self.variable = variable
            self._coords = merged_coords
            self.name = name if name is not None else data.name
            return
        if isinstance(data, Variable):
            variable = data
            if dims is not None and tuple([dims] if isinstance(dims, str) else dims) != variable.dims:
                variable = Variable(dims, variable.data, variable.attrs)
            if attrs:
                variable = Variable(variable.dims, variable.data, attrs)
        else:
            data = as_compatible_data(data)
            if dims is None:
                dims = tuple(f"dim_{i}" for i in range(data.ndim))
            elif isinstance(dims, str):
                dims = (dims,)
            variable = Variable(dims, data, attrs)
        self.variable = variable
        self._coords = _normalize_coords(coords, variable.dims, variable.shape)
        self.name = name
        self._validate_coords()

    def _validate_coords(self):
        sizes = self.variable.sizes
        for cname, cvar in self._coords.items():
            for d, s in cvar.sizes.items():
                if d in sizes and sizes[d] != s:
                    raise ValueError(
                        f"conflicting size for dimension {d!r} in coordinate {cname!r}: {s} vs {sizes[d]}"
                    )

    @classmethod
    def _construct(cls, variable: Variable, coords: dict, name) -> "DataArray":
        obj = object.__new__(cls)
        obj.variable = variable
        obj._coords = coords
        obj.name = name
        return obj

    # -- properties ---------------------------------------------------------
    @property
    def dims(self):
        return self.variable.dims

    @property
    def shape(self):
        return self.variable.shape

    @property
    def sizes(self):
        return self.variable.sizes

    @property
    def ndim(self):
        return self.variable.ndim

    @property
    def size(self):
        return self.variable.size

    @property
    def dtype(self):
        return self.variable.dtype

    @property
    def data(self):
        """The payload: a numpy array or a torch tensor, not copied."""
        return self.variable.data

    @data.setter
    def data(self, value):
        self.variable.data = as_compatible_data(value)

    @property
    def values(self) -> np.ndarray:
        """The payload on the host: a copy of a tensor."""
        return self.variable.values

    @property
    def attrs(self) -> dict:
        return self.variable.attrs

    @attrs.setter
    def attrs(self, value):
        self.variable.attrs = dict(value)

    @property
    def encoding(self) -> dict:
        return self.variable.encoding

    @property
    def coords(self) -> Coordinates:
        return Coordinates(self)

    @property
    def indexes(self) -> dict:
        return {
            dim: as_index(self._coords[dim].data)
            for dim in self.dims
            if dim in self._coords and self._coords[dim].dims == (dim,)
        }

    def __len__(self):
        if not self.dims:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __repr__(self):
        header = f"<xdata.DataArray {self.name!r} {tuple(self.dims)} {self.shape}>"
        coords = "\n".join(f"  * {k}: {tuple(v.dims)} {v.dtype}" for k, v in self._coords.items())
        data = self.variable.data
        if is_tensor(data):
            data_repr = f"<tensor {tuple(data.shape)} {data.dtype} on {data.device}>"
        else:
            data_repr = repr(data)
            if len(data_repr) > 400:
                data_repr = data_repr[:400] + "…"
        return f"{header}\n{data_repr}\nCoordinates:\n{coords}"

    def item(self):
        return self.variable.data.item()

    def __array__(self, dtype=None, copy=None):
        if is_tensor(self.variable.data):
            raise TypeError(
                "a DataArray over a tensor is not converted implicitly: take .values or .to_numpy() "
                "for a host copy"
            )
        v = np.asarray(self.variable.data)
        return v.astype(dtype) if dtype is not None else v

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __bool__(self):
        return bool(self.item())

    # -- conversion ---------------------------------------------------------
    def copy(self, deep: bool = True, data=None) -> "DataArray":
        """Copy; ``data`` replaces the values while keeping dims, coords
        and attrs."""
        return DataArray._construct(
            self.variable.copy(deep, data=data),
            {k: v.copy(deep) for k, v in self._coords.items()},
            self.name,
        )

    def rename(self, new_name_or_dict=None, **names) -> "DataArray":
        if isinstance(new_name_or_dict, (str, type(None))) and not names:
            if new_name_or_dict is None:
                return self.copy(deep=False)
            return DataArray._construct(self.variable, dict(self._coords), new_name_or_dict)
        mapping = dict(new_name_or_dict or {})
        mapping.update(names)
        new_dims = tuple(mapping.get(d, d) for d in self.dims)
        var = Variable(new_dims, self.variable.data, self.attrs, self.encoding)
        coords = {}
        for k, v in self._coords.items():
            cdims = tuple(mapping.get(d, d) for d in v.dims)
            coords[mapping.get(k, k)] = Variable(cdims, v.data, v.attrs)
        name = mapping.get(self.name, self.name)
        return DataArray._construct(var, coords, name)

    def astype(self, dtype) -> "DataArray":
        return DataArray._construct(self.variable.astype(dtype), dict(self._coords), self.name)

    def to_dataset(self, name=None):
        from xugrid_tpu_torch.xdata.dataset import Dataset

        name = name or self.name
        if name is None:
            raise ValueError("unable to convert unnamed DataArray to Dataset")
        ds = Dataset()
        for k, v in self._coords.items():
            ds._variables[k] = v
            ds._coord_names.add(k)
        ds._variables[name] = self.variable
        return ds

    def to_numpy(self) -> np.ndarray:
        """The payload on the host: a copy of a tensor."""
        return self.values

    # -- indexing -----------------------------------------------------------
    @staticmethod
    def _resolve_indexers(indexers, kwargs):
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        return indexers

    def isel(self, indexers=None, drop: bool = False, missing_dims: str = "raise", **kwargs) -> "DataArray":
        indexers = self._resolve_indexers(indexers, kwargs)
        unknown = set(indexers) - set(self.dims)
        if unknown:
            if missing_dims == "raise":
                raise ValueError(f"dimensions {unknown} do not exist")
            indexers = {k: v for k, v in indexers.items() if k in self.dims}
        da_idx = {k: v for k, v in indexers.items() if isinstance(v, DataArray) and v.ndim >= 1}
        if len(da_idx) > 1:
            # Several DataArray indexers select jointly (pointwise), as
            # xarray's vectorized indexing does: not an outer product.
            rest = {k: v for k, v in indexers.items() if k not in da_idx}
            return self._isel_pointwise(da_idx, rest, drop)
        clean = {}
        renames = {}
        for k, v in indexers.items():
            if isinstance(v, DataArray):
                # The indexed axis takes the indexer's dimension name.
                if v.ndim == 1 and v.dims[0] != k:
                    renames[k] = v.dims[0]
                v = v.data
            clean[k] = v
        new_var = self.variable.isel(clean)
        new_coords = {}
        for name, cvar in self._coords.items():
            sub = {d: clean[d] for d in cvar.dims if d in clean}
            cv = cvar.isel(sub) if sub else cvar
            if drop and cv.ndim == 0:
                continue
            new_coords[name] = cv
        out = DataArray._construct(new_var, new_coords, self.name)
        if renames:
            out = out.rename(renames)
            # The old index coordinate holds positions of the old dim.
            for new in renames.values():
                if new in out._coords and out._coords[new].dims == (new,):
                    del out._coords[new]
        return out

    def _isel_pointwise(self, da_idx, rest, drop):
        """Joint indexing by several DataArray indexers: they broadcast
        against each other by dimension name, and their dimensions take
        the place of the indexed ones, first.  A tensor payload is
        gathered on its device."""
        out = self.isel(rest, drop=drop) if rest else self
        axes_dims = list(da_idx)
        bvars = broadcast_variables(*[v.variable for v in da_idx.values()])
        idx_arrays = [to_numpy(b.data).astype(np.int64) for b in bvars]
        new_idx_dims = bvars[0].dims
        for d in new_idx_dims:
            if d in out.dims and d not in axes_dims:
                raise ValueError(f"pointwise indexer dim {d!r} collides with a remaining array dim")
        data = out.data
        axes = [out.dims.index(k) for k in axes_dims]
        front = list(range(len(axes)))
        if is_tensor(data):
            key = tuple(torch.from_numpy(i).to(data.device) for i in idx_arrays)
            result = torch.movedim(data, axes, front)[key]
        else:
            result = np.moveaxis(np.asarray(data), axes, front)[tuple(idx_arrays)]
        rest_dims = tuple(d for d in out.dims if d not in axes_dims)
        coords = {}
        for name, cvar in out._coords.items():
            hit = [d for d in cvar.dims if d in axes_dims]
            if not hit:
                coords[name] = cvar
                continue
            c_axes = [cvar.dims.index(d) for d in hit]
            c_moved = np.moveaxis(to_numpy(cvar.data), c_axes, range(len(c_axes)))
            c_idx = tuple(idx_arrays[axes_dims.index(d)] for d in hit)
            c_rest = tuple(d for d in cvar.dims if d not in axes_dims)
            coords[name] = Variable(new_idx_dims + c_rest, c_moved[c_idx])
        # The indexers' own coordinates come along.
        for v in da_idx.values():
            for cname, cvar in v._coords.items():
                if cname not in coords and set(cvar.dims) <= set(new_idx_dims):
                    coords[cname] = cvar
        return DataArray._construct(Variable(new_idx_dims + rest_dims, result, self.attrs), coords, self.name)

    def sel(self, indexers=None, method=None, tolerance=None, drop: bool = False, **kwargs) -> "DataArray":
        """Label selection on 1-D index coordinates; a dimension without
        one takes the labels as positions."""
        indexers = self._resolve_indexers(indexers, kwargs)
        positional = {}
        for dim, label in indexers.items():
            if dim not in self.dims:
                raise KeyError(f"no dimension {dim!r}")
            if dim not in self._coords or self._coords[dim].dims != (dim,):
                positional[dim] = label
                continue
            index = as_index(self._coords[dim].data)
            positional[dim] = resolve_label_indexer(index, label, method, tolerance)
        return self.isel(positional, drop=drop)

    def __getitem__(self, key) -> "DataArray":
        if isinstance(key, str):
            return self.coords[key]
        if isinstance(key, dict):
            return self.isel(key)
        if not isinstance(key, tuple):
            key = (key,)
        return self.isel(dict(zip(self.dims, key)))

    def __setitem__(self, key, value):
        if isinstance(value, DataArray):
            value = value.data
        if isinstance(key, str):
            self._coords[key] = value if isinstance(value, Variable) else Variable((key,), value)
            return
        if isinstance(key, dict):
            key = tuple(key.get(d, slice(None)) for d in self.dims)
        data = self.variable.data
        if is_tensor(data):
            value = as_tensor_like(value, data)
        data[key] = value

    # -- coordinate manipulation --------------------------------------------
    def assign_coords(self, coords=None, **kwargs) -> "DataArray":
        coords = dict(coords or {})
        coords.update(kwargs)
        new = dict(self._coords)
        new.update(_normalize_coords(coords, self.dims, self.shape))
        out = DataArray._construct(self.variable, new, self.name)
        out._validate_coords()
        return out

    def drop_vars(self, names, errors: str = "raise") -> "DataArray":
        if isinstance(names, str):
            names = [names]
        new = dict(self._coords)
        for n in names:
            if n in new:
                del new[n]
            elif errors == "raise":
                raise ValueError(f"{n!r} not found in coords")
        return DataArray._construct(self.variable, new, self.name)

    # -- shaping ------------------------------------------------------------
    def transpose(self, *dims) -> "DataArray":
        return DataArray._construct(self.variable.transpose(*dims), dict(self._coords), self.name)

    @property
    def T(self):
        return self.transpose()

    def squeeze(self, dim=None, drop: bool = False) -> "DataArray":
        if dim is None:
            drop_dims = [d for d, s in self.sizes.items() if s == 1]
        else:
            drop_dims = [dim] if isinstance(dim, str) else list(dim)
        return self.isel({d: 0 for d in drop_dims}, drop=drop)

    def expand_dims(self, dim=None, axis=None, **dim_kwargs) -> "DataArray":
        if isinstance(dim, str):
            dims = {dim: 1}
        elif isinstance(dim, (list, tuple)):
            dims = {d: 1 for d in dim}
        else:
            dims = dict(dim or {})
        dims.update(dim_kwargs)
        var = self.variable
        coords = dict(self._coords)
        for i, (d, size_or_values) in enumerate(dims.items()):
            ax = axis if axis is not None else i
            var = var.expand_dims(d, axis=ax)
            if isinstance(size_or_values, (int, np.integer)):
                size = int(size_or_values)
            else:
                values = np.asarray(size_or_values)
                coords[d] = Variable((d,), values)
                size = len(values)
            if size > 1:
                var = var.broadcast_to(var.dims, {**var.sizes, d: size})
        return DataArray._construct(var, coords, self.name)

    def stack_dims(self, new_dim: str, dims) -> "DataArray":
        """Collapse ``dims`` (in order) into one new trailing dim."""
        other = [d for d in self.dims if d not in dims]
        var = self.variable.transpose(*(other + list(dims)))
        n = int(np.prod([self.sizes[d] for d in dims]))
        shape = tuple(self.sizes[d] for d in other) + (n,)
        coords = {k: v for k, v in self._coords.items() if not (set(v.dims) & set(dims))}
        return DataArray._construct(
            Variable(tuple(other) + (new_dim,), var.data.reshape(shape), self.attrs), coords, self.name
        )

    # -- computation --------------------------------------------------------
    def _apply_binary(self, other, op, reflexive=False) -> "DataArray":
        if isinstance(other, DataArray):
            var = self.variable._binary_op(other.variable, op, reflexive)
            coords = _merge_coords(self._coords, other._coords)
            name = self.name if self.name == other.name else None
        else:
            var = self.variable._binary_op(other, op, reflexive)
            coords = dict(self._coords)
            name = self.name
        coords = {k: v for k, v in coords.items() if set(v.dims) <= set(var.dims)}
        return DataArray._construct(var, coords, name)

    def _apply_unary(self, op) -> "DataArray":
        var = Variable(self.dims, op(self.variable.data), self.attrs)
        return DataArray._construct(var, dict(self._coords), self.name)

    def _reduce(self, func_name, dim=None, skipna=None, keep_attrs=False, **kwargs) -> "DataArray":
        var = self.variable.reduce(func_name, dim=dim, skipna=skipna, **kwargs)
        if not keep_attrs:
            var = Variable(var.dims, var.data)
        coords = {k: v for k, v in self._coords.items() if set(v.dims) <= set(var.dims)}
        return DataArray._construct(var, coords, self.name)

    def where(self, cond, other=np.nan) -> "DataArray":
        """Keep the values where ``cond`` holds, else ``other``."""
        cond_var = cond.variable if isinstance(cond, DataArray) else Variable(self.dims, cond)
        if isinstance(other, DataArray):
            other = other.variable
        sv, cv = broadcast_variables(self.variable, cond_var)
        if isinstance(other, Variable):
            sv, ov = broadcast_variables(sv, other)
            cv = cv.broadcast_to(sv.dims, sv.sizes)
            other = ov.data
        data, mask = common_operands(sv.data, cv.data)
        if is_tensor(data):
            result = torch.where(mask, data, as_tensor_like(other, data))
        else:
            result = np.where(mask, data, other)
        var = Variable(sv.dims, result, self.attrs)
        coords = {k: v for k, v in self._coords.items() if set(v.dims) <= set(var.dims)}
        if isinstance(cond, DataArray):
            coords = _merge_coords(
                coords, {k: v for k, v in cond._coords.items() if set(v.dims) <= set(var.dims)}
            )
        return DataArray._construct(var, coords, self.name)

    def fillna(self, value) -> "DataArray":
        if isinstance(value, DataArray):
            value = value.variable.broadcast_to(self.dims, self.sizes).data
        return DataArray._construct(self.variable.fillna(value), dict(self._coords), self.name)

    def notnull(self) -> "DataArray":
        return DataArray._construct(self.variable.notnull(), dict(self._coords), self.name)

    def isnull(self) -> "DataArray":
        return DataArray._construct(self.variable.isnull(), dict(self._coords), self.name)

    def equals(self, other) -> bool:
        """Same dims, shape, values and coordinates (NaN equal to NaN)."""
        if not isinstance(other, DataArray):
            return False
        if self.dims != other.dims or self.shape != other.shape:
            return False
        if not _array_equiv(self.data, other.data):
            return False
        for k in self._coords:
            if k not in other._coords:
                return False
            if not _array_equiv(self._coords[k].data, other._coords[k].data):
                return False
        return True

    def identical(self, other) -> bool:
        return self.equals(other) and self.name == other.name and self.attrs == other.attrs


# -- attach operators -------------------------------------------------------
def _make_binop(op, reflexive=False):
    def method(self, other):
        return self._apply_binary(other, op, reflexive)

    return method


def _make_unary(op):
    def method(self):
        return self._apply_unary(op)

    return method


BINARY_OPERATORS = {
    "__add__": operator.add,
    "__sub__": operator.sub,
    "__mul__": operator.mul,
    "__truediv__": operator.truediv,
    "__floordiv__": operator.floordiv,
    "__mod__": operator.mod,
    "__pow__": operator.pow,
    "__and__": operator.and_,
    "__or__": operator.or_,
    "__xor__": operator.xor,
    "__lt__": operator.lt,
    "__le__": operator.le,
    "__gt__": operator.gt,
    "__ge__": operator.ge,
    "__eq__": operator.eq,
    "__ne__": operator.ne,
}
REFLEXIVE_OPERATORS = {
    "__radd__": operator.add,
    "__rsub__": operator.sub,
    "__rmul__": operator.mul,
    "__rtruediv__": operator.truediv,
    "__rpow__": operator.pow,
}
UNARY_OPERATORS = {
    "__neg__": operator.neg,
    "__pos__": operator.pos,
    "__abs__": operator.abs,
    "__invert__": operator.invert,
}
REDUCTIONS = ("sum", "mean", "std", "var", "min", "max", "prod", "all", "any", "median")

for _name, _op in BINARY_OPERATORS.items():
    setattr(DataArray, _name, _make_binop(_op))
for _name, _op in REFLEXIVE_OPERATORS.items():
    setattr(DataArray, _name, _make_binop(_op, reflexive=True))
for _name, _op in UNARY_OPERATORS.items():
    setattr(DataArray, _name, _make_unary(_op))


def _make_reduce(n):
    def method(self, dim=None, skipna=None, **kwargs):
        return self._reduce(n, dim=dim, skipna=skipna, **kwargs)

    method.__name__ = n
    return method


for _rname in REDUCTIONS:
    setattr(DataArray, _rname, _make_reduce(_rname))

DataArray.__hash__ = object.__hash__
