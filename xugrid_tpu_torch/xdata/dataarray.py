"""
DataArray: a Variable plus coordinates and a name.

The subset of xarray's DataArray that the UGRID wrappers and the
regridders read.  Coordinates are numpy on the host; the payload may be
a torch tensor, which stays on its device (``variable.py``).
"""

from __future__ import annotations

import contextlib
import operator
from typing import Hashable, Mapping

import numpy as np
import pandas as pd
import torch

from xugrid_tpu_torch.xdata.indexes import as_index, resolve_label_indexer, stacked_multiindex
from xugrid_tpu_torch.xdata.variable import (
    Variable,
    arg_extreme,
    as_compatible_data,
    as_tensor_like,
    broadcast_variables,
    common_operands,
    fill_directional_tensor,
    gradient_tensor,
    interp_tensor,
    interpolate_tensor,
    is_floating,
    is_tensor,
    isin_tensor,
    polyfit_tensor,
    quantile_tensor,
    rank_tensor,
    shift_tensor,
    to_numpy,
    trapezoid_tensor,
    where_tensor,
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


def level_mask(values: np.ndarray, label, name) -> np.ndarray:
    """Where the host level coordinate ``values`` holds ``label`` (one
    value, which must occur, or a list of values)."""
    lab = np.asarray(label)
    if lab.ndim == 0:
        mask = values == lab[()]
        if not mask.any():
            raise KeyError(f"{label!r} not found in level {name!r}")
        return mask
    return np.isin(values, lab)


def with_level_masks(positional: dict, level_masks: dict, sizes) -> dict:
    """``positional`` with each dim's level selection (a bool mask)
    intersected in; a slice on the same dim is taken as its positions."""
    for dim, mask in level_masks.items():
        pos = np.flatnonzero(mask)
        if dim in positional:
            prev = positional[dim]
            if isinstance(prev, slice):
                prev = np.arange(sizes[dim])[prev]
            prev = np.atleast_1d(np.asarray(prev))
            positional[dim] = prev[np.isin(prev, pos)]
        else:
            positional[dim] = pos
    return positional


@contextlib.contextmanager
def ieee_float32():
    """float32 matrix products in IEEE precision inside the block: no
    TF32 rounding on the card, whatever the caller's global setting."""
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(previous)


def _keep_mask(mask, dims, dim):
    """Positions along ``dim`` where the host bool ``mask`` over ``dims``
    holds anywhere."""
    axes = tuple(i for i, d in enumerate(dims) if d != dim)
    return np.flatnonzero(mask.any(axis=axes) if axes else mask)


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

    @values.setter
    def values(self, value):
        """Replace the payload; a tensor payload's replacement goes to its
        device."""
        data = self.variable.data
        value = np.asarray(value)
        self.variable.data = torch.as_tensor(np.ascontiguousarray(value), device=data.device) if is_tensor(data) else value

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
        """The index of each dim with one: a stacked dim's MultiIndex, else
        its 1-D coordinate."""
        out = {}
        for dim in self.dims:
            mi = stacked_multiindex(dim, self.encoding, self._coords)
            if mi is not None:
                out[dim] = mi
            elif dim in self._coords and self._coords[dim].dims == (dim,):
                out[dim] = as_index(self._coords[dim].data)
        return out

    def get_index(self, dim) -> pd.Index:
        """The index of ``dim``: a stacked dim's MultiIndex, its 1-D
        coordinate, else positions."""
        mi = stacked_multiindex(dim, self.encoding, self._coords)
        if mi is not None:
            return mi
        if dim in self._coords and self._coords[dim].dims == (dim,):
            return as_index(self._coords[dim].data)
        return pd.RangeIndex(self.sizes[dim])

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

    def to_pandas(self):
        """A pandas Series (1-D, on the host) or the scalar (0-D)."""
        if self.ndim == 1:
            return pd.Series(self.values, index=self.get_index(self.dims[0]), name=self.name)
        if self.ndim == 0:
            return self.values.item()
        raise NotImplementedError("to_pandas only for 0D/1D")

    def to_dataframe(self, name=None, dim_order=None):
        """A pandas DataFrame on the host (``Dataset.to_dataframe``)."""
        name = name or self.name or "data"
        ds = self.rename(name).to_dataset() if name != self.name else self.to_dataset(name)
        return ds.to_dataframe(dim_order=dim_order)

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
        # A stacked dim's layout survives subsetting (unstack takes a
        # subset through the level coordinates).
        for key, value in self.encoding.items():
            if key.startswith("_stacked_") and key[len("_stacked_") :] in out.dims:
                out.encoding[key] = value
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
        """Label selection on 1-D index coordinates (a dimension without one
        takes the labels as positions); on a stacked dim, full tuples of
        level labels, and a level name selects by that level's values."""
        indexers = self._resolve_indexers(indexers, kwargs)
        positional = {}
        level_masks = {}  # dim -> bool mask of the level selections over it
        for dim, label in indexers.items():
            if dim not in self.dims:
                # A level: a 1-D coordinate over another dim (the layout
                # stack() makes).
                cv = self._coords.get(dim)
                if cv is None or len(cv.dims) != 1 or cv.dims[0] == dim or cv.dims[0] not in self.dims:
                    raise KeyError(f"no dimension {dim!r}")
                other = cv.dims[0]
                mask = level_mask(to_numpy(cv.data), label, dim)
                level_masks[other] = mask if other not in level_masks else level_masks[other] & mask
                continue
            entry = self.encoding.get("_stacked_" + dim)
            levels = None if entry is None else entry[0]
            if levels is not None and isinstance(label, tuple):
                positional[dim] = self._stacked_tuple_position(dim, levels, label)
                continue
            if levels is not None and isinstance(label, (list, np.ndarray)) and len(label) and isinstance(label[0], tuple):
                positional[dim] = np.array([self._stacked_tuple_position(dim, levels, t) for t in label])
                continue
            if dim not in self._coords or self._coords[dim].dims != (dim,):
                positional[dim] = label
                continue
            index = as_index(self._coords[dim].data)
            positional[dim] = resolve_label_indexer(index, label, method, tolerance)
        return self.isel(with_level_masks(positional, level_masks, self.sizes), drop=drop)

    def _stacked_tuple_position(self, dim, levels, label) -> int:
        """The position of a full (level0, level1, ...) label on a stacked
        dim."""
        if len(label) != len(levels):
            raise KeyError(f"stacked dim {dim!r} expects {len(levels)}-tuples (levels {levels}), got {label!r}")
        mask = np.ones(self.sizes[dim], bool)
        for lev, lab in zip(levels, label):
            lv = self._coords.get(lev)
            if lv is None:
                raise KeyError(f"stacked level coordinate {lev!r} was dropped")
            mask &= to_numpy(lv.data) == lab
        pos = np.flatnonzero(mask)
        if len(pos) == 0:
            raise KeyError(f"{label!r} not found in stacked dim {dim!r}")
        return int(pos[0])

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

    def reset_coords(self, names=None, drop=True):
        """Drop the non-index coordinates ``names`` (default: all)."""
        if not drop:
            raise NotImplementedError("reset_coords(drop=False)")
        names = names or [k for k in self._coords if k not in self.dims]
        return self.drop_vars(names, errors="ignore")

    def _with_encoding(self, encoding) -> "DataArray":
        """The same payload and coordinates with another encoding."""
        var = Variable(self.variable.dims, self.variable.data, self.attrs, encoding)
        return DataArray._construct(var, dict(self._coords), self.name)

    def set_index(self, **kwargs):
        """A coordinate onto the dim of its name, or (a list of 1-D
        coordinates over the dim) a multi-coordinate index: the level order
        is recorded for tuple-label ``sel`` and ``unstack``; the payload is
        not reshaped."""
        out = self
        for dim, coord in kwargs.items():
            if isinstance(coord, (list, tuple)):
                for c in coord:
                    if out._coords[c].dims != (dim,):
                        raise ValueError(f"set_index level {c!r} must be a 1-D coordinate over {dim!r}")
                # Sizes None: no product layout, unstack takes the sparse
                # unique-level path.
                out = out._with_encoding({**out.encoding, "_stacked_" + dim: (tuple(coord), None)})
                continue
            cv = out._coords[coord]
            new = dict(out._coords)
            del new[coord]
            new[dim] = Variable((dim,), cv.data, cv.attrs)
            out = DataArray._construct(out.variable, new, out.name)
        return out

    def reset_index(self, dims_or_levels, drop: bool = False):
        """Remove the index of the given dims (xarray's semantics): a
        stacked dim forgets its MultiIndex layout, its level coordinates
        kept as plain coordinates unless ``drop``; a dimension coordinate
        becomes the non-index ``<dim>_`` (xarray's name), or is dropped."""
        if isinstance(dims_or_levels, str):
            dims_or_levels = [dims_or_levels]
        encoding = dict(self.encoding)
        coords = dict(self._coords)
        for d in dims_or_levels:
            key = "_stacked_" + d
            if key in encoding:
                levels, _sizes = encoding.pop(key)
                if drop:
                    for name in levels:
                        coords.pop(name, None)
            elif d in coords and coords[d].dims == (d,):
                cv = coords.pop(d)
                if not drop:
                    coords[d + "_"] = cv
            else:
                raise ValueError(f"{d!r} has no index to reset")
        var = Variable(self.variable.dims, self.variable.data, self.attrs, encoding)
        return DataArray._construct(var, coords, self.name)

    def reorder_levels(self, dim_order=None, **kwargs):
        """Reorder the levels of stacked dims' MultiIndexes: only the
        recorded level order changes (the payload does not), so a reordered
        dim unstacks through the sparse unique-level path, levels sorted,
        as xarray's reindex-based unstack does."""
        dim_order = {**(dim_order or {}), **kwargs}
        encoding = dict(self.encoding)
        for d, order in dim_order.items():
            key = "_stacked_" + d
            if key not in encoding:
                raise ValueError(f"{d!r} has no MultiIndex")
            levels, _sizes = encoding[key]
            if sorted(order) != sorted(levels):
                raise ValueError(f"reorder_levels for {d!r}: {tuple(order)} is not a permutation of {tuple(levels)}")
            encoding[key] = (tuple(order), None)
        return self._with_encoding(encoding)

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

    def broadcast_like(self, other) -> "DataArray":
        sizes = {**other.sizes, **self.sizes}
        dims = tuple(dict.fromkeys(tuple(other.dims) + tuple(self.dims)))
        coords = {**other._coords, **self._coords}
        return DataArray._construct(self.variable.broadcast_to(dims, sizes), coords, self.name)

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

    def where(self, cond, other=np.nan, drop: bool = False) -> "DataArray":
        """Keep the values where ``cond`` holds, else ``other``.  With
        ``drop``, first trim every dimension of ``cond`` to the positions
        where it holds anywhere (the mask is read on the host)."""
        cond_var = cond.variable if isinstance(cond, DataArray) else Variable(self.dims, cond)
        if isinstance(other, DataArray):
            other = other.variable
        if drop:
            mask = to_numpy(cond_var.data).astype(bool)
            keep = {dim: _keep_mask(mask, cond_var.dims, dim) for dim in cond_var.dims}
            sub_cond = cond.isel(keep) if isinstance(cond, DataArray) else cond_var.isel(keep).data
            if isinstance(other, Variable):
                sub = {d: keep[d] for d in other.dims if d in keep}
                other = other.isel(sub) if sub else other
            return self.isel(keep).where(sub_cond, other)
        sv, cv = broadcast_variables(self.variable, cond_var)
        if isinstance(other, Variable):
            sv, ov = broadcast_variables(sv, other)
            cv = cv.broadcast_to(sv.dims, sv.sizes)
            other = ov.data
        data, mask = common_operands(sv.data, cv.data)
        if is_tensor(data):
            result = where_tensor(mask, data, other)
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

    # -- payload methods ------------------------------------------------------
    def compute(self):
        return self

    def load(self):
        return self

    def chunk(self, *args, **kwargs):
        return self

    def persist(self):
        return self

    def pipe(self, func, *args, **kwargs):
        return func(self, *args, **kwargs)

    def assign_attrs(self, *args, **kwargs) -> "DataArray":
        out = self.copy(deep=False)
        out.attrs.update(dict(*args, **kwargs))
        return out

    def _with_data(self, data, coords=None, keep_attrs=True) -> "DataArray":
        """A DataArray of the same dims over ``data``."""
        var = Variable(self.dims, data, self.attrs if keep_attrs else None)
        return DataArray._construct(var, dict(self._coords) if coords is None else coords, self.name)

    def clip(self, min=None, max=None) -> "DataArray":
        data = self.data
        if not is_tensor(data):
            return self._with_data(np.clip(data, min, max))
        if not is_floating(data) and any(isinstance(v, float) for v in (min, max)):
            data = data.double()
        return self._with_data(torch.clamp(data, as_tensor_like(min, data), as_tensor_like(max, data)))

    def round(self, decimals=0) -> "DataArray":
        data = self.data
        if not is_tensor(data):
            return self._with_data(np.round(data, decimals))
        if not is_floating(data):
            return self._with_data(data.clone())
        return self._with_data(torch.round(data, decimals=decimals))

    def isin(self, values) -> "DataArray":
        data = self.data
        if is_tensor(data):
            return self._with_data(isin_tensor(data, values))
        return self._with_data(np.isin(data, np.asarray(values)))

    def diff(self, dim, n: int = 1) -> "DataArray":
        axis = self.dims.index(dim)
        data = self.data
        result = torch.diff(data, n=n, dim=axis) if is_tensor(data) else np.diff(data, n=n, axis=axis)
        coords = {k: v.isel({dim: slice(n, None)}) if dim in v.dims else v for k, v in self._coords.items()}
        return self._with_data(result, coords)

    def _cumulative(self, name, dim) -> "DataArray":
        data = self.data
        if not is_tensor(data):
            axis = None if dim is None else self.dims.index(dim)
            return self._with_data(getattr(np, name)(data, axis=axis))
        if dim is None:
            return self._with_data(getattr(torch, name)(data.reshape(-1), dim=0))
        return self._with_data(getattr(torch, name)(data, dim=self.dims.index(dim)))

    def cumsum(self, dim=None) -> "DataArray":
        """Cumulative sum along ``dim`` (None: over the flattened array,
        which only a 1-D array can take)."""
        return self._cumulative("cumsum", dim)

    def cumprod(self, dim=None) -> "DataArray":
        return self._cumulative("cumprod", dim)

    def argmax(self, dim=None):
        return self._reduce("argmax", dim=dim, skipna=False)

    def argmin(self, dim=None):
        return self._reduce("argmin", dim=dim, skipna=False)

    def idxmax(self, dim=None, skipna=True):
        return self._idx_reduce("argmax", dim, skipna)

    def idxmin(self, dim=None, skipna=True):
        return self._idx_reduce("argmin", dim, skipna)

    def _idx_reduce(self, op, dim, skipna):
        """The labels of ``dim`` at the arg reduction.  NaN never wins with
        ``skipna``, and an all-NaN slice gives a NaN (or NaT) label.  A
        tensor payload takes a numeric index's labels on its device;
        other labels (dates, strings) come back on the host."""
        dim = dim or self.dims[0]
        axis = self.dims.index(dim)
        data = self.data
        nan_aware = skipna and is_floating(data)
        coords = {k: v for k, v in self._coords.items() if dim not in v.dims}
        pos_dims = tuple(d for d in self.dims if d != dim)
        index = np.asarray(self.get_index(dim))
        if not is_tensor(data):
            values = np.asarray(data)
            if nan_aware:
                clean = np.where(np.isnan(values), -np.inf if op == "argmax" else np.inf, values)
                pos = (np.argmax if op == "argmax" else np.argmin)(clean, axis=axis)
            else:
                pos = self._reduce(op, dim=dim, skipna=False).data
            labels = index[np.asarray(pos)]
            if nan_aware:
                all_nan = np.isnan(values).all(axis=axis)
                if all_nan.any():
                    if labels.dtype.kind in "mM":
                        labels = np.where(all_nan, np.array("NaT", dtype=labels.dtype), labels)
                    else:
                        labels = np.where(all_nan, np.nan, labels.astype(np.float64))
            return DataArray._construct(Variable(pos_dims, labels), coords, self.name)
        clean = data
        if nan_aware:
            clean = torch.where(torch.isnan(data), -torch.inf if op == "argmax" else torch.inf, data)
        pos = arg_extreme(clean, axis, op == "argmax")
        all_nan = torch.isnan(data).all(dim=axis) if nan_aware else None
        if index.dtype.kind in "biuf":
            labels = torch.from_numpy(index).to(data.device)[pos]
            if all_nan is not None and bool(all_nan.any()):
                labels = torch.where(all_nan, torch.nan, labels.double())
        else:
            labels = index[pos.cpu().numpy()]
            if all_nan is not None:
                missing = all_nan.cpu().numpy()
                if missing.any():
                    nat = np.array("NaT", dtype=labels.dtype) if labels.dtype.kind in "mM" else np.nan
                    labels = np.where(missing, nat, labels if labels.dtype.kind in "mM" else labels.astype(np.float64))
        return DataArray._construct(Variable(pos_dims, labels), coords, self.name)

    def dropna(self, dim: str, how: str = "any") -> "DataArray":
        """Drop positions along ``dim`` holding NaN (any or all over the
        other dimensions); the mask along ``dim`` is read on the host."""
        axis = tuple(i for i, d in enumerate(self.dims) if d != dim)
        data = self.data
        if is_tensor(data):
            isnan = torch.isnan(data) if is_floating(data) else torch.zeros_like(data, dtype=torch.bool)
            if axis:
                isnan = isnan.any(dim=axis) if how == "any" else isnan.all(dim=axis)
            mask = isnan.cpu().numpy()
        else:
            isnan = np.isnan(np.asarray(data))
            mask = isnan.any(axis=axis) if how == "any" else isnan.all(axis=axis)
        return self.isel({dim: np.flatnonzero(~mask)})

    def count(self, dim=None) -> "DataArray":
        """Number of non-null elements along ``dim`` (NaN for floats, NaT
        for datetimes and timedeltas), int64."""
        valid = self.variable.notnull().data
        valid = valid.long() if is_tensor(valid) else np.asarray(valid).astype(np.int64)
        out = DataArray._construct(Variable(self.dims, valid), dict(self._coords), self.name)
        return out._reduce("sum", dim=dim, skipna=False)

    def quantile(self, q, dim=None, skipna=True, **kwargs) -> "DataArray":
        """NaN-aware quantiles (linear interpolation), float64; an array
        ``q`` adds a leading ``quantile`` dimension."""
        q_arr = np.atleast_1d(np.asarray(q, dtype=np.float64))
        if dim is None:
            axis, new_dims = None, ()
        else:
            dims = [dim] if isinstance(dim, str) else list(dim)
            axis = tuple(self.dims.index(d) for d in dims)
            new_dims = tuple(d for d in self.dims if d not in dims)
        data = self.data
        if is_tensor(data):
            result = quantile_tensor(data, q_arr, axis, skipna)
        else:
            result = (np.nanquantile if skipna else np.quantile)(np.asarray(data), q_arr, axis=axis)
        coords = {k: v for k, v in self._coords.items() if set(v.dims) <= set(new_dims)}
        if np.ndim(q) == 0:
            return DataArray._construct(Variable(new_dims, result[0]), coords, self.name)
        coords["quantile"] = Variable(("quantile",), q_arr)
        return DataArray._construct(Variable(("quantile",) + new_dims, result), coords, self.name)

    def rank(self, dim) -> "DataArray":
        """Rank along ``dim`` (average method, NaN stays NaN), float64."""
        axis = self.dims.index(dim)
        data = self.data
        if is_tensor(data):
            return self._with_data(rank_tensor(data, axis))
        from scipy.stats import rankdata

        values = np.asarray(data, dtype=np.float64)
        ranked = rankdata(values, method="average", axis=axis, nan_policy="omit").astype(np.float64)
        return self._with_data(np.where(np.isnan(values), np.nan, ranked))

    def shift(self, shifts=None, fill_value=np.nan, **kwargs) -> "DataArray":
        """Shift the data along dims, ``fill_value`` in the vacated places
        (the coordinates stay).  An integer or bool payload with a NaN
        fill becomes float64."""
        shifts = {**(shifts or {}), **kwargs}
        data = self.data
        promote = isinstance(fill_value, float) and np.isnan(fill_value)
        if is_tensor(data):
            out = data.double() if promote and not is_floating(data) else data.clone()
            for dim, n in shifts.items():
                if n != 0:
                    out = shift_tensor(out, self.dims.index(dim), n, fill_value)
            return self._with_data(out)
        data = np.asarray(data)
        if data.dtype.kind in "iub" and promote:
            data = data.astype(np.float64)
        out = data.copy()
        for dim, n in shifts.items():
            if n == 0:
                continue
            axis = self.dims.index(dim)
            out = np.roll(out, n, axis=axis)
            index = [slice(None)] * out.ndim
            index[axis] = slice(0, n) if n > 0 else slice(n, None)
            out[tuple(index)] = fill_value
        return self._with_data(out)

    def roll(self, shifts=None, roll_coords=False, **kwargs) -> "DataArray":
        """Roll the data (and with ``roll_coords`` the coordinates)
        cyclically along dims."""
        shifts = {**(shifts or {}), **kwargs}
        out = self.data
        for dim, n in shifts.items():
            axis = self.dims.index(dim)
            out = torch.roll(out, n, dims=axis) if is_tensor(out) else np.roll(out, n, axis=axis)
        coords = {}
        for k, v in self._coords.items():
            if roll_coords and any(d in shifts for d in v.dims):
                cdat = to_numpy(v.data)
                for dim, n in shifts.items():
                    if dim in v.dims:
                        cdat = np.roll(cdat, n, axis=v.dims.index(dim))
                coords[k] = Variable(v.dims, cdat, v.attrs)
            else:
                coords[k] = v
        return self._with_data(out, coords)

    def sortby(self, variables, ascending: bool = True) -> "DataArray":
        """Sort along the dimension of each 1-D key (a coordinate name or
        a DataArray), read on the host; the payload is gathered on its
        device."""
        if isinstance(variables, (str, DataArray)):
            variables = [variables]
        out = self
        for v in variables:
            key = self._coords[v] if isinstance(v, str) else v.variable
            if len(key.dims) != 1:
                raise ValueError("sortby requires 1-D sort keys")
            order = np.argsort(to_numpy(key.data), kind="stable")
            out = out.isel({key.dims[0]: order if ascending else order[::-1]})
        return out

    def _fill_directional(self, dim, limit, reverse) -> "DataArray":
        axis = self.dims.index(dim)
        data = self.data
        if is_tensor(data):
            return self._with_data(fill_directional_tensor(data, axis, limit, reverse))
        moved = np.moveaxis(np.asarray(data, dtype=np.float64), axis, 0)
        n = moved.shape[0]
        if reverse:
            moved = moved[::-1]
        idx = np.arange(n).reshape((n,) + (1,) * (moved.ndim - 1))
        valid = ~np.isnan(moved)
        last = np.maximum.accumulate(np.where(valid, idx, -1), axis=0)
        if limit is not None:
            last = np.where((last >= 0) & (idx - last <= limit), last, -1)
        filled = np.take_along_axis(moved, np.where(last >= 0, last, 0), axis=0)
        filled = np.where(valid, moved, np.where(last >= 0, filled, np.nan))
        if reverse:
            filled = filled[::-1]
        return self._with_data(np.moveaxis(filled, 0, axis))

    def ffill(self, dim, limit=None) -> "DataArray":
        """Forward-fill NaN along ``dim`` (at most ``limit`` steps), float64."""
        return self._fill_directional(dim, limit, reverse=False)

    def bfill(self, dim, limit=None) -> "DataArray":
        """Backward-fill NaN along ``dim`` (at most ``limit`` steps), float64."""
        return self._fill_directional(dim, limit, reverse=True)

    def dot(self, other, dims=None) -> "DataArray":
        """Tensor contraction over the shared (or the named) dimensions.
        A tensor payload contracts on its device, float32 without TF32."""
        if dims is None:
            dims = [d for d in self.dims if d in other.dims]
        elif isinstance(dims, str):
            dims = [dims]
        a_keep = [d for d in self.dims if d not in dims]
        b_keep = [d for d in other.dims if d not in dims]
        letters = {d: chr(ord("a") + i) for i, d in enumerate(dict.fromkeys(tuple(self.dims) + tuple(other.dims)))}
        spec = (
            "".join(letters[d] for d in self.dims) + "," + "".join(letters[d] for d in other.dims)
            + "->" + "".join(letters[d] for d in a_keep + b_keep)
        )
        a, b = common_operands(self.data, other.data)
        if is_tensor(a):
            a, b = torch.as_tensor(a), torch.as_tensor(b)
            dtype = torch.promote_types(a.dtype, b.dtype)
            with ieee_float32():
                result = torch.einsum(spec, a.to(dtype), b.to(dtype))
        else:
            result = np.einsum(spec, np.asarray(a), np.asarray(b))
        new_dims = tuple(a_keep + b_keep)
        coords = {k: v for k, v in {**other._coords, **self._coords}.items() if set(v.dims) <= set(new_dims)}
        return DataArray._construct(Variable(new_dims, result), coords, self.name)

    def polyfit(self, dim: str, deg: int, skipna=None):
        """Least-squares polynomial fit along ``dim``: a Dataset with
        ``polyfit_coefficients`` over a ``degree`` dimension (descending
        powers, xarray's layout), float64.  A column with NaN is fit over
        its finite samples when ``skipna`` (default: when NaN are present).
        A tensor payload is fit on its device (``variable.lstsq_tall``: the
        Vandermonde matrix's QR)."""
        from xugrid_tpu_torch.xdata.dataset import Dataset

        axis = self.dims.index(dim)
        x = np.asarray(self.get_index(dim), dtype=np.float64)
        vander = np.vander(x, deg + 1)  # descending powers
        data = self.data
        if is_tensor(data):
            coeffs = polyfit_tensor(data.double().movedim(axis, 0).reshape(len(x), -1), vander, skipna)
        else:
            flat = np.moveaxis(np.asarray(data, dtype=np.float64), axis, 0).reshape(len(x), -1)
            has_nan = bool(np.isnan(flat).any())
            if skipna is None:
                skipna = has_nan
            coeffs = np.full((deg + 1, flat.shape[1]), np.nan)
            if not has_nan:
                coeffs, *_ = np.linalg.lstsq(vander, flat, rcond=None)
            elif skipna:
                finite_cols = ~np.isnan(flat).any(axis=0)
                if finite_cols.any():
                    coeffs[:, finite_cols], *_ = np.linalg.lstsq(vander, flat[:, finite_cols], rcond=None)
                for c in np.flatnonzero(~finite_cols):
                    ok = np.isfinite(flat[:, c])
                    if ok.sum() > deg:
                        coeffs[:, c], *_ = np.linalg.lstsq(vander[ok], flat[ok, c], rcond=None)
        other_dims = tuple(d for d in self.dims if d != dim)
        other_shape = tuple(s for d, s in zip(self.dims, self.shape) if d != dim)
        out = coeffs.reshape((deg + 1,) + other_shape)
        coords = {k: v for k, v in self._coords.items() if dim not in v.dims}
        coords["degree"] = Variable(("degree",), np.arange(deg, -1, -1))
        ds = Dataset()
        ds._variables.update(coords)
        ds._coord_names = set(coords)
        ds["polyfit_coefficients"] = DataArray._construct(Variable(("degree",) + other_dims, out), dict(coords), None)
        return ds

    def integrate(self, coord) -> "DataArray":
        """Trapezoidal integral over the named coordinate (numpy's
        ``trapezoid``, its result dtype; a tensor payload on its device)."""
        key = self._coords[coord]
        dim = key.dims[0]
        axis = self.dims.index(dim)
        data = self.data
        if is_tensor(data):
            result = trapezoid_tensor(data, to_numpy(key.data), axis)
        else:
            trapezoid = getattr(np, "trapezoid", None) or np.trapz
            result = trapezoid(np.asarray(data), x=np.asarray(key.data), axis=axis)
        new_dims = tuple(d for d in self.dims if d != dim)
        coords = {k: v for k, v in self._coords.items() if set(v.dims) <= set(new_dims)}
        return DataArray._construct(Variable(new_dims, result), coords, self.name)

    def differentiate(self, coord) -> "DataArray":
        """Central-difference derivative along the named coordinate
        (numpy's ``gradient``), float64; a tensor payload on its device."""
        key = self._coords[coord]
        dim = key.dims[0]
        axis = self.dims.index(dim)
        x = to_numpy(key.data).astype(np.float64)
        data = self.data
        if is_tensor(data):
            result = gradient_tensor(data.double(), x, axis)
        else:
            result = np.gradient(np.asarray(data, dtype=np.float64), x, axis=axis)
        return self._with_data(result)

    def map_blocks(self, func, args=(), kwargs=None, template=None):
        """``func`` applied to the whole array (one block)."""
        return func(self, *args, **(kwargs or {}))

    def stack(self, dimensions=None, **kwargs) -> "DataArray":
        """Stack several dims into one; the stacked dims' coordinates become
        (stacked,)-shaped level coordinates and the layout is recorded
        (``indexes`` gives its MultiIndex)."""
        dimensions = {**(dimensions or {}), **kwargs}
        out = self
        for new_dim, dims in dimensions.items():
            dims = list(dims)
            base = out.stack_dims(new_dim, dims)
            sizes = [out.sizes[d] for d in dims]
            grids = np.meshgrid(
                *[to_numpy(out._coords[d].data) if d in out._coords else np.arange(out.sizes[d]) for d in dims],
                indexing="ij",
            )
            coords = dict(base._coords)
            for d, g in zip(dims, grids):
                coords[d] = Variable((new_dim,), g.reshape(-1))
            out = DataArray._construct(base.variable, coords, out.name)
            out.encoding["_stacked_" + new_dim] = (tuple(dims), tuple(sizes))
        return out

    def unstack(self, dim=None, fill_value=np.nan) -> "DataArray":
        """Invert ``stack`` through the recorded layout: a reshape while
        the stacked dim holds the whole product in its original order,
        else a scatter into the grid of the levels' unique values (sorted),
        the missing cells ``fill_value``.  A tensor payload stays on its
        device."""
        if dim is None:
            dims = [k[len("_stacked_") :] for k in self.encoding if k.startswith("_stacked_")]
        else:
            dims = [dim] if isinstance(dim, str) else list(dim)
        out = self
        for d in dims:
            key = "_stacked_" + d
            if key not in out.encoding:
                raise ValueError(f"cannot unstack {d!r}: not created by stack()")
            orig_dims, orig_sizes = out.encoding[key]
            axis = out.dims.index(d)
            data = out.data if is_tensor(out.data) else np.asarray(out.data)
            new_dims = out.dims[:axis] + orig_dims + out.dims[axis + 1 :]
            coords = {}
            # The reshape needs the product in its original order: a
            # matching length alone is not enough (sortby and roll keep the
            # length while permuting rows).
            canonical = orig_sizes is not None and data.shape[axis] == int(np.prod(orig_sizes))
            if canonical:
                for k in orig_dims:
                    if k not in out._coords:
                        continue  # a dropped level: no evidence of order
                    flat = to_numpy(out._coords[k].data).reshape(orig_sizes)
                    index = [slice(0, 1)] * len(orig_sizes)
                    index[orig_dims.index(k)] = slice(None)
                    expect = np.broadcast_to(flat[tuple(index)], flat.shape)
                    if not np.array_equal(flat, expect, equal_nan=flat.dtype.kind == "f"):
                        canonical = False
                        break
            if canonical:
                unstacked = data.reshape(tuple(data.shape[:axis]) + tuple(orig_sizes) + tuple(data.shape[axis + 1 :]))
                for k, v in out._coords.items():
                    if d not in v.dims:
                        coords[k] = v
                    elif k in orig_dims:
                        # The 1-D coordinate, recovered from the product.
                        flat = to_numpy(v.data).reshape(orig_sizes)
                        index = [0] * len(orig_sizes)
                        index[orig_dims.index(k)] = slice(None)
                        coords[k] = Variable((k,), flat[tuple(index)])
            else:
                try:
                    level_values = [to_numpy(out._coords[k].data) for k in orig_dims]
                except KeyError:
                    raise ValueError(f"cannot unstack subset of {d!r}: a level coordinate was dropped") from None
                uniq = [np.unique(lv) for lv in level_values]
                new_sizes = tuple(len(u) for u in uniq)
                flat_idx = np.ravel_multi_index(
                    [np.searchsorted(u, lv) for u, lv in zip(uniq, level_values)], new_sizes
                )
                full = len(np.unique(flat_idx)) == int(np.prod(new_sizes))
                promote = not full and not isinstance(fill_value, (int, np.integer))
                moved = range(len(new_sizes)), range(axis, axis + len(new_sizes))
                if is_tensor(data):
                    d0 = data.movedim(axis, 0)
                    dtype = torch.float64 if promote and not is_floating(d0) else d0.dtype
                    out0 = torch.full((int(np.prod(new_sizes)),) + tuple(d0.shape[1:]), fill_value, dtype=dtype, device=d0.device)
                    out0[torch.from_numpy(flat_idx).to(d0.device)] = d0.to(dtype)
                    unstacked = out0.reshape(new_sizes + tuple(d0.shape[1:])).movedim(*map(tuple, moved))
                else:
                    d0 = np.moveaxis(data, axis, 0)
                    dtype = np.float64 if promote and d0.dtype.kind in "iub" else d0.dtype
                    out0 = np.full((int(np.prod(new_sizes)),) + d0.shape[1:], fill_value, dtype=dtype)
                    out0[flat_idx] = d0
                    unstacked = np.moveaxis(out0.reshape(new_sizes + d0.shape[1:]), *moved)
                for k, v in out._coords.items():
                    if d not in v.dims:
                        coords[k] = v
                    elif k in orig_dims:
                        coords[k] = Variable((k,), uniq[orig_dims.index(k)])
            encoding = dict(out.encoding)
            encoding.pop(key)
            out = DataArray._construct(Variable(new_dims, unstacked, out.attrs, encoding), coords, out.name)
        return out

    def reindex(self, indexers=None, method=None, tolerance=None, fill_value=np.nan, **kwargs) -> "DataArray":
        """Conform to new labels of index coordinates; unmatched labels
        take ``fill_value`` (or the nearest, ffill or bfill match within
        ``tolerance``).  The positions are found on the host, the payload
        gathered on its device."""
        indexers = {**(indexers or {}), **kwargs}
        out = self
        for dim, labels in indexers.items():
            labels = to_numpy(labels.data if isinstance(labels, DataArray) else labels)
            current = to_numpy(out._coords[dim].data)
            pos = _reindex_positions(dim, current, labels, method, tolerance)
            axis = out.dims.index(dim)
            data = out.data
            as_float = not isinstance(fill_value, (int, np.integer))
            take = np.clip(pos, 0, len(current) - 1)
            miss_shape = [1] * len(out.dims)
            miss_shape[axis] = len(labels)
            miss = (pos < 0).reshape(miss_shape)
            if is_tensor(data):
                if as_float and not is_floating(data):
                    data = data.double()
                gathered = data.index_select(axis, torch.from_numpy(take).to(data.device))
                gathered = torch.where(torch.from_numpy(miss).to(data.device), fill_value, gathered)
            else:
                data = np.asarray(data)
                if data.dtype.kind in "iub" and as_float:
                    data = data.astype(np.float64)
                gathered = np.where(miss, fill_value, np.take(data, take, axis=axis))
            coords = {}
            for k, v in out._coords.items():
                if k == dim:
                    coords[k] = Variable((dim,), labels)
                elif dim not in v.dims:  # non-index coordinates over dim are dropped
                    coords[k] = v
            out = DataArray._construct(Variable(out.dims, gathered, out.attrs), coords, out.name)
        return out

    def reindex_like(self, other, method=None, tolerance=None, fill_value=np.nan) -> "DataArray":
        indexers = {
            d: to_numpy(other._coords[d].data) for d in self.dims if d in other._coords and d in self._coords
        }
        return self.reindex(indexers, method=method, tolerance=tolerance, fill_value=fill_value)

    def interp(self, coords=None, method="linear", kwargs=None, **coords_kwargs) -> "DataArray":
        """Sequential 1-D interpolation along each named dim, float64, NaN
        outside the coordinate's range: "linear" (``np.interp``'s
        arithmetic), "nearest" (midpoint rule), or scipy's spline kinds
        "slinear", "quadratic" and "cubic".  A tensor payload interpolates
        on its device for "linear" and "nearest"; the spline kinds copy it
        to the host for scipy and the result back to its device."""
        spline_kinds = ("slinear", "quadratic", "cubic")
        if method not in ("linear", "nearest") + spline_kinds:
            raise NotImplementedError("interp supports method='linear', 'nearest', 'slinear', 'quadratic', or 'cubic'")
        targets = {**(coords or {}), **coords_kwargs}
        out = self
        for dim, new in targets.items():
            new = to_numpy(new.data if isinstance(new, DataArray) else new).astype(np.float64)
            scalar = new.ndim == 0
            new1 = np.atleast_1d(new)
            old = to_numpy(out._coords[dim].data).astype(np.float64)
            axis = out.dims.index(dim)
            data = out.data
            if is_tensor(data) and method in ("linear", "nearest"):
                result = interp_tensor(data, old, new1, axis, method)
            else:
                moved = np.moveaxis(to_numpy(data).astype(np.float64), axis, -1)
                flat = moved.reshape(-1, moved.shape[-1])
                order = np.argsort(old, kind="stable")
                so = old[order]
                if method == "nearest":
                    # Midpoint rule, NaN out of range (xarray's semantics).
                    j = np.searchsorted(so, new1)
                    j_lo = np.clip(j - 1, 0, len(so) - 1)
                    j_hi = np.clip(j, 0, len(so) - 1)
                    pick = np.where(np.abs(new1 - so[j_lo]) <= np.abs(so[j_hi] - new1), j_lo, j_hi)
                    oob = (new1 < so[0]) | (new1 > so[-1])
                    res = np.where(oob[None, :], np.nan, flat[:, order][:, pick])
                elif method in spline_kinds:
                    from scipy.interpolate import interp1d

                    f = interp1d(
                        so, flat[:, order], kind=method, axis=1, bounds_error=False, fill_value=np.nan,
                        assume_sorted=True,
                    )
                    res = f(new1)
                else:
                    res = np.empty((flat.shape[0], len(new1)), dtype=np.float64)
                    for i in range(flat.shape[0]):
                        res[i] = np.interp(new1, so, flat[i][order], left=np.nan, right=np.nan)
                result = np.moveaxis(res.reshape(moved.shape[:-1] + (len(new1),)), -1, axis)
                if is_tensor(data):
                    result = torch.from_numpy(np.ascontiguousarray(result)).to(data.device)
            coords2 = {}
            for k, v in out._coords.items():
                if k == dim:
                    coords2[k] = Variable((dim,), new1)
                elif dim not in v.dims:
                    coords2[k] = v
            out = DataArray._construct(Variable(out.dims, result, out.attrs), coords2, out.name)
            if scalar:
                out = out.isel({dim: 0})
        return out

    def interp_like(self, other, method="linear") -> "DataArray":
        targets = {d: to_numpy(other._coords[d].data) for d in self.dims if d in other._coords and d in self._coords}
        return self.interp(targets, method=method)

    def weighted(self, weights):
        from xugrid_tpu_torch.xdata.grouped import DataArrayWeighted

        return DataArrayWeighted(self, weights)

    def groupby(self, group):
        from xugrid_tpu_torch.xdata.grouped import DataArrayGroupBy

        return DataArrayGroupBy(self, group)

    def rolling(self, dim=None, min_periods=None, center=False, **kwargs):
        from xugrid_tpu_torch.xdata.grouped import DataArrayRolling

        return DataArrayRolling(self, {**(dim or {}), **kwargs}, min_periods, center)

    def coarsen(self, dim=None, boundary="exact", **kwargs):
        from xugrid_tpu_torch.xdata.grouped import DataArrayCoarsen

        return DataArrayCoarsen(self, {**(dim or {}), **kwargs}, boundary)

    def resample(self, indexer=None, **kwargs):
        from xugrid_tpu_torch.xdata.grouped import DataArrayResample

        indexer = {**(indexer or {}), **kwargs}
        if len(indexer) != 1:
            raise ValueError("resample expects exactly one dim=freq pair")
        ((dim, freq),) = indexer.items()
        return DataArrayResample(self, dim, freq)

    def interpolate_na(self, dim=None, method: str = "linear", fill_value=None, **kwargs):
        """
        Fill NaN by 1-D interpolation along ``dim`` over its coordinate
        (else positions), float64: interior gaps are interpolated,
        leading and trailing NaN stay unless ``fill_value="extrapolate"``.
        A tensor payload fills every row at once on its device.  For the
        fill over the mesh use ``uda.ugrid.interpolate_na``.
        """
        if dim is None:
            raise ValueError("interpolate_na requires a dim")
        if method not in ("linear", "nearest"):
            raise NotImplementedError(f"method {method!r} not supported")
        axis = self.dims.index(dim)
        n = self.sizes[dim]
        x = to_numpy(self._coords[dim].data).astype(np.float64) if dim in self._coords else np.arange(n, dtype=np.float64)
        if (np.diff(x) <= 0).any():
            # np.interp's result is undefined there (xarray refuses too).
            raise ValueError(f"interpolate_na needs an increasing coordinate along {dim!r}")
        extrapolate = fill_value == "extrapolate"
        if is_tensor(self.data):
            return self._with_data(interpolate_tensor(self.data, x, axis, method, extrapolate))
        moved = np.moveaxis(np.asarray(self.data, dtype=np.float64), axis, -1)
        flat = moved.reshape(-1, n).copy()
        for row in flat:
            ok = ~np.isnan(row)
            if ok.all() or not ok.any():
                continue
            missing = ~ok
            if method == "linear":
                left = right = None if extrapolate else np.nan
                row[missing] = np.interp(x[missing], x[ok], row[ok], left=left, right=right)
                xs, ys = x[ok], row[ok]
                if extrapolate and len(xs) > 1:
                    # np.interp clamps: linear extrapolation at the ends.
                    lo, hi = (x < xs[0]) & missing, (x > xs[-1]) & missing
                    row[lo] = ys[0] + (ys[1] - ys[0]) / (xs[1] - xs[0]) * (x[lo] - xs[0])
                    row[hi] = ys[-1] + (ys[-1] - ys[-2]) / (xs[-1] - xs[-2]) * (x[hi] - xs[-1])
            else:
                idx_ok = np.flatnonzero(ok)
                pos = np.clip(np.searchsorted(x[ok], x[missing]), 1, len(idx_ok) - 1)
                left_i, right_i = idx_ok[pos - 1], idx_ok[pos]
                take_right = np.abs(x[right_i] - x[missing]) < np.abs(x[missing] - x[left_i])
                filled = np.where(take_right, row[right_i], row[left_i])
                if not extrapolate:
                    xs = x[ok]
                    filled = np.where((x[missing] < xs[0]) | (x[missing] > xs[-1]), np.nan, filled)
                row[missing] = filled
        return self._with_data(np.moveaxis(flat.reshape(moved.shape), -1, axis))


def _reindex_positions(dim, current: np.ndarray, labels: np.ndarray, method, tolerance) -> np.ndarray:
    """Positions in ``current`` of each label (-1 where none matches)."""
    if method is None:
        if current.dtype.kind == "O":
            # Object labels (mixed types) do not sort: a hash lookup.
            if len(set(current.tolist())) != len(current):
                raise ValueError(f"cannot reindex dimension {dim!r}: index has duplicate labels")
            lookup = {v: i for i, v in enumerate(current.tolist())}
            return np.array([lookup.get(lab, -1) for lab in labels.tolist()], dtype=np.int64)
        order = np.argsort(current, kind="stable")
        sc = current[order]
        if len(sc) > 1 and (sc[1:] == sc[:-1]).any():
            raise ValueError(f"cannot reindex dimension {dim!r}: index has duplicate labels")
        j = np.searchsorted(sc, labels)
        safe = np.clip(j, 0, len(sc) - 1)
        return np.where((j < len(sc)) & (sc[safe] == labels), order[safe], -1)
    order = np.argsort(current, kind="stable")
    sc = current[order]
    j = np.searchsorted(sc, labels)
    if method == "nearest":
        j_lo, j_hi = np.clip(j - 1, 0, len(sc) - 1), np.clip(j, 0, len(sc) - 1)
        # strict <: pandas breaks exact-distance ties toward the higher label
        pick = np.where(np.abs(labels - sc[j_lo]) < np.abs(sc[j_hi] - labels), j_lo, j_hi)
    elif method in ("ffill", "pad"):
        pick = np.where((j < len(sc)) & (sc[np.clip(j, 0, len(sc) - 1)] == labels), j, j - 1)
    elif method in ("bfill", "backfill"):
        pick = j
    else:
        raise ValueError(f"unknown reindex method: {method}")
    valid = (pick >= 0) & (pick < len(sc))
    safe = np.clip(pick, 0, len(sc) - 1)
    if tolerance is not None:
        valid &= np.abs(sc[safe] - labels) <= tolerance
    return np.where(valid, order[safe], -1)


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
