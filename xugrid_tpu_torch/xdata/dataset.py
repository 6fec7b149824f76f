"""
Dataset: a dict of Variables sharing dimensions, with a set of coordinate
names.  The subset of xarray's Dataset that the UGRID wrappers and the
regridders read; payloads may be torch tensors (``variable.py``).
"""

from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np
import pandas as pd
import torch

from xugrid_tpu_torch.xdata.dataarray import (
    REDUCTIONS,
    DataArray,
    _array_equiv,
    _keep_mask,
    level_mask,
    with_level_masks,
)
from xugrid_tpu_torch.xdata.indexes import as_index, resolve_label_indexer, stacked_multiindex
from xugrid_tpu_torch.xdata.variable import Variable, as_compatible_data, is_tensor, to_numpy


class _DictView(Mapping):
    def __init__(self, owner, names):
        self._owner = owner
        self._names = names

    def __getitem__(self, key) -> DataArray:
        if key not in self._names:
            raise KeyError(key)
        return self._owner[key]

    def __iter__(self):
        return iter(self._names)

    def __len__(self):
        return len(self._names)

    def __contains__(self, key):
        return key in self._names

    def __repr__(self):
        return "\n".join(f"  {k}: {tuple(self._owner._variables[k].dims)}" for k in self._names)


class Dataset:
    __slots__ = ("_variables", "_coord_names", "attrs", "encoding")

    def __init__(self, data_vars=None, coords=None, attrs=None):
        self._variables: dict = {}
        self._coord_names: set = set()
        self.attrs = dict(attrs) if attrs else {}
        self.encoding: dict = {}
        if coords:
            for name, v in coords.items():
                self._set_variable(name, v)
                self._coord_names.add(name)
        if data_vars:
            for name, v in data_vars.items():
                self._set_variable(name, v)

    def _set_variable(self, name, value):
        if isinstance(value, DataArray):
            for cname, cvar in value._coords.items():
                if cname not in self._variables:
                    self._variables[cname] = cvar
                    self._coord_names.add(cname)
            self._variables[name] = value.variable
        elif isinstance(value, Variable):
            self._variables[name] = value
        elif isinstance(value, tuple):
            dims, data = value[0], value[1]
            attrs = value[2] if len(value) > 2 else None
            self._variables[name] = Variable(dims, data, attrs)
        else:
            arr = as_compatible_data(value)
            if arr.ndim == 0:
                self._variables[name] = Variable((), arr)
            elif arr.ndim == 1:
                self._variables[name] = Variable((name,), arr)
            else:
                raise ValueError(
                    f"cannot infer dimensions for variable {name!r}; pass a (dims, data) tuple"
                )
        self._check_sizes()

    def _check_sizes(self):
        sizes = {}
        for vname, var in self._variables.items():
            for d, s in var.sizes.items():
                if d in sizes and sizes[d] != s:
                    raise ValueError(
                        f"conflicting size for dimension {d!r}: {s} (variable {vname!r}) vs {sizes[d]}"
                    )
                sizes.setdefault(d, s)

    # -- mapping interface --------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, (list, tuple)):
            out = Dataset(attrs=self.attrs)
            for k in key:
                out[k] = self[k]
            return out
        if key not in self._variables:
            raise KeyError(key)
        var = self._variables[key]
        coords = {
            k: v
            for k, v in self._variables.items()
            if k in self._coord_names and set(v.dims) <= set(var.dims)
        }
        return DataArray._construct(var, coords, key)

    def __setitem__(self, key, value):
        self._set_variable(key, value)

    def __delitem__(self, key):
        del self._variables[key]
        self._coord_names.discard(key)

    def __contains__(self, key) -> bool:
        return key in self._variables

    def __iter__(self) -> Iterator:
        return iter(self.data_vars)

    def __len__(self) -> int:
        return len(self.data_vars)

    def keys(self):
        return self.data_vars.keys()

    def values(self):
        return (self[k] for k in self.data_vars)

    def items(self):
        return ((k, self[k]) for k in self.data_vars)

    def get(self, key, default=None):
        return self[key] if key in self else default

    # -- properties ---------------------------------------------------------
    @property
    def data_vars(self) -> _DictView:
        return _DictView(self, [k for k in self._variables if k not in self._coord_names])

    @property
    def coords(self) -> _DictView:
        return _DictView(self, list(self._coord_names))

    @property
    def variables(self) -> dict:
        return dict(self._variables)

    def dims_sizes(self) -> dict:
        sizes: dict = {}
        for var in self._variables.values():
            sizes.update(var.sizes)
        return sizes

    @property
    def dims(self) -> dict:
        return self.dims_sizes()

    @property
    def sizes(self) -> dict:
        return self.dims_sizes()

    @property
    def indexes(self) -> dict:
        """Each stacked dim's MultiIndex (its layout recorded in the data
        variables' encodings, its levels at the dataset's level), then each
        dimension coordinate's index."""
        out = {}
        coords = {k: self._variables[k] for k in self._coord_names}
        for name in self.data_vars:
            encoding = self._variables[name].encoding
            for key in encoding:
                dim = key[len("_stacked_") :]
                if key.startswith("_stacked_") and dim not in out:
                    mi = stacked_multiindex(dim, encoding, coords)
                    if mi is not None:
                        out[dim] = mi
        for name in self._coord_names:
            var = self._variables[name]
            if var.dims == (name,) and name not in out:
                out[name] = as_index(var.data)
        return out

    def reset_index(self, dims_or_levels, drop: bool = False) -> "Dataset":
        """``DataArray.reset_index`` for every variable over a stacked dim;
        a dimension coordinate becomes ``<dim>_``, or is dropped."""
        if isinstance(dims_or_levels, str):
            dims_or_levels = [dims_or_levels]
        stacked = {
            k[len("_stacked_") :]
            for name in self.data_vars
            for k in self._variables[name].encoding
            if k.startswith("_stacked_")
        }
        out = self.copy(deep=False)
        for d in dims_or_levels:
            if d in stacked:
                dropped: set = set()

                def _reset(da, d=d, dropped=dropped):
                    if "_stacked_" + d not in da.encoding:
                        return da
                    if drop:
                        dropped.update(da.encoding["_stacked_" + d][0])
                    return da.reset_index(d, drop=drop)

                out = out._apply_per_var(_reset)
                for name in dropped:
                    out._variables.pop(name, None)
                    out._coord_names.discard(name)
            elif d in out._coord_names and out._variables[d].dims == (d,):
                cv = out._variables.pop(d)
                out._coord_names.discard(d)
                if not drop:
                    out._variables[d + "_"] = cv
                    out._coord_names.add(d + "_")
            else:
                raise ValueError(f"{d!r} has no index to reset")
        return out

    def reorder_levels(self, dim_order=None, **kwargs) -> "Dataset":
        dim_order = {**(dim_order or {}), **kwargs}
        return self._apply_per_var(
            lambda da: da.reorder_levels({d: o for d, o in dim_order.items() if "_stacked_" + d in da.encoding})
            if any("_stacked_" + d in da.encoding for d in dim_order)
            else da
        )

    def __repr__(self) -> str:
        lines = ["<xdata.Dataset>", f"Dimensions: {self.dims_sizes()}"]
        if self._coord_names:
            lines.append("Coordinates:")
            lines += [f"  * {k} {tuple(self._variables[k].dims)} {self._variables[k].dtype}" for k in self._coord_names]
        lines.append("Data variables:")
        lines += [f"    {k} {tuple(self._variables[k].dims)} {self._variables[k].dtype}" for k in self.data_vars]
        if self.attrs:
            lines.append(f"Attributes: {self.attrs}")
        return "\n".join(lines)

    # -- conversion ---------------------------------------------------------
    def copy(self, deep: bool = True) -> "Dataset":
        out = Dataset(attrs=dict(self.attrs))
        out._variables = {k: v.copy(deep) for k, v in self._variables.items()}
        out._coord_names = set(self._coord_names)
        return out

    def set_coords(self, names) -> "Dataset":
        if isinstance(names, str):
            names = [names]
        out = self.copy(deep=False)
        for n in names:
            if n not in out._variables:
                raise ValueError(f"{n!r} not found")
            out._coord_names.add(n)
        return out

    def reset_coords(self, names=None, drop: bool = False) -> "Dataset":
        """Make the coordinates ``names`` (default: those that are not
        indexes) data variables, or drop them."""
        if names is None:
            names = [n for n in self._coord_names if self._variables[n].dims != (n,)]
        elif isinstance(names, str):
            names = [names]
        out = self.copy(deep=False)
        for n in names:
            out._coord_names.discard(n)
            if drop:
                del out._variables[n]
        return out

    def drop_vars(self, names, errors: str = "raise") -> "Dataset":
        if isinstance(names, str):
            names = [names]
        out = self.copy(deep=False)
        for n in names:
            if n in out._variables:
                del out._variables[n]
                out._coord_names.discard(n)
            elif errors == "raise":
                raise ValueError(f"{n!r} not found")
        return out

    def drop_dims(self, dims, errors: str = "raise") -> "Dataset":
        """Drop every variable over any of ``dims``."""
        if isinstance(dims, str):
            dims = [dims]
        missing = set(dims) - set(self.dims_sizes())
        if missing and errors == "raise":
            raise ValueError(f"dimensions {missing} not found")
        return self.drop_vars([n for n, v in self._variables.items() if set(v.dims) & set(dims)], errors="ignore")

    def rename(self, name_dict=None, **names) -> "Dataset":
        mapping = dict(name_dict or {})
        mapping.update(names)
        out = Dataset(attrs=dict(self.attrs))
        for name, var in self._variables.items():
            new_dims = tuple(mapping.get(d, d) for d in var.dims)
            out._variables[mapping.get(name, name)] = Variable(new_dims, var.data, var.attrs, var.encoding)
        out._coord_names = {mapping.get(n, n) for n in self._coord_names}
        return out

    def rename_dims(self, dims_dict=None, **dims) -> "Dataset":
        mapping = {**(dims_dict or {}), **dims}
        out = Dataset(attrs=dict(self.attrs))
        for name, var in self._variables.items():
            out._variables[name] = Variable(tuple(mapping.get(d, d) for d in var.dims), var.data, var.attrs, var.encoding)
        out._coord_names = set(self._coord_names)
        return out

    def rename_vars(self, name_dict=None, **names) -> "Dataset":
        mapping = {**(name_dict or {}), **names}
        out = Dataset(attrs=dict(self.attrs))
        out._variables = {mapping.get(name, name): var for name, var in self._variables.items()}
        out._coord_names = {mapping.get(n, n) for n in self._coord_names}
        return out

    def assign(self, variables=None, **kwargs) -> "Dataset":
        out = self.copy(deep=False)
        for k, v in {**(variables or {}), **kwargs}.items():
            out[k] = v
        return out

    def assign_coords(self, coords=None, **kwargs) -> "Dataset":
        out = self.copy(deep=False)
        for k, v in {**(coords or {}), **kwargs}.items():
            out._set_variable(k, v)
            out._coord_names.add(k)
        return out

    def update(self, other) -> "Dataset":
        """Add or replace the variables of ``other`` (a Dataset or a
        mapping) in place; returns this dataset."""
        if isinstance(other, Dataset):
            self._variables.update(other._variables)
            self._coord_names |= other._coord_names
            self._check_sizes()
        else:
            for k, v in other.items():
                self[k] = v
        return self

    def merge(self, other, compat: str = "no_conflicts") -> "Dataset":
        out = self.copy(deep=False)
        if isinstance(other, DataArray):
            other = other.to_dataset()
        if isinstance(other, Dataset):
            for k, v in other._variables.items():
                if k in out._variables:
                    existing = out._variables[k]
                    if existing.dims == v.dims and _array_equiv(existing.data, v.data):
                        continue
                    if compat == "override":
                        continue
                    raise ValueError(f"conflicting values for variable {k!r}")
                out._variables[k] = v
            out._coord_names |= other._coord_names
            out.attrs.update(other.attrs)
        else:
            for k, v in dict(other).items():
                out[k] = v
        out._check_sizes()
        return out

    def map(self, func, *args, **kwargs) -> "Dataset":
        """``func`` applied to every data variable; the coordinates stay."""
        out = Dataset(attrs=dict(self.attrs))
        for k in self._coord_names:
            out._variables[k] = self._variables[k]
            out._coord_names.add(k)
        for k in self.data_vars:
            result = func(self[k], *args, **kwargs)
            out._variables[k] = result.variable if isinstance(result, DataArray) else result
        return out

    def apply(self, func, *args, **kwargs) -> "Dataset":
        """The former name of ``map``."""
        return self.map(func, *args, **kwargs)

    def pipe(self, func, *args, **kwargs):
        return func(self, *args, **kwargs)

    def compute(self):
        return self

    def load(self):
        return self

    def chunk(self, *args, **kwargs):
        return self

    def unify_chunks(self):
        return self

    # -- payload methods, variable by variable --------------------------------
    def _apply_per_var(self, fn, only_dims=None) -> "Dataset":
        """``fn`` (DataArray -> DataArray) applied to every data variable
        (those over none of ``only_dims`` kept as they are), with the
        coordinates whose dimensions kept their sizes."""
        out = Dataset(attrs=dict(self.attrs))
        for name in self.data_vars:
            da = self[name]
            if only_dims is not None and not any(d in da.dims for d in only_dims):
                out._variables[name] = self._variables[name]
                continue
            out._set_variable(name, fn(da))
        sizes = out.dims_sizes()
        for k in self._coord_names:
            if k in out._variables:
                out._coord_names.add(k)
                continue
            var = self._variables[k]
            if all(sizes.get(d) == s for d, s in var.sizes.items()):
                out._variables[k] = var
                out._coord_names.add(k)
        return out

    def where(self, cond, other=np.nan, drop: bool = False) -> "Dataset":
        """Each variable where ``cond`` holds, else ``other``.  With
        ``drop`` (a DataArray ``cond``), every dimension of ``cond`` is
        first trimmed to the positions where it holds anywhere (the mask
        is read on the host)."""
        cond_da = cond if isinstance(cond, DataArray) else None
        if not drop:
            return self._apply_per_var(lambda da: da.where(cond, other))
        if cond_da is None:
            raise TypeError("Dataset.where(drop=True) requires a DataArray cond")
        mask = to_numpy(cond_da.data).astype(bool)
        keep = {dim: _keep_mask(mask, cond_da.dims, dim) for dim in cond_da.dims}
        trimmed = cond_da.isel(keep)
        return self.isel(keep)._apply_per_var(
            lambda da: da.where(trimmed, other) if any(d in da.dims for d in cond_da.dims) else da
        )

    def fillna(self, value) -> "Dataset":
        return self._apply_per_var(lambda da: da.fillna(value))

    def count(self, dim=None) -> "Dataset":
        return self._apply_per_var(
            lambda da: da.count(dim if dim is None or dim in da.dims else None),
            only_dims=None if dim is None else [dim],
        )

    def quantile(self, q, dim=None, skipna=True) -> "Dataset":
        return self._apply_per_var(
            lambda da: da.quantile(q, dim=dim, skipna=skipna), only_dims=None if dim is None else [dim]
        )

    def diff(self, dim, n: int = 1) -> "Dataset":
        return self._apply_per_var(lambda da: da.diff(dim, n=n), only_dims=[dim])

    def shift(self, shifts=None, fill_value=np.nan, **kwargs) -> "Dataset":
        shifts = {**(shifts or {}), **kwargs}
        return self._apply_per_var(
            lambda da: da.shift({d: s for d, s in shifts.items() if d in da.dims}, fill_value=fill_value),
            only_dims=list(shifts),
        )

    def roll(self, shifts=None, roll_coords=False, **kwargs) -> "Dataset":
        shifts = {**(shifts or {}), **kwargs}
        return self._apply_per_var(
            lambda da: da.roll({d: s for d, s in shifts.items() if d in da.dims}, roll_coords=roll_coords),
            only_dims=list(shifts),
        )

    def sortby(self, variables, ascending: bool = True) -> "Dataset":
        """Sort along the dimension of each 1-D key, read on the host."""
        if isinstance(variables, (str, DataArray)):
            variables = [variables]
        out = self
        for v in variables:
            key = out[v] if isinstance(v, str) else v
            order = np.argsort(to_numpy(key.data), kind="stable")
            out = out.isel({key.dims[0]: order if ascending else order[::-1]})
        return out

    def dropna(self, dim, how: str = "any", subset=None) -> "Dataset":
        """Drop positions along ``dim`` holding nulls in the variables
        (``subset``, default all over ``dim``); the mask along ``dim`` is
        read on the host."""
        names = subset if subset is not None else [n for n in self.data_vars if dim in self[n].dims]
        masks = []
        for n in names:
            da = self[n]
            if dim not in da.dims:
                continue
            axis = tuple(i for i, d in enumerate(da.dims) if d != dim)
            isnull = ~da.variable.notnull().data
            if is_tensor(isnull):
                if axis:
                    isnull = isnull.any(dim=axis) if how == "any" else isnull.all(dim=axis)
                masks.append(isnull.cpu().numpy())
            else:
                masks.append(isnull.any(axis=axis) if how == "any" else isnull.all(axis=axis))
        if not masks:
            return self
        bad = np.logical_or.reduce(masks) if how == "any" else np.logical_and.reduce(masks)
        return self.isel({dim: np.flatnonzero(~bad)})

    def to_array(self, dim: str = "variable", name=None) -> DataArray:
        """Every data variable stacked along ``dim``, as float64 (on the
        device of the first tensor payload, where there is one)."""
        names = list(self.data_vars)
        das = [self[n] for n in names]
        all_dims = list(dict.fromkeys(d for da in das for d in da.dims))
        sizes = self.dims_sizes()
        parts = [da.variable.broadcast_to(all_dims, sizes).data for da in das]
        like = next((p for p in parts if is_tensor(p)), None)
        if like is None:
            data = np.stack([np.asarray(p, dtype=np.float64) for p in parts], axis=0)
        else:
            data = torch.stack([torch.as_tensor(p).to(device=like.device, dtype=torch.float64) for p in parts])
        coords = {dim: Variable((dim,), np.array(names, dtype=object))}
        for k in self._coord_names:
            if set(self._variables[k].dims) <= set(all_dims):
                coords[k] = self._variables[k]
        return DataArray(data, dims=(dim,) + tuple(all_dims), coords={k: (v.dims, v.data) for k, v in coords.items()}, name=name)

    def reindex(self, indexers=None, method=None, tolerance=None, fill_value=np.nan, **kwargs) -> "Dataset":
        indexers = {**(indexers or {}), **kwargs}
        return self._apply_per_var(
            lambda da: da.reindex(
                {d: v for d, v in indexers.items() if d in da.dims},
                method=method, tolerance=tolerance, fill_value=fill_value,
            )
            if any(d in da.dims for d in indexers)
            else da
        )

    def reindex_like(self, other, method=None, tolerance=None, fill_value=np.nan) -> "Dataset":
        indexers = {d: to_numpy(other[d].data) for d in self.dims_sizes() if d in other.coords and d in self.coords}
        return self.reindex(indexers, method=method, tolerance=tolerance, fill_value=fill_value)

    def stack(self, dimensions=None, **kwargs) -> "Dataset":
        """``DataArray.stack`` for every variable over a stacked dim; one
        over only some of them is broadcast over the rest first, as in
        xarray."""
        dimensions = {**(dimensions or {}), **kwargs}
        out = self
        for new_dim, dims in dimensions.items():
            dims = tuple(dims)
            sizes = out.dims_sizes()

            def _stack_var(da, dims=dims, new_dim=new_dim, sizes=sizes, source=out):
                if not any(d in da.dims for d in dims):
                    return da
                missing = [d for d in dims if d not in da.dims]
                if missing:
                    var = da.variable.broadcast_to(tuple(da.dims) + tuple(missing), sizes)
                    coords = dict(da._coords)
                    for d in missing:
                        if d in source._variables:
                            coords[d] = source._variables[d]
                    da = DataArray._construct(var, coords, da.name)
                return da.stack({new_dim: dims})

            out = out._apply_per_var(_stack_var)
        return out

    def unstack(self, dim=None) -> "Dataset":
        return self._apply_per_var(
            lambda da: da.unstack(dim) if any(k.startswith("_stacked_") for k in da.encoding) else da
        )

    def interp(self, coords=None, method="linear", **coords_kwargs) -> "Dataset":
        targets = {**(coords or {}), **coords_kwargs}
        return self._apply_per_var(
            lambda da: da.interp({d: v for d, v in targets.items() if d in da.dims}, method=method)
            if any(d in da.dims for d in targets)
            else da
        )

    def polyfit(self, dim: str, deg: int, skipna=None) -> "Dataset":
        """Each variable's fit along ``dim`` (xarray's layout:
        ``{name}_polyfit_coefficients`` over a ``degree`` dim)."""
        out = Dataset(attrs=dict(self.attrs))
        for name, da in self.data_vars.items():
            if dim in da.dims:
                out[f"{name}_polyfit_coefficients"] = da.polyfit(dim, deg, skipna=skipna)["polyfit_coefficients"]
        return out

    def groupby(self, group):
        from xugrid_tpu_torch.xdata.grouped import DatasetGroupBy

        return DatasetGroupBy(self, group)

    def rolling(self, dim=None, min_periods=None, center=False, **kwargs):
        from xugrid_tpu_torch.xdata.grouped import DatasetWindowed

        return DatasetWindowed(self, "rolling", {**(dim or {}), **kwargs}, dict(min_periods=min_periods, center=center))

    def coarsen(self, dim=None, boundary="exact", **kwargs):
        from xugrid_tpu_torch.xdata.grouped import DatasetWindowed

        return DatasetWindowed(self, "coarsen", {**(dim or {}), **kwargs}, dict(boundary=boundary))

    def resample(self, indexer=None, **kwargs):
        from xugrid_tpu_torch.xdata.grouped import DatasetWindowed

        indexer = {**(indexer or {}), **kwargs}
        if len(indexer) != 1:
            raise ValueError("resample expects exactly one dim=freq pair")
        return DatasetWindowed(self, "resample", indexer, {})

    def expand_dims(self, dim=None, **kwargs) -> "Dataset":
        """Every data variable expanded (``DataArray.expand_dims``); a
        coordinate of the new dimension joins the coordinates."""
        out = Dataset(attrs=dict(self.attrs))
        out._coord_names = set(self._coord_names)
        for name, var in self._variables.items():
            if name in self._coord_names:
                out._variables[name] = var
                continue
            da = self[name].expand_dims(dim, **kwargs)
            out._variables[name] = da.variable
            for cname, cvar in da._coords.items():
                if cname not in out._variables:
                    out._variables[cname] = cvar
                    out._coord_names.add(cname)
        return out

    def to_dataframe(self, dim_order=None) -> pd.DataFrame:
        """A pandas DataFrame on the host: one column per data variable,
        indexed by the product of the dimensions (sorted, or
        ``dim_order``)."""
        sizes = self.dims_sizes()
        if dim_order is None:
            dims = sorted(sizes)
        else:
            dims = list(dim_order)
            if set(dims) != set(sizes):
                raise ValueError(f"dim_order {dims} does not match dataset dimensions {sorted(sizes)}")
        if not dims:
            return pd.DataFrame({k: [to_numpy(self._variables[k].data).item()] for k in self.data_vars})
        columns = {k: to_numpy(self._variables[k].broadcast_to(dims, sizes).data).ravel() for k in self.data_vars}
        indexes = self.indexes
        arrays = [np.asarray(indexes[d]) if d in indexes else np.arange(sizes[d]) for d in dims]
        if len(dims) == 1:
            index = pd.Index(arrays[0], name=dims[0])
        else:
            index = pd.MultiIndex.from_product(arrays, names=dims)
        return pd.DataFrame(columns, index=index)

    # -- reductions -----------------------------------------------------------
    def _reduce(self, func_name, dim=None, skipna=None, **kwargs) -> "Dataset":
        """``func_name`` over ``dim`` of every data variable holding it
        (None: all dims); coordinates over a reduced dimension go, the
        others (scalar ones always) stay."""
        out = Dataset(attrs=dict(self.attrs))
        rdims = None if dim is None else ([dim] if isinstance(dim, str) else list(dim))
        for name, var in self._variables.items():
            if name in self._coord_names:
                drop = var.ndim > 0 if rdims is None else any(d in var.dims for d in rdims)
                if not drop:
                    out._variables[name] = var
                    out._coord_names.add(name)
                continue
            here = None if rdims is None else [d for d in rdims if d in var.dims]
            if here == []:
                out._variables[name] = var
                continue
            out._variables[name] = var.reduce(func_name, dim=here, skipna=skipna, **kwargs)
        return out

    # -- indexing -----------------------------------------------------------
    def isel(self, indexers=None, drop: bool = False, missing_dims: str = "raise", **kwargs) -> "Dataset":
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        unknown = set(indexers) - set(self.dims_sizes())
        if unknown and missing_dims == "raise":
            raise ValueError(f"dimensions {unknown} do not exist")
        clean = {}
        renames = {}
        for k, v in indexers.items():
            if isinstance(v, DataArray):
                if v.ndim == 1 and v.dims[0] != k:
                    renames[k] = v.dims[0]
                v = v.data
            clean[k] = v
        out = Dataset(attrs=dict(self.attrs))
        for name, var in self._variables.items():
            sub = {d: clean[d] for d in var.dims if d in clean}
            new_var = var.isel(sub) if sub else var
            if drop and new_var.ndim == 0 and name in self._coord_names:
                continue
            out._variables[name] = new_var
        out._coord_names = {n for n in self._coord_names if n in out._variables}
        if renames:
            out = out.rename(renames)
            for new in renames.values():
                var = out._variables.get(new)
                if var is not None and var.dims == (new,) and new in out._coord_names:
                    del out._variables[new]
                    out._coord_names.discard(new)
        return out

    def sel(self, indexers=None, method=None, tolerance=None, drop: bool = False, **kwargs) -> "Dataset":
        """Label selection on 1-D index coordinates (a dimension without one
        takes the labels as positions); a level of a stacked dim selects by
        that level's values."""
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        positional = {}
        level_masks = {}  # dim -> bool mask of the level selections over it
        dim_sizes = self.dims_sizes()
        for dim, label in indexers.items():
            var = self._variables.get(dim)
            if var is not None and var.dims == (dim,) and dim in self._coord_names:
                positional[dim] = resolve_label_indexer(as_index(var.data), label, method, tolerance)
            elif var is not None and dim in self._coord_names and len(var.dims) == 1 and dim not in dim_sizes:
                # A level: a 1-D coordinate over another dim (the layout
                # stack() makes).
                other = var.dims[0]
                mask = level_mask(to_numpy(var.data), label, dim)
                level_masks[other] = mask if other not in level_masks else level_masks[other] & mask
            else:
                positional[dim] = label
        return self.isel(with_level_masks(positional, level_masks, dim_sizes), drop=drop)

    def transpose(self, *dims) -> "Dataset":
        out = Dataset(attrs=dict(self.attrs))
        for name, var in self._variables.items():
            order = [d for d in dims if d in var.dims]
            order += [d for d in var.dims if d not in order]
            out._variables[name] = var.transpose(*order) if var.ndim > 1 else var
        out._coord_names = set(self._coord_names)
        return out

    def equals(self, other) -> bool:
        if not isinstance(other, Dataset):
            return False
        if set(self._variables) != set(other._variables) or self._coord_names != other._coord_names:
            return False
        for k, v in self._variables.items():
            ov = other._variables[k]
            if v.dims != ov.dims or not _array_equiv(v.data, ov.data):
                return False
        return True

    def identical(self, other) -> bool:
        if not self.equals(other) or self.attrs != other.attrs:
            return False
        return all(v.attrs == other._variables[k].attrs for k, v in self._variables.items())

    # -- files ----------------------------------------------------------------
    def to_netcdf(self, path=None, **kwargs):
        """Write to a netCDF file (``io_netcdf.to_netcdf``); a tensor
        payload is copied to the host."""
        from xugrid_tpu_torch.xdata.io_netcdf import to_netcdf

        return to_netcdf(self, path, **kwargs)

    def to_zarr(self, store=None, **kwargs):
        """Write to a zarr v2 directory store (``io_zarr.to_zarr``); a
        tensor payload is copied to the host."""
        from xugrid_tpu_torch.xdata.io_zarr import to_zarr

        return to_zarr(self, store, **kwargs)

    def close(self):
        pass


def _make_reduce(n):
    def method(self, dim=None, skipna=None, **kwargs):
        return self._reduce(n, dim=dim, skipna=skipna, **kwargs)

    method.__name__ = n
    return method


for _rname in REDUCTIONS:
    setattr(Dataset, _rname, _make_reduce(_rname))
