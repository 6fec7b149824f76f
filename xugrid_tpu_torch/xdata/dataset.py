"""
Dataset: a dict of Variables sharing dimensions, with a set of coordinate
names.  The subset of xarray's Dataset that the UGRID wrappers and the
regridders read; payloads may be torch tensors (``variable.py``).
"""

from __future__ import annotations

from typing import Iterator, Mapping

from xugrid_tpu_torch.xdata.dataarray import DataArray, _array_equiv
from xugrid_tpu_torch.xdata.indexes import as_index, resolve_label_indexer
from xugrid_tpu_torch.xdata.variable import Variable, as_compatible_data


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
        return {
            name: as_index(var.data)
            for name in self._coord_names
            if (var := self._variables[name]).dims == (name,)
        }

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

    def rename(self, name_dict=None, **names) -> "Dataset":
        mapping = dict(name_dict or {})
        mapping.update(names)
        out = Dataset(attrs=dict(self.attrs))
        for name, var in self._variables.items():
            new_dims = tuple(mapping.get(d, d) for d in var.dims)
            out._variables[mapping.get(name, name)] = Variable(new_dims, var.data, var.attrs, var.encoding)
        out._coord_names = {mapping.get(n, n) for n in self._coord_names}
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
        """Label selection on 1-D index coordinates; a dimension without
        one takes the labels as positions."""
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        positional = {}
        for dim, label in indexers.items():
            var = self._variables.get(dim)
            if var is not None and var.dims == (dim,) and dim in self._coord_names:
                positional[dim] = resolve_label_indexer(as_index(var.data), label, method, tolerance)
            else:
                positional[dim] = label
        return self.isel(positional, drop=drop)

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
