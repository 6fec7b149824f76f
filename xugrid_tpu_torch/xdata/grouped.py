"""
Grouped and windowed operations of labelled arrays, the port's copy of
``xugrid_tpu/xdata/grouped.py``: GroupBy, Rolling, Coarsen, Weighted and
Resample objects with xarray's reductions, iteration and map.

Group labels, bins and window layouts come from the coordinates, which
are numpy on the host.  A numpy payload is reduced with numpy, exactly as
the JAX package does; a tensor payload stays on its device and is reduced
there with ``reduce_tensor`` (each group's rows gathered with
``index_select``, rolling windows as ``Tensor.unfold`` views, coarsening
windows as a reshape).  Float payloads reduce in float64, NaN-skipping,
as numpy's ``nan`` functions do.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from xugrid_tpu_torch.xdata.variable import Variable, is_floating, is_tensor, reduce_tensor, to_numpy

_REDUCERS = ("mean", "sum", "min", "max", "std", "var", "median", "prod")


def _data_array():
    from xugrid_tpu_torch.xdata.dataarray import DataArray

    return DataArray


def _nan_pad(data: torch.Tensor, axis: int, before: int, after: int) -> torch.Tensor:
    """``data`` with ``before`` and ``after`` NaN slabs along ``axis``."""
    parts = []
    for n in (before, after):
        shape = list(data.shape)
        shape[axis] = n
        parts.append(torch.full(shape, torch.nan, dtype=data.dtype, device=data.device))
    return torch.cat([parts[0], data, parts[1]], dim=axis)


def _coarsen_coord(cvar, dim, k, n):
    """Coarsen one coordinate Variable along ``dim`` with window ``k``.

    The data dimension has already been trimmed or padded to ``n`` (a
    multiple of ``k``); coordinates are NaN-mean-pooled to match
    (xarray's ``coord_func="mean"``), datetime64/timedelta64 through their
    int64 representation.
    """
    axis = cvar.dims.index(dim)
    vals = to_numpy(cvar.data)
    is_time = vals.dtype.kind in "mM"
    time_dtype = vals.dtype
    if is_time:
        fvals = vals.astype("int64").astype(np.float64)
        fvals[np.isnat(vals)] = np.nan
    else:
        fvals = vals.astype(np.float64)
    cur = fvals.shape[axis]
    if cur > n:
        index = [slice(None)] * fvals.ndim
        index[axis] = slice(0, n)
        fvals = fvals[tuple(index)]
    elif cur < n:
        pad = [(0, 0)] * fvals.ndim
        pad[axis] = (0, n - cur)
        fvals = np.pad(fvals, pad, constant_values=np.nan)
    shape = fvals.shape[:axis] + (n // k, k) + fvals.shape[axis + 1 :]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        pooled = np.nanmean(fvals.reshape(shape), axis=axis + 1)
    if is_time:
        pooled = np.where(np.isnan(pooled), np.iinfo("int64").min, pooled)
        pooled = pooled.astype("int64").view(time_dtype).reshape(pooled.shape)
    return Variable(cvar.dims, pooled, cvar.attrs)


# ---------------------------------------------------------------------------
# GroupBy
# ---------------------------------------------------------------------------
class DataArrayGroupBy:
    """Group a DataArray by a 1-D coordinate or array over its dimension."""

    def __init__(self, obj, group):
        DataArray = _data_array()
        self._obj = obj
        if isinstance(group, str):
            self._group_name = group
            key = obj._coords[group]
        elif isinstance(group, DataArray):
            self._group_name = group.name or "group"
            key = group.variable
        else:
            raise TypeError("groupby expects a coordinate name or DataArray")
        if len(key.dims) != 1:
            raise ValueError("groupby requires a 1-D group key")
        self._dim = key.dims[0]
        self._labels, self._inverse = np.unique(to_numpy(key.data), return_inverse=True)
        self._inverse = self._inverse.ravel()

    def __len__(self):
        return len(self._labels)

    def _positions(self, k) -> np.ndarray:
        return np.flatnonzero(self._inverse == k)

    def __iter__(self):
        for k, label in enumerate(self._labels):
            yield label, self._obj.isel({self._dim: self._positions(k)})

    def map(self, func, *args, **kwargs):
        from xugrid_tpu_torch.xdata import concat

        results = [func(sub, *args, **kwargs) for _, sub in self]
        payloads = [getattr(r, "data", r) for r in results]
        if all(getattr(p, "ndim", np.ndim(p)) == 0 for p in payloads):
            # Stacked (not float()), so datetime64 and integer results keep
            # their dtype (first and last on time data).
            if any(is_tensor(p) for p in payloads):
                return self._wrap_scalars(torch.stack([torch.as_tensor(p) for p in payloads]))
            return self._wrap_scalars(np.stack([np.asarray(p) for p in payloads]))
        out = concat(results, dim=self._dim)
        # Where the group dim survives whole (transform-like results), the
        # original element order comes back: concat emits the groups in
        # label order (xarray's _maybe_reorder).
        if out.sizes.get(self._dim) == len(self._inverse):
            grouped_pos = np.concatenate([self._positions(k) for k in range(len(self._labels))])
            out = out.isel({self._dim: np.argsort(grouped_pos, kind="stable")})
        return out

    def _wrap_scalars(self, values):
        var = Variable((self._group_name,), values)
        coords = {self._group_name: Variable((self._group_name,), self._labels)}
        return _data_array()._construct(var, coords, self._obj.name)

    def _grouped_layout(self):
        """The dims and coordinates of a per-group stack, the group axis in
        the grouped dim's place."""
        obj = self._obj
        new_dims = tuple(self._group_name if d == self._dim else d for d in obj.dims)
        coords = {k: v for k, v in obj._coords.items() if self._dim not in v.dims}
        coords[self._group_name] = Variable((self._group_name,), self._labels)
        return new_dims, coords

    def _reduce(self, func_name, **kwargs):
        obj = self._obj
        axis = obj.dims.index(self._dim)
        data = obj.data
        # NaN-skipping matters only for inexact input: integers, bools and
        # datetimes take the plain reduction, so sum/min/max keep their
        # dtype (xarray's behaviour) and datetime64 reduces.
        floating = is_floating(data) if is_tensor(data) else np.asarray(data).dtype.kind == "f"
        if is_tensor(data):
            moved = data.movedim(axis, 0)
            if floating:
                moved = moved.double()
            pieces = [
                reduce_tensor(
                    moved.index_select(0, torch.from_numpy(self._positions(k)).to(data.device)),
                    func_name, (0,), floating, **kwargs,
                )
                for k in range(len(self._labels))
            ]
            result = torch.stack(pieces, dim=0).movedim(0, axis)
        else:
            data = np.asarray(data)
            if floating:
                data = data.astype(np.float64)
                func = getattr(np, f"nan{func_name}")
            else:
                func = getattr(np, func_name)
            moved = np.moveaxis(data, axis, 0)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                pieces = [func(moved[self._inverse == k], axis=0, **kwargs) for k in range(len(self._labels))]
            result = np.moveaxis(np.stack(pieces, axis=0), 0, axis)
        new_dims, coords = self._grouped_layout()
        return _data_array()._construct(Variable(new_dims, result, obj.attrs), coords, obj.name)

    def _dispatch_reduce(self, name, dim, **kwargs):
        """xarray's groupby-reduce over an explicit ``dim``: the group dim
        (or None) collapses to one value per label; other dims reduce
        inside each group, transform-like; Ellipsis, or a list holding the
        group dim, reduces everything requested within each group at once."""
        group_dims = (None, self._dim, self._group_name)
        if dim in group_dims:
            if name == "count":
                return self._count_groupwise()
            return self._reduce(name, **kwargs)
        if dim is Ellipsis:
            return self.map(lambda sub: getattr(sub, name)(**kwargs))
        dims = [dim] if isinstance(dim, str) else list(dim)
        if self._dim in dims or self._group_name in dims:
            inner = [d for d in dims if d not in (self._dim, self._group_name)]
            return self.map(lambda sub: getattr(sub, name)(inner + [self._dim], **kwargs))
        return self.map(lambda sub: getattr(sub, name)(dims[0] if len(dims) == 1 else dims, **kwargs))

    def count(self, dim=None):
        return self._dispatch_reduce("count", dim)

    def _count_groupwise(self):
        obj = self._obj
        axis = obj.dims.index(self._dim)
        valid = obj.variable.notnull().data
        if is_tensor(valid):
            moved = valid.movedim(axis, 0)
            pieces = [
                moved.index_select(0, torch.from_numpy(self._positions(k)).to(valid.device)).sum(dim=0)
                for k in range(len(self._labels))
            ]
            stacked = torch.stack(pieces, dim=0).movedim(0, axis).long()
        else:
            moved = np.moveaxis(np.asarray(valid), axis, 0)
            pieces = [moved[self._inverse == k].sum(axis=0) for k in range(len(self._labels))]
            stacked = np.moveaxis(np.stack(pieces, axis=0), 0, axis).astype(np.int64)
        new_dims, coords = self._grouped_layout()
        return _data_array()._construct(Variable(new_dims, stacked), coords, obj.name)

    def first(self):
        return self.map(lambda sub: sub.isel({self._dim: 0}))

    def last(self):
        return self.map(lambda sub: sub.isel({self._dim: -1}))


def _make_group_reduce(n):
    def method(self, dim=None, **kwargs):
        return self._dispatch_reduce(n, dim, **kwargs)

    method.__name__ = n
    return method


for _name in _REDUCERS:
    setattr(DataArrayGroupBy, _name, _make_group_reduce(_name))


class DatasetGroupBy:
    def __init__(self, ds, group):
        self._ds = ds
        self._group = group

    def _key(self):
        return self._ds[self._group] if isinstance(self._group, str) else self._group

    def _apply(self, method_name, *args, **kwargs):
        from xugrid_tpu_torch.xdata.dataset import Dataset

        out = Dataset(attrs=dict(self._ds.attrs))
        key = self._key()
        dim = key.dims[0]
        for name in self._ds.data_vars:
            da = self._ds[name]
            if dim in da.dims:
                by_name = isinstance(self._group, str) and self._group in da._coords
                out[name] = getattr(da.groupby(self._group if by_name else key), method_name)(*args, **kwargs)
            else:
                out[name] = da
        return out

    def __iter__(self):
        key = self._key()
        dim = key.dims[0]
        labels, inverse = np.unique(to_numpy(key.data), return_inverse=True)
        for k, label in enumerate(labels):
            yield label, self._ds.isel({dim: np.flatnonzero(inverse.ravel() == k)})


def _make_ds_group(n):
    def method(self, *args, **kwargs):
        return self._apply(n, *args, **kwargs)

    method.__name__ = n
    return method


for _name in _REDUCERS + ("count", "first", "last"):
    setattr(DatasetGroupBy, _name, _make_ds_group(_name))


# ---------------------------------------------------------------------------
# Rolling
# ---------------------------------------------------------------------------
class DataArrayRolling:
    """Rolling windows over one or more dimensions (NaN-padded edges; the
    reductions run over the whole window product, as in xarray)."""

    def __init__(self, obj, windows, min_periods=None, center=False):
        if not windows:
            raise ValueError("rolling requires at least one dimension")
        self._obj = obj
        self._windows_map = dict(windows)
        total = int(np.prod(list(self._windows_map.values())))
        self._min_periods = total if min_periods is None else min_periods
        self._center = center

    def _pads(self, w):
        if self._center:
            pad_l = (w - 1) // 2
            return pad_l, w - 1 - pad_l
        return w - 1, 0

    def _windows(self):
        """(windowed float64 payload, window-axis count); the trailing axes
        are the per-dim window axes in insertion order (a tensor payload's
        are ``unfold`` views of one padded copy)."""
        obj = self._obj
        if is_tensor(obj.data):
            data = obj.data.double()
            for dim, w in self._windows_map.items():
                axis = obj.dims.index(dim)
                data = _nan_pad(data, axis, *self._pads(w)).unfold(axis, w, 1)
            return data, len(self._windows_map)
        data = np.asarray(obj.data, dtype=np.float64)
        for dim, w in self._windows_map.items():
            axis = obj.dims.index(dim)
            pad = [(0, 0)] * data.ndim
            pad[axis] = self._pads(w)
            data = np.pad(data, pad, constant_values=np.nan)
            data = np.lib.stride_tricks.sliding_window_view(data, w, axis=axis)
        return data, len(self._windows_map)

    def _reduce(self, func_name):
        obj = self._obj
        win, n_win = self._windows()
        wax = tuple(range(win.ndim - n_win, win.ndim))
        if is_tensor(win):
            result = reduce_tensor(win, func_name, wax, True)
            counts = (~torch.isnan(win)).sum(dim=wax)
            result = torch.where(counts >= self._min_periods, result, torch.nan)
        else:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                result = getattr(np, f"nan{func_name}")(win, axis=wax)
                counts = np.sum(~np.isnan(win), axis=wax)
            result = np.where(counts >= self._min_periods, result, np.nan)
        return _data_array()._construct(Variable(obj.dims, result, obj.attrs), dict(obj._coords), obj.name)

    def count(self):
        obj = self._obj
        win, n_win = self._windows()
        wax = tuple(range(win.ndim - n_win, win.ndim))
        if is_tensor(win):
            counts = (~torch.isnan(win)).sum(dim=wax).double()
        else:
            counts = np.sum(~np.isnan(win), axis=wax).astype(np.float64)
        return _data_array()._construct(Variable(obj.dims, counts), dict(obj._coords), obj.name)

    def construct(self, window_dim):
        obj = self._obj
        if isinstance(window_dim, str):
            if len(self._windows_map) != 1:
                raise ValueError("construct with multiple rolling dims needs a mapping of dim -> window_dim")
            names = [window_dim]
        else:
            names = [window_dim[d] for d in self._windows_map]
        win, _ = self._windows()
        return _data_array()._construct(Variable(obj.dims + tuple(names), win), dict(obj._coords), obj.name)


def _make_window_reduce(n):
    def method(self, **kwargs):
        return self._reduce(n)

    method.__name__ = n
    return method


for _name in _REDUCERS:
    setattr(DataArrayRolling, _name, _make_window_reduce(_name))


# ---------------------------------------------------------------------------
# Coarsen
# ---------------------------------------------------------------------------
class DataArrayCoarsen:
    def __init__(self, obj, windows, boundary="exact"):
        self._obj = obj
        self._windows = dict(windows)
        self._boundary = boundary

    def _reduce(self, func_name):
        obj = self._obj
        data = obj.data
        tensor = is_tensor(data)
        if not tensor:
            data = np.asarray(data)
        # boundary="pad" brings NaN fill, which needs float; exact or
        # trimmed windows of other input reduce in their own dtype, so
        # integer sum/min/max stay integer (xarray's behaviour).
        needs_float = (is_floating(data) if tensor else data.dtype.kind == "f") or self._boundary == "pad"
        if needs_float:
            data = data.double() if tensor else data.astype(np.float64)
        coords = dict(obj._coords)
        for dim, k in self._windows.items():
            axis = obj.dims.index(dim)
            n = data.shape[axis]
            if n % k:
                if self._boundary == "exact":
                    raise ValueError(f"dimension {dim!r} size {n} is not a multiple of window {k}")
                if self._boundary == "trim":
                    index = [slice(None)] * data.ndim
                    index[axis] = slice(0, n - n % k)
                    data = data[tuple(index)]
                elif self._boundary == "pad":
                    if tensor:
                        data = _nan_pad(data, axis, 0, k - n % k)
                    else:
                        pad = [(0, 0)] * data.ndim
                        pad[axis] = (0, k - n % k)
                        data = np.pad(data, pad, constant_values=np.nan)
                n = data.shape[axis]
            shape = tuple(data.shape[:axis]) + (n // k, k) + tuple(data.shape[axis + 1 :])
            if tensor:
                data = reduce_tensor(data.reshape(shape), func_name, (axis + 1,), needs_float)
            else:
                func = getattr(np, f"nan{func_name}" if needs_float else func_name)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)
                    data = func(data.reshape(shape), axis=axis + 1)
            # Every coordinate over this dim is coarsened (a NaN-mean), so
            # each boundary mode gives n // k entries along the dim
            # (xarray's coord_func="mean").
            for cname, cvar in list(coords.items()):
                if dim in cvar.dims:
                    coords[cname] = _coarsen_coord(cvar, dim, k, n)
        return _data_array()._construct(Variable(obj.dims, data, obj.attrs), coords, obj.name)


for _name in _REDUCERS:
    setattr(DataArrayCoarsen, _name, _make_window_reduce(_name))


# ---------------------------------------------------------------------------
# Weighted
# ---------------------------------------------------------------------------
class DataArrayWeighted:
    def __init__(self, obj, weights):
        self._obj = obj
        self._weights = weights

    def _aligned(self):
        """(float64 data, weights zeroed where the data is NaN, valid mask);
        tensors on the payload's device when either is a tensor."""
        obj, w = self._obj, self._weights
        wb = w.broadcast_like(obj)
        like = next((d for d in (obj.data, wb.data) if is_tensor(d)), None)
        if like is not None:
            data = torch.as_tensor(obj.data, device=like.device).double()
            wd = torch.as_tensor(wb.data, device=like.device).double()
            valid = ~torch.isnan(data)
            return data, torch.where(valid, wd, 0.0), valid
        data = np.asarray(obj.data, dtype=np.float64)
        wd = np.asarray(wb.data, dtype=np.float64)
        valid = ~np.isnan(data)
        return data, np.where(valid, wd, 0.0), valid

    def _axes(self, dim):
        if dim is None:
            return None
        dims = [dim] if isinstance(dim, str) else list(dim)
        return tuple(self._obj.dims.index(d) for d in dims)

    @staticmethod
    def _sum(x, axes):
        if is_tensor(x):
            return x.sum() if axes is None else x.sum(dim=axes)
        return np.sum(x, axis=axes)

    @staticmethod
    def _ratio(num, den):
        """num / den where den > 0, else NaN."""
        if is_tensor(num):
            return torch.where(den > 0, num / torch.where(den == 0, 1.0, den), torch.nan)
        return np.where(den > 0, num / np.where(den == 0, 1.0, den), np.nan)

    def _wrap(self, result, dim):
        obj = self._obj
        if dim is None:
            new_dims = ()
        else:
            dims = [dim] if isinstance(dim, str) else list(dim)
            new_dims = tuple(d for d in obj.dims if d not in dims)
        coords = {k: v for k, v in obj._coords.items() if set(v.dims) <= set(new_dims)}
        return _data_array()._construct(Variable(new_dims, result), coords, obj.name)

    def _weighted_sum(self, data, wd, valid, axes):
        zeroed = torch.where(valid, data, 0.0) if is_tensor(data) else np.where(valid, data, 0.0)
        return self._sum(zeroed * wd, axes)

    def sum(self, dim=None, skipna=True):
        data, wd, valid = self._aligned()
        return self._wrap(self._weighted_sum(data, wd, valid, self._axes(dim)), dim)

    def sum_of_weights(self, dim=None):
        _, wd, _ = self._aligned()
        return self._wrap(self._sum(wd, self._axes(dim)), dim)

    def mean(self, dim=None, skipna=True):
        data, wd, valid = self._aligned()
        axes = self._axes(dim)
        return self._wrap(self._ratio(self._weighted_sum(data, wd, valid, axes), self._sum(wd, axes)), dim)

    def var(self, dim=None, skipna=True):
        data, wd, valid = self._aligned()
        axes = self._axes(dim)
        den = self._sum(wd, axes)
        mean = self._ratio(self._weighted_sum(data, wd, valid, axes), den)
        if is_tensor(data):
            mean_b = mean
            for a in sorted(axes or ()):
                mean_b = mean_b.unsqueeze(a)
            dev = torch.where(valid, (data - mean_b) ** 2, 0.0)
        else:
            mean_b = np.expand_dims(mean, axes) if axes else mean
            dev = np.where(valid, (data - mean_b) ** 2, 0.0)
        return self._wrap(self._ratio(self._sum(dev * wd, axes), den), dim)

    def std(self, dim=None, skipna=True):
        out = self.var(dim=dim, skipna=skipna)
        return out._apply_unary(lambda d: torch.sqrt(d) if is_tensor(d) else np.sqrt(d))


# ---------------------------------------------------------------------------
# Resample (time frequencies through pandas)
# ---------------------------------------------------------------------------
#: Offset aliases removed in pandas >= 2.2/3.0, mapped to their
#: replacements so that code written for older pandas keeps working.
_LEGACY_FREQ_ALIASES = {
    "H": "h", "T": "min", "S": "s", "L": "ms", "U": "us", "N": "ns",
    "M": "ME", "Q": "QE", "A": "YE", "Y": "YE",
    "BM": "BME", "BQ": "BQE", "BA": "BYE", "BY": "BYE",
}


def _resample_bin_labels(times, freq):
    """Each element's bin label by pandas' own resample binning
    (``pd.Grouper``), which covers every pandas offset alias, anchored
    ones (QS, W-SUN, YS) included, with the label conventions xarray users
    expect (month-end labels for "ME").

    Returns ``(labels, full_bins)``: the labels and the whole regular bin
    range, empty bins included (resample emits NaN rows for gaps)."""
    import re

    import pandas as pd

    def grouper_bins(f):
        s = pd.Series(np.zeros(len(times)), index=times)
        idx = s.groupby(pd.Grouper(freq=f)).indices
        full = s.resample(f).size().index
        return idx, full

    try:
        idx, full = grouper_bins(freq)
    except ValueError:
        m = re.match(r"^(\d*)([A-Za-z]+)(-\w+)?$", str(freq))
        alias = _LEGACY_FREQ_ALIASES.get(m.group(2)) if m else None
        if alias is None:
            raise
        idx, full = grouper_bins((m.group(1) or "") + alias + (m.group(3) or ""))
    labels = np.empty(len(times), dtype="datetime64[ns]")
    for lab, pos in idx.items():
        labels[np.asarray(pos)] = np.datetime64(lab)
    return labels, np.asarray(full, dtype="datetime64[ns]")


class DataArrayResample:
    def __init__(self, obj, dim, freq):
        import pandas as pd

        self._obj = obj
        self._dim = dim
        times = pd.to_datetime(to_numpy(obj._coords[dim].data))
        self._bins, self._full_bins = _resample_bin_labels(times, freq)
        self._key = _data_array()(np.asarray(self._bins), dims=(dim,), name=dim)

    def _grouped(self):
        return DataArrayGroupBy(self._obj, self._key)

    def __iter__(self):
        return iter(self._grouped())

    def __getattr__(self, name):
        if name in _REDUCERS + ("count", "first", "last", "map"):
            grouped = self._grouped()

            def method(*args, **kwargs):
                out = getattr(grouped, name)(*args, **kwargs)
                if grouped._group_name != self._dim:
                    out = out.rename({grouped._group_name: self._dim})
                # The whole regular bin range: empty bins take NaN (0 for
                # count), as pandas and xarray resample.
                if self._dim in out.dims and out.sizes[self._dim] < len(self._full_bins):
                    fill = 0 if name == "count" else np.nan
                    out = out.reindex({self._dim: self._full_bins}, fill_value=fill)
                return out

            return method
        raise AttributeError(name)


# ---------------------------------------------------------------------------
# Dataset windowed dispatch (rolling / coarsen / resample per variable)
# ---------------------------------------------------------------------------
class DatasetWindowed:
    """A DataArray windowing operation (rolling, coarsen or resample)
    applied to every data variable over a windowed dimension."""

    def __init__(self, ds, kind, windows, options):
        self._ds = ds
        self._kind = kind
        self._windows = dict(windows)
        self._options = dict(options)

    def _reduce(self, method_name, *args, **kwargs):
        from xugrid_tpu_torch.xdata.dataset import Dataset

        dims = list(self._windows)
        out = Dataset(attrs=dict(self._ds.attrs))
        for name in self._ds.data_vars:
            da = self._ds[name]
            if not any(d in da.dims for d in dims):
                out._variables[name] = self._ds._variables[name]
                continue
            sub_windows = {d: w for d, w in self._windows.items() if d in da.dims}
            if self._kind == "rolling":
                obj = da.rolling(sub_windows, **self._options)
            elif self._kind == "coarsen":
                obj = da.coarsen(sub_windows, **self._options)
            else:
                obj = da.resample(sub_windows)
            out._set_variable(name, getattr(obj, method_name)(*args, **kwargs))
        sizes = out.dims_sizes()
        for k in self._ds._coord_names:
            if k in out._variables:
                out._coord_names.add(k)
                continue
            var = self._ds._variables[k]
            if all(sizes.get(d) == s for d, s in var.sizes.items()):
                out._variables[k] = var
                out._coord_names.add(k)
        return out

    def __getattr__(self, name):
        if name in _REDUCERS + ("count", "first", "last"):
            def method(*args, **kwargs):
                return self._reduce(name, *args, **kwargs)

            return method
        raise AttributeError(name)
