"""
NetCDF I/O, the port's copy of ``xugrid_tpu/xdata/io_netcdf.py``.

Uses the netCDF4 library when available (NetCDF4/HDF5 files); otherwise
scipy.io.netcdf_file (NetCDF3 classic), which covers UGRID interchange
without any extra dependency.  Opening reads every variable into host
numpy arrays in native byte order, or with ``lazy=True`` leaves the
large ones in the memory-mapped file as ``LazyArray``s: nothing goes to
a device.  Writing copies a tensor payload to the host explicitly
(``.cpu().numpy()``).  The scipy writer makes classic netCDF3 files, in
which one variable holds less than 2^31 - 4 bytes.
"""

from __future__ import annotations

import numpy as np

from xugrid_tpu_torch.xdata.dataset import Dataset
from xugrid_tpu_torch.xdata.lazy import cf_block_decoder
from xugrid_tpu_torch.xdata.variable import Variable, is_tensor, to_numpy

try:
    import netCDF4

    HAS_NETCDF4 = True
except ImportError:
    HAS_NETCDF4 = False


#: CF time-unit multipliers in nanoseconds.
_TIME_UNITS_NS = {
    "nanoseconds": 1,
    "microseconds": 1_000,
    "milliseconds": 1_000_000,
    "seconds": 1_000_000_000,
    "minutes": 60 * 1_000_000_000,
    "hours": 3600 * 1_000_000_000,
    "days": 86400 * 1_000_000_000,
}


def _parse_time_units(units):
    """('seconds since 1970-01-01...') -> (ns_per_unit, epoch) or None."""
    if not isinstance(units, str) or " since " not in units:
        return None
    unit, _, epoch = units.partition(" since ")
    ns = _TIME_UNITS_NS.get(unit.strip().lower().rstrip("s") + "s")
    if ns is None:
        return None
    epoch = epoch.strip().replace(" ", "T").rstrip("Z")
    try:
        return ns, np.datetime64(epoch, "ns")
    except ValueError:
        return None


def _resolve_time_units(units):
    """CF units string -> (ns_per_unit, epoch-or-None), or None when the
    string is not a recognized time unit.  Bare units ('seconds') decode
    to timedelta64 (epoch=None); '<unit> since <epoch>' to datetime64."""
    parsed = _parse_time_units(units)
    if parsed is not None:
        return parsed
    if isinstance(units, str):
        ns = _TIME_UNITS_NS.get(units.strip().lower().rstrip("s") + "s")
        if ns is not None:
            return ns, None
    return None


def _time_values_to_datetime64(data, ns, epoch):
    """Numeric time values -> datetime64[ns] (or timedelta64[ns] when
    epoch is None); non-finite values map to NaT."""
    values = np.asarray(data, dtype=np.float64) * ns
    nat = ~np.isfinite(values)
    delta = np.where(nat, 0, np.round(values)).astype("timedelta64[ns]")
    out = delta if epoch is None else epoch + delta
    if nat.any():
        fill = np.datetime64("NaT") if epoch is not None else np.timedelta64("NaT")
        out = np.where(nat, fill, out)
    return out


def _decode_variable(name, dims, data, attrs, decode_cf: bool) -> Variable:
    if (
        data.dtype == np.dtype("S1")
        and data.ndim >= 1
        and dims
        and str(dims[-1]).startswith("string")
    ):
        # Collapse the CF char-array encoding back to fixed-width bytes
        # (inverse of the writer's "string{N}" trailing dimension).
        k = data.shape[-1]
        data = (
            np.ascontiguousarray(data).view(f"S{max(k, 1)}")
            .reshape(data.shape[:-1])
        )
        dims = tuple(dims[:-1])
    # The CF decode (fill, packing, time units) is the lazy reader's per
    # block decode, applied to the whole variable.
    attrs, encoding, transform, _ = cf_block_decoder(dims, data.dtype, attrs, decode_cf)
    return Variable(dims, transform(data), attrs, encoding)


_LAZY_OPEN_FILES: list = []


def open_dataset(path, decode_cf: bool = True, engine=None, lazy: bool = False) -> Dataset:
    """Read a netCDF file into a Dataset of host numpy arrays.  With
    ``lazy``, the scipy engine opens the file memory-mapped and each large
    variable becomes a ``LazyArray`` that reads and decodes row blocks on
    demand (``_open_scipy_lazy``)."""
    if HAS_NETCDF4 and engine != "scipy" and not lazy:
        return _open_netcdf4(path, decode_cf)
    return _open_scipy(path, decode_cf, lazy)


def _native(data: np.ndarray) -> np.ndarray:
    """A native-byte-order copy: scipy returns big-endian views, which
    torch.from_numpy rejects."""
    if data.dtype.byteorder not in ("=", "|"):
        return data.astype(data.dtype.newbyteorder("="))
    return data.copy()


def _open_scipy(path, decode_cf: bool, lazy: bool = False) -> Dataset:
    from scipy.io import netcdf_file

    if lazy:
        return _open_scipy_lazy(path, decode_cf)
    with netcdf_file(str(path), "r", mmap=False) as f:
        ds = Dataset(attrs={k: _decode_attr(v) for k, v in f._attributes.items()})
        for name, var in f.variables.items():
            data = _native(np.asarray(var.data))
            attrs = {k: _decode_attr(v) for k, v in var._attributes.items()}
            ds._variables[name] = _decode_variable(name, tuple(var.dimensions), data, attrs, decode_cf)
        _mark_coords(ds)
    return ds


def _open_scipy_lazy(path, decode_cf: bool) -> Dataset:
    """Lazy open: large variables become LazyArrays over the scipy memmap;
    small ones (coordinates, topology) load eagerly.  Each loaded block is
    copied into native byte order before it is decoded, so the blocks are
    ready for ``torch.from_numpy``; the operating system pages the rows
    in, and a file larger than host memory opens."""
    from scipy.io import netcdf_file

    from xugrid_tpu_torch.xdata.lazy import LAZY_MIN_BYTES, LazyArray

    f = netcdf_file(str(path), "r", mmap=True)
    # The handle stays open for the process's lifetime (as xarray's file
    # cache keeps it): scipy cannot close a memory-mapped file while views
    # of it exist, and warns from __del__ otherwise.
    _LAZY_OPEN_FILES.append(f)
    ds = Dataset(attrs={k: _decode_attr(v) for k, v in f._attributes.items()})
    for name, var in f.variables.items():
        dims = tuple(var.dimensions)
        attrs = {k: _decode_attr(v) for k, v in var._attributes.items()}
        raw = var.data
        plan = cf_block_decoder(dims, raw.dtype, attrs, decode_cf) if raw.ndim and raw.nbytes >= LAZY_MIN_BYTES else None
        if plan is None:
            ds._variables[name] = _decode_variable(name, dims, _native(np.asarray(raw)), attrs, decode_cf)
            continue
        attrs_out, encoding, transform, out_dtype = plan

        def loader(start, stop, raw=raw, transform=transform):
            return np.ascontiguousarray(transform(_native(np.asarray(raw[start:stop]))))

        ds._variables[name] = Variable(dims, LazyArray(loader, raw.shape, out_dtype), attrs_out, encoding)
    _mark_coords(ds)
    return ds


def _open_netcdf4(path, decode_cf: bool) -> Dataset:
    with netCDF4.Dataset(str(path), "r") as f:
        ds = Dataset(attrs={k: f.getncattr(k) for k in f.ncattrs()})
        for name, var in f.variables.items():
            var.set_auto_maskandscale(False)
            data = np.asarray(var[...])
            attrs = {k: var.getncattr(k) for k in var.ncattrs()}
            ds._variables[name] = _decode_variable(
                name, tuple(var.dimensions), data, attrs, decode_cf
            )
        _mark_coords(ds)
    return ds


def _decode_attr(value):
    if isinstance(value, bytes):
        return value.decode("utf-8", errors="replace")
    return value


def _mark_coords(ds: Dataset) -> None:
    """Mark 1-D vars named after their dim, plus CF 'coordinates' refs.

    The consumed ``coordinates`` attributes move to encoding (CF decode)."""
    referenced: set = set()
    global_coords = ds.attrs.pop("coordinates", None)
    if global_coords:
        ds.encoding["coordinates"] = global_coords
        referenced.update(str(global_coords).split())
    for var in ds._variables.values():
        coords_attr = var.attrs.pop("coordinates", None)
        if coords_attr:
            var.encoding["coordinates"] = coords_attr
            referenced.update(str(coords_attr).split())
    for name, var in ds._variables.items():
        if var.dims == (name,) or name in referenced:
            ds._coord_names.add(name)


_NC3_DTYPES = {
    np.dtype(np.int64): np.int32,
    np.dtype(np.uint64): np.int32,
    np.dtype(np.uint32): np.int32,
    np.dtype(np.uint16): np.int32,
    # NC_BYTE is signed and scipy writes raw uint8 as a char array
    # (read back as |S1, corrupting values): widen to int16.
    np.dtype(np.uint8): np.int16,
    np.dtype(np.bool_): np.int8,
    np.dtype(np.float16): np.float32,
}


def annotate_cf_coordinates(ds: Dataset) -> Dataset:
    """
    Stamp the CF ``coordinates`` attribute on data variables so
    coordinate status survives a file round-trip (dim-named coords are
    recovered by name alone).
    """
    auxiliary = [
        name
        for name in ds._coord_names
        if ds._variables[name].dims != (name,)
    ]
    if not auxiliary:
        return ds
    out = ds.copy(deep=False)
    referenced = set()
    for name, var in out._variables.items():
        if name in out._coord_names:
            continue
        relevant = [
            c for c in auxiliary if set(out._variables[c].dims) <= set(var.dims)
        ]
        if relevant and "coordinates" not in var.attrs:
            var = Variable(var.dims, var.data, dict(var.attrs), var.encoding)
            var.attrs["coordinates"] = " ".join(relevant)
            out._variables[name] = var
            referenced.update(relevant)
    # Coordinates referenced by no data variable go into the global
    # coordinates attribute (xarray convention for orphaned coords).
    orphaned = [c for c in auxiliary if c not in referenced]
    if orphaned:
        out.attrs = dict(out.attrs)
        out.attrs["coordinates"] = " ".join(orphaned)
    return out


def encode_cf_time(ds: Dataset) -> Dataset:
    """
    CF-encode datetime64/timedelta64 variables as float64 with CF time
    units ('seconds since 1970-01-01' / 'seconds'), matching xarray's
    encoding path — NetCDF has no native datetime type.  float64
    seconds carry ~0.25 us resolution over +-100 years; NaT maps to NaN.
    """
    out = None
    for name, var in ds._variables.items():
        if is_tensor(var.data):  # torch has no datetime dtype
            continue
        kind = np.asarray(var.data).dtype.kind
        if kind not in "mM":
            continue
        if out is None:
            out = ds.copy(deep=False)
        data = np.asarray(var.data).astype("datetime64[ns]" if kind == "M" else "timedelta64[ns]")
        nat = np.isnat(data)
        if kind == "M":
            seconds = (
                data.astype("datetime64[ns]").astype(np.int64) / 1e9
            )
            attrs = dict(var.attrs)
            attrs["units"] = "seconds since 1970-01-01"
            attrs["calendar"] = "proleptic_gregorian"
        else:
            seconds = data.astype("timedelta64[ns]").astype(np.int64) / 1e9
            attrs = dict(var.attrs)
            attrs["units"] = "seconds"
        seconds = np.where(nat, np.nan, seconds)
        out._variables[name] = Variable(
            var.dims, seconds, attrs, var.encoding
        )
    return ds if out is None else out


def to_netcdf(ds: Dataset, path, engine=None, **kwargs) -> None:
    ds = annotate_cf_coordinates(encode_cf_time(ds))
    if HAS_NETCDF4 and engine != "scipy":
        _write_netcdf4(ds, path)
        return
    _write_scipy(ds, path)


def _nc3_attr(value):
    """Coerce attribute values to types scipy's netcdf_file can encode
    (its typecode table lacks int64/uint/np.bool_ scalars)."""
    if isinstance(value, np.bool_):
        return int(value)
    if isinstance(value, np.integer):
        v = int(value)
        if np.iinfo(np.int32).min <= v <= np.iinfo(np.int32).max:
            return v
        return np.float64(v)
    if isinstance(value, np.floating):
        # scipy encodes python floats as NC_FLOAT (f32, lossy); an
        # explicit float64 scalar keeps NC_DOUBLE.
        return np.float64(value)
    if isinstance(value, float):
        return np.float64(value)
    if isinstance(value, np.str_):
        return str(value)
    if isinstance(value, np.bytes_):
        return bytes(value)
    if isinstance(value, np.ndarray):
        if value.dtype.kind in "ui" and value.dtype.itemsize > 4:
            info = np.iinfo(np.int32)
            if value.size and (
                value.min() < info.min or value.max() > info.max
            ):
                return value.astype(np.float64)
            return value.astype(np.int32)
        if value.dtype == np.bool_:
            return value.astype(np.int8)
        if value.dtype.kind == "f" and value.dtype.itemsize > 8:
            return value.astype(np.float64)
        return value
    if isinstance(value, (list, tuple)):
        return [_nc3_attr(v) for v in value]
    return value


def _write_scipy(ds: Dataset, path) -> None:
    from scipy.io import netcdf_file

    with netcdf_file(str(path), "w") as f:
        for k, v in ds.attrs.items():
            setattr(f, k, _nc3_attr(v))
        sizes = ds.dims_sizes()
        for dim, size in sizes.items():
            f.createDimension(dim, size)
        for name, var in ds._variables.items():
            data = to_numpy(var.data)
            target = _NC3_DTYPES.get(data.dtype)
            if target is not None:
                data = data.astype(target)
            var_dims = tuple(var.dims)
            if data.dtype.kind in "US":
                # CF char-array encoding (xarray convention): a
                # fixed-width string becomes S1 chars over an extra
                # trailing "string{N}" dimension.
                if data.dtype.kind == "U":
                    data = np.char.encode(data, "utf-8")
                k = max(data.dtype.itemsize, 1)
                strdim = f"string{k}"
                if strdim not in f.dimensions:
                    f.createDimension(strdim, k)
                data = (
                    np.ascontiguousarray(data)
                    .view("S1")
                    .reshape(data.shape + (k,))
                )
                var_dims = var_dims + (strdim,)
            nc_var = f.createVariable(name, data.dtype, var_dims)
            if var.ndim == 0:
                # scipy's assignValue is broken for true scalars; write
                # through the underlying array instead.
                nc_var.data[...] = data
            else:
                nc_var[:] = data
            for k, v in var.attrs.items():
                setattr(nc_var, k, _nc3_attr(v))
            fill = var.encoding.get("_FillValue")
            if fill is not None and "_FillValue" not in var.attrs:
                nc_var._FillValue = _nc3_attr(fill)


def _write_netcdf4(ds: Dataset, path) -> None:
    with netCDF4.Dataset(str(path), "w") as f:
        for k, v in ds.attrs.items():
            f.setncattr(k, v)
        for dim, size in ds.dims_sizes().items():
            f.createDimension(dim, size)
        for name, var in ds._variables.items():
            data = to_numpy(var.data)
            fill = var.attrs.get("_FillValue", var.encoding.get("_FillValue"))
            nc_var = f.createVariable(
                name, data.dtype, tuple(var.dims), fill_value=fill
            )
            if var.ndim == 0:
                nc_var.assignValue(data)
            else:
                nc_var[...] = data
            for k, v in var.attrs.items():
                if k != "_FillValue":
                    nc_var.setncattr(k, v)
