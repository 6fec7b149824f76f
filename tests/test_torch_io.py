"""
The port's eager netCDF and zarr IO (``xugrid_tpu_torch.xdata.io_netcdf``
and ``io_zarr``) held on the CPU against the JAX package's: a Dataset
written by one package is opened by the other (and by itself), over the
scipy netCDF engine and zarr, and the two packages' opened datasets are
equal variable for variable, attribute for attribute and bit for bit.

The cases follow ``tests/test_xdata.py``'s IO tests: CF time (datetime
and timedelta, NaT included, and a foreign ``days since`` unit),
strings (the CF char-array encoding), uint8 widening, numpy attributes
(int64, bool, float64 kept f64), integer fill values kept as integers
in ``encoding``, packed data, zero-length zarr arrays and foreign zarr
stores.  The port also writes tensor payloads (copied to the host),
and opens payloads that ``torch.from_numpy`` takes (native byte order).
The lazy reads are held in ``tests/test_torch_lazy.py``.
"""

import json
import zlib

import numpy as np
import pytest
import torch

import xugrid_tpu as xu
import xugrid_tpu_torch as xt

PACKAGES = {"jax": xu, "torch": xt}
#: (writer, reader): each package reads the other's files and its own.
PAIRS = [("jax", "torch"), ("torch", "jax"), ("torch", "torch")]
FORMATS = ["nc", "zarr"]


def write(ds, path, fmt):
    (ds.to_netcdf if fmt == "nc" else ds.to_zarr)(path)


def read(pkg, path, fmt):
    if fmt == "nc":
        return pkg.xdata.open_dataset(path, engine="scipy")
    return pkg.xdata.open_zarr(path)


def assert_attrs_equal(got: dict, want: dict, name=""):
    assert sorted(got) == sorted(want), name
    for key, value in want.items():
        assert type(got[key]) is type(value) or np.ndim(value) == 0, (name, key)
        np.testing.assert_array_equal(got[key], value, err_msg=f"{name}.{key}")


def assert_same(got, want):
    """Equal datasets: names, coordinate names, dims, dtypes, attrs,
    encodings and values (bit for bit, NaN and NaT equal)."""
    assert sorted(got._variables) == sorted(want._variables)
    assert got._coord_names == want._coord_names
    assert_attrs_equal(got.attrs, want.attrs)
    for name, var in want._variables.items():
        other = got._variables[name]
        data = np.asarray(var.data)
        assert other.dims == var.dims and other.values.dtype == data.dtype.newbyteorder("="), name
        assert_attrs_equal(other.attrs, var.attrs, name)
        assert_attrs_equal(other.encoding, var.encoding, name)
        np.testing.assert_array_equal(other.values, data, err_msg=name)


def times():
    return np.array(["2020-01-01", "2020-01-02T06:30:00", "NaT"], dtype="datetime64[ns]")


def time_dataset(pkg):
    ds = pkg.xdata.Dataset()
    ds["v"] = pkg.xdata.DataArray(np.arange(3.0), dims=("time",)).assign_coords(time=times())
    ds["dt"] = (("x",), np.array([1, 2, -5], dtype="timedelta64[s]").astype("timedelta64[ns]"))
    ds["lag"] = (("time",), np.array([1_500_000, "NaT", 0], dtype="timedelta64[ns]"))
    return ds


def string_dataset(pkg):
    ds = pkg.xdata.Dataset()
    ds["names"] = (("x",), np.array(["alpha", "be", "gamma!"], "U"))
    ds["codes"] = (("x",), np.array([b"ab", b"c", b"de"], "S2"))
    ds["title_var"] = ((), np.str_("hello"))
    return ds


def dtype_dataset(pkg):
    ds = pkg.xdata.Dataset(attrs={"gattr": np.int64(3), "flag": np.True_})
    ds["flags"] = (("x",), np.array([0, 1, 127, 128, 255], np.uint8))
    ds["big"] = (("x",), np.arange(5, dtype=np.int64) * 1000)
    ds["half"] = (("x",), np.arange(5, dtype=np.float16))
    ds["mask"] = (("x",), np.array([True, False, True, True, False]))
    ds["conn"] = (("face", "nmax"), np.array([[0, 1, 2, -1], [1, 2, 3, -1]], np.int32),
                  {"_FillValue": -1, "start_index": 0})
    ds["v"] = (("x",), np.array([1.0, np.nan, 3.0, 4.0, 5.0]), {
        "np_int": np.int64(7),
        "np_bool": np.True_,
        "precise": 0.1234567890123456789,
        "iarr64": np.array([1, 2], np.int64),
        "text": "hello",
        "_FillValue": -9999.0,
    })
    return ds


def empty_dataset(pkg):
    ds = pkg.xdata.Dataset()
    ds["empty"] = (("x",), np.zeros((0,), np.float64))
    ds["e2"] = (("x", "y"), np.zeros((0, 3), np.int32))
    ds["v"] = (("y",), np.arange(3.0))
    return ds


CASES = {"time": time_dataset, "strings": string_dataset, "dtypes": dtype_dataset, "empty": empty_dataset}
#: Zero-length arrays are a zarr case (netCDF3 takes a zero length as
#: its one unlimited dimension).
CASE_FORMATS = [(case, fmt) for case in sorted(CASES) for fmt in FORMATS if (case, fmt) != ("empty", "nc")]


@pytest.mark.parametrize("writer, reader", PAIRS)
@pytest.mark.parametrize("case, fmt", CASE_FORMATS)
def test_roundtrip_matches_jax(tmp_path, case, writer, reader, fmt):
    path = tmp_path / f"{case}.{fmt}"
    write(CASES[case](PACKAGES[writer]), path, fmt)
    got = read(PACKAGES[reader], path, fmt)
    assert isinstance(got, PACKAGES[reader].xdata.Dataset)
    assert_same(got, read(xu, path, fmt))
    if case == "time":
        t = got["time"].values
        assert t.dtype == np.dtype("datetime64[ns]") and np.isnat(t[2])
        np.testing.assert_array_equal(t[:2], times()[:2])
        np.testing.assert_array_equal(got["dt"].values, np.array([1, 2, -5], dtype="timedelta64[s]"))
        assert np.isnat(got["lag"].values[1]) and "time" in got.coords
    elif case == "strings":
        assert list(got["names"].values) == [b"alpha", b"be", b"gamma!"] and got["names"].dims == ("x",)
        assert got["title_var"].values[()] == b"hello"
    elif case == "dtypes":
        if fmt == "nc":
            assert got["flags"].values.dtype == np.int16 and got["big"].values.dtype == np.int32
        np.testing.assert_array_equal(got["flags"].values, [0, 1, 127, 128, 255])
        assert got["conn"].values.dtype.kind == "i" and got["conn"].encoding["_FillValue"] == -1
        assert np.isnan(got["v"].values[1]) and got["v"].encoding["_FillValue"] == -9999.0
        assert abs(float(got["v"].attrs["precise"]) - 0.1234567890123456789) < 1e-15
        assert got.attrs["gattr"] == 3
    else:
        assert got["empty"].values.shape == (0,) and got["e2"].values.shape == (0, 3)


def test_decode_foreign_units_and_packing(tmp_path):
    """Files written by other tools: 'days since' units, packed integers
    with a fill value, big-endian payloads."""
    from scipy.io import netcdf_file

    path = tmp_path / "foreign.nc"
    with netcdf_file(str(path), "w") as f:
        f.createDimension("time", 3)
        v = f.createVariable("time", np.float64, ("time",))
        v[:] = np.array([0.0, 1.5, 3.0])
        v.units = "days since 2000-01-01 12:00:00"
        p = f.createVariable("packed", np.int16, ("time",))
        p[:] = np.array([10, -1, 30], np.int16)
        p._FillValue = np.int16(-1)
        p.scale_factor = 0.5
        p.add_offset = 1.0
    got, want = xt.xdata.open_dataset(path), xu.xdata.open_dataset(path, engine="scipy")
    assert_same(got, want)
    t = got["time"].values
    assert t[0] == np.datetime64("2000-01-01T12:00:00") and t[1] == np.datetime64("2000-01-03T00:00:00")
    np.testing.assert_array_equal(got["packed"].values, [6.0, np.nan, 16.0])
    for name in ("time", "packed"):
        assert got[name].data.dtype.isnative
    torch.from_numpy(got["packed"].data)  # scipy's big-endian views are normalized at read


def test_foreign_zarr_store(tmp_path):
    """Absent chunks (the fill value), string-coded NaN fills, raw chunks,
    big-endian dtypes, and F order (refused)."""
    store = tmp_path / "foreign.zarr"
    store.mkdir()
    (store / ".zgroup").write_text(json.dumps({"zarr_format": 2}))

    def array(name, meta, dims, chunks):
        d = store / name
        d.mkdir()
        (d / ".zarray").write_text(json.dumps({"zarr_format": 2, "order": "C", "filters": None, **meta}))
        (d / ".zattrs").write_text(json.dumps({"_ARRAY_DIMENSIONS": dims}))
        for key, raw in chunks.items():
            (d / key).write_bytes(raw)

    chunk = np.arange(4.0).reshape(2, 2)
    array("sparse", {"shape": [4, 4], "chunks": [2, 2], "dtype": "<f8", "compressor": {"id": "zlib", "level": 1},
                     "fill_value": "NaN"}, ["y", "x"], {"0.0": zlib.compress(chunk.tobytes())})
    array("intfill", {"shape": [3], "chunks": [2], "dtype": ">i4", "compressor": None, "fill_value": -9},
          ["x"], {"0": np.array([5, 6], ">i4").tobytes()})
    got, want = xt.xdata.open_zarr(store), xu.xdata.open_zarr(store)
    for name in ("sparse", "intfill"):
        np.testing.assert_array_equal(got[name].values, np.asarray(want[name].data))
    assert list(got["intfill"].values) == [5, 6, -9] and got["intfill"].data.dtype.isnative
    torch.from_numpy(got["intfill"].data)
    array("forder", {"shape": [2], "chunks": [2], "dtype": "<i4", "compressor": None, "fill_value": 0,
                     "order": "F"}, ["x"], {"0": np.array([1, 2], "<i4").tobytes()})
    with pytest.raises(NotImplementedError, match="order='F'"):
        xt.xdata.open_zarr(store)


@pytest.mark.parametrize("fmt", FORMATS)
def test_tensor_payload_written_through_a_host_copy(tmp_path, fmt):
    values = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    values[1, 1] = float("nan")
    ds = xt.xdata.Dataset()
    ds["v"] = xt.xdata.DataArray(values, dims=("time", "x"), coords={"time": times()}, attrs={"units": "m"})
    path = tmp_path / f"tensor.{fmt}"
    write(ds, path, fmt)
    assert isinstance(ds["v"].data, torch.Tensor)  # the written dataset keeps its tensor
    for pkg in (xt, xu):
        back = read(pkg, path, fmt)
        np.testing.assert_array_equal(np.asarray(back["v"].data), values.numpy())
        assert np.asarray(back["v"].data).dtype == np.float32
    opened = read(xt, path, fmt)["v"]
    assert isinstance(opened.data, np.ndarray)  # opening puts nothing on a device
    assert torch.equal(torch.from_numpy(opened.data).nan_to_num(-1.0), values.nan_to_num(-1.0))


def test_zarr_store_layout_matches_jax(tmp_path):
    """The same metadata files (consolidated too) as the JAX writer, and
    mode='w-' refuses to overwrite."""
    for name, pkg in PACKAGES.items():
        time_dataset(pkg).to_zarr(tmp_path / f"{name}.zarr")
    for key in (".zmetadata", ".zattrs", "v/.zarray", "v/.zattrs", "time/.zattrs"):
        got = json.loads((tmp_path / "torch.zarr" / key).read_text())
        assert got == json.loads((tmp_path / "jax.zarr" / key).read_text()), key
    with pytest.raises(FileExistsError):
        time_dataset(xt).to_zarr(tmp_path / "torch.zarr")
    time_dataset(xt).to_zarr(tmp_path / "torch.zarr", mode="w")
