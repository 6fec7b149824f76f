"""
The port's out-of-core path (``xugrid_tpu_torch.xdata.lazy``, the lazy
netCDF and zarr readers, the streamed regrid) held on the CPU against the
JAX package's, case by case after ``tests/test_lazy.py``: the same files,
written from a numpy seed, opened lazily by both packages.

- ``LazyArray`` slicing composes lazily and reads only the requested rows;
  anything else materializes.
- Each loaded block is CF-decoded as the eager reader decodes the whole
  variable (a float ``_FillValue``, an int16 packed with
  ``scale_factor``/``add_offset``/``_FillValue``, time units): bit-equal to
  the eager read and to the JAX package's lazy read.
- ``isel`` of the leading dim stays lazy, through the UGRID wrappers too.
- A regrid with ``APPLY_CHUNK_BYTES`` and ``LAZY_MIN_BYTES`` patched small
  streams in several blocks, no block over half the data: bit-equal to the
  port's eager regrid, and to the JAX package's streamed one at rtol 1e-6
  (float32) or 1e-12 (float64).
- A zarr store chunked along time (a partial last chunk, with and without
  chunks along the faces): each lazy block opens only the chunk files that
  hold its rows, as the JAX package's lazy read does.
"""

import itertools
import json
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import xugrid_tpu as xu
import xugrid_tpu.xdata.lazy as jax_lazy
import xugrid_tpu_torch as xt
import xugrid_tpu_torch.xdata.lazy as torch_lazy
from xugrid_tpu_torch.regrid import regridder as torch_regridder
from xugrid_tpu_torch.regrid.aligned_apply import window_reduce
from xugrid_tpu_torch.regrid.select_apply import window_select
from xugrid_tpu_torch.xdata.lazy import LazyArray, is_lazy, max_single_load

N_TIME = 40


@pytest.fixture
def small_lazy(monkeypatch):
    """Both packages open variables of 1 KiB and more lazily."""
    monkeypatch.setattr(jax_lazy, "LAZY_MIN_BYTES", 1024)
    monkeypatch.setattr(torch_lazy, "LAZY_MIN_BYTES", 1024)


def make_mesh(pkg, nx=8, scale=1.0):
    xs, ys = np.meshgrid(np.arange(nx + 1.0) * scale, np.arange(nx + 1.0) * scale)
    nid = lambda i, j: j * (nx + 1) + i  # noqa: E731
    i, j = np.meshgrid(np.arange(nx), np.arange(nx), indexing="xy")
    faces = np.stack([nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)], -1).reshape(-1, 4)
    return pkg.Ugrid2d(xs.ravel(), ys.ravel(), -1, faces)


def payload(kind, n_time, n_face, seed=7):
    """(stored values, their decoded values, variable attrs) of one case:
    float32 or float64 with 10 % NaN, an int16 packed with a scale, an
    offset and a fill sentinel, or a float with a ``_FillValue``."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n_time, n_face))
    gaps = rng.random(data.shape) < 0.10
    if kind in ("float32", "float64"):
        data = data.astype(kind)
        data[gaps] = np.nan
        return data, data, {}
    if kind == "packed":
        scale, offset, fill = 0.01, 5.0, np.int16(-32767)
        packed = np.round(data / scale).astype(np.int16)
        packed[gaps] = fill
        decoded = np.where(gaps, np.nan, packed.astype(np.float64) * scale + offset)
        return packed, decoded, {"scale_factor": scale, "add_offset": offset, "_FillValue": fill}
    if kind == "float_fill":
        fill = np.float32(-999.0)
        stored = data.astype(np.float32)
        stored[gaps] = fill
        return stored, np.where(gaps, np.float32(np.nan), stored), {"_FillValue": fill}
    raise ValueError(kind)


def write_file(tmp_path, kind, fmt, n_time=N_TIME, nx=8):
    """A UGRID file of ``nx`` x ``nx`` faces with a (time, face) variable
    ``depth`` of ``kind``, written by the port; (path, decoded values)."""
    grid = make_mesh(xt, nx)
    stored, decoded, attrs = payload(kind, n_time, grid.n_face)
    da = xt.xdata.DataArray(
        stored, dims=("time", grid.face_dimension), name="depth", attrs=attrs,
        coords={"time": np.arange(n_time)},
    )
    ds = xt.UgridDataArray(da, grid).ugrid.to_dataset()
    path = tmp_path / f"{kind}.{fmt}"
    (ds.to_netcdf if fmt == "nc" else ds.to_zarr)(path)
    return path, decoded


def open_with(pkg, path, lazy, wrapped=False):
    if wrapped:
        return pkg.open_dataset(path, lazy=lazy) if path.suffix == ".nc" else pkg.open_zarr(path, lazy=lazy)
    if path.suffix == ".nc":
        return pkg.xdata.open_dataset(path, engine="scipy", lazy=lazy)
    return pkg.xdata.open_zarr(path, lazy=lazy)


class TestLazyArray:
    def test_slicing_composition(self):
        base = np.arange(600.0).reshape(30, 20)
        logs = {}
        arrays = {}
        for name, mod in (("jax", jax_lazy), ("torch", torch_lazy)):
            logs[name] = []
            arrays[name] = mod.LazyArray(lambda s, e: base[s:e], base.shape, base.dtype, logs[name])
        arr = arrays["torch"]
        sub = arr[5:25]
        assert is_lazy(sub) and sub.shape == (20, 20)
        sub2 = sub[2:10]
        np.testing.assert_array_equal(np.asarray(sub2), base[7:15])
        # Only the requested rows were read.
        assert max(logs["torch"]) == base[7:15].nbytes
        np.testing.assert_array_equal(arr[3], base[3])
        np.testing.assert_array_equal(arr[-1], base[-1])
        np.testing.assert_array_equal(np.asarray(arr[4:8, 2:5]), base[4:8, 2:5])
        np.testing.assert_array_equal(arr[[1, 3]], base[[1, 3]])
        assert arr[...] is arr and arr[:] is arr
        with pytest.raises(IndexError):
            arr[30]
        # The JAX package's LazyArray logs the same reads.
        ref = arrays["jax"]
        np.asarray(ref[5:25][2:10])
        ref[3], ref[-1], ref[4:8, 2:5], ref[[1, 3]]
        assert logs["torch"] == logs["jax"]

    def test_materialize_matches(self):
        base = np.arange(24.0).reshape(6, 4)
        arr = LazyArray(lambda s, e: base[s:e], base.shape, base.dtype)
        np.testing.assert_array_equal(np.asarray(arr), base)
        np.testing.assert_array_equal(arr.compute(), base)
        assert np.asarray(arr, dtype=np.float32).dtype == np.float32
        assert (arr.ndim, arr.size, arr.nbytes) == (2, 24, 192)
        assert max_single_load(arr) == base.nbytes and max_single_load(base) == 0

    def test_variable_passes_lazy_through(self):
        base = np.arange(24.0).reshape(6, 4)
        arr = LazyArray(lambda s, e: base[s:e], base.shape, base.dtype)
        da = xt.xdata.DataArray(arr, dims=("time", "x"), name="v")
        assert da.data is arr and da.variable.copy().data is arr
        assert da.shape == (6, 4) and da.dtype == np.float64
        for method in ("compute", "load", "chunk", "persist"):
            assert getattr(da, method)() is da
        ds = da.to_dataset()
        for method in ("compute", "load", "chunk", "unify_chunks"):
            assert getattr(ds, method)() is ds
        assert is_lazy(da.isel(time=slice(1, 4)).data)
        assert is_lazy(da.transpose("time", "x").data)
        assert arr.load_log == []
        np.testing.assert_array_equal(da.values, base)
        np.testing.assert_array_equal(da.isel(x=[0, 2]).values, base[:, [0, 2]])


@pytest.mark.parametrize("fmt", ["nc", "zarr"])
@pytest.mark.parametrize("kind", ["float32", "float64", "packed", "float_fill"])
def test_open_lazy_matches_eager(tmp_path, small_lazy, kind, fmt):
    """A lazy open gives LazyArrays whose values, dtypes, attrs and
    encodings are the eager open's and the JAX package's lazy open's."""
    path, decoded = write_file(tmp_path, kind, fmt)
    eager = open_with(xt, path, lazy=False)
    lazy = open_with(xt, path, lazy=True)
    ref = open_with(xu, path, lazy=True)
    assert is_lazy(lazy["depth"].data) and is_lazy(ref["depth"].data)
    assert sorted(lazy._variables) == sorted(eager._variables) == sorted(ref._variables)
    assert lazy._coord_names == eager._coord_names
    for name, var in eager._variables.items():
        got = lazy._variables[name]
        assert got.dims == var.dims and got.attrs.keys() == var.attrs.keys(), name
        assert got.encoding.keys() == var.encoding.keys(), name
        assert got.dtype == var.dtype == ref._variables[name].dtype, name
        np.testing.assert_array_equal(got.values, var.values, err_msg=name)
        np.testing.assert_array_equal(got.values, np.asarray(ref._variables[name].data), err_msg=name)
    np.testing.assert_array_equal(lazy["depth"].values, decoded)
    block = lazy["depth"].data[3:7]
    values = np.asarray(block)
    assert values.dtype.isnative and values.flags.c_contiguous
    torch.from_numpy(values)  # takes the block without a copy
    np.testing.assert_array_equal(values, np.asarray(ref["depth"].data[3:7]))


def test_cf_time_units_decode_per_block(tmp_path, small_lazy):
    """A large numeric variable with CF time units (datetime and
    timedelta, NaN as NaT) decodes per block as the eager reader does."""
    n = 400
    seconds = np.arange(n * 4, dtype=np.float64).reshape(n, 4) * 3600.0
    seconds[5, 1] = np.nan
    ds = xt.xdata.Dataset()
    ds["stamp"] = (("row", "col"), seconds, {"units": "seconds since 2000-01-01", "calendar": "standard"})
    ds["age"] = (("row", "col"), seconds / 86400.0, {"units": "days"})
    for fmt in ("nc", "zarr"):
        path = tmp_path / f"t.{fmt}"
        (ds.to_netcdf if fmt == "nc" else ds.to_zarr)(path)
        eager, lazy, ref = (open_with(p, path, lz) for p, lz in ((xt, False), (xt, True), (xu, True)))
        for name, kind in (("stamp", "M"), ("age", "m")):
            assert is_lazy(lazy[name].data)
            assert lazy[name].dtype.kind == kind and lazy[name].attrs == eager[name].attrs
            assert lazy[name].encoding == eager[name].encoding == ref[name].encoding
            np.testing.assert_array_equal(np.asarray(lazy[name].data[2:9]), eager[name].values[2:9])
            np.testing.assert_array_equal(np.asarray(lazy[name].data[2:9]), np.asarray(ref[name].data[2:9]))
        assert np.isnat(lazy["stamp"].values[5, 1])


@pytest.mark.parametrize("fmt", ["nc", "zarr"])
def test_isel_stays_lazy(tmp_path, small_lazy, fmt):
    path, decoded = write_file(tmp_path, "float64", fmt)
    lazy = open_with(xt, path, lazy=True)
    sub = lazy["depth"].isel(time=slice(10, 20))
    assert is_lazy(sub.data)
    assert lazy["depth"].data.load_log == []
    np.testing.assert_array_equal(np.asarray(sub.data), decoded[10:20])
    np.testing.assert_array_equal(sub["time"].values, np.arange(10, 20))
    # Through the UGRID wrappers: uda.isel(time=slice(...)) composes lazily.
    uds = open_with(xt, path, lazy=True, wrapped=True)
    uda = uds["depth"]
    assert isinstance(uda, xt.UgridDataArray) and is_lazy(uda.obj.data)
    part = uda.isel(time=slice(0, 24))
    assert isinstance(part, xt.UgridDataArray) and is_lazy(part.obj.data)
    assert part.obj.data.load_log == []
    np.testing.assert_array_equal(part.values, decoded[:24])
    # One read of the 24 rows, logged by the slice and by the file's array.
    assert part.obj.data.load_log == [decoded[:24].nbytes] * 2
    ref = open_with(xu, path, lazy=True, wrapped=True)["depth"].isel(time=slice(0, 24))
    np.testing.assert_array_equal(part.values, np.asarray(ref.obj.data))


@pytest.mark.parametrize("method", ["mean", "median"])
@pytest.mark.parametrize("fmt", ["nc", "zarr"])
@pytest.mark.parametrize("kind", ["float32", "float64", "packed"])
def test_chunked_regrid_streams(tmp_path, small_lazy, monkeypatch, kind, fmt, method):
    """Open lazily and regrid with an apply budget far below the data:
    several blocks are read, none over half the data, one kernel launch
    per block; the result is the eager regrid's bit for bit and the JAX
    package's streamed regrid's within rtol 1e-6 (float32) or 1e-12."""
    n_time = 64
    path, decoded = write_file(tmp_path, kind, fmt, n_time=n_time, nx=10)
    eager = xt.open_dataset(path) if fmt == "nc" else xt.open_zarr(path)
    lazy = xt.open_dataset(path, lazy=True) if fmt == "nc" else xt.open_zarr(path, lazy=True)
    grid = lazy.grids[0]
    regridder = xt.OverlapRegridder(grid, make_mesh(xt, 5, scale=2.0), method=method)
    want = regridder.regrid(eager["depth"], device="cpu")

    lazy_da = lazy["depth"]
    assert is_lazy(lazy_da.obj.data)
    full_bytes = decoded.nbytes
    # A budget of about eight rows of source and target.
    monkeypatch.setattr(torch_regridder, "APPLY_CHUNK_BYTES", full_bytes // 8)
    kernel = window_reduce if method == "mean" else window_select
    before = kernel.launches
    got = regridder.regrid(lazy_da, device="cpu")
    assert kernel.launches == before  # the plain versions on the CPU launch nothing
    assert isinstance(got, xt.UgridDataArray) and isinstance(got.obj.data, torch.Tensor)
    assert got.obj.data.dtype == want.obj.data.dtype
    assert torch.equal(got.obj.data, want.obj.data)
    log = lazy_da.obj.data.load_log
    assert 0 < max_single_load(lazy_da.obj.data) < full_bytes / 2
    assert sum(log) >= full_bytes and len(log) > 2
    np.testing.assert_array_equal(got["time"].values, np.arange(n_time))

    monkeypatch.setenv("XUGRID_TPU_APPLY_CHUNK_BYTES", str(full_bytes // 8))
    ref_uds = xu.open_dataset(path, lazy=True) if fmt == "nc" else xu.open_zarr(path, lazy=True)
    ref_regridder = xu.OverlapRegridder(ref_uds.grids[0], make_mesh(xu, 5, scale=2.0), method=method)
    ref = np.asarray(ref_regridder.regrid(ref_uds["depth"]).values)
    assert jax_lazy.max_single_load(ref_uds["depth"].obj.data) < full_bytes / 2
    rtol = 1e-6 if kind == "float32" else 1e-12
    np.testing.assert_allclose(got.values, ref, rtol=rtol, atol=rtol * np.nanmax(np.abs(decoded)))


def test_regrid_chunk_rows_follow_decoded_itemsize(tmp_path, small_lazy, monkeypatch):
    """The budget counts the decoded itemsize (at least 4 bytes): a packed
    int16 variable decodes to float64 and streams in blocks of half the
    rows of a float32 one's."""
    target = make_mesh(xt, 5, scale=2.0)
    rows = {}
    for kind in ("float32", "packed"):
        path, _ = write_file(tmp_path, kind, "nc", n_time=48, nx=10)
        uda = xt.open_dataset(path, lazy=True)["depth"]
        n_face = uda.grid.n_face
        monkeypatch.setattr(torch_regridder, "APPLY_CHUNK_BYTES", 6 * 4 * (n_face + target.n_face))
        xt.OverlapRegridder(uda.grid, target).regrid(uda, device="cpu")
        data = uda.obj.data
        rows[kind] = max(data.load_log) // (data.dtype.itemsize * n_face)
    assert rows == {"float32": 6, "packed": 3}


def test_lazy_regrid_of_a_bare_lazy_array(small_lazy):
    """A LazyArray handed to regrid as it is streams the same way; one
    without a leading dim (the grid's own axis only) is materialized; an
    empty extra dim gives an empty result."""
    grid = make_mesh(xt, 10)
    target = make_mesh(xt, 5, scale=2.0)
    regridder = xt.OverlapRegridder(grid, target, method="mean")
    values = np.random.default_rng(3).normal(size=(12, grid.n_face))
    arr = LazyArray(lambda s, e: values[s:e], values.shape, values.dtype)
    want = regridder.regrid(torch.from_numpy(values), device="cpu")
    assert torch.equal(regridder.regrid(arr, device="cpu"), want)
    one = LazyArray(lambda s, e: values[0, s:e], values.shape[1:], values.dtype)
    assert torch.equal(regridder.regrid(one, device="cpu"), want[0])
    empty = LazyArray(lambda s, e: values[s:e][:0], (0, grid.n_face), values.dtype)
    assert tuple(regridder.regrid(empty, device="cpu").shape) == (0, target.n_face)
    hollow = np.zeros((3, 0, grid.n_face))
    no_extra = LazyArray(lambda s, e: hollow[s:e], hollow.shape, hollow.dtype)
    assert tuple(regridder.regrid(no_extra, device="cpu").shape) == (3, 0, target.n_face)


def rechunk_zarr(var_path, chunks):
    """Rewrite one array of a zarr store written by the port (a single
    zlib chunk) into ``chunks``: chunk files "i.j", edge chunks padded to
    the full chunk shape as zarr writes them, the consolidated metadata
    kept in step."""
    meta = json.loads((var_path / ".zarray").read_text())
    dtype, shape = np.dtype(meta["dtype"]), tuple(meta["shape"])
    key = ".".join(["0"] * len(shape))
    data = np.frombuffer(zlib.decompress((var_path / key).read_bytes()), dtype=dtype).reshape(shape)
    (var_path / key).unlink()
    meta["chunks"] = list(chunks)
    (var_path / ".zarray").write_text(json.dumps(meta))
    consolidated = var_path.parent / ".zmetadata"
    if consolidated.exists():
        store_meta = json.loads(consolidated.read_text())
        store_meta["metadata"][f"{var_path.name}/.zarray"] = meta
        consolidated.write_text(json.dumps(store_meta))
    grid = [-(-n // c) for n, c in zip(shape, chunks)]
    for idx in itertools.product(*map(range, grid)):
        part = data[tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, chunks))]
        block = np.zeros(chunks, dtype=dtype)
        block[tuple(slice(0, k) for k in part.shape)] = part
        (var_path / ".".join(map(str, idx))).write_bytes(zlib.compress(block.tobytes(), 4))
    return grid


@pytest.fixture
def chunk_files_opened(monkeypatch):
    """The names of the ``depth`` chunk files read, in order."""
    opened = []
    read_bytes = Path.read_bytes

    def recording(self):
        if self.parent.name == "depth" and not self.name.startswith("."):
            opened.append(self.name)
        return read_bytes(self)

    monkeypatch.setattr(Path, "read_bytes", recording)
    return opened


@pytest.mark.parametrize("chunks", [(7, None), (7, 30), (1, None)])
@pytest.mark.parametrize("kind", ["float32", "packed"])
def test_lazy_zarr_block_reads_only_its_chunks(tmp_path, small_lazy, chunk_files_opened, kind, chunks):
    """A store chunked along time (40 rows in chunks of 7: the last holds
    5), also along the faces: each lazy block opens the chunk files that
    hold its rows and no other, and decodes to the eager read's values and
    the JAX package's lazy read's, bit for bit."""
    path, decoded = write_file(tmp_path, kind, "zarr")
    n_face = decoded.shape[1]
    rows_per_chunk, faces_per_chunk = chunks[0], chunks[1] or n_face
    grid = rechunk_zarr(path / "depth", (rows_per_chunk, faces_per_chunk))
    lazy, ref, eager = open_with(xt, path, True), open_with(xu, path, True), open_with(xt, path, False)
    assert is_lazy(lazy["depth"].data) and is_lazy(ref["depth"].data)
    np.testing.assert_array_equal(eager["depth"].values, decoded)
    for start, stop in ((0, N_TIME), (3, 11), (7, 14), (13, 14), (35, N_TIME), (30, 38)):
        del chunk_files_opened[:]
        block = np.asarray(lazy["depth"].data[start:stop])
        want = [f"{i}.{j}" for i in range(start // rows_per_chunk, -(-stop // rows_per_chunk)) for j in range(grid[1])]
        assert chunk_files_opened == want, (start, stop)
        np.testing.assert_array_equal(block, decoded[start:stop])
        del chunk_files_opened[:]
        np.testing.assert_array_equal(block, np.asarray(ref["depth"].data[start:stop]))
        assert chunk_files_opened == want, (start, stop)


@pytest.mark.parametrize("method", ["mean", "median"])
def test_chunked_zarr_regrid_streams(tmp_path, small_lazy, monkeypatch, chunk_files_opened, method):
    """A regrid of a store chunked along time streams block by block: each
    block opens only the chunks holding its rows (a chunk split between
    two blocks is opened by both), and the result is the eager regrid's
    bit for bit and the JAX package's streamed one's within rtol 1e-6."""
    n_time = 64
    path, decoded = write_file(tmp_path, "float32", "zarr", n_time=n_time, nx=10)
    rechunk_zarr(path / "depth", (5, decoded.shape[1]))
    want = xt.open_zarr(path)["depth"]
    lazy_da = xt.open_zarr(path, lazy=True)["depth"]
    target = make_mesh(xt, 5, scale=2.0)
    regridder = xt.OverlapRegridder(lazy_da.grid, target, method=method)
    # Blocks of 8 rows: chunks 1, 3, 4, 6, 8, 9 and 11 straddle two blocks.
    monkeypatch.setattr(torch_regridder, "APPLY_CHUNK_BYTES", 8 * 4 * (decoded.shape[1] + target.n_face))
    del chunk_files_opened[:]
    got = regridder.regrid(lazy_da, device="cpu")
    blocks = [(start, min(start + 8, n_time)) for start in range(0, n_time, 8)]
    assert chunk_files_opened == [f"{i}.0" for a, b in blocks for i in range(a // 5, -(-b // 5))]
    # Each block logged twice: by the regridder's view and by the file's array.
    assert lazy_da.obj.data.load_log == [8 * decoded.shape[1] * 4] * (2 * len(blocks))
    assert torch.equal(got.obj.data, regridder.regrid(want, device="cpu").obj.data)
    monkeypatch.setenv("XUGRID_TPU_APPLY_CHUNK_BYTES", str(8 * 4 * (decoded.shape[1] + target.n_face)))
    ref_da = xu.open_zarr(path, lazy=True)["depth"]
    ref = np.asarray(xu.OverlapRegridder(ref_da.grid, make_mesh(xu, 5, scale=2.0), method=method).regrid(ref_da).values)
    np.testing.assert_allclose(got.values, ref, rtol=1e-6, atol=1e-6 * np.nanmax(np.abs(decoded)))
