"""
Minimal self-contained zarr v2 directory store I/O, the port's copy of
``xugrid_tpu/xdata/io_zarr.py``.

Implements just enough of the zarr v2 spec (JSON metadata + zlib-compressed
C-order chunks, xarray's ``_ARRAY_DIMENSIONS`` convention) to round-trip
datasets without the zarr package.  When the real zarr/xarray stack is
present it reads these stores transparently.  Opening gives host numpy
arrays (with ``lazy=True``, ``LazyArray`` row loaders for the large
variables); writing copies a tensor payload to the host explicitly.
The writer stores each array as one chunk, so a lazy read of any rows of
a store it wrote decompresses the whole array.
"""

from __future__ import annotations

import itertools
import json
import zlib
from pathlib import Path

import numpy as np

from xugrid_tpu_torch.xdata.dataset import Dataset
from xugrid_tpu_torch.xdata.io_netcdf import _decode_variable, _mark_coords, annotate_cf_coordinates, encode_cf_time
from xugrid_tpu_torch.xdata.variable import Variable, to_numpy

_COMPRESSOR = {"id": "zlib", "level": 4}


def _dtype_str(dtype: np.dtype) -> str:
    return dtype.str


def to_zarr(ds: Dataset, store, mode: str = "w-", **kwargs) -> None:
    ds = annotate_cf_coordinates(encode_cf_time(ds))
    root = Path(store)
    if (root / ".zgroup").exists():
        # xarray's default mode "w-" refuses to clobber an existing
        # store; only an explicit mode="w" removes it (removal must be
        # complete — stale arrays or chunk files would reappear on open
        # with conflicting dimension sizes).
        if mode != "w":
            raise FileExistsError(
                f"zarr store already exists at {root}; "
                "pass mode='w' to overwrite"
            )
        import shutil

        shutil.rmtree(root)
    root.mkdir(parents=True, exist_ok=True)
    (root / ".zgroup").write_text(json.dumps({"zarr_format": 2}))
    (root / ".zattrs").write_text(json.dumps(_json_safe(ds.attrs)))
    for name, var in ds._variables.items():
        _write_array(root / str(name), var)
    # Consolidated metadata: xarray's open_zarr reads this by default
    # (consolidated=True) and warns or fails without it.
    consolidated = {}
    for key in (".zgroup", ".zattrs"):
        consolidated[key] = json.loads((root / key).read_text())
    for child in sorted(root.iterdir()):
        if child.is_dir():
            for key in (".zarray", ".zattrs"):
                f = child / key
                if f.exists():
                    consolidated[f"{child.name}/{key}"] = json.loads(
                        f.read_text()
                    )
    (root / ".zmetadata").write_text(
        json.dumps(
            {"zarr_consolidated_format": 1, "metadata": consolidated}
        )
    )


def _write_array(path: Path, var: Variable) -> None:
    path.mkdir(parents=True, exist_ok=True)
    data = to_numpy(var.data)
    if data.ndim:
        # NOTE: ascontiguousarray promotes 0-d arrays to 1-d, which would
        # corrupt scalar variables (e.g. the UGRID topology dummy var).
        data = np.ascontiguousarray(data)
    if data.dtype.kind == "U":
        # utf-8, not astype("S") (which is ASCII-only and raises on
        # accented text); the reader decodes bytes back as utf-8.
        data = np.char.encode(data, "utf-8")
    meta = {
        "zarr_format": 2,
        "shape": list(data.shape),
        # zarr v2 requires len(chunks) == len(shape) and every chunk
        # length >= 1 (even for zero-length dims); 0-d arrays use []
        # (zarr-python normalize_chunks semantics) with chunk key "0".
        "chunks": [max(1, s) for s in data.shape],
        "dtype": _dtype_str(data.dtype),
        "compressor": _COMPRESSOR,
        "fill_value": None,
        "order": "C",
        "filters": None,
    }
    (path / ".zarray").write_text(json.dumps(meta))
    attrs = _json_safe(dict(var.attrs))
    attrs["_ARRAY_DIMENSIONS"] = list(map(str, var.dims))
    (path / ".zattrs").write_text(json.dumps(attrs))
    if data.size:
        chunk_key = ".".join(["0"] * max(data.ndim, 1))
        (path / chunk_key).write_bytes(zlib.compress(data.tobytes(), 4))


def open_zarr(store, lazy: bool = False, **kwargs) -> Dataset:
    """Read a zarr v2 directory store into a Dataset of host numpy arrays.
    With ``lazy``, each large variable becomes a ``LazyArray`` that reads
    the chunks covering the requested rows and decodes them on demand."""
    from xugrid_tpu_torch.xdata.lazy import LAZY_MIN_BYTES, LazyArray, cf_block_decoder

    root = Path(store)
    if not (root / ".zgroup").exists():
        raise FileNotFoundError(f"not a zarr store: {store}")
    attrs = {}
    if (root / ".zattrs").exists():
        attrs = json.loads((root / ".zattrs").read_text())
    ds = Dataset(attrs=attrs)
    for child in sorted(root.iterdir()):
        if not child.is_dir() or not (child / ".zarray").exists():
            continue
        name = child.name
        meta = json.loads((child / ".zarray").read_text())
        var_attrs = {}
        dims = None
        if (child / ".zattrs").exists():
            var_attrs = json.loads((child / ".zattrs").read_text())
            dims = var_attrs.pop("_ARRAY_DIMENSIONS", None)
        shape = tuple(meta["shape"])
        dtype = np.dtype(meta["dtype"])
        chunks = tuple(meta["chunks"])
        if dims is None:
            dims = tuple(f"{name}_dim_{i}" for i in range(len(shape)))
        nbytes = int(np.prod(shape)) * dtype.itemsize
        plan = cf_block_decoder(tuple(dims), dtype, var_attrs, True) if lazy and shape and nbytes >= LAZY_MIN_BYTES else None
        if plan is not None:
            attrs_out, encoding, transform, out_dtype = plan

            def loader(start, stop, child=child, shape=shape, chunks=chunks, dtype=dtype, meta=meta, transform=transform):
                block = _read_chunks(child, shape, chunks, dtype, meta, row_range=(start, stop))
                # A foreign store may hold big-endian chunks: the loaders
                # emit native byte order, which torch takes.
                block = block.astype(block.dtype.newbyteorder("="), copy=False)
                return np.ascontiguousarray(transform(block))

            ds._variables[name] = Variable(tuple(dims), LazyArray(loader, shape, out_dtype), attrs_out, encoding)
            continue
        data = _read_chunks(child, shape, chunks, dtype, meta)
        # A foreign store may hold big-endian chunks: torch takes native
        # byte order only.
        data = data.astype(data.dtype.newbyteorder("="), copy=False)
        ds._variables[name] = _decode_variable(name, tuple(dims), data, var_attrs, decode_cf=True)
    _mark_coords(ds)
    return ds


def _read_chunks(path: Path, shape, chunks, dtype, meta, row_range=None) -> np.ndarray:
    """The array, or with ``row_range`` (start, stop) its rows [start,
    stop) along the first dimension, from the chunks that cover them (a
    chunk holding any of those rows is read and decompressed whole)."""
    compressor = meta.get("compressor")
    if meta.get("order", "C") != "C":
        # Silently reading an F-order store would transpose every chunk.
        raise NotImplementedError("zarr arrays with order='F' require the zarr package")
    if meta.get("filters"):
        raise NotImplementedError("zarr arrays with filters require the zarr package")
    if any(s == 0 for s in shape):
        # Zero-length array: no chunk files exist.
        return np.zeros(shape, dtype=dtype)
    ranged = row_range is not None and bool(shape)
    r0, r1 = row_range if ranged else (0, shape[0] if shape else 1)
    out_shape = (r1 - r0,) + tuple(shape[1:]) if ranged else shape
    fill = meta.get("fill_value")
    if fill is None:
        out = np.zeros(out_shape, dtype=dtype)
    else:
        if isinstance(fill, str) and dtype.kind == "f":
            fill = float(fill)  # "NaN" / "Infinity" spec encodings
        out = np.full(out_shape, fill, dtype=dtype)
    grid = [max(1, -(-s // max(1, c))) for s, c in zip(shape, chunks)]
    ranges = [range(g) for g in grid]
    if ranged:
        c0 = max(1, chunks[0])
        ranges[0] = range(r0 // c0, min(grid[0], -(-max(r1, r0 + 1) // c0)))
    for idx in itertools.product(*ranges) if shape else [()]:
        chunk_file = path / (".".join(map(str, idx)) if idx else "0")
        if not chunk_file.exists():
            # Absent chunk: entirely fill_value (legal sparse store).
            continue
        raw = chunk_file.read_bytes()
        if compressor and compressor.get("id") == "zlib":
            raw = zlib.decompress(raw)
        elif compressor and compressor.get("id") == "blosc":
            raise ImportError("blosc-compressed zarr requires the zarr package")
        full_chunk = np.frombuffer(raw, dtype=dtype).reshape(chunks if shape else ())
        if not shape:
            out = full_chunk.copy()
            continue
        chunk_shape = tuple(min(c, s - i * c) for i, c, s in zip(idx, chunks, shape))
        sel = [slice(0, cs) for cs in chunk_shape]
        target = [slice(i * c, i * c + cs) for i, c, cs in zip(idx, chunks, chunk_shape)]
        if ranged:
            lo = max(idx[0] * chunks[0], r0)
            hi = min(idx[0] * chunks[0] + chunk_shape[0], r1)
            if hi <= lo:
                continue
            sel[0] = slice(lo - idx[0] * chunks[0], hi - idx[0] * chunks[0])
            target[0] = slice(lo - r0, hi - r0)
        out[tuple(target)] = full_chunk[tuple(sel)]
    return out


def _json_safe(obj):
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.bytes_):
        return obj.decode("utf-8", errors="replace")
    if isinstance(obj, np.str_):
        return str(obj)
    if isinstance(obj, np.ndarray):
        return _json_safe(obj.tolist())
    return obj
