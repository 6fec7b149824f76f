"""
Out-of-core variables, the port's copy of ``xugrid_tpu/xdata/lazy.py``.

``LazyArray`` is a small duck array that reads row blocks of a variable
from its file on demand:

* ``open_dataset(path, lazy=True)`` / ``open_zarr(store, lazy=True)``
  wrap each large data variable in a LazyArray; small variables
  (coordinates, topology) load eagerly, the grids need them anyway.
* Basic slicing along the leading dimension composes lazily, so
  ``uda.isel(time=slice(...))`` and the regridder's chunked apply
  stream row blocks without materializing the whole payload.
* Any other access materializes through ``__array__`` (a host numpy
  array).  A LazyArray never becomes a tensor by itself: the regridder
  copies each block it loads to its device.
* CF decoding (fill, scale, offset, time) runs on every loaded block
  (``cf_block_decoder``, the eager reader's decode too), so a lazy read
  gives the eager read's values bit for bit.

``load_log`` records the byte size of every block read, so a caller can
check that no single read took more than one chunk (``max_single_load``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

#: Variables smaller than this load eagerly (bytes).
LAZY_MIN_BYTES = 8 * 1024 * 1024


class LazyArray:
    """Duck array backed by a row-block loader.

    ``loader(start, stop)`` returns the decoded rows [start, stop) along
    dimension 0 as numpy.  Slicing dimension 0 composes lazily; anything
    else loads the covering rows and indexes them.
    """

    is_lazy = True

    def __init__(
        self,
        loader: Callable[[int, int], np.ndarray],
        shape: Tuple[int, ...],
        dtype,
        load_log: list | None = None,
    ):
        self._loader = loader
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.load_log = load_log if load_log is not None else []

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    def _load(self, start: int, stop: int) -> np.ndarray:
        block = self._loader(start, stop)
        self.load_log.append(block.nbytes)
        return block

    def __array__(self, dtype=None, copy=None):
        out = self._load(0, self.shape[0]) if self.ndim else self._load(0, 1)
        if dtype is not None:
            out = out.astype(dtype, copy=False)
        return out

    def compute(self) -> np.ndarray:
        return self.__array__()

    def __getitem__(self, key):
        n = self.shape[0] if self.ndim else 1
        if key is Ellipsis or (isinstance(key, slice) and key == slice(None)):
            return self
        first, rest = key, ()
        if isinstance(key, tuple):
            if not key:
                return self
            first, rest = key[0], key[1:]
        if isinstance(first, slice) and first.step in (None, 1):
            start, stop, _ = first.indices(n)
            stop = max(stop, start)
            if not rest or all(isinstance(r, slice) and r == slice(None) for r in rest):
                parent = self

                def loader(s, e, off=start):
                    return parent._load(off + s, off + e)

                return LazyArray(loader, (stop - start,) + self.shape[1:], self.dtype, self.load_log)
            block = self._load(start, stop)
            return block[(slice(None),) + rest]
        if isinstance(first, (int, np.integer)):
            i = int(first)
            if i < 0:
                i += n
            if not 0 <= i < n:
                raise IndexError(f"index {int(first)} is out of bounds for axis 0 with size {n}")
            block = self._load(i, i + 1)[0]
            return block[rest] if rest else block
        # Fancy, boolean or strided: materialize, then index.
        return self.__array__()[key]

    def __repr__(self):
        return f"LazyArray(shape={self.shape}, dtype={self.dtype}, loads={len(self.load_log)})"


def max_single_load(arr) -> int:
    """The largest single block read (bytes) a LazyArray recorded."""
    log = getattr(arr, "load_log", None)
    return max(log) if log else 0


def is_lazy(data) -> bool:
    return getattr(data, "is_lazy", False)


def cf_block_decoder(dims, dtype, attrs, decode_cf):
    """
    The readers' one CF decode: (attrs_out, encoding, transform,
    out_dtype), where ``transform`` decodes an array in native byte order
    (fill to NaN, the packed sentinel, scale, offset, time units).  The
    lazy readers apply it to every loaded block, the eager reader
    (``io_netcdf._decode_variable``) to the whole variable, so both give
    the same values bit for bit.

    Returns None when the variable needs a decode that changes its shape
    (CF char arrays): the lazy readers load those eagerly.
    """
    from xugrid_tpu_torch.xdata.io_netcdf import _resolve_time_units, _time_values_to_datetime64

    attrs = dict(attrs)
    encoding: dict = {}
    if dtype == np.dtype("S1") and dims and str(dims[-1]).startswith("string"):
        return None
    steps = []
    if decode_cf:
        fill = attrs.pop("_FillValue", None)
        scale = attrs.pop("scale_factor", None)
        offset = attrs.pop("add_offset", None)
        packed = scale is not None or offset is not None
        if fill is not None:
            encoding["_FillValue"] = fill
            if np.issubdtype(dtype, np.floating):
                steps.append(lambda d, f=fill: np.where(d == f, np.nan, d))
            elif packed:
                # The sentinel becomes NaN before unpacking, as in the
                # eager reader.
                steps.append(lambda d, f=fill: np.where(d == f, np.nan, d.astype(np.float64)))
        if packed:
            steps.append(lambda d: d.astype(np.float64))
            if scale is not None:
                steps.append(lambda d, s=scale: d * s)
            if offset is not None:
                steps.append(lambda d, o=offset: d + o)
        if np.issubdtype(dtype, np.number) or packed:
            resolved = _resolve_time_units(attrs.get("units"))
            if resolved is not None:
                ns, epoch = resolved
                steps.append(lambda d, ns=ns, epoch=epoch: _time_values_to_datetime64(d, ns, epoch))
                attrs.pop("units", None)
                attrs.pop("calendar", None)
                encoding["units"] = "seconds since 1970-01-01"

    def transform(block):
        for f in steps:
            block = f(block)
        return block

    probe = transform(np.zeros((0,), dtype=dtype))
    # The loaders emit native byte order (netCDF3 stores are big-endian).
    return attrs, encoding, transform, probe.dtype.newbyteorder("=")
