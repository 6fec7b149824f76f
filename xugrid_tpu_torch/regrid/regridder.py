"""
Regridders between the faces of 2D meshes and rasters: by area of
overlap (``OverlapRegridder``, ``RelativeOverlapRegridder``), by the
cell holding each target centroid (``CentroidLocatorRegridder``), and by
barycentric interpolation (``BarycentricInterpolator``: in the source's
centroidal voronoi tessellation, or bilinear between raster cells).

A source or target is a ``Ugrid2d``, a ``UgridDataArray`` /
``UgridDataset`` over one (unstructured), or an xdata ``DataArray`` /
``Dataset`` with ``x`` and ``y`` coordinates (structured).  The weights
are built on the host (structured joins, grid hash and native geometry
kernels) as a CSR matrix, padded to ``PaddedCSR`` and uploaded once per
(dtype, device).  ``regrid`` applies them to a UgridDataArray or a
DataArray, returning a UgridDataArray (unstructured target) or a
DataArray with the raster's coordinates (structured target), or to a
bare tensor or array whose trailing axes are the source grid's.  The
centroid locator keeps its weights as COO triplets and applies them as
a row gather.

``to_dataset`` stores the weights (``__regrid_*``) with the source and
target grids (``__source_*``, ``__target_*``), under the names
``xugrid_tpu`` uses, so that either package reloads the other's file
with ``from_dataset``.
"""

from __future__ import annotations

import abc
from typing import Callable, Optional, Tuple, Union

import numpy as np
import pandas as pd
import torch

from xugrid_tpu_torch import xdata
from xugrid_tpu_torch.constants import IntDType
from xugrid_tpu_torch.core.sparse import MatrixCOO, MatrixCSR, PaddedCSR
from xugrid_tpu_torch.core.wrap import UgridDataArray, UgridDataset
from xugrid_tpu_torch.regrid import reduce
from xugrid_tpu_torch.regrid.apply import apply_coo_gather, apply_weights, result_dtype
from xugrid_tpu_torch.regrid.structured import StructuredGrid2d
from xugrid_tpu_torch.regrid.unstructured import Network1d, UnstructuredGrid2d
from xugrid_tpu_torch.ugrid.ugrid1d import Ugrid1d
from xugrid_tpu_torch.ugrid.ugrid2d import Ugrid2d
from xugrid_tpu_torch.utils.device import resolve_device
from xugrid_tpu_torch.utils.profiling import count, span, timed
from xugrid_tpu_torch.xdata.lazy import is_lazy

#: Working-set budget per apply chunk (bytes of source plus target):
#: stacks of extra slices larger than this are applied in slabs.
APPLY_CHUNK_BYTES = 2_000_000_000


def setup_grid(obj, **kwargs):
    """The regridding adapter of a source or target: a raster has ``x``
    and ``y`` coordinates, or those named by ``name_x`` and ``name_y``."""
    if isinstance(obj, (UnstructuredGrid2d, StructuredGrid2d)):
        return obj
    if isinstance(obj, (Ugrid2d, UgridDataArray, UgridDataset)):
        return UnstructuredGrid2d(obj)
    if isinstance(obj, (xdata.DataArray, xdata.Dataset)):
        return StructuredGrid2d(obj, name_x=kwargs.get("name_x", "x"), name_y=kwargs.get("name_y", "y"))
    raise TypeError(
        "Expected Ugrid2d, UgridDataArray, UgridDataset, DataArray, or "
        f"Dataset; received: {type(obj).__name__}"
    )


def convert_to_match(source, target):
    """Both grids structured, or both unstructured (a raster becomes the
    Ugrid2d of its cells)."""
    PROMOTIONS = {
        frozenset({StructuredGrid2d}): StructuredGrid2d,
        frozenset({StructuredGrid2d, UnstructuredGrid2d}): UnstructuredGrid2d,
        frozenset({UnstructuredGrid2d}): UnstructuredGrid2d,
    }
    matched_type = PROMOTIONS[frozenset({type(source), type(target)})]
    return source.convert_to(matched_type), target.convert_to(matched_type)


class BaseRegridder(abc.ABC):
    _METHODS = {}
    #: The method of a regridder made from weights without one.
    _DEFAULT_METHOD = "mean"
    #: The matrix type the ``weights`` setter takes.
    _WEIGHTS_TYPE = MatrixCSR

    def __init__(self, source, target, tolerance: Optional[float] = None):
        self._source = setup_grid(source)
        self._target = setup_grid(target)
        self._set_weights(self._compute_weights(self._source, self._target, tolerance))

    @abc.abstractmethod
    def _compute_weights(self, source, target, tolerance=None) -> MatrixCSR:
        ...

    def _set_weights(self, weights) -> None:
        with timed("regridder.padded_csr"):
            if isinstance(weights, MatrixCOO):
                weights = weights.to_csr()
            self._weights = weights
            self._padded = PaddedCSR.from_csr(weights)
        # (dtype, device) -> (indices, weights) tensors on that device.
        self._device_weights = {}

    @property
    def weights(self) -> xdata.Dataset:
        """The weights and both grids as a dataset (``to_dataset``), which
        ``from_weights`` takes."""
        return self.to_dataset()

    @weights.setter
    def weights(self, weights) -> None:
        """Replace the weight matrix (this class's ``_WEIGHTS_TYPE``); the
        cached layouts are rebuilt from it."""
        if not isinstance(weights, self._WEIGHTS_TYPE):
            raise TypeError(f"Expected {self._WEIGHTS_TYPE.__name__}, received: {type(weights).__name__}")
        self._set_weights(weights)

    def _setup_regrid(self, func) -> None:
        if isinstance(func, str):
            try:
                self._reduction = self._METHODS[func]
            except KeyError as e:
                raise ValueError(
                    "Invalid regridding method. Available methods are: "
                    f"{list(self._METHODS.keys())}"
                ) from e
        elif callable(func):
            # Custom reduction: a torch function over the trailing window
            # axis f(values (..., w), weights (..., w)) -> (...).
            self._reduction = func
        else:
            raise TypeError(
                f"method must be string or callable, received: {type(func).__name__}"
            )

    @classmethod
    def from_csr_arrays(cls, data, indices, indptr, n: int, m: int, target, method=None):
        """A regridder applying given CSR weights (n targets by m source
        entities), e.g. those a ``xugrid_tpu`` regridder built; ``method``
        None is the class's default."""
        return cls._from_weights(MatrixCSR(data, indices, indptr, int(n), int(m), len(data)), target, method)

    @classmethod
    def from_coo_arrays(cls, data, row, col, n: int, m: int, target, method=None):
        """A regridder applying given COO weight triplets (row: target,
        col: source), e.g. a ``xugrid_tpu`` CentroidLocatorRegridder's."""
        return cls._from_weights(MatrixCOO.from_triplet(row, col, data, n, m), target, method)

    @staticmethod
    def _target_grid(target):
        return setup_grid(target)

    @classmethod
    def _from_weights(cls, weights, target, method, source=None):
        instance = cls.__new__(cls)
        instance._source = source
        instance._target = cls._target_grid(target)
        if instance._target.size != weights.n:
            raise ValueError(f"target has {instance._target.size} faces, weights have {weights.n} rows")
        if source is not None and source.size != weights.m:
            raise ValueError(f"source has {source.size} faces, weights have {weights.m} columns")
        instance._set_weights(weights)
        instance._setup_regrid(cls._DEFAULT_METHOD if method is None else method)
        return instance

    # -- serialization ---------------------------------------------------------
    def to_dataset(self) -> xdata.Dataset:
        """The weights (``__regrid_{field}`` for each field of the CSR or
        COO matrix), the source grid (``__source_*``) and the target grid
        (``__target_*``), for reuse through ``from_dataset``."""
        if self._source is None:
            raise ValueError("a regridder made from weight arrays knows no source grid to store")
        w = self._weights
        ds = xdata.Dataset()
        for field, value in zip(w._fields, w):
            value = np.asarray(value)
            if value.ndim == 0:
                ds[f"__regrid_{field}"] = ((), value)
            else:
                ds[f"__regrid_{field}"] = ((f"__regrid_{field}",), value)
        ds = ds.merge(self._source.to_dataset("__source"), compat="override")
        return ds.merge(self._target.to_dataset("__target"), compat="override")

    def weights_as_dataframe(self) -> pd.DataFrame:
        """The weights as a (target_index, source_index, weight) frame."""
        matrix = self._weights
        if isinstance(matrix, MatrixCSR):
            matrix = matrix.to_coo()
        return pd.DataFrame({"target_index": matrix.row, "source_index": matrix.col, "weight": matrix.data})

    @staticmethod
    def _csr_from_dataset(dataset) -> MatrixCSR:
        """The CSR weights of a stored dataset, with the index dtypes of
        ``core/sparse.py`` (netCDF3 stores the indices as int32)."""
        return MatrixCSR(
            np.asarray(dataset["__regrid_data"].data, dtype=np.float64),
            np.asarray(dataset["__regrid_indices"].data, dtype=IntDType),
            np.asarray(dataset["__regrid_indptr"].data, dtype=IntDType),
            int(dataset["__regrid_n"].data),
            int(dataset["__regrid_m"].data),
            int(dataset["__regrid_nnz"].data),
        )

    @staticmethod
    def _coo_from_dataset(dataset) -> MatrixCOO:
        """The COO weights of a stored dataset, with ``core/sparse.py``'s
        index dtypes."""
        return MatrixCOO(
            np.asarray(dataset["__regrid_data"].data, dtype=np.float64),
            np.asarray(dataset["__regrid_row"].data, dtype=IntDType),
            np.asarray(dataset["__regrid_col"].data, dtype=IntDType),
            int(dataset["__regrid_n"].data),
            int(dataset["__regrid_m"].data),
            int(dataset["__regrid_nnz"].data),
        )

    @classmethod
    def _weights_from_dataset(cls, dataset):
        return cls._csr_from_dataset(dataset)

    @staticmethod
    def _structured_from_dataset(dataset, prefix: str) -> StructuredGrid2d:
        """The structured grid stored under ``{prefix}_*`` names, with the
        user-facing coordinate names restored."""
        attrs = dataset[prefix + "_type"].attrs
        nx = attrs.get("name_x", "x")
        ny = attrs.get("name_y", "y")
        grid = StructuredGrid2d(dataset, name_x=f"{prefix}_{nx}", name_y=f"{prefix}_{ny}")
        grid.xbounds.name, grid.xbounds.dname = nx, f"d{nx}"
        grid.ybounds.name, grid.ybounds.dname = ny, f"d{ny}"
        return grid

    @classmethod
    def _grid_from_dataset(cls, dataset, prefix: str):
        """The regridding adapter stored under ``{prefix}_*`` names."""
        kind = dataset[prefix + "_type"].attrs["type"]
        if kind == "UnstructuredGrid2d":
            return UnstructuredGrid2d(Ugrid2d.from_dataset(dataset, prefix))
        if kind == "StructuredGrid2d":
            return cls._structured_from_dataset(dataset, prefix)
        if kind == "Network1d":
            return Network1d(Ugrid1d.from_dataset(dataset, prefix))
        raise ValueError(f"unknown stored grid type: {kind}")

    @classmethod
    def from_weights(cls, weights, target, method=None):
        """A regridder from a stored weights dataset (``to_dataset``) onto
        ``target``, its source grid rebuilt from the dataset; ``method``
        None is the class's default."""
        return cls._from_weights(
            cls._weights_from_dataset(weights), target, method, source=cls._grid_from_dataset(weights, "__source")
        )

    @classmethod
    def from_dataset(cls, dataset, method=None):
        """A regridder from a stored weights dataset, source and target
        grids rebuilt from it (either target kind)."""
        return cls.from_weights(dataset, cls._grid_from_dataset(dataset, "__target"), method)

    def _source_ndim(self) -> int:
        return 1 if self._source is None else self._source.ndim

    def _slices_per_chunk(self, itemsize: int) -> int:
        """How many extra slices of ``itemsize`` bytes, source plus
        target, fit ``APPLY_CHUNK_BYTES`` (at least one): the slab of
        ``_apply`` and, divided by the slices per row, the row block of
        ``_regrid_lazy``."""
        return max(APPLY_CHUNK_BYTES // (itemsize * (self._weights.m + self._weights.n)), 1)

    def _apply(self, source2d: torch.Tensor) -> torch.Tensor:
        """The weights applied to an (E, m) source: (E, n).  A stack of
        more than one slab (``_slices_per_chunk``) streams through in
        slabs, each slab written in place: the (E, n) result is
        allocated once, of the dtype ``apply_weights`` gives
        (``result_dtype``), and slab i's kernel writes its contiguous
        rows ``out[i : i + rows]``; while spans are recorded each such
        slab counts ``apply.slabs_in_place``.  A single slab takes the
        kernel's own output."""
        n = self._weights.n
        # Bound the device working set: stacks larger than the budget
        # stream through in slabs of extra slices.
        with span("regrid.apply"):
            E = source2d.shape[0]
            rows = self._slices_per_chunk(source2d.element_size())
            if E <= rows:
                return apply_weights(self._padded, source2d, self._reduction, n, plan_cache=self._device_weights)
            out = torch.empty((E, n), dtype=result_dtype(source2d.dtype), device=source2d.device)
            for i in range(0, E, rows):
                apply_weights(
                    self._padded, source2d[i : i + rows], self._reduction, n,
                    plan_cache=self._device_weights, out=out[i : i + rows],
                )
                count("apply.slabs_in_place", 1)
            return out

    def _regrid_array(self, source, device=None) -> torch.Tensor:
        if is_lazy(source):
            return self._regrid_lazy(source, device)
        if isinstance(source, np.ndarray):
            source = np.ascontiguousarray(source)  # torch takes no negative strides
        source = torch.as_tensor(source).to(resolve_device(source, device))
        first_dims_shape = tuple(source.shape[: source.ndim - self._source_ndim()])
        target_shape = tuple(self._target.shape)
        if 0 in first_dims_shape:
            return torch.empty(first_dims_shape + target_shape, dtype=source.dtype, device=source.device)
        source = source.reshape(first_dims_shape + (-1,))
        if source.shape[-1] != self._weights.m:
            raise ValueError(
                f"Source size {source.shape[-1]} does not match regridder source size {self._weights.m}"
            )
        out = self._apply(source.reshape(-1, self._weights.m))
        return out.reshape(first_dims_shape + target_shape)

    def _regrid_lazy(self, source, device=None) -> torch.Tensor:
        """Out-of-core: stream row blocks of a ``LazyArray`` along its
        leading dimension from the file, each loaded on the host, copied to
        the device and applied, and concatenate the (much smaller) results
        on the device.  A block holds as many rows as fit the apply budget
        (``APPLY_CHUNK_BYTES``) at the decoded itemsize (at least 4 bytes),
        by the slab count ``_apply`` takes too (``_slices_per_chunk``), so
        the whole payload is never on the device at once.  The host
        stages ``regrid.lazy_read`` (read and CF-decode a block) and
        ``regrid.lazy_upload`` (its copy to the device) are timed
        (``utils.profiling.timings``)."""
        shape = source.shape
        if len(shape) <= self._source_ndim() or shape[0] == 0:
            # No leading dimension to stream over (or nothing to stream):
            # materialize and take the eager path.
            return self._regrid_array(np.asarray(source), device)
        extra = int(np.prod(shape[1 : len(shape) - self._source_ndim()]))
        rows = max(1, self._slices_per_chunk(max(source.dtype.itemsize, 4)) // max(extra, 1))
        blocks = []
        for start in range(0, shape[0], rows):
            with timed("regrid.lazy_read"):
                block = np.ascontiguousarray(source[start : start + rows])
            with timed("regrid.lazy_upload"):
                block = torch.from_numpy(block).to(resolve_device(block, device))
            blocks.append(self._regrid_array(block, device))
        return blocks[0] if len(blocks) == 1 else torch.cat(blocks)

    def regrid_dataarray(self, source: xdata.DataArray, source_dims: Tuple[str, ...], device=None):
        """The regridded DataArray: the extra dimensions first, then the
        target's, with the source's coordinates on the extra dimensions,
        its name and attrs.  A tensor payload is never copied to the host;
        a ``LazyArray`` payload streams through in row blocks."""
        extra_dims = tuple(d for d in source.dims if d not in source_dims)
        transposed = source.transpose(*extra_dims, *source_dims)
        result = self._regrid_array(transposed.data, device)
        out = xdata.DataArray(
            result, dims=extra_dims + tuple(self._target.dims), name=source.name, attrs=dict(source.attrs)
        )
        for k, v in transposed._coords.items():
            if set(v.dims) <= set(extra_dims):
                out._coords[k] = v
        return out

    def regrid(self, data, device=None):
        """
        Regrid the data along its grid dimensions; all other dimensions
        (e.g. time, layer) are mapped.

        ``data``: a UgridDataArray or a DataArray, giving a UgridDataArray
        (unstructured target) or a DataArray with the raster's ``y``,
        ``x``, ``dy`` and ``dx`` coordinates (structured target); or a
        tensor or array whose trailing axes are the source grid's (the
        face axis; a raster's (y, x)), giving a tensor of the leading
        axes and the target's.

        ``device``: where to compute, and where the result lies.  None
        means the device of a tensor payload and the CUDA card for
        anything else; without a card, pass ``device="cpu"``.  A numpy
        payload gives a tensor payload on ``device``; so does a lazy one
        (``open_dataset(..., lazy=True)``), read from its file in row
        blocks of at most ``APPLY_CHUNK_BYTES`` (``_regrid_lazy``).
        """
        with span("regrid"):
            if isinstance(data, UgridDataArray):
                obj = data.obj
                source_dims = (data.grid.core_dimension,)
            elif isinstance(data, xdata.DataArray):
                if self._source is None:
                    raise ValueError("a regridder made from weights knows no source grid: pass a UgridDataArray")
                obj = data
                source_dims = tuple(self._source.dims)
            else:
                return self._regrid_array(data, device)
            missing_dims = set(source_dims).difference(obj.dims)
            if missing_dims:
                raise ValueError(f"data does not contain regridder source dimensions: {missing_dims}")
            regridded = self.regrid_dataarray(obj, source_dims, device)
            with span("regrid.wrap"):
                if isinstance(self._target, StructuredGrid2d):
                    return regridded.assign_coords(self._target.coords)
                return UgridDataArray(regridded, self._target.ugrid_topology)


class BaseOverlapRegridder(BaseRegridder, abc.ABC):
    def __init__(self, source, target, tolerance: Optional[float] = None, method=None, device=None):
        # Where the exact overlap of faces above the native clips' sizes
        # runs; resolved only if such faces occur.
        self._build_device = device
        super().__init__(source, target, tolerance)
        self._setup_regrid(self._DEFAULT_METHOD if method is None else method)

    def _overlap_weights(self, source, target, relative: bool) -> MatrixCSR:
        source, target = convert_to_match(source, target)
        if isinstance(source, StructuredGrid2d):
            source_index, target_index, weight_values = source.overlap(target, relative=relative)
        else:
            source_index, target_index, weight_values = source.overlap(
                target, relative=relative, device=self._build_device
            )
        return MatrixCSR.from_triplet(target_index, source_index, weight_values, n=target.size, m=source.size)


class OverlapRegridder(BaseOverlapRegridder):
    """
    Regrid by area of overlap between source and target faces.

    Supported methods: mean, harmonic_mean, geometric_mean, sum, minimum,
    maximum, mode, median, max_overlap, p5/p10/p25/p50/p75/p90/p95, or a
    custom torch reduction over the trailing window axis.  ``device`` is
    where the overlap of faces above the native clips' sizes (32 tree
    nodes, then 96 nodes of both polygons) is computed: None means the
    CUDA card, which must be present unless ``device="cpu"``.
    """

    _METHODS = reduce.ABSOLUTE_OVERLAP_METHODS

    def __init__(self, source, target, method: Union[str, Callable] = "mean", device=None):
        super().__init__(source, target, method=method, device=device)

    def _compute_weights(self, source, target, tolerance=None) -> MatrixCSR:
        return self._overlap_weights(source, target, relative=False)

    @staticmethod
    def create_percentile_method(percentile: float) -> Callable:
        return reduce.create_percentile_method(percentile)


class RelativeOverlapRegridder(BaseOverlapRegridder):
    """
    Overlap regridding with weights divided by the source face area
    (first-order conservative / conductance regridding).  ``device`` as
    for ``OverlapRegridder``.
    """

    _METHODS = reduce.RELATIVE_OVERLAP_METHODS
    _DEFAULT_METHOD = "first_order_conservative"

    def __init__(self, source, target, method: Union[str, Callable] = "first_order_conservative", device=None):
        super().__init__(source, target, method=method, device=device)

    def _compute_weights(self, source, target, tolerance=None) -> MatrixCSR:
        return self._overlap_weights(source, target, relative=True)


class CentroidLocatorRegridder(BaseRegridder):
    """
    Regrid by locating the target faces' centroids in the source:
    out[target] = source[face holding its centroid], NaN where no face
    holds it.  ``tolerance`` is the on-edge tolerance of the point
    location.  Launches no kernel: the apply is a row gather.
    """

    _WEIGHTS_TYPE = MatrixCOO

    def _compute_weights(self, source, target, tolerance=None) -> MatrixCOO:
        source, target = convert_to_match(source, target)
        source_index, target_index, weight_values = source.locate_centroids(target, tolerance)
        return MatrixCOO.from_triplet(target_index, source_index, weight_values, n=target.size, m=source.size)

    def _set_weights(self, weights) -> None:
        if not isinstance(weights, MatrixCOO):
            raise TypeError(
                f"CentroidLocatorRegridder takes COO weights (from_coo_arrays), received {type(weights).__name__}"
            )
        self._weights = weights
        # device -> (row, col) tensors on that device.
        self._device_weights = {}

    def _setup_regrid(self, func) -> None:
        """The row gather takes no method."""

    @classmethod
    def _weights_from_dataset(cls, dataset) -> MatrixCOO:
        return cls._coo_from_dataset(dataset)

    def _apply(self, source2d: torch.Tensor) -> torch.Tensor:
        w = self._weights
        with span("regrid.apply"):
            return apply_coo_gather(w.row, w.col, source2d, w.n, cache=self._device_weights)


class BarycentricInterpolator(BaseRegridder):
    """
    Smooth interpolation: between rasters, bilinear weights of the
    neighbouring source cell centres; otherwise the target centroids are
    located in the source's centroidal voronoi tessellation and weighted
    by generalized barycentric (mean-value) weights over the surrounding
    source faces.  The apply is their weighted mean, which skips NaN
    sources.

    ``tolerance`` is the on-edge tolerance of the point location.
    ``device`` is where the tessellation's angle sort and the weights in
    its cells above the native kernel's 64 nodes run: None means the
    CUDA card, which must be present unless ``device="cpu"``.  The rest
    of the weight build runs on the host.
    """

    _METHODS = {"mean": reduce.mean}

    def __init__(self, source, target, tolerance: Optional[float] = None, device=None):
        self._build_device = resolve_device(None, device)
        super().__init__(source, target, tolerance)
        self._setup_regrid("mean")

    def _compute_weights(self, source, target, tolerance=None) -> MatrixCSR:
        source, target = convert_to_match(source, target)
        if isinstance(source, StructuredGrid2d):
            source_index, target_index, weights = source.linear_weights(target)
        else:
            source_index, target_index, weights = source.barycentric(target, tolerance, device=self._build_device)
        return MatrixCSR.from_triplet(target_index, source_index, weights, n=target.size, m=source.size)
