"""
Regridders between the faces of 2D meshes: by area of overlap
(``OverlapRegridder``, ``RelativeOverlapRegridder``), by the face
holding each target centroid (``CentroidLocatorRegridder``), and by
barycentric interpolation in the source's centroidal voronoi
tessellation (``BarycentricInterpolator``).

The weights are built on the host (grid hash and native geometry
kernels) as a CSR matrix, padded to ``PaddedCSR`` and uploaded once per
(dtype, device); ``regrid`` applies them to a tensor or array whose last
axis is the source face dimension.  The centroid locator keeps its
weights as COO triplets and applies them as a row gather.
"""

from __future__ import annotations

import abc
from typing import Callable, Optional, Union

import torch

from xugrid_tpu_torch.core.sparse import MatrixCOO, MatrixCSR, PaddedCSR
from xugrid_tpu_torch.regrid import reduce
from xugrid_tpu_torch.regrid.apply import apply_coo_gather, apply_weights
from xugrid_tpu_torch.regrid.unstructured import UnstructuredGrid2d
from xugrid_tpu_torch.utils.device import resolve_device

#: Working-set budget per apply chunk (bytes of source plus target):
#: stacks of extra slices larger than this are applied in slabs.
APPLY_CHUNK_BYTES = 2_000_000_000


class BaseRegridder(abc.ABC):
    _METHODS = {}

    def __init__(self, source, target, tolerance: Optional[float] = None):
        self._set_weights(
            self._compute_weights(UnstructuredGrid2d(source), UnstructuredGrid2d(target), tolerance)
        )

    @abc.abstractmethod
    def _compute_weights(self, source, target, tolerance=None) -> MatrixCSR:
        ...

    def _set_weights(self, weights) -> None:
        if isinstance(weights, MatrixCOO):
            weights = weights.to_csr()
        self._weights = weights
        self._padded = PaddedCSR.from_csr(weights)
        # (dtype, device) -> (indices, weights) tensors on that device.
        self._device_weights = {}

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
    def from_csr_arrays(cls, data, indices, indptr, n: int, m: int, target, method="mean"):
        """A regridder applying given CSR weights (n targets by m source
        entities), e.g. those a ``xugrid_tpu`` regridder built."""
        return cls._from_weights(MatrixCSR(data, indices, indptr, int(n), int(m), len(data)), target, method)

    @classmethod
    def from_coo_arrays(cls, data, row, col, n: int, m: int, target, method="mean"):
        """A regridder applying given COO weight triplets (row: target,
        col: source), e.g. a ``xugrid_tpu`` CentroidLocatorRegridder's."""
        return cls._from_weights(MatrixCOO.from_triplet(row, col, data, n, m), target, method)

    @classmethod
    def _from_weights(cls, weights, target, method):
        n_target = UnstructuredGrid2d(target).size
        if n_target != weights.n:
            raise ValueError(f"target has {n_target} faces, weights have {weights.n} rows")
        instance = cls.__new__(cls)
        instance._set_weights(weights)
        instance._setup_regrid(method)
        return instance

    def _regrid_array(self, source, device=None) -> torch.Tensor:
        source = torch.as_tensor(source).to(resolve_device(source, device))
        n, m = self._weights.n, self._weights.m
        first_dims_shape = tuple(source.shape[:-1])
        if 0 in first_dims_shape:
            return torch.empty(first_dims_shape + (n,), dtype=source.dtype, device=source.device)
        if source.shape[-1] != m:
            raise ValueError(
                f"Source size {source.shape[-1]} does not match regridder source size {m}"
            )
        source2d = source.reshape(-1, m)
        n_extra = source2d.shape[0]
        # Bound the device working set: stacks larger than the budget
        # stream through in slabs of extra slices.
        per_slice = source2d.element_size() * (m + n)
        rows = max(APPLY_CHUNK_BYTES // per_slice, 1)
        chunks = [
            apply_weights(
                self._padded, source2d[i : i + rows], self._reduction, n,
                cache=self._device_weights,
            )
            for i in range(0, n_extra, rows)
        ]
        out = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
        return out.reshape(first_dims_shape + (n,))

    def regrid(self, data, device=None) -> torch.Tensor:
        """
        Regrid a tensor or array whose last axis is the source face
        dimension; all leading axes (e.g. time, layer) are mapped.

        ``device``: where to compute, and where the result lies.  None
        means the device of ``data`` for a tensor and the CUDA card for
        anything else; without a card, pass ``device="cpu"``.
        """
        return self._regrid_array(data, device)


class BaseOverlapRegridder(BaseRegridder, abc.ABC):
    def _overlap_weights(self, source, target, relative: bool) -> MatrixCSR:
        source_index, target_index, weight_values = source.overlap(target, relative=relative)
        return MatrixCSR.from_triplet(
            target_index, source_index, weight_values, n=target.size, m=source.size
        )


class OverlapRegridder(BaseOverlapRegridder):
    """
    Regrid by area of overlap between source and target faces.

    Supported methods: mean, harmonic_mean, geometric_mean, sum, minimum,
    maximum, mode, median, max_overlap, p5/p10/p25/p50/p75/p90/p95, or a
    custom torch reduction over the trailing window axis.
    """

    _METHODS = reduce.ABSOLUTE_OVERLAP_METHODS

    def __init__(self, source, target, method: Union[str, Callable] = "mean"):
        super().__init__(source=source, target=target)
        self._setup_regrid(method)

    def _compute_weights(self, source, target, tolerance=None) -> MatrixCSR:
        return self._overlap_weights(source, target, relative=False)

    @staticmethod
    def create_percentile_method(percentile: float) -> Callable:
        return reduce.create_percentile_method(percentile)


class RelativeOverlapRegridder(BaseOverlapRegridder):
    """
    Overlap regridding with weights divided by the source face area
    (first-order conservative / conductance regridding).
    """

    _METHODS = reduce.RELATIVE_OVERLAP_METHODS

    def __init__(self, source, target, method: Union[str, Callable] = "first_order_conservative"):
        super().__init__(source=source, target=target)
        self._setup_regrid(method)

    def _compute_weights(self, source, target, tolerance=None) -> MatrixCSR:
        return self._overlap_weights(source, target, relative=True)


class CentroidLocatorRegridder(BaseRegridder):
    """
    Regrid by locating the target faces' centroids in the source mesh:
    out[target] = source[face holding its centroid], NaN where no face
    holds it.  ``tolerance`` is the on-edge tolerance of the point
    location.  Launches no kernel: the apply is a row gather.
    """

    def _compute_weights(self, source, target, tolerance=None) -> MatrixCOO:
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

    def _regrid_array(self, source, device=None) -> torch.Tensor:
        source = torch.as_tensor(source).to(resolve_device(source, device))
        n, m = self._weights.n, self._weights.m
        first_dims_shape = tuple(source.shape[:-1])
        if 0 in first_dims_shape:
            return torch.empty(first_dims_shape + (n,), dtype=source.dtype, device=source.device)
        if source.shape[-1] != m:
            raise ValueError(
                f"Source size {source.shape[-1]} does not match regridder source size {m}"
            )
        w = self._weights
        return apply_coo_gather(w.row, w.col, source, n, cache=self._device_weights)


class BarycentricInterpolator(BaseRegridder):
    """
    Smooth interpolation: the target centroids are located in the
    source's centroidal voronoi tessellation and weighted by generalized
    barycentric (mean-value) weights over the surrounding source faces;
    the apply is their weighted mean, which skips NaN sources.

    ``tolerance`` is the on-edge tolerance of the point location.
    ``device`` is where the tessellation's angle sort runs: None means
    the CUDA card, which must be present unless ``device="cpu"``.  The
    rest of the weight build runs on the host.
    """

    _METHODS = {"mean": reduce.mean}

    def __init__(self, source, target, tolerance: Optional[float] = None, device=None):
        self._build_device = resolve_device(None, device)
        super().__init__(source, target, tolerance)
        self._setup_regrid("mean")

    def _compute_weights(self, source, target, tolerance=None) -> MatrixCSR:
        source_index, target_index, weights = source.barycentric(
            target, tolerance, device=self._build_device
        )
        return MatrixCSR.from_triplet(target_index, source_index, weights, n=target.size, m=source.size)
