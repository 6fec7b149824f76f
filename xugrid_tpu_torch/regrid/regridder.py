"""
Overlap regridders: map face data of one 2D mesh onto the faces of
another by area of overlap.

The weights are built on the host (grid hash and native polygon clip)
as a CSR matrix, padded to ``PaddedCSR`` and uploaded once per (dtype,
device); ``regrid`` applies them to a tensor or array whose last axis
is the source face dimension.
"""

from __future__ import annotations

import abc
from typing import Callable, Union

import torch

from xugrid_tpu_torch.core.sparse import MatrixCSR, PaddedCSR
from xugrid_tpu_torch.regrid import reduce
from xugrid_tpu_torch.regrid.apply import apply_weights
from xugrid_tpu_torch.regrid.unstructured import UnstructuredGrid2d

#: Working-set budget per apply chunk (bytes of source plus target):
#: stacks of extra slices larger than this are applied in slabs.
APPLY_CHUNK_BYTES = 2_000_000_000


class BaseRegridder(abc.ABC):
    _METHODS = {}

    def __init__(self, source, target):
        self._set_weights(
            self._compute_weights(UnstructuredGrid2d(source), UnstructuredGrid2d(target))
        )

    @abc.abstractmethod
    def _compute_weights(self, source, target) -> MatrixCSR:
        ...

    def _set_weights(self, weights: MatrixCSR) -> None:
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
    def from_csr_arrays(cls, data, indices, indptr, n: int, m: int, target, method):
        """A regridder applying given CSR weights (n targets by m source
        faces), e.g. those a ``xugrid_tpu`` regridder built."""
        n_target = UnstructuredGrid2d(target).size
        if n_target != n:
            raise ValueError(f"target has {n_target} faces, weights have {n} rows")
        instance = cls.__new__(cls)
        instance._set_weights(MatrixCSR(data, indices, indptr, int(n), int(m), len(data)))
        instance._setup_regrid(method)
        return instance

    def _regrid_array(self, source) -> torch.Tensor:
        source = torch.as_tensor(source)
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

    def regrid(self, data) -> torch.Tensor:
        """
        Regrid a tensor or array whose last axis is the source face
        dimension; all leading axes (e.g. time, layer) are mapped.
        Returns a tensor on the device of ``data``.
        """
        return self._regrid_array(data)


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

    def _compute_weights(self, source, target) -> MatrixCSR:
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

    def _compute_weights(self, source, target) -> MatrixCSR:
        return self._overlap_weights(source, target, relative=True)
