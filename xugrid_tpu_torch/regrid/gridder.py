"""
NetworkGridder: grid data on the edges of a 1D network (a river or
channel network) onto the faces of a 2D mesh or the cells of a raster,
weighted by the length of each edge inside each face.
"""

from __future__ import annotations

from typing import Callable, Union

from xugrid_tpu_torch.core.sparse import MatrixCSR
from xugrid_tpu_torch.regrid import reduce
from xugrid_tpu_torch.regrid.regridder import BaseRegridder, setup_grid
from xugrid_tpu_torch.regrid.structured import StructuredGrid2d
from xugrid_tpu_torch.regrid.unstructured import Network1d, UnstructuredGrid2d


class NetworkGridder(BaseRegridder):
    """
    Grid data living on the edges of a Ugrid1d network onto the faces of
    a 2D grid, weighting by intersection length (absolute, not relative
    to the edge length).  A raster target is gridded as the Ugrid2d of
    its cells: ``regrid`` then returns a UgridDataArray over it.

    Supported methods: those of ``OverlapRegridder``, or a custom torch
    reduction over the trailing window axis.
    """

    _METHODS = reduce.ABSOLUTE_OVERLAP_METHODS

    def __init__(self, source, target, method: Union[str, Callable] = "mean"):
        self._source = Network1d(source)
        self._target = self._target_grid(target)
        self._set_weights(self._compute_weights(self._source, self._target))
        self._setup_regrid(method)

    @staticmethod
    def _target_grid(target):
        target = setup_grid(target)
        if isinstance(target, StructuredGrid2d):
            return target.convert_to(UnstructuredGrid2d)
        return target

    def _compute_weights(self, source, target, tolerance=None) -> MatrixCSR:
        source_index, target_index, weight_values = target.intersection_length(source, relative=False)
        return MatrixCSR.from_triplet(target_index, source_index, weight_values, n=target.size, m=source.size)
