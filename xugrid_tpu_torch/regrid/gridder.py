"""
NetworkGridder: grid data on the edges of a 1D network (a river or
channel network) onto the faces of a 2D mesh, weighted by the length of
each edge inside each face.
"""

from __future__ import annotations

from typing import Callable, Union

from xugrid_tpu_torch.core.sparse import MatrixCSR
from xugrid_tpu_torch.regrid import reduce
from xugrid_tpu_torch.regrid.regridder import BaseRegridder
from xugrid_tpu_torch.regrid.unstructured import Network1d, UnstructuredGrid2d


class NetworkGridder(BaseRegridder):
    """
    Grid data living on the edges of a Ugrid1d network onto the faces of
    a Ugrid2d, weighting by intersection length (absolute, not relative
    to the edge length).

    Supported methods: those of ``OverlapRegridder``, or a custom torch
    reduction over the trailing window axis.
    """

    _METHODS = reduce.ABSOLUTE_OVERLAP_METHODS

    def __init__(self, source, target, method: Union[str, Callable] = "mean"):
        self._set_weights(self._compute_weights(Network1d(source), UnstructuredGrid2d(target)))
        self._setup_regrid(method)

    def _compute_weights(self, source, target, tolerance=None) -> MatrixCSR:
        source_index, target_index, weight_values = target.intersection_length(source)
        return MatrixCSR.from_triplet(target_index, source_index, weight_values, n=target.size, m=source.size)
