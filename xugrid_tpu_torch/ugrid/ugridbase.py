"""
What ``Ugrid1d`` and ``Ugrid2d`` share for the labelled wrappers: the
UGRID dimension names, the search for the one a DataArray carries, the
bounding box, and the construction of a UgridDataArray on a facet.
"""

from __future__ import annotations

import abc

import numpy as np


class AbstractUgrid(abc.ABC):
    @property
    @abc.abstractmethod
    def topology_dimension(self) -> int:
        ...

    @property
    @abc.abstractmethod
    def core_dimension(self) -> str:
        ...

    @property
    @abc.abstractmethod
    def facets(self) -> dict:
        """Facet name ("node", "edge", "face") -> dimension name."""

    @property
    def dims(self) -> set:
        """Set of UGRID dimension names."""
        return set(self.facets.values())

    @property
    def bounds(self) -> tuple:
        """(xmin, ymin, xmax, ymax) of the nodes."""
        return (self.node_x.min(), self.node_y.min(), self.node_x.max(), self.node_y.max())

    def equals(self, other) -> bool:
        """Same kind, name, node coordinates and connectivity."""
        if other is self:
            return True
        if type(other) is not type(self) or other.name != self.name:
            return False
        conn = "face_node_connectivity" if self.topology_dimension == 2 else "edge_node_connectivity"
        return (
            np.array_equal(self.node_x, other.node_x)
            and np.array_equal(self.node_y, other.node_y)
            and np.array_equal(getattr(self, conn), getattr(other, conn))
        )

    def find_ugrid_dim(self, obj) -> str:
        """The single UGRID dimension present in the object."""
        ugrid_dims = self.dims.intersection(obj.dims)
        if len(ugrid_dims) != 1:
            raise ValueError(
                f"UgridDataArray should contain exactly one of the UGRID dimensions: {self.dims}"
            )
        return ugrid_dims.pop()

    def create_data_array(self, data, facet: str):
        """UgridDataArray from a 1D array or tensor on the given facet."""
        from xugrid_tpu_torch import xdata
        from xugrid_tpu_torch.core.wrap import UgridDataArray
        from xugrid_tpu_torch.xdata.variable import as_compatible_data

        if facet not in self.facets:
            raise ValueError(f"Invalid facet: {facet}. Must be one of: {', '.join(self.facets)}.")
        dimension = self.facets[facet]
        data = as_compatible_data(data)
        if data.ndim != 1:
            raise ValueError(f"Can only create DataArrays from 1D arrays. Data has {data.ndim} dimensions.")
        size = getattr(self, f"n_{facet}")
        if len(data) != size:
            raise ValueError(
                f"Conflicting sizes for dimension {dimension}: length {len(data)} on the data, "
                f"but length {size} on the grid."
            )
        return UgridDataArray(xdata.DataArray(data, dims=(dimension,)), self)
