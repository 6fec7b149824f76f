"""
Ugrid1d: topology of a 1D network (connected line elements, such as a
river or channel network), reduced to what ``NetworkGridder`` and the
UGRID file round trip read.
"""

from __future__ import annotations

from itertools import chain
from typing import Any, Dict, Optional

import numpy as np

from xugrid_tpu_torch import xdata
from xugrid_tpu_torch.constants import FloatDType, IntDType
from xugrid_tpu_torch.ugrid import conventions
from xugrid_tpu_torch.ugrid.ugridbase import AbstractUgrid, _strip_dim_coords


class Ugrid1d(AbstractUgrid):
    """
    Topological data of a 1-D unstructured grid.

    Parameters
    ----------
    node_x, node_y: ndarray of floats
    fill_value: int
    edge_node_connectivity: ndarray of integers (n_edge, 2)
    name: str, default "network1d"
        Names the UGRID variables and dimensions: ``{name}_nNodes``,
        ``{name}_nEdges`` by default.
    dataset, indexes, is_projected, crs, attrs: as for ``Ugrid2d``
    start_index: 0 or 1, default 0
    """

    def __init__(
        self,
        node_x,
        node_y,
        fill_value: int,
        edge_node_connectivity,
        name: str = "network1d",
        dataset=None,
        indexes: Optional[Dict[str, str]] = None,
        is_projected: bool = True,
        crs: Any = None,
        attrs: Optional[Dict[str, str]] = None,
        start_index: int = 0,
    ):
        self.node_x = np.ascontiguousarray(node_x, dtype=FloatDType)
        self.node_y = np.ascontiguousarray(node_y, dtype=FloatDType)
        self.fill_value = fill_value
        self.start_index = start_index
        self.edge_node_connectivity = np.asarray(edge_node_connectivity).astype(IntDType) - start_index
        self.name = name
        self.crs, self.is_projected = self._validate_crs(crs, is_projected)
        self._initialize_indexes_attrs(name, dataset, indexes, attrs)
        self._dataset = dataset
        self._clear_geometry_properties()

    def _clear_geometry_properties(self):
        """Drop the cached geometry (after the node coordinates change)."""
        self._edge_x = None
        self._edge_y = None

    # -- UGRID datasets ----------------------------------------------------------
    @classmethod
    def from_dataset(cls, dataset, topology: Optional[str] = None) -> "Ugrid1d":
        """The 1D UGRID topology ``topology`` of a Dataset (the only one
        when None)."""
        ds = dataset
        if not isinstance(ds, xdata.Dataset):
            raise TypeError(
                "Ugrid1d should be initialized with an xdata.Dataset. "
                f"Received instead: {type(ds).__name__}"
            )
        if topology is None:
            topology = cls._single_topology(ds)

        roles = conventions.ugrid_roles(ds)
        connectivity_names = roles.connectivity[topology]
        coordinates = roles.coordinates[topology]
        dimensions = roles.dimensions[topology]
        ugrid_vars = (
            [topology]
            + list(connectivity_names.values())
            + list(chain.from_iterable(chain.from_iterable(coordinates.values())))
        )

        x_index = coordinates["node_coordinates"][0][0]
        y_index = coordinates["node_coordinates"][1][0]
        node_x = np.asarray(ds[x_index].data, dtype=FloatDType)
        node_y = np.asarray(ds[y_index].data, dtype=FloatDType)

        da = ds[connectivity_names["edge_node_connectivity"]]
        fill_value = da.encoding.get("_FillValue", da.attrs.get("_FillValue", -1))
        start_index = da.attrs.get("start_index", 0)
        edge_node_connectivity = cls._prepare_connectivity(
            da, fill_value, IntDType, coredim=dimensions["edge_dimension"]
        )

        indexes = {"node_x": x_index, "node_y": y_index}
        edge_coords = coordinates.get("edge_coordinates")
        if edge_coords is not None:
            indexes["edge_x"] = edge_coords[0][0]
            indexes["edge_y"] = edge_coords[1][0]

        crs, is_projected = cls._extract_crs(ds, topology)
        return cls(
            node_x,
            node_y,
            fill_value,
            edge_node_connectivity,
            name=topology,
            dataset=_strip_dim_coords(ds[ugrid_vars]),
            indexes=indexes,
            is_projected=is_projected,
            crs=crs,
            start_index=start_index,
        )

    def to_dataset(self, other=None, optional_attributes: bool = False):
        """The UGRID dataset of this network (merged with ``other``): the
        topology variable, the edge-node connectivity in the grid's fill
        value and start index, and the node coordinates; with
        ``optional_attributes`` also the edge coordinates."""
        node_x = self._indexes["node_x"]
        node_y = self._indexes["node_y"]
        edge_nodes = self._attrs["edge_node_connectivity"]
        edge_nodes_attrs = dict(conventions.DEFAULT_ATTRS["edge_node_connectivity"])
        edge_nodes_attrs["start_index"] = self.start_index
        edge_nodes_attrs["_FillValue"] = self.fill_value

        ds = xdata.Dataset(attrs={"Conventions": "CF-1.9 UGRID-1.0"})
        if other is not None:
            ds.attrs.update(other.attrs)
        ds[self.name] = ((), np.int32(0))
        ds[edge_nodes] = (
            (self.edge_dimension, "two"),
            self._adjust_connectivity(self.edge_node_connectivity),
            edge_nodes_attrs,
        )
        if self._dataset:
            ds = ds.merge(self._dataset, compat="override")
        if other is not None:
            ds = ds.merge(other, compat="override")
        if node_x not in ds._variables or node_y not in ds._variables:
            ds = self.assign_node_coords(ds)
        if optional_attributes:
            ds = self.assign_edge_coords(ds)
        ds._variables[self.name].attrs = self._filtered_attrs(ds)
        return self.write_grid_mapping(ds)

    # -- sizes and dimension names ---------------------------------------------
    @property
    def topology_dimension(self) -> int:
        return 1

    @property
    def core_dimension(self) -> str:
        return self.edge_dimension

    @property
    def facets(self) -> dict:
        return {"node": self.node_dimension, "edge": self.edge_dimension}

    @property
    def sizes(self) -> dict:
        return {self.node_dimension: self.n_node, self.edge_dimension: self.n_edge}
