"""
Ugrid1d: topology of a 1D network (connected line elements, such as a
river or channel network), reduced to what ``NetworkGridder`` reads.
"""

from __future__ import annotations

import numpy as np

from xugrid_tpu_torch.constants import FloatDType, IntDType
from xugrid_tpu_torch.ugrid.ugridbase import AbstractUgrid


class Ugrid1d(AbstractUgrid):
    """
    Topological data of a 1-D unstructured grid.

    Parameters
    ----------
    node_x, node_y: ndarray of floats
    fill_value: int
    edge_node_connectivity: ndarray of integers (n_edge, 2)
    name: str, default "network1d"
        Names the UGRID dimensions: ``{name}_nNodes``, ``{name}_nEdges``.
    start_index: 0 or 1, default 0
    """

    def __init__(
        self,
        node_x,
        node_y,
        fill_value: int,
        edge_node_connectivity,
        name: str = "network1d",
        start_index: int = 0,
    ):
        self.node_x = np.ascontiguousarray(node_x, dtype=FloatDType)
        self.node_y = np.ascontiguousarray(node_y, dtype=FloatDType)
        self.fill_value = fill_value
        self.start_index = start_index
        self.edge_node_connectivity = np.asarray(edge_node_connectivity).astype(IntDType) - start_index
        self.name = name

    @property
    def n_node(self) -> int:
        return len(self.node_x)

    @property
    def n_edge(self) -> int:
        return len(self.edge_node_connectivity)

    @property
    def node_dimension(self) -> str:
        return f"{self.name}_nNodes"

    @property
    def edge_dimension(self) -> str:
        return f"{self.name}_nEdges"

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
    def node_coordinates(self) -> np.ndarray:
        """(n_node, 2) node x and y."""
        return np.column_stack([self.node_x, self.node_y])

    @property
    def edge_node_coordinates(self) -> np.ndarray:
        """Node coordinates of every edge: (n_edge, 2, 2)."""
        return self.node_coordinates[self.edge_node_connectivity]

    @property
    def edge_length(self) -> np.ndarray:
        """Length of every edge."""
        dxy = np.diff(self.edge_node_coordinates, axis=1)[:, 0, :]
        return np.linalg.norm(dxy, axis=-1)
