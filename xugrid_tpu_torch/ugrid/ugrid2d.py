"""
Ugrid2d: topology of a 2D unstructured mesh (UGRID conventions),
reduced to what the regridders and the Laplace fill read.

The canonical storage is a padded dense int64 ``face_node_connectivity``
(fill -1, 0-based) plus float64 node x/y; face areas, centroids, the
derived connectivities and the spatial index are computed on first use
and cached.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.sparse import csr_matrix

from xugrid_tpu_torch.constants import FILL_VALUE, FloatDType, IntDType
from xugrid_tpu_torch.ugrid import connectivity
from xugrid_tpu_torch.ugrid.ugridbase import AbstractUgrid


class Ugrid2d(AbstractUgrid):
    """
    Topological data of a 2-D unstructured grid.

    Parameters
    ----------
    node_x, node_y: ndarray of floats
    fill_value: int
        Fill value of the provided face_node_connectivity.
    face_node_connectivity: ndarray of integers
    name: str, default "mesh2d"
        Names the UGRID dimensions: ``{name}_nNodes``, ``{name}_nEdges``,
        ``{name}_nFaces``.
    edge_node_connectivity: ndarray of integers, optional
        A prior edge numbering to keep.
    start_index: 0 or 1, default 0
    """

    def __init__(
        self,
        node_x,
        node_y,
        fill_value: int,
        face_node_connectivity,
        name: str = "mesh2d",
        edge_node_connectivity=None,
        start_index: int = 0,
    ):
        self.node_x = np.ascontiguousarray(node_x, dtype=FloatDType)
        self.node_y = np.ascontiguousarray(node_y, dtype=FloatDType)
        self.fill_value = fill_value
        self.name = name
        if not isinstance(face_node_connectivity, np.ndarray):
            raise TypeError(
                "face_node_connectivity should be an array of integers, "
                f"received: {type(face_node_connectivity).__name__}"
            )
        conn = face_node_connectivity.copy()
        # Normalize to -1 fill and 0-based indices.
        if fill_value != FILL_VALUE or start_index != 0:
            is_fill = conn == fill_value
            if start_index != 0:
                conn[~is_fill] -= start_index
            if fill_value != FILL_VALUE:
                conn[is_fill] = FILL_VALUE
        self.face_node_connectivity = conn.astype(IntDType, copy=False)
        if edge_node_connectivity is not None:
            edge_node_connectivity = np.asarray(edge_node_connectivity, dtype=IntDType) - start_index
        self._edge_node_connectivity = edge_node_connectivity
        self._face_edge_connectivity = None
        self._edge_face_connectivity = None
        self._face_face_connectivity = None
        self._node_node_connectivity = None
        self._node_face_connectivity = None
        self._area = None
        self._centroids = None
        self._celltree = None

    # -- sizes and dimension names ---------------------------------------------
    @property
    def n_node(self) -> int:
        return len(self.node_x)

    @property
    def n_edge(self) -> int:
        return len(self.edge_node_connectivity)

    @property
    def n_face(self) -> int:
        return len(self.face_node_connectivity)

    @property
    def node_dimension(self) -> str:
        return f"{self.name}_nNodes"

    @property
    def edge_dimension(self) -> str:
        return f"{self.name}_nEdges"

    @property
    def face_dimension(self) -> str:
        return f"{self.name}_nFaces"

    @property
    def topology_dimension(self) -> int:
        return 2

    @property
    def core_dimension(self) -> str:
        return self.face_dimension

    @property
    def facets(self) -> dict:
        return {"node": self.node_dimension, "edge": self.edge_dimension, "face": self.face_dimension}

    @property
    def node_coordinates(self) -> np.ndarray:
        """(n_node, 2) node x and y."""
        return np.column_stack([self.node_x, self.node_y])

    # -- structured constructors -------------------------------------------------
    @staticmethod
    def _from_intervals_helper(node_x, node_y, nx: int, ny: int, name: str) -> "Ugrid2d":
        """Quads over the (ny + 1, nx + 1) nodes of interval breaks, y-major
        in the breaks' own order, each counter-clockwise."""
        linear = np.arange(node_x.size, dtype=IntDType).reshape((ny + 1, nx + 1))
        face_nodes = np.empty((ny * nx, 4), dtype=IntDType)
        left, right = slice(None, -1), slice(1, None)
        lower, upper = slice(None, -1), slice(1, None)
        if node_x[1] < node_x[0]:  # x decreasing
            left, right = right, left
        if node_y[nx + 1] < node_y[0]:  # y decreasing
            lower, upper = upper, lower
        face_nodes[:, 0] = linear[lower, left].ravel()
        face_nodes[:, 1] = linear[lower, right].ravel()
        face_nodes[:, 2] = linear[upper, right].ravel()
        face_nodes[:, 3] = linear[upper, left].ravel()
        return Ugrid2d(node_x, node_y, FILL_VALUE, face_nodes, name=name)

    @staticmethod
    def from_structured_intervals1d(x_intervals, y_intervals, name="mesh2d") -> "Ugrid2d":
        """Ugrid2d from 1D x and y interval breaks."""
        x_intervals = np.asarray(x_intervals)
        y_intervals = np.asarray(y_intervals)
        nx = x_intervals.shape[0] - 1
        ny = y_intervals.shape[0] - 1
        node_y, node_x = (a.ravel() for a in np.meshgrid(y_intervals, x_intervals, indexing="ij"))
        return Ugrid2d._from_intervals_helper(node_x, node_y, nx, ny, name)

    @staticmethod
    def from_structured_bounds(x_bounds, y_bounds, name="mesh2d"):
        """
        Ugrid2d from (nx, 2) and (ny, 2) cell bounds, monotonic ascending or
        descending: face k is cell (k // nx, k % nx) in the bounds' own
        order.  (Curvilinear (N, M, 4) bounds are not ported.)
        """
        from xugrid_tpu_torch import conversion

        x_bounds = np.asarray(x_bounds)
        y_bounds = np.asarray(y_bounds)
        if x_bounds.ndim != 2 or y_bounds.ndim != 2:
            raise ValueError(f"Expected (n, 2) bounds, received {x_bounds.ndim} and {y_bounds.ndim} dimensions")
        x = conversion.bounds1d_to_vertices(x_bounds)
        y = conversion.bounds1d_to_vertices(y_bounds)
        node_y, node_x = (a.ravel() for a in np.meshgrid(y, x, indexing="ij"))
        return Ugrid2d._from_intervals_helper(node_x, node_y, x_bounds.shape[0], y_bounds.shape[0], name)

    @staticmethod
    def from_structured(data, x=None, y=None, name="mesh2d", return_dims=False):
        """
        Ugrid2d from a rectilinear DataArray or Dataset (1D x and y
        coordinates, inferred when not given).  ``return_dims`` also
        returns the (y, x) dimensions.  (Rotated and curvilinear
        coordinates are not ported.)
        """
        from xugrid_tpu_torch import conversion

        if (x is None) ^ (y is None):
            raise ValueError("Provide both x and y, or neither.")
        if x is None:
            x, y = conversion.infer_xy_coords(data)
            if x is None or y is None:
                raise ValueError("Could not infer bounds. Please provide x and y explicitly.")
        else:
            missing = {x, y} - set(data.coords)
            if missing:
                raise ValueError(f"Coordinates {x} and {y} are not present, expected one of: {set(data.coords)}")
        if data[x].ndim != 1:
            raise NotImplementedError("x and y must be 1D: curvilinear coordinates are not ported")
        grid = Ugrid2d.from_structured_intervals1d(
            conversion.infer_interval_breaks1d(data, x), conversion.infer_interval_breaks1d(data, y), name
        )
        dims = (data[y].dims[0], data[x].dims[0])
        if return_dims:
            return grid, dims
        return grid

    # -- derived connectivity --------------------------------------------------
    def _edge_connectivity(self):
        (
            self._edge_node_connectivity,
            self._face_edge_connectivity,
        ) = connectivity.edge_connectivity(
            self.face_node_connectivity, self._edge_node_connectivity
        )

    @property
    def edge_node_connectivity(self) -> np.ndarray:
        """(n_edge, 2) node pair per edge."""
        if self._edge_node_connectivity is None:
            self._edge_connectivity()
        return self._edge_node_connectivity

    @property
    def face_edge_connectivity(self) -> np.ndarray:
        """(n_face, n_max) edge index per face (fill -1)."""
        if self._face_edge_connectivity is None:
            self._edge_connectivity()
        return self._face_edge_connectivity

    @property
    def edge_face_connectivity(self) -> np.ndarray:
        """(n_edge, 2) faces per edge; exterior edges have -1 second."""
        if self._edge_face_connectivity is None:
            inverted = connectivity.invert_dense(self.face_edge_connectivity)
            # Where every edge borders one face the inversion has one
            # column: pad the second.
            if inverted.shape[1] == 1:
                inverted = np.column_stack(
                    [inverted[:, 0], np.full(len(inverted), FILL_VALUE)]
                )
            self._edge_face_connectivity = inverted
        return self._edge_face_connectivity

    @property
    def face_face_connectivity(self) -> csr_matrix:
        """Face adjacency (CSR); data holds the shared edge index."""
        if self._face_face_connectivity is None:
            self._face_face_connectivity = connectivity.face_face_connectivity(
                self.edge_face_connectivity, self.n_face
            )
        return self._face_face_connectivity

    @property
    def node_node_connectivity(self) -> csr_matrix:
        """Node adjacency (CSR); data holds the connecting edge index."""
        if self._node_node_connectivity is None:
            self._node_node_connectivity = connectivity.node_node_connectivity(
                self.edge_node_connectivity
            )
        return self._node_node_connectivity

    @property
    def node_face_connectivity(self) -> csr_matrix:
        """Node to face connectivity (CSR); data holds the face index."""
        if self._node_face_connectivity is None:
            self._node_face_connectivity = connectivity.invert_dense_to_sparse(
                self.face_node_connectivity
            )
        return self._node_face_connectivity

    def get_connectivity_matrix(self, dim: str, xy_weights: bool) -> csr_matrix:
        """Adjacency matrix (CSR) of the nodes or the faces.  With
        ``xy_weights`` its data are normalized inverse distances between
        the node coordinates or face centroids, else the connecting edge
        index."""
        if dim == self.node_dimension:
            conn = self.node_node_connectivity.copy()
            coordinates = self.node_coordinates
        elif dim == self.face_dimension:
            conn = self.face_face_connectivity.copy()
            coordinates = self.centroids
        else:
            raise ValueError(
                f"Expected {self.node_dimension} or {self.face_dimension}; got: {dim}"
            )
        if xy_weights:
            conn.data = self._connectivity_weights(conn, coordinates)
        return conn

    @staticmethod
    def _connectivity_weights(conn: csr_matrix, coordinates: np.ndarray) -> np.ndarray:
        """Normalized inverse-distance weights for adjacency data."""
        coo = conn.tocoo()
        distance = np.linalg.norm(coordinates[coo.col] - coordinates[coo.row], axis=1)
        return distance.mean() / distance

    # -- geometry --------------------------------------------------------------
    @property
    def area(self) -> np.ndarray:
        """Area of every face."""
        if self._area is None:
            self._area = connectivity.area(
                self.face_node_connectivity, self.node_x, self.node_y
            )
        return self._area

    @property
    def centroids(self) -> np.ndarray:
        """(n_face, 2) area-weighted centroid per face."""
        if self._centroids is None:
            self._centroids = connectivity.centroids(
                self.face_node_connectivity, self.node_x, self.node_y
            )
        return self._centroids

    @property
    def celltree(self):
        """The spatial index over the faces."""
        if self._celltree is None:
            from xugrid_tpu_torch.spatial.celltree import CellTree2d

            self._celltree = CellTree2d(
                self.node_coordinates, self.face_node_connectivity, FILL_VALUE
            )
        return self._celltree

    # -- point queries -----------------------------------------------------------
    def locate_points(self, points: np.ndarray, tolerance: Optional[float] = None) -> np.ndarray:
        """Index of the face holding each point (-1 outside)."""
        return self.celltree.locate_points(points, tolerance)

    def compute_barycentric_weights(self, points: np.ndarray, tolerance: Optional[float] = None, device=None):
        """Face holding each point and the mean-value weights of its
        nodes: (face_index (n,), weights (n, n_max_node)).  Faces above
        the native kernel's 64 nodes are weighed on ``device``."""
        return self.celltree.compute_barycentric_weights(points, tolerance, device=device)
