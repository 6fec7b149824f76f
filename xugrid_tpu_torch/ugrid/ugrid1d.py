"""
Ugrid1d: topology of a 1D network (connected line elements, such as a
river or channel network), reduced to what ``NetworkGridder``, the
UGRID file round trip, the topology subsets, the partition merge, the
point and line selections, the nearest fill (Dijkstra along the
network) and the graph edits (topological order, self-loops, vertex
contraction, refinement) read; the meshkernel bridge (``mesh``,
``meshkernel``, ``from_meshkernel``) imports meshkernel where it is
used, as the JAX package does.
"""

from __future__ import annotations

from itertools import chain
from typing import Any, Dict, Optional, Sequence

import numpy as np
import pandas as pd
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra

from xugrid_tpu_torch import xdata
from xugrid_tpu_torch.constants import FILL_VALUE, FloatDType, IntDType
from xugrid_tpu_torch.ugrid import connectivity, conventions
from xugrid_tpu_torch.ugrid.selection_utils import section_coordinates_1d
from xugrid_tpu_torch.ugrid.ugridbase import AbstractUgrid, _strip_dim_coords, as_pandas_index
from xugrid_tpu_torch.utils.profiling import timed


def _alt_cumsum(a: np.ndarray) -> np.ndarray:
    """Exclusive cumulative sum: [0, a0, a0 + a1, ...]."""
    out = np.empty_like(a)
    out[0] = 0
    np.cumsum(a[:-1], out=out[1:])
    return out


class Ugrid1d(AbstractUgrid):
    """
    Topological data of a 1-D unstructured grid.

    Parameters
    ----------
    node_x, node_y: ndarray of floats
    fill_value: int
    edge_node_connectivity: ndarray of integers (n_edge, 2)
        Required: its default None raises TypeError, as in the reference.
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
        edge_node_connectivity=None,
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
        self._mesh = None
        self._meshkernel = None
        self._edge_x = None
        self._edge_y = None
        self._celltree = None
        self._node_kdtree = None
        self._edge_kdtree = None

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

    @classmethod
    def from_meshkernel(cls, mesh, name="network1d", is_projected=True, crs=None):
        """A Ugrid1d of a meshkernel Mesh1d object (node_x, node_y,
        edge_nodes)."""
        return cls(
            mesh.node_x,
            mesh.node_y,
            fill_value=FILL_VALUE,
            edge_node_connectivity=mesh.edge_nodes.reshape((-1, 2)),
            name=name,
            is_projected=is_projected,
            crs=crs,
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

    def get_coordinates(self, dim: str) -> np.ndarray:
        """(n, 2) coordinates of the nodes or the edge midpoints."""
        if dim == self.node_dimension:
            return self.node_coordinates
        elif dim == self.edge_dimension:
            return self.edge_coordinates
        raise ValueError(f"Expected {self.node_dimension} or {self.edge_dimension}; got: {dim}")

    def get_connectivity_matrix(self, dim: str, xy_weights: bool) -> csr_matrix:
        """Adjacency matrix (CSR) of the nodes.  With ``xy_weights`` its
        data are normalized inverse distances between the nodes, else the
        connecting edge index."""
        if dim != self.node_dimension:
            raise ValueError(f"Expected {self.node_dimension}; got: {dim}")
        conn = self.node_node_connectivity.copy()
        if xy_weights:
            conn.data = self._connectivity_weights(conn, self.node_coordinates)
        return conn

    # -- vector conversion ---------------------------------------------------------
    @classmethod
    def from_geodataframe(cls, geodataframe) -> "Ugrid1d":
        """Convert a geopandas GeoDataFrame of linestrings to Ugrid1d."""
        import geopandas as gpd

        if not isinstance(geodataframe, gpd.GeoDataFrame):
            raise TypeError(f"Expected GeoDataFrame, received: {type(geodataframe).__name__}")
        return cls.from_shapely(geodataframe.geometry.to_numpy(), crs=geodataframe.crs)

    @staticmethod
    def from_shapely(geometry, crs=None) -> "Ugrid1d":
        """Convert an array of shapely linestrings to Ugrid1d."""
        import shapely

        from xugrid_tpu_torch import conversion

        if not (shapely.get_type_id(geometry) == shapely.GeometryType.LINESTRING).all():
            raise TypeError(
                "Can only create Ugrid1d from shapely LineString geometries, "
                "geometry contains other types of geometries."
            )
        x, y, edge_node_connectivity = conversion.linestrings_to_edges(geometry)
        return Ugrid1d(x, y, FILL_VALUE, edge_node_connectivity, crs=crs)

    def to_shapely(self, dim: str):
        """Convert a facet to shapely points/linestrings."""
        from xugrid_tpu_torch import conversion

        if dim == self.node_dimension:
            return conversion.nodes_to_points(self.node_x, self.node_y)
        elif dim == self.edge_dimension:
            return conversion.edges_to_linestrings(self.node_x, self.node_y, self.edge_node_connectivity)
        raise ValueError(
            f"Dimension {dim} is not a node or edge dimension of the "
            "Ugrid1d topology."
        )

    def to_pygeos(self, dim):
        """Deprecated: ``to_shapely``."""
        import warnings

        warnings.warn(".to_pygeos has been deprecated. Use .to_shapely instead.", DeprecationWarning)
        return self.to_shapely(dim)

    # -- meshkernel (optional; imported where it is used) -------------------------
    @property
    def mesh(self):
        """meshkernel Mesh1d view of this network (requires meshkernel)."""
        import meshkernel as mk

        if self._mesh is None:
            self._mesh = mk.Mesh1d(
                node_x=self.node_x,
                node_y=self.node_y,
                edge_nodes=self.edge_node_connectivity.ravel().astype(np.int32),
            )
        return self._mesh

    @property
    def meshkernel(self):
        """meshkernel MeshKernel instance for this network (requires
        meshkernel)."""
        import meshkernel as mk

        if self._meshkernel is None:
            projection = mk.ProjectionType.SPHERICAL if self.is_geographic else mk.ProjectionType.CARTESIAN
            self._meshkernel = mk.MeshKernel(projection)
            self._meshkernel.mesh1d_set(self.mesh)
        return self._meshkernel

    # -- spatial queries -----------------------------------------------------------
    @property
    def celltree(self):
        """The spatial index over the edges, built on first use."""
        if self._celltree is None:
            from xugrid_tpu_torch.spatial.celltree import EdgeCellTree2d

            self._celltree = EdgeCellTree2d(self.node_coordinates, self.edge_node_connectivity)
        return self._celltree

    def _locate_nearest(self, facet: str, points: np.ndarray, max_distance=np.inf, device=None) -> np.ndarray:
        if facet == "node":
            return self.locate_nearest_node(points, max_distance, device=device)
        elif facet == "edge":
            return self.locate_nearest_edge(points, max_distance, device=device)
        raise ValueError(f"Expected facet as one of node, edge; received: {facet}")

    @staticmethod
    def _section_coordinates(edges, xy, dim, index, name):
        return section_coordinates_1d(edges, xy, dim, index, name)

    # -- graph edits ---------------------------------------------------------------
    @property
    def is_cyclic(self) -> bool:
        """Whether the directed node graph (first node to second) holds a
        cycle."""
        try:
            self.topological_sort_by_dfs()
            return False
        except ValueError as e:
            if "cycle" in str(e):
                return True
            raise

    def topological_sort_by_dfs(self) -> np.ndarray:
        """The nodes in topological order; raises ValueError on a cycle."""
        return connectivity.topological_sort_by_dfs(self.directed_node_node_connectivity)

    def remove_self_loops(self) -> "Ugrid1d":
        """The network without the edges from a node to itself (and the
        nodes no other edge uses)."""
        a, b = self.edge_node_connectivity.T
        edge_subset = self.edge_node_connectivity[a != b]
        valid = np.bincount(edge_subset.ravel(), minlength=self.n_node) > 0
        return Ugrid1d(
            node_x=self.node_x[valid],
            node_y=self.node_y[valid],
            fill_value=self.fill_value,
            edge_node_connectivity=connectivity.renumber(edge_subset),
            name=self.name,
            indexes=self._indexes,
            is_projected=self.is_projected,
            crs=self.crs,
            attrs=self._attrs,
        )

    def contract_vertices(self, indices: np.ndarray) -> "Ugrid1d":
        """The network simplified to the vertices ``indices``, each joined
        to the next ones it reaches downstream."""
        edges = connectivity.contract_vertices(self.directed_node_node_connectivity, indices)
        node_index = np.unique(edges.ravel())
        return Ugrid1d(
            node_x=self.node_x[node_index],
            node_y=self.node_y[node_index],
            fill_value=self.fill_value,
            edge_node_connectivity=connectivity.renumber(edges),
            name=self.name,
            indexes=self._indexes,
            is_projected=self.is_projected,
            crs=self.crs,
            attrs=self._attrs,
        )

    def refine_by_vertices(self, vertices: np.ndarray, return_index: bool = False, tolerance: Optional[float] = None):
        """
        The network with ``vertices`` (which must lie on its edges)
        inserted as nodes, each edge split at the vertices on it, in
        order along it; vertices that are already nodes are skipped.
        ``return_index`` also returns the new nodes' indices.
        """
        vertices = np.atleast_2d(np.asarray(vertices, dtype=float))
        edge_index = self.celltree.locate_points(vertices, tolerance)
        invalid = edge_index == -1
        if invalid.any():
            raise ValueError(f"The following vertices are not located on any edge:\n{vertices[invalid]}")

        # Drop the vertices that already exist as nodes.
        node_xy = self.node_coordinates
        combined = np.concatenate((node_xy, vertices))
        _, index, inverse = np.unique(combined, return_index=True, return_inverse=True, axis=0)
        index_to_vertices = index[inverse.ravel()][self.n_node :]
        not_duplicated = index_to_vertices >= self.n_node
        new_vertices = vertices[not_duplicated]
        edge_index = edge_index[not_duplicated]

        first_node = self.edge_node_connectivity[edge_index, 0]
        distance = np.linalg.norm(new_vertices - node_xy[first_node], axis=1)
        repeats = np.bincount(np.concatenate((np.arange(self.n_edge), edge_index)))
        new_edges = np.repeat(self.edge_node_connectivity, repeats, axis=0)
        order = np.lexsort((distance, edge_index))
        node_index = np.arange(self.n_node, self.n_node + len(edge_index))[order]

        # Splice: of the sub-edges of a split edge, all but the last end
        # at a new node, and all but the first start at one.
        i = np.arange(len(new_edges))
        mask0 = np.repeat(_alt_cumsum(repeats), repeats)
        mask1 = np.repeat(np.cumsum(repeats), repeats) - 1
        new_edges[i > mask0, 0] = node_index
        new_edges[i < mask1, 1] = node_index

        grid = Ugrid1d(
            np.concatenate((self.node_x, new_vertices[:, 0])),
            np.concatenate((self.node_y, new_vertices[:, 1])),
            self.fill_value,
            new_edges,
            name=self.name,
            is_projected=self.is_projected,
            crs=self.crs,
        )
        self._propagate_properties(grid)
        if return_index:
            return grid, node_index
        return grid

    def to_periodic(self, obj=None):
        """A network is left as it is (for the accessors' symmetry)."""
        if obj is not None:
            return self, obj
        return self

    def to_nonperiodic(self, xmax, obj=None):
        """A network is left as it is (for the accessors' symmetry)."""
        if obj is not None:
            return self, obj
        return self

    # -- subsets -------------------------------------------------------------------
    def isel(self, indexers=None, return_index: bool = False, **indexers_kwargs):
        """The network of a selection by node or edge positions.  An edge
        selection always gives a valid topology; a node selection takes
        the edges it touches, and raises where those hold other nodes."""
        if indexers is None:
            indexers = indexers_kwargs
        elif indexers_kwargs:
            raise ValueError("cannot specify both indexers and keyword arguments")
        invalid = indexers.keys() - self.dims
        if invalid:
            raise ValueError(f"Dimensions {invalid} do not exist. Expected one of {self.dims}")
        indexers = {
            k: as_pandas_index(v if isinstance(v, pd.Index) else np.asarray(v), self.sizes[k])
            for k, v in indexers.items()
        }
        nodedim, edgedim = self.node_dimension, self.edge_dimension

        edge_index = {}
        if nodedim in indexers:
            edge_index[nodedim] = np.unique(self.node_edge_connectivity[indexers[nodedim]].data)
        if edgedim in indexers:
            edge_index[edgedim] = indexers[edgedim]

        edge_index = {
            k: as_pandas_index(v if isinstance(v, pd.Index) else np.asarray(v), self.n_edge)
            for k, v in edge_index.items()
        }
        index = self._precheck(edge_index)
        grid, finalized_indexers = self.topology_subset(index, return_index=True)
        self._postcheck(indexers, finalized_indexers)
        if return_index:
            return grid, finalized_indexers
        return grid

    def _validate_indexer(self, indexer):
        if isinstance(indexer, slice):
            if indexer.step is not None:
                raise ValueError("Ugrid1d does not support steps in slices")
            if indexer.start is not None and indexer.stop is not None and indexer.start >= indexer.stop:
                raise ValueError("slice start should be smaller than slice stop")
        else:
            raise ValueError("Ugrid1d only supports slice indexing")
        return indexer

    def sel(self, obj, x, y):
        """The edges whose midpoint lies in the box of two slices: (the
        subset of ``obj``, the subset network)."""
        x = self._validate_indexer(x)
        y = self._validate_indexer(y)
        xmin, ymin, xmax, ymax = self.bounds
        x0 = x.start if x.start is not None else xmin
        x1 = x.stop if x.stop is not None else np.nextafter(xmax, np.inf)
        y0 = y.start if y.start is not None else ymin
        y1 = y.stop if y.stop is not None else np.nextafter(ymax, np.inf)
        edge_index = np.nonzero(
            (self.edge_x >= x0) & (self.edge_x < x1) & (self.edge_y >= y0) & (self.edge_y < y1)
        )[0]
        grid, indexes = self.topology_subset(edge_index, return_index=True)
        return obj.isel({k: v.to_numpy() for k, v in indexes.items() if k in obj.dims}), grid

    def topology_subset(self, edge_index, return_index: bool = False):
        """The network of a subset of edges, in the order given, with the
        nodes they use, renumbered.  ``return_index`` also returns the
        positions taken per UGRID dimension (pandas Indexes)."""
        if not isinstance(edge_index, pd.Index):
            edge_index = as_pandas_index(edge_index, self.n_edge)
        range_index = pd.RangeIndex(0, self.n_edge)
        if edge_index.size == self.n_edge and edge_index.equals(range_index):
            if return_index:
                indexes = {self.node_dimension: pd.RangeIndex(0, self.n_node), self.edge_dimension: range_index}
                return self, indexes
            return self

        edge_subset = self.edge_node_connectivity[edge_index.to_numpy()]
        node_index = np.unique(edge_subset.ravel())
        grid = Ugrid1d(
            self.node_x[node_index],
            self.node_y[node_index],
            FILL_VALUE,
            connectivity.renumber(edge_subset),
            name=self.name,
            indexes=self._indexes,
            is_projected=self.is_projected,
            crs=self.crs,
            attrs=self._attrs,
        )
        self._propagate_properties(grid)
        if return_index:
            return grid, {self.node_dimension: pd.Index(node_index), self.edge_dimension: edge_index}
        return grid

    def clip_box(self, xmin, ymin, xmax, ymax):
        """The network of the edges whose midpoint lies in the closed box."""
        edge_index = np.nonzero(
            (self.edge_x >= xmin) & (self.edge_x <= xmax) & (self.edge_y >= ymin) & (self.edge_y <= ymax)
        )[0]
        return self.topology_subset(edge_index)

    # -- reindexing and the nearest fill -----------------------------------------------
    def reindex_like(self, other: "Ugrid1d", obj, tolerance: float = 0.0):
        """``obj`` reordered onto ``other``, the same network with its nodes
        and edges permuted: matched by coordinates within ``tolerance``."""
        if not isinstance(other, Ugrid1d):
            raise TypeError(f"Expected Ugrid1d, received: {type(other).__name__}")
        indexers = {
            self.node_dimension: connectivity.index_like(self.node_coordinates, other.node_coordinates, tolerance),
            self.edge_dimension: connectivity.index_like(self.edge_coordinates, other.edge_coordinates, tolerance),
        }
        return obj.isel(indexers, missing_dims="ignore")

    def _nearest_interpolate(self, data: np.ndarray, ugrid_dim: str, max_distance: float, device=None) -> np.ndarray:
        """``data`` (1D float, host) with each NaN replaced by the value of
        the nearest non-NaN node or edge along the network (scipy's
        Dijkstra over edge lengths; NaN beyond ``max_distance``).  Runs
        on the host: ``device`` is accepted for the 2D grid's signature."""
        isnull = np.isnan(data)
        if isnull.all():
            raise ValueError("All values are NA.")

        edge_length = self.edge_length
        if ugrid_dim == self.node_dimension:
            conn = self.node_node_connectivity.copy()
            conn.data = edge_length[conn.data]
        elif ugrid_dim == self.edge_dimension:
            conn = self.edge_edge_connectivity.tocoo()
            conn.data = 0.5 * (edge_length[conn.row] + edge_length[conn.col])
        else:
            raise ValueError(
                f"Expected {self.node_dimension} or {self.edge_dimension}, received instead: {ugrid_dim}"
            )
        _, _, index = dijkstra(
            csgraph=conn,
            indices=np.flatnonzero(~isnull),
            return_predecessors=True,
            limit=max_distance,
            min_only=True,
        )
        found = index != -9999
        out = data.copy()
        out[found] = data[index[found]]
        return out

    # -- partition merge -------------------------------------------------------------
    @staticmethod
    def merge_partitions(grids: Sequence["Ugrid1d"]):
        """The partitions merged into one network, shared nodes and edges
        deduplicated: (network, each partition's positions taken per
        UGRID dimension)."""
        from xugrid_tpu_torch.ugrid import partitioning

        grid = next(iter(grids))
        with timed("merge.nodes"):
            node_coordinates, node_indexes, node_inverse = partitioning.merge_nodes(grids)
        with timed("merge.edges"):
            new_edges, edge_indexes = partitioning.merge_edges(grids, node_inverse)
        merged = Ugrid1d(
            node_coordinates[:, 0],
            node_coordinates[:, 1],
            grid.fill_value,
            new_edges,
            name=grid.name,
            indexes=grid._indexes,
            is_projected=grid.is_projected,
            crs=grid.crs,
            attrs=grid._attrs,
        )
        return merged, {grid.node_dimension: node_indexes, grid.edge_dimension: edge_indexes}
