"""
Ugrid2d: topology of a 2D unstructured mesh (UGRID conventions),
reduced to what the regridders, the Laplace and nearest fills, the
UGRID file round trip, the topology subsets, the partition merge, the
point and line selections, rasterization, the topology operations
(triangulation, voronoi tessellations, periodic conversion, reordering)
and the structured constructors (rectilinear, rotated and curvilinear
coordinates, (N, M, 4) corner bounds) read; the meshkernel bridge
(``mesh``, ``meshkernel``, ``from_meshkernel``, ``refine_polygon``,
``delete_polygon``, ``from_polygon``) imports meshkernel where it is
used, as the JAX package does.

The canonical storage is a padded dense int64 ``face_node_connectivity``
(fill -1, 0-based) plus float64 node x/y; the fill value and start index
of the file it came from are kept and restored on writing.  Face areas,
perimeters, centroids, circumcenters, the derived connectivities, the
triangulations, the voronoi topology, the spatial index and the KDTrees
are computed on first use and cached.
"""

from __future__ import annotations

import warnings
from itertools import chain
from typing import Any, Dict, Optional, Sequence

import numpy as np
import pandas as pd
from scipy.sparse import coo_matrix, csr_matrix
from scipy.sparse.csgraph import reverse_cuthill_mckee

from xugrid_tpu_torch import xdata
from xugrid_tpu_torch.constants import FILL_VALUE, FloatDType, IntDType
from xugrid_tpu_torch.ugrid import connectivity, conventions
from xugrid_tpu_torch.ugrid.selection_utils import section_coordinates_2d
from xugrid_tpu_torch.ugrid.ugridbase import AbstractUgrid, _strip_dim_coords, as_pandas_index, numeric_bound
from xugrid_tpu_torch.utils.device import resolve_device
from xugrid_tpu_torch.utils.profiling import timed


def raster_xy(bounds, resolution: float):
    """Cell centres of a raster of cell size ``resolution`` over ``bounds``
    (xmin, ymin, xmax, ymax), snapped outward to whole cells: (x
    ascending, y descending)."""
    xmin, ymin, xmax, ymax = bounds
    d = abs(resolution)
    xmin = np.floor(xmin / d) * d
    xmax = np.ceil(xmax / d) * d
    ymin = np.floor(ymin / d) * d
    ymax = np.ceil(ymax / d) * d
    return np.arange(xmin + 0.5 * d, xmax, d), np.arange(ymax - 0.5 * d, ymin, -d)


class Ugrid2d(AbstractUgrid):
    """
    Topological data of a 2-D unstructured grid.

    Parameters
    ----------
    node_x, node_y: ndarray of floats
    fill_value: int
        Fill value of the provided face_node_connectivity.
    face_node_connectivity: ndarray of integers, or a CSR/COO matrix
    name: str, default "mesh2d"
        Names the UGRID variables and dimensions: ``{name}_nNodes``,
        ``{name}_nEdges``, ``{name}_nFaces`` by default.
    edge_node_connectivity: ndarray of integers, optional
        A prior edge numbering to keep.
    dataset: xdata.Dataset, optional
        The UGRID variables this grid was read from (``from_dataset``).
    indexes: dict role -> variable name, optional
    is_projected: bool, default True
    crs: Any, optional
    attrs: dict, optional
        UGRID topology attributes overriding the defaults.
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
        self.name = name
        self.crs, self.is_projected = self._validate_crs(crs, is_projected)
        if isinstance(face_node_connectivity, np.ndarray):
            conn = face_node_connectivity.copy()
        elif isinstance(face_node_connectivity, (coo_matrix, csr_matrix)):
            conn = connectivity.to_dense(face_node_connectivity)
        else:
            raise TypeError(
                "face_node_connectivity should be an array of integers or a sparse matrix, "
                f"received: {type(face_node_connectivity).__name__}"
            )
        # Normalize to -1 fill and 0-based indices.
        if fill_value != FILL_VALUE or start_index != 0:
            is_fill = conn == fill_value
            if start_index != 0:
                conn[~is_fill] -= start_index
            if fill_value != FILL_VALUE:
                conn[is_fill] = FILL_VALUE
        self.face_node_connectivity = conn.astype(IntDType, copy=False)
        if edge_node_connectivity is not None:
            edge_node_connectivity = np.asarray(edge_node_connectivity).astype(IntDType) - start_index
        self._edge_node_connectivity = edge_node_connectivity
        self._initialize_indexes_attrs(name, dataset, indexes, attrs)
        self._dataset = dataset
        self._face_edge_connectivity = None
        self._edge_face_connectivity = None
        self._face_face_connectivity = None
        self._node_node_connectivity = None
        self._node_face_connectivity = None
        self._boundary_node_connectivity = None
        self._clear_geometry_properties()

    def _clear_geometry_properties(self):
        """Drop the cached geometry (after the node coordinates change)."""
        self._mesh = None
        self._meshkernel = None
        self._area = None
        self._perimeter = None
        self._centroids = None
        self._circumcenters = None
        self._celltree = None
        self._node_kdtree = None
        self._edge_kdtree = None
        self._face_kdtree = None
        self._edge_x = None
        self._edge_y = None
        self._triangulation = None
        self._voronoi_topology = None
        self._centroid_triangulation = None

    # -- UGRID datasets ----------------------------------------------------------
    @classmethod
    def from_dataset(cls, dataset, topology: Optional[str] = None) -> "Ugrid2d":
        """The 2D UGRID topology ``topology`` of a Dataset (the only one
        when None)."""
        ds = dataset
        if not isinstance(ds, xdata.Dataset):
            raise TypeError(
                "Ugrid2d should be initialized with an xdata.Dataset. "
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

        da = ds[connectivity_names["face_node_connectivity"]]
        fill_value = da.encoding.get("_FillValue", da.attrs.get("_FillValue", -1))
        start_index = da.attrs.get("start_index", 0)
        face_node_connectivity = cls._prepare_connectivity(
            da, fill_value, IntDType, coredim=dimensions["face_dimension"]
        )
        edge_nodes = connectivity_names.get("edge_node_connectivity")
        if edge_nodes:
            eda = ds[edge_nodes]
            edge_node_connectivity = cls._prepare_connectivity(
                eda, fill_value, IntDType, coredim=dimensions["edge_dimension"]
            )
            edge_start_index = eda.attrs.get("start_index", 0)
            if edge_start_index != start_index:
                edge_node_connectivity += start_index - edge_start_index
        else:
            edge_node_connectivity = None

        indexes = {"node_x": x_index, "node_y": y_index}
        for facet in ("edge", "face"):
            facet_coords = coordinates.get(f"{facet}_coordinates")
            if facet_coords is not None:
                indexes[f"{facet}_x"] = facet_coords[0][0]
                indexes[f"{facet}_y"] = facet_coords[1][0]

        crs, is_projected = cls._extract_crs(ds, topology)
        return cls(
            node_x,
            node_y,
            fill_value,
            face_node_connectivity,
            name=topology,
            edge_node_connectivity=edge_node_connectivity,
            dataset=_strip_dim_coords(ds[ugrid_vars]),
            indexes=indexes,
            is_projected=is_projected,
            crs=crs,
            start_index=start_index,
        )

    @classmethod
    def from_meshkernel(cls, mesh, name="mesh2d", is_projected=True, crs=None):
        """A Ugrid2d of a meshkernel Mesh2d object (node_x, node_y,
        edge_nodes, face_nodes, nodes_per_face)."""
        n_face = len(mesh.nodes_per_face)
        n_max = int(mesh.nodes_per_face.max())
        conn = np.full((n_face, n_max), FILL_VALUE, dtype=IntDType)
        isnode = connectivity.ragged_index(n_face, n_max, mesh.nodes_per_face)
        conn[isnode] = mesh.face_nodes
        return cls(
            node_x=mesh.node_x,
            node_y=mesh.node_y,
            fill_value=FILL_VALUE,
            face_node_connectivity=conn,
            edge_node_connectivity=np.reshape(mesh.edge_nodes, (-1, 2)),
            name=name,
            is_projected=is_projected,
            crs=crs,
        )

    def _get_name_and_attrs(self, name: str):
        key = f"{name}_connectivity"
        attrs = dict(conventions.DEFAULT_ATTRS[key])
        if "start_index" in attrs:
            attrs["start_index"] = self.start_index
        if "_FillValue" in attrs:
            attrs["_FillValue"] = self.fill_value
        return self._attrs[key], attrs

    def to_dataset(self, other=None, optional_attributes: bool = False):
        """The UGRID dataset of this grid (merged with ``other``, whose
        variables it then carries): the topology variable, the
        connectivity in the grid's fill value and start index, and the
        node coordinates; with ``optional_attributes`` also every derived
        connectivity and the edge and face coordinates."""
        node_x = self._indexes["node_x"]
        node_y = self._indexes["node_y"]
        face_nodes, face_nodes_attrs = self._get_name_and_attrs("face_node")
        nmax_dim = self._attrs["max_face_nodes_dimension"]
        edge_nodes, edge_nodes_attrs = self._get_name_and_attrs("edge_node")

        ds = xdata.Dataset(attrs={"Conventions": "CF-1.9 UGRID-1.0"})
        if other is not None:
            ds.attrs.update(other.attrs)
        ds[self.name] = ((), np.int32(0))
        ds[face_nodes] = (
            (self.face_dimension, nmax_dim),
            self._adjust_connectivity(self.face_node_connectivity),
            face_nodes_attrs,
        )
        if self._edge_node_connectivity is not None or optional_attributes:
            ds[edge_nodes] = (
                (self.edge_dimension, "two"),
                self._adjust_connectivity(self.edge_node_connectivity),
                edge_nodes_attrs,
            )
        if optional_attributes:
            boundary_edge_dim = self._attrs["boundary_edge_dimension"]
            optional = (
                ("face_edge", (self.face_dimension, nmax_dim), self.face_edge_connectivity),
                (
                    "face_face",
                    (self.face_dimension, nmax_dim),
                    connectivity.to_dense(self.face_face_connectivity, self.n_max_node_per_face),
                ),
                ("edge_face", (self.edge_dimension, "two"), self.edge_face_connectivity),
                ("boundary_node", (boundary_edge_dim, "two"), self.boundary_node_connectivity),
            )
            for role, dims, conn in optional:
                varname, attrs = self._get_name_and_attrs(role)
                ds[varname] = (dims, self._adjust_connectivity(conn), attrs)

        if self._dataset:
            ds = ds.merge(self._dataset, compat="override")
        if other is not None:
            ds = ds.merge(other, compat="override")
        if node_x not in ds._variables or node_y not in ds._variables:
            ds = self.assign_node_coords(ds)
        if optional_attributes:
            ds = self.assign_face_coords(ds)
            ds = self.assign_edge_coords(ds)

        ds._variables[self.name].attrs = self._filtered_attrs(ds)
        return self.write_grid_mapping(ds)

    @staticmethod
    def topology_dataset(node_x, node_y, face_node_connectivity, name="mesh2d"):
        """The minimal UGRID dataset of raw topology arrays."""
        return Ugrid2d(node_x, node_y, FILL_VALUE, face_node_connectivity, name=name).to_dataset()

    # -- sizes and dimension names ---------------------------------------------
    @property
    def n_face(self) -> int:
        return len(self.face_node_connectivity)

    @property
    def n_max_node_per_face(self) -> int:
        """Maximum number of nodes a face can contain."""
        return self.face_node_connectivity.shape[1]

    @property
    def n_node_per_face(self) -> np.ndarray:
        return (self.face_node_connectivity != FILL_VALUE).sum(axis=1)

    @property
    def face_dimension(self) -> str:
        return self._attrs["face_dimension"]

    @property
    def max_face_node_dimension(self) -> str:
        return self._attrs["max_face_nodes_dimension"]

    @property
    def max_connectivity_sizes(self) -> dict:
        return {self.max_face_node_dimension: self.n_max_node_per_face}

    @property
    def max_connectivity_dimensions(self) -> tuple:
        return (self.max_face_node_dimension,)

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
    def sizes(self) -> dict:
        return {self.node_dimension: self.n_node, self.edge_dimension: self.n_edge, self.face_dimension: self.n_face}

    def get_coordinates(self, dim: str) -> np.ndarray:
        """(n, 2) coordinates of the entities of a UGRID dimension: nodes,
        edge midpoints or face centroids."""
        if dim == self.node_dimension:
            return self.node_coordinates
        elif dim == self.edge_dimension:
            return self.edge_coordinates
        elif dim == self.face_dimension:
            return self.face_coordinates
        raise ValueError(
            f"Expected {self.node_dimension}, {self.edge_dimension}, or {self.face_dimension}; got: {dim}"
        )

    # -- vector conversion ---------------------------------------------------------
    @staticmethod
    def earcut_triangulate_polygons(polygons, return_index: bool = False):
        """Triangulate (shapely) polygons and build a mesh of the result."""
        from xugrid_tpu_torch.ugrid.burn import grid_from_earcut_polygons

        return grid_from_earcut_polygons(polygons, return_index=return_index)

    @classmethod
    def from_geodataframe(cls, geodataframe) -> "Ugrid2d":
        """Convert a geopandas GeoDataFrame of polygons to Ugrid2d."""
        import geopandas as gpd

        if not isinstance(geodataframe, gpd.GeoDataFrame):
            raise TypeError(f"Expected GeoDataFrame, received: {type(geodataframe).__name__}")
        return cls.from_shapely(geodataframe.geometry.to_numpy(), crs=geodataframe.crs)

    @staticmethod
    def from_shapely(geometry, crs=None) -> "Ugrid2d":
        """Convert an array of shapely polygons to Ugrid2d."""
        import shapely

        from xugrid_tpu_torch import conversion

        if not (shapely.get_type_id(geometry) == shapely.GeometryType.POLYGON).all():
            raise TypeError(
                "Can only create Ugrid2d from shapely Polygon geometries, "
                "geometry contains other types of geometries."
            )
        x, y, face_node_connectivity = conversion.polygons_to_faces(geometry)
        return Ugrid2d(x, y, FILL_VALUE, face_node_connectivity, crs=crs)

    def to_shapely(self, dim: str):
        """Convert a facet to shapely points/linestrings/polygons."""
        from xugrid_tpu_torch import conversion

        if dim == self.face_dimension:
            return conversion.faces_to_polygons(self.node_x, self.node_y, self.face_node_connectivity)
        elif dim == self.node_dimension:
            return conversion.nodes_to_points(self.node_x, self.node_y)
        elif dim == self.edge_dimension:
            return conversion.edges_to_linestrings(self.node_x, self.node_y, self.edge_node_connectivity)
        raise ValueError(
            f"Dimension {dim} is not a face, node, or edge dimension of "
            "the Ugrid2d topology."
        )

    def bounding_polygon(self):
        """The exterior boundary polygon of the grid (shapely)."""
        import shapely

        def _bbox_area(bounds):
            return (bounds[2] - bounds[0]) * (bounds[3] - bounds[1])

        edges = self.node_coordinates[self.boundary_node_connectivity]
        collection = shapely.polygonize(shapely.linestrings(edges))
        return max(collection.geoms, key=lambda geom: _bbox_area(geom.bounds))

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
    def from_structured_intervals2d(x_intervals, y_intervals, name="mesh2d") -> "Ugrid2d":
        """Ugrid2d from 2D (curvilinear) interval breaks, (ny + 1, nx + 1)
        each."""
        x_intervals = np.asarray(x_intervals)
        y_intervals = np.asarray(y_intervals)
        if x_intervals.ndim != 2 or y_intervals.ndim != 2:
            raise ValueError("Dimensions of intervals must be 2D.")
        if x_intervals.shape != y_intervals.shape:
            raise ValueError(
                "Interval shapes must match. Found: "
                f"x_intervals: {x_intervals.shape}, versus y_intervals: "
                f"{y_intervals.shape}"
            )
        ny = x_intervals.shape[0] - 1
        nx = x_intervals.shape[1] - 1
        return Ugrid2d._from_intervals_helper(x_intervals.ravel(), y_intervals.ravel(), nx, ny, name)

    @staticmethod
    def from_structured_bounds(x_bounds, y_bounds, name="mesh2d", return_index: bool = False):
        """
        Ugrid2d from cell bounds: (nx, 2) and (ny, 2) interval bounds,
        monotonic ascending or descending (face k is cell (k // nx, k %
        nx) in the bounds' own order), or (N, M, 4) corner bounds of a
        curvilinear grid, whose NaN-masked and degenerate cells are
        dropped (``conversion.bounds2d_to_topology2d``).
        ``return_index`` also returns the cells kept: a boolean mask of
        the N * M cells, or ``slice(None, None)`` for interval bounds.
        """
        from xugrid_tpu_torch import conversion

        x_bounds = np.asarray(x_bounds)
        y_bounds = np.asarray(y_bounds)
        ndim = x_bounds.ndim
        if ndim == 2:
            nx = x_bounds.shape[0]
            ny = y_bounds.shape[0]
            x = conversion.bounds1d_to_vertices(x_bounds)
            y = conversion.bounds1d_to_vertices(y_bounds)
            node_y, node_x = (a.ravel() for a in np.meshgrid(y, x, indexing="ij"))
            grid = Ugrid2d._from_intervals_helper(node_x, node_y, nx, ny, name)
            index = slice(None, None)
        elif ndim == 3:
            if x_bounds.shape != y_bounds.shape:
                raise ValueError(f"Bounds shapes do not match: {x_bounds.shape} versus {y_bounds.shape}")
            x, y, face_node_connectivity, index = conversion.bounds2d_to_topology2d(x_bounds, y_bounds)
            grid = Ugrid2d(x, y, FILL_VALUE, face_node_connectivity, name=name)
        else:
            raise ValueError(f"Expected 2 or 3 dimensions on bounds, received: {ndim}")
        if return_index:
            return grid, index
        return grid

    @staticmethod
    def _from_structured_singlecoord(data, x=None, y=None, name="mesh2d") -> "Ugrid2d":
        from xugrid_tpu_torch import conversion

        if x is None or y is None:
            x, y = conversion.infer_xy_coords(data)
            if x is None or y is None:
                raise ValueError("Could not infer bounds. Please provide x and y explicitly.")
        x_intervals = conversion.infer_interval_breaks1d(data, x)
        y_intervals = conversion.infer_interval_breaks1d(data, y)
        return Ugrid2d.from_structured_intervals1d(x_intervals, y_intervals, name)

    @staticmethod
    def _from_structured_multicoord(data, x, y, name="mesh2d") -> "Ugrid2d":
        from xugrid_tpu_torch import conversion

        xv = conversion.infer_interval_breaks(np.asarray(data[x].data), axis=1, check_monotonic=True)
        xv = conversion.infer_interval_breaks(xv, axis=0)
        yv = conversion.infer_interval_breaks(np.asarray(data[y].data), axis=1)
        yv = conversion.infer_interval_breaks(yv, axis=0, check_monotonic=True)
        return Ugrid2d.from_structured_intervals2d(xv, yv, name)

    @staticmethod
    def from_structured_multicoord(data, x=None, y=None, name="mesh2d") -> "Ugrid2d":
        """Deprecated: ``from_structured``."""
        warnings.warn(
            "Ugrid2d.from_structured_multicoord has been deprecated. "
            "Use Ugrid2d.from_structured instead.",
            FutureWarning,
        )
        return Ugrid2d.from_structured(data, x, y, name)

    @staticmethod
    def from_structured(data, x=None, y=None, name="mesh2d", return_dims=False):
        """
        Ugrid2d from a structured DataArray or Dataset: rectilinear (1D x
        and y coordinates) or rotated and curvilinear (2D x and y
        coordinates, their interval breaks inferred along both axes).
        x and y name the coordinates, inferred when not given;
        ``return_dims`` also returns the (y, x) dimensions.
        """
        from xugrid_tpu_torch import conversion

        if (x is None) ^ (y is None):
            raise ValueError("Provide both x and y, or neither.")
        if x is None:
            x, y = conversion.infer_xy_coords(data)
            if x is None or y is None:
                raise ValueError("Could not infer bounds. Please provide x and y explicitly.")
        else:
            coords = set(data.coords)
            missing = {x, y} - coords
            if missing:
                raise ValueError(f"Coordinates {x} and {y} are not present, expected one of: {coords}")
        ndim = data[x].ndim
        if ndim == 1:
            grid = Ugrid2d._from_structured_singlecoord(data, x=x, y=y, name=name)
            dims = (data[y].dims[0], data[x].dims[0])
        elif ndim == 2:
            grid = Ugrid2d._from_structured_multicoord(data, x=x, y=y, name=name)
            dims = tuple(data[x].dims)
        else:
            raise ValueError(f"x and y must be 1D or 2D. Found: {ndim}")
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
    def boundary_node_connectivity(self) -> np.ndarray:
        """(n_boundary_edge, 2) node pairs of the boundary edges."""
        if self._boundary_node_connectivity is None:
            self._boundary_node_connectivity = connectivity.boundary_node_connectivity(
                self.edge_face_connectivity, self.edge_node_connectivity
            )
        return self._boundary_node_connectivity

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

    def validate_edge_node_connectivity(self) -> np.ndarray:
        """Per edge: whether the faces define it and it is not a duplicate."""
        return connectivity.validate_edge_node_connectivity(self.face_node_connectivity, self.edge_node_connectivity)

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
    def circumcenters(self) -> np.ndarray:
        """(n_face, 2) circumcenter per face (triangles only)."""
        if self._circumcenters is None:
            self._circumcenters = connectivity.circumcenters(
                self.face_node_connectivity, self.node_x, self.node_y
            )
        return self._circumcenters

    @property
    def perimeter(self) -> np.ndarray:
        """Perimeter of every face."""
        if self._perimeter is None:
            self._perimeter = connectivity.perimeter(
                self.face_node_connectivity, self.node_x, self.node_y
            )
        return self._perimeter

    @property
    def face_bounds(self) -> np.ndarray:
        """(n_face, 4): minx, miny, maxx, maxy per face."""
        from xugrid_tpu_torch.spatial.bvh import face_bounding_boxes

        return face_bounding_boxes(self.face_node_connectivity, self.node_x, self.node_y)

    @property
    def face_x(self) -> np.ndarray:
        """x-coordinate of the face centroids."""
        return self.centroids[:, 0]

    @property
    def face_y(self) -> np.ndarray:
        """y-coordinate of the face centroids."""
        return self.centroids[:, 1]

    @property
    def face_coordinates(self) -> np.ndarray:
        """(n_face, 2) face centroids."""
        return self.centroids

    @property
    def face_node_coordinates(self) -> np.ndarray:
        """(n_face, n_max_node, 2) vertex coordinates; NaN in the fill slots."""
        coords = np.full((self.n_face, self.n_max_node_per_face, 2), np.nan, dtype=FloatDType)
        is_node = self.face_node_connectivity != FILL_VALUE
        coords[is_node, :] = self.node_coordinates[self.face_node_connectivity[is_node]]
        return coords

    @property
    def exterior_edges(self) -> np.ndarray:
        """Indices of the edges bordering one face."""
        return np.nonzero(self.edge_face_connectivity[:, 1] == FILL_VALUE)[0]

    @property
    def exterior_faces(self) -> np.ndarray:
        """Indices of the faces with at least one exterior edge."""
        exterior_faces = self.edge_face_connectivity[self.exterior_edges].ravel()
        return np.unique(exterior_faces[exterior_faces != FILL_VALUE])

    # -- triangulations and the voronoi topology -----------------------------------
    @property
    def triangulation(self):
        """((node_x, node_y, triangles), triangle_face_connectivity): the
        faces fanned from their first node."""
        if self._triangulation is None:
            triangles, triangle_face = connectivity.triangulate(self.face_node_connectivity)
            self._triangulation = ((self.node_x, self.node_y, triangles), triangle_face)
        return self._triangulation

    @property
    def voronoi_topology(self):
        """(vertices, face_node_connectivity, face_index) of the centroidal
        voronoi tessellation with its exterior: one cell per node.  Its
        angle sort of a large table runs on the CUDA card
        (``voronoi.angle_sort_rows``)."""
        from xugrid_tpu_torch.ugrid.voronoi import voronoi_topology

        if self._voronoi_topology is None:
            vertices, faces, face_index, _ = voronoi_topology(
                self.node_face_connectivity,
                self.node_coordinates,
                self.centroids,
                self.edge_face_connectivity,
                self.edge_node_connectivity,
                add_exterior=True,
                add_vertices=False,
                device=None,
            )
            self._voronoi_topology = vertices, faces, face_index
        return self._voronoi_topology

    @property
    def centroid_triangulation(self):
        """((x, y, triangles), face_index): the voronoi topology's cells
        fanned into triangles over the face centroids, for contouring face
        data."""
        if self._centroid_triangulation is None:
            nodes, faces, face_index = self.voronoi_topology
            triangles, _ = connectivity.triangulate(faces)
            triangulation = (nodes[:, 0].copy(), nodes[:, 1].copy(), triangles)
            self._centroid_triangulation = (triangulation, face_index)
        return self._centroid_triangulation

    def assign_face_coords(self, obj):
        """``obj`` with this grid's face centroids as coordinates."""
        return self._assign_coords(obj, "face", self.face_x, self.face_y, self.face_dimension)

    def _assign_derived_coords(self, obj):
        """``obj`` with the node, edge and face coordinates of the facets
        it spans."""
        obj = super()._assign_derived_coords(obj)
        if self.face_dimension in obj.dims:
            obj = self.assign_face_coords(obj)
        return obj

    @property
    def celltree(self):
        """The spatial index over the faces."""
        if self._celltree is None:
            from xugrid_tpu_torch.spatial.celltree import CellTree2d

            self._celltree = CellTree2d(
                self.node_coordinates, self.face_node_connectivity, FILL_VALUE
            )
        return self._celltree

    # -- meshkernel (optional; imported where it is used) -------------------------
    @property
    def mesh(self):
        """meshkernel Mesh2d view of this topology (requires meshkernel)."""
        import meshkernel as mk

        if self._mesh is None:
            is_node = self.face_node_connectivity != FILL_VALUE
            self._mesh = mk.Mesh2d(
                node_x=self.node_x,
                node_y=self.node_y,
                edge_nodes=self.edge_node_connectivity.ravel().astype(np.int32),
                face_nodes=self.face_node_connectivity[is_node].ravel().astype(np.int32),
                nodes_per_face=is_node.sum(axis=1).astype(np.int32),
            )
        return self._mesh

    @mesh.setter
    def mesh(self, value):
        self._mesh = value

    @property
    def meshkernel(self):
        """meshkernel MeshKernel instance for this topology (requires
        meshkernel)."""
        import meshkernel as mk

        if self._meshkernel is None:
            projection = mk.ProjectionType.SPHERICAL if self.is_geographic else mk.ProjectionType.CARTESIAN
            self._meshkernel = mk.MeshKernel(projection)
            self._meshkernel.mesh2d_set(self.mesh)
        return self._meshkernel

    def _initialize_mesh_kernel(self):
        _ = self.meshkernel

    def refine_polygon(
        self,
        polygon,
        min_face_size: float,
        refine_intersected: bool = True,
        use_mass_center_when_refining: bool = True,
        refinement_type: str = "refinement_levels",
        connect_hanging_nodes: bool = True,
        account_for_samples_outside_face: bool = True,
        max_refinement_iterations: int = 10,
    ):
        """Refine the faces inside a shapely polygon with meshkernel."""
        import meshkernel as mk

        from xugrid_tpu_torch import meshkernel_utils as mku

        geometry_list = mku.to_geometry_list(polygon)
        refinement_type = mku.either_string_or_enum(refinement_type, mk.RefinementType)
        self._initialize_mesh_kernel()
        params = mk.MeshRefinementParameters(
            refine_intersected,
            use_mass_center_when_refining,
            min_face_size,
            refinement_type,
            connect_hanging_nodes,
            account_for_samples_outside_face,
            max_refinement_iterations,
        )
        self._meshkernel.mesh2d_refine_based_on_polygon(geometry_list, params)

    def delete_polygon(
        self,
        polygon,
        delete_option: str = "all_face_circumenters",
        invert_deletion: bool = False,
    ):
        """Delete the part of the mesh inside a shapely polygon with
        meshkernel."""
        import meshkernel as mk

        from xugrid_tpu_torch import meshkernel_utils as mku

        geometry_list = mku.to_geometry_list(polygon)
        delete_option = mku.either_string_or_enum(delete_option, mk.DeleteMeshOption)
        self._initialize_mesh_kernel()
        self._meshkernel.mesh2d_delete(geometry_list, delete_option, invert_deletion)

    @staticmethod
    def from_polygon(polygon):
        """A mesh of a shapely polygon, made by meshkernel."""
        import meshkernel as mk

        from xugrid_tpu_torch import meshkernel_utils as mku

        geometry_list = mku.to_geometry_list(polygon)
        kernel = mk.MeshKernel()
        kernel.mesh2d_make_mesh_from_polygon(geometry_list)
        mesh = kernel.mesh2d_get()
        ugrid = Ugrid2d.from_meshkernel(mesh)
        ugrid._meshkernel = kernel
        return ugrid

    # -- point queries -----------------------------------------------------------
    def locate_points(self, points: np.ndarray, tolerance: Optional[float] = None) -> np.ndarray:
        """Index of the face holding each point (-1 outside)."""
        return self.celltree.locate_points(points, tolerance)

    def compute_barycentric_weights(self, points: np.ndarray, tolerance: Optional[float] = None, device=None):
        """Face holding each point and the mean-value weights of its
        nodes: (face_index (n,), weights (n, n_max_node)).  Faces above
        the native kernel's 64 nodes are weighed on ``device``."""
        return self.celltree.compute_barycentric_weights(points, tolerance, device=device)

    @property
    def face_kdtree(self):
        """scipy KDTree over the face centroids, built on first use."""
        if self._face_kdtree is None:
            from scipy.spatial import KDTree

            self._face_kdtree = KDTree(self.face_coordinates)
        return self._face_kdtree

    def locate_nearest_face(self, points: np.ndarray, max_distance: float = np.inf, device=None) -> np.ndarray:
        """Nearest face (by centroid) per point; -1 beyond ``max_distance``."""
        from xugrid_tpu_torch.spatial.nearest import nearest_points

        return nearest_points(self.face_coordinates, points, max_distance, tree=self.face_kdtree, device=device)

    def _locate_nearest(self, facet: str, points: np.ndarray, max_distance=np.inf, device=None) -> np.ndarray:
        if facet == "node":
            return self.locate_nearest_node(points, max_distance, device=device)
        elif facet == "edge":
            return self.locate_nearest_edge(points, max_distance, device=device)
        elif facet == "face":
            return self.locate_nearest_face(points, max_distance, device=device)
        raise ValueError(f"Expected facet as one of node, edge, face; received: {facet}")

    @staticmethod
    def _section_coordinates(edges, xy, dim, index, name):
        return section_coordinates_2d(edges, xy, dim, index, name)

    # -- rasterization ------------------------------------------------------------
    def rasterize_like(self, x: np.ndarray, y: np.ndarray):
        """The face holding each point of the raster of x and y cell
        centres: (x, y, index (y.size, x.size), -1 outside)."""
        yy, xx = np.meshgrid(y, x, indexing="ij")
        nodes = np.column_stack([xx.ravel(), yy.ravel()])
        index = self.celltree.locate_points(nodes).reshape((y.size, x.size))
        return x, y, index

    def rasterize(self, resolution: float, bounds: Optional[tuple] = None):
        """``rasterize_like`` on a raster of cell size ``resolution`` over
        ``bounds`` (the grid's by default)."""
        return self.rasterize_like(*raster_xy(self.bounds if bounds is None else bounds, resolution))

    # -- subsets -------------------------------------------------------------------
    def locate_bounding_box(self, xmin, ymin, xmax, ymax) -> np.ndarray:
        """Faces whose centroid lies in the half-open bounding box."""
        return np.nonzero(
            (self.face_x >= xmin) & (self.face_x < xmax) & (self.face_y >= ymin) & (self.face_y < ymax)
        )[0]

    def topology_subset(self, face_index, return_index: bool = False):
        """
        The topology of a subset of faces, in the order given, with the
        nodes (and edges, where this grid has them) they use, renumbered.
        ``return_index`` also returns the positions taken per UGRID
        dimension (pandas Indexes).
        """
        if not isinstance(face_index, pd.Index):
            face_index = as_pandas_index(face_index, self.n_face)

        range_index = pd.RangeIndex(0, self.n_face)
        if face_index.size == self.n_face and face_index.equals(range_index):
            if return_index:
                indexes = {
                    self.node_dimension: pd.RangeIndex(0, self.n_node),
                    self.edge_dimension: pd.RangeIndex(0, self.n_edge),
                    self.face_dimension: range_index,
                }
                return self, indexes
            return self

        index = face_index.to_numpy()
        face_subset = self.face_node_connectivity[index]
        node_index = np.unique(face_subset.ravel())
        node_index = node_index[node_index != FILL_VALUE]
        new_faces = connectivity.renumber(face_subset)

        edge_index = None
        new_edges = None
        if self._edge_node_connectivity is not None:
            edge_index = np.unique(self.face_edge_connectivity[index].ravel())
            edge_index = edge_index[edge_index != FILL_VALUE]
            new_edges = connectivity.renumber(self.edge_node_connectivity[edge_index])

        grid = Ugrid2d(
            self.node_x[node_index],
            self.node_y[node_index],
            FILL_VALUE,
            new_faces,
            name=self.name,
            edge_node_connectivity=new_edges,
            indexes=self._indexes,
            is_projected=self.is_projected,
            crs=self.crs,
            attrs=self._attrs,
        )
        self._propagate_properties(grid)
        if return_index:
            indexes = {self.node_dimension: pd.Index(node_index), self.face_dimension: face_index}
            if edge_index is not None:
                indexes[self.edge_dimension] = pd.Index(edge_index)
            return grid, indexes
        return grid

    def clip_box(self, xmin, ymin, xmax, ymax):
        """The topology of the faces whose centroid lies in the box."""
        return self.topology_subset(self.locate_bounding_box(xmin, ymin, xmax, ymax))

    def isel(self, indexers=None, return_index: bool = False, **indexers_kwargs):
        """
        The topology of a selection by node, edge or face positions.  A
        face selection always gives a valid topology; a node or edge
        selection takes the faces they touch, and raises where those
        faces hold other nodes or edges than the ones selected.
        """
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
        nodedim, edgedim, facedim = self.node_dimension, self.edge_dimension, self.face_dimension

        face_index = {}
        if nodedim in indexers:
            face_index[nodedim] = np.unique(self.node_face_connectivity[indexers[nodedim]].data)
        if edgedim in indexers:
            index = np.unique(self.edge_face_connectivity[indexers[edgedim]])
            face_index[edgedim] = index[index != FILL_VALUE]
        if facedim in indexers:
            face_index[facedim] = indexers[facedim]

        face_index = {
            k: as_pandas_index(v if isinstance(v, pd.Index) else np.asarray(v), self.n_face)
            for k, v in face_index.items()
        }
        index = self._precheck(face_index)
        grid, finalized_indexers = self.topology_subset(index, return_index=True)
        self._postcheck(indexers, finalized_indexers)
        if return_index:
            return grid, finalized_indexers
        return grid

    def _validate_indexer(self, indexer):
        if isinstance(indexer, slice):
            s = indexer
            if s.start is not None and s.stop is not None:
                if s.start >= s.stop:
                    raise ValueError(
                        f"slice stop should be larger than slice start, received: start: {s.start}, stop: {s.stop}"
                    )
                if s.step is not None:
                    indexer = np.arange(s.start, s.stop, s.step)
            elif s.step is not None:
                raise ValueError("step should be None if slice start or stop is None")
        else:
            if isinstance(indexer, xdata.DataArray):
                indexer = indexer.values
            if isinstance(indexer, (list, np.ndarray, int, float)):
                indexer = np.atleast_1d(indexer)
            else:
                raise TypeError(
                    f"Invalid indexer type: {type(indexer).__name__}, allowed types: integer, float, list, "
                    "numpy array, DataArray"
                )
            if indexer.ndim > 1:
                raise ValueError("index should be 0d or 1d")
        return indexer

    def _sel_box(self, obj, x: slice, y: slice):
        xmin, ymin, xmax, ymax = self.bounds
        face_index = self.locate_bounding_box(
            numeric_bound(x.start, xmin),
            numeric_bound(y.start, ymin),
            numeric_bound(x.stop, xmax),
            numeric_bound(y.stop, ymax),
        )
        grid, indexes = self.topology_subset(face_index, return_index=True)
        return obj.isel({k: v.to_numpy() for k, v in indexes.items() if k in obj.dims}), grid

    # -- reindexing and the nearest fill -----------------------------------------------
    def reindex_like(self, other: "Ugrid2d", obj, tolerance: float = 0.0):
        """``obj`` reordered onto ``other``, the same topology with its
        nodes, faces (and edges, where ``other`` has them) permuted:
        matched by coordinates within ``tolerance``."""
        if not isinstance(other, Ugrid2d):
            raise TypeError(f"Expected Ugrid2d, received: {type(other).__name__}")
        indexers = {
            self.node_dimension: connectivity.index_like(self.node_coordinates, other.node_coordinates, tolerance),
            self.face_dimension: connectivity.index_like(self.centroids, other.centroids, tolerance),
        }
        if other._edge_node_connectivity is not None:
            indexers[self.edge_dimension] = connectivity.index_like(
                self.edge_coordinates, other.edge_coordinates, tolerance
            )
        return obj.isel(indexers, missing_dims="ignore")

    def _nearest_interpolate(self, data: np.ndarray, ugrid_dim: str, max_distance: float, device=None) -> np.ndarray:
        """``data`` (1D float, host) with each NaN replaced by the value of
        the nearest non-NaN entity of ``ugrid_dim`` (NaN beyond
        ``max_distance``); the search may run on ``device``
        (``spatial/nearest.py``)."""
        from xugrid_tpu_torch.spatial.nearest import nearest_points

        coordinates = self.get_coordinates(ugrid_dim)
        isnull = np.isnan(data)
        if isnull.all():
            raise ValueError("All values are NA.")
        i_source = np.flatnonzero(~isnull)
        i_target = np.flatnonzero(isnull)
        index = nearest_points(coordinates[i_source], coordinates[i_target], max_distance, device=device)
        keep = index >= 0
        out = data.copy()
        out[i_target[keep]] = data[i_source[index[keep]]]
        return out

    # -- periodic conversion -------------------------------------------------------
    def to_periodic(self, obj=None):
        """
        The grid with its rightmost nodes merged into the leftmost ones
        (a global grid that wraps around): the boundary nodes are paired
        by their y coordinates, and the lower id of each pair survives.
        With ``obj``, also ``obj`` aligned on the new grid (its node and
        edge payloads taken at the survivors, on the payload's device).
        """
        xmin, _, xmax, _ = self.bounds
        coordinates = self.node_coordinates
        is_right = np.isclose(coordinates[:, 0], xmax)
        is_left = np.isclose(coordinates[:, 0], xmin)
        node_y = coordinates[:, 1]
        left_ids = np.flatnonzero(is_left)
        right_ids = np.flatnonzero(is_right)
        left_sorted = left_ids[np.argsort(node_y[left_ids], kind="stable")]
        right_sorted = right_ids[np.argsort(node_y[right_ids], kind="stable")]
        if len(left_sorted) != len(right_sorted) or not np.allclose(node_y[left_sorted], node_y[right_sorted]):
            raise ValueError("y-coordinates of the left and right boundaries do not match")

        survivor = np.minimum(left_sorted, right_sorted)
        dropped = np.maximum(left_sorted, right_sorted)
        remap = np.arange(self.n_node)
        remap[dropped] = survivor
        keep = np.ones(self.n_node, dtype=bool)
        keep[dropped] = False
        node_index = np.flatnonzero(keep)
        new_of_old = np.full(self.n_node, FILL_VALUE, dtype=IntDType)
        new_of_old[node_index] = np.arange(len(node_index))
        full_map = new_of_old[remap]

        fnc = self.face_node_connectivity
        new_faces = np.where(fnc == FILL_VALUE, FILL_VALUE, full_map[np.maximum(fnc, 0)]).astype(IntDType)
        new_xy = coordinates[node_index].copy()
        # Survivors that sat on the right boundary move to x = xmin.
        new_xy[np.isclose(new_xy[:, 0], xmax), 0] = xmin

        new_edges = None
        edge_index = None
        if self._edge_node_connectivity is not None:
            mapped = np.sort(remap[self.edge_node_connectivity], axis=1)
            # The boundary edges that now coincide: the first of each
            # pair survives, in the original order.
            key = mapped[:, 0].astype(np.int64) * self.n_node + mapped[:, 1]
            _, edge_index = np.unique(key, return_index=True)
            edge_index.sort()
            new_edges = full_map[mapped[edge_index]]

        new = Ugrid2d(
            new_xy[:, 0],
            new_xy[:, 1],
            FILL_VALUE,
            new_faces,
            name=self.name,
            edge_node_connectivity=new_edges,
            indexes=self._indexes,
            is_projected=self.is_projected,
            crs=self.crs,
            attrs=self.attrs,
        )
        self._propagate_properties(new)
        if obj is not None:
            indexes = {
                self.face_dimension: pd.RangeIndex(0, self.n_face),
                self.node_dimension: pd.Index(node_index),
            }
            if edge_index is not None:
                indexes[self.edge_dimension] = pd.Index(edge_index)
            indexes = {k: v.to_numpy() for k, v in indexes.items() if k in obj.dims}
            return new, obj.isel(indexes)
        return new

    def to_nonperiodic(self, xmax: float, obj=None):
        """
        The periodic grid split at its shared boundary: the nodes of the
        faces that wrap around (spanning over half the domain in x) are
        duplicated at x = ``xmax``.  With ``obj``, also ``obj`` aligned on
        the new grid (each new node and edge takes its periodic
        counterpart's value, on the payload's device).
        """
        xleft, _, xright, _ = self.bounds
        half_domain = 0.5 * (xright - xleft)
        x = self.face_node_coordinates[..., 0]
        with np.errstate(invalid="ignore"):
            is_periodic = (np.nanmax(x, axis=1)[:, np.newaxis] - x) > half_domain
        periodic_nodes = self.face_node_connectivity[is_periodic]

        uniques, new_nodes = np.unique(periodic_nodes, return_inverse=True)
        new_x = np.full(uniques.size, xmax)
        new_y = self.node_y[uniques]
        new_faces = self.face_node_connectivity.copy()
        new_faces[is_periodic] = new_nodes + self.n_node

        new = Ugrid2d(
            np.concatenate((self.node_x, new_x)),
            np.concatenate((self.node_y, new_y)),
            FILL_VALUE,
            new_faces,
            name=self.name,
            edge_node_connectivity=None,
            indexes=self._indexes,
            is_projected=self.is_projected,
            crs=self.crs,
            attrs=self.attrs,
        )
        self._propagate_properties(new)

        edge_index = None
        if self._edge_node_connectivity is not None:
            # Each new edge's periodic counterpart, by its sorted (old
            # node) pair packed into one key.
            def pack(pairs):
                s = np.sort(pairs, axis=1)
                return s[:, 0].astype(np.int64) << 32 | s[:, 1].astype(np.uint32)

            old_keys = pack(self.edge_node_connectivity)
            mapping = np.concatenate((np.arange(self.n_node), uniques))
            new_keys = pack(mapping[new.edge_node_connectivity])
            order = np.argsort(old_keys)
            position = np.searchsorted(old_keys, new_keys, sorter=order)
            edge_index = order[np.clip(position, 0, old_keys.size - 1)]
            if not np.array_equal(old_keys[edge_index], new_keys):
                raise ValueError(
                    "Cannot map edge-associated data onto the non-periodic "
                    "grid: the new grid has edges with no counterpart in "
                    "the periodic grid (degenerate periodic topology)."
                )

        if obj is not None:
            indexes = {
                self.face_dimension: pd.RangeIndex(0, self.n_face),
                self.node_dimension: pd.Index(np.concatenate((np.arange(self.n_node), uniques))),
            }
            if edge_index is not None:
                indexes[self.edge_dimension] = pd.Index(edge_index)
            indexes = {k: v.to_numpy() for k, v in indexes.items() if k in obj.dims}
            return new, obj.isel(indexes)
        return new

    # -- tessellation and reordering ---------------------------------------------------
    def triangulate(self) -> "Ugrid2d":
        """The grid of the faces fanned into triangles from their first node."""
        triangles, _ = connectivity.triangulate(self.face_node_connectivity)
        grid = Ugrid2d(self.node_x, self.node_y, FILL_VALUE, triangles)
        self._propagate_properties(grid)
        return grid

    def _tesselate_voronoi(self, centroids, add_exterior, add_vertices, skip_concave, device):
        from xugrid_tpu_torch.ugrid.voronoi import voronoi_topology

        device = resolve_device(None, device)

        if add_exterior:
            edge_face_connectivity = self.edge_face_connectivity
            edge_node_connectivity = self.edge_node_connectivity
        else:
            edge_face_connectivity = None
            edge_node_connectivity = None
        vertices, faces, _, _ = voronoi_topology(
            self.node_face_connectivity,
            self.node_coordinates,
            centroids,
            edge_face_connectivity,
            edge_node_connectivity,
            add_exterior,
            add_vertices,
            skip_concave,
            device=device,
        )
        grid = Ugrid2d(vertices[:, 0], vertices[:, 1], FILL_VALUE, faces)
        self._propagate_properties(grid)
        return grid

    def tesselate_centroidal_voronoi(
        self, add_exterior=True, add_vertices=True, skip_concave=False, device=None
    ) -> "Ugrid2d":
        """The centroidal voronoi tessellation of this grid: one cell per
        node around the face centroids.  The angle sort of a large table
        runs on ``device``: None means the CUDA card, and raises without
        one; pass ``device="cpu"`` to sort on the CPU."""
        return self._tesselate_voronoi(self.centroids, add_exterior, add_vertices, skip_concave, device)

    def tesselate_circumcenter_voronoi(
        self, add_exterior=True, add_vertices=True, skip_concave=False, device=None
    ) -> "Ugrid2d":
        """The circumcenter voronoi tessellation of this (triangular) grid,
        its angle sort on ``device`` as for the centroidal one."""
        return self._tesselate_voronoi(self.circumcenters, add_exterior, add_vertices, skip_concave, device)

    def reverse_cuthill_mckee(self, dimension=None):
        """The grid with its faces reordered by scipy's reverse
        Cuthill-McKee over the face adjacency, to narrow its bandwidth:
        (grid, the new order)."""
        reordering = reverse_cuthill_mckee(graph=self.face_face_connectivity, symmetric_mode=True)
        reordered = Ugrid2d(self.node_x, self.node_y, FILL_VALUE, self.face_node_connectivity[reordering])
        self._propagate_properties(reordered)
        return reordered, reordering

    # -- partition merge -------------------------------------------------------------
    @staticmethod
    def merge_partitions(grids: Sequence["Ugrid2d"]):
        """The partitions merged into one topology, shared nodes, faces and
        edges deduplicated: (grid, each partition's positions taken per
        UGRID dimension)."""
        from xugrid_tpu_torch.ugrid import partitioning

        grid = next(iter(grids))
        with timed("merge.nodes"):
            node_coordinates, node_indexes, node_inverse = partitioning.merge_nodes(grids)
        with timed("merge.faces"):
            new_faces, face_indexes = partitioning.merge_faces(grids, node_inverse)
        indexes = {grid.node_dimension: node_indexes, grid.face_dimension: face_indexes}
        new_edges = None
        if grid._edge_node_connectivity is not None:
            with timed("merge.edges"):
                new_edges, edge_indexes = partitioning.merge_edges(grids, node_inverse)
            indexes[grid.edge_dimension] = edge_indexes

        merged = Ugrid2d(
            node_coordinates[:, 0],
            node_coordinates[:, 1],
            FILL_VALUE,
            new_faces,
            name=grid.name,
            edge_node_connectivity=new_edges,
            indexes=grid._indexes,
            is_projected=grid.is_projected,
            crs=grid.crs,
            attrs=grid._attrs,
        )
        grid._propagate_properties(merged)
        return merged, indexes
