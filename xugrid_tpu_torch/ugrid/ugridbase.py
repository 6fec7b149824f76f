"""
What ``Ugrid1d`` and ``Ugrid2d`` share: the UGRID attributes and
dimension names, the conversion to and from a UGRID dataset (fill value
and start index, connectivity layout, coordinate attributes, the CRS and
its grid mapping), renaming, the bounding box, the construction of a
UgridDataArray on a facet, and the spatial queries: nearest node and
edge (``spatial/nearest.py``), point location, line sections and the
selection at points.  The port of ``xugrid_tpu/ugrid/ugridbase.py``.
"""

from __future__ import annotations

import abc
import copy
import warnings
from itertools import chain
from typing import Any, Optional, Sequence, Union

import numpy as np
import pandas as pd
from scipy.sparse import coo_matrix, csr_matrix

from xugrid_tpu_torch import xdata
from xugrid_tpu_torch.constants import FILL_VALUE
from xugrid_tpu_torch.ugrid import connectivity, conventions
from xugrid_tpu_torch.ugrid.crs import CrsPlaceholder, crs_from_attrs, crs_to_attrs
from xugrid_tpu_torch.ugrid.selection_utils import get_sorted_section_coords
from xugrid_tpu_torch.utils.profiling import timed


def numeric_bound(v: Union[float, None], other: float) -> float:
    return other if v is None else v


def _strip_dim_coords(ds):
    """Drop index coordinates named after their own dimension (the wrap
    layer's position coordinates) before storing the dataset on the grid
    for round-tripping."""
    drop = [name for name in list(ds._coord_names) if ds._variables[name].dims == (name,)]
    return ds.drop_vars(drop, errors="ignore")


def as_pandas_index(index, n: int) -> pd.Index:
    """A bool mask or integer positions into a dimension of size ``n``
    as a pandas Index of unique positions."""
    if isinstance(index, np.ndarray):
        if index.size > n:
            raise ValueError(f"index size {index.size} is larger than dimension size: {n}")
        if np.issubdtype(index.dtype, np.bool_):
            pd_index = pd.RangeIndex(0, n) if index.all() else pd.Index(np.arange(n)[index])
        elif np.issubdtype(index.dtype, np.integer):
            pd_index = pd.Index(index)
        else:
            raise TypeError(f"index should be bool or integer. Received: {index.dtype}")
    elif isinstance(index, pd.Index):
        pd_index = index
    else:
        raise TypeError(f"index should be pandas Index or numpy array. Received: {type(index).__name__}")
    if not pd_index.is_unique:
        raise ValueError("index contains repeated values; only subsets will result in valid UGRID topology.")
    return pd_index


def dim_coordinates(obj, dims) -> dict:
    """The data of the index coordinates of ``obj`` (a DataArray or a
    Dataset) on ``dims``, not copied."""
    if isinstance(obj, xdata.DataArray):
        coords = obj._coords
    else:
        coords = {k: obj._variables[k] for k in obj._coord_names}
    return {d: coords[d].data for d in dims if d in coords and coords[d].dims == (d,)}


def align(obj, grids, old_coords):
    """
    ``obj`` and its grids after a forwarded operation: where the index
    coordinate of a UGRID dimension changed (``old_coords``: its data
    before, from ``dim_coordinates``), the grid is subset to the entities
    left (``grid.isel``), and ``obj`` to that subset's entities on the
    grid's other dimensions.  The positions into the grid are the new
    index's places in the old one.  A coordinate that is the same array
    as before is unchanged without a comparison.
    """
    if old_coords is None:
        return obj, grids
    ugrid_dims = set(chain.from_iterable(grid.dims for grid in grids)).intersection(old_coords)
    new_indexes = {
        k: xdata.indexes.as_index(data)
        for k, data in dim_coordinates(obj, ugrid_dims).items()
        if data is not old_coords[k] and not np.array_equal(data, old_coords[k])
    }
    if not new_indexes:
        return obj, grids

    new_grids = []
    for grid in grids:
        grid_dims = grid.dims.intersection(new_indexes)
        if grid_dims:
            positions = {dim: xdata.indexes.as_index(old_coords[dim]).get_indexer(new_indexes[dim]) for dim in grid_dims}
            newgrid, indexers = grid.isel(indexers=positions, return_index=True)
            obj = obj.isel({k: v.to_numpy() for k, v in indexers.items() if k in obj.dims and k not in new_indexes})
            new_grids.append(newgrid)
        else:
            new_grids.append(grid)
    return obj, new_grids


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
    @abc.abstractmethod
    def sizes(self) -> dict:
        """UGRID dimension name -> length."""

    @abc.abstractmethod
    def to_dataset(self, other=None, optional_attributes: bool = False):
        ...

    @abc.abstractmethod
    def _clear_geometry_properties(self):
        ...

    @abc.abstractmethod
    def get_coordinates(self, dim: str) -> np.ndarray:
        ...

    @abc.abstractmethod
    def topology_subset(self, index, return_index: bool = False):
        ...

    @abc.abstractmethod
    def clip_box(self, xmin, ymin, xmax, ymax):
        ...

    @property
    def dims(self) -> set:
        """Set of UGRID dimension names."""
        return set(self.facets.values())

    @property
    def coords(self) -> dict:
        """(n, 2) coordinates per UGRID dimension: nodes, edge midpoints
        (and face centroids)."""
        return {dim: self.get_coordinates(dim) for dim in self.facets.values()}

    @property
    def dimensions(self):
        warnings.warn(
            ".dimensions is deprecated; use .dims (set of names) or .sizes (mapping to lengths) instead.",
            FutureWarning,
        )
        return self.sizes

    # -- connectivity format helpers -------------------------------------------
    @staticmethod
    def format_connectivity_as_dense(sparse_connectivity) -> np.ndarray:
        """CSR/COO connectivity -> padded dense (-1 fill)."""
        if isinstance(sparse_connectivity, np.ndarray):
            return sparse_connectivity
        return connectivity.to_dense(sparse_connectivity)

    @staticmethod
    def format_connectivity_as_sparse(dense_connectivity) -> csr_matrix:
        """Padded dense (-1 fill) connectivity -> CSR."""
        if isinstance(dense_connectivity, csr_matrix):
            return dense_connectivity
        if isinstance(dense_connectivity, coo_matrix):
            return dense_connectivity.tocsr()
        return connectivity.to_sparse(dense_connectivity)

    # -- construction helpers --------------------------------------------------
    def _initialize_indexes_attrs(self, name, dataset, indexes, attrs) -> None:
        defaults = conventions.default_topology_attrs(name, self.topology_dimension)
        if dataset is None:
            if attrs is None:
                x, y = defaults["node_coordinates"].split()
                indexes = {"node_x": x, "node_y": y}
            else:
                if indexes is None:
                    raise ValueError("indexes must be provided for attrs")
                defaults.update(attrs)
            self._indexes = indexes
            self._attrs = defaults
        else:
            if attrs is not None:
                raise ValueError("Provide either dataset or attrs, not both.")
            if indexes is None:
                raise ValueError("indexes must be provided for dataset")
            derived_dims = conventions.ugrid_roles(dataset).dimensions[name]
            self._indexes = indexes
            self._attrs = {**defaults, **derived_dims, **dataset._variables[name].attrs}
        self._attrs["name"] = name

    def rename(self, name: str, return_name_dict: bool = False):
        """This grid with every topology variable and dimension renamed to
        the default scheme of ``name``.  The copy shares the arrays."""
        old_attrs = self._attrs
        new_attrs = conventions.default_topology_attrs(name, self.topology_dimension)

        name_dict = {self.name: name}
        skip = ("cf_role", "long_name", "topology_dimension")
        for key, value in old_attrs.items():
            if key in new_attrs and key not in skip:
                split_new = new_attrs[key].split()
                split_old = str(value).split()
                if len(split_new) != len(split_old):
                    raise ValueError(f"Number of entries does not match on {key}: {split_new} versus {split_old}")
                for old_name, new_name in zip(split_old, split_new):
                    name_dict[old_name] = new_name

        new = copy.copy(self)
        new.name = name
        new._attrs = new_attrs
        new._indexes = {k: name_dict[v] for k, v in self._indexes.items()}
        if new._dataset is not None:
            present = set(new._dataset._variables) | set(new._dataset.dims_sizes())
            new._dataset = new._dataset.rename({k: v for k, v in name_dict.items() if k in present})
        if return_name_dict:
            return new, name_dict
        return new

    def _propagate_properties(self, other) -> None:
        other.start_index = self.start_index
        other.fill_value = self.fill_value

    @staticmethod
    def _single_topology(dataset) -> str:
        topologies = conventions.ugrid_roles(dataset).topology
        if len(topologies) == 0:
            raise ValueError("Dataset contains no UGRID topology variable.")
        if len(topologies) > 1:
            raise ValueError(
                f"Dataset contains {len(topologies)} topology variables, "
                "please specify the topology variable name to use."
            )
        return topologies[0]

    def _filtered_attrs(self, dataset) -> dict:
        """The topology attrs without entries naming variables or
        dimensions absent from ``dataset``."""
        topodim = self.topology_dimension
        attrs = self._attrs.copy()
        present_dims = set(dataset.dims_sizes())
        present_vars = set(dataset._variables)

        ugrid_dims = conventions._DIM_NAMES[topodim] + tuple(
            dims[0] for dims in conventions._CONNECTIVITY_DIMS.values()
        )
        for key in ugrid_dims:
            if key in attrs and attrs[key] not in present_dims:
                attrs.pop(key)
        for key in conventions._CONNECTIVITY_NAMES[topodim]:
            if key in attrs and attrs[key] not in present_vars:
                attrs.pop(key)
        for coord in conventions._COORD_NAMES[topodim]:
            if coord in attrs:
                names = [n for n in attrs[coord].split(" ") if n in present_vars]
                if names:
                    attrs[coord] = " ".join(names)
                else:
                    attrs.pop(coord)
        return attrs

    # -- fill value / start index -----------------------------------------------
    @property
    def fill_value(self) -> int:
        """Fill value of the UGRID connectivity arrays as written."""
        return self._fill_value

    @fill_value.setter
    def fill_value(self, value: int):
        self._fill_value = value

    @property
    def start_index(self) -> int:
        """Start index of the UGRID connectivity arrays as written."""
        return self._start_index

    @start_index.setter
    def start_index(self, value: int):
        if value not in (0, 1):
            raise ValueError(f"start_index must be 0 or 1, received: {value}")
        self._start_index = value

    @staticmethod
    def _prepare_connectivity(da, fill_value, dtype, coredim: str) -> np.ndarray:
        """
        A connectivity variable read from a file, normalized: core
        dimension first, the file's fill (or NaN for a float variable)
        replaced by ``fill_value``, cast to ``dtype`` (netCDF3 stores
        int32).
        """
        data = np.asarray(da.data)
        if da.dims[0] != coredim:
            data = data.T
        data = data.copy()
        file_fill = da.encoding.get("_FillValue", da.attrs.get("_FillValue"))
        if np.issubdtype(data.dtype, np.floating):
            # The CF decode replaced the fill by NaN: NaN is the fill,
            # whatever sentinel was recorded.
            is_fill = np.isnan(data)
            if file_fill is not None and not np.isnan(np.asarray(file_fill)).any():
                is_fill |= data == file_fill
        elif file_fill is not None and not np.isnan(np.asarray(file_fill)).any():
            is_fill = data == file_fill
        else:
            is_fill = data == fill_value
        data[is_fill] = fill_value
        cast = data.astype(dtype, copy=False)
        if (cast[~is_fill] < 0).any():
            raise ValueError("connectivity contains negative values")
        return cast

    def _adjust_connectivity(self, conn: np.ndarray) -> np.ndarray:
        """Write side: restore the grid's fill_value and start_index."""
        c = conn.copy()
        if self.start_index == 0 and self.fill_value == FILL_VALUE:
            return c
        is_fill = c == FILL_VALUE
        if self.start_index:
            c[~is_fill] += self.start_index
        if self.fill_value != FILL_VALUE:
            c[is_fill] = self.fill_value
        return c

    # -- CRS ----------------------------------------------------------------------
    @staticmethod
    def _extract_crs(dataset, topology: str):
        roles = conventions.ugrid_roles(dataset)
        grid_mapping_name = roles.grid_mapping_names[topology]
        stdname_projected = roles.is_projected[topology]
        crs = None
        if grid_mapping_name is not None:
            crs = crs_from_attrs(dataset._variables[grid_mapping_name].attrs)

        if not (crs is None or isinstance(crs, CrsPlaceholder)):
            is_projected = crs.is_projected
            if stdname_projected is not None and stdname_projected != is_projected:
                warnings.warn(
                    "standard_name suggests "
                    f"{'projected' if stdname_projected else 'geographic'} "
                    f"coordinates, but the CRS ({crs}) is "
                    f"{'projected' if is_projected else 'geographic'}. "
                    "The CRS will take priority.",
                    UserWarning,
                    stacklevel=2,
                )
            return crs, is_projected

        if stdname_projected is not None:
            is_projected = stdname_projected
        else:
            warnings.warn(
                f"No CRS or recognizable standard_name found for topology '{topology}'. "
                "Assuming projected coordinates.",
                UserWarning,
                stacklevel=2,
            )
            is_projected = True
        return crs, is_projected

    @staticmethod
    def _validate_crs(crs: Any, is_projected: bool):
        if crs is None or isinstance(crs, CrsPlaceholder):
            return crs, is_projected
        import pyproj

        _crs = pyproj.CRS.from_user_input(crs)
        if not (_crs.is_projected ^ _crs.is_geographic):
            raise ValueError(
                f"Unsupported CRS: {crs}. CRS should either be geographic "
                "(latitude / longitude) or projected."
            )
        return _crs, _crs.is_projected

    def set_crs(self, crs=None, epsg: Optional[int] = None, allow_override: bool = False):
        """Set the CRS without transforming the geometry (needs pyproj)."""
        import pyproj

        if crs is not None:
            crs = pyproj.CRS.from_user_input(crs)
        elif epsg is not None:
            crs = pyproj.CRS.from_epsg(epsg)
        else:
            raise ValueError("Must pass either crs or epsg.")
        crs, is_projected = self._validate_crs(crs, crs.is_projected)
        if not allow_override and self.crs is not None and not self.crs == crs:
            raise ValueError(
                "The Ugrid already has a CRS which is not equal to the "
                "passed CRS. Specify 'allow_override=True' to replace it "
                "without transformation, or use '.to_crs' to transform."
            )
        self.crs = crs
        self.is_projected = is_projected

    def to_crs(self, crs=None, epsg: Optional[int] = None):
        """Transform node geometry to a new CRS (needs pyproj)."""
        import pyproj

        if self.crs is None:
            raise ValueError("Cannot transform naive geometries. Set a crs first.")
        if isinstance(self.crs, CrsPlaceholder):
            raise ValueError(
                "Cannot transform geometries: the current CRS is a "
                "placeholder (pyproj missing or unparseable grid mapping). "
                "Use .set_crs(..., allow_override=True) first."
            )
        if crs is not None:
            crs = pyproj.CRS.from_user_input(crs)
        elif epsg is not None:
            crs = pyproj.CRS.from_epsg(epsg)
        else:
            raise ValueError("Must pass either crs or epsg.")
        crs, is_projected = self._validate_crs(crs, crs.is_projected)
        grid = self.copy()
        if self.crs.is_exact_same(crs):
            return grid
        transformer = pyproj.Transformer.from_crs(crs_from=self.crs, crs_to=crs, always_xy=True)
        node_x, node_y = transformer.transform(xx=grid.node_x, yy=grid.node_y)
        grid.node_x = node_x
        grid.node_y = node_y
        grid._clear_geometry_properties()
        grid._dataset = None
        grid.crs = crs
        grid.is_projected = is_projected
        return grid

    @property
    def is_geographic(self) -> bool:
        return not self.is_projected

    def write_grid_mapping(self, dataset, grid_mapping_name: Optional[str] = None):
        """Write the CF grid_mapping attributes of the CRS to a mapping
        variable, and name it on every variable sharing this topology's
        dimensions."""
        if self.crs is None:
            return dataset
        dataset = dataset.copy(deep=False)
        if grid_mapping_name is None:
            grid_mapping_name = f"{self.name}_crs"
        fill = np.int32(np.iinfo(np.int32).min + 1)
        dataset._variables[grid_mapping_name] = xdata.Variable((), fill, attrs=crs_to_attrs(self.crs))
        for var in dataset._variables.values():
            if set(self.dims) & set(var.dims):
                var.attrs["grid_mapping"] = grid_mapping_name
        return dataset

    def _update_coordinate_attrs(self, obj) -> None:
        for role, name in self._indexes.items():
            attrs = conventions.DEFAULT_ATTRS[role][self.is_projected]
            if name in getattr(obj, "_coords", {}):
                obj._coords[name].attrs = dict(attrs)
            elif isinstance(obj, xdata.Dataset) and name in obj._variables:
                obj._variables[name].attrs = dict(attrs)
            if self._dataset is not None and name in self._dataset._variables:
                self._dataset._variables[name].attrs = dict(attrs)

    # -- generic -----------------------------------------------------------------
    def __repr__(self) -> str:
        if self._dataset:
            return self._dataset.__repr__()
        return self.to_dataset().__repr__()

    def equals(self, other) -> bool:
        """Same kind, and identical UGRID datasets (names, attributes,
        coordinates and connectivity)."""
        if other is self:
            return True
        if isinstance(other, type(self)):
            return self.to_dataset().identical(other.to_dataset())
        return False

    def copy(self):
        """A deep copy."""
        return copy.deepcopy(self)

    @property
    def attrs(self) -> dict:
        return copy.deepcopy(self._attrs)

    @property
    def node_dimension(self) -> str:
        """Name of the node dimension."""
        return self._attrs["node_dimension"]

    @property
    def edge_dimension(self) -> str:
        """Name of the edge dimension."""
        return self._attrs["edge_dimension"]

    @property
    def max_connectivity_dimensions(self) -> tuple:
        return ()

    @property
    def max_connectivity_sizes(self) -> dict:
        return {}

    # -- geometry ----------------------------------------------------------------
    @property
    def node_coordinates(self) -> np.ndarray:
        """(n_node, 2) node x and y."""
        return np.column_stack([self.node_x, self.node_y])

    @property
    def n_node(self) -> int:
        return len(self.node_x)

    @property
    def n_edge(self) -> int:
        return len(self.edge_node_connectivity)

    @property
    def edge_x(self) -> np.ndarray:
        """x-coordinate of every edge midpoint."""
        if self._edge_x is None:
            self._edge_x = self.node_x[self.edge_node_connectivity].mean(axis=1)
        return self._edge_x

    @property
    def edge_y(self) -> np.ndarray:
        """y-coordinate of every edge midpoint."""
        if self._edge_y is None:
            self._edge_y = self.node_y[self.edge_node_connectivity].mean(axis=1)
        return self._edge_y

    @property
    def edge_coordinates(self) -> np.ndarray:
        """(n_edge, 2) edge midpoints."""
        return np.column_stack([self.edge_x, self.edge_y])

    @property
    def edge_node_coordinates(self) -> np.ndarray:
        """Node coordinates of every edge: (n_edge, 2, 2)."""
        return self.node_coordinates[self.edge_node_connectivity]

    @property
    def edge_length(self) -> np.ndarray:
        """Length of every edge."""
        dxy = np.diff(self.edge_node_coordinates, axis=1)[:, 0, :]
        return np.linalg.norm(dxy, axis=-1)

    @property
    def bounds(self) -> tuple:
        """(xmin, ymin, xmax, ymax) of the nodes."""
        return (self.node_x.min(), self.node_y.min(), self.node_x.max(), self.node_y.max())

    @property
    def edge_bounds(self) -> np.ndarray:
        """(n_edge, 4): minx, miny, maxx, maxy per edge."""
        x = self.node_x[self.edge_node_connectivity]
        y = self.node_y[self.edge_node_connectivity]
        return np.column_stack([x.min(axis=1), y.min(axis=1), x.max(axis=1), y.max(axis=1)])

    # -- derived connectivity ----------------------------------------------------
    @property
    def node_edge_connectivity(self) -> csr_matrix:
        """Node to edge connectivity (CSR)."""
        return connectivity.invert_dense_to_sparse(self.edge_node_connectivity)

    @property
    def node_node_connectivity(self) -> csr_matrix:
        """Node adjacency (CSR); data holds the connecting edge index."""
        return connectivity.node_node_connectivity(self.edge_node_connectivity)

    @property
    def edge_edge_connectivity(self) -> csr_matrix:
        """Edge adjacency (CSR); data holds the shared node index."""
        return connectivity.edge_edge_connectivity(self.edge_node_connectivity, self.node_edge_connectivity)

    @property
    def directed_node_node_connectivity(self) -> csr_matrix:
        """Node adjacency along each edge's direction (CSR); data holds the
        edge index."""
        return connectivity.directed_node_node_connectivity(self.edge_node_connectivity)

    @property
    def directed_edge_edge_connectivity(self) -> csr_matrix:
        """Each edge's downstream edges (CSR); data holds the shared node."""
        return connectivity.directed_edge_edge_connectivity(self.edge_node_connectivity, self.node_edge_connectivity)

    @staticmethod
    def _connectivity_weights(conn: csr_matrix, coordinates: np.ndarray) -> np.ndarray:
        """Normalized inverse-distance weights for adjacency data."""
        coo = conn.tocoo()
        distance = np.linalg.norm(coordinates[coo.col] - coordinates[coo.row], axis=1)
        return distance.mean() / distance

    # -- coordinate assignment ---------------------------------------------------
    def set_node_coords(self, node_x: str, node_y: str, obj, is_projected=True, crs=None):
        """Use the coordinates ``node_x`` and ``node_y`` of ``obj`` as this
        grid's node coordinates."""
        if " " in node_x or " " in node_y:
            raise ValueError("coordinate names may not contain spaces")
        x = np.asarray(obj[node_x].values)
        y = np.asarray(obj[node_y].values)
        if x.ndim != 1 or x.size != self.n_node:
            raise ValueError(f"shape of node_x does not match n_node of grid: {x.shape} versus {self.n_node}")
        if y.ndim != 1 or y.size != self.n_node:
            raise ValueError(f"shape of node_y does not match n_node of grid: {y.shape} versus {self.n_node}")
        node_coords = [c for c in self._attrs["node_coordinates"].split(" ") if c not in (node_x, node_y)]
        node_coords.extend((node_x, node_y))
        self._clear_geometry_properties()
        self.node_x = np.ascontiguousarray(x, dtype=np.float64)
        self.node_y = np.ascontiguousarray(y, dtype=np.float64)
        self._attrs["node_coordinates"] = " ".join(node_coords)
        self._indexes["node_x"] = node_x
        self._indexes["node_y"] = node_y
        self.crs, self.is_projected = self._validate_crs(crs, is_projected)

    def _assign_coords(self, obj, facet: str, x: np.ndarray, y: np.ndarray, dim: str):
        xname = self._indexes.get(f"{facet}_x", f"{self.name}_{facet}_x")
        yname = self._indexes.get(f"{facet}_y", f"{self.name}_{facet}_y")
        coords = {
            xname: xdata.DataArray(x, dims=(dim,), attrs=conventions.DEFAULT_ATTRS[f"{facet}_x"][self.is_projected]),
            yname: xdata.DataArray(y, dims=(dim,), attrs=conventions.DEFAULT_ATTRS[f"{facet}_y"][self.is_projected]),
        }
        return obj.assign_coords(coords)

    def assign_node_coords(self, obj):
        """``obj`` with this grid's node coordinates."""
        return self._assign_coords(obj, "node", self.node_x, self.node_y, self.node_dimension)

    def assign_edge_coords(self, obj):
        """``obj`` with this grid's edge midpoints as coordinates."""
        return self._assign_coords(obj, "edge", self.edge_x, self.edge_y, self.edge_dimension)

    def _assign_derived_coords(self, obj):
        """``obj`` with the node and edge coordinates of the facets it spans."""
        if self.node_dimension in obj.dims:
            obj = self.assign_node_coords(obj)
        if self.edge_dimension in obj.dims:
            obj = self.assign_edge_coords(obj)
        return obj

    # -- labelled wrappers --------------------------------------------------------
    def find_ugrid_dim(self, obj) -> str:
        """The single UGRID dimension present in the object."""
        ugrid_dims = self.dims.intersection(obj.dims)
        if len(ugrid_dims) != 1:
            raise ValueError(f"UgridDataArray should contain exactly one of the UGRID dimensions: {self.dims}")
        return ugrid_dims.pop()

    def create_data_array(self, data, facet: str):
        """UgridDataArray from a 1D array or tensor on the given facet."""
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

    # -- spatial queries -----------------------------------------------------------
    @property
    def node_kdtree(self):
        """scipy KDTree over the nodes, built on first use."""
        if self._node_kdtree is None:
            from scipy.spatial import KDTree

            self._node_kdtree = KDTree(self.node_coordinates)
        return self._node_kdtree

    @property
    def edge_kdtree(self):
        """scipy KDTree over the edge midpoints, built on first use."""
        if self._edge_kdtree is None:
            from scipy.spatial import KDTree

            self._edge_kdtree = KDTree(self.edge_coordinates)
        return self._edge_kdtree

    def locate_nearest_node(self, points: np.ndarray, max_distance: float = np.inf, device=None) -> np.ndarray:
        """Nearest node per point; -1 beyond ``max_distance``.  Large
        batches scan on ``device`` (``spatial/nearest.py``), small ones
        query the cached KDTree."""
        from xugrid_tpu_torch.spatial.nearest import nearest_points

        return nearest_points(self.node_coordinates, points, max_distance, tree=self.node_kdtree, device=device)

    def locate_nearest_edge(self, points: np.ndarray, max_distance: float = np.inf, device=None) -> np.ndarray:
        """Nearest edge (by midpoint) per point; -1 beyond ``max_distance``."""
        from xugrid_tpu_torch.spatial.nearest import nearest_points

        return nearest_points(self.edge_coordinates, points, max_distance, tree=self.edge_kdtree, device=device)

    def locate_points(self, points: np.ndarray, tolerance: Optional[float] = None) -> np.ndarray:
        """Index of the core entity holding each point (-1 outside)."""
        return self.celltree.locate_points(points, tolerance)

    def intersect_edges(self, edges: np.ndarray):
        """Segments (n, 2, 2) against the grid: (segment index, core
        entity index, intersections)."""
        return self.celltree.intersect_edges(edges)

    def intersect_line(self, obj, start: Sequence[float], end: Sequence[float]):
        """Cross-section of ``obj`` along the line from start to end."""
        if len(start) != 2 or len(end) != 2:
            raise ValueError("Start and end coordinate pairs must have length two")
        return self._sel_line(obj, start, end)

    def _sel_line(self, obj, start, end):
        dim = self.core_dimension
        edges = np.array([[start, end]])
        _, index, xy = self.intersect_edges(edges)
        coords, index = self._section_coordinates(edges, xy, dim, index, self.name)
        return obj.isel({dim: index}).assign_coords(coords)

    def _sel_yline(self, obj, x: slice, y: np.ndarray):
        xmin, _, xmax, _ = self.bounds
        if y.size != 1:
            raise ValueError("If x is a slice without steps, y should be a single value")
        y = y[0]
        return self._sel_line(obj, start=(numeric_bound(x.start, xmin), y), end=(numeric_bound(x.stop, xmax), y))

    def _sel_xline(self, obj, x: np.ndarray, y: slice):
        _, ymin, _, ymax = self.bounds
        if x.size != 1:
            raise ValueError("If y is a slice without steps, x should be a single value")
        x = x[0]
        return self._sel_line(obj, start=(x, numeric_bound(y.start, ymin)), end=(x, numeric_bound(y.stop, ymax)))

    def intersect_linestring(self, obj, linestring):
        """Cross-section along a linestring: a shapely LineString, or its
        (n, 2) vertices as an array (without shapely)."""
        if isinstance(linestring, np.ndarray) or (
            isinstance(linestring, (list, tuple)) and len(linestring) and not hasattr(linestring, "coords")
        ):
            xy = np.asarray(linestring, dtype=np.float64)
            if xy.ndim != 2 or xy.shape[1] != 2:
                raise ValueError(f"linestring array must have shape (n_vertex, 2); got {xy.shape}")
        else:
            import shapely

            xy = shapely.get_coordinates([linestring])
        return self.intersect_segments(obj, np.stack((xy[:-1], xy[1:]), axis=1))

    def intersect_segments(self, obj, edges: np.ndarray):
        """Cross-section along a polyline given as (n, 2, 2) segments; ``s``
        is the distance along the polyline."""
        edge_index, core_index, intersections = self.intersect_edges(edges)

        edge_length = np.linalg.norm(edges[:, 1] - edges[:, 0], axis=1)
        cumulative = np.concatenate([[0.0], np.cumsum(edge_length[:-1])])
        if self.topology_dimension == 2:
            xy = intersections.mean(axis=1)
        else:
            xy = intersections
        distance = np.linalg.norm(xy - edges[edge_index, 0], axis=1)
        s = distance + cumulative[edge_index]

        dim = self.core_dimension
        coords, core_index = get_sorted_section_coords(s, xy, dim, core_index, self.name)
        return obj.isel({dim: core_index}).assign_coords(coords)

    def sel_points(
        self,
        obj,
        x,
        y,
        method: Optional[str] = None,
        out_of_bounds: str = "warn",
        fill_value=np.nan,
        tolerance: Optional[float] = None,
        device=None,
    ):
        """
        Values of ``obj`` at points, along a new ``{name}_points``
        dimension with ``{name}_x`` and ``{name}_y`` coordinates.  Data on
        the core dimension takes the entity holding each point (the
        nearest with ``method="nearest"``), data on the other dimensions
        the nearest entity (searched on ``device``, see
        ``locate_nearest_node``).  Points on no entity: ``out_of_bounds``
        "warn" (and fill), "raise", "ignore" (fill silently) or "drop".
        """
        if method not in (None, "nearest"):
            raise ValueError(f"method must be None or 'nearest', got: {method}")
        options = ("warn", "raise", "ignore", "drop")
        if out_of_bounds not in options:
            raise ValueError(f"out_of_bounds must be one of {', '.join(options)}, received: {out_of_bounds}")

        x = np.atleast_1d(np.asarray(x, dtype=float))
        y = np.atleast_1d(np.asarray(y, dtype=float))
        if x.shape != y.shape:
            raise ValueError("shape of x does not match shape of y")
        if x.ndim != 1:
            raise ValueError("x and y must be 1d")
        xy = np.column_stack([x, y])

        point_dim = f"{self.name}_points"
        core_indexer = self.locate_points(xy, tolerance)
        keep = slice(None, None)
        condition = None
        valid = core_indexer != -1
        if not valid.all():
            msg = "Not all points are located on the topology."
            if out_of_bounds == "raise":
                raise ValueError(msg)
            elif out_of_bounds == "warn":
                warnings.warn(msg, UserWarning, stacklevel=2)
                condition = xdata.DataArray(valid, dims=(point_dim,))
            elif out_of_bounds == "ignore":
                condition = xdata.DataArray(valid, dims=(point_dim,))
            else:  # drop
                core_indexer = core_indexer[valid]
                keep = valid
        xy_sel = xy[keep]

        core_dim = self.core_dimension
        other_dims = self.dims.intersection(obj.dims) - {core_dim}
        facets = {v: k for k, v in self.facets.items()}
        if core_dim in obj.dims:
            if method == "nearest":
                core_indexer = self._locate_nearest(facets[core_dim], xy_sel, device=device)
            indexers = {core_dim: xdata.DataArray(core_indexer, dims=(point_dim,))}
        else:
            indexers = {}
        for dim in other_dims:
            indexer = self._locate_nearest(facets[dim], xy_sel, device=device)
            indexers[dim] = xdata.DataArray(indexer, dims=(point_dim,))

        selection = obj.isel(indexers).assign_coords(
            {f"{self.name}_x": (point_dim, xy[keep, 0]), f"{self.name}_y": (point_dim, xy[keep, 1])}
        )
        if condition is not None:
            if isinstance(selection, xdata.Dataset):
                out = selection.copy(deep=False)
                for varname in list(out.data_vars):
                    if point_dim in out._variables[varname].dims:
                        out[varname] = out[varname].where(condition, other=fill_value)
                selection = out
            else:
                selection = selection.where(condition, other=fill_value)
        return selection

    def sel(self, obj, x=None, y=None):
        """
        Orthogonal selection in UGRID x and y.  Two slices select a box:
        returns (the subset of ``obj``, the subset grid).  A slice and a
        value select along a line (``intersect_line``), values for both
        the points of their outer product (``sel_points``): each returns
        the selection of ``obj`` alone.
        """
        if x is None:
            x = slice(None, None)
        if y is None:
            y = slice(None, None)
        x = self._validate_indexer(x)
        y = self._validate_indexer(y)
        if isinstance(x, slice) and isinstance(y, slice):
            f = self._sel_box
        elif isinstance(x, slice) and isinstance(y, np.ndarray):
            f = self._sel_yline
        elif isinstance(x, np.ndarray) and isinstance(y, slice):
            f = self._sel_xline
        elif isinstance(x, np.ndarray) and isinstance(y, np.ndarray):
            y, x = (a.ravel() for a in np.meshgrid(y, x, indexing="ij"))
            f = self.sel_points
        else:
            raise TypeError(f"Invalid indexer types: {type(x).__name__}, {type(y).__name__}")
        return f(obj, x, y)

    def _precheck(self, multi_index):
        dim, index = multi_index.popitem()
        for check_dim, check_index in multi_index.items():
            if not index.equals(check_index):
                raise ValueError(f"UGRID dimensions do not align: {dim} versus {check_dim}")
        return index

    def _postcheck(self, indexers, finalized_indexers):
        for dim, indexer in indexers.items():
            if dim != self.core_dimension and not indexer.equals(finalized_indexers[dim]):
                raise ValueError(f"This subset selection of UGRID dimension {dim} results in an invalid topology")

    # -- partitioning --------------------------------------------------------------
    def _validate_partitioning_weights(self, weights) -> None:
        facet = {v: k for k, v in self.facets.items()}[self.core_dimension]
        n_expected = getattr(self, f"n_{facet}")
        if weights is None:
            return
        if weights.shape != (n_expected,):
            raise ValueError(
                f"Wrong shape on weights. Expected a 1D array with {n_expected} elements, "
                f"received array with shape: {weights.shape}"
            )
        if not np.issubdtype(weights.dtype, np.integer):
            raise TypeError(f"Wrong type on weights. Expected an integer array, received: {weights.dtype}")
        if np.any(weights < 0):
            raise ValueError("Wrong values on weights. Weights should be greater or equal to zero.")

    def label_partitions(self, n_part: int, weights: Optional[np.ndarray] = None):
        """
        Partition labels on the core dimension (``partition_labels``: the
        Hilbert order of the core entities' coordinates, split into
        ``n_part`` chunks of equal count or of equal total ``weights``),
        as a UgridDataArray named "labels".
        """
        from xugrid_tpu_torch.core.wrap import UgridDataArray
        from xugrid_tpu_torch.ugrid.partitioning import partition_labels

        self._validate_partitioning_weights(weights)
        with timed("partition.labels"):
            facet = {v: k for k, v in self.facets.items()}[self.core_dimension]
            coordinates = self.get_coordinates(self.core_dimension)
            # The adjacency is unused by the partitioner, but computing it
            # derives a Ugrid2d's edges, which every subset then carries.
            adjacency = getattr(self, f"{facet}_{facet}_connectivity")
            labels = partition_labels(coordinates, n_part, adjacency, weights)
        return UgridDataArray(xdata.DataArray(labels, dims=(self.core_dimension,), name="labels"), self)

    def partition(self, n_part: int, weights: Optional[np.ndarray] = None):
        """This topology split into ``n_part`` topologies."""
        from xugrid_tpu_torch.ugrid.partitioning import labels_to_indices

        labels = self.label_partitions(n_part, weights)
        return [self.topology_subset(index) for index in labels_to_indices(labels.values)]

    def plot(self, **kwargs):
        """Plot the edges of the mesh (matplotlib, on the host)."""
        from xugrid_tpu_torch.plot import line

        return line(self, **kwargs)


UgridType = AbstractUgrid
