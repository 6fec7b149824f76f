"""
The ``.ugrid`` accessor of a UgridDataArray: its topology, renaming,
coordinate assignment, the conversion to a UGRID dataset and file, box,
line and point selections, rasterization, the remaps between facets,
reindexing, partitions, the periodic conversion, the binary morphology
of face masks, connected components, the face reordering, and the
nearest and Laplace fills.  The port of
``xugrid_tpu/core/dataarray_accessor.py`` reduced to these; the rest of
the accessor is not ported.  A tensor payload stays on its device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import scipy.sparse
import torch

from xugrid_tpu_torch import xdata
from xugrid_tpu_torch.core.accessorbase import AbstractUgridAccessor, payload_device, where_nan
from xugrid_tpu_torch.utils.profiling import timed
from xugrid_tpu_torch.ugrid import connectivity
from xugrid_tpu_torch.xdata.variable import is_tensor, to_numpy


class UgridDataArrayAccessor(AbstractUgridAccessor):
    """Operations using the UGRID topology, via ``uda.ugrid``."""

    def __init__(self, obj: xdata.DataArray, grid):
        self.obj = obj
        self.grid = grid

    @property
    def grids(self):
        """The topology, as a list (as a UgridDataset gives its grids)."""
        return [self.grid]

    @property
    def name(self) -> str:
        """Name of the UGRID topology."""
        return self.grid.name

    @property
    def names(self):
        """Name of the UGRID topology, as a list."""
        return [self.grid.name]

    @property
    def topology(self) -> dict:
        """Mapping from name to UGRID topology."""
        return {self.name: self.grid}

    @property
    def bounds(self) -> dict:
        """Mapping from grid name to (minx, miny, maxx, maxy)."""
        return {self.grid.name: self.grid.bounds}

    @property
    def total_bounds(self):
        """(minx, miny, maxx, maxy) of the grid."""
        return self.grid.bounds

    @property
    def plot(self):
        """Plotting methods for this array's facet (matplotlib; a tensor
        payload is copied to the host to draw it)."""
        from xugrid_tpu_torch.plot.plot import _PlotMethods

        return _PlotMethods(self)

    def rename(self, name: str):
        """The array over this topology renamed to ``name``, its UGRID
        coordinate and dimension names with it."""
        from xugrid_tpu_torch.core.wrap import UgridDataArray

        new_grid, name_dict = self.grid.rename(name, return_name_dict=True)
        present = tuple(self.obj.coords) + tuple(self.obj.dims)
        return UgridDataArray(self.obj.rename({k: v for k, v in name_dict.items() if k in present}), new_grid)

    def assign_node_coords(self):
        """The array with the grid's node coordinates."""
        from xugrid_tpu_torch.core.wrap import UgridDataArray

        return UgridDataArray(self.grid.assign_node_coords(self.obj), self.grid)

    def assign_edge_coords(self):
        """The array with the grid's edge coordinates."""
        from xugrid_tpu_torch.core.wrap import UgridDataArray

        return UgridDataArray(self.grid.assign_edge_coords(self.obj), self.grid)

    def assign_face_coords(self):
        """The array with the grid's face coordinates."""
        from xugrid_tpu_torch.core.wrap import UgridDataArray

        if self.grid.topology_dimension == 1:
            raise TypeError("Cannot set face coords from a Ugrid1D topology")
        return UgridDataArray(self.grid.assign_face_coords(self.obj), self.grid)

    def set_node_coords(self, node_x: str, node_y: str):
        """Use the coordinates ``node_x`` and ``node_y`` of the array as the
        grid's node coordinates."""
        self.grid.set_node_coords(node_x, node_y, self.obj)

    def sel(self, x=None, y=None):
        """Selection in UGRID x and y: a box (two slices) gives a
        UgridDataArray; a line (a slice and a value) or points (values)
        a DataArray with the section's or the points' coordinates."""
        from xugrid_tpu_torch.core.wrap import UgridDataArray

        result = self.grid.sel(self.obj, x, y)
        if isinstance(result, tuple):
            return UgridDataArray(*result)
        return result

    def sel_points(self, x, y, method=None, out_of_bounds="warn", fill_value=np.nan, tolerance=None):
        """The values at the points (x[i], y[i]): ``Ugrid2d.sel_points``,
        its nearest searches on the payload's device."""
        return self.grid.sel_points(
            self.obj, x, y, method, out_of_bounds, fill_value, tolerance, device=payload_device(self.obj)
        )

    def rasterize(self, resolution: float):
        """The face data sampled on a regular raster of cell size
        ``resolution`` over the grid: a DataArray (..., y, x)."""
        x, y, index = self.grid.rasterize(resolution)
        return self._raster(x, y, index)

    def rasterize_like(self, other):
        """The face data sampled at the x and y coordinates of ``other``."""
        x, y, index = self.grid.rasterize_like(x=np.asarray(other["x"].values), y=np.asarray(other["y"].values))
        return self._raster(x, y, index)

    def to_periodic(self):
        """The array on the periodic grid (``Ugrid2d.to_periodic``), its
        payload aligned on its device."""
        from xugrid_tpu_torch.core.wrap import UgridDataArray

        grid, obj = self.grid.to_periodic(obj=self.obj)
        return UgridDataArray(obj, grid)

    def to_nonperiodic(self, xmax: float):
        """The array on the grid split at its periodic boundary, the new
        nodes at x = ``xmax`` (``Ugrid2d.to_nonperiodic``)."""
        from xugrid_tpu_torch.core.wrap import UgridDataArray

        grid, obj = self.grid.to_nonperiodic(xmax=xmax, obj=self.obj)
        return UgridDataArray(obj, grid)

    def intersect_line(self, start: Sequence[float], end: Sequence[float]):
        """The values along the line from start to end, with the distance
        along it as the coordinate ``{name}_s``."""
        return self.grid.intersect_line(self.obj, start, end)

    def intersect_linestring(self, linestring):
        """The values along a linestring (a shapely LineString or its
        (n, 2) vertices)."""
        return self.grid.intersect_linestring(self.obj, linestring)

    def _to_facet(self, facet: str, newdim: str):
        """The data on ``facet``: for each of its entities, the values of
        the entities that connect to it along ``newdim``, NaN in the fill
        slots (an integer payload becomes float64, as numpy promotes)."""
        from xugrid_tpu_torch.core.wrap import UgridDataArray

        grid = self.grid
        obj = self.obj
        gridfacets = grid.facets
        if facet not in gridfacets:
            raise ValueError(f"Cannot map to {facet} for a {type(grid).__name__} topology.")
        if newdim in obj.dims:
            raise ValueError(f"Dimension {newdim} already exists. Please provide a new dimension name.")
        source_dim = grid.dims.intersection(obj.dims).pop()
        target_dim = getattr(grid, f"{facet}_dimension")
        if source_dim == target_dim:
            raise ValueError(f"No conversion needed, data is already {facet}-associated.")
        source = {v: k for k, v in gridfacets.items()}[source_dim]
        conn = grid.format_connectivity_as_dense(getattr(grid, f"{facet}_{source}_connectivity"))
        axis = obj.dims.index(source_dim)
        values = obj.data
        shape = tuple(values.shape)
        gathered = shape[:axis] + conn.shape + shape[axis + 1 :]
        if is_tensor(values):
            index = torch.from_numpy(np.maximum(conn, 0).ravel()).to(values.device)
            taken = values.index_select(axis, index).reshape(gathered)
        else:
            taken = np.take(values, np.maximum(conn, 0), axis=axis)
        mask_shape = [1] * len(shape)
        mask_shape[axis : axis + 1] = list(conn.shape)
        taken = where_nan(taken, (conn != -1).reshape(mask_shape))
        new_dims = obj.dims[:axis] + (target_dim, newdim) + obj.dims[axis + 1 :]
        mapped = xdata.DataArray(taken, dims=new_dims, name=obj.name, attrs=dict(obj.attrs))
        mapped._coords.update({k: v for k, v in obj._coords.items() if source_dim not in v.dims})
        return UgridDataArray(mapped, grid)

    def to_node(self, dim: str = "nmax"):
        """The data mapped to the nodes; ``dim`` holds the contributing
        entities."""
        return self._to_facet("node", dim)

    def to_edge(self, dim: str = "nmax"):
        """The data mapped to the edges; ``dim`` holds the contributing
        entities."""
        return self._to_facet("edge", dim)

    def to_face(self, dim: str = "nmax"):
        """The data mapped to the faces; ``dim`` holds the contributing
        entities."""
        return self._to_facet("face", dim)

    def reindex_like(self, other, tolerance: float = 0.0):
        """The array on ``other``'s topology (a grid, UgridDataArray or
        UgridDataset): the same entities in another order, matched by
        coordinates within ``tolerance``."""
        from xugrid_tpu_torch.core.wrap import UgridDataArray, UgridDataset
        from xugrid_tpu_torch.ugrid.ugrid1d import Ugrid1d
        from xugrid_tpu_torch.ugrid.ugrid2d import Ugrid2d

        if isinstance(other, (Ugrid1d, Ugrid2d)):
            other_grid = other
        elif isinstance(other, (UgridDataArray, UgridDataset)):
            other_grid = other.ugrid.grid
        else:
            raise TypeError(
                "Expected Ugrid1d, Ugrid2d, UgridDataArray, or UgridDataset, "
                f"received instead: {type(other).__name__}"
            )
        return UgridDataArray(self.grid.reindex_like(other_grid, obj=self.obj, tolerance=tolerance), other_grid)

    def set_crs(self, crs=None, epsg=None, allow_override: bool = False):
        """Set the CRS of the grid without transforming its geometry."""
        self.grid.set_crs(crs, epsg, allow_override)
        self.grid._update_coordinate_attrs(self.obj)

    def to_crs(self, crs=None, epsg=None):
        """Transform node geometry to a new CRS (needs pyproj)."""
        from xugrid_tpu_torch.core.wrap import UgridDataArray

        grid = self.grid.to_crs(crs, epsg)
        obj = grid._assign_derived_coords(self.obj)
        return UgridDataArray(obj, grid)

    def to_geodataframe(self, name: Optional[str] = None, dim_order=None):
        """Convert one facet's data and geometry to a GeoDataFrame; a
        tensor payload is copied to the host."""
        import geopandas as gpd

        dim = self.obj.dims[-1]
        if name is not None:
            ds = self.obj.rename(name).to_dataset()
        else:
            ds = self.obj.to_dataset()
        variables = [var for var in ds.data_vars if dim in ds._variables[var].dims]
        df = ds[variables].to_dataframe(dim_order=dim_order)
        geometry = self.grid.to_shapely(dim)
        return gpd.GeoDataFrame(df, geometry=geometry, crs=self.grid.crs)

    def interpolate_na(self, method: str = "nearest", max_distance: Optional[float] = None):
        """
        Fill NaNs with the value of the nearest non-NaN entity: by
        distance on a 2D grid (the search on the payload's device from
        ``spatial/nearest.py``'s threshold), along the network (Dijkstra)
        on a 1D one; NaN beyond ``max_distance``.  The result is float64,
        on the payload's device.
        """
        from xugrid_tpu_torch.core.wrap import UgridDataArray
        from xugrid_tpu_torch.ugrid.interpolate import interpolate_na_helper

        if method != "nearest":
            raise ValueError(f'"{method}" is not a valid interpolator.')
        if max_distance is None:
            max_distance = np.inf
        grid = self.grid
        ugrid_dim = grid.find_ugrid_dim(self.obj)
        filled = interpolate_na_helper(
            self.obj,
            ugrid_dim=ugrid_dim,
            func=grid._nearest_interpolate,
            kwargs={"ugrid_dim": ugrid_dim, "max_distance": max_distance},
        )
        return UgridDataArray(filled, grid)

    def _binary_iterate(self, iterations, mask, value, border_value):
        """The bool face payload dilated (``value`` True) or eroded along
        the face adjacency: scipy on the host (a tensor payload and mask
        copied there explicitly), the result on the payload's device."""
        from xugrid_tpu_torch.core.wrap import UgridDataArray

        if border_value == value:
            exterior = self.grid.exterior_faces
        else:
            exterior = None
        if mask is not None:
            mask = to_numpy(mask.data if hasattr(mask, "data") else mask)
        obj = self.obj
        if not isinstance(obj, xdata.DataArray):
            raise ValueError("object should be an xdata.DataArray")
        output = connectivity._binary_iterate(
            self.grid.face_face_connectivity, to_numpy(obj.data), value, iterations, mask, exterior, border_value
        )
        if is_tensor(obj.data):
            output = torch.from_numpy(output).to(obj.data.device)
        da = xdata.DataArray(output, dims=obj.dims, name=obj.name, attrs=dict(obj.attrs))
        da._coords.update(obj._coords)
        return UgridDataArray(da, self.grid.copy())

    def binary_dilation(self, iterations: int = 1, mask=None, border_value=False):
        """True faces grown by ``iterations`` steps along the face
        adjacency; ``mask`` faces forced False after every step, the
        exterior faces set True after the first where ``border_value``."""
        return self._binary_iterate(iterations, mask, True, border_value)

    def binary_erosion(self, iterations: int = 1, mask=None, border_value=False):
        """True faces shrunk by ``iterations`` steps along the face
        adjacency; ``mask`` faces forced True after every step, the
        exterior faces set False after the first unless ``border_value``."""
        return self._binary_iterate(iterations, mask, False, border_value)

    def connected_components(self):
        """The label of each face's connected component of the face
        adjacency (scipy), on the payload's device."""
        from xugrid_tpu_torch.core.wrap import UgridDataArray

        _, labels = scipy.sparse.csgraph.connected_components(self.grid.face_face_connectivity)
        device = payload_device(self.obj)
        if device is not None:
            labels = torch.from_numpy(labels).to(device)
        return UgridDataArray(xdata.DataArray(labels, dims=(self.grid.face_dimension,)), self.grid)

    def reverse_cuthill_mckee(self):
        """The array on the grid with its faces in reverse Cuthill-McKee
        order (``Ugrid2d.reverse_cuthill_mckee``), its payload reordered
        on its device."""
        from xugrid_tpu_torch.core.wrap import UgridDataArray

        grid = self.grid
        reordered_grid, reordering = grid.reverse_cuthill_mckee()
        return UgridDataArray(self.obj.isel({grid.face_dimension: reordering}), reordered_grid)

    def label_partitions(self, n_part: int):
        """Partition labels of the grid with this array's integer values
        on the core dimension as the weights (a tensor payload is copied
        to the host)."""
        obj = self.obj
        grid = self.grid
        if tuple(obj.dims) != (grid.core_dimension,):
            raise ValueError(f"Weights must be associated with the core-dimension of the grid: {grid.core_dimension}")
        return grid.label_partitions(n_part=n_part, weights=obj.values)

    def to_dataset(self, optional_attributes: bool = False):
        """The array (named ``{grid}_data`` when unnamed) and the UGRID
        variables of its topology as one Dataset."""
        obj = self.obj
        if obj.name is None:
            obj = obj.rename(f"{self.grid.name}_data")
        return self.grid.to_dataset(obj.to_dataset(), optional_attributes)

    def laplace_interpolate(
        self,
        xy_weights: bool = True,
        direct_solve: bool = False,
        delta=0.0,
        relax=0.0,
        rtol: float = 0.0,
        atol: float = 1.0e-4,
        maxiter: int = 500,
        precondition_degree: int = 4,
        device=None,
    ):
        """
        Fill NaNs by solving Laplace's equation over the node or face
        adjacency, with the known values as boundary conditions: the
        port's ``laplace_interpolate`` (a Chebyshev-Jacobi preconditioned
        CG whose SpMV is the CUDA kernel ``csr_matvec``).  Slices of the
        extra dimensions that share one NaN pattern are solved together,
        as one batched solve.  ``delta`` and ``relax`` are accepted for
        the reference's signature and unused.

        The solve runs in float64 on ``device``: None means the device of
        a tensor payload, else the CUDA card; pass ``device="cpu"``
        without one.  The right-hand sides are built on the host, so a
        tensor payload is copied there for the solve; the result is
        float64, a tensor on the payload's device for a tensor payload,
        numpy for numpy.
        """
        from xugrid_tpu_torch.core.wrap import UgridDataArray
        from xugrid_tpu_torch.ugrid.interpolate import interpolate_na_helper, laplace_interpolate

        grid = self.grid
        da = self.obj
        ugrid_dim = grid.find_ugrid_dim(da)
        if ugrid_dim == grid.edge_dimension:
            raise ValueError("Laplace interpolation along edges is not allowed.")
        with timed("accessor.connectivity"):
            conn = grid.get_connectivity_matrix(ugrid_dim, xy_weights=xy_weights)
        with timed("accessor.components"):
            _, components_labels = scipy.sparse.csgraph.connected_components(conn)
        with timed("accessor.fill"):
            da_filled = interpolate_na_helper(
                da,
                ugrid_dim,
                func=laplace_interpolate,
                kwargs={
                    "connectivity": conn,
                    "use_weights": xy_weights,
                    "components_labels": components_labels,
                    "direct_solve": direct_solve,
                    "delta": delta,
                    "relax": relax,
                    "rtol": rtol,
                    "atol": atol,
                    "maxiter": maxiter,
                    "precondition_degree": precondition_degree,
                },
                device=device,
            )
        return UgridDataArray(da_filled, grid)
