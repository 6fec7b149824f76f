"""
The ``.ugrid`` accessor of a UgridDataset: its topologies, renaming,
coordinate assignment, the conversion to a UGRID dataset, box, line and
point selections, rasterization, the periodic conversion, reindexing
and partitions.  The port
of ``xugrid_tpu/core/dataset_accessor.py`` reduced to these; the rest of
the accessor is not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from xugrid_tpu_torch import xdata
from xugrid_tpu_torch.core.accessorbase import AbstractUgridAccessor, payload_device, raster
from xugrid_tpu_torch.core.wrap import UgridDataArray, UgridDataset


class UgridDatasetAccessor(AbstractUgridAccessor):
    """Operations using the UGRID topologies, via ``uds.ugrid``."""

    def __init__(self, obj: xdata.Dataset, grids):
        self.obj = obj
        self.grids = grids

    @property
    def grid(self):
        """The single grid (raises for several topologies)."""
        if len(self.grids) != 1:
            raise ValueError(f"Can only call .grid with a single topology, found: {len(self.grids)}")
        return self.grids[0]

    @property
    def name(self) -> str:
        """Name of the single topology."""
        return self.grid.name

    @property
    def names(self):
        """Names of all topologies."""
        return [grid.name for grid in self.grids]

    @property
    def topology(self) -> dict:
        """Mapping from name to topology."""
        return {grid.name: grid for grid in self.grids}

    @property
    def bounds(self) -> dict:
        """Mapping from grid name to (minx, miny, maxx, maxy)."""
        return {grid.name: grid.bounds for grid in self.grids}

    @property
    def total_bounds(self):
        """(minx, miny, maxx, maxy) over all topologies."""
        bounds = np.array(list(self.bounds.values()))
        return (bounds[:, 0].min(), bounds[:, 1].min(), bounds[:, 2].max(), bounds[:, 3].max())

    def _single_grid_for(self, method: str):
        if len(self.grids) != 1:
            raise ValueError(
                f".{method} requires a single grid, found {len(self.grids)}. Select a single topology first."
            )
        return self.grids[0]

    def rename(self, name_dict=None, **names) -> UgridDataset:
        """Rename topologies: ``{old_name: new_name}``, or a single name
        when only one topology is present."""
        if isinstance(name_dict, str):
            name_dict = {self._single_grid_for("rename").name: name_dict}
        mapping = dict(name_dict or {})
        mapping.update(names)
        obj = self.obj
        new_grids = []
        for grid in self.grids:
            if grid.name in mapping:
                new_grid, name_dict_grid = grid.rename(mapping[grid.name], return_name_dict=True)
                present = tuple(obj._variables) + tuple(obj.dims_sizes())
                obj = obj.rename({k: v for k, v in name_dict_grid.items() if k in present})
                new_grids.append(new_grid)
            else:
                new_grids.append(grid)
        return UgridDataset(obj, new_grids)

    def assign_node_coords(self) -> UgridDataset:
        """The dataset with every grid's node coordinates."""
        obj = self.obj
        for grid in self.grids:
            obj = grid.assign_node_coords(obj)
        return UgridDataset(obj, self.grids)

    def assign_edge_coords(self) -> UgridDataset:
        """The dataset with every grid's edge coordinates."""
        obj = self.obj
        for grid in self.grids:
            obj = grid.assign_edge_coords(obj)
        return UgridDataset(obj, self.grids)

    def assign_face_coords(self) -> UgridDataset:
        """The dataset with every 2D grid's face coordinates."""
        obj = self.obj
        for grid in self.grids:
            if grid.topology_dimension == 2:
                obj = grid.assign_face_coords(obj)
        return UgridDataset(obj, self.grids)

    def set_node_coords(self, node_x: str, node_y: str, topology: Optional[str] = None):
        """Use dataset coordinates as the node coordinates of a topology."""
        grid = self._single_grid_for("set_node_coords") if topology is None else self.topology[topology]
        grid.set_node_coords(node_x, node_y, self.obj)

    def sel(self, x=None, y=None):
        """Selection in UGRID x and y over every topology: a box (two
        slices) gives a UgridDataset; a line (a slice and a value) or
        points (values) a Dataset with the section's or the points'
        coordinates."""
        result = self.obj
        new_grids = []
        for grid in self.grids:
            out = grid.sel(result, x, y)
            if isinstance(out, tuple):
                result, new_grid = out
                new_grids.append(new_grid)
            else:
                result = out
        if new_grids:
            return UgridDataset(result, new_grids)
        return result

    def sel_points(self, x, y, method=None, out_of_bounds="warn", fill_value=np.nan, tolerance=None):
        """The values at the points (x[i], y[i]) over every topology, the
        nearest searches on the payload's device."""
        device = payload_device(self.obj)
        result = self.obj
        for grid in self.grids:
            result = grid.sel_points(result, x, y, method, out_of_bounds, fill_value, tolerance, device=device)
        return result

    def rasterize(self, resolution: float):
        """Every face variable sampled on a regular raster of cell size
        ``resolution`` over the single grid: a Dataset (..., y, x)."""
        grid = self._single_grid_for("rasterize")
        x, y, index = grid.rasterize(resolution)
        return self._raster_dataset(grid, x, y, index)

    def rasterize_like(self, other):
        """Every face variable sampled at the x and y coordinates of
        ``other``."""
        grid = self._single_grid_for("rasterize_like")
        x, y, index = grid.rasterize_like(x=np.asarray(other["x"].values), y=np.asarray(other["y"].values))
        return self._raster_dataset(grid, x, y, index)

    def _raster_dataset(self, grid, x, y, index):
        return raster(self.obj, grid, x, y, index)

    def to_periodic(self) -> UgridDataset:
        """The dataset on every grid made periodic, its payloads aligned
        on their devices."""
        obj = self.obj
        new_grids = []
        for grid in self.grids:
            new_grid, obj = grid.to_periodic(obj=obj)
            new_grids.append(new_grid)
        return UgridDataset(obj, new_grids)

    def to_nonperiodic(self, xmax: float) -> UgridDataset:
        """The dataset on every grid split at its periodic boundary, the
        new nodes at x = ``xmax``."""
        obj = self.obj
        new_grids = []
        for grid in self.grids:
            new_grid, obj = grid.to_nonperiodic(xmax=xmax, obj=obj)
            new_grids.append(new_grid)
        return UgridDataset(obj, new_grids)

    def intersect_line(self, start: Sequence[float], end: Sequence[float]):
        """The values along the line from start to end, for every topology."""
        result = self.obj
        for grid in self.grids:
            result = grid.intersect_line(result, start, end)
        return result

    def intersect_linestring(self, linestring):
        """The values along a linestring, for every topology."""
        result = self.obj
        for grid in self.grids:
            result = grid.intersect_linestring(result, linestring)
        return result

    def reindex_like(self, other, tolerance: float = 0.0) -> UgridDataset:
        """The dataset on ``other``'s topologies (a grid, UgridDataArray or
        UgridDataset), matched by name: the same entities in another
        order, matched by coordinates within ``tolerance``."""
        from xugrid_tpu_torch.ugrid.ugrid1d import Ugrid1d
        from xugrid_tpu_torch.ugrid.ugrid2d import Ugrid2d

        if isinstance(other, (Ugrid1d, Ugrid2d)):
            other_grids = {other.name: other}
        elif isinstance(other, UgridDataset):
            other_grids = {grid.name: grid for grid in other.grids}
        elif isinstance(other, UgridDataArray):
            other_grids = {other.grid.name: other.grid}
        else:
            raise TypeError(
                "Expected Ugrid1d, Ugrid2d, UgridDataArray, or UgridDataset, "
                f"received instead: {type(other).__name__}"
            )
        obj = self.obj
        new_grids = []
        for grid in self.grids:
            other_grid = other_grids.get(grid.name)
            if other_grid is not None:
                obj = grid.reindex_like(other_grid, obj=obj, tolerance=tolerance)
                new_grids.append(other_grid)
            else:
                new_grids.append(grid)
        return UgridDataset(obj, new_grids)

    def set_crs(self, crs=None, epsg=None, allow_override: bool = False, topology: Optional[str] = None):
        """Set the CRS of one or all topologies without transforming their
        geometry."""
        grids = self.grids if topology is None else [self.topology[topology]]
        for grid in grids:
            grid.set_crs(crs, epsg, allow_override)
            grid._update_coordinate_attrs(self.obj)

    def to_crs(self, crs=None, epsg=None, topology: Optional[str] = None):
        """Transform one or all topologies to a new CRS (needs pyproj)."""
        obj = self.obj
        new_grids = []
        for grid in self.grids:
            if topology is None or grid.name == topology:
                new_grid = grid.to_crs(crs, epsg)
                obj = new_grid._assign_derived_coords(obj)
            else:
                new_grid = grid
            new_grids.append(new_grid)
        return UgridDataset(obj, new_grids)

    def to_geodataframe(self, dim: Optional[str] = None, name: Optional[str] = None, dim_order=None):
        """Convert facet data and geometry of all grids to a GeoDataFrame;
        tensor payloads are copied to the host."""
        import geopandas as gpd
        import pandas as pd

        frames = []
        for grid in self.grids:
            for facet_dim in grid.dims:
                if dim is not None and facet_dim != dim:
                    continue
                variables = [var for var in self.obj.data_vars if facet_dim in self.obj._variables[var].dims]
                if not variables:
                    continue
                df = self.obj[variables].to_dataframe(dim_order=dim_order)
                geometry = grid.to_shapely(facet_dim)
                frames.append(gpd.GeoDataFrame(df, geometry=geometry, crs=grid.crs))
        if not frames:
            raise ValueError(
                "Unable to convert to GeoDataFrame: no data variables are "
                "associated with any UGRID dimension."
            )
        if len(frames) == 1:
            return frames[0]
        return pd.concat(frames)

    def to_dataset(self, optional_attributes: bool = False):
        """The data and every topology's UGRID variables as one Dataset."""
        ds = self.obj
        for grid in self.grids:
            ds = grid.to_dataset(ds, optional_attributes)
        return ds
