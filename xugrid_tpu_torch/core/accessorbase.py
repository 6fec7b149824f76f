"""
What the ``.ugrid`` accessors of UgridDataArray and UgridDataset share:
the box clip, the partitions, rasterization, and writing the data with
its topologies as a UGRID netCDF file or zarr store.  The port of
``xugrid_tpu/core/accessorbase.py``.
"""

from __future__ import annotations

import abc

import numpy as np
import torch

from xugrid_tpu_torch import xdata
from xugrid_tpu_torch.ugrid.ugrid2d import raster_xy
from xugrid_tpu_torch.xdata.variable import is_tensor


def where_nan(values, mask):
    """``values`` where ``mask`` holds, else NaN, with numpy's promotion
    (``np.where(mask, values, np.nan)``): an integer or bool payload
    comes back float64, a floating one keeps its dtype.  A tensor stays
    on its device."""
    if is_tensor(values):
        if not values.dtype.is_floating_point:
            values = values.double()
        mask = torch.as_tensor(mask, device=values.device)
        return torch.where(mask, values, torch.tensor(np.nan, dtype=values.dtype, device=values.device))
    return np.where(mask, values, np.nan)


def payload_device(obj):
    """The device of ``obj``'s tensor payload (a DataArray's, or a
    Dataset's first tensor variable's), None for numpy payloads: where a
    query on the accessor may search."""
    arrays = [obj.data] if isinstance(obj, xdata.DataArray) else [obj[name].data for name in obj.data_vars]
    return next((a.device for a in arrays if is_tensor(a)), None)


class AbstractUgridAccessor(abc.ABC):
    _raster_xy = staticmethod(raster_xy)

    def _raster(self, x, y, index):
        """The face data sampled at a raster's cells (``raster``)."""
        return raster(self.obj, self.grid, x, y, index)

    @abc.abstractmethod
    def to_dataset(self, optional_attributes: bool = False):
        """The data and its topology variables as one xdata.Dataset."""

    @abc.abstractmethod
    def sel(self, x=None, y=None):
        """Selection in UGRID x and y."""

    @property
    def crs(self) -> dict:
        """Mapping from grid name to its CRS (None where unset)."""
        return {grid.name: grid.crs for grid in self.grids}

    def clip_box(self, xmin: float, ymin: float, xmax: float, ymax: float):
        """The data and topology in a bounding box."""
        return self.sel(x=slice(xmin, xmax), y=slice(ymin, ymax))

    def partition_by_label(self, labels):
        """The grid and data split by integer labels on the grid's core
        dimension: a list of UgridDataArray or UgridDataset."""
        from xugrid_tpu_torch.ugrid import partitioning

        return partitioning.partition_by_label(self.grid, self.obj, labels)

    def partition(self, n_part: int):
        """The grid and data split into ``n_part`` parts
        (``grid.label_partitions``)."""
        return self.partition_by_label(self.grid.label_partitions(n_part))

    def to_netcdf(self, *args, **kwargs):
        """Write as a UGRID netCDF file (topology variables included); a
        tensor payload is copied to the host."""
        self.to_dataset().to_netcdf(*args, **kwargs)

    def to_zarr(self, *args, **kwargs):
        """Write as a UGRID zarr store (topology variables included); a
        tensor payload is copied to the host."""
        self.to_dataset().to_zarr(*args, **kwargs)


def raster(obj, grid, x, y, index):
    """The face data of ``obj`` on ``grid`` sampled at a raster's cells:
    the face ``index`` (y.size, x.size) holds, NaN where it is -1, as a
    DataArray (..., y, x); a Dataset passes its variables on other
    dimensions through.  A tensor payload is gathered on its device."""
    index2d = np.asarray(index).reshape(y.size, x.size)
    face_dim = grid.face_dimension
    taken = obj.isel({face_dim: np.maximum(index2d.ravel(), 0)})
    if isinstance(taken, xdata.Dataset):
        out = xdata.Dataset(attrs=dict(taken.attrs))
        for name in taken.data_vars:
            var = taken[name]
            out[name] = _reshape_raster_var(var, face_dim, index2d, x, y) if face_dim in var.dims else var
        return out
    return _reshape_raster_var(taken, face_dim, index2d, x, y)


def _reshape_raster_var(da, face_dim, index2d, x, y):
    """A DataArray gathered at the raster's flattened face index, with
    its face dimension unfolded into (y, x) last and masked to NaN."""
    values = da.data
    axis = da.dims.index(face_dim)
    if is_tensor(values):
        values = torch.movedim(values, axis, -1)
    else:
        values = np.moveaxis(np.asarray(values), axis, -1)
    values = where_nan(values.reshape(tuple(values.shape[:-1]) + index2d.shape), index2d != -1)
    other_dims = tuple(d for d in da.dims if d != face_dim)
    out = xdata.DataArray(values, dims=other_dims + ("y", "x"), name=da.name, attrs=dict(da.attrs))
    out._coords.update({k: v for k, v in da._coords.items() if face_dim not in v.dims})
    return out.assign_coords(y=y, x=x)
