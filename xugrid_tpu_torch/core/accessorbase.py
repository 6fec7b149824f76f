"""
What the ``.ugrid`` accessors of UgridDataArray and UgridDataset share:
the box clip, the partitions, and writing the data with its topologies
as a UGRID netCDF file or zarr store.  The port of
``xugrid_tpu/core/accessorbase.py`` without its rasterization.
"""

from __future__ import annotations

import abc


class AbstractUgridAccessor(abc.ABC):
    @abc.abstractmethod
    def to_dataset(self, optional_attributes: bool = False):
        """The data and its topology variables as one xdata.Dataset."""

    @abc.abstractmethod
    def sel(self, x=None, y=None):
        """Selection in UGRID x and y."""

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
