"""
What the ``.ugrid`` accessors of UgridDataArray and UgridDataset share:
writing the data with its topologies as a UGRID netCDF file or zarr
store.  The port of ``xugrid_tpu/core/accessorbase.py``'s writers.
"""

from __future__ import annotations

import abc


class AbstractUgridAccessor(abc.ABC):
    @abc.abstractmethod
    def to_dataset(self, optional_attributes: bool = False):
        """The data and its topology variables as one xdata.Dataset."""

    def to_netcdf(self, *args, **kwargs):
        """Write as a UGRID netCDF file (topology variables included); a
        tensor payload is copied to the host."""
        self.to_dataset().to_netcdf(*args, **kwargs)

    def to_zarr(self, *args, **kwargs):
        """Write as a UGRID zarr store (topology variables included); a
        tensor payload is copied to the host."""
        self.to_dataset().to_zarr(*args, **kwargs)
