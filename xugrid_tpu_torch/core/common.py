"""
Top-level file readers and combination functions over UgridDataArrays
and UgridDatasets (``xugrid_tpu/core/common.py``): the readers open a
UGRID netCDF file or zarr store into host arrays (or, with
``lazy=True``, its large variables as ``LazyArray`` row loaders) and
read its topologies; the combinations are the xdata ones, with the grids
carried over.
"""

from __future__ import annotations

from xugrid_tpu_torch import xdata
from xugrid_tpu_torch.core.utils import unique_grids
from xugrid_tpu_torch.core.wrap import UgridDataArray, UgridDataset, maybe_xdata
from xugrid_tpu_torch.ugrid.conventions import ugrid_roles


def _dataset_helper(ds: xdata.Dataset) -> UgridDataset:
    if len(ugrid_roles(ds).topology) == 0:
        raise ValueError(
            "The file or object does not contain UGRID conventions data: "
            "no variable with the attribute cf_role: mesh_topology was found."
        )
    return UgridDataset(ds)


def open_dataset(path, **kwargs) -> UgridDataset:
    """Open a UGRID netCDF file as a UgridDataset (host arrays; ``lazy=True``
    leaves the large variables on disk as ``LazyArray`` row loaders)."""
    return _dataset_helper(xdata.open_dataset(path, **kwargs))


def load_dataset(path, **kwargs) -> UgridDataset:
    """Open a UGRID netCDF file (``open_dataset``)."""
    return open_dataset(path, **kwargs)


def open_dataarray(path, **kwargs) -> UgridDataArray:
    """Open a UGRID netCDF file holding a single data variable."""
    uds = open_dataset(path, **kwargs)
    data_vars = list(uds.obj.data_vars)
    if len(data_vars) != 1:
        raise ValueError(
            f"The file contains more than one data variable: use open_dataset instead. Found: {data_vars}"
        )
    return uds[data_vars[0]]


def load_dataarray(path, **kwargs) -> UgridDataArray:
    return open_dataarray(path, **kwargs)


def open_zarr(store, **kwargs) -> UgridDataset:
    """Open a UGRID zarr store as a UgridDataset (host arrays, or
    ``LazyArray`` row loaders with ``lazy=True``)."""
    return _dataset_helper(xdata.open_zarr(store, **kwargs))


def open_mfdataset(paths, **kwargs) -> UgridDataset:
    """Open several UGRID netCDF files (a list, or a glob pattern) and
    merge them."""
    if isinstance(paths, str):
        import glob

        paths = sorted(glob.glob(paths))
    datasets = [xdata.open_dataset(p, **kwargs) for p in paths]
    merged = datasets[0]
    for ds in datasets[1:]:
        merged = merged.merge(ds)
    return _dataset_helper(merged)


def _unwrap_grids(objects):
    """The distinct grids of the wrapped objects, in order."""
    grids = []
    for obj in objects:
        if isinstance(obj, (UgridDataArray, UgridDataset)):
            grids.extend(obj.grids)
    return unique_grids(grids)


def concat(objs, *args, **kwargs):
    """Concatenate UgridDataArrays or UgridDatasets (``xdata.concat``'s
    arguments); the grids must match."""
    grids = _unwrap_grids(objs)
    result = xdata.concat([maybe_xdata(o) for o in objs], *args, **kwargs)
    if isinstance(result, xdata.DataArray):
        return UgridDataArray(result, grids[0])
    return UgridDataset(result, grids)


def merge(objs, *args, **kwargs):
    """Merge UgridDataArrays and UgridDatasets into a UgridDataset
    (``xdata.merge``'s arguments)."""
    grids = _unwrap_grids(objs)
    return UgridDataset(xdata.merge([maybe_xdata(o) for o in objs], *args, **kwargs), grids)


def full_like(other, fill_value, *args, **kwargs):
    """A UgridDataArray or UgridDataset like ``other``, filled with
    ``fill_value`` (``xdata.full_like``'s arguments; a tensor payload
    gives one on its device)."""
    result = xdata.full_like(maybe_xdata(other), fill_value, *args, **kwargs)
    if isinstance(other, UgridDataArray):
        return UgridDataArray(result, other.grid)
    if isinstance(other, UgridDataset):
        return UgridDataset(result, other.grids)
    return result


def zeros_like(other, *args, **kwargs):
    return full_like(other, 0, *args, **kwargs)


def ones_like(other, *args, **kwargs):
    return full_like(other, 1, *args, **kwargs)
