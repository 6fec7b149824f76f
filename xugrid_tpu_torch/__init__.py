"""
xugrid_tpu_torch: the PyTorch and CUDA port of xugrid_tpu, for one
NVIDIA H100.

It covers:
- labelled arrays: ``xdata`` (DataArray, Dataset; coordinates numpy on
  the host, payloads numpy or torch tensors that stay on their device),
  ``UgridDataArray`` / ``UgridDataset`` over a ``Ugrid2d`` or
  ``Ugrid1d``, the ``.ugrid`` accessor's topology and Laplace fill, and
  ``concat``/``merge``/``full_like``/``zeros_like``/``ones_like``;
- files: UGRID conventions (``ugrid_roles``), ``Ugrid2d``/``Ugrid1d``
  ``from_dataset``/``to_dataset``, eager netCDF and zarr reading and
  writing (``open_dataset``, ``open_zarr``, ``.ugrid.to_netcdf``,
  ``.ugrid.to_zarr``), and regridder weights stored with
  ``to_dataset`` and reloaded with ``from_dataset``;
- topology subsets (``isel`` and box ``sel`` along a UGRID dimension,
  ``clip_box``), partitions (``.ugrid.partition``, ``label_partitions``)
  and ``merge_partitions``, which reassembles a partitioned run;
- queries: the nearest node, edge or face (scipy's KDTree, or a tiled
  distance scan on the card for large batches, ``spatial/nearest.py``),
  selections at points (``.ugrid.sel_points``) and along lines
  (``intersect_line``, ``intersect_linestring``, ``sel`` of a slice and a
  value), ``rasterize``/``rasterize_like``, the remaps between facets
  (``to_node``, ``to_edge``, ``to_face``), ``reindex_like``, and the
  nearest fill ``.ugrid.interpolate_na`` (Dijkstra along a network);
- the regridders between 2D meshes and rasters (overlap, centroid
  locator, barycentric interpolation: in the centroidal voronoi
  tessellation, or bilinear between rasters) and from a 1D network onto
  a mesh or raster (``NetworkGridder``): weights built on the host from
  the geometry (faces above the native kernels' sizes on the device),
  applied on the device by two hand-written CUDA kernels,
  ``csrc/window_reduce.cu`` and ``csrc/window_select.cu`` (the centroid
  locator is a row gather);
- the Laplace fill (``ugrid/interpolate.py``, a preconditioned CG whose
  SpMV is the CUDA kernel ``csr_matvec``);
- vector geometry: ``burn_vector_geometry`` and
  ``earcut_triangulate_polygons`` (``ops/earcut.py``), ``snap_nodes``,
  ``snap_to_grid``, ``polygonize``, and the conversions to and from
  shapely geometry and GeoDataFrames (shapely and geopandas imported
  where they are used); and the sample datasets of ``data``;
- curvilinear grids from (N, M, 4) corner bounds or 2D coordinates, and
  voxel and layered 3-D grids (``regrid.StructuredGrid3d``,
  ``ExplicitStructuredGrid3d``);
- ``parallel``: the regrid, a Jacobi smoothing and a CG solve sharded
  over the ranks of a ``torch.distributed`` process group, each rank
  running the kernels on its block;
- ``utils.profiling``: host stage timings, ``trace`` (a
  ``torch.profiler`` trace) and ``annotate``; and the meshkernel bridge,
  imported where it is used;
- ``spatial``: a flat BVH (``build_bvh``) and its batched queries as
  torch ops on the card (``spatial/queries.py``: point location on faces
  and edges, box joins, exact segment clips and point tests);
- ``plot`` (matplotlib, imported where it is used): the grids' and
  ``.ugrid.plot``'s artists and facet grids, drawn on the host.

Entry points run on the CUDA card unless the caller asks for the CPU.
The package imports torch, numpy, scipy and pandas, and never jax,
xugrid_tpu or (at import) matplotlib.
"""

from xugrid_tpu_torch import data, xdata
from xugrid_tpu_torch.constants import FILL_VALUE
from xugrid_tpu_torch.core.common import (
    concat,
    full_like,
    load_dataarray,
    load_dataset,
    merge,
    ones_like,
    open_dataarray,
    open_dataset,
    open_mfdataset,
    open_zarr,
    zeros_like,
)
from xugrid_tpu_torch.core.dataarray_accessor import UgridDataArrayAccessor
from xugrid_tpu_torch.core.dataset_accessor import UgridDatasetAccessor
from xugrid_tpu_torch.core.wrap import UgridDataArray, UgridDataset
from xugrid_tpu_torch.plot import plot
from xugrid_tpu_torch.regrid.gridder import NetworkGridder
from xugrid_tpu_torch.regrid.regridder import (
    BarycentricInterpolator,
    CentroidLocatorRegridder,
    OverlapRegridder,
    RelativeOverlapRegridder,
)
from xugrid_tpu_torch.ugrid.burn import burn_vector_geometry, earcut_triangulate_polygons
from xugrid_tpu_torch.ugrid.conventions import UgridRolesAccessor, ugrid_roles
from xugrid_tpu_torch.ugrid.partitioning import merge_partitions
from xugrid_tpu_torch.ugrid.polygonize import polygonize
from xugrid_tpu_torch.ugrid.snapping import create_snap_to_grid_dataframe, snap_nodes, snap_to_grid
from xugrid_tpu_torch.ugrid.ugrid1d import Ugrid1d
from xugrid_tpu_torch.ugrid.ugrid2d import Ugrid2d
from xugrid_tpu_torch.ugrid.ugridbase import AbstractUgrid

__all__ = [
    "FILL_VALUE",
    "AbstractUgrid",
    "BarycentricInterpolator",
    "CentroidLocatorRegridder",
    "NetworkGridder",
    "OverlapRegridder",
    "RelativeOverlapRegridder",
    "Ugrid1d",
    "Ugrid2d",
    "UgridDataArray",
    "UgridDataArrayAccessor",
    "UgridDataset",
    "UgridDatasetAccessor",
    "UgridRolesAccessor",
    "burn_vector_geometry",
    "concat",
    "create_snap_to_grid_dataframe",
    "data",
    "earcut_triangulate_polygons",
    "full_like",
    "load_dataarray",
    "load_dataset",
    "merge",
    "merge_partitions",
    "ones_like",
    "open_dataarray",
    "open_dataset",
    "open_mfdataset",
    "open_zarr",
    "plot",
    "polygonize",
    "snap_nodes",
    "snap_to_grid",
    "ugrid_roles",
    "xdata",
    "zeros_like",
]
