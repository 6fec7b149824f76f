"""
xugrid_tpu_torch: the PyTorch and CUDA port of xugrid_tpu, for one
NVIDIA H100.

It covers the regridders between 2D meshes (overlap, centroid locator,
barycentric interpolation in the centroidal voronoi tessellation) and
from a 1D network onto a 2D mesh (``NetworkGridder``): weights built on
the host from the mesh geometry, applied on the device by two
hand-written CUDA kernels, ``csrc/window_reduce.cu`` and
``csrc/window_select.cu`` (the centroid locator is a row gather); and
the Laplace fill (``ugrid/interpolate.py``, a preconditioned CG whose
SpMV is the CUDA kernel ``csr_matvec``).  Entry points run on the CUDA
card unless the caller asks for the CPU.  The package imports torch,
numpy and scipy, and never jax or xugrid_tpu.
"""

from xugrid_tpu_torch.regrid.gridder import NetworkGridder
from xugrid_tpu_torch.regrid.regridder import (
    BarycentricInterpolator,
    CentroidLocatorRegridder,
    OverlapRegridder,
    RelativeOverlapRegridder,
)
from xugrid_tpu_torch.ugrid.ugrid1d import Ugrid1d
from xugrid_tpu_torch.ugrid.ugrid2d import Ugrid2d

__all__ = [
    "BarycentricInterpolator",
    "CentroidLocatorRegridder",
    "NetworkGridder",
    "OverlapRegridder",
    "RelativeOverlapRegridder",
    "Ugrid1d",
    "Ugrid2d",
]
