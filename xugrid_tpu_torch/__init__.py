"""
xugrid_tpu_torch: the PyTorch and CUDA port of xugrid_tpu, for one
NVIDIA H100.

This slice covers the overlap regrid: weights built on the host from
the mesh geometry, applied on the device by two hand-written CUDA
kernels (``csrc/window_reduce.cu``, ``csrc/window_select.cu``).  The
package imports torch, numpy and scipy, and never jax or xugrid_tpu.
"""

from xugrid_tpu_torch.regrid.regridder import OverlapRegridder, RelativeOverlapRegridder
from xugrid_tpu_torch.ugrid.ugrid2d import Ugrid2d

__all__ = ["OverlapRegridder", "RelativeOverlapRegridder", "Ugrid2d"]
