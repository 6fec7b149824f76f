"""Regridders, the apply, and its kernels."""
from xugrid_tpu_torch.regrid.gridder import NetworkGridder
from xugrid_tpu_torch.regrid.regridder import (
    BarycentricInterpolator,
    CentroidLocatorRegridder,
    OverlapRegridder,
    RelativeOverlapRegridder,
)
from xugrid_tpu_torch.regrid.structured import (
    ExplicitStructuredGrid3d,
    StructuredGrid1d,
    StructuredGrid2d,
    StructuredGrid3d,
)
from xugrid_tpu_torch.regrid.unstructured import Network1d, UnstructuredGrid2d

__all__ = [
    "BarycentricInterpolator",
    "CentroidLocatorRegridder",
    "NetworkGridder",
    "OverlapRegridder",
    "RelativeOverlapRegridder",
    "StructuredGrid1d",
    "StructuredGrid2d",
    "StructuredGrid3d",
    "ExplicitStructuredGrid3d",
    "UnstructuredGrid2d",
    "Network1d",
]
