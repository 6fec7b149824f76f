"""Plotting: artists and facet grids (matplotlib imported inside the
functions)."""

from xugrid_tpu_torch.plot.facetgrid import FacetGrid
from xugrid_tpu_torch.plot.plot import (
    contour,
    contourf,
    imshow,
    line,
    pcolormesh,
    scatter,
    surface,
    tripcolor,
)

__all__ = [
    "FacetGrid",
    "contour",
    "contourf",
    "imshow",
    "line",
    "pcolormesh",
    "scatter",
    "surface",
    "tripcolor",
]
