"""
meshkernel bridge helpers (optional dependency), copied from
``xugrid_tpu/meshkernel_utils.py``: meshkernel is imported when this
module is, and stands in as a ``MissingOptionalModule`` that raises on
use where it is not installed.
"""

from __future__ import annotations

import numpy as np

from xugrid_tpu_torch.constants import MissingOptionalModule

try:
    import meshkernel as mk
except ImportError:
    mk = MissingOptionalModule("meshkernel")


def either_string_or_enum(value, enum_class):
    """Coerce a string (case-insensitive) into the given meshkernel enum."""
    if isinstance(value, str):
        name = value.upper()
        members = {m.name: m for m in enum_class}
        if name not in members:
            raise ValueError(f"Invalid option {value}: choose from {[m.name.lower() for m in enum_class]}")
        return members[name]
    if isinstance(value, enum_class):
        return value
    raise TypeError(f"Expected str or {enum_class.__name__}, got: {type(value).__name__}")


def to_geometry_list(polygon) -> "mk.GeometryList":
    """Convert a shapely polygon to a meshkernel GeometryList."""
    import shapely

    if not isinstance(polygon, shapely.Polygon):
        raise TypeError(f"Expected shapely Polygon, got: {type(polygon).__name__}")
    x, y = shapely.get_coordinates(polygon.exterior).T.astype(np.float64)
    return mk.GeometryList(x, y)
