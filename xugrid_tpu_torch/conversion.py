"""
Conversions between UGRID geometry and other data structures (host,
numpy): GIS vector geometry (shapely arrays and geopandas
GeoDataFrames), and structured (raster) coordinates (cell-centre
coordinates to interval breaks, cell bounds to vertices, curvilinear
(N, M, 4) corner bounds to a topology, the inference of a raster's x and
y coordinates).  Copied from ``xugrid_tpu/conversion.py`` so that the
port imports nothing of the JAX package.

shapely and geopandas are optional and imported inside the functions
that use them, so the module found in ``sys.modules`` at the call is the
one used.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np

from xugrid_tpu_torch.constants import FILL_VALUE, IntDType
from xugrid_tpu_torch.ugrid.connectivity import cross2d, ragged_index


def contiguous_xy(xy: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    x, y = (np.ascontiguousarray(a) for a in xy.T)
    return x, y


# -- UGRID -> shapely --------------------------------------------------------
def nodes_to_points(x: np.ndarray, y: np.ndarray):
    import shapely

    return shapely.points(x, y)


def edges_to_linestrings(x, y, edge_node_connectivity):
    import shapely

    c = edge_node_connectivity.ravel()
    xy = np.column_stack((x[c], y[c]))
    i = np.repeat(np.arange(len(edge_node_connectivity)), 2)
    return shapely.linestrings(xy, indices=i)


def faces_to_polygons(x, y, face_node_connectivity):
    import shapely

    is_data = face_node_connectivity != FILL_VALUE
    m_per_row = is_data.sum(axis=1)
    i = np.repeat(np.arange(len(face_node_connectivity)), m_per_row)
    c = face_node_connectivity.ravel()[is_data.ravel()]
    xy = np.column_stack((x[c], y[c]))
    rings = shapely.linearrings(xy, indices=i)
    return shapely.polygons(rings)


# -- shapely -> UGRID --------------------------------------------------------
def points_to_nodes(points) -> Tuple[np.ndarray, np.ndarray]:
    import shapely

    return contiguous_xy(shapely.get_coordinates(points))


def linestrings_to_edges(edges) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    import shapely

    xy, index = shapely.get_coordinates(edges, return_index=True)
    linear_index = np.arange(index.size)
    segments = np.column_stack([linear_index[:-1], linear_index[1:]])
    segments = segments[np.diff(index) == 0]
    unique, inverse = np.unique(xy, return_inverse=True, axis=0)
    inverse = inverse.ravel()
    segments = inverse[segments]
    x, y = contiguous_xy(unique)
    return x, y, segments


def _drop_closing_vertex(xy: np.ndarray, indices: np.ndarray):
    """GEOS rings repeat the first vertex at the end; UGRID faces are
    implicitly closed, so drop every ring's final vertex."""
    keep = np.diff(indices, append=-1) == 0
    return xy[keep], indices[keep]


def polygons_to_faces(polygons) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    import shapely

    xy, indices = _drop_closing_vertex(*shapely.get_coordinates(polygons, return_index=True))
    unique, inverse = np.unique(xy, axis=0, return_inverse=True)
    inverse = inverse.ravel()
    n = len(polygons)
    m_per_row = np.bincount(indices)
    m = int(m_per_row.max())
    conn = np.full((n, m), FILL_VALUE, dtype=IntDType)
    valid = ragged_index(n, m, m_per_row)
    conn[valid] = inverse
    x, y = contiguous_xy(unique)
    return x, y, conn


# -- structured coordinates --------------------------------------------------
def _is_monotonic_and_increasing(coord, axis: int = 0) -> bool:
    """True if increasing, False if decreasing; raises otherwise."""
    coord = np.asarray(coord)
    n = coord.shape[axis]
    nxt = coord.take(np.arange(1, n), axis=axis)
    prv = coord.take(np.arange(0, n - 1), axis=axis)
    if np.all(nxt >= prv):
        return True
    if np.all(nxt <= prv):
        return False
    raise ValueError("The input coordinate is not monotonic.")


def infer_interval_breaks(coord, axis: int = 0, check_monotonic: bool = False):
    """Cell-centre coordinates -> interval breaks (midpoints, with the
    first and last extrapolated by half a cell)."""
    coord = np.asarray(coord)
    if check_monotonic:
        _is_monotonic_and_increasing(coord, axis=axis)
    deltas = 0.5 * np.diff(coord, axis=axis)
    if deltas.size == 0:
        deltas = np.array(0.0)
    first = np.take(coord, [0], axis=axis) - np.take(deltas, [0], axis=axis)
    last = np.take(coord, [-1], axis=axis) + np.take(deltas, [-1], axis=axis)
    trim_last = tuple(slice(None, -1) if n == axis else slice(None) for n in range(coord.ndim))
    return np.concatenate([first, coord[trim_last] + deltas, last], axis=axis)


def _scalar_spacing(coord_values, spacing_value, name):
    diff = np.diff(coord_values)
    spacing_value = abs(float(spacing_value))
    if not np.allclose(np.abs(diff), spacing_value, atol=abs(1.0e-4 * spacing_value)):
        raise ValueError(f"spacing of {name} does not match value of d{name}")
    return np.full_like(coord_values, 0.5 * spacing_value)


def infer_interval_breaks1d(obj, var: str) -> np.ndarray:
    """
    Breaks of a 1D coordinate: from an explicit ``d{var}`` spacing
    (scalar or array), else from the midpoints.  A coordinate of one
    value needs the explicit spacing.
    """
    values = np.asarray(obj[var].data, dtype=np.float64)
    spacing_name = f"d{var}"
    if spacing_name in obj.coords:
        spacing = np.asarray(obj[spacing_name].data)
        if spacing.ndim > 1:
            raise NotImplementedError(f"More than one dimension in spacing variable: {spacing_name}")
        if spacing.shape in ((), (1,)):
            halfdiff = _scalar_spacing(values, spacing, var)
        else:
            if values.size != spacing.size:
                raise ValueError(f"size of {var} does not match size of {spacing_name}")
            halfdiff = 0.5 * np.abs(spacing)
        if _is_monotonic_and_increasing(values):
            return np.insert(values + halfdiff, 0, values[0] - halfdiff[0])
        return np.insert(values - halfdiff, 0, values[0] + halfdiff[0])
    if values.size == 1:
        raise ValueError(
            f"Cannot derive spacing of 1-sized coordinate: {var}\n"
            f"Assign a d{var} variable with spacing instead."
        )
    return infer_interval_breaks(values, check_monotonic=True)


def infer_xy_coords(obj):
    """The names of the x and y coordinates: by dimension name, then by
    the ``axis`` and ``standard_name`` attributes."""
    x = None
    y = None
    dims = set(obj.dims)
    if "x" in dims and "y" in dims:
        x, y = "x", "y"
    elif "longitude" in dims and "latitude" in dims:
        x, y = "longitude", "latitude"
    else:
        for name in obj.coords:
            da = obj[name]
            if da.ndim != 1:
                continue
            axis = str(da.attrs.get("axis", "")).lower()
            stdname = str(da.attrs.get("standard_name", "")).lower()
            if axis == "x" or stdname in ("longitude", "projection_x_coordinate"):
                x = name
            elif axis == "y" or stdname in ("latitude", "projection_y_coordinate"):
                y = name
    missing = [n for n in (x, y) if n is not None and n not in obj.coords]
    if missing:
        raise ValueError(
            f"Found spatial dimensions ({y!r}, {x!r}) but no matching "
            f"coordinate variables for {missing}; assign coordinates "
            f"(e.g. obj.assign_coords({x}=..., {y}=...)) first."
        )
    return x, y


def bounds1d_to_vertices(bounds: np.ndarray) -> np.ndarray:
    """(n, 2) monotonic cell bounds -> the n + 1 vertices."""
    diff = np.diff(bounds, axis=0)
    if (diff >= 0.0).all():
        return np.concatenate((bounds[:, 0], bounds[-1:, 1]))
    if (diff <= 0.0).all():
        return np.concatenate((bounds[:, 1], bounds[-1:, 0]))
    raise ValueError("Bounds are not monotonic ascending or monotonic descending")


def _fan_area_abs(coordinates: np.ndarray) -> np.ndarray:
    """Total absolute triangle-fan area (orientation-insensitive)."""
    xy0 = coordinates[:, 0]
    a = coordinates[:, :-1] - xy0[:, np.newaxis]
    b = coordinates[:, 1:] - xy0[:, np.newaxis]
    determinant = cross2d(a, b)
    return 0.5 * np.abs(determinant).sum(axis=1)


def bounds2d_to_topology2d(x_bounds: np.ndarray, y_bounds: np.ndarray):
    """
    (N, M, 4) corner bounds -> UGRID topology: validity filtering
    (degenerate/collinear/NaN cells dropped, a warning counting the
    degenerate ones), CCW vertex ordering, and node deduplication.
    Returns (x, y, face_node_connectivity, index), ``index`` the boolean
    mask of the N * M cells kept.
    """
    x = x_bounds.reshape(-1, 4)
    y = y_bounds.reshape(-1, 4)
    # Group repeated corners consecutively via a per-face lexsort.
    sorter = np.lexsort((y, x))
    corners = np.stack(
        (np.take_along_axis(x, sorter, axis=1), np.take_along_axis(y, sorter, axis=1)),
        axis=-1,
    )

    n_unique = (corners != np.roll(corners, 1, axis=1)).any(axis=-1).sum(axis=1)
    valid = (n_unique >= 3) & (_fan_area_abs(corners) > 0)
    if not valid.all():
        warnings.warn(
            "A UGRID2D face requires at least three unique non-collinear "
            f"vertices.\nYour structured bounds contain "
            f"{len(valid) - valid.sum()} invalid faces.\n"
            "These will be omitted from the Ugrid2d topology.",
            UserWarning,
            stacklevel=2,
        )
    index = np.isfinite(corners.reshape(-1, 8)).all(axis=-1) & valid
    corners = corners[index]

    # CCW ordering by angle around the cell mean; repeated corners are
    # pushed to the end (angle = inf) so they become the fill slot.
    centers = np.mean(corners, axis=1)
    dx = corners[..., 0] - centers[:, np.newaxis, 0]
    dy = corners[..., 1] - centers[:, np.newaxis, 1]
    angle = np.arctan2(dy, dx)
    angle[:, 1:][angle[:, 1:] == angle[:, :-1]] = np.inf
    ccw = np.argsort(angle, axis=1)
    corners = np.take_along_axis(corners, ccw[..., None], axis=1)

    xy, inverse = np.unique(corners.reshape((-1, 2)), return_inverse=True, axis=0)
    face_node_connectivity = inverse.reshape((-1, 4)).astype(IntDType)
    face_node_connectivity[n_unique[index] == 3, -1] = FILL_VALUE
    return xy[:, 0], xy[:, 1], face_node_connectivity, index


# -- dispatch ----------------------------------------------------------------
def grid_from_geodataframe(geodataframe):
    """A Ugrid1d of a GeoDataFrame of linestrings, or a Ugrid2d of one of
    polygons."""
    import geopandas as gpd

    from xugrid_tpu_torch.ugrid.ugrid1d import Ugrid1d
    from xugrid_tpu_torch.ugrid.ugrid2d import Ugrid2d

    gdf = geodataframe
    if not isinstance(gdf, gpd.GeoDataFrame):
        raise TypeError(f"Cannot convert a {type(gdf).__name__}, expected a GeoDataFrame")
    geom_types = gdf.geom_type.unique()
    if len(geom_types) == 0:
        raise ValueError("geodataframe contains no geometry")
    elif len(geom_types) > 1:
        raise ValueError(f"Multiple geometry types detected: {', '.join(geom_types)}")
    geom_type = geom_types[0]
    if geom_type == "LineString":
        return Ugrid1d.from_geodataframe(gdf)
    elif geom_type == "Polygon":
        return Ugrid2d.from_geodataframe(gdf)
    raise ValueError(f"Invalid geometry type: {geom_type}. Expected Linestring or Polygon.")


def grid_from_dataset(dataset, topology: str):
    """The Ugrid1d or Ugrid2d of the named topology variable of a dataset."""
    from xugrid_tpu_torch.ugrid.ugrid1d import Ugrid1d
    from xugrid_tpu_torch.ugrid.ugrid2d import Ugrid2d

    topodim = dataset._variables[topology].attrs["topology_dimension"]
    if topodim == 1:
        return Ugrid1d.from_dataset(dataset, topology)
    elif topodim == 2:
        return Ugrid2d.from_dataset(dataset, topology)
    elif topodim == 3:
        raise NotImplementedError
    raise ValueError(f"Invalid topology dimension: {topodim}")
