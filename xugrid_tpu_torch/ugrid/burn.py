"""
Burning vector geometries (points, lines, polygons) into a Ugrid2d mesh
(host, numpy and the native host library).

Polygons are triangulated by the in-repo ear clipping (``ops/earcut.py``),
the triangles joined against the mesh's faces by overlap
(``CellTree2d.intersect_faces``), and the faces whose centroid lies in a
triangle kept (the native ``points_in_polygons``, which raises without
the library, as point location does).  Copied from
``xugrid_tpu/ugrid/burn.py``; the JAX package's device fallback of the
centroid test is not ported.  shapely and geopandas are imported inside
the functions, so the modules found in ``sys.modules`` at the call are
the ones used.  The burned field is a float64 numpy payload, as in the
JAX package.
"""

from __future__ import annotations

from typing import List, Union

import numpy as np

from xugrid_tpu_torch import xdata
from xugrid_tpu_torch.ops.earcut import earcut_triangulate
from xugrid_tpu_torch.utils.profiling import timed


def _triangulate_polygon(exterior: np.ndarray, interiors: List[np.ndarray]):
    rings = np.cumsum([len(exterior)] + [len(i) for i in interiors])
    vertices = np.vstack([exterior] + list(interiors)).astype(np.float64)
    triangles = earcut_triangulate(vertices, rings)
    return vertices, triangles


def _locate_polygon(grid, exterior, interiors, all_touched: bool) -> np.ndarray:
    """
    Faces covered by one polygon: triangulate it, join triangles against
    the grid by overlap, and (unless all_touched) keep only faces whose
    centroid falls inside a triangle.

    Known deviation from upstream xugrid (``_burn_polygons``): with
    ``all_touched=True`` upstream counts a face whose edge merely TOUCHES
    the polygon boundary (zero-area contact), because its rasterization
    marks any intersected cell.  We intersect by clip area and drop
    zero-area grazes, so boundary-touching faces with no interior overlap
    are excluded.  For a polygon aligned with face edges both give the
    same face set.
    """
    from xugrid_tpu_torch.utils.native import points_in_polygons_native

    with timed("burn.earcut"):
        vertices, triangles = _triangulate_polygon(exterior, interiors)
    tri_index, grid_index, area = grid.celltree.intersect_faces(vertices, triangles, -1)
    tolerance = grid.celltree.default_tolerance()
    if all_touched:
        # Drop zero-area boundary grazes: a polygon edge coinciding with
        # a face edge produces clip areas at FP-noise scale.  Compare in
        # area units, not the length-scale point tolerance.
        area_tolerance = grid.celltree.default_area_tolerance()
        uniq, inverse = np.unique(grid_index, return_inverse=True)
        area_per_face = np.bincount(inverse.ravel(), weights=area)
        return uniq[area_per_face > area_tolerance]
    centroids = grid.centroids[grid_index]
    tri_xy = vertices[triangles]
    with timed("burn.centroid_test"):
        inside = points_in_polygons_native(centroids, tri_index.astype(np.int64), tri_xy, tolerance)
    if inside is None:
        raise RuntimeError("burning polygons needs the native host library (g++)")
    return np.unique(grid_index[inside])


def _burn_polygons(polygons, like, values, all_touched: bool, output) -> None:
    import shapely

    exteriors = [shapely.get_coordinates(e) for e in polygons.exterior]
    interiors = [[shapely.get_coordinates(i) for i in p_interiors] for p_interiors in polygons.interiors]
    for exterior, interior, value in zip(exteriors, interiors, values):
        to_burn = _locate_polygon(like, exterior, interior, all_touched)
        output[to_burn] = value


def _burn_points(points, like, values, output) -> None:
    import shapely

    xy = shapely.get_coordinates(points)
    to_burn = like.locate_points(xy)
    inside = to_burn != -1
    output[to_burn[inside]] = values[inside]


def _burn_lines(lines, like, values, output) -> None:
    import shapely

    xy, index = shapely.get_coordinates(lines, return_index=True)
    linear_index = np.arange(index.size)
    segments = np.column_stack([linear_index[:-1], linear_index[1:]])
    valid = np.diff(index) == 0
    segments = segments[valid]
    edges = xy[segments]
    edge_index, face_index, _ = like.intersect_edges(edges)
    line_index = index[1:][valid]
    output[face_index] = values[line_index[edge_index]]


def burn_vector_geometry(
    gdf,
    like,
    column: Union[str, None] = None,
    fill: Union[int, float] = np.nan,
    all_touched: bool = False,
):
    """
    Burn vector geometries into a Ugrid2d mesh.

    Parameters
    ----------
    gdf: geopandas.GeoDataFrame
        Points, lines, and/or polygons.
    like: Ugrid2d, UgridDataArray, or UgridDataset
    column: str, optional
        Column of values to burn; 1.0 when absent.
    fill: scalar, default NaN
    all_touched: bool, default False
        Include every touched face rather than centroid-inside faces.

    Returns
    -------
    burned: UgridDataArray over the faces, a float64 numpy payload.
    """
    import geopandas as gpd
    import shapely

    from xugrid_tpu_torch.core.wrap import UgridDataArray, UgridDataset
    from xugrid_tpu_torch.ugrid.ugrid2d import Ugrid2d

    POINT = shapely.GeometryType.POINT
    LINESTRING = shapely.GeometryType.LINESTRING
    LINEARRING = shapely.GeometryType.LINEARRING
    POLYGON = shapely.GeometryType.POLYGON
    GEOM_NAMES = {v: k for k, v in shapely.GeometryType.__members__.items()}

    if not isinstance(gdf, gpd.GeoDataFrame):
        raise TypeError(f"gdf must be GeoDataFrame, received: {type(gdf).__name__}")
    if isinstance(like, (UgridDataArray, UgridDataset)):
        like = like.grid
    if not isinstance(like, Ugrid2d):
        raise TypeError(
            "Like must be Ugrid2d, UgridDataArray, or UgridDataset; "
            f"received: {type(like).__name__}"
        )
    geometry_id = shapely.get_type_id(gdf.geometry)
    allowed = (POINT, LINESTRING, LINEARRING, POLYGON)
    if not np.isin(geometry_id, allowed).all():
        received = ", ".join(GEOM_NAMES[g] for g in np.unique(geometry_id))
        raise TypeError(
            "GeoDataFrame contains unsupported geometry types. Can only "
            "burn Point, LineString, LinearRing, and Polygon geometries. "
            f"Received: {received}"
        )

    points = gdf.loc[geometry_id == POINT]
    lines = gdf.loc[(geometry_id == LINESTRING) | (geometry_id == LINEARRING)]
    polygons = gdf.loc[geometry_id == POLYGON]

    if column is None:
        point_values = np.ones(len(points), dtype=float)
        line_values = np.ones(len(lines), dtype=float)
        poly_values = np.ones(len(polygons), dtype=float)
    else:
        point_values = points[column].to_numpy()
        line_values = lines[column].to_numpy()
        poly_values = polygons[column].to_numpy()

    output = np.full(like.n_face, fill)
    if len(polygons) > 0:
        _burn_polygons(polygons.geometry, like, poly_values, all_touched, output)
    if len(lines) > 0:
        _burn_lines(lines.geometry, like, line_values, output)
    if len(points) > 0:
        _burn_points(points.geometry, like, point_values, output)

    return UgridDataArray(xdata.DataArray(output, dims=(like.face_dimension,), name=column), like)


def grid_from_earcut_polygons(polygons, return_index: bool = False):
    """Triangulate (Geo)polygons and build a Ugrid2d from the triangles."""
    import geopandas as gpd
    import shapely

    from xugrid_tpu_torch.ugrid.ugrid2d import Ugrid2d

    if not isinstance(polygons, gpd.GeoDataFrame):
        raise TypeError(f"Expected GeoDataFrame, received: {type(polygons).__name__}")
    geometry = polygons.geometry
    POLYGON = shapely.GeometryType.POLYGON
    geometry_id = shapely.get_type_id(geometry)
    if not (geometry_id == POLYGON).all():
        GEOM_NAMES = {v: k for k, v in shapely.GeometryType.__members__.items()}
        received = ", ".join(GEOM_NAMES[g] for g in np.unique(geometry_id))
        raise TypeError(
            "geometry contains unsupported geometry types. Can only "
            f"triangulate Polygon geometries. Received: {received}"
        )

    exteriors = [shapely.get_coordinates(e) for e in geometry.exterior]
    interiors = [[shapely.get_coordinates(i) for i in p_interiors] for p_interiors in geometry.interiors]
    all_triangles = []
    offset = 0
    for exterior, interior in zip(exteriors, interiors):
        vertices, triangles = _triangulate_polygon(exterior, interior)
        all_triangles.append(triangles + offset)
        offset += len(vertices)

    face_nodes = np.concatenate(all_triangles).reshape((-1, 3))
    all_vertices = shapely.get_coordinates(geometry)
    grid = Ugrid2d(all_vertices[:, 0], all_vertices[:, 1], -1, face_nodes)
    if return_index:
        n_triangles = [len(t) for t in all_triangles]
        index = np.repeat(np.arange(len(geometry)), n_triangles)
        return grid, index
    return grid


def earcut_triangulate_polygons(polygons, column: Union[str, None] = None):
    """
    Triangulate polygons into a mesh; faces carry the polygon index (or
    the given column's values).
    """
    from xugrid_tpu_torch.core.wrap import UgridDataArray

    grid, index = grid_from_earcut_polygons(polygons, return_index=True)
    if column is not None:
        values = polygons[column].reset_index(drop=True).to_numpy()[index]
        da = xdata.DataArray(values, dims=(grid.face_dimension,), name=column)
    else:
        da = xdata.DataArray(index, dims=(grid.face_dimension,))
    return UgridDataArray(da, grid)
