"""
Polygonize: vector polygons for connected same-valued face regions
(host, numpy and scipy).

Copied from ``xugrid_tpu/ugrid/polygonize.py``: connected components
over the face adjacency of equal-valued faces, the boundary edges of
each region, shapely's ``polygonize`` of them, and the polygon of the
largest bounding box.  A payload on the card is copied to the host.
Each polygon carries the value of its region's faces, where the JAX
package can give an enclosed region the value of the region around it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import sparse

from xugrid_tpu_torch.constants import FILL_VALUE


def _bbox_area(bounds):
    return (bounds[2] - bounds[0]) * (bounds[3] - bounds[1])


def _classify(i: np.ndarray, j: np.ndarray, face_values) -> Tuple[int, np.ndarray]:
    """Label connected regions of faces sharing a value across edges."""
    vi = face_values[i]
    vj = face_values[j]
    n = face_values.size
    is_connection = (i != FILL_VALUE) & (j != FILL_VALUE) & (vi == vj)
    i = i[is_connection]
    j = j[is_connection]
    ij = np.concatenate([i, j])
    ji = np.concatenate([j, i])
    coo = sparse.coo_matrix((ji, (ij, ji)), shape=(n, n))
    return sparse.csgraph.connected_components(coo)


def polygonize(uda):
    """
    Create polygons for every connected region of faces sharing a value.

    The DataArray may only have the face dimension; NaN faces are
    dropped.  Meant for data with few unique values (classifications);
    use ``to_geodataframe`` for per-face polygons.

    Returns
    -------
    polygonized: geopandas.GeoDataFrame with a "values" column.
    """
    facedim = uda.grid.face_dimension
    if tuple(uda.obj.dims) != (facedim,):
        raise ValueError(
            "Cannot polygonize non-face dimensions. Expected only "
            f"({facedim},), but received {tuple(uda.obj.dims)}."
        )

    import geopandas as gpd
    import shapely

    values = uda.obj.values
    notnull = ~np.isnan(values)
    if notnull.all():
        grid = uda.grid
        face_values = values
    else:
        sub = uda.isel({facedim: np.flatnonzero(notnull)})
        grid = sub.grid
        face_values = sub.obj.values

    i, j = grid.edge_face_connectivity.T
    n_polygon, polygon_id = _classify(i, j, face_values)

    coordinates = grid.node_coordinates
    # A region's value is that of any of its faces.  (The JAX package takes
    # the face on the first side of the region's first boundary edge,
    # which lies in the neighbouring region when the region is on the
    # other side: an island gets the value of the region around it.)
    _, first_face = np.unique(polygon_id, return_index=True)
    region_values = face_values[first_face]
    vi = polygon_id[i]
    vj = polygon_id[np.where(j == FILL_VALUE, 0, j)]
    vi = np.where(i == FILL_VALUE, FILL_VALUE, vi)
    vj = np.where(j == FILL_VALUE, FILL_VALUE, vj)
    boundary = vi != vj

    polygons = []
    for label in range(n_polygon):
        keep = ((vi == label) | (vj == label)) & boundary
        edges = grid.edge_node_connectivity[keep]
        collection = shapely.polygonize(
            shapely.linestrings(
                coordinates[edges].reshape(-1, 2),
                indices=np.repeat(np.arange(len(edges)), 2),
            )
        )
        # Holes appear both as holes and as standalone polygons; the
        # region itself is the largest-bbox polygon.
        polygon = max(collection.geoms, key=lambda g: _bbox_area(g.bounds))
        polygons.append(polygon)

    return gpd.GeoDataFrame({"values": region_values}, geometry=polygons)
