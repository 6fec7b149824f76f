"""
Snapping of points and lines to grid nodes and edges (host, numpy and
the native host library).

Copied from ``xugrid_tpu/ugrid/snapping.py``.  The per-segment
half-plane tests of ``snap_to_edges`` are vectorized numpy over all
(segment, face-edge) pairs at once; the order-dependent greedy of
``snap_nodes`` runs in the native ``snap_to_nearest_greedy``, else as the
same sequential loop.  shapely and geopandas are imported inside the
functions that use them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import pandas as pd
from scipy.spatial import cKDTree

from xugrid_tpu_torch import xdata
from xugrid_tpu_torch.constants import FILL_VALUE, IntDType
from xugrid_tpu_torch.ugrid.ugrid2d import Ugrid2d


def _snap_to_nearest(distances, snap_candidates: np.ndarray, max_distance) -> np.ndarray:
    """
    Greedy assignment: walk candidates in order; unvisited candidates
    become targets, and nearby nodes attach to their closest target.
    """
    UNVISITED = -1
    TARGET = -2
    n = distances.shape[0]
    from xugrid_tpu_torch.utils.native import snap_to_nearest_native

    native = snap_to_nearest_native(
        distances.indptr, distances.indices, distances.data,
        n, np.asarray(snap_candidates), max_distance,
    )
    if native is not None:
        return native
    nearest = np.full(n, max_distance + 1.0)
    visited = np.full(n, UNVISITED)
    indptr = distances.indptr
    indices = distances.indices
    data = distances.data

    for i in snap_candidates:
        if visited[i] != UNVISITED:
            continue
        visited[i] = TARGET
        for k in range(indptr[i], indptr[i + 1]):
            j = indices[k]
            dist = data[k]
            if i == j or visited[j] == TARGET:
                continue
            if visited[j] == UNVISITED or dist < nearest[j]:
                visited[j] = i
                nearest[j] = dist
    return visited


def snap_nodes(
    x: np.ndarray, y: np.ndarray, max_snap_distance: float
) -> Tuple[Optional[np.ndarray], np.ndarray, np.ndarray]:
    """
    Merge vertices lying within max_snap_distance of each other.

    Returns (inverse, x_snapped, y_snapped); inverse maps old vertex
    numbers to new ones (None when nothing snaps).
    """
    coords = np.column_stack((x, y))
    tree = cKDTree(coords)
    distances = tree.sparse_distance_matrix(
        tree, max_distance=max_snap_distance, output_type="coo_matrix"
    ).tocsr()
    should_snap = distances.getnnz(axis=1) > 1
    if not should_snap.any():
        return None, x.copy(), y.copy()

    index = np.arange(x.size)
    visited = _snap_to_nearest(distances, index[should_snap], max_snap_distance)
    targets = visited < 0  # UNVISITED or TARGET
    visited[targets] = index[targets]
    deduplicated, inverse = np.unique(visited, return_inverse=True)
    return inverse.ravel(), x[deduplicated], y[deduplicated]


def snap_to_nodes(
    x: np.ndarray,
    y: np.ndarray,
    to_x: np.ndarray,
    to_y: np.ndarray,
    max_distance: float,
    tiebreaker=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Snap vertices (x, y) onto (to_x, to_y) within max_distance."""
    if tiebreaker not in (None, "nearest"):
        raise ValueError(
            f"Invalid tiebreaker: {tiebreaker}, should be one of "
            '{None, "nearest"} instead.'
        )
    coords = np.column_stack((x, y))
    to_coords = np.column_stack((to_x, to_y))
    tree = cKDTree(coords)
    to_tree = cKDTree(to_coords)
    distances = tree.sparse_distance_matrix(
        to_tree, max_distance=max_distance, output_type="coo_matrix"
    ).tocsr()
    n_per_row = distances.getnnz(axis=1)
    update = n_per_row == 1
    tie = n_per_row > 1

    xnew = x.copy()
    ynew = y.copy()
    j_update = distances[update].indices
    xnew[update] = to_x[j_update]
    ynew[update] = to_y[j_update]

    if tie.any():
        if tiebreaker == "nearest":
            ties = distances[tie].tocoo()
            j_nearest = (
                pd.DataFrame(
                    {"i": ties.row, "distance": ties.data}, index=ties.col
                )
                .groupby("i")["distance"]
                .idxmin()
                .to_numpy()
            )
            xnew[tie] = to_x[j_nearest]
            ynew[tie] = to_y[j_nearest]
        else:
            raise ValueError(
                "Ties detected: multiple options to snap to, given max "
                "distance: set a smaller tolerance or specify a tiebreaker."
            )
    return xnew, ynew


def lines_as_edges(line_coords, line_index) -> Tuple[np.ndarray, np.ndarray]:
    """Consecutive coordinate pairs within each line become segments."""
    edges = np.empty((len(line_coords) - 1, 2, 2))
    edges[:, 0, :] = line_coords[:-1]
    edges[:, 1, :] = line_coords[1:]
    keep = np.diff(line_index) == 0
    return edges[keep], line_index[1:][keep]


def _left_of(a: np.ndarray, p: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Vectorized: is point a left of the ray p + t*u? Shapes (..., 2)."""
    return u[..., 0] * (a[..., 1] - p[..., 1]) > u[..., 1] * (
        a[..., 0] - p[..., 0]
    )


def snap_to_edges(
    face_indices: np.ndarray,
    intersection_edges: np.ndarray,
    face_edge_connectivity: np.ndarray,
    edge_face_connectivity: np.ndarray,
    centroids: np.ndarray,
    tolerance: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """
    For every intersected segment (fully inside one face), select the
    face edges that separate the face centroid from the neighboring
    face's centroid across the segment.

    Vectorized over all (segment, face-edge) pairs: the separation is a
    double half-plane test (each centroid pair straddles the segment AND
    the segment straddles the centroid-to-centroid vector).

    Returns (edge_index, segment_index).
    """
    n_seg = len(face_indices)
    if n_seg == 0:
        empty = np.empty(0, dtype=IntDType)
        return empty, empty
    n_max = face_edge_connectivity.shape[1]

    p = intersection_edges[:, 0]  # (n_seg, 2)
    q = intersection_edges[:, 1]
    u = q - p
    nondegenerate = ~((u[:, 0] == 0) & (u[:, 1] == 0))

    # Slightly enlarge segments for edge cases.
    sign = np.sign(u)
    increase = tolerance * np.abs(u).max(axis=1, keepdims=True)
    p = p - sign * increase
    q = q + sign * increase
    u = q - p

    a = centroids[face_indices]  # (n_seg, 2) own centroid
    face_edges = face_edge_connectivity[face_indices]  # (n_seg, n_max)
    valid_edge = face_edges != FILL_VALUE
    safe_edges = np.where(valid_edge, face_edges, 0)

    both_faces = edge_face_connectivity[safe_edges]  # (n_seg, n_max, 2)
    # The "other" face across each edge.
    own = face_indices[:, None]
    other = np.where(both_faces[..., 1] == own, both_faces[..., 0], both_faces[..., 1])
    has_other = (other != FILL_VALUE) & valid_edge & nondegenerate[:, None]

    b = centroids[np.maximum(other, 0)]  # (n_seg, n_max, 2)
    a3 = a[:, None, :]
    p3 = p[:, None, :]
    u3 = u[:, None, :]
    a_left = _left_of(a3, p3, u3)
    b_left = _left_of(b, p3, u3)
    v = b - a3
    p_left = _left_of(p3, a3, v)
    q_left = _left_of(q[:, None, :], a3, v)
    separates = has_other & (a_left != b_left) & (p_left != q_left)

    seg_idx, slot = np.nonzero(separates)
    return face_edges[seg_idx, slot], seg_idx


def coerce_geometry(lines):
    import shapely

    geometry = lines.geometry.to_numpy()
    geom_type = shapely.get_type_id(geometry)
    if not ((geom_type == 1) | (geom_type == 2)).all():
        raise ValueError(
            "Geometry should contain only LineStrings and/or LinearRings"
        )
    return geometry


def _edges_from_arrays(line_coords, line_index, topology, max_snap_distance):
    vertices = topology.node_coordinates
    x, y = snap_to_nodes(
        line_coords[:, 0],
        line_coords[:, 1],
        vertices[:, 0],
        vertices[:, 1],
        max_snap_distance,
        tiebreaker="nearest",
    )
    return lines_as_edges(np.column_stack([x, y]), line_index)


def create_snap_to_grid_dataframe(
    lines,
    grid,
    max_snap_distance: float,
    tolerance: float = 1.0e-12,
) -> pd.DataFrame:
    """
    Compute which grid edges line geometries snap onto.

    Returns a DataFrame with line_index, edge_index, segment coordinates
    (x0, y0, x1, y1), and segment length.
    """
    import shapely

    if not isinstance(grid, Ugrid2d):
        raise TypeError(f"Expected Ugrid2d, received: {type(grid).__name__}")
    topology = grid

    line_geometry = coerce_geometry(lines)
    line_coords, shapely_vertex_index = shapely.get_coordinates(
        line_geometry, return_index=True
    )
    line_edges, shapely_line_index = _edges_from_arrays(
        line_coords, shapely_vertex_index, topology, max_snap_distance
    )

    line_index, face_indices, segment_edges = topology.celltree.intersect_edges(
        line_edges
    )
    edge_index, segment_index = snap_to_edges(
        face_indices,
        segment_edges,
        topology.face_edge_connectivity,
        topology.edge_face_connectivity,
        topology.centroids,
        tolerance,
    )
    line_index = line_index[segment_index]
    segment_edges = segment_edges[segment_index]

    return pd.DataFrame(
        data={
            "line_index": shapely_line_index[line_index],
            "edge_index": edge_index,
            "x0": segment_edges[:, 0, 0],
            "y0": segment_edges[:, 0, 1],
            "x1": segment_edges[:, 1, 0],
            "y1": segment_edges[:, 1, 1],
            "length": ((segment_edges[:, 1] - segment_edges[:, 0]) ** 2).sum(
                axis=1
            ),
        }
    )


def snap_to_grid(lines, grid, max_snap_distance: float):
    """
    Snap line geometries onto the edges of a Ugrid2d topology.

    Returns (uds, gdf): a UgridDataset with a line_index edge variable
    (plus the line attribute columns), and a GeoDataFrame of the snapped
    edge geometries.
    """
    import geopandas as gpd
    import shapely

    from xugrid_tpu_torch.core.wrap import UgridDataArray, UgridDataset

    if isinstance(grid, Ugrid2d):
        topology = grid
    elif isinstance(grid, xdata.DataArray):
        topology = Ugrid2d.from_structured(grid)
    elif isinstance(grid, UgridDataArray):
        topology = grid.grid
    else:
        raise TypeError(
            "Expected DataArray, Ugrid2d, or UgridDataArray, received: "
            f"{type(grid).__name__}"
        )

    result = create_snap_to_grid_dataframe(lines, topology, max_snap_distance)
    # Multiple snapped parts per edge: keep the longest.
    max_edge_index = result.groupby("edge_index").idxmax()["length"].to_numpy()
    line_index = result["line_index"].to_numpy()[max_edge_index]
    edges = result["edge_index"].to_numpy()[max_edge_index]

    uds = UgridDataset(grids=[topology])
    data = np.full(topology.n_edge, np.nan)
    data[edges] = line_index
    uds["line_index"] = xdata.DataArray(
        data, dims=(topology.edge_dimension,)
    )
    for column in lines.columns:
        if column == "geometry":
            continue
        data = np.full(topology.n_edge, np.nan)
        data[edges] = lines[column].iloc[line_index]
        uds[column] = xdata.DataArray(data, dims=(topology.edge_dimension,))

    edge_vertices = topology.node_coordinates[
        topology.edge_node_connectivity[edges]
    ]
    geometry = shapely.linestrings(
        edge_vertices.reshape(-1, 2),
        indices=np.repeat(np.arange(len(edges)), 2),
    )
    gdf = gpd.GeoDataFrame(
        lines.drop(columns="geometry").iloc[line_index], geometry=geometry
    )
    return uds, gdf
