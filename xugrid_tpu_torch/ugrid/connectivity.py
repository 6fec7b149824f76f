"""
Connectivity and face geometry from a padded dense face-node table
(host, numpy and scipy).

Padded dense connectivity uses FILL_VALUE (-1) on the right of each row;
derived adjacency matrices carry the connecting edge index as data.
The functions are those of ``xugrid_tpu/ugrid/connectivity.py``, copied
so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import sparse

from xugrid_tpu_torch.constants import FILL_VALUE, IntDType


def cross2d(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """z-component of the cross product of 2D vectors (..., 2)."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def argsort_rows(array: np.ndarray) -> np.ndarray:
    """Lexicographic argsort over the rows of a 2D array, the first
    column the primary key."""
    if array.ndim != 2:
        raise ValueError(f"Array is not 2D, but has shape: {array.shape}")
    return np.lexsort(array.T[::-1])


def index_like(xy_a: np.ndarray, xy_b: np.ndarray, tolerance: float = 0.0) -> np.ndarray:
    """
    The permutation taking the coordinates ``xy_a`` onto ``xy_b``:
    ``xy_a[result]`` equals ``xy_b`` within ``tolerance``.  Both sets must
    hold the same points; raises otherwise.
    """
    xy_a = np.asarray(xy_a)
    xy_b = np.asarray(xy_b)
    if xy_a.shape != xy_b.shape:
        raise ValueError("coordinates do not match in shape")
    if tolerance != 0.0:
        # Quantize so that nearly equal coordinates sort alike.
        sorter_a = argsort_rows(np.round(xy_a / tolerance))
        sorter_b = argsort_rows(np.round(xy_b / tolerance))
    else:
        sorter_a = argsort_rows(xy_a)
        sorter_b = argsort_rows(xy_b)
    if not np.allclose(xy_a[sorter_a], xy_b[sorter_b], rtol=0.0, atol=tolerance):
        raise ValueError("coordinates are not identical after sorting")
    inverse_b = np.argsort(sorter_b)
    return sorter_a[inverse_b]


# Dense <-> sparse conversion
# ---------------------------
def _connectivity_ij(conn: np.ndarray, invert: bool) -> Tuple[np.ndarray, np.ndarray]:
    n, m = conn.shape
    j = conn.ravel()
    valid = j != FILL_VALUE
    i = np.repeat(np.arange(n), m)[valid]
    j = j[valid]
    return (j, i) if invert else (i, j)


def _build_csr(i: np.ndarray, j: np.ndarray, sort_indices: bool) -> sparse.csr_matrix:
    # data = column index so that CSR conversions keep carrying j around.
    coo = sparse.coo_matrix((j, (i, j)))
    csr = coo.tocsr()
    if not sort_indices:
        # CSR conversion sorts column indices within each row; restore the
        # original within-row (e.g. counter-clockwise) order.
        order = np.argsort(i, kind="stable")
        csr.indices = j[order].astype(csr.indices.dtype)
        csr.has_sorted_indices = False
    return csr


def to_sparse(conn: np.ndarray, sort_indices: bool = True) -> sparse.csr_matrix:
    """Padded dense (fill -1) -> CSR."""
    i, j = _connectivity_ij(conn, invert=False)
    return _build_csr(i, j, sort_indices)


def invert_dense_to_sparse(conn: np.ndarray, sort_indices: bool = True) -> sparse.csr_matrix:
    i, j = _connectivity_ij(conn, invert=True)
    return _build_csr(i, j, sort_indices)


def ragged_index(n: int, m: int, m_per_row: np.ndarray) -> np.ndarray:
    """Mask marking, per row, the leftmost ``m_per_row`` entries True."""
    return np.arange(m)[np.newaxis, :] < np.asarray(m_per_row)[:, np.newaxis]


def to_dense(conn, n_columns: Optional[int] = None) -> np.ndarray:
    """CSR/COO -> padded dense (fill -1)."""
    n, _ = conn.shape
    m_per_row = conn.getnnz(axis=1)
    m = int(m_per_row.max()) if len(m_per_row) else 0
    if n_columns is not None:
        if n_columns < m:
            raise ValueError(
                f"n_columns {n_columns} is too small for the data, requires {m}"
            )
        m = n_columns
    dense = np.full((n, m), FILL_VALUE, dtype=IntDType)
    valid = ragged_index(n, m, m_per_row)
    if isinstance(conn, sparse.csr_matrix):
        cols = conn.indices
    elif isinstance(conn, sparse.coo_matrix):
        cols = conn.col
    else:
        raise TypeError("Can only convert coo or csr matrix")
    dense[valid] = cols
    return dense


def invert_dense(conn: np.ndarray, sort_indices: bool = True) -> np.ndarray:
    return to_dense(invert_dense_to_sparse(conn, sort_indices))


def renumber(a: np.ndarray) -> np.ndarray:
    """Compactly renumber the non-fill entries to 0..k-1 in the order of
    their values, keeping FILL_VALUE in place."""
    valid = a != FILL_VALUE
    out = np.full_like(a, FILL_VALUE)
    _, inverse = np.unique(a[valid], return_inverse=True)
    out[valid] = inverse.astype(IntDType).ravel()
    return out


# Polygon rows
# ------------
def close_polygons(face_node_connectivity: np.ndarray):
    """
    Append the first node to every row and replace fills by the first
    node, yielding closed polygons.  Returns (closed, isfill), where
    isfill marks the replaced entries (shape (n, m+1)).
    """
    n, m = face_node_connectivity.shape
    closed = np.full((n, m + 1), FILL_VALUE, dtype=IntDType)
    closed[:, :-1] = face_node_connectivity
    isfill = closed == FILL_VALUE
    first = np.broadcast_to(face_node_connectivity[:, :1], (n, m + 1))
    closed = np.where(isfill, first, closed)
    return closed, isfill


# Derived connectivities
# ----------------------
def edge_connectivity(
    face_node_connectivity: np.ndarray,
    edge_node_connectivity: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """
    Derive (edge_node_connectivity, face_edge_connectivity) from faces.

    Edges are the unique sorted node pairs of all face boundaries.  When a
    prior edge_node_connectivity is given, its edge numbering is preserved
    (and validated against the face-derived set).
    """
    prior = edge_node_connectivity
    n, m = face_node_connectivity.shape
    closed, isfill = close_polygons(face_node_connectivity)
    raw = np.empty((n * m, 2), dtype=IntDType)
    raw[:, 0] = closed[:, :-1].ravel()
    raw[:, 1] = closed[:, 1:].ravel()
    # Degenerate (fill-padding) edges connect a node to itself; drop them.
    keep = raw[:, 0] != raw[:, 1]
    raw = raw[keep]
    raw.sort(axis=1)
    # Unique rows through one int64 key per (sorted) node pair: the
    # same lexicographic order as np.unique(axis=0), at a fraction of
    # its cost (seconds at 1M nodes).
    base = int(raw.max()) + 1 if len(raw) else 1
    keys, inverse = np.unique(raw[:, 0] * base + raw[:, 1], return_inverse=True)
    edge_nodes = np.column_stack([keys // base, keys % base]).astype(IntDType)
    inverse = inverse.ravel()

    if prior is not None:
        unique_prior, prior_index = np.unique(
            np.sort(prior, axis=1), axis=0, return_index=True
        )
        if not np.array_equal(unique_prior, edge_nodes):
            raise ValueError("Invalid edge_node_connectivity.")
        inverse = prior_index[inverse]
        edge_nodes = prior

    face_edges = np.full((n, m), FILL_VALUE, dtype=IntDType)
    face_edges[~isfill[:, :-1] & keep.reshape(n, m)] = inverse
    return edge_nodes, face_edges


def boundary_node_connectivity(edge_face_connectivity: np.ndarray, edge_node_connectivity: np.ndarray) -> np.ndarray:
    """Node pairs of the edges bordering at most one face."""
    is_boundary = (edge_face_connectivity == FILL_VALUE).any(axis=1)
    return edge_node_connectivity[is_boundary]


def face_face_connectivity(edge_face_connectivity: np.ndarray, n_face: int) -> sparse.csr_matrix:
    """Symmetric face adjacency; data holds the connecting edge index."""
    i = edge_face_connectivity[:, 0]
    j = edge_face_connectivity[:, 1]
    connected = j != FILL_VALUE
    i, j = i[connected], j[connected]
    edge_index = np.flatnonzero(connected)
    rows = np.concatenate([i, j])
    cols = np.concatenate([j, i])
    data = np.concatenate([edge_index, edge_index])
    return sparse.coo_matrix((data, (rows, cols)), shape=(n_face, n_face)).tocsr()


def node_node_connectivity(edge_node_connectivity: np.ndarray) -> sparse.csr_matrix:
    """Symmetric node adjacency; data holds the connecting edge index."""
    i = edge_node_connectivity[:, 0]
    j = edge_node_connectivity[:, 1]
    edge_index = np.arange(len(edge_node_connectivity))
    rows = np.concatenate([i, j])
    cols = np.concatenate([j, i])
    data = np.concatenate([edge_index, edge_index])
    return sparse.coo_matrix((data, (rows, cols))).tocsr()


def edge_edge_connectivity(
    edge_node_connectivity: np.ndarray, node_edge_connectivity: sparse.csr_matrix
) -> sparse.csr_matrix:
    """Edges sharing a node; data holds the shared node index."""
    n_edge = len(edge_node_connectivity)
    node_index = edge_node_connectivity.ravel()
    j = node_edge_connectivity[node_index].indices
    n_connection = node_edge_connectivity.getnnz(axis=1)[node_index]
    i = np.repeat(np.arange(n_edge), n_connection.reshape((-1, 2)).sum(axis=1))
    data = np.repeat(node_index, n_connection)
    not_self = i != j
    return sparse.coo_matrix((data[not_self], (i[not_self], j[not_self]))).tocsr()


# Geometry
# --------
def area_from_coordinates(coordinates: np.ndarray) -> np.ndarray:
    """Shoelace area of closed polygon rows (n, m+1, 2)."""
    xy0 = coordinates[:, :1]
    a = coordinates[:, :-1] - xy0
    b = coordinates[:, 1:] - xy0
    return 0.5 * np.abs(cross2d(a, b).sum(axis=1))


def area(face_node_connectivity, node_x, node_y) -> np.ndarray:
    """Area of every face."""
    nodes = np.column_stack([node_x, node_y])
    closed, _ = close_polygons(face_node_connectivity)
    return area_from_coordinates(nodes[closed])


def centroids(face_node_connectivity, node_x, node_y) -> np.ndarray:
    """Area-weighted polygon centroids (mean of vertices for triangles)."""
    n_face, n_max = face_node_connectivity.shape
    from xugrid_tpu_torch.utils.native import face_centroids_native

    native = face_centroids_native(face_node_connectivity, node_x, node_y)
    if native is not None:
        return native
    nodes = np.column_stack([node_x, node_y])
    if n_max == 3:
        return nodes[face_node_connectivity].mean(axis=1)
    closed, _ = close_polygons(face_node_connectivity)
    coords = nodes[closed]
    xy0 = coords[:, :1]
    a = coords[:, :-1] - xy0
    b = coords[:, 1:] - xy0
    c = a + b
    det = cross2d(a, b)
    total = det.sum(axis=1)
    weight = 1.0 / (3.0 * total)
    out = np.empty((n_face, 2), dtype=np.float64)
    out[:, 0] = weight * (c[..., 0] * det).sum(axis=1)
    out[:, 1] = weight * (c[..., 1] * det).sum(axis=1)
    return out + xy0[:, 0]
