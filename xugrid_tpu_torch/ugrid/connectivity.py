"""
Connectivity, face geometry, triangulation, graph walks and binary
morphology from a padded dense face-node table (host, numpy and scipy).

Padded dense connectivity uses FILL_VALUE (-1) on the right of each row;
derived adjacency matrices carry the connecting edge index as data.
Triangulation fans from the first node of every face.  The functions are
those of ``xugrid_tpu/ugrid/connectivity.py``, copied so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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


class AdjacencyMatrix(NamedTuple):
    """A minimal CSR view for graph walks."""

    indices: np.ndarray
    indptr: np.ndarray
    nnz: int
    n: int
    m: int


def to_adjacency(A: sparse.csr_matrix) -> AdjacencyMatrix:
    if not isinstance(A, sparse.csr_matrix):
        raise TypeError(f"Expected csr_matrix, got: {type(A).__name__}")
    n, m = A.shape
    return AdjacencyMatrix(A.indices, A.indptr, A.nnz, n, m)


def neighbors(A: AdjacencyMatrix, vertex: int) -> np.ndarray:
    return A.indices[A.indptr[vertex] : A.indptr[vertex + 1]]


# Graph walks
# -----------
def topological_sort_by_dfs(A: sparse.csr_matrix) -> np.ndarray:
    """
    The vertices of a directed acyclic graph in topological order (the
    depth-first search's postorder, reversed), through the native walk
    where the host library is built, else in numpy, in the same visit
    order.  Raises ValueError when the graph contains a cycle.
    """
    from xugrid_tpu_torch.utils.native import topo_sort_dfs_native

    adj = to_adjacency(A)
    native = topo_sort_dfs_native(adj.indptr, adj.indices, adj.m)
    if native is not None:
        return native.astype(IntDType)
    WHITE, GRAY, BLACK = 0, 1, 2
    color = np.zeros(adj.m, dtype=np.uint8)
    order: list = []
    for start in range(adj.m):
        if color[start] != WHITE:
            continue
        stack = [start]
        color[start] = GRAY
        while stack:
            u = stack[-1]
            advanced = False
            for n in neighbors(adj, u):
                if color[n] == GRAY:
                    raise ValueError("The graph contains at least one cycle")
                if color[n] == WHITE:
                    color[n] = GRAY
                    stack.append(int(n))
                    advanced = True
                    break
            if not advanced:
                color[u] = BLACK
                order.append(u)
                stack.pop()
    return np.array(order[::-1], dtype=IntDType)


def contract_vertices(A: sparse.csr_matrix, indices: np.ndarray) -> np.ndarray:
    """
    A directed graph contracted onto the vertices ``indices``: from each
    of them, walk downstream to the next kept vertices, one edge per
    pair reached.  Returns the (n_edge, 2) edge-node connectivity over
    the original vertex ids (native walk, else numpy, in the same
    order).  Raises ValueError on a cycle through a kept vertex.
    """
    from xugrid_tpu_torch.utils.native import contract_vertices_native

    adj = to_adjacency(A)
    indices = np.asarray(indices)
    native = contract_vertices_native(adj.indptr, adj.indices, adj.m, indices)
    if native is not None:
        return native.astype(IntDType).reshape((-1, 2))
    keep = np.zeros(adj.m, dtype=bool)
    keep[indices] = True
    edges: list = []
    for v in indices:
        stack = list(neighbors(adj, v))
        visited = set()
        while stack:
            u = int(stack.pop())
            if u == v:
                raise ValueError("The graph contains at least one cycle")
            if keep[u]:
                edges.append((int(v), u))
                continue
            if u in visited:
                # Paths that meet again downstream (braided channels)
                # are no cycle: skip the vertex already expanded.
                continue
            visited.add(u)
            stack.extend(int(n) for n in neighbors(adj, u))
    return np.array(edges, dtype=IntDType).reshape((-1, 2))


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


def invert_sparse(conn: sparse.csr_matrix) -> sparse.csr_matrix:
    """The transposed connectivity; data holds the (new) column index."""
    coo = conn.tocoo()
    i, j = coo.col, coo.row
    return sparse.coo_matrix((j, (i, j))).tocsr()


def invert_sparse_to_dense(conn: sparse.csr_matrix) -> np.ndarray:
    return to_dense(invert_sparse(conn))


# Renumbering
# -----------
def _dense_rank(a: np.ndarray) -> np.ndarray:
    """Rank values 0..k-1 by sorted unique value ("dense" ranking)."""
    _, inverse = np.unique(np.ravel(a), return_inverse=True)
    return inverse.astype(IntDType).reshape(a.shape)


def renumber(a: np.ndarray) -> np.ndarray:
    """Compactly renumber the non-fill entries to 0..k-1 in the order of
    their values, keeping FILL_VALUE in place."""
    valid = a != FILL_VALUE
    out = np.full_like(a, FILL_VALUE)
    out[valid] = _dense_rank(a[valid])
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


def reverse_orientation(face_node_connectivity: np.ndarray) -> np.ndarray:
    """Reverse each row's valid entries, leaving the fill slots in place."""
    out = face_node_connectivity.copy()
    valid = face_node_connectivity != FILL_VALUE
    reversed_vals = face_node_connectivity[:, ::-1]
    out[valid] = reversed_vals[reversed_vals != FILL_VALUE]
    return out


def counterclockwise(face_node_connectivity: np.ndarray, nodes: np.ndarray) -> np.ndarray:
    """The faces with their nodes counter-clockwise (positive signed
    area): clockwise rows reversed."""
    closed, _ = close_polygons(face_node_connectivity)
    dxy = np.diff(nodes[closed], axis=1)
    reverse = cross2d(dxy[:, :-1], dxy[:, 1:]).sum(axis=1) < 0
    ccw = face_node_connectivity.copy()
    if reverse.any():
        ccw[reverse] = reverse_orientation(face_node_connectivity[reverse])
    return ccw


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


def validate_edge_node_connectivity(
    face_node_connectivity: np.ndarray, edge_node_connectivity: np.ndarray
) -> np.ndarray:
    """Per given edge: whether the faces define it and it is the first
    of its node pair (not a duplicate).  Raises where the faces define
    more edges than the given ones hold."""
    derived, _ = edge_connectivity(face_node_connectivity)
    old = np.sort(edge_node_connectivity, axis=1)

    # Pack (a, b) pairs into single int64 keys for fast membership tests.
    def pack(pairs: np.ndarray) -> np.ndarray:
        return pairs[:, 0].astype(np.int64) << 32 | pairs[:, 1].astype(np.uint32)

    new_keys = pack(derived)
    old_keys = pack(old)
    _, first_index = np.unique(old_keys, return_index=True)
    n_unique_old = len(first_index)
    if n_unique_old < len(new_keys):
        raise ValueError(
            f"face_node_connectivity defines {len(new_keys)} edges, but "
            f"edge_node_connectivity defines only {n_unique_old} edges."
        )
    is_first = np.zeros(len(old_keys), dtype=bool)
    is_first[first_index] = True
    return np.isin(old_keys, new_keys) & is_first


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


def directed_node_node_connectivity(edge_node_connectivity: np.ndarray) -> sparse.csr_matrix:
    """Node adjacency along each edge's direction (first node to second);
    data holds the edge index."""
    i = edge_node_connectivity[:, 0]
    j = edge_node_connectivity[:, 1]
    edge_index = np.arange(len(edge_node_connectivity))
    n = int(max(i.max(), j.max())) + 1
    return sparse.coo_matrix((edge_index, (i, j)), shape=(n, n)).tocsr()


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


def directed_edge_edge_connectivity(
    edge_node_connectivity: np.ndarray, node_edge_connectivity: sparse.csr_matrix
) -> sparse.csr_matrix:
    """Each edge's downstream edges: those at its second node; data holds
    that node."""
    n_edge = len(edge_node_connectivity)
    second_node = edge_node_connectivity[:, 1]
    n_downstream = node_edge_connectivity.getnnz(axis=1)[second_node]
    upstream = np.repeat(np.arange(n_edge), n_downstream)
    downstream = node_edge_connectivity[second_node].indices
    node_index = np.repeat(second_node, n_downstream)
    valid = downstream != upstream
    return sparse.csr_matrix(
        (node_index[valid], (upstream[valid], downstream[valid])),
        shape=(n_edge, n_edge),
    )


def structured_connectivity(active: np.ndarray) -> AdjacencyMatrix:
    """Four-neighbour adjacency of the active cells of a structured
    raster, the cells renumbered in order."""
    nrow, ncol = active.shape
    cells = np.arange(nrow * ncol).reshape(nrow, ncol)
    cells = np.where(active, cells, -1)
    pairs = []
    for a, b in (
        (cells[:, :-1].ravel(), cells[:, 1:].ravel()),
        (cells[:-1].ravel(), cells[1:].ravel()),
    ):
        valid = (a != -1) & (b != -1)
        pairs.append((a[valid], b[valid]))
    left_right = np.concatenate([p[0] for p in pairs] + [p[1] for p in pairs])
    right_left = np.concatenate([p[1] for p in pairs] + [p[0] for p in pairs])
    i = renumber(left_right)
    j = renumber(right_left)
    A = sparse.coo_matrix((j, (i, j))).tocsr()
    n, m = A.shape
    return AdjacencyMatrix(A.indices, A.indptr, A.nnz, n, m)


# Geometry
# --------
def perimeter(face_node_connectivity, node_x, node_y) -> np.ndarray:
    """Perimeter of every face."""
    nodes = np.column_stack([node_x, node_y])
    closed, _ = close_polygons(face_node_connectivity)
    coords = nodes[closed]
    coords = coords - coords[:, :1]  # local origin: keeps the precision
    dxy = np.diff(coords, axis=1)
    return np.linalg.norm(dxy, axis=-1).sum(axis=1)


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


def circumcenters(face_node_connectivity, node_x, node_y) -> np.ndarray:
    """(n_face, 2) circumcenters of a triangular grid; raises
    NotImplementedError for other faces."""
    if face_node_connectivity.shape[1] != 3:
        raise NotImplementedError("Circumcenters are only supported for triangular grids")
    ax, bx, cx = (node_x[face_node_connectivity[:, k]] for k in range(3))
    ay, by, cy = (node_y[face_node_connectivity[:, k]] for k in range(3))
    # The perpendicular bisectors' intersection, relative to vertex c
    # for precision.
    ux, uy = ax - cx, ay - cy
    vx, vy = bx - cx, by - cy
    d = 2.0 * (ux * vy - uy * vx)
    u2 = ux * ux + uy * uy
    v2 = vx * vx + vy * vy
    x = cx + (vy * u2 - uy * v2) / d
    y = cy + (ux * v2 - vx * u2) / d
    return np.column_stack((x, y))


# Triangulation
# -------------
def _fan_gather(node_stream: np.ndarray, row_starts: np.ndarray, counts: np.ndarray):
    """Fan triangles by gathers into the per-row node stream: triangle t
    of a row is (stream[start], stream[start + t + 1], stream[start + t +
    2])."""
    tri_per_row = np.maximum(counts - 2, 0)
    face = np.repeat(np.arange(len(counts)), tri_per_row)
    offsets = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(tri_per_row, out=offsets[1:])
    rank = np.arange(offsets[-1]) - offsets[face]
    base = row_starts[face]
    triangles = np.empty((len(face), 3), IntDType)
    triangles[:, 0] = node_stream[base]
    triangles[:, 1] = node_stream[base + rank + 1]
    triangles[:, 2] = node_stream[base + rank + 2]
    return triangles, face.astype(IntDType)


def triangulate_dense(face_node_connectivity: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    n_face, n_max = face_node_connectivity.shape
    if n_max == 3:
        return face_node_connectivity.copy(), np.arange(n_face)
    valid = face_node_connectivity != FILL_VALUE
    counts = valid.sum(axis=1)
    starts = np.zeros(n_face + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    return _fan_gather(face_node_connectivity[valid], starts[:-1], counts)


def triangulate_coo(conn: sparse.coo_matrix) -> Tuple[np.ndarray, np.ndarray]:
    counts = conn.getnnz(axis=1)
    if counts.max() == 3:
        triangles = conn.row.copy().reshape((-1, 3))
        return triangles, np.arange(len(triangles))
    starts = np.zeros(conn.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    return _fan_gather(conn.col, starts[:-1], counts)


def triangulate(face_node_connectivity) -> Tuple[np.ndarray, np.ndarray]:
    """
    Fan triangulation of the faces from the first node of every face:
    (first, second, third), (first, third, fourth), ...  Returns
    (triangles (n_triangle, 3), triangle_face_connectivity).
    """
    if isinstance(face_node_connectivity, np.ndarray):
        return triangulate_dense(face_node_connectivity)
    elif isinstance(face_node_connectivity, sparse.coo_matrix):
        return triangulate_coo(face_node_connectivity)
    raise TypeError("connectivity must be ndarray or sparse matrix")


# Binary morphology on adjacency graphs
# -------------------------------------
# One step is a structure-only product: a dilation sets every cell with
# a True neighbour, an erosion clears every cell with a False neighbour.
def _structure_matrix(connectivity: sparse.csr_matrix) -> sparse.csr_matrix:
    """Pattern-only symmetric adjacency: the data (edge ids, which may
    be 0) is ignored, so every stored entry counts as a neighbour."""
    pattern = sparse.csr_matrix(
        (
            np.ones(len(connectivity.indices), dtype=np.int8),
            connectivity.indices,
            connectivity.indptr,
        ),
        shape=connectivity.shape,
    )
    return pattern.maximum(pattern.T).tocsr()


def _binary_iterate(
    connectivity: sparse.csr_matrix,
    input: np.ndarray,
    value: bool,
    iterations: int,
    mask: Optional[np.ndarray],
    exterior: Optional[np.ndarray],
    border_value: Optional[bool],
) -> np.ndarray:
    """``iterations`` steps (at least one) of dilation (``value`` True)
    or erosion; ``mask`` is set to ``not value`` after every step, and
    ``exterior`` to ``value`` after the first step only, where
    ``border_value`` equals ``value``."""
    if input.dtype != np.bool_:
        raise TypeError("input dtype should be bool")
    if input.ndim != 1:
        raise ValueError(
            "Binary operations are only supported for a single (face) "
            f"dimension. Found {input.ndim} dimensions."
        )
    A = _structure_matrix(connectivity)
    out = input.copy()
    for step in range(max(iterations, 1)):
        if value:
            out |= (A @ out.astype(np.int8)).astype(bool)
        else:
            out &= ~(A @ (~out).astype(np.int8)).astype(bool)
        if mask is not None:
            out[mask] = not value
        if step == 0 and exterior is not None and value == border_value:
            out[exterior] = value
    return out


def binary_erosion(
    connectivity: sparse.csr_matrix,
    input: np.ndarray,
    iterations: int = 1,
    mask: Optional[np.ndarray] = None,
    exterior: Optional[np.ndarray] = None,
    border_value: Optional[bool] = False,
) -> np.ndarray:
    """True regions shrunk along the adjacency."""
    return _binary_iterate(connectivity, input, False, iterations, mask, exterior, border_value)


def binary_dilation(
    connectivity: sparse.csr_matrix,
    input: np.ndarray,
    iterations: int = 1,
    mask: Optional[np.ndarray] = None,
    exterior: Optional[np.ndarray] = None,
    border_value: Optional[bool] = False,
) -> np.ndarray:
    """True regions grown along the adjacency."""
    return _binary_iterate(connectivity, input, True, iterations, mask, exterior, border_value)
