"""
ctypes bindings for the repository's native host kernels
(``csrc/host_kernels.cpp``), the same source ``xugrid_tpu`` builds.

Bound are the BVH's kd order, the entry points of the regridders'
weight builds (grid hash, polygon clips, point location, point in
polygon, segment clip, mean-value weights, CSR build), the face
centroids, the partition
and merge kernels (Hilbert distances, the hashed row deduplication) and
the network's graph walks (topological sort, vertex contraction), the greedy
snap of ``snap_nodes`` and the Hilbert-ordered padded weight layout of
the sharded regrid.  The library is
compiled with g++ into the port's build directory on first use.  Every
binding returns None when the library is unavailable (or refuses the
input, as each one says); its caller then takes a numpy fallback where
``xugrid_tpu`` has one on the host, sends polygons refused by size to
the device geometry (``spatial/celltree.py``), and raises where the
library is missing and ``xugrid_tpu`` falls back to a device kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np

from xugrid_tpu_torch.utils.build import PACKAGE_DIR, compile_shared

_SOURCE = PACKAGE_DIR.parent / "csrc" / "host_kernels.cpp"

#: -ffp-contract=off: the exact-geometry kernels keep bit-for-bit parity
#: with their numpy fallbacks; FMA contraction under -O3 -march=native
#: breaks it at 1 ulp on boundary-grazing inputs.
_CFLAGS = (
    "g++", "-O3", "-march=native", "-ffp-contract=off",
    "-shared", "-fPIC", "-std=c++17", "-pthread",
)

_lib = None
_tried = False

_dp = ctypes.POINTER(ctypes.c_double)
_ip = ctypes.POINTER(ctypes.c_int64)
_i64 = ctypes.c_int64
_f64 = ctypes.c_double
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _bind(lib):
    lib.kd_order.argtypes = [_dp, _i64, ctypes.c_int32, _i64, _ip]
    lib.kd_order.restype = None
    lib.face_bbox.argtypes = [_ip, _i64, _i64, _dp, _dp, _dp]
    lib.face_bbox.restype = None
    lib.pad_and_bbox.argtypes = [_ip, _i64, _i64, _dp, _dp, _dp, _dp]
    lib.pad_and_bbox.restype = None
    grid = [_dp, _i64, _f64, _f64, _f64, _f64, _i64, _i64]
    lib.grid_hash_count.argtypes = grid + [_ip]
    lib.grid_hash_count.restype = ctypes.c_int64
    lib.grid_hash_fill.argtypes = [_dp, _ip, _i64] + grid[2:] + [_ip, _ip]
    lib.grid_hash_fill.restype = None
    points = [_dp, _i64, _f64, _f64, _f64, _f64, _f64, _i64, _i64, _ip, _ip, _dp]
    lib.grid_hash_points_count.argtypes = points + [_ip]
    lib.grid_hash_points_count.restype = None
    lib.grid_hash_points_fill.argtypes = points + [_ip, _ip, _ip]
    lib.grid_hash_points_fill.restype = None
    boxes = grid + [_ip, _ip, _dp]
    lib.grid_hash_boxes_count.argtypes = boxes + [_ip]
    lib.grid_hash_boxes_count.restype = None
    lib.grid_hash_boxes_fill.argtypes = boxes + [_ip, _ip, _ip]
    lib.grid_hash_boxes_fill.restype = None
    lib.polygon_clip_areas_conn.argtypes = [
        _ip, _ip, _i64, _dp, _i64, _ip, _i64, _dp, _dp, _dp,
    ]
    lib.polygon_clip_areas_conn.restype = None
    lib.polygon_clip_areas.argtypes = [_ip, _ip, _i64, _dp, _i64, _dp, _i64, _dp]
    lib.polygon_clip_areas.restype = None
    lib.csr_from_triplet.argtypes = [_ip, _ip, _dp, _i64, _i64, _ip, _ip, _dp]
    lib.csr_from_triplet.restype = None
    lib.face_centroids.argtypes = [_ip, _i64, _i64, _dp, _dp, _dp]
    lib.face_centroids.restype = None
    lib.points_in_polygons.argtypes = [_dp, _ip, _i64, _dp, _i64, _f64, _u8p]
    lib.points_in_polygons.restype = None
    lib.clip_segments_by_faces.argtypes = [_dp, _dp, _ip, _i64, _dp, _i64, _u8p, _dp, _dp]
    lib.clip_segments_by_faces.restype = None
    lib.mean_value_weights.argtypes = [_dp, _ip, _i64, _dp, _i64, _f64, _dp]
    lib.mean_value_weights.restype = None
    lib.locate_points_hash.argtypes = points[:3] + points[3:9] + [_ip, _ip, _dp, _dp, _i64, _ip]
    lib.locate_points_hash.restype = None
    lib.hilbert_distance.argtypes = [_dp, _i64, ctypes.c_int32, _f64, _f64, _f64, _f64, ctypes.POINTER(ctypes.c_uint64)]
    lib.hilbert_distance.restype = None
    lib.unique_rows_hash.argtypes = [ctypes.c_char_p, _i64, _i64, _ip, _ip]
    lib.unique_rows_hash.restype = ctypes.c_int64
    lib.unique_sorted_rows_hash.argtypes = [_ip, _i64, _i64, _ip, _ip]
    lib.unique_sorted_rows_hash.restype = ctypes.c_int64
    lib.topo_sort_dfs.argtypes = [_ip, _ip, _i64, _ip]
    lib.topo_sort_dfs.restype = ctypes.c_int64
    lib.contract_vertices_walk.argtypes = [_ip, _ip, _i64, _ip, _i64, _ip, _i64]
    lib.contract_vertices_walk.restype = ctypes.c_int64
    lib.snap_to_nearest_greedy.argtypes = [_ip, _ip, _dp, _i64, _ip, _i64, _f64, _ip]
    lib.snap_to_nearest_greedy.restype = None
    lib.padded_layout.argtypes = [
        _ip, _ip, _dp, _i64, _i64, _ip, _ip, _ip, _i64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
    ]
    lib.padded_layout.restype = ctypes.c_int64


def get_lib():
    """The loaded host library, or None when it cannot be built."""
    global _lib, _tried
    if not _tried:
        _tried = True
        try:
            path = compile_shared(list(_CFLAGS), [_SOURCE], "host_kernels")
            lib = ctypes.CDLL(str(path))
        except (RuntimeError, OSError, FileNotFoundError):
            return None
        _bind(lib)
        _lib = lib
    return _lib


def _ptr(array, kind):
    return array.ctypes.data_as(kind)


def kd_order_native(xy: np.ndarray, n_levels: int, capacity: int):
    """The BVH's kd order of (n, 2) points (``spatial/bvh.py:kd_order``),
    or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    xy = np.ascontiguousarray(xy, dtype=np.float64)
    out = np.empty(len(xy), dtype=np.int64)
    lib.kd_order(_ptr(xy, _dp), len(xy), n_levels, capacity, _ptr(out, _ip))
    return out


def face_bbox_native(faces: np.ndarray, x: np.ndarray, y: np.ndarray):
    """Per-face AABBs (n, 4), or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    faces = np.ascontiguousarray(faces, dtype=np.int64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    n, nv = faces.shape
    out = np.empty((n, 4), dtype=np.float64)
    lib.face_bbox(_ptr(faces, _ip), n, nv, _ptr(x, _dp), _ptr(y, _dp), _ptr(out, _dp))
    return out


def pad_and_bbox_native(faces: np.ndarray, x: np.ndarray, y: np.ndarray):
    """Padded polygon buffer (n, nv, 2) and per-face AABBs (n, 4) in one
    pass, or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    faces = np.ascontiguousarray(faces, dtype=np.int64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    n, nv = faces.shape
    poly_xy = np.empty((n, nv, 2), dtype=np.float64)
    bbox = np.empty((n, 4), dtype=np.float64)
    lib.pad_and_bbox(
        _ptr(faces, _ip), n, nv, _ptr(x, _dp), _ptr(y, _dp),
        _ptr(poly_xy, _dp), _ptr(bbox, _dp),
    )
    return poly_xy, bbox


def grid_hash_bins_native(boxes, ids, xmin, ymin, dx, dy, nx, ny):
    """Grid-hash binning: (bin_start (nx*ny+1), bin_prims), or None when
    the library is unavailable.  ``ids`` None means identity ids."""
    lib = get_lib()
    if lib is None:
        return None
    boxes = np.ascontiguousarray(boxes, dtype=np.float64)
    if ids is not None:
        ids = np.ascontiguousarray(ids, dtype=np.int64)
    k = len(boxes)
    bin_start = np.zeros(nx * ny + 1, dtype=np.int64)
    total = lib.grid_hash_count(
        _ptr(boxes, _dp), k, xmin, ymin, dx, dy, nx, ny, _ptr(bin_start, _ip)
    )
    bin_prims = np.empty(total, dtype=np.int64)
    cursor = bin_start[:-1].copy()
    lib.grid_hash_fill(
        _ptr(boxes, _dp),
        _ptr(ids, _ip) if ids is not None else None,
        k, xmin, ymin, dx, dy, nx, ny,
        _ptr(cursor, _ip), _ptr(bin_prims, _ip),
    )
    return bin_start, bin_prims


def grid_hash_query_boxes_native(
    qb, xmin, ymin, dx, dy, nx, ny, bin_start, bin_prims, boxes
):
    """Box candidate join with exact bbox filter and inline dedup:
    (pair_q, pair_p) int64, or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    qb = np.ascontiguousarray(qb, dtype=np.float64)
    bin_start = np.ascontiguousarray(bin_start, dtype=np.int64)
    bin_prims = np.ascontiguousarray(bin_prims, dtype=np.int64)
    boxes = np.ascontiguousarray(boxes, dtype=np.float64)
    nq = len(qb)
    counts = np.empty(nq, dtype=np.int64)
    common = (
        _ptr(qb, _dp), nq, xmin, ymin, dx, dy, nx, ny,
        _ptr(bin_start, _ip), _ptr(bin_prims, _ip), _ptr(boxes, _dp),
    )
    lib.grid_hash_boxes_count(*common, _ptr(counts, _ip))
    offsets = np.zeros(nq, dtype=np.int64)
    if nq:
        np.cumsum(counts[:-1], out=offsets[1:])
    total = int(offsets[-1] + counts[-1]) if nq else 0
    pair_q = np.empty(total, dtype=np.int64)
    pair_p = np.empty(total, dtype=np.int64)
    lib.grid_hash_boxes_fill(
        *common, _ptr(offsets, _ip), _ptr(pair_q, _ip), _ptr(pair_p, _ip)
    )
    return pair_q, pair_p


def polygon_clip_areas_conn_native(pair_q, pair_p, query_xy, tree_faces, x, y):
    """Convex clip area per candidate pair, gathering the tree polygons
    from connectivity, or None when the library is unavailable or the
    polygons are too large for the kernel's working buffer."""
    lib = get_lib()
    # The Sutherland-Hodgman kernel's fixed buffer holds 96 vertices and
    # silently truncates beyond that (wrong areas): refuse those shapes.
    if (
        lib is None
        or tree_faces.shape[1] > 32
        or query_xy.shape[1] + tree_faces.shape[1] > 96
    ):
        return None
    pair_q = np.ascontiguousarray(pair_q, dtype=np.int64)
    pair_p = np.ascontiguousarray(pair_p, dtype=np.int64)
    query_xy = np.ascontiguousarray(query_xy, dtype=np.float64)
    tree_faces = np.ascontiguousarray(tree_faces, dtype=np.int64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    areas = np.empty(len(pair_q), dtype=np.float64)
    lib.polygon_clip_areas_conn(
        _ptr(pair_q, _ip), _ptr(pair_p, _ip), len(pair_q),
        _ptr(query_xy, _dp), query_xy.shape[1],
        _ptr(tree_faces, _ip), tree_faces.shape[1],
        _ptr(x, _dp), _ptr(y, _dp), _ptr(areas, _dp),
    )
    return areas


def polygon_clip_areas_native(pair_q, pair_p, query_xy, tree_xy):
    """Convex clip area per candidate pair of padded polygon buffers, or
    None when the library is unavailable or the two polygons together
    hold more than the kernel's 96-vertex working buffer (a convex-convex
    intersection has at most m + k vertices)."""
    lib = get_lib()
    if lib is None or query_xy.shape[1] + tree_xy.shape[1] > 96:
        return None
    pair_q = np.ascontiguousarray(pair_q, dtype=np.int64)
    pair_p = np.ascontiguousarray(pair_p, dtype=np.int64)
    query_xy = np.ascontiguousarray(query_xy, dtype=np.float64)
    tree_xy = np.ascontiguousarray(tree_xy, dtype=np.float64)
    areas = np.empty(len(pair_q), dtype=np.float64)
    lib.polygon_clip_areas(
        _ptr(pair_q, _ip), _ptr(pair_p, _ip), len(pair_q),
        _ptr(query_xy, _dp), query_xy.shape[1],
        _ptr(tree_xy, _dp), tree_xy.shape[1], _ptr(areas, _dp),
    )
    return areas


def face_centroids_native(faces: np.ndarray, x: np.ndarray, y: np.ndarray):
    """Area-weighted polygon centroids (n, 2), or None when the library
    is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    # (n, 3) connectivities carrying fills would need numpy's
    # negative-index wraparound; leave them to the fallback.
    if faces.shape[1] == 3 and faces.min() < 0:
        return None
    faces = np.ascontiguousarray(faces, dtype=np.int64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    out = np.empty((len(faces), 2), dtype=np.float64)
    lib.face_centroids(_ptr(faces, _ip), faces.shape[0], faces.shape[1], _ptr(x, _dp), _ptr(y, _dp), _ptr(out, _dp))
    return out


def csr_from_triplet_native(row, col, data, n: int):
    """Stable counting-sort CSR build (same order as a stable argsort by
    row): (data, col, indptr), or None when the library is unavailable
    or the input is not float64 data with rows in [0, n)."""
    lib = get_lib()
    if lib is None or np.asarray(data).dtype != np.float64:
        return None
    row = np.ascontiguousarray(row, dtype=np.int64)
    # An out-of-range row is an IndexError in numpy but heap corruption in C.
    if len(row) and (row.min() < 0 or row.max() >= n):
        return None
    col = np.ascontiguousarray(col, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.float64)
    nnz = len(row)
    indptr = np.empty(n + 1, dtype=np.int64)
    out_col = np.empty(nnz, dtype=np.int64)
    out_data = np.empty(nnz, dtype=np.float64)
    lib.csr_from_triplet(
        _ptr(row, _ip), _ptr(col, _ip), _ptr(data, _dp), nnz, n,
        _ptr(indptr, _ip), _ptr(out_col, _ip), _ptr(out_data, _dp),
    )
    return out_data, out_col, indptr


def grid_hash_query_points_native(pts, tol, xmin, ymin, dx, dy, nx, ny, bin_start, bin_prims, boxes):
    """Point candidate join, one bin scan per point: (pair_q, pair_p)
    int64 for the boxes (expanded by ``tol``) that hold each point, or
    None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    bin_start = np.ascontiguousarray(bin_start, dtype=np.int64)
    bin_prims = np.ascontiguousarray(bin_prims, dtype=np.int64)
    boxes = np.ascontiguousarray(boxes, dtype=np.float64)
    nq = len(pts)
    counts = np.empty(nq, dtype=np.int64)
    common = (
        _ptr(pts, _dp), nq, float(tol), xmin, ymin, dx, dy, nx, ny,
        _ptr(bin_start, _ip), _ptr(bin_prims, _ip), _ptr(boxes, _dp),
    )
    lib.grid_hash_points_count(*common, _ptr(counts, _ip))
    offsets = np.zeros(nq, dtype=np.int64)
    if nq:
        np.cumsum(counts[:-1], out=offsets[1:])
    total = int(offsets[-1] + counts[-1]) if nq else 0
    pair_q = np.empty(total, dtype=np.int64)
    pair_p = np.empty(total, dtype=np.int64)
    lib.grid_hash_points_fill(*common, _ptr(offsets, _ip), _ptr(pair_q, _ip), _ptr(pair_p, _ip))
    return pair_q, pair_p


def points_in_polygons_native(pts, prims, poly_xy, tol: float):
    """Pairwise point in polygon (crossing number, or within ``tol`` of
    an edge): bool per (pts[i], poly_xy[prims[i]]), or None when the
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    prims = np.ascontiguousarray(prims, dtype=np.int64)
    poly_xy = np.ascontiguousarray(poly_xy, dtype=np.float64)
    out = np.empty(len(pts), dtype=np.uint8)
    lib.points_in_polygons(
        _ptr(pts, _dp), _ptr(prims, _ip), len(pts), _ptr(poly_xy, _dp), poly_xy.shape[1],
        float(tol), _ptr(out, _u8p),
    )
    return out.astype(bool)


def clip_segments_by_faces_native(p0, p1, prims, poly_xy):
    """Pairwise Liang-Barsky clip of segment (p0[i], p1[i]) by the
    convex face poly_xy[prims[i]]: (valid, t0, t1), or None when the
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    p0 = np.ascontiguousarray(p0, dtype=np.float64)
    p1 = np.ascontiguousarray(p1, dtype=np.float64)
    prims = np.ascontiguousarray(prims, dtype=np.int64)
    poly_xy = np.ascontiguousarray(poly_xy, dtype=np.float64)
    n = len(prims)
    valid = np.empty(n, dtype=np.uint8)
    t0 = np.empty(n, dtype=np.float64)
    t1 = np.empty(n, dtype=np.float64)
    lib.clip_segments_by_faces(
        _ptr(p0, _dp), _ptr(p1, _dp), _ptr(prims, _ip), n, _ptr(poly_xy, _dp), poly_xy.shape[1],
        _ptr(valid, _u8p), _ptr(t0, _dp), _ptr(t1, _dp),
    )
    return valid.astype(bool), t0, t1


def mean_value_weights_native(pts, prims, poly_xy, tol: float):
    """Mean-value coordinates of pts[i] in poly_xy[prims[i]], (n, nv)
    (a zero row where prims[i] < 0), or None when the library is
    unavailable or a face has more than the kernel's 64 nodes."""
    lib = get_lib()
    if lib is None or poly_xy.shape[1] > 64:
        return None
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    prims = np.ascontiguousarray(prims, dtype=np.int64)
    poly_xy = np.ascontiguousarray(poly_xy, dtype=np.float64)
    out = np.empty((len(pts), poly_xy.shape[1]), dtype=np.float64)
    lib.mean_value_weights(
        _ptr(pts, _dp), _ptr(prims, _ip), len(pts), _ptr(poly_xy, _dp), poly_xy.shape[1],
        float(tol), _ptr(out, _dp),
    )
    return out


def locate_points_hash_native(pts, tol: float, grid_hash, poly_xy):
    """Fused grid-hash scan and exact test: the lowest-index face holding
    each point (-1 for none), or None when the library is unavailable
    or the hash has oversize primitives (those bypass the bins)."""
    lib = get_lib()
    if lib is None or len(grid_hash.oversize) > 0:
        return None
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    poly_xy = np.ascontiguousarray(poly_xy, dtype=np.float64)
    boxes = np.ascontiguousarray(grid_hash.boxes, dtype=np.float64)
    bin_start = np.ascontiguousarray(grid_hash.bin_start, dtype=np.int64)
    bin_prims = np.ascontiguousarray(grid_hash.bin_prims, dtype=np.int64)
    out = np.empty(len(pts), dtype=np.int64)
    lib.locate_points_hash(
        _ptr(pts, _dp), len(pts), float(tol),
        grid_hash.xmin, grid_hash.ymin, grid_hash.dx, grid_hash.dy, grid_hash.nx, grid_hash.ny,
        _ptr(bin_start, _ip), _ptr(bin_prims, _ip), _ptr(boxes, _dp),
        _ptr(poly_xy, _dp), poly_xy.shape[1], _ptr(out, _ip),
    )
    return out


def hilbert_distance_native(xy: np.ndarray, order: int = 16):
    """Distance along the Hilbert curve of 2^order cells over the points'
    bounding box, uint64 per point, or None when the library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    xy = np.ascontiguousarray(xy, dtype=np.float64)
    lo = xy.min(axis=0)
    extent = np.maximum(xy.max(axis=0) - lo, 1e-300)
    out = np.empty(len(xy), dtype=np.uint64)
    lib.hilbert_distance(
        _ptr(xy, _dp), len(xy), order, float(lo[0]), float(lo[1]), float(extent[0]), float(extent[1]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return out


def unique_rows_hash_native(rows: np.ndarray):
    """Bytewise row deduplication in first-seen order, one hashed pass:
    (rep, inverse, count), rep the first row of each group and inverse
    each row's group, or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows)
    n = len(rows)
    row_bytes = rows.dtype.itemsize * int(np.prod(rows.shape[1:]))
    rep = np.empty(n, dtype=np.int64)
    inverse = np.empty(n, dtype=np.int64)
    count = lib.unique_rows_hash(rows.ctypes.data_as(ctypes.c_char_p), n, row_bytes, _ptr(rep, _ip), _ptr(inverse, _ip))
    return rep[:count], inverse, int(count)


def unique_sorted_rows_native(rows: np.ndarray):
    """Deduplication of int64 rows regardless of the order within a row
    (each row sorted, then compared bytewise), in first-seen order:
    (rep, inverse, count), or None when the library is unavailable or a
    row is wider than the kernel's 64 entries."""
    lib = get_lib()
    if lib is None or rows.shape[1] > 64:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    n, width = rows.shape
    rep = np.empty(n, dtype=np.int64)
    inverse = np.empty(n, dtype=np.int64)
    count = lib.unique_sorted_rows_hash(_ptr(rows, _ip), n, width, _ptr(rep, _ip), _ptr(inverse, _ip))
    return rep[:count], inverse, int(count)


def topo_sort_dfs_native(indptr: np.ndarray, indices: np.ndarray, m: int):
    """Topological order of a directed graph (CSR) by depth-first search,
    its postorder reversed, or None when the library is unavailable.
    Raises ValueError on a cycle."""
    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    out = np.empty(m, dtype=np.int64)
    if lib.topo_sort_dfs(_ptr(indptr, _ip), _ptr(indices, _ip), m, _ptr(out, _ip)) == -1:
        raise ValueError("The graph contains at least one cycle")
    return out


def contract_vertices_native(indptr: np.ndarray, indices: np.ndarray, m: int, keep: np.ndarray):
    """The directed graph (CSR) contracted onto the vertices ``keep``: a
    (v, u) pair for every kept u reached downstream of a kept v without
    passing another kept vertex, in the walk's order; or None when the
    library is unavailable.  Raises ValueError on a cycle."""
    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    keep = np.ascontiguousarray(keep, dtype=np.int64)
    # The kernel writes the keep flags unchecked: an index out of range
    # must raise here, as the numpy walk does.
    if len(keep) and (keep.min() < 0 or keep.max() >= m):
        raise IndexError(f"contract_vertices: keep indices out of range [0, {m})")
    cap = max(4 * len(indices), 4 * len(keep), 1024)
    while True:
        out = np.empty((cap, 2), dtype=np.int64)
        rc = lib.contract_vertices_walk(
            _ptr(indptr, _ip), _ptr(indices, _ip), m, _ptr(keep, _ip), len(keep), _ptr(out, _ip), cap
        )
        if rc == -1:
            raise ValueError("The graph contains at least one cycle")
        if rc != -2:
            return out[:rc]
        cap *= 4


def snap_to_nearest_native(indptr, indices, data, n: int, candidates, max_distance: float):
    """The greedy snap assignment of ``snapping._snap_to_nearest`` over a
    CSR distance matrix: the visited array (-2 a target, -1 unvisited,
    else the target a node attaches to), or None when the library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.float64)
    candidates = np.ascontiguousarray(candidates, dtype=np.int64)
    # The kernel indexes unchecked: an index out of range must raise here.
    if len(indptr) != n + 1 or (len(candidates) and (candidates.min() < 0 or candidates.max() >= n)):
        raise IndexError(f"snap_to_nearest: indices out of range [0, {n})")
    visited = np.empty(n, dtype=np.int64)
    lib.snap_to_nearest_greedy(
        _ptr(indptr, _ip), _ptr(indices, _ip), _ptr(data, _dp), n,
        _ptr(candidates, _ip), len(candidates), float(max_distance), _ptr(visited, _ip),
    )
    return visited


def padded_layout_native(target_index, source_index, weights, torder, sremap, n: int):
    """The Hilbert-ordered ``PaddedCSR`` of a weight matrix in one pass
    (``padded_layout`` of csrc/host_kernels.cpp): row ``r`` is target
    ``torder[r]``'s window, its columns remapped by ``sremap``, in the
    triplets' entry order.  Returns (indices int32 (n, w_max), weights
    float32 (n, w_max)), or None when the library is unavailable, an
    index lies outside its range, or ``target_index`` is not grouped in
    ascending order (the caller then takes the sorting path)."""
    lib = get_lib()
    if lib is None:
        return None
    target_index = np.ascontiguousarray(target_index, dtype=np.int64)
    source_index = np.ascontiguousarray(source_index, dtype=np.int64)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    torder = np.ascontiguousarray(torder, dtype=np.int64)
    sremap = np.ascontiguousarray(sremap, dtype=np.int64)
    nnz = len(target_index)
    if nnz and (
        target_index.min() < 0 or target_index.max() >= n
        or source_index.min() < 0 or source_index.max() >= len(sremap)
    ):
        return None
    starts = np.empty(n + 1, dtype=np.int64)
    args = (_ptr(target_index, _ip), _ptr(source_index, _ip), _ptr(weights, _dp), nnz, n,
            _ptr(torder, _ip), _ptr(sremap, _ip), _ptr(starts, _ip))
    w_max = lib.padded_layout(*args, 0, None, None)
    if w_max < 0:
        return None
    w_max = max(int(w_max), 1)
    out_idx = np.empty((n, w_max), dtype=np.int32)
    out_w = np.empty((n, w_max), dtype=np.float32)
    lib.padded_layout(
        *args, w_max, out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out_idx, out_w
