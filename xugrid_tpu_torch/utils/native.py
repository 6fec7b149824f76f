"""
ctypes bindings for the repository's native host kernels
(``csrc/host_kernels.cpp``), the same source ``xugrid_tpu`` builds.

Only the entry points of the overlap-weight build are bound.  The
library is compiled with g++ into the port's build directory on first
use.  Every binding returns None when the library is unavailable, and
its caller then takes the numpy fallback, as in ``xugrid_tpu``.
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


def _bind(lib):
    lib.face_bbox.argtypes = [_ip, _i64, _i64, _dp, _dp, _dp]
    lib.face_bbox.restype = None
    lib.pad_and_bbox.argtypes = [_ip, _i64, _i64, _dp, _dp, _dp, _dp]
    lib.pad_and_bbox.restype = None
    grid = [_dp, _i64, _f64, _f64, _f64, _f64, _i64, _i64]
    lib.grid_hash_count.argtypes = grid + [_ip]
    lib.grid_hash_count.restype = ctypes.c_int64
    lib.grid_hash_fill.argtypes = [_dp, _ip, _i64] + grid[2:] + [_ip, _ip]
    lib.grid_hash_fill.restype = None
    boxes = grid + [_ip, _ip, _dp]
    lib.grid_hash_boxes_count.argtypes = boxes + [_ip]
    lib.grid_hash_boxes_count.restype = None
    lib.grid_hash_boxes_fill.argtypes = boxes + [_ip, _ip, _ip]
    lib.grid_hash_boxes_fill.restype = None
    lib.polygon_clip_areas_conn.argtypes = [
        _ip, _ip, _i64, _dp, _i64, _ip, _i64, _dp, _dp, _dp,
    ]
    lib.polygon_clip_areas_conn.restype = None
    lib.csr_from_triplet.argtypes = [_ip, _ip, _dp, _i64, _i64, _ip, _ip, _dp]
    lib.csr_from_triplet.restype = None


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
