"""
Uniform grid-hash spatial index: the candidate join of the weight build
(host; native C++ with vectorized numpy fallbacks).

Primitives are binned into a uniform grid sized to ~2 primitives per
cell.  Primitives larger than 4x the 99th-percentile extent go into a
small "oversize" list checked brute-force, which keeps cells small on
meshes with a few huge cells.
"""

from __future__ import annotations

import warnings

import numpy as np

from xugrid_tpu_torch.constants import IntDType
from xugrid_tpu_torch.utils.profiling import timed

#: bound on the (query_chunk x n_oversize) brute-force hit matrix.
OVERSIZE_CHUNK_ELEMS = 2**24


def alt_cumsum(a):
    """Exclusive cumsum: starts at 0, omits the final total."""
    out = np.cumsum(a)
    if out.size:
        out = np.roll(out, 1)
        out[0] = 0
    return out.astype(a.dtype, copy=False)


class GridHash:
    """Uniform-bin index over primitive bounding boxes."""

    def __init__(self, prim_bboxes: np.ndarray, target_per_cell: float = 2.0):
        with timed("grid_hash.build"):
            self._build(prim_bboxes, target_per_cell)

    def _build(self, prim_bboxes, target_per_cell):
        boxes = np.asarray(prim_bboxes, dtype=np.float64)
        self.boxes = boxes
        self.n_prim = len(boxes)

        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            self.xmin = float(np.nanmin(boxes[:, 0]))
            self.ymin = float(np.nanmin(boxes[:, 1]))
            xmax = float(np.nanmax(boxes[:, 2]))
            ymax = float(np.nanmax(boxes[:, 3]))
        if not (np.isfinite(self.xmin) and np.isfinite(self.ymin)):
            raise ValueError("no finite bounding boxes")
        extent_x = max(xmax - self.xmin, 1e-300)
        extent_y = max(ymax - self.ymin, 1e-300)

        # The p99 extent only SIZES cells: a sample is enough.
        step = max(1, len(boxes) // 65536)
        sw = boxes[::step, 2] - boxes[::step, 0]
        sh = boxes[::step, 3] - boxes[::step, 1]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            w99 = float(np.nanquantile(sw, 0.99))
            h99 = float(np.nanquantile(sh, 0.99))
        if not np.isfinite(w99):
            w99 = 0.0
        if not np.isfinite(h99):
            h99 = 0.0

        w = boxes[:, 2] - boxes[:, 0]
        h = boxes[:, 3] - boxes[:, 1]
        # Finiteness checks all 4 coordinates: a box with finite x but
        # NaN y would otherwise reach the binning with NaN cell indices.
        finite_all = np.isfinite(boxes).all(axis=1)
        with np.errstate(invalid="ignore"):
            oversize_mask = (w > 4 * max(w99, 1e-300)) | (
                h > 4 * max(h99, 1e-300)
            )
            regular_mask = finite_all & (w >= 0) & (h >= 0) & ~oversize_mask
        self.oversize = np.flatnonzero(oversize_mask)
        # No copy when EVERY box is regular: finite, not inverted, not
        # oversize.
        if len(self.oversize) == 0 and int(np.count_nonzero(regular_mask)) == len(boxes):
            regular_ids = None
            rb = boxes
            n_regular = len(boxes)
        else:
            regular_ids = np.flatnonzero(regular_mask)
            rb = boxes[regular_ids]
            n_regular = len(regular_ids)
        del w, h

        # ~target_per_cell prims per cell, cells at least the p99 extent
        # so each prim covers O(1) cells.
        n_cells_target = max(1, int(n_regular / target_per_cell))
        aspect = extent_x / extent_y
        ny = max(1, int(np.sqrt(n_cells_target / aspect)))
        nx = max(1, n_cells_target // ny)
        dx = max(extent_x / nx, w99, 1e-300)
        dy = max(extent_y / ny, h99, 1e-300)
        self.nx = max(1, int(np.ceil(extent_x / dx)))
        self.ny = max(1, int(np.ceil(extent_y / dy)))
        self.dx = extent_x / self.nx
        self.dy = extent_y / self.ny

        from xugrid_tpu_torch.utils.native import grid_hash_bins_native

        native = grid_hash_bins_native(
            rb, regular_ids, self.xmin, self.ymin, self.dx, self.dy,
            self.nx, self.ny,
        )
        if native is not None:
            self.bin_start, self.bin_prims = native
        else:
            if regular_ids is None:
                regular_ids = np.arange(len(boxes))
            ix0, iy0, ix1, iy1 = self._cell_ranges(rb)
            span_x = ix1 - ix0 + 1
            span_y = iy1 - iy0 + 1
            counts = span_x * span_y
            total = int(counts.sum())
            prim_rep = np.repeat(regular_ids, counts)
            offsets = np.arange(total) - np.repeat(alt_cumsum(counts), counts)
            span_x_rep = np.repeat(span_x, counts)
            cell_x = np.repeat(ix0, counts) + offsets % span_x_rep
            cell_y = np.repeat(iy0, counts) + offsets // span_x_rep
            cell = cell_y * self.nx + cell_x
            order = np.argsort(cell, kind="stable")
            self.bin_prims = prim_rep[order].astype(IntDType)
            bin_counts = np.bincount(cell, minlength=self.nx * self.ny)
            self.bin_start = np.zeros(self.nx * self.ny + 1, dtype=IntDType)
            np.cumsum(bin_counts, out=self.bin_start[1:])
        self._cols = None

    def _box_cols(self):
        """(bx0, by0, bx1, by1) contiguous columns for the fallback filter."""
        if self._cols is None:
            self._cols = tuple(
                np.ascontiguousarray(self.boxes[:, j]) for j in range(4)
            )
        return self._cols

    def _cell_ranges(self, boxes):
        # Reciprocal multiply, NOT division: matches the native binning
        # arithmetic bit for bit, so a build binned by one path is never
        # queried with 1-ulp-different cell indices.
        inv_dx = 1.0 / self.dx
        inv_dy = 1.0 / self.dy
        ix0 = np.clip(((boxes[:, 0] - self.xmin) * inv_dx).astype(np.int64), 0, self.nx - 1)
        iy0 = np.clip(((boxes[:, 1] - self.ymin) * inv_dy).astype(np.int64), 0, self.ny - 1)
        ix1 = np.clip(((boxes[:, 2] - self.xmin) * inv_dx).astype(np.int64), 0, self.nx - 1)
        iy1 = np.clip(((boxes[:, 3] - self.ymin) * inv_dy).astype(np.int64), 0, self.ny - 1)
        return ix0, iy0, ix1, iy1

    def query_boxes(self, query_boxes: np.ndarray):
        """
        Candidate join: (query_index, prim_index) pairs whose bounding
        boxes overlap, exact bbox filter included, without duplicates.
        """
        with timed("grid_hash.query_boxes"):
            return self._query_boxes(query_boxes)

    def _query_boxes(self, query_boxes):
        qb = np.asarray(query_boxes, dtype=np.float64)
        valid_q = (
            np.isfinite(qb).all(axis=1)
            & (qb[:, 0] <= qb[:, 2])
            & (qb[:, 1] <= qb[:, 3])
        )
        ids_q = np.flatnonzero(valid_q)
        b = qb[valid_q]
        if len(b) == 0:
            empty = np.empty(0, dtype=IntDType)
            return empty, empty

        from xugrid_tpu_torch.utils.native import grid_hash_query_boxes_native

        native = grid_hash_query_boxes_native(
            b, self.xmin, self.ymin, self.dx, self.dy, self.nx, self.ny,
            self.bin_start, self.bin_prims, self.boxes,
        )
        if native is not None:
            pair_q, pair_p = native
            return self._query_boxes_finish(pair_q, pair_p, b, ids_q)

        ix0, iy0, ix1, iy1 = self._cell_ranges(b)
        span_x = ix1 - ix0 + 1
        span_y = iy1 - iy0 + 1
        counts = span_x * span_y
        total = int(counts.sum())
        q_rep = np.repeat(np.arange(len(b)), counts)
        offsets = np.arange(total) - np.repeat(alt_cumsum(counts), counts)
        span_x_rep = np.repeat(span_x, counts)
        cell_x = np.repeat(ix0, counts) + offsets % span_x_rep
        cell_y = np.repeat(iy0, counts) + offsets // span_x_rep
        cell = cell_y * self.nx + cell_x

        # Expand each (query, cell) into the cell's primitives.
        start = self.bin_start[cell]
        n_in_bin = self.bin_start[cell + 1] - start
        total2 = int(n_in_bin.sum())
        pair_q = np.repeat(q_rep, n_in_bin)
        inner = np.arange(total2) - np.repeat(alt_cumsum(n_in_bin), n_in_bin)
        pair_p = self.bin_prims[np.repeat(start, n_in_bin) + inner]

        qx0 = b[:, 0][pair_q]
        qy0 = b[:, 1][pair_q]
        qx1 = b[:, 2][pair_q]
        qy1 = b[:, 3][pair_q]
        bx0, by0, bx1, by1 = self._box_cols()
        keep = (
            (bx0[pair_p] <= qx1)
            & (bx1[pair_p] >= qx0)
            & (by0[pair_p] <= qy1)
            & (by1[pair_p] >= qy0)
        )
        pair_q = pair_q[keep]
        pair_p = pair_p[keep]

        # A prim may share several cells with one query.
        unique_key = np.unique(pair_q.astype(np.int64) * self.n_prim + pair_p)
        pair_q = unique_key // self.n_prim
        pair_p = unique_key % self.n_prim
        return self._query_boxes_finish(pair_q, pair_p, b, ids_q)

    def _oversize_hits(self, qx0, qy0, qx1, qy1):
        """Brute-force the oversize list against query intervals, in
        query chunks so the broadcast hit matrix stays bounded."""
        ob = self.boxes[self.oversize]
        n_q = len(qx0)
        chunk = max(1, int(OVERSIZE_CHUNK_ELEMS // max(1, len(ob))))
        out_q, out_p = [], []
        for lo in range(0, n_q, chunk):
            hi = min(n_q, lo + chunk)
            hit = (
                (ob[None, :, 0] <= qx1[lo:hi, None])
                & (ob[None, :, 2] >= qx0[lo:hi, None])
                & (ob[None, :, 1] <= qy1[lo:hi, None])
                & (ob[None, :, 3] >= qy0[lo:hi, None])
            )
            oq, op = np.nonzero(hit)
            out_q.append(oq + lo)
            out_p.append(op)
        if not out_q:
            empty = np.empty(0, dtype=np.int64)
            return empty, empty
        return np.concatenate(out_q), np.concatenate(out_p)

    def _query_boxes_finish(self, pair_q, pair_p, b, ids_q):
        """Append brute-force oversize hits and remap to query ids."""
        if len(self.oversize) > 0:
            oq, op = self._oversize_hits(b[:, 0], b[:, 1], b[:, 2], b[:, 3])
            pair_q = np.concatenate([pair_q, oq])
            pair_p = np.concatenate([pair_p, self.oversize[op]])
        return ids_q[pair_q].astype(IntDType), pair_p.astype(IntDType)

    def query_points(self, points: np.ndarray, tol: float = 0.0):
        """
        Candidate join for points: (point_index, prim_index) pairs where
        the point falls inside the primitive's bounding box expanded by
        ``tol``, oversize primitives included.  Native path: one bin scan
        per point; else the box join of the expanded points.
        """
        pts = np.asarray(points, dtype=np.float64)
        with timed("grid_hash.query_points"):
            native = self._query_points_native(pts, tol)
        if native is not None:
            return native
        return self.query_boxes(np.column_stack([pts - tol, pts + tol]))

    def _query_points_native(self, pts, tol):
        from xugrid_tpu_torch.utils.native import grid_hash_query_points_native

        valid = np.isfinite(pts).all(axis=1)
        fp = pts[valid]
        result = grid_hash_query_points_native(
            fp, float(tol), self.xmin, self.ymin, self.dx, self.dy, self.nx, self.ny,
            self.bin_start, self.bin_prims, self.boxes,
        )
        if result is None:
            return None
        pair_q, pair_p = result
        if len(self.oversize) > 0:
            oq, op = self._oversize_hits(
                fp[:, 0] - tol, fp[:, 1] - tol, fp[:, 0] + tol, fp[:, 1] + tol
            )
            pair_q = np.concatenate([pair_q, oq])
            pair_p = np.concatenate([pair_p, self.oversize[op]])
        ids_q = np.flatnonzero(valid)
        return ids_q[pair_q].astype(IntDType), pair_p.astype(IntDType)
