"""
Nearest-neighbour queries: the index of the nearest source point per
query point.

Two paths, chosen by problem shape as ``xugrid_tpu`` chooses them:

- the host: scipy's KDTree, threaded (a tree the caller built may be
  passed in and is reused);
- the device: ``nearest_scan``, a brute-force scan of every source per
  query, ``TILE`` sources at a time, keeping a running (best squared
  distance, index) per query, as torch ops on the card.  It takes over
  from P x M >= 2^36 query-source pairs, with at most 2^21 sources.

The scan computes in float32 about the sources' mean, so coordinates of
large magnitude (UTM, about 1e6) keep their relative precision.  It
forms d^2 = (qx - sx)^2 + (qy - sy)^2 directly: with two coordinates a
matrix product gains nothing, and this form has neither TF32 rounding
nor the cancellation of |q|^2 + |s|^2 - 2 q.s.  Ties go to the lowest
source index.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from xugrid_tpu_torch.utils.device import resolve_device

#: sources per scan step.
TILE = 2048
#: the device path engages from this many query-source pairs ...
_MIN_WORK = 1 << 36
#: ... and up to this many sources.
_MAX_SOURCES = 1 << 21
#: bytes of one (query chunk, TILE) float32 intermediate of the scan.
_CHUNK_BYTES = 256 << 20
#: queries per chunk: each (chunk, TILE) intermediate stays at _CHUNK_BYTES.
CHUNK = _CHUNK_BYTES // (TILE * 4)


def scan_tiles(queries: torch.Tensor, sources: torch.Tensor):
    """
    The scan on resident float32 tensors: (P, 2) queries against (M, 2)
    sources, both on one device.  Returns (best squared distance (P,)
    float32, best index (P,) int64; inf and -1 where no source is
    finite).  Within a tile the lowest index of equal distances wins;
    across tiles a later tile must be strictly nearer.
    """
    n_query, n_source = len(queries), len(sources)
    best_d2 = torch.full((n_query,), torch.inf, dtype=torch.float32, device=queries.device)
    best_idx = torch.full((n_query,), -1, dtype=torch.int64, device=queries.device)
    sx, sy = sources[:, 0], sources[:, 1]
    for start in range(0, n_query, CHUNK):
        stop = min(start + CHUNK, n_query)
        qx = queries[start:stop, 0:1]
        qy = queries[start:stop, 1:2]
        chunk_d2 = best_d2[start:stop]
        chunk_idx = best_idx[start:stop]
        for first in range(0, n_source, TILE):
            last = min(first + TILE, n_source)
            d2 = (qx - sx[first:last]).square_()
            dy = qy - sy[first:last]
            d2.addcmul_(dy, dy)
            tile_d2, arg = d2.min(dim=1)
            better = tile_d2 < chunk_d2
            chunk_d2.copy_(torch.where(better, tile_d2, chunk_d2))
            chunk_idx.copy_(torch.where(better, arg + first, chunk_idx))
    return best_d2, best_idx


def nearest_scan(queries: np.ndarray, sources: np.ndarray, device):
    """
    The device path: (P, 2) queries against (M, 2) sources (float64
    numpy), shifted to the sources' mean and computed in float32 on
    ``device``.  Returns (best squared distance (P,) float32, best index
    (P,) int64) as tensors on ``device``.
    """
    origin = sources.mean(axis=0)
    q = torch.from_numpy((queries - origin).astype(np.float32)).to(device)
    s = torch.from_numpy((sources - origin).astype(np.float32)).to(device)
    return scan_tiles(q, s)


def nearest_points(sources, queries, max_distance: float = np.inf, tree=None, device=None):
    """
    Index of the nearest source per query (-1 beyond ``max_distance``).

    The device scan runs from P x M >= 2^36 pairs with at most 2^21
    sources, on ``device`` (None: the CUDA card, which must be present),
    unless that is the CPU; else scipy's KDTree on the host (``tree``: a
    prebuilt KDTree over ``sources``, reused).  XUGRID_TPU_NEAREST=
    device|host overrides the choice; "device" runs the scan on
    ``device`` whatever it is.
    """
    sources = np.ascontiguousarray(sources, dtype=np.float64)
    queries = np.atleast_2d(np.ascontiguousarray(queries, dtype=np.float64))
    P, M = len(queries), len(sources)
    mode = os.environ.get("XUGRID_TPU_NEAREST", "auto")
    use_device = M > 0 and (
        mode == "device" or (mode == "auto" and P * M >= _MIN_WORK and M <= _MAX_SOURCES)
    )
    if use_device:
        device = resolve_device(None, device)
        use_device = mode == "device" or device.type == "cuda"
    if not use_device:
        if tree is None:
            from scipy.spatial import KDTree

            tree = KDTree(sources)
        _, indices = tree.query(queries, distance_upper_bound=max_distance, workers=-1)
        indices = np.asarray(indices, dtype=np.int64)
        indices[indices == M] = -1
        return indices

    d2, idx = nearest_scan(queries, sources, device)
    idx = idx.cpu().numpy()
    if np.isfinite(max_distance):
        idx = np.where(d2.cpu().numpy() <= max_distance**2, idx, -1)
    return idx
