"""Order statistics over the windows of overlap between mesh faces and
raster cells, in plain PyTorch on any device: a target's window is the
faces whose area of overlap with it is positive
(``overlap.overlap_triplets``), and its p-th percentile is that of the
window's non-NaN values, NaN where none is valid.

It follows xugrid's ``reduce.Percentile``: linear interpolation between
the closest ranks, rank = 1 + (n - 1) p / 100 over the n valid values,
which is ``torch.nanquantile(q=p / 100, interpolation="linear")``.
Departures: the rank and the interpolation are computed in float64 (the
port computes them in the values' dtype), and the weights play no part
beyond deciding the window (xugrid gates the result on the window's
largest weight being positive, which every positive-area window meets).
"""

from __future__ import annotations

import torch

#: float32 and float64 are ranked as they are; a lower precision is
#: rounded to and ranked in float32 (``torch.nanquantile`` takes no other).
RANKED = (torch.float32, torch.float64)


def windows(triplets, n_target: int) -> torch.Tensor:
    """(n_target, w) int64: each target's source faces, -1 padded, w the
    largest window (at least 1)."""
    target, source, _ = triplets
    order = torch.argsort(target, stable=True)
    target, source = target[order], source[order]
    counts = torch.bincount(target, minlength=n_target)
    w = max(int(counts.max()) if len(counts) else 0, 1)
    first = torch.cumsum(counts, 0) - counts
    slot = torch.arange(len(target), device=target.device) - first[target]
    out = torch.full((n_target, w), -1, dtype=torch.int64, device=target.device)
    out[target, slot] = source
    return out


def percentile(window: torch.Tensor, values: torch.Tensor, p: float, dtype=torch.float64, block: int = 64) -> torch.Tensor:
    """(E, n_target) float64: per slice of ``values`` (E, m) and target of
    ``window`` (``windows``) the p-th percentile of the window's non-NaN
    values, NaN where none is valid.  ``dtype`` is the precision of the
    values and of the result; ``block`` slices are ranked at a time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ranked = dtype if dtype in RANKED else torch.float32
    pad = window < 0
    safe = window.clamp(min=0)
    out = torch.empty((values.shape[0], window.shape[0]), dtype=torch.float64, device=values.device)
    for start in range(0, values.shape[0], block):
        v = values[start : start + block][:, safe].to(dtype).to(ranked)  # (B, n, w)
        v = torch.where(pad, torch.nan, v)
        q = torch.nanquantile(v, p / 100.0, dim=-1, interpolation="linear")
        out[start : start + block] = q.to(dtype).double()
    return out
