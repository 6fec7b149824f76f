"""Frozen byte counts of the port's kernels and the published peak they
are held to.  Bytes count each input read once and each output written
once, at the shapes of the call, whatever the kernel reads again."""

from __future__ import annotations

#: NVIDIA H100 SXM, data sheet: 80 GB of HBM3 at 3.35 TB/s (at its
#: full 700 W power limit).
PEAK_HBM_BYTES_PER_S = 3.35e12


def window_reduce_bytes(nnz: int, m: int, n: int, E: float, itemsize: int = 4) -> float:
    """One ``window_reduce`` launch over an (E, m) source into (E, n):
    every weight and its int32 index, the source and the output."""
    return nnz * (4 + itemsize) + m * E * itemsize + n * E * itemsize


def share_pct(nbytes: float, seconds: float) -> float:
    """The least time the bytes take at the published bandwidth, as a
    percentage of ``seconds``."""
    return 100.0 * nbytes / PEAK_HBM_BYTES_PER_S / seconds
