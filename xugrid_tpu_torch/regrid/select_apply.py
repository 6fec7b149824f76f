"""
Hopper kernel #2, ``window_select`` (``csrc/window_select.cu``): the
order statistics of the regrid apply, one pass over ``PaddedCSR``.

It replaces ``xugrid_tpu/regrid/select_apply.py:gather_select_apply``
for mode, median and any percentile (``reduce.Percentile``).  Windows
of any width are taken, so the reference's 32-slot split plan has no
counterpart.

``window_select`` launches the kernel for CUDA tensors and raises on
what it does not take; for CPU tensors it runs the plain PyTorch
version, ``reduce.reduce_windows``.  ``window_select.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from xugrid_tpu_torch.regrid import reduce
from xugrid_tpu_torch.regrid.aligned_apply import DTYPE_CODES, check_kernel_args, kernel_function


def covers(reduction) -> bool:
    """True when the selection kernel implements ``reduction``."""
    return reduction is reduce.mode or isinstance(reduction, reduce.Percentile)


def window_select(sourceT: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor, reduction) -> torch.Tensor:
    """
    Mode or percentile over every target's window.

    sourceT: (m, E) source values, extra slices on the minor axis.
    indices: (n, w) int32, -1 padded.  weights: (n, w), 0 padded.
    Returns (n, E).
    """
    if not covers(reduction):
        raise ValueError(f"window_select does not cover {reduction!r}")
    if sourceT.device.type == "cpu":
        return reduce.reduce_windows(sourceT, indices, weights, reduction)
    check_kernel_args(sourceT, indices, weights)
    out = torch.empty((indices.shape[0], sourceT.shape[1]), dtype=sourceT.dtype, device=sourceT.device)
    if out.numel() == 0:
        return out
    is_mode = reduction is reduce.mode
    err = kernel_function("xt_window_select")(
        DTYPE_CODES[sourceT.dtype], 1 if is_mode else 0, 0.0 if is_mode else float(reduction.p),
        sourceT.data_ptr(), indices.data_ptr(), weights.data_ptr(), out.data_ptr(),
        indices.shape[0], indices.shape[1], sourceT.shape[1],
        torch.cuda.current_stream(sourceT.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"window_select launch failed with CUDA error {err}")
    window_select.launches += 1
    return out


window_select.launches = 0
