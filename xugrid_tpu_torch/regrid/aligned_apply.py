"""
Hopper kernel #1, ``window_reduce`` (``csrc/window_reduce.cu``): the
windowed reductions of the regrid apply, one pass over ``PaddedCSR``.

It replaces ``xugrid_tpu/regrid/aligned_apply.py:gather_aligned_apply``
(and, by function, the stream, span, packet and pdot engines of
``xugrid_tpu/regrid/gather_apply.py``) for mean, sum,
first_order_conservative (which conductance is), harmonic_mean,
geometric_mean, minimum, maximum and max_overlap.

``window_reduce`` launches the kernel for CUDA tensors and raises on
what it does not take; for CPU tensors it runs the plain PyTorch
version, ``reduce.reduce_windows``.  ``window_reduce.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from xugrid_tpu_torch.regrid import reduce

#: reduce.py function -> the kernel's method code (csrc/window_reduce.cu).
METHOD_CODES = {
    reduce.mean: 0,
    reduce.sum: 1,
    reduce.first_order_conservative: 2,
    reduce.harmonic_mean: 3,
    reduce.geometric_mean: 4,
    reduce.minimum: 5,
    reduce.maximum: 6,
    reduce.max_overlap: 7,
}

#: kernel dtype codes (csrc/*.cu): the kernels are instantiated for these.
DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def check_kernel_args(sourceT, indices, weights):
    """Validate the tensors handed to a window kernel; raises on what
    the kernels do not take."""
    for name, t in (("sourceT", sourceT), ("indices", indices), ("weights", weights)):
        if t.device.type != "cuda" or t.device != sourceT.device:
            raise ValueError(f"{name} must lie on the CUDA device of sourceT, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sourceT.dtype not in DTYPE_CODES:
        raise TypeError(f"window kernels take float32 or float64, got {sourceT.dtype}")
    if weights.dtype != sourceT.dtype:
        raise TypeError(f"weights dtype {weights.dtype} differs from source dtype {sourceT.dtype}")
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    if sourceT.dim() != 2 or indices.dim() != 2 or weights.shape != indices.shape:
        raise ValueError(
            f"expected sourceT (m, E) and indices, weights (n, w); got "
            f"{tuple(sourceT.shape)}, {tuple(indices.shape)}, {tuple(weights.shape)}"
        )


def launch_args(sourceT, indices, weights, out):
    """The pointer, size and stream arguments shared by both kernels."""
    stream = torch.cuda.current_stream(sourceT.device).cuda_stream
    return (
        ctypes.c_void_p(sourceT.data_ptr()),
        ctypes.c_void_p(indices.data_ptr()),
        ctypes.c_void_p(weights.data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_int64(indices.shape[0]),
        ctypes.c_int32(indices.shape[1]),
        ctypes.c_int32(sourceT.shape[1]),
        ctypes.c_void_p(stream),
    )


def window_reduce(sourceT: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor, reduction) -> torch.Tensor:
    """
    ``reduction`` over every target's window.

    sourceT: (m, E) source values, extra slices on the minor axis.
    indices: (n, w) int32, -1 padded.  weights: (n, w), 0 padded.
    Returns (n, E).
    """
    if reduction not in METHOD_CODES:
        raise ValueError(f"window_reduce does not cover {reduction!r}")
    if sourceT.device.type == "cpu":
        return reduce.reduce_windows(sourceT, indices, weights, reduction)
    check_kernel_args(sourceT, indices, weights)
    out = torch.empty((indices.shape[0], sourceT.shape[1]), dtype=sourceT.dtype, device=sourceT.device)
    if out.numel() == 0:
        return out
    from xugrid_tpu_torch.utils.build import kernel_library

    fn = kernel_library().xt_window_reduce
    fn.restype = ctypes.c_int
    err = fn(
        ctypes.c_int(DTYPE_CODES[sourceT.dtype]),
        ctypes.c_int(METHOD_CODES[reduction]),
        *launch_args(sourceT, indices, weights, out),
    )
    if err != 0:
        raise RuntimeError(f"window_reduce launch failed with CUDA error {err}")
    window_reduce.launches += 1
    return out


window_reduce.launches = 0
