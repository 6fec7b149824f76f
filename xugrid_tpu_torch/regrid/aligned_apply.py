"""
Hopper kernel #1, ``window_reduce`` (``csrc/window_reduce.cu``): the
windowed reductions of the regrid apply, one pass over ``PaddedCSR``;
and its matvec mode, ``csr_matvec`` (same source), the SpMV of the
Laplace PCG over a CSR matrix.

It replaces ``xugrid_tpu/regrid/aligned_apply.py:gather_aligned_apply``
(and, by function, the stream, span, packet and pdot engines of
``xugrid_tpu/regrid/gather_apply.py``) for mean, sum,
first_order_conservative (which conductance is), harmonic_mean,
geometric_mean, minimum, maximum and max_overlap.

``csr_matvec`` replaces ``gather_aligned_apply(method="matvec")`` and,
by function, the stream, span, packet and pdot engines in that mode,
the SpMV engines of ``xugrid_tpu/ugrid/interpolate.py:cg_solve``.

Each wrapper launches its kernel for CUDA tensors and raises on what it
does not take; for CPU tensors it runs the plain PyTorch version
(``reduce.reduce_windows``, ``csr_matvec_plain``).  ``window_reduce.
launches`` and ``csr_matvec.launches`` count kernel launches.
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


def csr_matvec_plain(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``csr_matvec``: the same rows summed in the same
    (CSR) order, one entry slot of every row per step, so it rounds as
    the kernel does."""
    n = indptr.numel() - 1
    starts = indptr[:-1].long()
    lengths = (indptr[1:] - indptr[:-1]).long()
    y = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    for k in range(int(lengths.max()) if n else 0):
        rows = torch.nonzero(lengths > k).squeeze(1)
        pos = starts[rows] + k
        y[rows] += data[pos, None] * x[indices[pos].long()]
    return y


def csr_matvec(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """
    y = A @ x for the CSR matrix A = (indptr, indices, data).

    indptr: (n + 1,) int32.  indices: (nnz,) int32.  data: (nnz,).
    x: (m, E) with the right-hand sides on the minor axis.
    Returns (n, E).  Inputs are not checked for NaN or inf.
    """
    if x.device.type == "cpu":
        return csr_matvec_plain(indptr, indices, data, x)
    for name, t in (("indptr", indptr), ("indices", indices), ("data", data), ("x", x)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must lie on the CUDA device of x, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"csr_matvec takes float32 or float64, got {x.dtype}")
    if data.dtype != x.dtype:
        raise TypeError(f"data dtype {data.dtype} differs from x dtype {x.dtype}")
    if indptr.dtype != torch.int32 or indices.dtype != torch.int32:
        raise TypeError(f"indptr and indices must be int32, got {indptr.dtype}, {indices.dtype}")
    if x.dim() != 2 or indptr.dim() != 1 or indices.shape != data.shape or indices.dim() != 1:
        raise ValueError(
            f"expected indptr (n + 1,), indices and data (nnz,), x (m, E); got "
            f"{tuple(indptr.shape)}, {tuple(indices.shape)}, {tuple(data.shape)}, {tuple(x.shape)}"
        )
    y = torch.empty((indptr.numel() - 1, x.shape[1]), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    from xugrid_tpu_torch.utils.build import kernel_library

    fn = kernel_library().xt_csr_matvec
    fn.restype = ctypes.c_int
    err = fn(
        ctypes.c_int(DTYPE_CODES[x.dtype]),
        ctypes.c_void_p(indptr.data_ptr()),
        ctypes.c_void_p(indices.data_ptr()),
        ctypes.c_void_p(data.data_ptr()),
        ctypes.c_void_p(x.data_ptr()),
        ctypes.c_void_p(y.data_ptr()),
        ctypes.c_int64(y.shape[0]),
        ctypes.c_int32(x.shape[1]),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"csr_matvec launch failed with CUDA error {err}")
    csr_matvec.launches += 1
    return y


csr_matvec.launches = 0
