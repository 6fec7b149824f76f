"""
Hopper kernel #1, ``window_reduce`` (``csrc/window_reduce.cu``): the
windowed reductions of the regrid apply, one pass over ``PaddedCSR``;
and its matvec mode, ``csr_matvec`` (same source), the SpMV of the
Laplace PCG over a CSR matrix.

It replaces ``xugrid_tpu/regrid/aligned_apply.py:gather_aligned_apply``
(and, by function, the stream, span, packet and pdot engines of
``xugrid_tpu/regrid/gather_apply.py``) for mean, sum,
first_order_conservative (which conductance is), harmonic_mean,
geometric_mean, minimum, maximum and max_overlap.  Like that kernel it
takes the source slices-major, (E, m), as ``apply_weights`` holds it.

``csr_matvec`` replaces ``gather_aligned_apply(method="matvec")`` and,
by function, the stream, span, packet and pdot engines in that mode,
the SpMV engines of ``xugrid_tpu/ugrid/interpolate.py:cg_solve``.

Each wrapper launches its kernel for CUDA tensors and raises on what it
does not take; for CPU tensors it runs the plain PyTorch version
(``reduce.reduce_windows``, ``csr_matvec_plain``).  Both window kernels
and ``apply_weights``' custom reductions share ``_window_apply``; every
launch is one ``_launch``, which counts it on the wrapper's
``launches``.  ``reduce_lanes`` picks the block shape of both window
kernels; ``window_reduce`` takes row tiles (``row_tiles``) instead for
windows of at most ``ROW_TILE_SLOTS`` slots (``reduce_block``) and
counts each such launch as ``apply.row_tile_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from xugrid_tpu_torch.regrid import reduce
from xugrid_tpu_torch.utils.profiling import count

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

#: Shared memory a window-kernel block may stage its windows in
#: (``kStageBytes`` in csrc/window_common.cuh): the default limit, so no
#: launch has to opt in to more.
STAGE_BYTES = 48 * 1024

#: Largest index a kernel takes: they index in 32 bits.
MAX_INT32 = 2**31 - 1 - 256

#: Widest window ``window_reduce`` reads in row tiles, held in registers
#: (``kRowSlots`` in csrc/window_reduce.cu).
ROW_TILE_SLOTS = 4

#: Most slices a row-tile block walks (``row_tiles``).
ROW_TILE_SLICES = 64


#: ctypes signatures of the kernel library's entry points
#: (csrc/*.cu): pointers and the stream as c_void_p.
_SIGNATURES = {
    "xt_window_reduce": (ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 4, *[ctypes.c_int32] * 7, ctypes.c_void_p),
    "xt_window_reduce_rows": (ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 4, *[ctypes.c_int32] * 5, ctypes.c_void_p),
    "xt_csr_matvec": (ctypes.c_int, *[ctypes.c_void_p] * 5, *[ctypes.c_int32] * 2, ctypes.c_void_p),
    "xt_window_select": (
        ctypes.c_int, ctypes.c_int, ctypes.c_double, *[ctypes.c_void_p] * 4, *[ctypes.c_int32] * 8,
        ctypes.c_void_p,
    ),
}


def kernel_function(name: str):
    """The kernel library's entry point ``name``, with its ctypes
    signature (the library is built on first use)."""
    from xugrid_tpu_torch.utils.build import kernel_library

    fn = getattr(kernel_library(), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _launch(wrapper, name: str, device: torch.device, *args) -> None:
    """Launch the kernel library's entry point ``name`` on ``args`` and
    the current stream of ``device``; raises on a CUDA error, else counts
    the launch on ``wrapper.launches``."""
    err = kernel_function(name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed with CUDA error {err}")
    wrapper.launches += 1


def _check_tensors(takes: str, anchor: str, values: str, **tensors) -> None:
    """Raise unless each of ``tensors`` lies contiguous on the CUDA device
    of ``tensors[anchor]``, whose kernel dtype ``tensors[values]`` shares
    (the dtype's message opens with ``takes``)."""
    a, v = tensors[anchor], tensors[values]
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"{name} must lie on the CUDA device of {anchor}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dtype not in DTYPE_CODES:
        raise TypeError(f"{takes} float32 or float64, got {a.dtype}")
    if v.dtype != a.dtype:
        raise TypeError(f"{values} dtype {v.dtype} differs from {anchor} dtype {a.dtype}")


def check_kernel_args(source, indices, weights):
    """Validate the tensors handed to a window kernel; raises on what
    the kernels do not take."""
    _check_tensors("window kernels take", "source", "weights", source=source, indices=indices, weights=weights)
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    if source.dim() != 2 or indices.dim() != 2 or weights.shape != indices.shape:
        raise ValueError(
            f"expected a 2-D source and indices, weights (n, w); got "
            f"{tuple(source.shape)}, {tuple(indices.shape)}, {tuple(weights.shape)}"
        )
    if max(source.shape) > MAX_INT32 or indices.shape[0] > MAX_INT32:
        raise ValueError(f"window kernels index in 32 bits: source {tuple(source.shape)}, n {indices.shape[0]}")


def check_out(out, source, n: int) -> None:
    """Validate the ``out`` handed to a window kernel: a contiguous (E,
    n) tensor of the source's dtype on the source's device; raises on
    anything else."""
    if not isinstance(out, torch.Tensor):
        raise TypeError(f"out must be a tensor, got {type(out).__name__}")
    if out.dtype != source.dtype:
        raise TypeError(f"out dtype {out.dtype} differs from source dtype {source.dtype}")
    if out.device != source.device:
        raise ValueError(f"out must lie on the device of source, {source.device}, got {out.device}")
    if tuple(out.shape) != (source.shape[0], n):
        raise ValueError(f"out must have shape {(source.shape[0], n)}, got {tuple(out.shape)}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")


def stage_bytes(target_warps: int, w: int, itemsize: int) -> int:
    """Shared memory of a window-kernel tile of 32 * target_warps
    targets: (tile + 1) rows of w slots of a weight and an int32 index."""
    return (32 * target_warps + 1) * w * (itemsize + 4)


def reduce_lanes(E: int, w: int, itemsize: int, batch: int = 4) -> tuple[int, int, bool]:
    """
    The block of a window kernel for E slices and windows of w slots of
    ``itemsize``-byte values: (slice warps S, target warps G, staged).

    The block's S * G <= 8 warps share a tile of 32 * G targets; warp
    (g, s) walks slices s, s + S, ..., ``batch`` of them per pass over
    the window (window_reduce 4, window_select 1).  S is the least power
    of two, at most 8, that leaves a warp at most 8 passes over its
    windows (8 * batch slices): one warp walks a short stack alone, and
    a deep stack spreads over more, smaller tiles.  The windows are
    staged in shared memory when a warp walks them more than once (E >
    batch * S) and the tile fits ``STAGE_BYTES`` (G halving until it
    does); otherwise they are read in place with G = 8 // S.
    """
    S = 1
    while S < 8 and S * 8 * batch < E:
        S *= 2
    G = 8 // S
    while G > 1 and stage_bytes(G, w, itemsize) > STAGE_BYTES:
        G //= 2
    if E <= batch * S or stage_bytes(G, w, itemsize) > STAGE_BYTES:
        return S, 8 // S, False
    return S, G, True


def row_tiles(E: int, n: int, itemsize: int) -> tuple[int, int, int]:
    """
    The row tiles of a ``window_reduce`` launch over E slices and n
    windows of at most ROW_TILE_SLOTS slots of ``itemsize``-byte values:
    (V targets a thread, tiles of 256 V targets, slices per group).

    V = 16 // itemsize, so that a thread stores a slice's V results in
    16 bytes.  Each block reads its tile's windows once and walks one
    group of slices, the E slices cut evenly into groups of at most
    ROW_TILE_SLICES (more only past 65,535 groups, the grid's limit).
    A group of 64 float32 slices writes 256 bytes a
    target against the 8 bytes of a one-slot window read again for it
    (3 %), and leaves a deep stack thousands of blocks; a group of all
    261 slices of a forcing slab ran 7 % slower on an H100 (its ~3
    waves of blocks), groups of 33-87 slices within 1.5 % of each other
    at w = 1, 2 and 4, and a stack of 20 fastest as one group
    (PERF.md).
    """
    V = 16 // itemsize
    groups = min(-(-E // ROW_TILE_SLICES), 65535)
    return V, -(-n // (256 * V)), -(-E // groups)


def reduce_block(E: int, n: int, w: int, itemsize: int) -> tuple[str, tuple[int, ...]]:
    """``window_reduce``'s entry point and block for E slices and n
    windows of w slots of ``itemsize``-byte values: row tiles of
    ``row_tiles``' slices per group where w <= ROW_TILE_SLOTS, else
    ``reduce_lanes``' block (slice warps, target warps, staged)."""
    if w <= ROW_TILE_SLOTS:
        return "xt_window_reduce_rows", (row_tiles(E, n, itemsize)[2],)
    slice_warps, target_warps, staged = reduce_lanes(E, w, itemsize)
    return "xt_window_reduce", (slice_warps, target_warps, int(staged))


def plain_into(out, source, indices, weights, reduction) -> torch.Tensor:
    """The plain version of a window kernel: (E, n), written into ``out``
    where one is given (checked by the caller); the bytes copied there
    count as ``apply.copy_bytes``."""
    result = reduce.reduce_windows(source.t(), indices, weights, reduction).t()
    if out is None:
        return result
    count("apply.copy_bytes", result.numel() * result.element_size())
    return out.copy_(result)


def _window_apply(source, indices, weights, reduction, *, out=None, launch=None) -> torch.Tensor:
    """The body of both window kernels and of a custom reduction (``launch``
    None): (E, n), into ``out`` where one is given.  The plain version
    runs for a CPU source or no ``launch``; else ``launch`` gets the
    windows' pointers and sizes (n, m, w, E) and picks its block."""
    if out is not None:
        check_out(out, source, indices.shape[0])
    if launch is None or source.device.type == "cpu":
        return plain_into(out, source, indices, weights, reduction)
    check_kernel_args(source, indices, weights)
    (E, m), (n, w) = source.shape, indices.shape
    if out is None:
        out = torch.empty((E, n), dtype=source.dtype, device=source.device)
    if out.numel():
        launch(source.data_ptr(), indices.data_ptr(), weights.data_ptr(), out.data_ptr(), n, m, w, E)
    return out


def window_reduce(
    source: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor, reduction, *, out: torch.Tensor | None = None
) -> torch.Tensor:
    """
    ``reduction`` over every target's window.

    source: (E, m) source values, slices major.
    indices: (n, w) int32, -1 padded.  weights: (n, w), 0 padded.
    out: None, or the contiguous (E, n) tensor of the source's dtype and
    device to write the result into (each slab of a stack writes its
    rows of one output in place); the kernel writes it directly, the
    plain version copies its result there.
    Returns (E, n) (contiguous on the card): ``out`` where one is given.
    """
    if reduction not in METHOD_CODES:
        raise ValueError(f"window_reduce does not cover {reduction!r}")

    def launch(*window):
        (E, _), (n, w) = source.shape, indices.shape
        name, block = reduce_block(E, n, w, source.element_size())
        _launch(window_reduce, name, source.device, DTYPE_CODES[source.dtype], METHOD_CODES[reduction], *window, *block)
        count("apply.row_tile_launches", int(name == "xt_window_reduce_rows"))

    return _window_apply(source, indices, weights, reduction, out=out, launch=launch)


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
    Returns (n, E), the same bits from the kernel and from the plain
    version.  Inputs are not checked for NaN or inf.
    """
    if x.device.type == "cpu":
        return csr_matvec_plain(indptr, indices, data, x)
    _check_tensors("csr_matvec takes", "x", "data", indptr=indptr, indices=indices, data=data, x=x)
    if indptr.dtype != torch.int32 or indices.dtype != torch.int32:
        raise TypeError(f"indptr and indices must be int32, got {indptr.dtype}, {indices.dtype}")
    if x.dim() != 2 or indptr.dim() != 1 or indices.shape != data.shape or indices.dim() != 1:
        raise ValueError(
            f"expected indptr (n + 1,), indices and data (nnz,), x (m, E); got "
            f"{tuple(indptr.shape)}, {tuple(indices.shape)}, {tuple(data.shape)}, {tuple(x.shape)}"
        )
    n = indptr.numel() - 1
    if n * x.shape[1] > MAX_INT32 or x.shape[0] > MAX_INT32:
        raise ValueError(f"csr_matvec indexes in 32 bits: n {n}, x {tuple(x.shape)}")
    y = torch.empty((n, x.shape[1]), dtype=x.dtype, device=x.device)
    if y.numel():
        pointers = indptr.data_ptr(), indices.data_ptr(), data.data_ptr(), x.data_ptr(), y.data_ptr()
        _launch(csr_matvec, "xt_csr_matvec", x.device, DTYPE_CODES[x.dtype], *pointers, n, x.shape[1])
    return y


csr_matvec.launches = 0
