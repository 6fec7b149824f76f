"""
Hopper kernel #2, ``window_select`` (``csrc/window_select.cu``): the
order statistics of the regrid apply, one pass over ``PaddedCSR``.

It replaces ``xugrid_tpu/regrid/select_apply.py:gather_select_apply``
for mode, median and any percentile (``reduce.Percentile``).  Like that
kernel, and like ``window_reduce``, it takes the source slices-major,
(E, m), as ``apply_weights`` holds it, in window_reduce's tile layout
(``aligned_apply.reduce_lanes`` with one slice per window read).  Each
thread ranks its window in ``register_slots(w)`` registers; longer
windows take a counting walk in the same launch, so windows of any
width are taken and the reference's 32-slot split plan has no
counterpart.

``window_select`` launches the kernel for CUDA tensors and raises on
what it does not take; for CPU tensors it runs the plain PyTorch
version, ``reduce.reduce_windows`` (through window_reduce's body).
``window_select.launches`` counts kernel launches.  Each call is a span
``apply.select`` (the checks, the block and register choice and the
launch; on the CPU the plain version), nested in ``apply_weights``'
``apply.kernel``; it counts ``select.windows``, the E x n (slice,
target) windows it ranks, and, per launch, ``select.walk_launches``: 1
where the padded width w exceeds ``register_slots(w)``, so that the
windows longer than the register array take the counting walk, else 0;
and ``select.network_launches``: 1 where a percentile's windows of up to
K slots are sorted by the kernel's network, 0 for the mode, which counts
group totals, and at p = 0 or 100, which take the extreme value; and
``select.median_launches``: 1 where p = 50, whose kernel selects the two
middle ranks by the fixed-slot network, else 0 (``utils.profiling``).
"""

from __future__ import annotations

import torch

from xugrid_tpu_torch.regrid import reduce
from xugrid_tpu_torch.regrid.aligned_apply import DTYPE_CODES, _launch, _window_apply, reduce_lanes
from xugrid_tpu_torch.utils.profiling import count, span


def covers(reduction) -> bool:
    """True when the selection kernel implements ``reduction``."""
    return reduction is reduce.mode or isinstance(reduction, reduce.Percentile)


def register_slots(w: int) -> int:
    """The kernel's register array K for windows of w slots: the least
    of 8, 16 and 32 that holds w, else 32 (longer windows walk)."""
    for K in (8, 16):
        if w <= K:
            return K
    return 32


def window_select(
    source: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor, reduction, *, out: torch.Tensor | None = None
) -> torch.Tensor:
    """
    Mode or percentile over every target's window.

    source: (E, m) source values, slices major.
    indices: (n, w) int32, -1 padded.  weights: (n, w), 0 padded.
    out: None, or the contiguous (E, n) tensor of the source's dtype and
    device to write the result into, as ``window_reduce`` takes it.
    Returns (E, n) (contiguous on the card): ``out`` where one is given.
    """
    if not covers(reduction):
        raise ValueError(f"window_select does not cover {reduction!r}")
    with span("apply.select"):
        count("select.windows", source.shape[0] * indices.shape[0])
        w, is_mode = indices.shape[1], reduction is reduce.mode
        slots, p = register_slots(w), 0.0 if is_mode else float(reduction.p)

        def launch(*window):
            code = DTYPE_CODES[source.dtype]
            slice_warps, target_warps, staged = reduce_lanes(source.shape[0], w, source.element_size(), batch=1)
            block = slice_warps, target_warps, int(staged), slots
            _launch(window_select, "xt_window_select", source.device, code, int(is_mode), p, *window, *block)
            count("select.walk_launches", int(w > slots))
            count("select.network_launches", int(0.0 < p < 100.0))  # the mode has p = 0
            count("select.median_launches", int(p == 50.0))

        return _window_apply(source, indices, weights, reduction, out=out, launch=launch)


window_select.launches = 0
