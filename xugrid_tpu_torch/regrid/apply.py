"""
The regrid apply: weights x source values -> target values.

The source is flattened to (E, m), the extra (time/layer) slices
major, as the caller holds it.  Both kernels take it so, the eight
``window_reduce`` methods and ``window_select``'s mode and percentiles,
in one kernel launch with no copy of a contiguous source; only custom
reductions take a slice-minor copy, (m, E), so that the plain window
path gathers from no strided view.  Built-in reductions go to the
Hopper kernels for a CUDA source, or to their plain PyTorch version for
a CPU source; a custom reduction runs the plain window path on either
device.  The result is contiguous.  A caller that streams a stack in
slabs hands each slab ``out=``, its rows of one output allocated once,
and each slab is written in place: the kernels write those rows
directly, the plain versions copy their result there, and no slab
results are joined afterwards.  Each apply is a span
``apply_weights`` around a span ``apply.kernel`` (the dispatch and the
launch); the bytes of each cast, reshape or ``.contiguous()`` that
copies, and of a plain result copied into ``out``, count as
``apply.copy_bytes`` (``utils.profiling``).

``apply_coo_gather`` is the apply of ``CentroidLocatorRegridder``: a
row gather by torch indexing on the source's device, no kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from xugrid_tpu_torch.core.sparse import PaddedCSR
from xugrid_tpu_torch.regrid.aligned_apply import DTYPE_CODES, METHOD_CODES, _window_apply, window_reduce
from xugrid_tpu_torch.regrid.select_apply import covers, window_select
from xugrid_tpu_torch.utils.profiling import count, span, timings
from xugrid_tpu_torch.xdata.variable import torch_dtype


def _counted(before: torch.Tensor, after: torch.Tensor) -> torch.Tensor:
    """``after``, made from ``before`` by a cast, a reshape or
    ``.contiguous()``; while spans are recorded, its bytes count as
    ``apply.copy_bytes`` where it is a copy: neither ``before`` itself
    (these return their input where nothing changes) nor a view."""
    if after is not before and timings.recording and after._base is None:
        count("apply.copy_bytes", after.numel() * after.element_size())
    return after


def result_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype ``apply_weights`` computes and returns for a source of
    ``dtype``: a float dtype as it is, any other float64."""
    return dtype if dtype.is_floating_point else torch.float64


def device_weights(weights: PaddedCSR, dtype: torch.dtype, device: torch.device, cache: dict | None = None):
    """(indices int32, weights of ``dtype``) on ``device``.  ``cache``
    (owned by the caller, e.g. the regridder) keeps one upload per
    (dtype, device) for repeated and chunked applies."""
    key = (dtype, device)
    if cache is not None and key in cache:
        return cache[key]
    pair = (
        torch.from_numpy(weights.indices).to(device),
        torch.from_numpy(weights.weights).to(device=device, dtype=dtype),
    )
    if cache is not None:
        cache[key] = pair
    return pair


def apply_weights(
    weights: PaddedCSR,
    source,
    reduction,
    target_size: int,
    dtype=None,
    plan_cache: dict | None = None,
    *,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """
    Apply regridding weights over the flattened source.

    source: (..., m) tensor or array; the leading dims are the extra
    slices.  ``dtype`` (numpy or torch) casts the source on its device
    first: float32 or float64, the two the kernels serve (any other
    raises TypeError).  An integer source is taken as float64
    (``result_dtype``).  ``plan_cache`` (owned by the caller, e.g. the
    regridder) keeps one upload of the weights per (dtype, device).
    ``out``: None, or a contiguous (E, n_target) tensor, E the product
    of the leading dims, of that dtype on the source's device, into
    which the result is written in place (a slab's rows of one output;
    the window kernels check it).  Returns (..., n_target) on the
    source's device, contiguous: a view of ``out`` where one is given.
    """
    with span("apply_weights"):
        source = torch.as_tensor(source)
        leading = tuple(source.shape[:-1])
        source2d = _counted(source, source.reshape(-1, source.shape[-1]))
        if dtype is not None:
            dtype = torch_dtype(dtype)
            if dtype not in DTYPE_CODES:
                raise TypeError(f"the regrid kernels take float32 or float64, got dtype={dtype}")
            source2d = _counted(source2d, source2d.to(dtype))
        computed = result_dtype(source2d.dtype)
        if computed != source2d.dtype:
            source2d = _counted(source2d, source2d.to(computed))
        indices, w = device_weights(weights, source2d.dtype, source2d.device, plan_cache)
        with span("apply.kernel"):
            if reduction in METHOD_CODES:
                kernel, held = window_reduce, _counted(source2d, source2d.contiguous())
            elif covers(reduction):
                kernel, held = window_select, _counted(source2d, source2d.contiguous())
            else:
                kernel, held = _window_apply, _counted(source2d, source2d.t().contiguous()).t()
            result = kernel(held, indices, w, reduction, out=out)
        return _counted(result, result.reshape(leading + (target_size,)).contiguous())


def apply_coo_gather(row, col, source, target_size: int, cache: dict | None = None) -> torch.Tensor:
    """
    ``out[..., row] = source[..., col]`` over the flattened source, NaN
    in the targets that no row names; integer input is cast to float64.

    row, col: host int arrays of the gather (target and source index).
    ``cache`` (owned by the caller) keeps one upload of them per device.
    Returns (..., target_size) on the source's device, contiguous.
    """
    source = torch.as_tensor(source)
    leading = tuple(source.shape[:-1])
    source2d = _counted(source, source.reshape(-1, source.shape[-1]))
    if not source2d.is_floating_point():
        source2d = _counted(source2d, source2d.to(torch.float64))
    device = source2d.device
    if cache is not None and device in cache:
        rows, cols = cache[device]
    else:
        rows, cols = (torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device) for a in (row, col))
        if cache is not None:
            cache[device] = (rows, cols)
    out = torch.full((source2d.shape[0], target_size), torch.nan, dtype=source2d.dtype, device=device)
    out[:, rows] = source2d[:, cols]
    return out.reshape(leading + (target_size,))
