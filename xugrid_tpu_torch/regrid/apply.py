"""
The regrid apply: weights x source values -> target values.

The source is staged slice-minor, (m, E) with the extra (time/layer)
slices on the minor axis, so one source row holds all slices and a
warp's gathers of that row are contiguous.  Built-in reductions then go
to the Hopper kernels (``window_reduce`` or ``window_select``) for a
CUDA source, or to their plain PyTorch version for a CPU source.  A
custom reduction runs the plain window path on either device.
"""

from __future__ import annotations

import torch

from xugrid_tpu_torch.core.sparse import PaddedCSR
from xugrid_tpu_torch.regrid import reduce
from xugrid_tpu_torch.regrid.aligned_apply import METHOD_CODES, window_reduce
from xugrid_tpu_torch.regrid.select_apply import covers, window_select


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
    cache: dict | None = None,
) -> torch.Tensor:
    """
    Apply regridding weights over the flattened source.

    source: (..., m) tensor or array; the leading dims are the extra
    slices.  Returns (..., n_target) on the source's device.
    """
    source = torch.as_tensor(source)
    leading = tuple(source.shape[:-1])
    source2d = source.reshape(-1, source.shape[-1])
    if not source2d.is_floating_point():
        source2d = source2d.to(torch.float64)
    indices, w = device_weights(weights, source2d.dtype, source2d.device, cache)
    sourceT = source2d.t().contiguous()
    if reduction in METHOD_CODES:
        out = window_reduce(sourceT, indices, w, reduction)
    elif covers(reduction):
        out = window_select(sourceT, indices, w, reduction)
    else:
        out = reduce.reduce_windows(sourceT, indices, w, reduction)
    return out.t().reshape(leading + (target_size,))

