"""
Regridding reductions as torch functions over padded windows.

Each reduction maps a window to one value per target:
``f(values (..., w), weights (..., w)) -> (...)``.  Padded slots carry
``value = NaN, weight = 0``.  The formulas are those of
``xugrid_tpu/regrid/reduce.py``, copied literally, so NaN, inf, zero
weights and negative values give the same answers.

``reduce_windows`` (a gather of each target's window plus one of these
reductions) is the plain PyTorch version of both apply kernels, and the
path of custom reductions on any device.
"""

from __future__ import annotations

import torch


def _valid(values):
    return ~torch.isnan(values)


def mean(values, weights):
    valid = _valid(values)
    w = torch.where(valid, weights, 0.0)
    vsum = torch.sum(w * torch.where(valid, values, 0.0), dim=-1)
    wsum = torch.sum(w, dim=-1)
    return torch.where(wsum > 0, vsum / torch.where(wsum == 0, 1.0, wsum), torch.nan)


def harmonic_mean(values, weights):
    use = _valid(values) & (values != 0.0) & (weights > 0.0)
    w = torch.where(use, weights, 0.0)
    w_sum = torch.sum(w, dim=-1)
    v_agg = torch.sum(torch.where(use, w / torch.where(use, values, 1.0), 0.0), dim=-1)
    ok = (v_agg != 0.0) & (w_sum != 0.0)
    return torch.where(ok, w_sum / torch.where(ok, v_agg, 1.0), torch.nan)


def geometric_mean(values, weights):
    normsum = torch.sum(weights, dim=-1, keepdim=True)
    w = weights / torch.where(normsum == 0.0, 1.0, normsum)
    use = _valid(values) & (values > 0.0) & (w > 0.0)
    v_agg = torch.sum(
        torch.where(use, w * torch.log(torch.abs(torch.where(use, values, 1.0))), 0.0),
        dim=-1,
    )
    w_sum = torch.sum(torch.where(use, w, 0.0), dim=-1)
    any_negative = torch.any(_valid(values) & (values < 0.0), dim=-1)
    ok = (w_sum != 0.0) & ~any_negative & (normsum[..., 0] != 0.0)
    return torch.where(ok, torch.exp(v_agg / torch.where(ok, w_sum, 1.0)), torch.nan)


def sum(values, weights):  # noqa: A001 - name parity with the reference
    valid = _valid(values)
    v_sum = torch.sum(torch.where(valid, values, 0.0), dim=-1)
    w_sum = torch.sum(torch.where(valid, weights, 0.0), dim=-1)
    return torch.where(w_sum != 0.0, v_sum, torch.nan)


def minimum(values, weights):
    valid = _valid(values)
    v_min = torch.amin(torch.where(valid, values, torch.inf), dim=-1)
    w_max = torch.amax(torch.where(valid, weights, 0.0), dim=-1)
    return torch.where(w_max > 0.0, v_min, torch.nan)


def maximum(values, weights):
    valid = _valid(values)
    v_max = torch.amax(torch.where(valid, values, -torch.inf), dim=-1)
    w_max = torch.amax(torch.where(valid, weights, 0.0), dim=-1)
    return torch.where(w_max > 0.0, v_max, torch.nan)


def mode(values, weights):
    """Area-weighted mode; ties resolve to the largest value."""
    valid = _valid(values)
    w = torch.where(valid, weights, 0.0)
    # Group totals, sum_j [v_k == v_j] * w_j, accumulated over j in
    # window order: exact ties between groups then resolve the same way
    # as in the kernel, and no (..., w, w) table is materialized.
    totals = torch.zeros(torch.broadcast_shapes(values.shape, w.shape), dtype=w.dtype, device=w.device)
    for j in range(values.shape[-1]):
        totals = totals + (values == values[..., j : j + 1]) * w[..., j : j + 1]
    totals = torch.where(valid, totals, -torch.inf)
    # Lexicographic (total, value) maximum: max total first, then the
    # largest value among the slots achieving it.
    safe_vals = torch.where(valid, values, -torch.inf)
    max_total = torch.amax(totals, dim=-1, keepdim=True)
    candidate_vals = torch.where(totals == max_total, safe_vals, -torch.inf)
    mode_value = torch.amax(candidate_vals, dim=-1)
    w_max = torch.amax(w, dim=-1)
    any_valid = torch.any(valid, dim=-1)
    return torch.where(any_valid & (w_max > 0.0), mode_value, torch.nan)


def max_overlap(values, weights):
    """Value of the source with the largest weight; ties -> larger value."""
    valid = _valid(values)
    w = torch.where(valid, weights, -torch.inf)
    w_max = torch.amax(w, dim=-1)
    is_best = w == w_max[..., None]
    v_best = torch.amax(torch.where(is_best & valid, values, -torch.inf), dim=-1)
    return torch.where(torch.any(valid, dim=-1) & (w_max > 0.0), v_best, torch.nan)


def first_order_conservative(values, weights):
    """Sum of v*w with relative weights (area fraction of the source)."""
    valid = _valid(values)
    w = torch.where(valid, weights, 0.0)
    v_agg = torch.sum(w * torch.where(valid, values, 0.0), dim=-1)
    w_sum = torch.sum(w, dim=-1)
    return torch.where(w_sum != 0.0, v_agg, torch.nan)


conductance = first_order_conservative


class Percentile:
    """
    Reduction computing the p-th percentile (NaN-skipping, linear
    interpolation between closest ranks: rank = 1 + (n - 1) p / 100).
    The rank is computed in the values' dtype.
    """

    def __init__(self, p: float):
        if not (0.0 <= p <= 100.0):
            raise ValueError(f"percentile must be in the range [0, 100], received: {p}")
        self.p = p
        self.__name__ = f"p{p}"

    def __call__(self, values, weights):
        p = self.p
        w_max = torch.amax(weights, dim=-1)
        valid = _valid(values)
        n = torch.sum(valid, dim=-1)
        # Sort with NaN pushed to the end (+inf).
        sorted_vals = torch.sort(torch.where(valid, values, torch.inf), dim=-1).values
        rank = 1.0 + (n.to(values.dtype) - 1.0) * (p / 100.0)
        f = torch.floor(rank)
        m = rank - f
        last = values.shape[-1] - 1
        lo_idx = torch.clamp(f.to(torch.int64) - 1, 0, last)
        hi_idx = torch.clamp(lo_idx + 1, 0, last)
        # Do not step past the last valid value.
        hi_idx = torch.minimum(hi_idx, torch.clamp(n - 1, min=0))
        lower = torch.gather(sorted_vals, -1, lo_idx[..., None])[..., 0]
        upper = torch.gather(sorted_vals, -1, hi_idx[..., None])[..., 0]
        result = lower * (1.0 - m) + upper * m
        if p == 0:
            result = minimum(values, weights)
        elif p == 100:
            result = maximum(values, weights)
        return torch.where((n > 0) & (w_max > 0.0), result, torch.nan)


def create_percentile_method(p: float) -> Percentile:
    """Reduction computing the p-th percentile of each window."""
    return Percentile(p)


median = create_percentile_method(50)


ABSOLUTE_OVERLAP_METHODS = {
    "mean": mean,
    "harmonic_mean": harmonic_mean,
    "geometric_mean": geometric_mean,
    "sum": sum,
    "minimum": minimum,
    "maximum": maximum,
    "mode": mode,
    "median": median,
    "max_overlap": max_overlap,
}
for _p in (5, 10, 25, 50, 75, 90, 95):
    ABSOLUTE_OVERLAP_METHODS[f"p{_p}"] = create_percentile_method(_p)

RELATIVE_OVERLAP_METHODS = {
    "conductance": conductance,
    "first_order_conservative": first_order_conservative,
}


def gather_windows(sourceT: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """
    Each target's window of source values: sourceT (m, E) with the extra
    slices on the minor axis, indices (n, w) padded with -1.  Returns
    (n, E, w), NaN in the pad slots.
    """
    pad = indices < 0
    vals = sourceT[indices.clamp(min=0).reshape(-1).long()]
    vals = vals.reshape(indices.shape + (sourceT.shape[1],))  # (n, w, E)
    vals = torch.where(pad[..., None], torch.nan, vals)
    return vals.transpose(-1, -2)


def reduce_windows(sourceT, indices, weights, reduction) -> torch.Tensor:
    """Plain apply: ``reduction`` over every target's window, (n, E)."""
    return reduction(gather_windows(sourceT, indices), weights[:, None, :])
