"""
The port's apply (xugrid_tpu_torch.regrid.apply) and its two kernel
modules, aligned_apply (window_reduce) and select_apply (window_select),
held on the CPU against the JAX package:

(a) ``xugrid_tpu.regrid.apply.apply_weights`` off-TPU, the XLA window
    path over reduce.py in float64: rtol 1e-12, as in
    tests/test_torch_reduce.py (only the summation order differs);
(b) the Pallas kernels in interpret mode on float32 sources,
    ``aligned_apply(..., interpret=True)`` at rtol 1e-5 / atol 1e-6
    (float32 sums in another order) and
    ``apply_windowed_select(..., interpret=True)`` at the tolerance the
    JAX package holds that kernel to, with identical NaN masks.

On CPU tensors the wrappers run their plain PyTorch version and launch
nothing.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_reduce import assert_matches
from xugrid_tpu.core.sparse import PaddedCSR as JaxPaddedCSR
from xugrid_tpu.regrid import reduce as jax_reduce
from xugrid_tpu.regrid.aligned_apply import aligned_apply, plan_gather_aligned
from xugrid_tpu.regrid.apply import _max_overlap_filter
from xugrid_tpu.regrid.apply import apply_weights as jax_apply_weights
from xugrid_tpu.regrid.select_apply import apply_windowed_select
from xugrid_tpu_torch.core.sparse import PaddedCSR
from xugrid_tpu_torch.regrid import reduce
from xugrid_tpu_torch.regrid.aligned_apply import window_reduce
from xugrid_tpu_torch.regrid.apply import apply_weights, device_weights
from xugrid_tpu_torch.regrid.select_apply import window_select

REDUCE_METHODS = [
    "mean", "sum", "first_order_conservative", "conductance", "harmonic_mean",
    "geometric_mean", "minimum", "maximum", "max_overlap",
]
#: names of the same methods in the Pallas gather kernels.
ALIGNED_NAMES = {
    "mean": "mean", "sum": "sum", "first_order_conservative": "first_order_conservative",
    "conductance": "conductance", "harmonic_mean": "harmonic_mean",
    "geometric_mean": "geometric_mean", "minimum": "min", "maximum": "max",
}
SELECT_METHODS = ["mode", "median", "p5", "p25", "p75", "p95", "p0", "p33.3", "p100"]


def _method(module, name):
    table = {**module.ABSOLUTE_OVERLAP_METHODS, **module.RELATIVE_OVERLAP_METHODS}
    if name in table:
        return table[name]
    return module.create_percentile_method(float(name[1:]))


def make_case(n=500, m=700, w=6, n_extra=5, seed=0, nan_frac=0.15, inf_frac=0.0,
              positive=False, few_values=False, dtype=np.float64):
    """Ragged (n, w) windows around a diagonal band, 2 % empty, weights
    in (0.1, 2), and a source (n_extra, m)."""
    rng = np.random.default_rng(seed)
    base = (np.arange(n) * m) // n
    indices = np.clip(base[:, None] + rng.integers(-15, 16, size=(n, w)), 0, m - 1)
    keep = rng.integers(1, w + 1, size=n)
    in_window = np.arange(w)[None, :] < keep[:, None]
    indices = np.where(in_window, indices, -1).astype(np.int32)
    indices[rng.random(n) < 0.02] = -1
    weights = rng.uniform(0.1, 2.0, size=(n, w))
    weights[indices < 0] = 0.0
    source = rng.normal(size=(n_extra, m))
    if positive:
        source = np.abs(source) + 0.1
    if few_values:
        source = np.round(source * 2.0) / 2.0
    u = rng.random(source.shape)
    source[u < nan_frac] = np.nan
    source[(u >= nan_frac) & (u < nan_frac + inf_frac)] = np.inf
    return indices, weights.astype(dtype), source.astype(dtype)


def windows(indices, weights, source2d):
    """The gathered (n, E, w) windows and (n, 1, w) weights."""
    values = source2d[:, np.maximum(indices, 0)]
    values = np.where(indices[None] < 0, np.nan, values)
    return np.moveaxis(values, 0, 1), weights[:, None, :]


def both_apply(indices, weights, source, name):
    n, w = indices.shape
    m = source.shape[-1]
    want = jax_apply_weights(
        JaxPaddedCSR(indices, weights, n, m, w), source, _method(jax_reduce, name), n
    )
    got = apply_weights(PaddedCSR(indices, weights, n, m, w), source, _method(reduce, name), n)
    return got, want


@pytest.mark.parametrize("method", REDUCE_METHODS)
def test_window_reduce_module_matches_jax_apply(method):
    indices, weights, source = make_case(seed=1, inf_frac=0.02)
    source = source.reshape(5, 1, -1)  # leading dims are kept
    before = window_reduce.launches
    got, want = both_apply(indices, weights, source, method)
    assert window_reduce.launches == before
    assert isinstance(got, torch.Tensor) and got.shape == (5, 1, indices.shape[0])
    got = got.numpy()
    assert got.dtype == want.dtype == np.float64
    values, w = windows(indices, weights, source.reshape(5, -1))
    assert_matches(got.reshape(5, -1).T, want.reshape(5, -1).T, method, values, w)


@pytest.mark.parametrize("w", [6, 40])
@pytest.mark.parametrize("method", SELECT_METHODS)
def test_window_select_module_matches_jax_apply(method, w):
    indices, weights, source = make_case(w=w, seed=2, inf_frac=0.02, few_values=True)
    before = window_select.launches
    got, want = both_apply(indices, weights, source, method)
    assert window_select.launches == before
    values, ww = windows(indices, weights, source)
    assert_matches(got.numpy().T, want.T, method, values, ww)


def test_custom_reduction_takes_plain_window_path():
    indices, weights, source = make_case(seed=3)
    n, w = indices.shape
    m = source.shape[-1]
    want = jax_apply_weights(
        JaxPaddedCSR(indices, weights, n, m, w), source,
        lambda v, ww: (v * ww).max(axis=-1), n,
    )
    got = apply_weights(
        PaddedCSR(indices, weights, n, m, w), source,
        lambda v, ww: torch.amax(v * ww, dim=-1), n,
    )
    np.testing.assert_array_equal(got.numpy(), want)


def _check_f32(got, want):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", sorted(ALIGNED_NAMES))
def test_window_reduce_plain_f32_matches_aligned_kernel(method):
    positive = method in ("harmonic_mean", "geometric_mean")
    indices, weights, source = make_case(
        n=300, m=400, seed=4, positive=positive, dtype=np.float32
    )
    plan = plan_gather_aligned(indices, weights)
    want = aligned_apply(source, plan, method=ALIGNED_NAMES[method], interpret=True)
    got = window_reduce(
        torch.from_numpy(source.T.copy()), torch.from_numpy(indices),
        torch.from_numpy(weights), _method(reduce, method),
    )
    assert got.dtype == torch.float32
    _check_f32(got.numpy(), want)


def test_max_overlap_plain_f32_matches_aligned_kernel():
    """The TPU path runs max_overlap as max over a host-filtered window,
    on NaN-free sources only."""
    indices, weights, source = make_case(n=300, m=400, seed=5, nan_frac=0.0, dtype=np.float32)
    fidx, fw = _max_overlap_filter(indices, weights)
    want = aligned_apply(source, plan_gather_aligned(fidx, fw), method="max", interpret=True)
    got = window_reduce(
        torch.from_numpy(source.T.copy()), torch.from_numpy(indices),
        torch.from_numpy(weights), reduce.max_overlap,
    )
    _check_f32(got.numpy(), want)


@pytest.mark.parametrize("method", ["mode", "median", "p90"])
def test_window_select_plain_f32_matches_select_kernel(method):
    """The Pallas selection kernel's value extraction rounds: on these
    windows it is up to 1.4e-5 off the exact median of a one-value
    window.  So it is held at the tolerance of the JAX package's own
    test of that kernel (tests/test_select_apply.py), and the port's
    float32 path is also held to the float64 result of oracle (a)."""
    indices, weights, source = make_case(
        n=300, m=400, seed=6, few_values=method == "mode", dtype=np.float32
    )
    want = apply_windowed_select(source, indices, weights, method, interpret=True)
    got = window_select(
        torch.from_numpy(source.T.copy()), torch.from_numpy(indices),
        torch.from_numpy(weights), _method(reduce, method),
    ).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)
    exact = jax_apply_weights(
        JaxPaddedCSR(indices, weights.astype(np.float64), indices.shape[0], 400, indices.shape[1]),
        source.astype(np.float64), _method(jax_reduce, method), indices.shape[0],
    ).T
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exact))
    np.testing.assert_allclose(got, exact, rtol=1e-6, atol=1e-6)


def test_device_weights_upload_once_per_dtype():
    indices, weights, source = make_case(seed=7)
    padded = PaddedCSR(indices, weights, indices.shape[0], source.shape[-1], indices.shape[1])
    cache = {}
    apply_weights(padded, source, reduce.mean, padded.n, cache=cache)
    idx, w = cache[(torch.float64, torch.device("cpu"))]
    apply_weights(padded, source, reduce.mean, padded.n, cache=cache)
    assert len(cache) == 1 and cache[(torch.float64, torch.device("cpu"))][0] is idx
    apply_weights(padded, source.astype(np.float32), reduce.mean, padded.n, cache=cache)
    assert len(cache) == 2
    idx32, w32 = device_weights(padded, torch.float32, torch.device("cpu"), cache)
    assert idx32.dtype == torch.int32 and w32.dtype == torch.float32


def test_integer_source_applies_as_float64():
    indices, weights, source = make_case(seed=8, nan_frac=0.0)
    ints = np.round(source * 10).astype(np.int64)
    got, want = both_apply(indices, weights, ints, "mean")
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_wrappers_reject_methods_they_do_not_cover():
    sourceT = torch.zeros((4, 2))
    indices = torch.zeros((3, 2), dtype=torch.int32)
    weights = torch.ones((3, 2))
    with pytest.raises(ValueError, match="does not cover"):
        window_reduce(sourceT, indices, weights, reduce.mode)
    with pytest.raises(ValueError, match="does not cover"):
        window_select(sourceT, indices, weights, reduce.mean)
