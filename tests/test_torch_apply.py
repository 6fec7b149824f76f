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
from xugrid_tpu_torch.regrid import apply as apply_module
from xugrid_tpu_torch.regrid.aligned_apply import (
    STAGE_BYTES, reduce_block, reduce_lanes, row_tiles, stage_bytes, window_reduce,
)
from xugrid_tpu_torch.regrid.apply import apply_weights, device_weights
from xugrid_tpu_torch.regrid.select_apply import register_slots, window_select

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
        torch.from_numpy(source), torch.from_numpy(indices),
        torch.from_numpy(weights), _method(reduce, method),
    )
    assert got.dtype == torch.float32 and got.shape == source.shape[:1] + indices.shape[:1]
    _check_f32(got.numpy().T, want)


def test_max_overlap_plain_f32_matches_aligned_kernel():
    """The TPU path runs max_overlap as max over a host-filtered window,
    on NaN-free sources only."""
    indices, weights, source = make_case(n=300, m=400, seed=5, nan_frac=0.0, dtype=np.float32)
    fidx, fw = _max_overlap_filter(indices, weights)
    want = aligned_apply(source, plan_gather_aligned(fidx, fw), method="max", interpret=True)
    got = window_reduce(
        torch.from_numpy(source), torch.from_numpy(indices),
        torch.from_numpy(weights), reduce.max_overlap,
    )
    _check_f32(got.numpy().T, want)


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
        torch.from_numpy(source), torch.from_numpy(indices),
        torch.from_numpy(weights), _method(reduce, method),
    )
    assert got.dtype == torch.float32 and got.shape == source.shape[:1] + indices.shape[:1]
    got = got.numpy().T
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
    apply_weights(padded, source, reduce.mean, padded.n, plan_cache=cache)
    idx, w = cache[(torch.float64, torch.device("cpu"))]
    apply_weights(padded, source, reduce.mean, padded.n, plan_cache=cache)
    assert len(cache) == 1 and cache[(torch.float64, torch.device("cpu"))][0] is idx
    apply_weights(padded, source.astype(np.float32), reduce.mean, padded.n, plan_cache=cache)
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
    source = torch.zeros((2, 4))
    indices = torch.zeros((3, 2), dtype=torch.int32)
    weights = torch.ones((3, 2))
    with pytest.raises(ValueError, match="does not cover"):
        window_reduce(source, indices, weights, reduce.mode)
    with pytest.raises(ValueError, match="does not cover"):
        window_select(source, indices, weights, reduce.mean)


def _apply_case(source, method, seed):
    """apply_weights of the port and of oracle (a) on one source; the
    port launches nothing on the CPU, keeps the leading dims and returns
    a contiguous result.  For the selection methods window_select is
    also called alone on the flattened (E, m) source."""
    indices, weights, _ = make_case(seed=seed)
    n, w = indices.shape
    m = source.shape[-1]
    want = jax_apply_weights(
        JaxPaddedCSR(indices, weights, n, m, w), np.ascontiguousarray(source), _method(jax_reduce, method), n
    )
    before = window_reduce.launches, window_select.launches
    got = apply_weights(PaddedCSR(indices, weights, n, m, w), source, _method(reduce, method), n)
    assert (window_reduce.launches, window_select.launches) == before
    assert tuple(got.shape) == source.shape[:-1] + (n,) == want.shape
    assert got.is_contiguous()
    values, ww = windows(indices, weights, np.ascontiguousarray(source).reshape(-1, m))
    flat = got.numpy().reshape(-1, n).T
    assert_matches(flat, want.reshape(-1, n).T, method, values, ww)
    if method in SELECT_METHODS:
        source2d = torch.as_tensor(source).reshape(-1, m)
        alone = window_select(source2d, torch.from_numpy(indices), torch.from_numpy(weights), _method(reduce, method))
        assert alone.shape == (source2d.shape[0], n)
        assert_matches(alone.numpy().T, want.reshape(-1, n).T, method, values, ww)


@pytest.mark.parametrize("method", REDUCE_METHODS)
def test_apply_weights_one_slice_matches_jax_apply(method):
    """E = 1, a single 2-D field: the commonest regrid call."""
    _, _, source = make_case(n_extra=1, seed=9, inf_frac=0.02)
    _apply_case(source[0], method, seed=9)


@pytest.mark.parametrize("method", ["mean", "first_order_conservative", "max_overlap", "median"])
def test_apply_weights_non_contiguous_source_matches_jax_apply(method):
    """A strided view of a (m, E) array: apply_weights copies it to
    (E, m) slices-major before the kernel."""
    _, _, source = make_case(n_extra=4, seed=10, inf_frac=0.02)
    view = torch.from_numpy(source.T.copy()).t()
    assert not view.is_contiguous()
    _apply_case(view, method, seed=10)


@pytest.mark.parametrize("method", ["mean", "sum", "geometric_mean", "mode"])
def test_apply_weights_leading_dims_match_jax_apply(method):
    """Leading (time, layer) dims (T, L) = (3, 2) come back as they went in."""
    _, _, source = make_case(n_extra=6, seed=11, nan_frac=0.1, positive=method == "geometric_mean")
    _apply_case(source.reshape(3, 2, -1), method, seed=11)


SELECT_CASES = ["one_slice", "non_contiguous", "leading_dims"]


@pytest.mark.parametrize("case", SELECT_CASES)
@pytest.mark.parametrize("method", ["mode", "median", "p90"])
def test_window_select_and_apply_weights_match_jax_apply(method, case):
    """window_select on the (E, m) source and apply_weights, against
    oracle (a) in float64 (rtol 1e-12, the mode bit-equal): E = 1, a
    strided view of a (m, E) array, and leading (T, L) = (3, 2) dims."""
    _, _, source = make_case(n_extra=6, seed=13, inf_frac=0.02, few_values=True)
    if case == "one_slice":
        source = source[0]
    elif case == "non_contiguous":
        source = torch.from_numpy(source.T.copy()).t()
        assert not source.is_contiguous()
    else:
        source = source.reshape(3, 2, -1)
    _apply_case(source, method, seed=13)


@pytest.mark.parametrize("method", ["mode", "median"])
@pytest.mark.parametrize("leading", [(4,), (3, 2)])
def test_apply_weights_hands_window_select_the_callers_storage(monkeypatch, method, leading):
    """Mode and percentiles go to window_select on the caller's (E, m)
    storage: the same data_ptr for a contiguous source, no transposed
    copy; the (E, n) result comes back contiguous as (..., n)."""
    indices, weights, _ = make_case(seed=14)
    n, w = indices.shape
    m = 700
    source = torch.from_numpy(np.random.default_rng(14).normal(size=leading + (m,)))
    seen = []

    def fake_select(src, idx, wts, reduction, *, out=None):
        assert out is None  # a plain apply: the kernel makes its own output
        seen.append(src)
        return torch.arange(src.shape[0] * idx.shape[0], dtype=src.dtype).reshape(src.shape[0], idx.shape[0])

    monkeypatch.setattr(apply_module, "window_select", fake_select)
    out = apply_weights(PaddedCSR(indices, weights, n, m, w), source, _method(reduce, method), n)
    (got,) = seen
    E = int(np.prod(leading))
    assert got.shape == (E, m) and got.is_contiguous()
    assert got.data_ptr() == source.data_ptr()
    assert out.shape == leading + (n,) and out.is_contiguous()
    np.testing.assert_array_equal(out.reshape(E, n).numpy(), np.arange(E * n).reshape(E, n))


@pytest.mark.parametrize(
    "w, slots", [(1, 8), (8, 8), (9, 16), (16, 16), (17, 32), (32, 32), (33, 32), (400, 32)]
)
def test_register_slots_picks_each_branch(w, slots):
    """window_select's register array K: the least of 8, 16, 32 that
    holds a w-slot window; wider tables keep 32 and their longer
    windows walk."""
    assert register_slots(w) == slots


def test_reduce_lanes_one_slice_per_walk():
    """window_select's block (batch 1): a warp walks at most 8 slices,
    and the windows are staged as soon as it walks them twice (E > S)."""
    assert reduce_lanes(1, 16, 4, batch=1) == (1, 8, False)
    assert reduce_lanes(2, 16, 4, batch=1) == (1, 8, True)
    assert reduce_lanes(8, 16, 4, batch=1) == (1, 8, True)
    assert reduce_lanes(9, 16, 4, batch=1) == (2, 4, True)
    assert reduce_lanes(20, 16, 4, batch=1) == (4, 2, True)
    assert reduce_lanes(33, 16, 4, batch=1) == (8, 1, True)
    assert reduce_lanes(128, 16, 4, batch=1) == (8, 1, True)
    assert reduce_lanes(20, 16, 8, batch=1) == (4, 2, True)
    assert reduce_lanes(20, 400, 4, batch=1) == (4, 2, False)


def test_reduce_lanes_picks_each_branch():
    """Slice warps S: the least power of two leaving a warp at most 32
    slices; windows staged when a warp walks them more than once (E >
    4 S), with target warps G halved until the tile fits STAGE_BYTES;
    otherwise, or when not even 32 targets fit, read in place."""
    assert reduce_lanes(1, 16, 4) == (1, 8, False)
    assert reduce_lanes(4, 16, 4) == (1, 8, False)
    assert reduce_lanes(5, 16, 4) == (1, 8, True)
    assert reduce_lanes(20, 16, 4) == (1, 8, True)
    assert reduce_lanes(32, 16, 4) == (1, 8, True)
    assert reduce_lanes(33, 16, 4) == (2, 4, True)
    assert reduce_lanes(8, 16, 4) == (1, 8, True)
    assert reduce_lanes(65, 16, 4) == (4, 2, True)
    assert reduce_lanes(128, 16, 4) == (4, 2, True)
    assert reduce_lanes(129, 16, 4) == (8, 1, True)
    assert reduce_lanes(2000, 16, 4) == (8, 1, True)
    # float64 windows of 16 slots: 257 x 16 x 12 bytes do not fit.
    assert reduce_lanes(20, 16, 8) == (1, 4, True)
    assert reduce_lanes(20, 40, 8) == (1, 2, True)
    assert stage_bytes(1, 124, 8) <= STAGE_BYTES < stage_bytes(1, 125, 8)
    assert reduce_lanes(20, 124, 8) == (1, 1, True)
    assert reduce_lanes(20, 125, 8) == (1, 8, False)
    assert reduce_lanes(128, 400, 4) == (4, 2, False)


@pytest.mark.parametrize(
    "E, n, w, itemsize, plan",
    [
        (261, 1_560_000, 1, 4, (4, 1524, 53)),  # a slab of the daily forcing onto the LHM mesh
        (301, 1_560_000, 1, 4, (4, 1524, 61)),
        (261, 1_560_000, 2, 4, (4, 1524, 53)),
        (261, 1_560_000, 4, 4, (4, 1524, 53)),
        (20, 1_000_000, 4, 4, (4, 977, 20)),
        (64, 1001, 1, 4, (4, 1, 64)),
        (65, 1001, 3, 4, (4, 1, 33)),
        (1, 1024, 2, 4, (4, 1, 1)),
        (261, 1_560_000, 1, 8, (2, 3047, 53)),
        (20, 1001, 4, 8, (2, 2, 20)),
        (64 * 65535 + 1, 1, 1, 4, (4, 1, 65)),  # past the grid's 65,535 groups
    ],
)
def test_window_reduce_takes_row_tiles_for_narrow_windows(E, n, w, itemsize, plan):
    """Windows of at most 4 slots take row tiles: 256 threads of V = 16 //
    itemsize consecutive targets a tile (16-byte stores), the slices cut
    evenly into groups of at most 64 (more past 65,535 groups)."""
    assert row_tiles(E, n, itemsize) == plan
    assert reduce_block(E, n, w, itemsize) == ("xt_window_reduce_rows", (plan[2],))


@pytest.mark.parametrize("E", [261, 301])
@pytest.mark.parametrize("w", [5, 16, 40])
def test_wider_windows_keep_the_tile_block(E, w):
    """Windows of more than 4 slots (the mean of a 1 km map cell's 16 faces
    of 250 m among them) keep ``reduce_lanes``' block: at E = 261 and 301,
    8 slice warps over a staged tile of 32 targets."""
    assert reduce_lanes(E, w, 4) == (8, 1, True)
    assert reduce_block(E, 97_500, w, 4) == ("xt_window_reduce", (8, 1, 1))
