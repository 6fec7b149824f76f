"""
The port's reductions (xugrid_tpu_torch.regrid.reduce) against the JAX
package's (xugrid_tpu.regrid.reduce) and against the reference goldens.

Inputs are made with numpy from a seed and handed to both.  In float64
the two differ only in summation order: rtol 1e-12, plus an absolute
1e-12 * max|value| for sums that cancel to near zero; for the harmonic
mean, whose sum of w / v can cancel with mixed signs, the relative
bound of a reordered sum (w * eps * sum|w / v| / |sum w / v|) is added.
Selections (minimum, maximum, max_overlap, mode) must be bit-equal.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xugrid_tpu.regrid import reduce as jax_reduce
from xugrid_tpu_torch.regrid import reduce as torch_reduce

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

ALL_METHODS = sorted(
    set(torch_reduce.ABSOLUTE_OVERLAP_METHODS) | set(torch_reduce.RELATIVE_OVERLAP_METHODS)
)
EXACT = {"minimum", "maximum", "max_overlap", "mode"}
RTOL = 1e-12


def _lookup(module, method):
    return module.ABSOLUTE_OVERLAP_METHODS.get(method) or module.RELATIVE_OVERLAP_METHODS[method]


def make_windows(w, seed, n=400):
    """(n, w) windows: normal values (half rounded to 0.5 steps, for
    ties), 15 % NaN, 2 % +inf, 2 % -inf, 5 % zeros; weights in (0, 2)
    with 10 % zero slots and 3 % all-zero rows; ragged pad slots."""
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(n, w))
    values[: n // 2] = np.round(values[: n // 2] * 2.0) / 2.0
    u = rng.random(values.shape)
    values[u < 0.15] = np.nan
    values[(u >= 0.15) & (u < 0.17)] = np.inf
    values[(u >= 0.17) & (u < 0.19)] = -np.inf
    values[(u >= 0.19) & (u < 0.24)] = 0.0
    weights = rng.uniform(0.0, 2.0, size=(n, w))
    weights[rng.random((n, w)) < 0.10] = 0.0
    weights[rng.random(n) < 0.03] = 0.0
    pad = np.arange(w)[None, :] >= rng.integers(1, w + 1, size=n)[:, None]
    values[pad] = np.nan
    weights[pad] = 0.0
    return values, weights


def harmonic_rtol(values, weights):
    use = ~np.isnan(values) & (values != 0.0) & (weights > 0.0)
    terms = np.where(use, weights / np.where(use, values, 1.0), 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        return RTOL + values.shape[-1] * np.finfo(np.float64).eps * (
            np.abs(terms).sum(-1) / np.abs(terms.sum(-1))
        )


def assert_matches(got, want, method, values, weights):
    if method in EXACT:
        np.testing.assert_array_equal(got, want, err_msg=method)
        return
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=method)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(got[~finite], want[~finite], err_msg=method)
    rtol = harmonic_rtol(values, weights) if method == "harmonic_mean" else RTOL
    atol = RTOL * np.nanmax(np.abs(np.where(np.isfinite(values), values, np.nan)))
    with np.errstate(invalid="ignore"):
        bad = np.abs(got - want) > atol + rtol * np.abs(want)
    assert not bad[finite].any(), f"{method}: {int(bad[finite].sum())} outputs differ"


@pytest.mark.parametrize("w", [9, 40])
@pytest.mark.parametrize("method", ALL_METHODS)
def test_reduction_matches_jax(method, w):
    values, weights = make_windows(w, seed=w)
    want = np.asarray(_lookup(jax_reduce, method)(jnp.asarray(values), jnp.asarray(weights)))
    got = _lookup(torch_reduce, method)(torch.from_numpy(values), torch.from_numpy(weights)).numpy()
    assert got.dtype == np.float64
    assert_matches(got, want, method, values, weights)


@pytest.mark.parametrize("p", [0, 33.3, 100])
def test_custom_percentile_matches_jax(p):
    values, weights = make_windows(12, seed=3)
    want = np.asarray(
        jax_reduce.create_percentile_method(p)(jnp.asarray(values), jnp.asarray(weights))
    )
    got = torch_reduce.create_percentile_method(p)(
        torch.from_numpy(values), torch.from_numpy(weights)
    ).numpy()
    assert_matches(got, want, f"p{p}", values, weights)


def test_percentile_range_checked():
    with pytest.raises(ValueError, match="range"):
        torch_reduce.create_percentile_method(101)


@pytest.mark.parametrize("method", ALL_METHODS)
@pytest.mark.parametrize("variant", ["nan", "clean"])
def test_reduction_goldens(method, variant):
    data = np.load(os.path.join(GOLDEN, "reductions.npz"))
    values = data["values" if variant == "nan" else "clean_values"]
    fn = _lookup(torch_reduce, method)
    actual = fn(torch.from_numpy(values), torch.from_numpy(data["weights"])).numpy()
    np.testing.assert_allclose(
        actual, data[f"expected_{method}_{variant}"], rtol=1e-6, atol=1e-10,
        equal_nan=True, err_msg=f"{method}/{variant} disagrees with the reference",
    )


def test_reduce_windows_gathers_slice_minor():
    """reduce_windows reads sourceT (m, E) through -1 padded indices and
    returns (n, E), NaN where a window is empty."""
    sourceT = torch.arange(12.0, dtype=torch.float64).reshape(4, 3)
    indices = torch.tensor([[0, 2], [3, -1], [-1, -1]], dtype=torch.int32)
    weights = torch.tensor([[1.0, 3.0], [2.0, 0.0], [0.0, 0.0]], dtype=torch.float64)
    out = torch_reduce.reduce_windows(sourceT, indices, weights, torch_reduce.mean)
    expected = torch.tensor(
        [[(0 + 3 * 6) / 4, (1 + 3 * 7) / 4, (2 + 3 * 8) / 4], [9.0, 10.0, 11.0]],
        dtype=torch.float64,
    )
    torch.testing.assert_close(out[:2], expected, rtol=1e-15, atol=0)
    assert torch.isnan(out[2]).all()
