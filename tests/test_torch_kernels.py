"""
The two Hopper kernels (window_reduce, window_select) against their
plain PyTorch version on a CUDA card, and the checks of their wrappers.

Every test here needs a card: marked ``cuda`` and skipped without one.
This file imports no jax; where jax is not installed, skip the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
import xugrid_tpu_torch as xt
from xugrid_tpu_torch.regrid import reduce
from xugrid_tpu_torch.regrid.aligned_apply import METHOD_CODES, window_reduce
from xugrid_tpu_torch.regrid.select_apply import window_select

pytestmark = pytest.mark.cuda

PERCENTILES = [reduce.Percentile(p) for p in (0, 10, 50, 90, 100, 33.3)]
EXACT = {reduce.minimum, reduce.maximum, reduce.max_overlap, reduce.mode, *PERCENTILES}
LINEAR = {reduce.mean, reduce.sum, reduce.first_order_conservative}
CASES = [(fn, window_reduce) for fn in METHOD_CODES] + [
    (fn, window_select) for fn in (reduce.mode, *PERCENTILES)
]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def windows():
    return chip_smoke.synthetic_windows(np.random.default_rng(11), n=1500, m=1200)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("fn, kernel", CASES, ids=[getattr(f, "__name__", "") for f, _ in CASES])
def test_kernel_matches_plain(device, windows, fn, kernel, dtype):
    indices, weights, mixed, positive = windows
    src = positive if fn is reduce.harmonic_mean else mixed
    sourceT = torch.from_numpy(src.T.copy()).to(device=device, dtype=dtype)
    idx = torch.from_numpy(indices).to(device)
    w = torch.from_numpy(weights).to(device=device, dtype=dtype)
    before = kernel.launches
    got = kernel(sourceT, idx, w, fn)
    assert kernel.launches == before + 1
    want = reduce.reduce_windows(sourceT, idx, w, fn)
    scale = float(np.nanmax(np.abs(np.where(np.isfinite(src), src, np.nan))))
    rtol, atol = chip_smoke.tolerance(dtype, scale)
    if fn in LINEAR:
        atol = torch.clamp(chip_smoke.summation_bound(sourceT, idx, w, fn), min=atol)
    chip_smoke.compare(got, want, fn in EXACT, rtol, atol)


def test_wrappers_check_their_tensors(device):
    sourceT = torch.zeros((10, 3), device=device)
    idx = torch.zeros((4, 2), dtype=torch.int32, device=device)
    w = torch.ones((4, 2), device=device)
    with pytest.raises(TypeError, match="int32"):
        window_reduce(sourceT, idx.long(), w, reduce.mean)
    with pytest.raises(TypeError, match="float32 or float64"):
        window_select(sourceT.half(), idx, w.half(), reduce.mode)
    with pytest.raises(TypeError, match="differs"):
        window_reduce(sourceT, idx, w.double(), reduce.mean)
    with pytest.raises(ValueError, match="contiguous"):
        window_reduce(torch.zeros((3, 10), device=device).t(), idx, w, reduce.mean)
    with pytest.raises(ValueError, match="CUDA device"):
        window_select(sourceT, idx, w.cpu(), reduce.median)


def test_regrid_on_cuda_matches_cpu(device):
    (verts, faces), (tverts, tfaces) = chip_smoke.bench_meshes(30, 17, np.random.default_rng(1))
    source = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    target = xt.Ugrid2d(tverts[:, 0], tverts[:, 1], -1, tfaces)
    data = torch.from_numpy(np.random.default_rng(2).normal(size=(4, source.n_face)))
    for method in ("mean", "median", "mode", "max_overlap"):
        regridder = xt.OverlapRegridder(source, target, method=method)
        on_card = regridder.regrid(data.to(device))
        assert on_card.device == device
        torch.testing.assert_close(on_card.cpu(), regridder.regrid(data), rtol=1e-12, atol=1e-12)
