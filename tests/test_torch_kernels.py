"""
The Hopper kernels (window_reduce, window_select, csr_matvec) against
their plain PyTorch version on a CUDA card, the checks of their
wrappers, the entry points (regrid, laplace_interpolate) on the card,
and the row grouping and ``merge_partitions`` with payloads there.

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
from xugrid_tpu_torch.regrid.aligned_apply import (
    METHOD_CODES, ROW_TILE_SLOTS, csr_matvec, csr_matvec_plain, reduce_block, reduce_lanes, window_reduce,
)
from xugrid_tpu_torch.regrid.select_apply import register_slots, window_select
from xugrid_tpu_torch.ugrid import interpolate

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
    source = torch.from_numpy(src).to(device=device, dtype=dtype)
    idx = torch.from_numpy(indices).to(device)
    w = torch.from_numpy(weights).to(device=device, dtype=dtype)
    before = kernel.launches
    got = kernel(source, idx, w, fn)
    want = reduce.reduce_windows(source.t(), idx, w, fn).t()
    assert kernel.launches == before + 1
    assert got.shape == source.shape[:1] + idx.shape[:1] and got.is_contiguous()
    scale = float(np.nanmax(np.abs(np.where(np.isfinite(src), src, np.nan))))
    rtol, atol = chip_smoke.tolerance(dtype, scale)
    if fn in LINEAR:
        atol = torch.clamp(chip_smoke.summation_bound(source, idx, w, fn), min=atol)
    chip_smoke.compare(got, want, fn in EXACT, rtol, atol)


@pytest.mark.parametrize("n", [1001, 1024])
@pytest.mark.parametrize("E", [1, 3, 20, 40, 128, 200, 261])
@pytest.mark.parametrize("w", [1, 2, 3, 4, 40, 400])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_window_reduce_lane_mappings_match_plain(device, dtype, w, E, n):
    """Each slice-warp count and slice batch (E), shared-memory tile
    (dtype, w) and the in-place read of windows (E <= 4, or too wide to
    stage at w = 400), on a target count that no tile divides (1001) and
    one that the row tiles' V does (1024).  Windows of w <= 4 slots (the
    first w of the 40) take row tiles, scalar stores at n = 1001 and 16-byte
    stores at 1024, with the bits of the tile block."""
    indices, weights, mixed, positive = chip_smoke.synthetic_windows(
        np.random.default_rng(E), n=n, m=900, w=max(w, 40), n_extra=E
    )
    idx = torch.from_numpy(np.ascontiguousarray(indices[:, :w])).to(device)
    wt = torch.from_numpy(np.ascontiguousarray(weights[:, :w])).to(device=device, dtype=dtype)
    rows = w <= ROW_TILE_SLOTS
    assert (reduce_block(E, n, w, wt.element_size())[0] == "xt_window_reduce_rows") == rows
    assert rows or reduce_lanes(E, w, wt.element_size())[2] == (w == 40 and E > 4)
    for fn in METHOD_CODES:
        src = positive if fn is reduce.harmonic_mean else mixed
        source = torch.from_numpy(src).to(device=device, dtype=dtype)
        got = window_reduce(source, idx, wt, fn)
        assert got.shape == (E, n) and got.is_contiguous()
        assert not rows or chip_smoke.same_bits(got, chip_smoke.tile_block_reduce(source, idx, wt, fn))
        want = reduce.reduce_windows(source.t(), idx, wt, fn).t()
        scale = float(np.nanmax(np.abs(np.where(np.isfinite(src), src, np.nan))))
        rtol, atol = chip_smoke.tolerance(dtype, scale)
        if fn in LINEAR:
            atol = torch.clamp(chip_smoke.summation_bound(source, idx, wt, fn), min=atol)
        chip_smoke.compare(got, want, fn in EXACT, rtol, atol)


def test_wrappers_check_their_tensors(device):
    source = torch.zeros((3, 10), device=device)
    idx = torch.zeros((4, 2), dtype=torch.int32, device=device)
    w = torch.ones((4, 2), device=device)
    with pytest.raises(TypeError, match="int32"):
        window_reduce(source, idx.long(), w, reduce.mean)
    with pytest.raises(TypeError, match="float32 or float64"):
        window_select(source.half(), idx, w.half(), reduce.mode)
    with pytest.raises(TypeError, match="differs"):
        window_reduce(source, idx, w.double(), reduce.mean)
    with pytest.raises(ValueError, match="contiguous"):
        window_reduce(torch.zeros((10, 3), device=device).t(), idx, w, reduce.mean)
    with pytest.raises(ValueError, match="contiguous"):
        window_select(torch.zeros((10, 3), device=device).t(), idx, w, reduce.mode)
    with pytest.raises(ValueError, match="CUDA device"):
        window_select(source, idx, w.cpu(), reduce.median)


def stress_windows(rng, n, m, w, n_extra):
    """Windows and a source that stress the percentile's sorting network:
    source values from a small pool (+-inf, -0 and +0 among them, 10 %
    NaN), faces [0, 16) NaN in every slice; windows of 0 to w slots (each
    length up to 32 at every K), 10 % of the slots before the last a -1
    pad, and a tie of every size (one face repeated in 0 to len slots).
    Windows 7j draw only from the NaN faces (all NaN), windows 7j + 1 all
    but one slot (one valid value).  Weights 0, 0.25 or 1, 0 at the
    pads."""
    pool = np.array([-np.inf, -2.5, -1.0, -0.0, 0.0, 0.5, 1.0, 3.0, np.inf])
    source = pool[rng.integers(0, len(pool), size=(n_extra, m))]
    source[rng.random(source.shape) < 0.10] = np.nan
    source[:, :16] = np.nan
    lengths = np.where(np.arange(n) < 33 * 3, np.arange(n) % 33, rng.integers(0, w + 1, size=n))
    lengths = np.minimum(lengths, w)
    indices = rng.integers(16, m, size=(n, w))
    ties = rng.integers(0, lengths + 1)
    for t in range(n):
        indices[t, rng.permutation(lengths[t])[: ties[t]]] = indices[t, 0]
        if t % 7 == 0:
            indices[t] = rng.integers(0, 16, size=w)
        elif t % 7 == 1 and lengths[t] > 0:
            indices[t] = rng.integers(0, 16, size=w)
            indices[t, rng.integers(0, lengths[t])] = rng.integers(16, m)
    slots = np.arange(w)[None, :]
    indices[(slots < lengths[:, None] - 1) & (rng.random((n, w)) < 0.10)] = -1
    indices[slots >= lengths[:, None]] = -1
    weights = rng.choice([0.0, 0.25, 1.0], size=(n, w))
    weights[indices < 0] = 0.0
    return indices.astype(np.int32), weights, source


@pytest.mark.parametrize("data", ["synthetic", "stress"])
@pytest.mark.parametrize("E", [1, 3, 20, 128])
@pytest.mark.parametrize("w", [8, 16, 32, 40, 400])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_window_select_register_slots_and_walk_match_plain(device, dtype, w, E, data):
    """Each register array K (windows cut to 8, 16 and 32 slots) and the
    walk of windows longer than 32 slots (w = 40: 5 % of the windows
    hold 33-40 slots; w = 400: up to 400), in place (E = 1) and staged,
    bit for bit, NaN in the same places; on ``chip_smoke``'s synthetic
    windows and on ``stress_windows``."""
    rng = np.random.default_rng(w + E)
    if data == "synthetic":
        indices, weights, mixed, _ = chip_smoke.synthetic_windows(
            rng, n=1001, m=900, w=max(w, 40), n_extra=E
        )
        indices, weights = indices[:, :w], weights[:, :w]
    else:
        indices, weights, mixed = stress_windows(rng, n=1001, m=900, w=w, n_extra=E)
    idx = torch.from_numpy(np.ascontiguousarray(indices)).to(device)
    wt = torch.from_numpy(np.ascontiguousarray(weights)).to(device=device, dtype=dtype)
    source = torch.from_numpy(mixed).to(device=device, dtype=dtype)
    assert register_slots(w) == min(w, 32)
    for fn in (reduce.mode, *PERCENTILES):
        got = window_select(source, idx, wt, fn)
        assert got.shape == (E, 1001) and got.is_contiguous()
        chip_smoke.compare(got, reduce.reduce_windows(source.t(), idx, wt, fn).t(), True, 0.0, 0.0)


@pytest.mark.parametrize("K", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_percentile_network_sorts_every_zero_one_window(device, dtype, K):
    """The 0-1 principle: a comparator network sorts every input if it
    sorts every input of 0s and 1s.  Every 0/1 window of K = 8 and 16
    distinct faces (a seeded sample of 65,536 at K = 32), in 8 staged
    slices (slice e flips the bits of mask e), at every percentile that
    selects an exact rank, p = 100 r / (K - 1), bit for bit."""
    rng = np.random.default_rng(K)
    n = 1 << min(K, 16)
    patterns = np.arange(n, dtype=np.int64) if K < 32 else rng.integers(0, 1 << 32, size=n, dtype=np.int64)
    masks = rng.integers(0, 1 << K, size=8, dtype=np.int64)
    masks[0] = 0
    bits = (((patterns[None, :] ^ masks[:, None])[..., None] >> np.arange(K)) & 1).reshape(8, n * K)
    source = torch.from_numpy(bits).to(device=device, dtype=dtype)
    idx = torch.arange(n * K, dtype=torch.int32, device=device).reshape(n, K)
    wt = torch.ones((n, K), dtype=dtype, device=device)
    assert register_slots(K) == K and reduce_lanes(8, K, source.element_size(), batch=1)[2]
    for r in range(K):
        fn = reduce.Percentile(100.0 * r / (K - 1))
        got = window_select(source, idx, wt, fn)
        chip_smoke.compare(got, reduce.reduce_windows(source.t(), idx, wt, fn).t(), True, 0.0, 0.0)


@pytest.mark.parametrize("slices", [1, 8], ids=["in_place", "staged"])
@pytest.mark.parametrize("K", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_median_network_selects_every_zero_one_window(device, dtype, K, slices):
    """The 0-1 principle for the median's fixed-slot network: every 0/1
    window of K = 8 and 16 faces (a seeded sample of 65,536 at K = 32),
    each with j = 0, 1, ..., K invalid slots at seeded positions (NaN
    faces and -1 pads among the slots, or the last j slots cut off as a
    shorter window), so every split of the +inf / -inf sentinels is hit;
    in place (1 slice) and staged (8 slices, slice e flipping the bits of
    mask e); ``reduce.median`` bit for bit."""
    rng = np.random.default_rng(100 + K)
    n = 1 << min(K, 16)
    patterns = np.arange(n, dtype=np.int64) if K < 32 else rng.integers(0, 1 << 32, size=n, dtype=np.int64)
    masks = rng.integers(0, 1 << K, size=slices, dtype=np.int64)
    masks[0] = 0
    bits = (((patterns[None, :] ^ masks[:, None])[..., None] >> np.arange(K)) & 1).reshape(slices, n * K)
    nan_face = n * K
    values = np.concatenate([bits.astype(np.float64), np.full((slices, 1), np.nan)], axis=1)
    source = torch.from_numpy(values).to(device=device, dtype=dtype)
    faces = np.arange(n * K, dtype=np.int32).reshape(n, K)
    assert register_slots(K) == K and reduce_lanes(slices, K, source.element_size(), batch=1)[2] == (slices > 1)
    for j in range(K + 1):
        invalid = np.argsort(rng.random((n, K)), axis=1)[:, :j]
        shorter = rng.random(n) < 1.0 / 3.0
        invalid[shorter] = np.arange(K - j, K)
        as_nan = (rng.random((n, j)) < 0.5) & ~shorter[:, None]
        indices = faces.copy()
        rows = np.repeat(np.arange(n), j).reshape(n, j)
        indices[rows, invalid] = np.where(as_nan, nan_face, -1)
        idx = torch.from_numpy(indices).to(device)
        wt = torch.from_numpy((indices >= 0).astype(np.float64)).to(device=device, dtype=dtype)
        before = window_select.launches
        got = window_select(source, idx, wt, reduce.median)
        assert window_select.launches == before + 1
        chip_smoke.compare(got, reduce.reduce_windows(source.t(), idx, wt, reduce.median).t(), True, 0.0, 0.0)


@pytest.mark.parametrize(
    "fn, w, walks, network, median",
    [(reduce.median, 16, 0, 1, 1), (reduce.mode, 16, 0, 0, 0), (reduce.median, 40, 1, 1, 1),
     (reduce.mode, 40, 1, 0, 0), (reduce.Percentile(0), 16, 0, 0, 0), (reduce.Percentile(100), 16, 0, 0, 0),
     (reduce.Percentile(50.0), 16, 0, 1, 1), (reduce.Percentile(10), 16, 0, 1, 0),
     (reduce.Percentile(33.3), 16, 0, 1, 0), (reduce.Percentile(90), 16, 0, 1, 0)],
    ids=["median", "mode", "median_walk", "mode_walk", "p0", "p100", "p50", "p10", "p33.3", "p90"],
)
def test_window_select_counts_its_launches_by_path(device, fn, w, walks, network, median):
    """Per launch, ``select.walk_launches`` where windows past the register
    slots walk, ``select.network_launches`` where a percentile's
    windows are sorted by the network: never the mode, nor p = 0 or 100,
    which take the extreme value; and ``select.median_launches`` where
    p = 50 takes the fixed-slot median, walking or not."""
    from xugrid_tpu_torch.utils.profiling import timings

    indices, weights, mixed, _ = chip_smoke.synthetic_windows(np.random.default_rng(5), n=300, m=400, n_extra=3)
    idx = torch.from_numpy(np.ascontiguousarray(indices[:, :w])).to(device)
    wt = torch.from_numpy(np.ascontiguousarray(weights[:, :w])).to(device=device, dtype=torch.float32)
    source = torch.from_numpy(mixed).to(device=device, dtype=torch.float32)
    timings.reset()
    timings.start_spans()
    try:
        window_select(source, idx, wt, fn)
    finally:
        records = timings.stop_spans()
    timings.reset()
    counts = {
        "select.windows": 3 * 300, "select.walk_launches": walks, "select.network_launches": network,
        "select.median_launches": median,
    }
    assert [(rec.name, rec.counts) for rec in records] == [("apply.select", counts)]


@pytest.mark.parametrize("w, rows", [(1, 1), (2, 1), (3, 1), (4, 1), (16, 0)])
def test_window_reduce_counts_row_tile_launches(device, w, rows):
    """``apply.row_tile_launches`` adds 1 per window_reduce launch that
    takes row tiles (windows of at most 4 slots), else 0."""
    from xugrid_tpu_torch.utils.profiling import timings

    indices, weights, mixed, _ = chip_smoke.synthetic_windows(np.random.default_rng(5), n=300, m=400, n_extra=3)
    idx = torch.from_numpy(np.ascontiguousarray(indices[:, :w])).to(device)
    wt = torch.from_numpy(np.ascontiguousarray(weights[:, :w])).to(device=device, dtype=torch.float32)
    source = torch.from_numpy(mixed).to(device=device, dtype=torch.float32)
    before = window_reduce.launches
    timings.reset()
    timings.start_spans()
    try:
        window_reduce(source, idx, wt, reduce.mean)
        window_reduce(source, idx, wt, reduce.maximum)
    finally:
        timings.stop_spans()
    counters = timings.counters()
    timings.reset()
    assert window_reduce.launches == before + 2 and counters == {"apply.row_tile_launches": 2 * rows}


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
        # A numpy source goes to the card by default.
        assert regridder.regrid(data.numpy()).device == device


def window_range(values, weights):
    """A custom reduction: each window's largest value less its smallest
    (NaN where the window holds none)."""
    nan = torch.isnan(values)
    hi = torch.where(nan, -torch.inf, values).amax(-1)
    lo = torch.where(nan, torch.inf, values).amin(-1)
    return torch.where(torch.isfinite(hi), hi - lo, torch.nan)


@pytest.mark.parametrize("method", ["mean", "median", "custom"])
def test_slabs_written_in_place_on_the_card(device, monkeypatch, method):
    """40 float32 slices in slabs of 12, 12, 12, 4: each slab's kernel
    writes its rows of one output (every slab's ``out`` lies at its rows
    inside the result's storage), with the bits of the slabs applied one
    by one and joined, and of the stack applied in one slab; an integer
    stack comes back float64."""
    from xugrid_tpu_torch.regrid import regridder as torch_regridder
    from xugrid_tpu_torch.regrid.apply import apply_weights

    (verts, faces), (tverts, tfaces) = chip_smoke.bench_meshes(30, 17, np.random.default_rng(1))
    mesh = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    raster = xt.Ugrid2d(tverts[:, 0], tverts[:, 1], -1, tfaces)
    r = xt.OverlapRegridder(mesh, raster, method=window_range if method == "custom" else method)
    data = np.random.default_rng(3).normal(size=(40, mesh.n_face)).astype(np.float32)
    data[np.random.default_rng(4).random(data.shape) < 0.05] = np.nan
    source = torch.from_numpy(data).to(device)
    whole = r.regrid(source)
    slabs = []

    def keep_out(*args, **kwargs):
        slabs.append(kwargs["out"])
        return apply_weights(*args, **kwargs)

    monkeypatch.setattr(torch_regridder, "apply_weights", keep_out)
    monkeypatch.setattr(torch_regridder, "APPLY_CHUNK_BYTES", 12 * 4 * (r._weights.m + r._weights.n))
    got = r.regrid(source)
    assert got.device == device and got.dtype == torch.float32 and got.is_contiguous()
    storage = got.untyped_storage()
    assert len(slabs) == 4
    for k, out in enumerate(slabs):
        assert out.data_ptr() == got[12 * k].data_ptr()
        end = out.data_ptr() + out.numel() * out.element_size()
        assert storage.data_ptr() <= out.data_ptr() and end <= storage.data_ptr() + storage.nbytes()
    joined = torch.cat([
        apply_weights(r._padded, source[i : i + 12], r._reduction, r._weights.n) for i in range(0, 40, 12)
    ])
    torch.testing.assert_close(got, joined, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got, whole, rtol=0, atol=0, equal_nan=True)
    counts = torch.from_numpy(np.round(np.nan_to_num(data) * 4.0).astype(np.int32)).to(device)
    slabs.clear()
    as_int = r.regrid(counts)
    assert as_int.dtype == torch.float64 and len(slabs) == 4
    torch.testing.assert_close(as_int, r.regrid(counts.double()), rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("cell, walks", [(1000.0, 0), (2000.0, 1)], ids=["map_1km", "map_2km"])
def test_labelled_median_in_slabs_on_the_card(device, monkeypatch, cell, walks):
    """A (time, layer, face) UgridDataArray of 250 m faces on the card,
    upscaled by the median onto a 1 km map (windows of 16 faces, in
    registers) and a 2 km one (64 faces: past the 32 register slots, so
    every launch walks), 15 slices in slabs of 4, 4, 4, 3 written in
    place: the bits of the slabs applied one by one and joined, within
    half a float32 ulp of the plain reference
    (``portbench/reference/select.py``; the median of float32 values is
    an exact selection and one halving sum), and per launch one
    ``apply.select`` span counting its E x n windows, ``walks``, one
    launch sorted by the network and one by the fixed-slot median."""
    from portbench import inputs
    from portbench.generators import common
    from portbench.reference import overlap, select
    from xugrid_tpu_torch.regrid import regridder as torch_regridder
    from xugrid_tpu_torch.regrid.apply import apply_weights
    from xugrid_tpu_torch.utils.profiling import timings

    mesh = inputs.quad_mesh(40, 48, 250.0, (0.0, 300000.0))
    raster = inputs.raster(mesh.bounds, cell)
    pool = inputs.payload_pool(15, len(mesh.faces), 0.01, 2147483659, device)
    grid = common.port_grid(xt, mesh)
    uda = xt.UgridDataArray(xt.xdata.DataArray(pool.view(5, 3, -1), dims=("time", "layer", grid.face_dimension)), grid)
    r = xt.OverlapRegridder(uda, common.port_raster(xt, raster), method="median")
    n, w = r._weights.n, r._padded.indices.shape[1]
    assert w == (cell / 250.0) ** 2 and (w > register_slots(w)) == bool(walks)
    monkeypatch.setattr(torch_regridder, "APPLY_CHUNK_BYTES", 4 * 4 * (r._weights.m + n))
    r.regrid(uda)  # the weights uploaded before the recording
    timings.reset()
    timings.start_spans()
    try:
        out = r.regrid(uda)
    finally:
        records = timings.stop_spans()
    timings.reset()
    assert out.dims == ("time", "layer", "y", "x") and out.data.device == device
    got = out.data.reshape(15, n)
    joined = torch.cat([apply_weights(r._padded, pool[i : i + 4], r._reduction, n) for i in range(0, 15, 4)])
    torch.testing.assert_close(got, joined, rtol=0, atol=0, equal_nan=True)
    window = select.windows(overlap.overlap_triplets(mesh.nodes, mesh.faces, raster, device), raster.size)
    expected = select.percentile(window, pool, 50.0)
    assert torch.equal(torch.isnan(got), torch.isnan(expected))
    valid = ~torch.isnan(expected)
    ulp = float(np.spacing(np.float32(expected[valid].abs().max().item())))
    torch.testing.assert_close(got.double()[valid], expected[valid], rtol=0, atol=0.5 * ulp)
    by_id = {rec.id: rec for rec in records}
    select_spans = [rec for rec in records if rec.name == "apply.select"]
    assert [by_id[rec.parent].name for rec in select_spans] == ["apply.kernel"] * 4
    assert [rec.counts for rec in select_spans] == [
        {"select.windows": rows * n, "select.walk_launches": walks, "select.network_launches": 1,
         "select.median_launches": 1}
        for rows in (4, 4, 4, 3)
    ]


@pytest.mark.parametrize("shift, ulps", [((0.0, 0.0), 2), ((125.0, -90.0), 8)], ids=["aligned", "shifted"])
def test_labelled_raster_to_mesh_in_slabs_on_the_card(device, monkeypatch, shift, ulps):
    """A (time, y, x) DataArray of 1 km cells on the card, north first,
    regridded by the mean onto a mesh of 250 m faces (aligned: each face
    in one cell, windows of 1; moved by a part of a cell: windows of 1,
    2 or 4), 15 slices in slabs of 4, 4, 4, 3 written in place, each slab
    one row-tile launch: a (time,
    face) UgridDataArray on the card with the bits of the slabs applied
    one by one and joined, and the CPU result's NaN; its values within
    twice the bound each path keeps of the float64 mean
    (``tests/test_torch_forcing.py``: 2 ulps of the largest value
    aligned, 8 moved)."""
    from portbench import inputs
    from portbench.generators import common
    from xugrid_tpu_torch.regrid import regridder as torch_regridder
    from xugrid_tpu_torch.regrid.apply import apply_weights
    from xugrid_tpu_torch.utils.profiling import timings

    mesh = inputs.quad_mesh(40, 48, 250.0, (0.0, 300000.0))
    raster = inputs.raster(mesh.bounds, 1000.0, shift)
    pool = inputs.payload_pool(15, raster.size, 0.01, 2147483659, device)
    grid = common.port_grid(xt, mesh)
    coords = common.port_raster(xt, raster).coords.variables
    source = xt.xdata.DataArray(pool.view(15, raster.ny, raster.nx), coords=coords, dims=("time", "y", "x"))
    r = xt.OverlapRegridder(source, grid, method="mean")
    m, n = r._weights.m, r._weights.n
    assert (m, n) == (raster.size, grid.n_face) and (r._padded.indices.shape[1] == 1) == (shift == (0.0, 0.0))
    monkeypatch.setattr(torch_regridder, "APPLY_CHUNK_BYTES", 4 * 4 * (m + n))
    timings.reset()
    timings.start_spans()
    try:
        out = r.regrid(source)
    finally:
        timings.stop_spans()
    row_tile_launches = timings.counters().get("apply.row_tile_launches")
    timings.reset()
    assert row_tile_launches == 4  # one a slab: windows of at most 4 slots
    assert isinstance(out, xt.UgridDataArray) and out.dims == ("time", grid.face_dimension)
    assert out.data.device == device and out.shape == (15, grid.n_face)
    joined = torch.cat([apply_weights(r._padded, pool[i : i + 4], r._reduction, n) for i in range(0, 15, 4)])
    torch.testing.assert_close(out.data, joined, rtol=0, atol=0, equal_nan=True)
    on_cpu = r.regrid(source.copy(data=pool.cpu().view(15, raster.ny, raster.nx))).data
    assert on_cpu.device.type == "cpu"
    got = out.data.cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(on_cpu))
    valid = ~torch.isnan(on_cpu)
    ulp = float(np.spacing(np.float32(on_cpu[valid].abs().max())))
    torch.testing.assert_close(got[valid], on_cpu[valid], rtol=0, atol=2 * ulps * ulp)


@pytest.mark.parametrize(
    "fn, kernel, width, start",
    [(reduce.mean, window_reduce, 40, 2 * 1500), (reduce.median, window_select, 40, 2 * 1500),
     (reduce.mean, window_reduce, 1, 2 * 1500), (reduce.mean, window_reduce, 4, 1)],
    ids=["window_reduce", "window_select", "window_reduce_rows", "window_reduce_rows_unaligned"],
)
def test_kernels_write_only_the_rows_of_out(device, windows, fn, kernel, width, start):
    """``out`` a view of E rows of a larger buffer from its element
    ``start`` (rows 2 to E + 1; for row tiles, whose 16-byte stores need
    16-byte aligned rows, also one element in, so that each result is
    stored alone), of the first ``width`` slots of each window: the kernel
    writes its bits there and the sentinels either side stay; a wrong
    ``out`` raises."""
    indices, weights, mixed, _ = windows
    source = torch.from_numpy(mixed).to(device=device, dtype=torch.float32)
    idx = torch.from_numpy(np.ascontiguousarray(indices[:, :width])).to(device)
    w = torch.from_numpy(np.ascontiguousarray(weights[:, :width])).to(device=device, dtype=torch.float32)
    E, n = source.shape[0], idx.shape[0]
    buffer = torch.full(((E + 4) * n,), -7.5, dtype=torch.float32, device=device)
    rows = buffer[start : start + E * n].view(E, n)
    assert (rows.data_ptr() % 16 == 0) == (start % 4 == 0)
    before = kernel.launches
    got = kernel(source, idx, w, fn, out=rows)
    assert kernel.launches == before + 1 and got.data_ptr() == rows.data_ptr()
    torch.testing.assert_close(rows, kernel(source, idx, w, fn), rtol=0, atol=0, equal_nan=True)
    assert bool((buffer[:start] == -7.5).all()) and bool((buffer[start + E * n :] == -7.5).all())
    with pytest.raises(ValueError, match="device"):
        kernel(source, idx, w, fn, out=torch.empty((E, n)))
    with pytest.raises(TypeError, match="dtype"):
        kernel(source, idx, w, fn, out=torch.empty((E, n), dtype=torch.float64, device=device))
    with pytest.raises(ValueError, match="shape"):
        kernel(source, idx, w, fn, out=torch.empty((E + 1, n), dtype=torch.float32, device=device))
    with pytest.raises(ValueError, match="contiguous"):
        kernel(source, idx, w, fn, out=torch.empty((n, E), dtype=torch.float32, device=device).t())


def launch_counts():
    return window_reduce.launches, window_select.launches, csr_matvec.launches


def test_new_regridders_on_cuda_match_cpu(device):
    """CentroidLocatorRegridder launches no kernel and gathers the same
    bits; BarycentricInterpolator sorts its tessellation on the card into
    the same weights and launches only window_reduce; NetworkGridder's
    mean launches window_reduce and its mode window_select."""
    rng = np.random.default_rng(4)
    (verts, faces), (tverts, tfaces) = chip_smoke.bench_meshes(150, 40, rng)
    mesh = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    raster = xt.Ugrid2d(tverts[:, 0], tverts[:, 1], -1, tfaces)
    data = {g: torch.from_numpy(rng.normal(size=(3, g.n_face))) for g in (mesh, raster)}
    for source, target in ((mesh, raster), (raster, mesh)):
        centroid = xt.CentroidLocatorRegridder(source, target)
        before = launch_counts()
        on_card = centroid.regrid(data[source].numpy())
        assert on_card.device == device and launch_counts() == before
        assert torch.equal(on_card.cpu().nan_to_num(7.0), centroid.regrid(data[source]).nan_to_num(7.0))
        sorted_on_card = xt.BarycentricInterpolator(source, target)
        on_host = xt.BarycentricInterpolator(source, target, device="cpu")
        (r1, c1, w1), (r2, c2, w2) = (chip_smoke.sorted_triplets(r._weights) for r in (sorted_on_card, on_host))
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_allclose(w1, w2, rtol=1e-12, atol=0)
        before = launch_counts()
        out = sorted_on_card.regrid(data[source].to(device))
        assert launch_counts() == (before[0] + 1, before[1], before[2])
        torch.testing.assert_close(out.cpu(), on_host.regrid(data[source]), rtol=1e-12, atol=1e-12, equal_nan=True)
    nodes, edges = chip_smoke.random_network(10, 300, 150.0, rng)
    network = xt.Ugrid1d(nodes[:, 0], nodes[:, 1], -1, edges)
    values = torch.from_numpy(np.round(rng.normal(size=(3, len(edges))) * 2.0) / 2.0)
    for method, rose in (("mean", (1, 0, 0)), ("mode", (0, 1, 0))):
        gridder = xt.NetworkGridder(network, mesh, method=method)
        before = launch_counts()
        out = gridder.regrid(values.to(device))
        assert tuple(a - b for a, b in zip(launch_counts(), before)) == rose
        torch.testing.assert_close(out.cpu(), gridder.regrid(values), rtol=1e-12, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("E", [1, 20, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_window_reduce_at_tessellation_windows(device, dtype, E):
    """window_reduce on windows of at most 6 slots, as the barycentric
    weights give it: at E = 20 the whole tile of 256 targets is staged,
    a block shape the wider windows of the other tests never take."""
    rng = np.random.default_rng(E)
    indices, weights, mixed, _ = chip_smoke.synthetic_windows(rng, n=3001, m=2000, w=40, n_extra=E)
    idx = torch.from_numpy(np.ascontiguousarray(indices[:, :6])).to(device)
    wt = torch.from_numpy(np.ascontiguousarray(weights[:, :6])).to(device=device, dtype=dtype)
    source = torch.from_numpy(mixed).to(device=device, dtype=dtype)
    rtol, atol = chip_smoke.tolerance(dtype, float(np.nanmax(np.abs(np.where(np.isfinite(mixed), mixed, np.nan)))))
    for fn in (reduce.mean, reduce.sum, reduce.minimum, reduce.max_overlap):
        got = window_reduce(source, idx, wt, fn)
        want = reduce.reduce_windows(source.t(), idx, wt, fn).t()
        bound = atol
        if fn in LINEAR:
            bound = torch.clamp(chip_smoke.summation_bound(source, idx, wt, fn), min=atol)
        chip_smoke.compare(got, want, fn in EXACT, rtol, bound)


@pytest.mark.parametrize("E", [1, 2, 3, 8, 12, 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_csr_matvec_matches_plain(device, dtype, E):
    """Bit for bit, the plain version summing in the kernel's (CSR)
    order, on rows of 0 to 40 entries; two launches give the same bits."""
    rng = np.random.default_rng(E)
    indptr, indices, data = chip_smoke.synthetic_csr(rng)
    x = rng.normal(size=(4000, E))
    args = [torch.from_numpy(a).to(device) for a in (indptr, indices)] + [
        torch.from_numpy(a).to(device=device, dtype=dtype) for a in (data, x)
    ]
    before = csr_matvec.launches
    got = csr_matvec(*args)
    assert csr_matvec.launches == before + 1
    assert torch.equal(got, csr_matvec(*args))
    assert torch.equal(got, csr_matvec_plain(*args))


def test_csr_matvec_checks_its_tensors(device):
    indptr = torch.tensor([0, 1, 2], dtype=torch.int32, device=device)
    indices = torch.tensor([0, 1], dtype=torch.int32, device=device)
    data = torch.ones(2, device=device)
    x = torch.ones((2, 1), device=device)
    with pytest.raises(TypeError, match="int32"):
        csr_matvec(indptr.long(), indices, data, x)
    with pytest.raises(TypeError, match="differs"):
        csr_matvec(indptr, indices, data.double(), x)
    with pytest.raises(TypeError, match="float32 or float64"):
        csr_matvec(indptr, indices, data.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        csr_matvec(indptr, indices, data, torch.ones((2, 2), device=device).t())
    with pytest.raises(ValueError, match="CUDA device"):
        csr_matvec(indptr.cpu(), indices, data, x)


def test_laplace_on_cuda_matches_cpu(device):
    nodes, faces = chip_smoke.delaunay_mesh(76)
    grid = xt.Ugrid2d(nodes[:, 0], nodes[:, 1], -1, faces)
    W = grid.get_connectivity_matrix(grid.node_dimension, xy_weights=True)
    truth, values = chip_smoke.laplace_inputs(nodes, 0.05)
    stack = np.stack([values, 2.0 * values])
    before = csr_matvec.launches
    on_card = interpolate.laplace_interpolate(stack, W, atol=1e-10, maxiter=2000)
    info = dict(interpolate.last_solve_info)
    assert csr_matvec.launches - before == 1 + 3 + 4 * info["iterations"]
    on_cpu = interpolate.laplace_interpolate(stack, W, atol=1e-10, maxiter=2000, device="cpu")
    np.testing.assert_allclose(on_card, on_cpu, rtol=0.0, atol=1e-8)
    with pytest.raises(ValueError, match="b holds NaN or inf"):
        interpolate.laplace_interpolate(np.where(np.isnan(values), values, np.inf), W)


def test_overlap_geometry_above_the_native_caps_on_the_card(device):
    """Overlap areas of 40- and 120-node faces on the card: against the
    native padded clip where it takes the face (its buffer cut to 40
    columns) and against the same torch geometry on the CPU; the
    OverlapRegridder entry point takes that path on the card."""
    from xugrid_tpu_torch.spatial import celltree, geometry
    from xugrid_tpu_torch.spatial.bvh import face_bounding_boxes
    from xugrid_tpu_torch.utils import native

    nodes, faces, n_nodes = chip_smoke.overcap_mesh(20)
    mesh = xt.Ugrid2d(nodes[:, 0], nodes[:, 1], -1, faces[:4])
    tverts, tfaces = chip_smoke.quad_mesh(16, 16, dx=40.0 / 16)
    boxes = face_bounding_boxes(tfaces, tverts[:, 0], tverts[:, 1])
    qi, ti = mesh.celltree.grid_hash.query_boxes(boxes)
    query_xy = geometry.pad_polygons(tfaces, tverts[:, 0], tverts[:, 1])
    tree_xy = mesh.celltree._poly_xy_host
    on_card = celltree.overlap_areas_device(qi, ti, query_xy, tree_xy, device)
    on_cpu = celltree.overlap_areas_device(qi, ti, query_xy, tree_xy, "cpu")
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-9, atol=1e-10)
    small = n_nodes[ti] <= 40
    cut = np.ascontiguousarray(tree_xy[:, :40])
    host = native.polygon_clip_areas_native(qi[small], ti[small], query_xy, cut)
    np.testing.assert_allclose(on_card[small], host, rtol=1e-9, atol=1e-10)
    w = xt.OverlapRegridder(mesh, xt.Ugrid2d(tverts[:, 0], tverts[:, 1], -1, tfaces), device=device)._weights
    np.testing.assert_allclose(np.bincount(w.indices, weights=w.data, minlength=4), mesh.area, rtol=1e-9)


def test_mean_value_weights_above_the_native_cap_on_the_card(device):
    from xugrid_tpu_torch.spatial import celltree

    nodes, faces, _ = chip_smoke.overcap_mesh(20)
    mesh = xt.Ugrid2d(nodes[:, 0], nodes[:, 1], -1, faces[:4])
    rng = np.random.default_rng(2)
    points = np.concatenate([rng.uniform(0.0, 40.0, (3000, 2)), nodes[-120:][:3]])
    face, weights = mesh.compute_barycentric_weights(points, device=device)
    on_cpu = celltree.mean_value_weights_device(
        points, face, mesh.celltree._poly_xy_host, mesh.celltree.default_tolerance(), "cpu"
    )
    assert (face >= 0).sum() > 300
    # Points close to an edge of a 120-node face weigh ill-conditioned:
    # a sum in another order moves a weight by up to 1e-9 there.
    np.testing.assert_allclose(weights, on_cpu, rtol=0, atol=1e-9)
    np.testing.assert_allclose(weights[face >= 0].sum(axis=1), 1.0, rtol=0, atol=1e-12)


def test_labelled_regrid_on_the_card(device):
    """A UgridDataArray on the card onto a raster DataArray and back: the
    payloads stay on the card and match the CPU path."""
    rng = np.random.default_rng(3)
    (verts, faces), _ = chip_smoke.bench_meshes(40, 4, rng)
    grid = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    values = rng.normal(size=(5, grid.n_face)).astype(np.float32)
    uda = xt.UgridDataArray(xt.xdata.DataArray(torch.from_numpy(values).to(device), dims=("time", grid.face_dimension)), grid)
    target = chip_smoke.raster_dataarray(16, np.zeros((16, 16), np.float32), extent=40.0)
    for cls, method in ((xt.OverlapRegridder, "mean"), (xt.OverlapRegridder, "mode"), (xt.BarycentricInterpolator, None)):
        kwargs = {} if method is None else {"method": method}
        regridder = cls(uda, target, **kwargs)
        out = regridder.regrid(uda)
        assert out.dims == (uda.dims[0], "y", "x") and out.data.device.type == "cuda"
        on_cpu = regridder.regrid(xt.UgridDataArray(uda.obj.copy(data=torch.from_numpy(values)), grid))
        chip_smoke.compare(out.data, on_cpu.data, method == "mode", 1e-5, 1e-6)
        back = xt.BarycentricInterpolator(out, uda).regrid(out)
        assert isinstance(back, xt.UgridDataArray) and back.data.device.type == "cuda"


def test_accessor_fill_on_the_card(device):
    nodes, faces = chip_smoke.delaunay_mesh(40)
    grid = xt.Ugrid2d(nodes[:, 0], nodes[:, 1], -1, faces)
    truth, values = chip_smoke.laplace_inputs(nodes, 0.05)
    stack = np.stack([values, 2.0 * values, 3.0 * values])
    uda = xt.UgridDataArray(xt.xdata.DataArray(torch.from_numpy(stack).to(device), dims=("time", grid.node_dimension)), grid)
    before = csr_matvec.launches
    filled = uda.ugrid.laplace_interpolate(atol=1e-10, maxiter=2000)
    assert csr_matvec.launches - before == 1 + 3 + 4 * interpolate.last_solve_info["iterations"]
    assert filled.data.device.type == "cuda" and filled.data.dtype == torch.float64
    on_cpu = xt.UgridDataArray(uda.obj.copy(data=torch.from_numpy(stack)), grid).ugrid.laplace_interpolate(
        atol=1e-10, maxiter=2000, device="cpu"
    )
    np.testing.assert_allclose(filled.values, on_cpu.values, rtol=0, atol=1e-8)


def test_loaded_regridder_on_the_card_is_bit_equal_to_the_fresh_one(device, tmp_path):
    """Weights stored to netCDF and reloaded regrid a CUDA payload through
    the same kernel, one launch per pass, bit for bit as the fresh
    regridder."""
    rng = np.random.default_rng(4)
    (verts, faces), _ = chip_smoke.bench_meshes(40, 4, rng)
    grid = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    values = torch.from_numpy(rng.normal(size=(5, grid.n_face)).astype(np.float32)).to(device)
    uda = xt.UgridDataArray(xt.xdata.DataArray(values, dims=("time", grid.face_dimension)), grid)
    target = chip_smoke.raster_dataarray(16, np.zeros((16, 16), np.float32), extent=40.0)
    for cls, method, kernel in (
        (xt.OverlapRegridder, "mean", window_reduce),
        (xt.OverlapRegridder, "mode", window_select),
        (xt.BarycentricInterpolator, None, window_reduce),
    ):
        kwargs = {} if method is None else {"method": method}
        fresh = cls(uda, target, **kwargs)
        fresh.to_dataset().to_netcdf(tmp_path / "weights.nc")
        loaded = cls.from_dataset(xt.xdata.open_dataset(tmp_path / "weights.nc"), **kwargs)
        before = kernel.launches
        out = loaded.regrid(uda)
        assert kernel.launches == before + 1 and out.data.device.type == "cuda"
        assert torch.equal(out.data.nan_to_num(-7.0), fresh.regrid(uda).data.nan_to_num(-7.0))


def test_cuda_payload_writes_and_reads_back(device, tmp_path):
    rng = np.random.default_rng(5)
    (verts, faces), _ = chip_smoke.bench_meshes(20, 4, rng)
    grid = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    values = torch.from_numpy(rng.normal(size=(3, grid.n_face)).astype(np.float32)).to(device)
    times = np.array(["2021-01-01", "2021-01-02", "2021-01-03"], dtype="datetime64[ns]")
    uda = xt.UgridDataArray(
        xt.xdata.DataArray(values, dims=("time", grid.face_dimension), coords={"time": times}, name="v"), grid
    )
    uda.ugrid.to_netcdf(tmp_path / "mesh.nc")
    uda.ugrid.to_zarr(tmp_path / "mesh.zarr")
    assert uda.data.device.type == "cuda"
    for opened in (xt.open_dataset(tmp_path / "mesh.nc"), xt.open_zarr(tmp_path / "mesh.zarr")):
        back = opened["v"]
        assert isinstance(back.data, np.ndarray)
        np.testing.assert_array_equal(back.values, values.cpu().numpy())
        np.testing.assert_array_equal(back.obj["time"].values, times)
        np.testing.assert_array_equal(opened.grid.face_node_connectivity, grid.face_node_connectivity)


def test_row_grouping_on_the_card_matches_the_host_hash(device):
    from xugrid_tpu_torch.core.dedup import unique_rows

    rng = np.random.default_rng(12)
    base = rng.normal(size=(3000, 2))
    other_nan = np.array([0x7FF8000000000001], dtype=np.uint64).view(np.float64)[0]
    for rows in (
        base[rng.integers(0, 3000, 40_000)],
        rng.integers(0, 60, (50_000, 4)),
        np.array([[0.0, 1.0], [-0.0, 1.0], [np.nan, 2.0], [other_nan, 2.0], [np.nan, 2.0]]),
    ):
        want_index, want_inverse = unique_rows(rows)
        got_index, got_inverse = unique_rows(rows, device=device)
        np.testing.assert_array_equal(got_index, want_index)
        np.testing.assert_array_equal(got_inverse, want_inverse)


def test_merge_partitions_keeps_a_cuda_payload(device):
    rng = np.random.default_rng(13)
    (verts, faces), _ = chip_smoke.bench_meshes(20, 4, rng)
    grid = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    grid.edge_node_connectivity
    values = {
        "face_v": (("time", grid.face_dimension), rng.normal(size=(3, grid.n_face)).astype(np.float32)),
        "node_v": ((grid.node_dimension,), rng.normal(size=grid.n_node)),
        "edge_v": ((grid.edge_dimension,), rng.normal(size=grid.n_edge)),
    }
    merged = {}
    for where in ("cpu", device):
        ds = xt.xdata.Dataset({k: (dims, torch.from_numpy(v).to(where)) for k, (dims, v) in values.items()})
        parts = xt.UgridDataset(ds, grids=[grid]).ugrid.partition(n_part=4)
        assert all(p.obj["face_v"].data.device.type == torch.device(where).type for p in parts)
        merged[str(where)] = xt.merge_partitions(parts)
    on_card, on_host = merged[str(device)], merged["cpu"]
    np.testing.assert_array_equal(on_card.grid.face_node_connectivity, on_host.grid.face_node_connectivity)
    for name in values:
        assert on_card.obj[name].data.device.type == "cuda"
        assert torch.equal(on_card.obj[name].data.cpu(), on_host.obj[name].data)


def test_nearest_scan_on_the_card(device):
    """The nearest scan on the card: the CPU scan's indices (or an
    equidistant source), ties to the lowest index, a payload's
    ``sel_points`` and ``interpolate_na`` kept on the card."""
    from scipy.spatial import KDTree

    from xugrid_tpu_torch.spatial import nearest

    rng = np.random.default_rng(3)
    sources = rng.uniform(0.0, 100.0, (3 * nearest.TILE + 11, 2))
    sources[5] = sources[2]
    queries = np.concatenate([rng.uniform(-5.0, 105.0, (500, 2)), sources[[2, 5]]])
    d2, idx = nearest.nearest_scan(queries, sources, device)
    assert idx.device.type == "cuda"
    idx = idx.cpu().numpy()
    want = KDTree(sources).query(queries)[1]
    diff = idx != want
    np.testing.assert_allclose(
        np.linalg.norm(sources[idx[diff]] - queries[diff], axis=1),
        np.linalg.norm(sources[want[diff]] - queries[diff], axis=1), rtol=1e-5,
    )
    assert idx[-2] == idx[-1] == 2
    (verts, faces), _ = chip_smoke.bench_meshes(12, 2, rng)
    grid = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    values = rng.normal(size=(2, grid.n_face))
    values[:, ::4] = np.nan
    uda = xt.UgridDataArray(xt.xdata.DataArray(torch.from_numpy(values).to(device), dims=("t", grid.face_dimension)),
                            grid)
    assert uda.ugrid.interpolate_na().data.device == device
    assert uda.ugrid.sel_points(x=[1.5, 7.2], y=[3.3, 9.1]).data.device == device


def test_topology_operations_keep_a_cuda_payload(device):
    """The topology operations of the accessor on a CUDA payload: each
    result on the card and equal to the same call on the CPU; the
    tessellation sorted on the card equal to the one sorted on the CPU."""
    rng = np.random.default_rng(8)
    (verts, faces), _ = chip_smoke.bench_meshes(100, 2, rng)
    grid = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    grid.edge_node_connectivity
    wet = rng.random(grid.n_face) < 0.7
    mask = rng.random(grid.n_face) < 0.1
    values = rng.normal(size=(3, grid.n_face))
    results = {}
    for where in (device, torch.device("cpu")):
        wet_uda = xt.UgridDataArray(
            xt.xdata.DataArray(torch.from_numpy(wet).to(where), dims=(grid.face_dimension,)), grid
        )
        uda = xt.UgridDataArray(
            xt.xdata.DataArray(torch.from_numpy(values).to(where), dims=("t", grid.face_dimension)), grid
        )
        periodic = uda.ugrid.to_periodic()
        results[where.type] = [
            wet_uda.ugrid.binary_dilation(iterations=3, mask=torch.from_numpy(mask).to(where), border_value=True),
            wet_uda.ugrid.binary_erosion(iterations=3),
            wet_uda.ugrid.connected_components(),
            uda.ugrid.reverse_cuthill_mckee(),
            periodic,
            periodic.ugrid.to_nonperiodic(xmax=100.0),
        ]
    for on_card, on_host in zip(results["cuda"], results["cpu"]):
        assert on_card.data.device == device
        assert torch.equal(on_card.data.cpu(), on_host.data)
    card = grid.tesselate_centroidal_voronoi(device=device)
    host = grid.tesselate_centroidal_voronoi(device="cpu")
    np.testing.assert_array_equal(card.face_node_connectivity, host.face_node_connectivity)
    np.testing.assert_array_equal(card.node_x, host.node_x)


def payload_arrays(rng, shape=(7, 300)):
    """(time, face) float32 with NaN, half-step ties and an all-NaN column."""
    values = (np.round(rng.normal(size=shape) * 2.0) / 2.0).astype(np.float32)
    values[rng.random(shape) < 0.1] = np.nan
    values[:, 5] = np.nan
    return values


def test_payload_methods_on_cuda_match_cpu(device):
    """Quantile, rank, idxmax/idxmin (ties and NaN: the first extreme on
    both), cumsum, ffill, bfill and interpolate_na of a CUDA payload
    against the same methods on the CPU: bit for bit, but cumsum, whose
    order differs (float32 summation bound) and the quantile (float64 rtol
    1e-12)."""
    values = payload_arrays(np.random.default_rng(3))
    coords = {"time": np.cumsum(np.random.default_rng(4).uniform(0.5, 1.5, values.shape[0]))}
    on = {
        where: tx_array(values, coords, where)
        for where in (device, torch.device("cpu"))
    }
    exact = {
        "rank": lambda da: da.rank("time"),
        "idxmax": lambda da: da.idxmax("time"),
        "idxmin": lambda da: da.idxmin("time"),
        "argmax face": lambda da: da.argmax("face"),
        "idxmax no skipna": lambda da: da.idxmax("time", skipna=False),
        "ffill": lambda da: da.ffill("time", limit=2),
        "bfill": lambda da: da.bfill("time"),
        "interpolate_na": lambda da: da.interpolate_na("time"),
        "nearest": lambda da: da.interpolate_na("time", method="nearest", fill_value="extrapolate"),
        "extrapolate": lambda da: da.interpolate_na("time", fill_value="extrapolate"),
        "shift": lambda da: da.shift(time=2),
        "count": lambda da: da.count("time"),
    }
    for label, f in exact.items():
        got, want = f(on[device]), f(on[torch.device("cpu")])
        assert got.data.device == device, label
        assert got.data.dtype == want.data.dtype, label
        np.testing.assert_array_equal(got.values, want.values, err_msg=label)
    for q in (0.5, [0.1, 0.9]):
        got, want = (on[w].quantile(q, "time") for w in (device, torch.device("cpu")))
        assert got.data.device == device and got.data.dtype == torch.float64
        np.testing.assert_allclose(got.values, want.values, rtol=1e-12, atol=0)
    got, want = (on[w].cumsum("time") for w in (device, torch.device("cpu")))
    magnitude = np.cumsum(np.nan_to_num(np.abs(values.astype(np.float64))), axis=0)
    np.testing.assert_array_equal(np.isnan(got.values), np.isnan(want.values))
    ok = ~np.isnan(want.values)
    assert (np.abs(got.values - want.values)[ok] <= 2 * values.shape[0] * 2.0**-24 * magnitude[ok]).all()


def tx_array(values, coords, where):
    return xt.xdata.DataArray(torch.from_numpy(values).to(where), coords=coords, dims=("time", "face"), name="h")


def test_dot_in_float32_excludes_tf32(device):
    """A float32 contraction where TF32's 10-bit mantissa would lose the
    2^-12 parts: with TF32 allowed globally, ``dot`` still gives the IEEE
    float32 result (within the float32 summation bound of float64)."""
    n = 64
    a = np.full((n, 256), 1.0 + 2.0**-12, dtype=np.float32)
    b = np.full(n, 1.0 + 2.0**-11, dtype=np.float32)
    da = xt.xdata.DataArray(torch.from_numpy(a).to(device), dims=("time", "face"))
    db = xt.xdata.DataArray(torch.from_numpy(b).to(device), dims=("time",))
    exact = a.astype(np.float64).T @ b.astype(np.float64)
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = da.dot(db)
        tf32 = torch.einsum("tf,t->f", da.data, db.data)
    finally:
        torch.set_float32_matmul_precision(previous)
    assert torch.get_float32_matmul_precision() == previous
    assert got.data.device == device and got.data.dtype == torch.float32
    bound = n * 2.0**-24 * exact
    assert (np.abs(got.values - exact) <= bound).all()
    # The unpinned product on this card: either TF32 (far off) or IEEE.
    print("unpinned einsum |diff|:", float(np.abs(tf32.cpu().numpy() - exact).max()), "bound", float(bound.max()))


def test_network_fill_on_the_card_matches_cpu(device):
    """The Laplace fill of node data on a network (two random-walk lines
    and one without a known node): csr_matvec on the card, the formula's
    launches, equal to the fill on the CPU within 1e-8, the line without a
    known node NaN."""
    rng = np.random.default_rng(9)
    nodes, edges = chip_smoke.random_network(3, 200, 100.0, rng)
    grid = xt.Ugrid1d(nodes[:, 0], nodes[:, 1], -1, edges)
    truth, values = chip_smoke.laplace_inputs(grid.node_coordinates, 0.05)
    values[:201] = np.nan
    out = {}
    for where in (device, torch.device("cpu")):
        uda = xt.UgridDataArray(
            xt.xdata.DataArray(torch.from_numpy(values).to(where), dims=(grid.node_dimension,)), grid
        )
        before = csr_matvec.launches
        out[where.type] = uda.ugrid.laplace_interpolate(atol=1e-10, maxiter=2000, device=where)
        info = interpolate.last_solve_info
        if where.type == "cuda":
            assert csr_matvec.launches - before == 1 + (info["degree"] - 1) + info["iterations"] * info["degree"]
    assert out["cuda"].data.device == device
    got, want = out["cuda"].values, out["cpu"].values
    assert np.isnan(got[:201]).all() and np.isfinite(got[201:]).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


def test_bvh_queries_on_the_card_match_cpu(device):
    """Every function of ``spatial/queries.py`` on the card equals its CPU
    result: ids, flags and counts equal, clip parameters, areas and
    weights within rtol 1e-12."""
    from xugrid_tpu_torch.spatial import build_bvh, queries
    from xugrid_tpu_torch.spatial.bvh import face_bounding_boxes
    from xugrid_tpu_torch.spatial.geometry import pad_polygons

    rng = np.random.default_rng(5)
    (verts, faces), _ = chip_smoke.bench_meshes(30, 4, rng)
    poly = pad_polygons(faces, verts[:, 0], verts[:, 1])
    boxes = face_bounding_boxes(faces, verts[:, 0], verts[:, 1])
    host = build_bvh(boxes, 8)
    depth = host.n_leaves.bit_length() - 1
    points = rng.uniform(-1.0, 31.0, (3000, 2))
    lo = rng.uniform(-1.0, 30.0, (500, 2))
    qboxes = np.column_stack([lo, lo + rng.uniform(0.0, 3.0, (500, 2))])
    edge_xy = poly[:200, :2]
    edge_host = build_bvh(np.concatenate([edge_xy.min(axis=1), edge_xy.max(axis=1)], axis=1), 4)
    edge_depth = edge_host.n_leaves.bit_length() - 1
    pairs = rng.integers(-1, len(faces), 3000)
    p0 = rng.uniform(0.0, 30.0, (300, 2))
    p1 = p0 + rng.normal(0.0, 4.0, (300, 2))
    cands = rng.integers(-1, len(faces), (300, 6))

    def run(dev):
        tree = queries.bvh_to_device(host, device=dev)
        P = torch.from_numpy(poly).to(dev)
        pts = torch.from_numpy(points).to(dev)
        capacity = 12
        return {
            "locate": queries.locate_points_kernel(pts, tree, P, host.n_internal, 8, depth, 2, 1e-9),
            "while": queries.locate_points_while_kernel(pts, tree, P, host.n_internal, 8, 1e-9),
            "edges": queries.locate_points_on_edges_kernel(
                pts, queries.bvh_to_device(edge_host, device=dev), torch.from_numpy(edge_xy).to(dev),
                edge_host.n_internal, 4, edge_depth, 4, 0.05,
            ),
            "boxes": queries.box_candidates_kernel(qboxes, tree, boxes, host.n_internal, 8, depth, 4),
            "count": queries.count_box_overlaps_kernel(qboxes, tree, boxes, host.n_internal, 8),
            "emit": queries.emit_box_overlaps_kernel(qboxes, tree, boxes, host.n_internal, 8, capacity),
            "pip": queries.points_in_polygons_kernel(pts, pairs, P, 1e-9),
            "tri": queries.points_in_triangles_kernel(pts, pairs, P[:, :3], 1e-9),
            "clip": queries.clip_segments_by_faces_kernel(p0, p1, cands, P),
            "areas": queries.polygon_overlap_areas_kernel(pairs[:500], pairs[500:1000], P, P + 0.3),
            "weights": queries.barycentric_weights_kernel(torch.from_numpy(poly.mean(1)).to(dev),
                                                          np.arange(len(faces)), P, 1e-9),
        }

    cpu, card = run("cpu"), run(device)
    for key in cpu:
        want = cpu[key] if isinstance(cpu[key], tuple) else (cpu[key],)
        got = card[key] if isinstance(card[key], tuple) else (card[key],)
        for w, g in zip(want, got):
            assert g.device.type == "cuda", key
            if w.dtype.is_floating_point:
                torch.testing.assert_close(g.cpu(), w, rtol=1e-12, atol=1e-14, msg=key)
            else:
                assert torch.equal(g.cpu(), w), key
