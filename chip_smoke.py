"""
Runs the PyTorch port (``xugrid_tpu_torch``) on one CUDA card and checks
it end to end.

    python3 chip_smoke.py

Phases:

1. The card's name and power limit, the versions, and the build of the
   two CUDA kernels (nvcc, sm_90a) and of the native host library from
   the sources in this checkout.
2. Each kernel against its plain PyTorch version on the card, for every
   method, in float32 and float64, on windows with NaN, +-inf, zeros,
   negative values, zero weights and more than 32 slots.
3. The main path at the 1M-face config of ``bench.py``: a jittered
   1000 x 1000 quad mesh regridded onto a 512 x 512 raster, 20 extra
   slices of float32, through ``OverlapRegridder`` (mean, median, mode)
   and ``RelativeOverlapRegridder`` (first_order_conservative).  The
   launch counters show which kernel ran; each output is held against
   the plain version on the card and against an independent host
   reference (scipy CSR products for the linear methods, numpy
   percentiles and weighted modes on a sample of targets).
4. Kernel, plain, full-apply and source-transpose times at E = 20 and
   E = 128 (CUDA events, median of passes after warm-up), with true
   bytes per pass, GB/s and the share of the card's measured copy
   bandwidth.

Prints one JSON line describing the kernels, then, as the last line,
``{"ok": true, "device": {...}}``.  Any failure raises (non-zero exit);
without a CUDA device it exits with 2 and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

N_SIDE, T_SIDE, N_EXTRA = 1000, 512, 20
TIMING_EXTRAS = (20, 128)


def quad_mesh(nx, ny, dx=1.0):
    """Nodes and (n, 4) faces of an nx by ny quad mesh of cell size dx."""
    x = np.arange(nx + 1.0) * dx
    y = np.arange(ny + 1.0) * dx
    yy, xx = np.meshgrid(y, x, indexing="ij")
    verts = np.column_stack([xx.ravel(), yy.ravel()])
    j, i = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    nid = lambda ii, jj: jj * (nx + 1) + ii  # noqa: E731
    faces = np.stack(
        [nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)], axis=-1
    ).reshape(-1, 4)
    return verts, faces


def bench_meshes(n_side, t_side, rng):
    """The bench config's meshes: an n_side^2 quad mesh with interior
    nodes jittered by +-0.15, and a t_side^2 raster over the same extent."""
    verts, faces = quad_mesh(n_side, n_side)
    jitter = rng.uniform(-0.15, 0.15, verts.shape)
    edge = (
        (verts[:, 0] == 0) | (verts[:, 1] == 0)
        | (verts[:, 0] == n_side) | (verts[:, 1] == n_side)
    )
    jitter[edge] = 0.0
    verts = verts + jitter
    tverts, tfaces = quad_mesh(t_side, t_side, dx=n_side / t_side)
    return (verts, faces), (tverts, tfaces)


def synthetic_windows(rng, n=4000, m=3000, w=40, n_extra=6):
    """PaddedCSR-style windows and two sources for the kernel checks.

    Windows are ragged (1-12 slots, 5 % of them 33-40 slots), 2 % are
    empty, 2 % have only zero weights, and 5 % of the slots have weight
    zero.  The mixed source is normal (half of it rounded to 0.5 steps,
    so windows hold equal values) with 10 % NaN, 1 % +inf, 1 % -inf and
    5 % zeros; the positive source is its absolute value."""
    base = (np.arange(n) * m) // n
    indices = np.clip(base[:, None] + rng.integers(-20, 21, size=(n, w)), 0, m - 1)
    widths = rng.integers(1, 13, size=n)
    wide = rng.random(n) < 0.05
    widths[wide] = rng.integers(33, w + 1, size=int(wide.sum()))
    in_window = np.arange(w)[None, :] < widths[:, None]
    indices = np.where(in_window, indices, -1).astype(np.int32)
    indices[rng.random(n) < 0.02] = -1
    weights = rng.uniform(0.1, 2.0, size=(n, w))
    weights[rng.random((n, w)) < 0.05] = 0.0
    weights[rng.random(n) < 0.02] = 0.0
    weights[indices < 0] = 0.0
    source = rng.normal(size=(n_extra, m))
    source[:, : m // 2] = np.round(source[:, : m // 2] * 2.0) / 2.0
    u = rng.random(source.shape)
    source[u < 0.10] = np.nan
    source[(u >= 0.10) & (u < 0.11)] = np.inf
    source[(u >= 0.11) & (u < 0.12)] = -np.inf
    source[(u >= 0.12) & (u < 0.17)] = 0.0
    return indices, weights, source, np.abs(source)


def compare(got, want, exact, rtol, atol):
    """Hold ``got`` to ``want``: the same NaN and inf positions, finite
    values bit-equal (``exact``) or within atol + rtol * |want| (``atol``
    a number, or a tensor of the shape of ``want``).
    Returns the largest absolute difference of the finite values."""
    import torch

    g = got.double().cpu()
    w = want.double().cpu()
    if g.shape != w.shape:
        raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    if not torch.equal(torch.isnan(g), torch.isnan(w)):
        raise AssertionError(f"NaN masks differ at {int((torch.isnan(g) != torch.isnan(w)).sum())} outputs")
    if not torch.equal(torch.isinf(g), torch.isinf(w)) or not torch.equal(g[torch.isinf(g)], w[torch.isinf(w)]):
        raise AssertionError("inf positions or signs differ")
    finite = torch.isfinite(w)
    err = (g[finite] - w[finite]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if exact:
        if max_err != 0.0:
            raise AssertionError(f"not bit-equal: max |diff| {max_err}")
    else:
        if isinstance(atol, torch.Tensor):
            atol = atol.double().cpu()[finite]
        bad = err > atol + rtol * w[finite].abs()
        if bool(bad.any()):
            raise AssertionError(
                f"{int(bad.sum())} outputs beyond rtol {rtol} / atol {atol}: max |diff| {max_err}"
            )
    return max_err


def tolerance(dtype, scale):
    """(rtol, atol) of a kernel against its plain version: float32 at
    rtol 1e-5 / atol 1e-6 * max|source|, float64 at rtol 1e-12 / atol
    1e-12 * max|source|.  The two sum in different orders, so a result
    that cancels to near zero keeps only an absolute agreement."""
    import torch

    if dtype == torch.float32:
        return 1e-5, 1e-6 * scale
    return 1e-12, 1e-12 * scale


def summation_bound(sourceT, idx, w, fn):
    """Order-independent error bound of a window sum of up to w_max
    terms: w_max * unit roundoff * (the same reduction of |source|).
    Wide windows of mixed signs can cancel below the fixed atol."""
    import torch

    from xugrid_tpu_torch.regrid import reduce

    unit = 2.0**-24 if sourceT.dtype == torch.float32 else 2.0**-53
    magnitude = reduce.reduce_windows(sourceT.abs(), idx, w, fn)
    return idx.shape[1] * unit * magnitude


def card_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def phase_build():
    import torch

    from xugrid_tpu_torch.utils import build, native

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build.kernel_library()
    t1 = time.perf_counter()
    if native.get_lib() is None:
        raise RuntimeError("the native host library did not build")
    t2 = time.perf_counter()
    print(f"build: CUDA kernels {t1 - t0:.3f} s, host library {t2 - t1:.3f} s")
    log = (build.BUILD_DIR / "kernels.log").read_text().splitlines()
    for line in log:
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


def phase_kernel_checks(device):
    """Phase 2: every method of both kernels against the plain version."""
    import torch

    from xugrid_tpu_torch.regrid import reduce
    from xugrid_tpu_torch.regrid.aligned_apply import METHOD_CODES, window_reduce
    from xugrid_tpu_torch.regrid.select_apply import window_select

    percentiles = [reduce.Percentile(p) for p in (0, 5, 25, 50, 75, 95, 100, 33.3)]
    # Selections, mode and percentiles run the same arithmetic in the
    # same order in kernel and plain version, so they are held bit for
    # bit.  harmonic_mean runs on the positive source only: with mixed
    # signs its sum of w / v cancels without a bound that the summation
    # order leaves alone.
    exact = {reduce.minimum, reduce.maximum, reduce.max_overlap, reduce.mode, *percentiles}
    linear = {reduce.mean, reduce.sum, reduce.first_order_conservative}
    cases = [(fn, window_reduce) for fn in METHOD_CODES] + [
        (fn, window_select) for fn in (reduce.mode, *percentiles)
    ]
    rng = np.random.default_rng(7)
    indices, weights, mixed, positive = synthetic_windows(rng)
    print(f"phase 2: windows n={indices.shape[0]} w_max={indices.shape[1]}, sources (E, m)={mixed.shape}")
    max_err = {"window_reduce": 0.0, "window_select": 0.0}
    for dtype in (torch.float32, torch.float64):
        idx = torch.from_numpy(indices).to(device)
        w = torch.from_numpy(weights).to(device=device, dtype=dtype)
        for label, src in (("mixed", mixed), ("positive", positive)):
            sourceT = torch.from_numpy(src.T.copy()).to(device=device, dtype=dtype)
            scale = float(np.nanmax(np.abs(np.where(np.isfinite(src), src, np.nan))))
            rtol, atol = tolerance(dtype, scale)
            for fn, kernel in cases:
                if fn is reduce.harmonic_mean and label == "mixed":
                    continue
                got = kernel(sourceT, idx, w, fn)
                want = reduce.reduce_windows(sourceT, idx, w, fn)
                bound = atol
                if fn in linear:
                    bound = torch.clamp(summation_bound(sourceT, idx, w, fn), min=atol)
                torch.cuda.synchronize()
                err = compare(got, want, fn in exact, rtol, bound)
                max_err[kernel.__name__] = max(max_err[kernel.__name__], err)
                name = getattr(fn, "__name__", "")
                print(f"  {kernel.__name__} {name} {label} {str(dtype)[6:]}: ok, max |diff| {err:.3e}")
    return max_err


def reference_linear(csr, source, relative):
    """Independent host reference of mean (relative=False) and
    first_order_conservative (relative=True): scipy CSR products in
    float64, NaN sources masked out."""
    from scipy.sparse import csr_matrix

    W = csr_matrix((csr.data, csr.indices, csr.indptr), shape=(csr.n, csr.m))
    x = source.astype(np.float64).T
    valid = ~np.isnan(x)
    num = W @ np.where(valid, x, 0.0)
    den = W @ valid.astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        out = num if relative else num / den
    return np.where(den != 0.0, out, np.nan).T


def reference_select(csr, source, targets, method):
    """Independent host reference of median and mode for ``targets``:
    numpy percentiles (linear interpolation) and weighted modes with
    ties to the largest value.  Returns (E, len(targets))."""
    out = np.full((source.shape[0], len(targets)), np.nan)
    for col, t in enumerate(targets):
        lo, hi = csr.indptr[t], csr.indptr[t + 1]
        if hi == lo:
            continue
        cols, wts = csr.indices[lo:hi], csr.data[lo:hi]
        for e in range(source.shape[0]):
            vals = source[e, cols].astype(np.float64)
            ok = ~np.isnan(vals)
            if method == "median":
                if ok.any() and wts.max() > 0:
                    out[e, col] = np.percentile(vals[ok], 50.0)
            elif ok.any() and wts[ok].max() > 0:
                uniq = np.unique(vals[ok])
                totals = np.array([wts[ok][vals[ok] == u].sum() for u in uniq])
                out[e, col] = uniq[totals == totals.max()].max()
    return out


def phase_main_path(device):
    """Phase 3: the overlap regridders at the 1M-face config."""
    import torch

    import xugrid_tpu_torch as xt
    from xugrid_tpu_torch.regrid import reduce
    from xugrid_tpu_torch.regrid.aligned_apply import window_reduce
    from xugrid_tpu_torch.regrid.apply import device_weights
    from xugrid_tpu_torch.regrid.select_apply import window_select
    from xugrid_tpu_torch.utils.profiling import timings

    rng = np.random.default_rng(42)
    t0 = time.perf_counter()
    (verts, faces), (tverts, tfaces) = bench_meshes(N_SIDE, T_SIDE, rng)
    source_grid = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    target_grid = xt.Ugrid2d(tverts[:, 0], tverts[:, 1], -1, tfaces)
    print(f"phase 3: meshes {source_grid.n_face} -> {target_grid.n_face} faces in {time.perf_counter() - t0:.3f} s")
    data = rng.normal(size=(N_EXTRA, source_grid.n_face))
    data = (np.round(data * 2.0) / 2.0).astype(np.float32)
    data[rng.random(data.shape) < 0.01] = np.nan
    source = torch.from_numpy(data).to(device)
    torch.cuda.synchronize()

    runs = [
        (xt.OverlapRegridder, "mean", window_reduce),
        (xt.RelativeOverlapRegridder, "first_order_conservative", window_reduce),
        (xt.OverlapRegridder, "median", window_select),
        (xt.OverlapRegridder, "mode", window_select),
    ]
    kernels = (window_reduce, window_select)
    results = []
    timings.reset()
    for k in kernels:
        k.launches = 0
    for cls, method, kernel in runs:
        before = {k.__name__: k.launches for k in kernels}
        t0 = time.perf_counter()
        regridder = cls(source_grid, target_grid, method=method)
        t1 = time.perf_counter()
        out = regridder.regrid(source)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rose = {k.__name__: k.launches - before[k.__name__] for k in kernels}
        results.append((cls, method, kernel, regridder, out, rose, t1 - t0, t2 - t1))
    counts = {k.__name__: k.launches for k in kernels}

    print(f"  host weight-build stages: {json.dumps(timings.summary())}")
    max_err = {"window_reduce": 0.0, "window_select": 0.0}
    scale = float(np.nanmax(np.abs(data)))
    rtol, atol = tolerance(torch.float32, scale)
    sample = np.sort(rng.choice(target_grid.n_face, size=400, replace=False))
    for cls, method, kernel, regridder, out, rose, build_s, apply_s in results:
        name = kernel.__name__
        if rose[name] < 1 or sum(rose.values()) != rose[name]:
            raise AssertionError(f"{method}: expected launches of {name} only, counters rose by {rose}")
        if tuple(out.shape) != (N_EXTRA, target_grid.n_face) or out.dtype != torch.float32:
            raise AssertionError(f"{method}: output {tuple(out.shape)} {out.dtype}")
        finite = float(torch.isfinite(out).double().mean())
        if finite < 0.99:
            raise AssertionError(f"{method}: only {finite:.4f} of the outputs are finite")
        idx, w = device_weights(regridder._padded, torch.float32, source.device, regridder._device_weights)
        plain = reduce.reduce_windows(source.t().contiguous(), idx, w, regridder._reduction).t()
        exact = kernel is window_select
        err = compare(out, plain, exact, rtol, atol)
        max_err[name] = max(max_err[name], err)
        csr = regridder._weights
        out_np = out.double().cpu().numpy()
        if kernel is window_reduce:
            ref = reference_linear(csr, data, relative=method != "mean")
            ref_err = compare(torch.from_numpy(out_np), torch.from_numpy(ref), False, 1e-5, 1e-6 * scale)
        else:
            ref = reference_select(csr, data, sample, method)
            ref_err = compare(torch.from_numpy(out_np[:, sample]), torch.from_numpy(ref), False, 1e-5, 1e-6 * scale)
        checksum = float(np.nansum(out_np))
        print(
            f"  {cls.__name__}({method}): weights {build_s:.3f} s, nnz {csr.nnz}, "
            f"w_max {regridder._padded.w_max}; regrid {apply_s:.4f} s (first call) via {name} "
            f"(launches +{rose[name]}); vs plain max |diff| {err:.3e}; vs host reference "
            f"max |diff| {ref_err:.3e}; finite {finite:.6f}; checksum {checksum!r}"
        )
    return counts, max_err, results


def cuda_time_ms(fn, reps=10, warmup=2):
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def phase_timing(device, results, card):
    """Phase 4: kernel, plain, full-apply and transpose times at the 1M
    config.  The apply pass is the source's slice-minor transpose plus
    the kernel; the output stays a transposed view."""
    import torch

    from xugrid_tpu_torch.regrid import reduce
    from xugrid_tpu_torch.regrid.apply import apply_weights, device_weights

    buf = torch.empty(1 << 28, dtype=torch.float32, device=device)
    dst = torch.empty_like(buf)
    copy_ms = cuda_time_ms(lambda: dst.copy_(buf))
    copy_gbps = 2 * buf.numel() * 4 / (copy_ms * 1e-3) / 1e9
    del buf, dst
    print(f"phase 4 [{card}]: device copy {copy_gbps:.1f} GB/s (1 GiB copy_, {copy_ms:.4f} ms)")
    rng = np.random.default_rng(0)
    timed = {}
    for cls, method, kernel, regridder, *_ in results:
        csr = regridder._weights
        n, m = csr.n, csr.m
        idx, w = device_weights(regridder._padded, torch.float32, device, regridder._device_weights)
        for n_extra in TIMING_EXTRAS:
            source = torch.from_numpy(rng.normal(size=(n_extra, m)).astype(np.float32)).to(device)
            sourceT = source.t().contiguous()
            red = regridder._reduction
            true_bytes = csr.nnz * 8 + m * n_extra * 4 + n * n_extra * 4
            samples = {"kernel": [], "plain": []}
            # Interleave plain, kernel, kernel, plain.
            for which in ("plain", "kernel", "kernel", "plain"):
                if which == "kernel":
                    samples[which].append(cuda_time_ms(lambda: kernel(sourceT, idx, w, red), reps=5))
                else:
                    samples[which].append(cuda_time_ms(lambda: reduce.reduce_windows(sourceT, idx, w, red), reps=5))
            kernel_ms = statistics.median(samples["kernel"])
            plain_ms = statistics.median(samples["plain"])
            full_ms = cuda_time_ms(
                lambda: apply_weights(regridder._padded, source, red, n, cache=regridder._device_weights)
            )
            transpose_ms = cuda_time_ms(lambda: source.t().contiguous())
            for label, ms in (
                ("kernel", kernel_ms), ("plain", plain_ms), ("apply pass", full_ms),
                ("source transpose", transpose_ms),
            ):
                gbps = true_bytes / (ms * 1e-3) / 1e9
                print(
                    f"  {method} E={n_extra} {label} ({kernel.__name__}): {ms * 1e-3:.6f} s/pass, "
                    f"true bytes {true_bytes}, {gbps:.1f} GB/s, {100 * gbps / copy_gbps:.2f} % of copy "
                    f"[{card}]"
                )
            timed[(method, n_extra)] = (kernel_ms, plain_ms)
            del source, sourceT
            torch.cuda.empty_cache()
    return timed


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import xugrid_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    device = torch.device("cuda", 0)
    card = card_line()
    print(card)
    phase_build()
    check_err = phase_kernel_checks(device)
    counts, main_err, results = phase_main_path(device)
    timed = phase_timing(device, results, card)
    kernels = [
        {
            "name": "window_reduce",
            "route": "cuda",
            "source": "xugrid_tpu_torch/csrc/window_reduce.cu",
            "replaces": "xugrid_tpu/regrid/aligned_apply.py:1271",
            "launches": counts["window_reduce"],
            "max_abs_err": max(check_err["window_reduce"], main_err["window_reduce"]),
            "ms": timed[("mean", N_EXTRA)][0],
            "plain_ms": timed[("mean", N_EXTRA)][1],
        },
        {
            "name": "window_select",
            "route": "cuda",
            "source": "xugrid_tpu_torch/csrc/window_select.cu",
            "replaces": "xugrid_tpu/regrid/select_apply.py:804",
            "launches": counts["window_select"],
            "max_abs_err": max(check_err["window_select"], main_err["window_select"]),
            "ms": timed[("median", N_EXTRA)][0],
            "plain_ms": timed[("median", N_EXTRA)][1],
        },
    ]
    print(json.dumps({"kernels": kernels}))
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device_info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
