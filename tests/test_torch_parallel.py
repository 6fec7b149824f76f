"""
The sharded regrid, halo exchange and solvers of the PyTorch port
(``xugrid_tpu_torch.parallel``, over ``torch.distributed``) against the
JAX package's ``xugrid_tpu.parallel`` (over a JAX mesh).

The JAX side runs here on 4 of ``tests/conftest.py``'s 8 virtual CPU
devices.  The port runs once per module in a gloo world of 4 spawned CPU
processes (``tests/torch_parallel_worker.py``), which computes every
case and hands its results back through files in a temporary directory;
each case is then a test of its own.  The world joins through a file
store in that directory, and is given 120 s.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

import xugrid_tpu as xu
from xugrid_tpu import parallel as jpar
from xugrid_tpu.core.sparse import MatrixCSR as JMatrixCSR
from xugrid_tpu.core.sparse import PaddedCSR as JPaddedCSR
from xugrid_tpu.regrid import reduce as jreduce

import xugrid_tpu_torch.parallel as tpar
from xugrid_tpu_torch.core.sparse import PaddedCSR
from xugrid_tpu_torch.regrid import reduce as treduce
from xugrid_tpu_torch.regrid.apply import apply_weights

WORLD = 4
JOIN_TIMEOUT_S = 120
REPO = Path(__file__).resolve().parent.parent


def mesh4():
    return Mesh(np.array(jax.devices()[:WORLD]), ("x",))


def quads(ns, dx=1.0):
    x = np.arange(ns + 1.0) * dx
    yy, xx = np.meshgrid(x, x, indexing="ij")
    verts = np.column_stack([xx.ravel(), yy.ravel()])
    j, i = np.meshgrid(np.arange(ns), np.arange(ns), indexing="ij")
    nid = lambda ii, jj: jj * (ns + 1) + ii  # noqa: E731
    faces = np.stack([nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)], -1).reshape(-1, 4)
    return verts, faces


def overlap_problem(n_side, t_side):
    """Hilbert-ordered jittered source quads -> raster target overlap
    weights (float32) and a float32 field, as ``tests/test_parallel.py``
    builds them."""
    from xugrid_tpu.regrid.unstructured import UnstructuredGrid2d

    sverts, sfaces = quads(n_side)
    tverts, tfaces = quads(t_side, dx=n_side / t_side)
    rng = np.random.default_rng(11)
    jitter = rng.uniform(-0.2, 0.2, sverts.shape)
    edge = (sverts[:, 0] == 0) | (sverts[:, 1] == 0) | (sverts[:, 0] == n_side) | (sverts[:, 1] == n_side)
    jitter[edge] = 0.0
    sverts = sverts + jitter
    source_grid = xu.Ugrid2d(sverts[:, 0], sverts[:, 1], -1, sfaces)
    target_grid = xu.Ugrid2d(tverts[:, 0], tverts[:, 1], -1, tfaces)
    si, ti, w = UnstructuredGrid2d(source_grid).overlap(UnstructuredGrid2d(target_grid), relative=False)
    sorder = jpar.partition_order(source_grid.centroids)
    torder = jpar.partition_order(target_grid.centroids)
    sremap = np.empty(len(sorder), np.int64)
    sremap[sorder] = np.arange(len(sorder))
    tremap = np.empty(len(torder), np.int64)
    tremap[torder] = np.arange(len(torder))
    csr = JMatrixCSR.from_triplet(tremap[ti], sremap[si], w, n=target_grid.n_face, m=source_grid.n_face)
    padded = JPaddedCSR.from_csr(csr, dtype=np.float32)
    field = np.sin(source_grid.centroids[sorder, 0]).astype(np.float32)
    return padded, field


def random_padded(seed, n_target, m, w):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_target), w)
    cols = rng.integers(0, m, n_target * w)
    weights = rng.uniform(0.5, 1.5, n_target * w)
    csr = JMatrixCSR.from_triplet(rows, cols, weights, n=n_target, m=m)
    return JPaddedCSR.from_csr(csr), csr, rng.normal(size=m)


def host_mean(csr, source):
    expected = np.empty(csr.n)
    for t in range(csr.n):
        sl = slice(csr.indptr[t], csr.indptr[t + 1])
        expected[t] = (source[csr.indices[sl]] * csr.data[sl]).sum() / csr.data[sl].sum()
    return expected


def summation_bound(padded, field):
    """w_max * 2^-24 * the weighted window mean of |field|: a bound on the
    difference of two float32 window sums taken in different orders."""
    idx, w = padded.indices, padded.weights.astype(np.float64)
    magnitude = np.where(idx >= 0, np.abs(field.astype(np.float64))[np.maximum(idx, 0)], 0.0)
    wsum = w.sum(axis=1)
    mean = (w * magnitude).sum(axis=1) / np.where(wsum > 0, wsum, 1.0)
    return padded.w_max * 2.0**-24 * mean


def face_adjacency(n_side):
    """Hilbert-ordered face neighbours of an n_side^2 quad mesh and a
    smooth field on them."""
    verts, faces = quads(n_side)
    grid = xu.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    order = jpar.partition_order(grid.centroids)
    remap = np.empty(len(order), dtype=np.int64)
    remap[order] = np.arange(len(order))
    neighbors = grid.format_connectivity_as_dense(grid.face_face_connectivity)[order]
    neighbors = np.where(neighbors >= 0, remap[np.maximum(neighbors, 0)], -1)
    values = np.sin(grid.centroids[order, 0]) + grid.centroids[order, 1]
    return neighbors, values


def cg_system(nx=24, ny=18, seed=0):
    """Laplacian + identity over a raster adjacency, windowed."""
    import scipy.sparse as sp

    idx = np.arange(nx * ny).reshape(ny, nx)
    pairs = np.concatenate([
        np.column_stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()]),
        np.column_stack([idx[:-1, :].ravel(), idx[1:, :].ravel()]),
    ])
    i = np.concatenate([pairs[:, 0], pairs[:, 1]])
    j = np.concatenate([pairs[:, 1], pairs[:, 0]])
    n = nx * ny
    W = sp.coo_matrix((np.ones(len(i)), (i, j)), shape=(n, n)).tocsr()
    deg = np.asarray(W.sum(axis=1)).ravel()
    b = np.random.default_rng(seed).normal(size=n)
    w_max = int(np.diff(W.indptr).max())
    indices = np.full((n, w_max), -1, np.int64)
    weights = np.zeros((n, w_max), np.float64)
    for r in range(n):
        sl = slice(W.indptr[r], W.indptr[r + 1])
        indices[r, : sl.stop - sl.start] = W.indices[sl]
        weights[r, : sl.stop - sl.start] = -W.data[sl]
    diag = deg + 1.0
    return indices, weights, diag, b, sp.diags(diag) - W


def as_torch_padded(padded):
    return PaddedCSR(padded.indices, padded.weights, padded.n, padded.m, padded.w_max)


@pytest.fixture(scope="module")
def case():
    """Inputs built here (numpy), the port's results from one spawned
    gloo world of 4 ranks, and the JAX package's results."""
    import tempfile

    inputs = {}
    rng = np.random.default_rng(7)
    inputs["plan_random"] = rng.integers(-1, 64, (96, 5)).astype(np.int64)
    inputs["plan_random_source_size"] = np.array(64)
    overlap, field = overlap_problem(32, 8)
    m_padded = overlap.m + (-overlap.m) % WORLD
    inputs["plan_overlap"] = jpar.sharding._pad_to_multiple(overlap.indices, WORLD, -1)
    inputs["plan_overlap_source_size"] = np.array(m_padded)
    neighbors, values = face_adjacency(16)
    inputs["plan_faces"] = neighbors
    inputs["faces_values"] = values
    for name, padded in (
        ("overlap", overlap),
        ("aligned", overlap_problem(64, 16)[0]),
        ("scattered", random_padded(3, 256, 256, 16)[0]),
        ("multi", random_padded(4, 32, 256, 4)[0]),
    ):
        inputs[f"{name}_indices"] = padded.indices
        inputs[f"{name}_weights"] = padded.weights
        inputs[f"{name}_shape"] = np.array([padded.n, padded.m])
    inputs["overlap_field"] = field
    inputs["overlap_stack"] = np.stack([field, 2.0 * field - 1.0, np.cos(field)]).astype(np.float32)
    inputs["aligned_field"] = overlap_problem(64, 16)[1]
    inputs["scattered_field"] = random_padded(3, 256, 256, 16)[2]
    inputs["multi_field"] = random_padded(4, 32, 256, 4)[2]
    sv, sf = quads(16)
    tv, tf = quads(4, dx=4.0)
    inputs.update(regridder_sv=sv, regridder_sf=sf, regridder_tv=tv, regridder_tf=tf)
    inputs["regridder_values"] = np.random.default_rng(0).normal(size=len(sf))
    cg_indices, cg_weights, cg_diag, cg_b, _ = cg_system()
    inputs.update(cg_indices=cg_indices, cg_weights=cg_weights, cg_diag=cg_diag, cg_b=cg_b)
    smooth_neighbors, smooth_values = face_adjacency(8)
    inputs.update(smooth_neighbors=smooth_neighbors, smooth_values=smooth_values)
    chain = np.column_stack([np.arange(128) - 1, np.arange(128) + 1])
    chain[0, 0] = -1
    chain[-1, 1] = -1
    inputs.update(chain_neighbors=chain, chain_values=np.random.default_rng(1).normal(size=128))

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        np.savez(tmp / "inputs.npz", **inputs)
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "tests.torch_parallel_worker", str(rank), str(WORLD),
                 str(tmp / "store"), str(tmp / "inputs.npz"), str(tmp)],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for rank in range(WORLD)
        ]
        logs = []
        try:
            for proc in procs:
                out, _ = proc.communicate(timeout=JOIN_TIMEOUT_S)
                logs.append(out)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        failed = [rank for rank, proc in enumerate(procs) if proc.returncode != 0]
        if failed:
            raise AssertionError(f"ranks {failed} failed:\n" + "\n".join(logs[r][-4000:] for r in failed))
        results = []
        for rank in range(WORLD):
            with np.load(tmp / f"rank{rank}.npz") as data:
                results.append(dict(data))
    return {"inputs": inputs, "ranks": results, "port": results[0], "overlap": overlap}


# -- the exchange plan ---------------------------------------------------------
@pytest.mark.parametrize("name", ["random", "overlap", "faces"])
def test_plan_equals_jax(case, name):
    inputs, port = case["inputs"], case["port"]
    kwargs = {}
    if f"plan_{name}_source_size" in inputs:
        kwargs["source_size"] = int(inputs[f"plan_{name}_source_size"])
    plan = jpar.NeighborExchangePlan(mesh4(), inputs[f"plan_{name}"], **kwargs)
    np.testing.assert_array_equal(port[f"plan_{name}_send_slots"], np.asarray(plan.send_slots))
    np.testing.assert_array_equal(port[f"plan_{name}_lookup"], np.asarray(plan.lookup))
    np.testing.assert_array_equal(
        port[f"plan_{name}_numbers"],
        [plan.R, plan.n_remote, plan.n_unique_remote, plan.exchanged_bytes_f32, plan.block, plan.req_block],
    )
    if name != "random":
        assert plan.n_unique_remote > 0


def test_gather_neighbors_equals_the_halo_gather(case):
    """``NeighborExchangePlan.gather_neighbors`` on each rank: its rows'
    neighbour values, NaN for -1, as the regrid's halo gather and numpy's
    indexing give them."""
    neighbors, values = case["inputs"]["plan_faces"], case["inputs"]["faces_values"]
    rows = -(-len(neighbors) // WORLD)
    for rank, result in enumerate(case["ranks"]):
        got = result["gather_neighbors"]
        np.testing.assert_array_equal(got, result["gather_neighbors_halo"])
        own = neighbors[rank * rows : (rank + 1) * rows]
        np.testing.assert_array_equal(got[: len(own)], np.where(own < 0, np.nan, values[np.maximum(own, 0)]))


def test_every_rank_holds_the_whole_plan_and_result(case):
    for other in case["ranks"][1:]:
        for key in ("plan_overlap_lookup", "plan_overlap_send_slots", "regrid_halo_mean", "cg_x", "smooth_halo"):
            np.testing.assert_array_equal(other[key], case["port"][key])


# -- the sharded regrid --------------------------------------------------------
@pytest.mark.parametrize("method", ["halo", "allgather"])
@pytest.mark.parametrize("label", ["mean", "median"])
def test_regrid_matches_jax(case, method, label):
    reduction = jreduce.mean if label == "mean" else jreduce.ABSOLUTE_OVERLAP_METHODS["median"]
    sharded = jpar.ShardedRegrid(mesh4(), case["overlap"], reduction=reduction, method=method)
    field = case["inputs"]["overlap_field"]
    want = sharded.gather(sharded(field))
    got = case["port"][f"regrid_{method}_{label}"]
    assert got.dtype == np.float32
    # The two sum each float32 window in another order: rtol 1e-6, and
    # the order-independent bound w_max * 2^-24 * (the window mean of
    # |field|) where a mean cancels towards zero.
    bound = summation_bound(case["overlap"], field)
    np.testing.assert_array_less(np.abs(got - want), 1e-6 * np.abs(want) + bound + 1e-30)
    numbers = case["port"][f"regrid_{method}_numbers"]
    assert numbers[0] == 1 and numbers[1] == sharded.exchanged_bytes


@pytest.mark.parametrize("method", ["halo", "allgather"])
@pytest.mark.parametrize("label", ["mean", "median"])
def test_regrid_matches_unsharded_port(case, method, label):
    """Each window keeps its entry order, so the sharded apply equals the
    port's unsharded one bit for bit, for one field and a stack of 3."""
    reduction = treduce.mean if label == "mean" else treduce.ABSOLUTE_OVERLAP_METHODS["median"]
    weights = as_torch_padded(case["overlap"])
    for key, source in (("", case["inputs"]["overlap_field"]), ("_stack", case["inputs"]["overlap_stack"])):
        want = apply_weights(weights, torch.from_numpy(source), reduction, weights.n).numpy()
        np.testing.assert_array_equal(case["port"][f"regrid_{method}_{label}{key}"], want)
    # Rank 0's own block is the first rows of the result.
    local = case["port"][f"regrid_{method}_{label}_local"]
    np.testing.assert_array_equal(local[: weights.n], case["port"][f"regrid_{method}_{label}"][: len(local)])


def test_halo_exercises_the_exchange(case):
    plan = case["port"]["plan_overlap_numbers"]
    assert plan[2] > 0  # unique remote rows
    assert case["port"]["regrid_halo_numbers"][1] < case["port"]["regrid_allgather_numbers"][1]


def test_auto_picks_halo_when_aligned(case):
    port = case["port"]
    assert bool(port["auto_aligned_halo"])
    exchanged, m_padded = port["auto_aligned_bytes"]
    assert exchanged < m_padded * 4
    assert np.isfinite(port["auto_aligned"]).all()
    padded, field = overlap_problem(64, 16)
    sharded = jpar.ShardedRegrid(mesh4(), padded, method="auto")
    assert sharded.method == "halo" and sharded.exchanged_bytes == exchanged
    want = sharded.gather(sharded(field))
    bound = summation_bound(padded, field)
    np.testing.assert_array_less(np.abs(port["auto_aligned"] - want), 1e-6 * np.abs(want) + bound + 1e-30)


def test_auto_takes_allgather_on_scattered_refs(case):
    """Windows of 16 random sources among 256: a halo would move more
    rows than a gather."""
    port = case["port"]
    assert not bool(port["auto_scattered_halo"])
    padded, csr, source = random_padded(3, 256, 256, 16)
    sharded = jpar.ShardedRegrid(mesh4(), padded, method="auto")
    assert sharded.method == "allgather"
    np.testing.assert_allclose(port["auto_scattered"], sharded.gather(sharded(source)), rtol=1e-12)
    np.testing.assert_allclose(port["auto_scattered"], host_mean(csr, source), rtol=1e-12)


def test_from_regridder(case):
    """A built OverlapRegridder sharded over the world reproduces the
    single-process regrid of both packages."""
    import xugrid_tpu_torch as xt
    from xugrid_tpu.xdata import DataArray

    inputs = case["inputs"]
    sv, sf, tv, tf = (inputs[k] for k in ("regridder_sv", "regridder_sf", "regridder_tv", "regridder_tf"))
    values = inputs["regridder_values"]
    grid = xu.Ugrid2d(sv[:, 0], sv[:, 1], -1, sf)
    src = xu.UgridDataArray(DataArray(values, dims=(grid.face_dimension,), name="v"), grid)
    target = xu.UgridDataArray.from_data(np.zeros(len(tf)), xu.Ugrid2d(tv[:, 0], tv[:, 1], -1, tf), facet="face")
    expected = np.asarray(xu.OverlapRegridder(src, target, method="mean").regrid(src).values)
    np.testing.assert_allclose(case["port"]["from_regridder"], expected, rtol=1e-5)

    tgrid = xt.Ugrid2d(sv[:, 0], sv[:, 1], -1, sf)
    ttarget = xt.Ugrid2d(tv[:, 0], tv[:, 1], -1, tf)
    unsharded = xt.OverlapRegridder(tgrid, ttarget, method="mean").regrid(
        torch.from_numpy(values.astype(np.float32)), device="cpu"
    )
    np.testing.assert_array_equal(case["port"]["from_regridder"], unsharded.numpy())


def test_subgroup_shards_over_its_ranks(case):
    """A 2 x 2 layout of 4 ranks sharded over one axis: each subgroup of 2
    ranks regrids the whole field, as one axis of a 2-axis JAX mesh."""
    padded, csr, source = random_padded(4, 32, 256, 4)
    expected = host_mean(csr, source)
    for rank in case["ranks"]:
        assert int(rank["subgroup_size"]) == 2
        np.testing.assert_allclose(rank["subgroup"], expected, rtol=1e-12)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("x", "y"))
    sharded = jpar.ShardedRegrid(mesh, padded, axis="x", method="allgather")
    np.testing.assert_allclose(case["port"]["subgroup"], sharded.gather(sharded(source)), rtol=1e-12)


# -- solvers and the ring -------------------------------------------------------
def test_cg_matches_scipy_and_jax(case):
    from scipy.sparse.linalg import spsolve

    indices, weights, diag, b, A = cg_system()
    x, k = case["port"]["cg_x"], int(case["port"]["cg_iterations"])
    np.testing.assert_allclose(x, spsolve(A.tocsr(), b), rtol=1e-6, atol=1e-8)
    _, k_jax = jpar.sharded_cg_solve(mesh4(), indices, weights, diag, b, atol=1e-10, maxiter=2000)
    assert 0 < k < 2000
    assert abs(k - k_jax) <= 1


@pytest.mark.parametrize("method", ["halo", "allgather"])
def test_smooth_matches_jax(case, method):
    inputs = case["inputs"]
    want = jpar.sharded_laplace_smooth(
        mesh4(), inputs["smooth_neighbors"], inputs["smooth_values"], n_steps=3, method=method
    )
    np.testing.assert_allclose(case["port"][f"smooth_{method}"], want, rtol=1e-12)


def test_smoothing_converges(case):
    inputs = case["inputs"]
    out = case["port"]["smooth_chain"]
    assert np.isfinite(out).all()
    assert out.var() < inputs["chain_values"].var()
    want = jpar.sharded_laplace_smooth(mesh4(), inputs["chain_neighbors"], inputs["chain_values"], n_steps=4)
    np.testing.assert_allclose(out, want, rtol=1e-12)


def test_halo_exchange_ring(case):
    blocks = [np.arange(6.0) + 10.0 * r for r in range(WORLD)]
    for r, result in enumerate(case["ranks"]):
        np.testing.assert_array_equal(result["halo_0"], blocks[r])
        want = np.concatenate([blocks[(r - 1) % WORLD][-2:], blocks[r], blocks[(r + 1) % WORLD][:2]])
        np.testing.assert_array_equal(result["halo_2"], want)
        assert bool(result["halo_7_raised"])


# -- in this process --------------------------------------------------------------
def test_bad_methods_raise():
    padded = as_torch_padded(random_padded(3, 8, 16, 2)[0])
    with pytest.raises(ValueError, match="method"):
        tpar.ShardedRegrid(None, padded, method="bogus")
    with pytest.raises(ValueError, match="halo"):
        tpar.sharded_laplace_smooth(None, np.zeros((4, 2), np.int64), np.zeros(4), method="bogus")


def test_partition_order_matches_jax():
    xy = np.random.default_rng(2).uniform(0, 100, (4096, 2))
    np.testing.assert_array_equal(tpar.partition_order(xy), jpar.partition_order(xy))


def _triplets(rng, n_target, n_source, grouped):
    counts = rng.integers(0, 7, n_target)
    tindex = np.repeat(np.arange(n_target), counts)
    sindex = rng.integers(0, n_source, len(tindex))
    w = rng.random(len(tindex))
    if not grouped:
        perm = rng.permutation(len(tindex))
        tindex, sindex, w = tindex[perm], sindex[perm], w[perm]
    return tindex, sindex, w


@pytest.mark.parametrize("grouped", [True, False])
def test_hilbert_layout_matches_jax(grouped):
    rng = np.random.default_rng(3)
    sc = rng.random((800, 2)) * 50
    tc = rng.random((500, 2)) * 50
    tindex, sindex, w = _triplets(rng, 500, 800, grouped)
    so, to, got = tpar.hilbert_layout(sc, tc, tindex, sindex, w)
    so_j, to_j, want = jpar.hilbert_layout(sc, tc, tindex, sindex, w)
    np.testing.assert_array_equal(so, so_j)
    np.testing.assert_array_equal(to, to_j)
    assert (got.n, got.m, got.w_max) == (want.n, want.m, want.w_max)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.weights, want.weights)


@pytest.mark.parametrize("grouped", [True, False])
def test_hilbert_layout_native_matches_numpy(grouped, monkeypatch):
    """The native one-pass layout against the sort path: grouped triplets
    keep each window's entry order, so the two are equal; ungrouped ones
    take the sort path either way."""
    from xugrid_tpu_torch.utils import native

    rng = np.random.default_rng(5)
    sc = rng.random((800, 2)) * 50
    tc = rng.random((500, 2)) * 50
    tindex, sindex, w = _triplets(rng, 500, 800, grouped)
    got = tpar.hilbert_layout(sc, tc, tindex, sindex, w)[2]
    assert (native.padded_layout_native(tindex, sindex, w, np.arange(500), np.arange(800), 500) is None) != grouped
    monkeypatch.setattr(native, "padded_layout_native", lambda *args: None)
    want = tpar.hilbert_layout(sc, tc, tindex, sindex, w)[2]
    assert got.w_max == want.w_max
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.weights, want.weights)


def test_hilbert_layout_empty_rows_and_single_entry():
    sc = np.array([[0.0, 0.0], [1.0, 1.0], [2.0, 0.5]])
    tc = np.array([[0.5, 0.5], [1.5, 0.5]])
    so, to, padded = tpar.hilbert_layout(sc, tc, np.array([1]), np.array([2]), np.array([0.7]))
    assert padded.n == 2 and padded.m == 3
    sremap = np.empty(3, np.int64)
    sremap[so] = np.arange(3)
    row = int(np.where(to == 1)[0][0])
    assert padded.indices[row, 0] == sremap[2]
    assert padded.weights[row, 0] == np.float32(0.7)
    assert (padded.indices[1 - row] == -1).all()


def test_exports_match_jax():
    assert sorted(tpar.__all__) == sorted(jpar.__all__)
