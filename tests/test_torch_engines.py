"""
The five Pallas gather engines of the JAX package, each held to the
port on the CPU.

The engines (``aligned`` #1, ``stream`` #3, ``span`` #4, ``packet`` #5,
``pdot`` #6) compute the same windowed reductions through different TPU
plan layouts.  The port computes their function with two kernels: the
PCG's matvec with ``csr_matvec`` and the regrid methods with
``window_reduce``.  So for each engine:

* the JAX ``cg_solve`` runs on a small SPD system with that engine as
  its SpMV (pinned through the JAX package's environment switches, in
  interpret mode), the plan it cached is checked to be that engine's,
  and its solution is held to the port's ``cg_solve`` on the CPU;
* ``apply_windowed_gather`` with that engine's plan runs every regrid
  method it covers, in interpret mode, and is held to the plain version
  of ``window_reduce``.

The Pallas engines compute in float32: tolerances rtol 2e-5 / atol 1e-4,
as the JAX package's own tests of these kernels
(tests/test_gather_apply.py).  Shapes stay small (n <= 700) because
interpret mode is slow.
"""

import numpy as np
import pytest
import scipy.sparse
import torch
from scipy.spatial import Delaunay

from tests.test_torch_apply import make_case
from xugrid_tpu.regrid import gather_apply
from xugrid_tpu.regrid.aligned_apply import AlignedPlan, plan_gather_aligned
from xugrid_tpu.ugrid import interpolate as jax_interpolate
from xugrid_tpu_torch.regrid import reduce
from xugrid_tpu_torch.regrid.aligned_apply import window_reduce
from xugrid_tpu_torch.ugrid import interpolate

ENGINES = {
    "aligned": (AlignedPlan, plan_gather_aligned),
    "stream": (gather_apply.StreamPlan, gather_apply.plan_gather_stream),
    "span": (gather_apply.SpanPlan, gather_apply.plan_gather_span),
    "packet": (gather_apply.GatherPlan, gather_apply.plan_gather),
    "pdot": (gather_apply.PdotPlan, gather_apply.plan_gather_pdot),
}

#: Pallas method name -> the port's reduction.
METHODS = {
    "mean": reduce.mean,
    "sum": reduce.sum,
    "first_order_conservative": reduce.first_order_conservative,
    "conductance": reduce.conductance,
    "harmonic_mean": reduce.harmonic_mean,
    "geometric_mean": reduce.geometric_mean,
    "min": reduce.minimum,
    "max": reduce.maximum,
}

#: pdot covers the sum-kind chains only; min and max would replan to
#: the stream engine, which has its own cases.
REGRID_CASES = [
    (engine, method)
    for engine in ENGINES
    for method in METHODS
    if engine != "pdot" or method not in ("min", "max")
]


def spd_system(n=600, seed=3):
    """A Delaunay-graph Laplacian plus a small shift (SPD), in cg_solve's
    [offdiag..., diag...] COO layout, and a right-hand side."""
    rng = np.random.default_rng(seed)
    tri = Delaunay(rng.uniform(0.0, 10.0, (n, 2)))
    edges = np.concatenate([tri.simplices[:, [0, 1]], tri.simplices[:, [1, 2]], tri.simplices[:, [2, 0]]])
    A = scipy.sparse.coo_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])), shape=(n, n))
    A = ((A + A.T) > 0).astype(np.float64).tocoo()
    diag = np.asarray(A.sum(axis=1)).ravel() + 0.5
    rows = np.concatenate([A.row, np.arange(n)])
    cols = np.concatenate([A.col, np.arange(n)])
    vals = np.concatenate([-A.data, diag])
    return rows, cols, vals, diag, rng.normal(size=n)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_cg_solve_engine_matches_port(engine, monkeypatch):
    monkeypatch.setenv("XUGRID_TPU_CG", "windowed")
    monkeypatch.setenv("XUGRID_TPU_CG_GATHER", "force")
    monkeypatch.setenv("XUGRID_TPU_GATHER_ENGINE", engine)
    rows, cols, vals, diag, b = spd_system()
    n = len(b)
    jax_interpolate._GATHER_PLANS.clear()
    want, want_iters = jax_interpolate.cg_solve(
        rows, cols, vals, diag, b, np.zeros(n), rtol=1e-6, atol=0.0, maxiter=300
    )
    (entry,) = jax_interpolate._GATHER_PLANS.values()
    assert isinstance(entry["plan"], ENGINES[engine][0])
    got, iters = interpolate.cg_solve(
        rows, cols, vals, diag, b, np.zeros(n), rtol=1e-6, atol=0.0, maxiter=300, device="cpu"
    )
    assert got.shape == (n,)
    assert abs(int(iters) - int(want_iters)) <= 2
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)
    A = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    assert np.linalg.norm(A @ got - b) <= 1e-6 * np.linalg.norm(b) * 1.0001


@pytest.mark.parametrize("engine, method", REGRID_CASES)
def test_regrid_engine_matches_window_reduce(engine, method):
    plan_type, planner = ENGINES[engine]
    positive = method in ("harmonic_mean", "geometric_mean")
    indices, weights, source = make_case(
        n=300, m=400, seed=len(method), positive=positive, dtype=np.float32
    )
    plan = planner(indices, weights)
    assert isinstance(plan, plan_type)
    if engine == "pdot":
        assert gather_apply._pdot_supported(method, True)
    want = gather_apply.apply_windowed_gather(
        source, indices, weights, method, plan=plan, interpret=True
    )
    before = window_reduce.launches
    got = window_reduce(
        torch.from_numpy(source), torch.from_numpy(indices),
        torch.from_numpy(weights), METHODS[method],
    ).numpy().T
    assert window_reduce.launches == before
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)
