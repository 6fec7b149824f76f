"""
The port's Laplace fill (xugrid_tpu_torch.ugrid.interpolate) and its
kernel module's matvec (csr_matvec in regrid/aligned_apply.py), held on
the CPU against the JAX package (float64 under x64, where its solver is
the COO segment-sum PCG, one loop per right-hand side, or, on banded
graphs, its DIA stencil PCG; the port runs its CSR PCG on every graph).

Tolerances.  Both solvers stop once every residual norm is at most
``atol`` (rtol 0), but they sum in other orders and the port runs one
shared loop over the right-hand sides, in which a converged column keeps
improving.  The solutions then agree to within the error that a
residual of ``atol`` allows: at most 1e4 * atol on these meshes, whose
Dirichlet Laplacians have smallest eigenvalues above 1e-3.  Single
right-hand sides take the same number of iterations, within 1.
"""

import numpy as np
import pytest
import scipy.sparse
import torch
from scipy.sparse.csgraph import connected_components

import chip_smoke
import xugrid_tpu as xu
import xugrid_tpu_torch as xt
from tests.test_gather_apply import dense_matvec_oracle, make_matvec_case
from tests.test_golden import load
from xugrid_tpu.regrid.aligned_apply import matvec_apply, plan_gather_matvec
from xugrid_tpu.ugrid import interpolate as jax_interpolate
from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec, csr_matvec_plain
from xugrid_tpu_torch.ugrid import interpolate

ATOL = 1e-10
TOL = 1e4 * ATOL


def padded_to_csr(indices, weights):
    """(indptr, indices, data) tensors of a -1 padded window table."""
    valid = indices >= 0
    indptr = np.zeros(len(indices) + 1, np.int32)
    np.cumsum(valid.sum(axis=1), out=indptr[1:])
    return (
        torch.from_numpy(indptr),
        torch.from_numpy(indices[valid].astype(np.int32)),
        torch.from_numpy(weights[valid]),
    )


def node_problem(nodes, faces, known_fraction, seed=7, unit_weights=True):
    """Both packages' grids, the node connectivity and the demo's fill
    problem on it."""
    jg = xu.Ugrid2d(nodes[:, 0], nodes[:, 1], -1, faces)
    tg = xt.Ugrid2d(nodes[:, 0], nodes[:, 1], -1, faces)
    W = tg.get_connectivity_matrix(tg.node_dimension, xy_weights=not unit_weights)
    if unit_weights:
        W = W.astype(np.float64)
        W.data = np.ones_like(W.data)
    truth, values = chip_smoke.laplace_inputs(nodes, known_fraction, seed)
    return jg, tg, W, truth, values


@pytest.fixture(scope="module")
def delaunay():
    """A shuffled Delaunay mesh with more than 4096 unknowns: the port
    relabels its CG system by RCM."""
    nodes, faces = chip_smoke.delaunay_mesh(76)
    return node_problem(nodes, faces, known_fraction=0.05)


def both(values, W, **kwargs):
    want = jax_interpolate.laplace_interpolate(values, W, **kwargs)
    jax_info = dict(jax_interpolate.last_solve_info)
    got = interpolate.laplace_interpolate(values, W, device="cpu", **kwargs)
    return got, want, jax_info, dict(interpolate.last_solve_info)


# csr_matvec
# ----------
@pytest.mark.parametrize("shape", [(700, 900, 5), (513, 5000, 3), (300, 200, 20)])
def test_csr_matvec_plain_matches_dense_oracle(shape):
    indices, weights = make_matvec_case(*shape, seed=shape[2])
    weights = weights.astype(np.float64)
    x = np.random.default_rng(1).normal(size=(shape[1], 3))
    before = csr_matvec.launches
    got = csr_matvec(*padded_to_csr(indices, weights), torch.from_numpy(x))
    assert csr_matvec.launches == before
    assert got.shape == (shape[0], 3) and got.dtype == torch.float64
    for e in range(3):
        want = dense_matvec_oracle(indices, weights, x[:, e])
        np.testing.assert_allclose(got[:, e].numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("qs", [1, 2])
def test_csr_matvec_plain_matches_pallas_matvec(qs):
    """Pallas #1 in matvec mode (interpret mode, float32), at the JAX
    package's tolerance for that kernel (tests/test_gather_apply.py)."""
    indices, weights = make_matvec_case(2100, 2600, 7, seed=qs, band=40)
    plan = plan_gather_matvec(indices, weights, qs=qs)
    assert plan is not None
    x = np.random.default_rng(1).normal(size=2600).astype(np.float32)
    want = matvec_apply(x, plan, interpret=True)
    got = csr_matvec(*padded_to_csr(indices, weights), torch.from_numpy(x[:, None]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got[:, 0].numpy(), want, rtol=2e-5, atol=1e-4)


def test_csr_matvec_plain_sums_each_row_in_order():
    """Ragged rows of 0 to 40 entries, empty rows, zero and negative
    weights: the plain version sums every row in CSR order, one entry
    after another, as the kernel does, so a sequential float32 loop
    reproduces it bit for bit."""
    indptr, indices, data = chip_smoke.synthetic_csr(np.random.default_rng(2), n=400, m=300)
    data = data.astype(np.float32)
    x = np.random.default_rng(3).normal(size=(300, 2)).astype(np.float32)
    got = csr_matvec_plain(*map(torch.from_numpy, (indptr, indices, data, x))).numpy()
    want = np.zeros((400, 2), np.float32)
    for t in range(400):
        for k in range(indptr[t], indptr[t + 1]):
            want[t] = want[t] + data[k] * x[indices[k]]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("E", [1, 2, 3, 8, 20])
def test_csr_matvec_on_cpu_runs_the_plain_version(E):
    """On CPU tensors csr_matvec launches nothing and returns the plain
    version's bits, at any slice count."""
    indptr, indices, data = chip_smoke.synthetic_csr(np.random.default_rng(6), n=200, m=150)
    args = [torch.from_numpy(a) for a in (indptr, indices, data)]
    x = torch.from_numpy(np.random.default_rng(E).normal(size=(150, E)))
    before = csr_matvec.launches
    got = csr_matvec(*args, x)
    assert csr_matvec.launches == before
    assert got.shape == (200, E) and got.dtype == torch.float64
    assert torch.equal(got, csr_matvec_plain(*args, x))


def test_chebyshev_preconditioner_matches_jax():
    rows, cols, vals, diag, b = spd_path(50)
    A = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(50, 50)).toarray()
    minv = 1.0 / diag
    for degree in (1, 2, 4):
        want = jax_interpolate._make_chebyshev_precond(lambda v: A @ v, minv, 3.0, degree)(b)
        got = interpolate._make_chebyshev_precond(
            lambda v: torch.from_numpy(A) @ v, torch.from_numpy(minv[:, None]), 3.0, degree
        )(torch.from_numpy(b[:, None]))
        np.testing.assert_allclose(got[:, 0].numpy(), want, rtol=1e-13, atol=1e-13)


# cg_solve
# --------
def spd_path(n):
    """A path-graph Laplacian plus 2 I in cg_solve's COO layout, and a
    right-hand side."""
    lo, hi = np.arange(1, n), np.arange(n - 1)
    rows = np.concatenate([lo, hi, np.arange(n)])
    cols = np.concatenate([lo - 1, hi + 1, np.arange(n)])
    vals = np.concatenate([np.full(n - 1, -1.0), np.full(n - 1, -1.0), np.full(n, 4.0)])
    return rows, cols, vals, np.full(n, 4.0), np.random.default_rng(n).normal(size=n)


def test_cg_solve_matches_jax_on_stacked_right_hand_sides():
    rows, cols, vals, diag, b = spd_path(300)
    b = np.stack([b, 2.0 * b + 1.0, np.zeros(300)])
    want, want_iters = jax_interpolate.cg_solve(rows, cols, vals, diag, b, np.zeros_like(b), 0.0, ATOL, 500)
    got, iters = interpolate.cg_solve(rows, cols, vals, diag, b, np.zeros_like(b), 0.0, ATOL, 500, device="cpu")
    assert got.shape == b.shape
    assert int(iters) == int(np.max(want_iters))
    np.testing.assert_allclose(got, want, rtol=0.0, atol=TOL)


@pytest.mark.parametrize("degree", [1, 4])
def test_cg_solve_runs_one_matvec_per_iteration_and_degree(degree, monkeypatch):
    """The count chip_smoke.py holds the kernel's launches to: one
    matvec for the initial residual, degree - 1 for the first
    preconditioning, and degree per iteration."""
    calls = []

    def counted(*args):
        calls.append(1)
        return csr_matvec(*args)

    monkeypatch.setattr(interpolate, "csr_matvec", counted)
    rows, cols, vals, diag, b = spd_path(200)
    _, iters = interpolate.cg_solve(rows, cols, vals, diag, b, np.zeros(200), 0.0, ATOL, 500, degree, device="cpu")
    assert len(calls) == 1 + (degree - 1) + int(iters) * degree


def test_cg_solve_rejects_bad_input():
    rows, cols, vals, diag, b = spd_path(20)
    x0 = np.zeros(20)
    with pytest.raises(ValueError, match="COO layout"):
        interpolate.cg_solve(rows[::-1], cols[::-1], vals[::-1], diag, b, x0, 0.0, ATOL, 50, device="cpu")
    for name, bad in (("vals", vals), ("b", b), ("x0", x0), ("diag", diag)):
        for value in (np.nan, np.inf):
            args = dict(vals=vals, b=b, x0=x0, diag=diag)
            args[name] = bad.copy()
            args[name][3] = value
            with pytest.raises(ValueError, match=f"{name} holds NaN or inf"):
                interpolate.cg_solve(rows, cols, args["vals"], args["diag"], args["b"], args["x0"],
                                     0.0, ATOL, 50, device="cpu")


@pytest.mark.parametrize(
    "change, message",
    [
        (lambda r, c, v: (r[:-1], c, v), "differ in length"),
        (lambda r, c, v: (r, c, v[:-1]), "differ in length"),
        (lambda r, c, v: (np.where(r == 5, -1, r), c, v), r"rows index outside \[0, 20\)"),
        (lambda r, c, v: (r, np.where(c == 5, 20, c), v), r"cols index outside \[0, 20\)"),
    ],
)
def test_cg_solve_rejects_indices_it_cannot_gather(change, message):
    """The kernel gathers x[cols] unchecked: cg_solve refuses COO input
    of unequal lengths or with an index outside [0, n)."""
    rows, cols, vals, diag, b = spd_path(20)
    rows, cols, vals = change(rows, cols, vals)
    with pytest.raises(ValueError, match=message):
        interpolate.cg_solve(rows, cols, vals, diag, b, np.zeros(20), 0.0, ATOL, 50, device="cpu")


# laplace_interpolate
# -------------------
@pytest.mark.parametrize("degree", [1, 4])
def test_laplace_delaunay_with_rcm_matches_jax(delaunay, degree):
    _, _, W, truth, values = delaunay
    assert np.isnan(values).sum() > 4096
    got, want, jax_info, info = both(values, W, atol=ATOL, maxiter=2000, precondition_degree=degree)
    assert jax_info["mode"] == info["mode"] == "cg"
    assert abs(info["iterations"] - jax_info["iterations"]) <= 1
    assert info["n_unknown"] == jax_info["n_unknown"]
    assert info["wall_s"] >= info["device_s"] > 0.0 and info["host_s"] >= 0.0
    np.testing.assert_allclose(got, want, rtol=0.0, atol=TOL)
    known = ~np.isnan(values)
    np.testing.assert_array_equal(got[known], values[known])
    assert np.abs(got - truth).max() < 5.0


def test_laplace_multi_rhs_matches_jax(delaunay):
    _, _, W, _, values = delaunay
    stack = values[None, :] * np.array([1.0, 0.5, -2.0])[:, None]
    got, want, _, info = both(stack, W, atol=ATOL, maxiter=2000)
    assert got.shape == stack.shape and info["mode"] == "cg"
    np.testing.assert_allclose(got, want, rtol=0.0, atol=TOL)


def test_laplace_structured_takes_dia_and_matches_jax(monkeypatch):
    """A structured-derived mesh: the JAX package takes its DIA stencil
    solver, the port its CSR PCG, one csr_matvec call per matvec."""
    nodes, faces = chip_smoke.structured_triangle_mesh(40)
    _, _, W, _, values = node_problem(nodes, faces, known_fraction=0.05)
    matvecs = []

    def counted(*args):
        matvecs.append(1)
        return csr_matvec(*args)

    monkeypatch.setattr(interpolate, "csr_matvec", counted)
    got, want, jax_info, info = both(values, W, atol=ATOL, maxiter=2000)
    assert jax_info["mode"] == "dia" and info["mode"] == "cg"
    assert len(matvecs) == 1 + 3 + 4 * info["iterations"]
    assert abs(info["iterations"] - jax_info["iterations"]) <= 1
    np.testing.assert_allclose(got, want, rtol=0.0, atol=TOL)


def test_try_dia_solve_matches_jax_after_rcm_relabel():
    """A shuffled narrow strip is not banded as given; the JAX package
    relabels it by RCM into its DIA budget and undoes the relabel.  The
    port's CSR PCG gives the same fill."""
    nodes, faces = chip_smoke.quad_mesh(150, 2)
    perm = np.random.default_rng(4).permutation(len(nodes))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    _, _, W, _, values = node_problem(nodes[perm], inv[faces], known_fraction=0.1)
    matrix2d = np.stack([values, 3.0 * values])
    notnull = ~np.isnan(values)
    solve_mask = ~notnull
    args = (W, solve_mask, notnull, matrix2d, 0.0, ATOL, 2000, 4)
    want, want_iters = jax_interpolate._try_dia_solve(*args)
    key = next(iter(k for k in jax_interpolate._DIA_ASSEMBLY if k[0] == W.shape))
    assert jax_interpolate._DIA_ASSEMBLY[key]["perm"] is not None
    got = interpolate.laplace_interpolate(matrix2d, W, atol=ATOL, maxiter=2000, device="cpu")
    assert abs(interpolate.last_solve_info["iterations"] - int(np.max(want_iters))) <= 1
    np.testing.assert_allclose(got[:, solve_mask], want, rtol=0.0, atol=TOL)


def test_laplace_caches_its_system_and_times_its_stages(delaunay):
    """A second fill over the same matrix and NaN pattern reuses the
    prepared system (one content hash per call) and gives the same
    answer; the host stages add up to at most the wall time."""
    _, _, W, _, values = delaunay
    interpolate._SYSTEMS.clear()
    first = interpolate.laplace_interpolate(values, W, atol=ATOL, maxiter=2000, device="cpu")
    assert not interpolate.last_solve_info["cached"]
    second = interpolate.laplace_interpolate(2.0 * values, W, atol=ATOL, maxiter=2000, device="cpu")
    info = dict(interpolate.last_solve_info)
    assert info["cached"] and len(interpolate._SYSTEMS) == 1
    np.testing.assert_allclose(second, 2.0 * first, rtol=0.0, atol=2 * TOL)
    stages = sum(info[k] for k in ("hash_s", "prep_s", "rhs_s", "device_s", "scatter_s"))
    assert all(info[k] >= 0.0 for k in ("hash_s", "prep_s", "rhs_s", "scatter_s"))
    assert stages <= info["wall_s"] and abs(info["host_s"] + info["device_s"] - info["wall_s"]) < 1e-9


def test_component_without_known_values_stays_nan():
    a_nodes, a_faces = chip_smoke.delaunay_mesh(20, seed=1)
    b_nodes, b_faces = chip_smoke.delaunay_mesh(10, seed=2)
    nodes = np.concatenate([a_nodes, b_nodes + 200.0])
    faces = np.concatenate([a_faces, b_faces + len(a_nodes)])
    _, tg, W, _, values = node_problem(nodes, faces, known_fraction=0.1)
    values[len(a_nodes):] = np.nan
    _, labels = connected_components(W)
    got, want, _, _ = both(values, W, components_labels=labels, atol=ATOL)
    assert np.isnan(got[len(a_nodes):]).all() and np.isfinite(got[: len(a_nodes)]).all()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=TOL)


@pytest.mark.parametrize("use_weights", [True, False])
@pytest.mark.parametrize("direct_solve", [False, True])
def test_laplace_weights_and_direct_solve_match_jax(use_weights, direct_solve):
    nodes, faces = chip_smoke.delaunay_mesh(30, seed=5)
    _, _, W, _, values = node_problem(nodes, faces, known_fraction=0.1, unit_weights=False)
    got, want, _, _ = both(values, W, use_weights=use_weights, direct_solve=direct_solve, atol=ATOL)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-12 if direct_solve else TOL)


def test_face_fill_matches_jax():
    """The accessor's face path: face-face connectivity with
    inverse-centroid-distance weights."""
    nodes, faces = chip_smoke.delaunay_mesh(20, seed=6)
    jg = xu.Ugrid2d(nodes[:, 0], nodes[:, 1], -1, faces)
    tg = xt.Ugrid2d(nodes[:, 0], nodes[:, 1], -1, faces)
    W = tg.get_connectivity_matrix(tg.face_dimension, xy_weights=True)
    values = np.where(np.random.default_rng(1).random(tg.n_face) < 0.1, tg.centroids[:, 0], np.nan)
    _, labels = connected_components(W)
    want = jax_interpolate.laplace_interpolate(
        values, jg.get_connectivity_matrix(jg.face_dimension, True), components_labels=labels, atol=ATOL
    )
    got = interpolate.laplace_interpolate(values, W, components_labels=labels, atol=ATOL, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0.0, atol=TOL)


def test_laplace_rejects_bad_input():
    W = scipy.sparse.csr_matrix(np.ones((3, 4)))
    with pytest.raises(ValueError, match="not a square matrix"):
        interpolate.laplace_interpolate(np.zeros(3), W, device="cpu")
    W = scipy.sparse.csr_matrix(np.ones((3, 3)) - np.eye(3))
    with pytest.raises(ValueError, match="All values are NA"):
        interpolate.laplace_interpolate(np.full(3, np.nan), W, device="cpu")
    with pytest.raises(ValueError, match="b holds NaN or inf"):
        interpolate.laplace_interpolate(np.array([np.inf, np.nan, 1.0]), W, device="cpu")
    filled = np.arange(3.0)
    np.testing.assert_array_equal(interpolate.laplace_interpolate(filled, W, device="cpu"), filled)


def test_laplace_runs_on_the_card_by_default():
    W = scipy.sparse.csr_matrix(np.ones((3, 3)) - np.eye(3))
    values = np.array([1.0, np.nan, 3.0])
    if torch.cuda.is_available():
        np.testing.assert_allclose(interpolate.laplace_interpolate(values, W), [1.0, 2.0, 3.0])
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            interpolate.laplace_interpolate(values, W)


class TestLaplaceGolden:
    """tests/golden/laplace.npz (the original numerics), at the
    tolerances of tests/test_golden.py."""

    def _connectivity(self, data):
        n = int(data["n"])
        return scipy.sparse.csr_matrix((data["w_data"], data["w_indices"], data["w_indptr"]), shape=(n, n))

    @pytest.mark.parametrize("use_weights", [True, False])
    def test_direct(self, use_weights):
        data = load("laplace.npz")
        key = "expected_weighted" if use_weights else "expected_unweighted"
        ours = interpolate.laplace_interpolate(
            data["data"], self._connectivity(data), use_weights=use_weights, direct_solve=True, device="cpu"
        )
        np.testing.assert_allclose(ours, data[key], rtol=1e-6, atol=1e-9)

    @pytest.mark.parametrize("use_weights", [True, False])
    def test_pcg(self, use_weights):
        data = load("laplace.npz")
        key = "expected_weighted" if use_weights else "expected_unweighted"
        ours = interpolate.laplace_interpolate(
            data["data"], self._connectivity(data), use_weights=use_weights,
            atol=1e-10, maxiter=2000, device="cpu",
        )
        np.testing.assert_allclose(ours, data[key], rtol=1e-6, atol=1e-6)
