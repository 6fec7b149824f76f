"""
Interpolation of missing values on UGRID topologies: the Laplace fill on
the card, and the nearest fill (``nearest_interpolate``, whose search is
``spatial/nearest.py``'s).

``laplace_interpolate`` solves Laplace's equation over the unknown nodes
(or faces), with the known values as Dirichlet boundaries, by a
preconditioned conjugate gradient (PCG).  The preconditioner is a
fixed-degree Chebyshev polynomial of the Jacobi-scaled operator: a few
extra matvecs per iteration in exchange for several times fewer
iterations.

The PCG's matvec is the CSR kernel ``csr_matvec``
(``csrc/window_reduce.cu``) over the compacted unknown-unknown system,
RCM-relabelled for locality when it has more than 4096 unknowns.  Every
mesh takes it: the JAX package's stencil (DIA) solver for banded graphs
exists because gathers are slow on a TPU, and on the card it was no
faster than this path on a structured-derived 1M mesh (PERF.md).

Right-hand sides (extra slices sharing one NaN pattern) ride the minor
axis: the state is (n, E), each column has its own step lengths and
tolerance, and the loop runs until every column has converged.  The
solve runs in float64.

State carried across from ``xugrid_tpu``: none.  The Laplace fill has no
trained state or weights; both packages take the same numpy ``data`` and
scipy CSR ``connectivity``, so the tests hand the identical arrays to
both and no converter exists.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import scipy.sparse
import torch
from scipy.sparse.linalg import spsolve

from xugrid_tpu_torch import xdata
from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec
from xugrid_tpu_torch.utils.device import resolve_device
from xugrid_tpu_torch.xdata.variable import is_tensor

#: Prepared systems, keyed by a content hash of the matrix (full bytes:
#: a collision would silently corrupt results) and the device, emptied
#: when it would exceed _CACHE_SIZE entries.  A fill over many time
#: slices re-solves the same Laplacian, and at 1M nodes the host
#: preparation and the upload cost more than the solve.  cg_solve keeps
#: its device system here; laplace_interpolate keeps the device system
#: with its RHS operator and RCM relabel.
_SYSTEMS: dict = {}
_CACHE_SIZE = 4

#: diagnostics of the most recent iterative solve: iterations,
#: n_unknown, degree, mode ("cg"), cached (the prepared system was
#: reused), and seconds: device_s (upload, PCG, download) and, for
#: laplace_interpolate, the host stages hash_s (content hash), prep_s
#: (system extraction, RCM relabel, CSR build and upload; 0 when
#: cached), rhs_s (right-hand sides and initial guess), scatter_s (undo
#: the relabel, write the output), wall_s (the whole call) and host_s
#: (wall_s minus device_s).
last_solve_info: dict = {}


def _digest(*parts) -> str:
    """SHA-256 of the arrays' bytes (SHA-256 runs in hardware on current
    x86 hosts: about 2.5x the rate of BLAKE2b)."""
    h = hashlib.sha256()
    for part in parts:
        h.update(np.ascontiguousarray(part))
    return h.hexdigest()


def _cached(key, build):
    """(_SYSTEMS[key], whether it was cached), built by ``build()`` on a
    miss."""
    if key in _SYSTEMS:
        return _SYSTEMS[key], True
    value = build()
    if len(_SYSTEMS) >= _CACHE_SIZE:
        _SYSTEMS.clear()
    _SYSTEMS[key] = value
    return value, False


def _check_finite(**arrays) -> None:
    for name, array in arrays.items():
        if not np.isfinite(array).all():
            raise ValueError(f"the CG solve needs finite input: {name} holds NaN or inf")


def _make_chebyshev_precond(matvec, minv, lmax, degree):
    """Chebyshev approximation of (D^-1 A)^-1 on [lmax/30, lmax] applied
    to D^-1 r: a fixed SPD linear operator (valid for PCG), built from
    matvecs only.  degree <= 1 degrades to plain Jacobi."""
    if degree <= 1:

        def precond(r):
            return minv * r

        return precond

    lo = lmax / 30.0
    theta = (lmax + lo) / 2.0
    delta = (lmax - lo) / 2.0
    sigma = theta / delta

    def precond(r):
        rd = minv * r
        d = rd / theta
        z = d
        rho_prev = 1.0 / sigma
        for _ in range(degree - 1):
            rho = 1.0 / (2.0 * sigma - rho_prev)
            resid = rd - minv * matvec(z)
            d = rho * rho_prev * d + (2.0 * rho / delta) * resid
            z = z + d
            rho_prev = rho
        return z

    return precond


def _coldot(a, b):
    """Per right-hand side inner products: (n, E) -> (E,)."""
    return torch.sum(a * b, dim=0)


def _pcg(matvec, minv, b, x0, tol, lmax, maxiter, degree):
    """
    Chebyshev-Jacobi preconditioned CG over right-hand sides on the
    minor axis: b, x0 (n, E), minv (n, 1), tol (E,).

    Runs while some column's residual norm exceeds its tolerance and
    fewer than ``maxiter`` iterations ran; one host sync per iteration.
    Converged columns have p ~ 0 and freeze through the zero guards on
    alpha and beta.  Returns (x, iterations).
    """
    precond = _make_chebyshev_precond(matvec, minv, lmax, degree)
    x = x0.clone()
    r = b - matvec(x)
    z = precond(r)
    p = z.clone()
    rz = _coldot(r, z)
    k = 0
    while k < maxiter and bool(torch.any(torch.sqrt(_coldot(r, r)) > tol)):
        Ap = matvec(p)
        pAp = _coldot(p, Ap)
        alpha = torch.where(pAp != 0.0, rz / torch.where(pAp == 0.0, 1.0, pAp), 0.0)
        x.addcmul_(alpha, p)
        r.addcmul_(alpha, Ap, value=-1.0)
        z = precond(r)
        rz_new = _coldot(r, z)
        beta = torch.where(rz != 0.0, rz_new / torch.where(rz == 0.0, 1.0, rz), 0.0)
        p.mul_(beta).add_(z)
        rz = rz_new
        k += 1
    return x, k


def _inverse_diagonal(diag: np.ndarray) -> np.ndarray:
    return np.where(diag != 0.0, 1.0 / np.where(diag == 0.0, 1.0, diag), 1.0)


def _csr_system(rows, cols, vals, diag, device: torch.device) -> dict:
    """The device side of a COO system in cg_solve's layout: int32 row
    pointers and columns and float64 data (each row in the given entry
    order), the inverse diagonal, and the Gershgorin bound on the
    Jacobi-scaled spectrum, per unknown 1 + sum(|offdiag|) / |diag|."""
    n = len(diag)
    if len(vals) >= 2**31:
        raise ValueError(f"csr_matvec indexes with int32: nnz {len(vals)}")
    m_off = len(vals) - n  # vals layout: [offdiag..., diag...]
    offdiag_abs = np.bincount(rows[:m_off], weights=np.abs(vals[:m_off]), minlength=n)
    safe_diag = np.where(diag != 0.0, diag, 1.0)
    order = np.argsort(rows, kind="stable")
    indptr = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return {
        "indptr": torch.from_numpy(indptr).to(device),
        "indices": torch.from_numpy(cols[order].astype(np.int32)).to(device),
        "data": torch.from_numpy(vals[order].astype(np.float64)).to(device),
        "minv": torch.from_numpy(_inverse_diagonal(diag)[:, None]).to(device),
        "lmax": float(np.max(1.0 + offdiag_abs / np.abs(safe_diag), initial=1.0)),
    }


def _solve_csr(system: dict, b, x0, rtol, atol, maxiter, degree):
    """The PCG over a device system with csr_matvec as its SpMV.  b, x0:
    (E, n) numpy.  Returns ((E, n) numpy, iterations)."""
    device = system["data"].device
    t0 = time.perf_counter()
    bT = torch.from_numpy(np.ascontiguousarray(b.T)).to(device)
    x0T = torch.from_numpy(np.ascontiguousarray(x0.T)).to(device)
    tol = torch.clamp(rtol * torch.sqrt(_coldot(bT, bT)), min=atol)
    indptr, indices, data = system["indptr"], system["indices"], system["data"]
    x, k = _pcg(
        lambda v: csr_matvec(indptr, indices, data, v),
        system["minv"], bT, x0T, tol, system["lmax"], int(maxiter), int(degree),
    )
    out = x.cpu().numpy().T
    last_solve_info["device_s"] = time.perf_counter() - t0
    return out, k


def cg_solve(rows, cols, vals, diag, b, x0, rtol, atol, maxiter, degree: int = 4, device=None):
    """
    Chebyshev-Jacobi preconditioned CG over a COO system, with the
    ``csr_matvec`` kernel as its SpMV.

    b, x0: (n,) or (E, n) numpy.  Returns (solutions of the shape of b,
    iterations until every right-hand side converged).

    Layout contract: ``rows/cols/vals`` must be ordered
    ``[off-diagonal entries..., diagonal entries]`` with exactly the n
    diagonal entries (rows[i] == cols[i] == i) at the tail: the
    Gershgorin bound for the Chebyshev interval depends on it, and an
    underestimated spectrum makes the preconditioner indefinite.
    ``vals``, ``diag``, ``b`` and ``x0`` must be finite: the matvec does
    not guard against NaN or inf.  ``rows``, ``cols`` and ``vals`` have
    one length and every index lies in [0, n): the kernel gathers
    ``x[cols]`` unchecked.

    ``device``: None means the CUDA card; ``"cpu"`` runs the plain
    matvec on the CPU.
    """
    device = resolve_device(None, device)
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals, dtype=np.float64)
    diag = np.asarray(diag, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    x0 = np.asarray(x0, dtype=np.float64)
    n = b.shape[-1]
    if not len(rows) == len(cols) == len(vals):
        raise ValueError(f"rows, cols and vals differ in length: {len(rows)}, {len(cols)}, {len(vals)}")
    for name, index in (("rows", rows), ("cols", cols)):
        if len(index) and (index.min() < 0 or index.max() >= n):
            raise ValueError(f"{name} index outside [0, {n})")
    if not (
        len(rows) >= n
        and len(diag) == n
        and np.array_equal(rows[-n:], np.arange(n))
        and np.array_equal(cols[-n:], np.arange(n))
    ):
        raise ValueError(
            "cg_solve expects [offdiag..., diag...] COO layout with the "
            "n diagonal entries at the tail (see docstring)."
        )
    _check_finite(vals=vals, diag=diag, b=b, x0=x0)
    system, _ = _cached(
        ("coo", n, _digest(rows, cols, vals, diag), device),
        lambda: _csr_system(rows, cols, vals, diag, device),
    )
    out, k = _solve_csr(system, np.atleast_2d(b), np.atleast_2d(x0), rtol, atol, maxiter, degree)
    return (out[0] if b.ndim == 1 else out), np.asarray(k)


def _laplace_system(W, solve_mask, notnull, unknown, relabel: bool):
    """The compacted unknown-unknown system A = D - W in cg_solve's COO
    layout (rows, cols, vals, diag), the RHS operator (weights from the
    unknowns to the known nodes), and, when ``relabel``, the RCM relabel
    applied to A (its inverse permutation pinv; else None)."""
    n = W.shape[0]
    nu = len(unknown)
    # Global index -> position in the unknown set (-1 for known).
    position = np.full(n, -1, dtype=np.int64)
    position[unknown] = np.arange(nu)

    sub = W[unknown]  # (n_unknown, n)
    coo = sub.tocoo()
    is_unknown_col = solve_mask[coo.col]
    rows_uu = coo.row[is_unknown_col]
    cols_uu = position[coo.col[is_unknown_col]]
    vals_uu = -coo.data[is_unknown_col]
    diag = np.asarray(sub.sum(axis=1)).ravel()
    is_known_col = notnull[coo.col]
    rhs = scipy.sparse.csr_matrix(
        (coo.data[is_known_col], (coo.row[is_known_col], coo.col[is_known_col])), shape=(nu, n)
    )

    pinv = None
    if relabel:
        # RCM relabel: neighbouring unknowns get nearby ids, so the
        # matvec's gathers of the iterate stay local.  A similarity
        # transform: iterations unchanged.
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        A_uu = scipy.sparse.coo_matrix((vals_uu, (rows_uu, cols_uu)), shape=(nu, nu)).tocsr()
        perm_cg = np.asarray(reverse_cuthill_mckee(A_uu, symmetric_mode=True), dtype=np.int64)
        pinv = np.empty(nu, np.int64)
        pinv[perm_cg] = np.arange(nu)
        rows_uu, cols_uu = pinv[rows_uu], pinv[cols_uu]
        diag = diag[perm_cg]
        rhs = rhs[perm_cg]
    # A = diag + offdiag(uu), with the diagonal entries at the tail.
    rows = np.concatenate([rows_uu, np.arange(nu)])
    cols = np.concatenate([cols_uu, np.arange(nu)])
    vals = np.concatenate([vals_uu, diag])
    return rows, cols, vals, diag, rhs, pinv


def laplace_interpolate(
    data,
    connectivity: scipy.sparse.csr_matrix,
    use_weights: bool = True,
    components_labels=None,
    direct_solve: bool = False,
    delta: float = 0.0,
    relax: float = 0.0,
    rtol: float = 0.0,
    atol: float = 1.0e-4,
    maxiter: int = 500,
    precondition_degree: int = 4,
    device=None,
) -> np.ndarray:
    """
    Fill NaNs in ``data`` by Laplace interpolation over the adjacency
    graph ``connectivity``.

    ``data`` may be 1D (n,) or 2D (n_extra, n) numpy: extra rows sharing
    the same NaN pattern are solved as batched right-hand sides.  Returns
    numpy of the shape of ``data``.  Unknowns in a component of
    ``components_labels`` without any known value stay NaN.
    ``precondition_degree`` sets the Chebyshev degree (1 = plain Jacobi).
    ``direct_solve`` solves with scipy's ``spsolve`` on the host.
    ``delta`` and ``relax`` (the reference's ILU0 knobs) are accepted at
    the reference's positions and unused.

    ``device``: None means the CUDA card, and raises without one;
    ``"cpu"`` runs the solve's plain versions on the CPU.
    """
    device = resolve_device(None, device)
    t_start = time.perf_counter()
    if connectivity.shape[0] != connectivity.shape[1]:
        raise ValueError(
            "connectivity is not a square matrix: "
            f"{connectivity.shape[0]} x {connectivity.shape[1]}"
        )
    data = np.asarray(data, dtype=np.float64)
    squeeze = data.ndim == 1
    matrix2d = np.atleast_2d(data)
    isnull = np.isnan(matrix2d[0])
    if not isnull.any():
        return data.copy()
    notnull = ~isnull
    if not notnull.any():
        raise ValueError("All values are NA.")

    # Unknowns in components without any known value stay NaN.
    keep_nan = np.zeros(len(isnull), dtype=bool)
    if components_labels is not None:
        _, label = np.unique(components_labels, return_inverse=True)
        known_per_label = np.bincount(label.ravel(), weights=notnull)
        keep_nan = known_per_label[label.ravel()] == 0
    solve_mask = isnull & ~keep_nan
    if not solve_mask.any():
        return data.copy()

    unknown = np.flatnonzero(solve_mask)
    W = connectivity.tocsr().astype(np.float64, copy=False)
    if not use_weights:
        W = scipy.sparse.csr_matrix((np.ones(W.nnz), W.indices, W.indptr), shape=W.shape)

    def finish(solutions):
        out = matrix2d.copy()
        out[:, unknown] = solutions
        return out[0] if squeeze else out

    if direct_solve:
        rows, cols, vals, _, rhs, _ = _laplace_system(W, solve_mask, notnull, unknown, relabel=False)
        A = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(len(unknown),) * 2).tocsr()
        b = (rhs @ np.where(notnull, matrix2d, 0.0).T).T
        return finish(np.stack([spsolve(A, bk) for bk in b]))

    # System extraction, RCM relabel and upload depend only on (W, NaN
    # pattern, device): cached under their content hash.
    def prepare():
        rows, cols, vals, diag, rhs, pinv = _laplace_system(
            W, solve_mask, notnull, unknown, relabel=len(unknown) > 4096
        )
        _check_finite(vals=vals, diag=diag)
        return {"rhs": rhs, "pinv": pinv, "system": _csr_system(rows, cols, vals, diag, device)}

    t_hash = time.perf_counter()
    key = ("laplace", W.shape, _digest(W.indptr, W.indices, W.data, solve_mask, notnull), device)
    t_prep = time.perf_counter()
    prep, cached = _cached(key, prepare)
    t_rhs = time.perf_counter()
    # The RHS comes relabelled: prep["rhs"]'s rows follow the system's.
    b = (prep["rhs"] @ np.where(notnull, matrix2d, 0.0).T).T
    # Initial guess: mean of the known values per row.
    x0 = np.broadcast_to(np.nanmean(matrix2d, axis=1)[:, None], b.shape)
    _check_finite(b=b, x0=x0)
    t_solve = time.perf_counter()
    solutions, iterations = _solve_csr(prep["system"], b, x0, rtol, atol, maxiter, precondition_degree)
    t_scatter = time.perf_counter()
    if prep["pinv"] is not None:
        solutions = solutions[:, prep["pinv"]]
    out = finish(solutions)
    t_end = time.perf_counter()
    last_solve_info.update(
        iterations=int(iterations),
        n_unknown=len(unknown),
        degree=precondition_degree,
        mode="cg",
        cached=cached,
        hash_s=t_prep - t_hash,
        prep_s=t_rhs - t_prep,
        rhs_s=t_solve - t_rhs,
        scatter_s=t_end - t_scatter,
        wall_s=t_end - t_start,
        host_s=t_end - t_start - last_solve_info["device_s"],
    )
    return out


def nearest_interpolate(coordinates: np.ndarray, data: np.ndarray, max_distance: float, device=None) -> np.ndarray:
    """``data`` (1D float) with each NaN replaced by the value at the
    nearest non-NaN coordinate (NaN beyond ``max_distance``); the search
    may run on ``device`` (``spatial/nearest.py``)."""
    from xugrid_tpu_torch.spatial.nearest import nearest_points

    isnull = np.isnan(data)
    if isnull.all():
        raise ValueError("All values are NA.")
    if not isnull.any():
        return data.copy()
    i_source = np.flatnonzero(~isnull)
    i_target = np.flatnonzero(isnull)
    index = nearest_points(coordinates[i_source], coordinates[i_target], max_distance, device=device)
    keep = index >= 0
    out = data.copy()
    out[i_target[keep]] = data[i_source[index[keep]]]
    return out


def interpolate_na_helper(da, ugrid_dim: str, func, kwargs: dict, device=None):
    """
    Apply a 1D fill function along ``ugrid_dim`` of an xdata DataArray,
    over every slice of its other dimensions, in float64.  The Laplace
    fill takes the slices that share one NaN pattern in one call (one
    batched solve); with mixed patterns it fills slice by slice.

    ``func`` takes and returns host numpy, and ``device=``: the one given,
    else a tensor payload's device, else None, which ``func`` resolves
    (the Laplace fill to the CUDA card; the nearest fill only where it
    searches on a device).  A tensor payload is copied to the host for
    it, explicitly, and the result goes back to the payload's device as
    a float64 tensor.
    """
    extra_dims = [d for d in da.dims if d != ugrid_dim]
    transposed = da.transpose(*extra_dims, ugrid_dim)
    payload = transposed.data
    if device is None and is_tensor(payload):
        device = payload.device
    kwargs = dict(kwargs, device=device)
    values = np.asarray(transposed.values, dtype=np.float64)
    flat = values.reshape(-1, values.shape[-1])

    patterns = np.isnan(flat)
    if func is laplace_interpolate and len(flat) > 1 and (patterns == patterns[0]).all():
        filled = func(flat, **kwargs)
    else:
        filled = np.stack([func(row, **kwargs) for row in flat])
    filled = filled.reshape(values.shape)
    if is_tensor(payload):
        filled = torch.from_numpy(filled).to(payload.device)

    out = xdata.DataArray(filled, dims=tuple(extra_dims) + (ugrid_dim,), name=da.name, attrs=dict(da.attrs))
    out._coords.update(transposed._coords)
    return out.transpose(*da.dims)
