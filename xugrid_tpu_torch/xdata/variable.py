"""
Variable: the dimension-labelled array under DataArray and Dataset.

The payload is a numpy array (host) or a torch tensor (on the CPU or the
card); every operation dispatches on it, so a tensor stays on its
device through indexing, shaping, arithmetic and reductions.  A numpy
payload meeting a tensor is moved to the tensor's device.  ``values``
is the one way a tensor payload is copied to the host.  A ``LazyArray``
(``lazy.py``) passes through untouched: slicing its leading dimension
stays lazy, and ``values`` loads it.
"""

from __future__ import annotations

from typing import Any, Hashable, Mapping, Sequence, Tuple

import numpy as np
import torch


def is_tensor(data) -> bool:
    return isinstance(data, torch.Tensor)


def to_numpy(data) -> np.ndarray:
    """The payload as a host numpy array: a copy of a tensor."""
    if is_tensor(data):
        return data.detach().cpu().numpy()
    return np.asarray(data)


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a torch or numpy dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def as_tensor_like(value, like: torch.Tensor):
    """``value`` as an operand of the tensor ``like``: arrays and numpy
    scalars become tensors on ``like``'s device; Python scalars and
    tensors pass unchanged."""
    if isinstance(value, (np.ndarray, np.generic)):
        return torch.as_tensor(np.asarray(value), device=like.device)
    return value


def where_tensor(mask: torch.Tensor, data: torch.Tensor, other) -> torch.Tensor:
    """``torch.where(mask, data, other)`` with numpy's promotion: an
    integer or bool tensor against a Python float becomes float64 (torch
    would take its default float32)."""
    if isinstance(other, float) and not is_floating(data):
        data = data.double()
    return torch.where(mask, data, as_tensor_like(other, data))


def common_operands(a, b):
    """(a, b) on one device: where one is a tensor, the other joins it."""
    if is_tensor(a):
        return a, as_tensor_like(b, a)
    if is_tensor(b):
        return as_tensor_like(a, b), b
    return a, b


def is_floating(data) -> bool:
    if is_tensor(data):
        return data.is_floating_point() or data.is_complex()
    dtype = np.asarray(data).dtype if not hasattr(data, "dtype") else data.dtype
    return np.issubdtype(dtype, np.floating) or np.issubdtype(dtype, np.complexfloating)


def as_compatible_data(data) -> Any:
    """Coerce Python scalars and lists to numpy; leave arrays, tensors and
    ``LazyArray``s alone (a DataArray gives its payload, not a copy).  A
    LazyArray is never materialized here: only ``values`` loads it."""
    if is_tensor(data) or isinstance(data, np.ndarray) or getattr(data, "is_lazy", False):
        return data
    if isinstance(data, Variable):
        return data.data
    if hasattr(data, "variable") and hasattr(data, "dims"):
        return data.variable.data
    return np.asarray(data)


_NAN_SKIPPING = ("sum", "mean", "std", "var", "min", "max", "prod", "median")


def _reduce_dims(tensor, axis):
    return tuple(range(tensor.ndim)) if axis is None else tuple(axis)


def _prod(x, dims):
    for d in sorted(dims, reverse=True):
        x = x.prod(dim=d)
    return x


def _median(x, dims, nan_skipping):
    """numpy's median (the mean of the two middle values) over ``dims``:
    torch's quantile at 0.5 with linear interpolation."""
    rest = [d for d in range(x.ndim) if d not in dims]
    moved = x.permute(*rest, *dims).reshape(*[x.shape[d] for d in rest], -1)
    return (torch.nanquantile if nan_skipping else torch.quantile)(moved, 0.5, dim=-1)


def _nan_var(x, dims, ddof):
    valid = ~torch.isnan(x)
    count = valid.sum(dim=dims, keepdim=True)
    mean = torch.nansum(x, dim=dims, keepdim=True) / count
    deviation = torch.where(valid, x - mean, 0.0)
    dof = count - ddof
    var = (deviation * deviation).sum(dim=dims, keepdim=True) / dof
    var = torch.where(dof > 0, var, torch.nan)
    return var.squeeze(dims) if dims else var


def _nan_extreme(x, dims, largest: bool):
    fill = -torch.inf if largest else torch.inf
    filled = torch.where(torch.isnan(x), fill, x)
    out = filled.amax(dim=dims) if largest else filled.amin(dim=dims)
    return torch.where(torch.isnan(x).all(dim=dims), torch.nan, out)


def reduce_tensor(data: torch.Tensor, func_name: str, axis, nan_skipping: bool, **kwargs):
    """numpy's reduction ``func_name`` (its ``nan`` form when
    ``nan_skipping``) over the axes ``axis`` (None: all), as torch ops on
    the tensor's device.  Integer input to mean, std, var and median is
    taken as float64, as numpy does."""
    if func_name in ("argmax", "argmin"):
        return arg_extreme(data, axis, func_name == "argmax")
    dims = _reduce_dims(data, axis)
    if func_name in ("all", "any"):
        out = data.bool()
        for d in sorted(dims, reverse=True):
            out = getattr(out, func_name)(dim=d)
        return out
    x = data
    if func_name in ("mean", "std", "var", "median") and not x.is_floating_point():
        x = x.double()
    ddof = kwargs.get("ddof", 0)
    if nan_skipping:
        if func_name == "sum":
            return torch.nansum(x, dim=dims)
        if func_name == "mean":
            return torch.nanmean(x, dim=dims)
        if func_name in ("min", "max"):
            return _nan_extreme(x, dims, func_name == "max")
        if func_name == "prod":
            return _prod(torch.where(torch.isnan(x), 1.0, x), dims)
        if func_name == "var":
            return _nan_var(x, dims, ddof)
        if func_name == "std":
            return torch.sqrt(_nan_var(x, dims, ddof))
        if func_name == "median":
            return _median(x, dims, True)
    if func_name == "sum":
        return x.sum(dim=dims)
    if func_name == "mean":
        return x.mean(dim=dims)
    if func_name == "min":
        return x.amin(dim=dims)
    if func_name == "max":
        return x.amax(dim=dims)
    if func_name == "prod":
        return _prod(x, dims)
    if func_name == "var":
        return torch.var(x, dim=dims, correction=ddof)
    if func_name == "std":
        return torch.std(x, dim=dims, correction=ddof)
    if func_name == "median":
        return _median(x, dims, False)
    raise ValueError(f"unknown reduction: {func_name}")


def arg_extreme(data: torch.Tensor, axis, largest: bool) -> torch.Tensor:
    """numpy's argmax (``largest``) or argmin over ``axis`` (None: the
    flattened tensor): the first position of the extreme, a NaN counting
    as the extreme.  Taken as the least matching position, so a tie
    resolves the same way on every device."""
    if axis is None:
        data, axis = data.reshape(-1), 0
    extreme = data.amax(dim=axis, keepdim=True) if largest else data.amin(dim=axis, keepdim=True)
    hit = data == extreme
    if data.is_floating_point():
        isnan = torch.isnan(data)
        hit = torch.where(isnan.any(dim=axis, keepdim=True), isnan, hit)
    shape = [1] * data.ndim
    shape[axis] = data.shape[axis]
    position = torch.arange(data.shape[axis], device=data.device).reshape(shape)
    return torch.where(hit, position, data.shape[axis]).amin(dim=axis)


def quantile_tensor(data: torch.Tensor, q: np.ndarray, axis, skipna: bool) -> torch.Tensor:
    """numpy's (nan)quantile at the 1-D float64 ``q`` over the axes
    ``axis`` (None: all), linear interpolation, computed in float64 as
    numpy computes it with a float64 ``q``: (len(q), *the other axes)."""
    dims = _reduce_dims(data, axis)
    rest = [d for d in range(data.ndim) if d not in dims]
    moved = data.permute(*rest, *dims).reshape(*[data.shape[d] for d in rest], -1).double()
    func = torch.nanquantile if skipna else torch.quantile
    return func(moved, torch.from_numpy(q).to(data.device), dim=-1)


def rank_tensor(data: torch.Tensor, axis: int) -> torch.Tensor:
    """scipy's ``rankdata(method="average", nan_policy="omit")`` along
    ``axis`` in float64, NaN kept: sorted once, each run of equal values
    taking the mean of its first and last rank (exact halves).  The
    sort and scans run along the first axis; float keys are sorted in
    their own dtype (the same order and ties as in float64)."""
    x = (data if data.is_floating_point() else data.double()).movedim(axis, 0)
    n = x.shape[0]
    values, order = torch.sort(x, dim=0, stable=True)  # NaN sorts last
    position = torch.arange(n, device=x.device).reshape((n,) + (1,) * (x.ndim - 1))
    starts = torch.ones_like(values, dtype=torch.bool)
    starts[1:] = values[1:] != values[:-1]
    ends = torch.ones_like(values, dtype=torch.bool)
    ends[:-1] = starts[1:]
    first = torch.where(starts, position, 0).cummax(dim=0).values
    last = torch.where(ends, position, n).flip(0).cummin(dim=0).values.flip(0)
    ranks = torch.empty_like(values, dtype=torch.float64).scatter_(0, order, (first + last).double() / 2.0 + 1.0)
    return torch.where(torch.isnan(x), torch.nan, ranks).movedim(0, axis)


def fill_directional_tensor(data: torch.Tensor, axis: int, limit, reverse: bool) -> torch.Tensor:
    """Each NaN along ``axis`` takes the last valid value before it (the
    next after it for ``reverse``), at most ``limit`` steps away; float64."""
    moved = data.double().movedim(axis, 0)
    if reverse:
        moved = moved.flip(0)
    n = moved.shape[0]
    idx = torch.arange(n, device=moved.device).reshape((n,) + (1,) * (moved.ndim - 1))
    valid = ~torch.isnan(moved)
    last = torch.where(valid, idx, -1).cummax(dim=0).values
    if limit is not None:
        last = torch.where((last >= 0) & (idx - last <= limit), last, -1)
    filled = torch.gather(moved, 0, last.clamp(min=0))
    filled = torch.where(valid, moved, torch.where(last >= 0, filled, torch.nan))
    if reverse:
        filled = filled.flip(0)
    return filled.movedim(0, axis)


def shift_tensor(data: torch.Tensor, axis: int, n: int, fill_value) -> torch.Tensor:
    """``data`` shifted by ``n`` along ``axis``, the vacated places set to
    ``fill_value``."""
    out = torch.roll(data, n, dims=axis)
    index = [slice(None)] * out.ndim
    index[axis] = slice(0, n) if n > 0 else slice(n, None)
    out[tuple(index)] = fill_value
    return out


def interpolate_tensor(data: torch.Tensor, x: np.ndarray, axis: int, method: str, extrapolate: bool) -> torch.Tensor:
    """NaN along ``axis`` filled by 1-D interpolation over the positions
    ``x`` (increasing) in float64, every row at once: each NaN between
    valid values from its neighbours (``np.interp``'s arithmetic, or the
    nearer one, ties to the left); NaN before the first and after the last
    valid value stay, unless ``extrapolate`` (linear: the end slopes;
    nearest: the end values).  Rows without a valid value stay NaN.  The
    scans and gathers run along the first axis."""
    y = data.double().movedim(axis, 0)
    n = y.shape[0]
    column = (n,) + (1,) * (y.ndim - 1)
    xs = torch.from_numpy(np.asarray(x, dtype=np.float64)).to(y.device)
    valid = ~torch.isnan(y)
    position = torch.arange(n, device=y.device).reshape(column)
    prev = torch.where(valid, position, -1).cummax(dim=0).values
    nxt = torch.where(valid, position, n).flip(0).cummin(dim=0).values.flip(0)
    has_prev, has_next = prev >= 0, nxt < n
    lo, hi = prev.clamp(min=0), nxt.clamp(max=n - 1)
    x_lo, x_hi, x_at = xs[lo], xs[hi], xs.reshape(column)
    y_lo, y_hi = torch.gather(y, 0, lo), torch.gather(y, 0, hi)
    inside = has_prev & has_next
    if method == "linear":
        slope = (y_hi - y_lo) / (x_hi - x_lo)
        filled = slope * (x_at - x_lo) + y_lo
        again = slope * (x_at - x_hi) + y_hi
        filled = torch.where(torch.isnan(filled), again, filled)
        filled = torch.where(torch.isnan(filled) & (y_lo == y_hi), y_lo, filled)
        filled = torch.where(inside, filled, torch.nan)
        if extrapolate:
            count = valid.sum(dim=0, keepdim=True)
            first = torch.where(valid, position, n).amin(dim=0, keepdim=True).clamp(max=n - 1)
            last = torch.where(valid, position, -1).amax(dim=0, keepdim=True).clamp(min=0)
            second = torch.where(valid & (position > first), position, n).amin(dim=0, keepdim=True).clamp(max=n - 1)
            before = torch.where(valid & (position < last), position, -1).amax(dim=0, keepdim=True).clamp(min=0)
            x0, x1, xm, xl = xs[first], xs[second], xs[before], xs[last]
            y0, y1 = torch.gather(y, 0, first), torch.gather(y, 0, second)
            ym, yl = torch.gather(y, 0, before), torch.gather(y, 0, last)
            head = torch.where(count > 1, y0 + (y1 - y0) / (x1 - x0) * (x_at - x0), y0)
            tail = torch.where(count > 1, yl + (yl - ym) / (xl - xm) * (x_at - xl), yl)
            filled = torch.where(~has_prev & has_next, head, filled)
            filled = torch.where(has_prev & ~has_next, tail, filled)
    else:
        take_hi = torch.abs(x_hi - x_at) < torch.abs(x_at - x_lo)
        nearest = torch.where(inside & take_hi, y_hi, y_lo)
        nearest = torch.where(has_prev, nearest, y_hi)
        filled = nearest if extrapolate else torch.where(inside, nearest, torch.nan)
    return torch.where(valid, y, filled).movedim(0, axis)


def gradient_tensor(f: torch.Tensor, x: np.ndarray, axis: int) -> torch.Tensor:
    """numpy's ``gradient(f, x, axis=axis)`` (edge_order 1) of a float64
    tensor over the host coordinate ``x``: second-order central
    differences inside (numpy's three weights per point where the spacing
    varies, its scalar form where it is constant), first-order ones at
    both ends, with numpy's arithmetic."""
    if f.shape[axis] < 2:
        raise ValueError(
            "Shape of array too small to calculate a numerical gradient, at least (edge_order + 1) elements are required."
        )

    def at(k):
        return (slice(None),) * axis + (k,)

    dx = np.diff(np.asarray(x, dtype=np.float64))
    out = torch.empty_like(f)
    if (dx == dx[0]).all():
        out[at(slice(1, -1))] = (f[at(slice(2, None))] - f[at(slice(None, -2))]) / (2.0 * dx[0])
    else:
        dx1, dx2 = dx[:-1], dx[1:]
        shape = [1] * f.ndim
        shape[axis] = -1
        a, b, c = (
            torch.from_numpy(v).to(f.device).reshape(shape)
            for v in (-dx2 / (dx1 * (dx1 + dx2)), (dx2 - dx1) / (dx1 * dx2), dx1 / (dx2 * (dx1 + dx2)))
        )
        out[at(slice(1, -1))] = a * f[at(slice(None, -2))] + b * f[at(slice(1, -1))] + c * f[at(slice(2, None))]
    out[at(0)] = (f[at(1)] - f[at(0)]) / dx[0]
    out[at(-1)] = (f[at(-1)] - f[at(-2)]) / dx[-1]
    return out


def trapezoid_tensor(y: torch.Tensor, x: np.ndarray, axis: int) -> torch.Tensor:
    """numpy's ``trapezoid(y, x=x, axis=axis)`` over the host coordinate
    ``x``, in numpy's result dtype: the neighbour sums in ``y``'s dtype,
    then times the spacing, halved and summed."""
    x = np.asarray(x)
    if x.dtype.kind in "mM":
        raise TypeError(
            "integrating over a datetime coordinate gives timedelta64 values (numpy's trapezoid), which a tensor "
            "cannot hold: integrate over a numeric coordinate"
        )
    d = np.diff(x)
    dtype = np.result_type(d.dtype, torch.empty(0, dtype=y.dtype).numpy().dtype)
    shape = [1] * y.ndim
    shape[axis] = len(d)
    spacing = torch.from_numpy(d.astype(dtype)).to(y.device).reshape(shape)
    n = y.shape[axis]
    pairs = (y.narrow(axis, 1, n - 1) + y.narrow(axis, 0, n - 1)).to(torch_dtype(dtype))
    return (spacing * pairs / 2.0).sum(dim=axis)


def interp_tensor(data: torch.Tensor, old: np.ndarray, new: np.ndarray, axis: int, method: str) -> torch.Tensor:
    """1-D interpolation of ``data`` along ``axis`` from the host
    coordinate ``old`` to ``new`` (both float64), in float64 with NaN
    outside ``old``'s range: "linear" with ``np.interp``'s arithmetic,
    "nearest" by the midpoint rule (ties to the lower neighbour).  The
    positions are found on the host, the values gathered on the tensor's
    device."""
    order = np.argsort(old, kind="stable")
    so = old[order]
    n = len(so)
    shape = [1] * data.ndim
    shape[axis] = len(new)
    y = data.double()
    device = y.device

    def gather(positions):
        return y.index_select(axis, torch.from_numpy(order[positions]).to(device))

    def column(values):
        return torch.from_numpy(np.asarray(values)).to(device).reshape(shape)

    outside = column((new < so[0]) | (new > so[-1]) | np.isnan(new))
    if method == "nearest":
        j = np.searchsorted(so, new)
        j_lo, j_hi = np.clip(j - 1, 0, n - 1), np.clip(j, 0, n - 1)
        pick = np.where(np.abs(new - so[j_lo]) <= np.abs(so[j_hi] - new), j_lo, j_hi)
        return torch.where(outside, torch.nan, gather(pick))
    j = np.clip(np.searchsorted(so, new, side="right") - 1, 0, n - 1)
    lo = np.clip(j, 0, max(n - 2, 0))
    hi = np.minimum(lo + 1, n - 1)
    y_lo, y_hi, y_at = gather(lo), gather(hi), gather(j)
    with np.errstate(divide="ignore", invalid="ignore"):
        width = so[hi] - so[lo]
    slope = (y_hi - y_lo) / column(width)
    x = column(new)
    out = slope * (x - column(so[lo])) + y_lo
    out = torch.where(torch.isnan(out), slope * (x - column(so[hi])) + y_hi, out)
    out = torch.where(torch.isnan(out) & (y_lo == y_hi), y_lo, out)
    # At a sample point (and at the last one) np.interp takes its value.
    out = torch.where(column((so[j] == new) | (j == n - 1)), y_at, out)
    return torch.where(outside, torch.nan, out)


def lstsq_tall(vander: np.ndarray, Y: torch.Tensor) -> torch.Tensor:
    """The least-squares solution of the tall, full-rank host matrix
    ``vander`` (T, k) against every column of ``Y`` (T, K) on ``Y``'s
    device: the QR of the small matrix on the host, then Q^T Y (one matrix
    product) and back substitution over the k rows of R on the device.
    (On the card, ``torch.linalg.lstsq`` and ``torch.linalg.qr`` with
    ``solve_triangular`` both take seconds against a million columns,
    this about a millisecond; ``scripts/lstsq_probe.py`` times all three.)"""
    Q, R = np.linalg.qr(vander)
    device = Y.device
    B = torch.from_numpy(np.ascontiguousarray(Q.T)).to(device) @ Y
    X = torch.empty_like(B)
    for i in range(R.shape[0] - 1, -1, -1):
        X[i] = (B[i] - torch.from_numpy(R[i, i + 1 :].copy()).to(device) @ X[i + 1 :]) / R[i, i]
    return X


def polyfit_tensor(flat: torch.Tensor, vander: np.ndarray, skipna) -> torch.Tensor:
    """Least-squares fits of the columns of the float64 (T, K) ``flat``
    against the host Vandermonde matrix (T, deg + 1), on the tensor's
    device: (deg + 1, K).  Without NaN, one solve; with NaN and
    ``skipna``, one solve for the columns without NaN and one per pattern
    of finite rows among the others (each column fit over its finite
    samples, where more than ``deg`` remain; else NaN), as the JAX
    package fits each such column alone."""
    device = flat.device
    deg = vander.shape[1] - 1
    isnan = torch.isnan(flat)
    has_nan = bool(isnan.any())
    if skipna is None:
        skipna = has_nan
    if not has_nan:
        return lstsq_tall(vander, flat)
    coeffs = torch.full((deg + 1, flat.shape[1]), torch.nan, dtype=torch.float64, device=device)
    if not skipna:
        return coeffs
    finite_cols = ~isnan.any(dim=0)
    if bool(finite_cols.any()):
        coeffs[:, finite_cols] = lstsq_tall(vander, flat[:, finite_cols])
    cols = torch.nonzero(~finite_cols).ravel()
    ok = torch.isfinite(flat[:, cols]).cpu().numpy()
    patterns, inverse = np.unique(ok.T, axis=0, return_inverse=True)
    inverse = inverse.ravel()
    for p, rows in enumerate(patterns):
        if rows.sum() > deg:
            members = cols[torch.from_numpy(np.flatnonzero(inverse == p)).to(device)]
            rows_t = torch.from_numpy(np.flatnonzero(rows)).to(device)
            coeffs[:, members] = lstsq_tall(vander[rows], flat[rows_t][:, members])
    return coeffs


def isin_tensor(data: torch.Tensor, values) -> torch.Tensor:
    """numpy's ``isin``: the test values are compared in ``data``'s dtype,
    those that this dtype cannot hold exactly dropped (they equal no
    element, as under numpy's promotion)."""
    values = to_numpy(values).ravel()
    dtype = torch.empty(0, dtype=data.dtype).numpy().dtype
    with np.errstate(invalid="ignore", over="ignore"):
        cast = values.astype(dtype)
        exact = cast.astype(values.dtype) == values
    return torch.isin(data, torch.from_numpy(cast[exact]).to(data.device))


def _index_tensor(k, size: int, device) -> torch.Tensor:
    """A 1-D position indexer (array, list or bool mask) as an int64
    tensor of positions in [0, size) on ``device``."""
    if is_tensor(k):
        k = torch.nonzero(k).ravel() if k.dtype == torch.bool else k.long()
        return torch.where(k < 0, k + size, k).to(device)
    k = np.asarray(k)
    if k.dtype == bool:
        k = np.flatnonzero(k)
    if k.ndim != 1:
        raise IndexError(f"a tensor payload takes 1-D position indexers, received {k.ndim}-D")
    k = k.astype(np.int64)
    return torch.from_numpy(np.where(k < 0, k + size, k)).to(device)


class Variable:
    """An array or tensor with named dimensions and attributes."""

    __slots__ = ("dims", "data", "attrs", "encoding")

    def __init__(
        self,
        dims: Sequence[Hashable] | Hashable,
        data,
        attrs: Mapping | None = None,
        encoding: Mapping | None = None,
    ):
        data = as_compatible_data(data)
        if isinstance(dims, str):
            dims = (dims,)
        dims = tuple(dims)
        if len(dims) != data.ndim:
            raise ValueError(
                f"dimensions {dims} do not match data with {data.ndim} "
                f"dimensions (shape {tuple(data.shape)})"
            )
        self.dims: Tuple[Hashable, ...] = dims
        self.data = data
        self.attrs = dict(attrs) if attrs else {}
        self.encoding = dict(encoding) if encoding else {}

    # -- basic properties ---------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def sizes(self) -> dict:
        return dict(zip(self.dims, self.shape))

    @property
    def values(self) -> np.ndarray:
        """The payload on the host (a copy of a tensor)."""
        return to_numpy(self.data)

    def __repr__(self) -> str:
        return f"<xdata.Variable {self.dims} {self.shape} {self.dtype}>"

    def copy(self, deep: bool = True, data=None) -> "Variable":
        """Copy; ``data`` replaces the values (it must match the shape)."""
        if data is None:
            data = self.data
            if deep and is_tensor(data):
                data = data.clone()
            elif deep and isinstance(data, np.ndarray):
                data = data.copy()
        else:
            data = as_compatible_data(data)
            if tuple(data.shape) != self.shape:
                raise ValueError(
                    f"Data shape {tuple(data.shape)} must match original shape {self.shape}"
                )
        return Variable(self.dims, data, self.attrs, self.encoding)

    def astype(self, dtype) -> "Variable":
        if is_tensor(self.data):
            return Variable(self.dims, self.data.to(torch_dtype(dtype)), self.attrs)
        return Variable(self.dims, self.data.astype(dtype), self.attrs)

    # -- indexing -----------------------------------------------------------
    def isel(self, indexers: Mapping[Hashable, Any]) -> "Variable":
        key = []
        for dim in self.dims:
            idx = indexers.get(dim, slice(None))
            if isinstance(idx, Variable):
                idx = idx.data
            key.append(idx)
        if is_tensor(self.data):
            return self._isel_tensor(key)
        # Several array indexers, or an array and an integer: sequential
        # (outer) indexing, as xarray does, not numpy's joint fancy
        # indexing (which moves the indexed axes first where a slice
        # separates them; ``xugrid_tpu`` mislabels that case).
        n_array = sum(1 for k in key if not isinstance(k, (slice, int, np.integer)))
        n_int = sum(1 for k in key if isinstance(k, (int, np.integer)))
        if n_array > 1 or (n_array and n_int):
            data = self.data
            new_dims = []
            offset = 0
            for axis, (dim, k) in enumerate(zip(self.dims, key)):
                ax = axis - offset
                if isinstance(k, (int, np.integer)):
                    data = np.take(data, int(k), axis=ax)
                    offset += 1
                elif isinstance(k, slice):
                    sl = [slice(None)] * data.ndim
                    sl[ax] = k
                    data = data[tuple(sl)]
                    new_dims.append(dim)
                else:
                    k = np.asarray(k)
                    # Boolean masks become positions, not 0/1 indices.
                    if k.dtype == bool:
                        k = np.flatnonzero(k)
                    data = np.take(data, k.astype(np.int64), axis=ax)
                    new_dims.append(dim)
            return Variable(tuple(new_dims), data, self.attrs)
        data = self.data[tuple(key)]
        new_dims = tuple(dim for dim, k in zip(self.dims, key) if not isinstance(k, (int, np.integer)))
        return Variable(new_dims, data, self.attrs)

    def _isel_tensor(self, key) -> "Variable":
        """Outer indexing of a tensor payload, one axis after another:
        integers select, slices of positive step view, and arrays,
        masks and slices of negative step gather on the tensor's device."""
        data = self.data
        new_dims = []
        ax = 0
        for dim, k in zip(self.dims, key):
            if isinstance(k, (int, np.integer)):
                data = data.select(ax, int(k))
                continue
            if isinstance(k, slice) and (k.step is None or k.step > 0):
                data = data[(slice(None),) * ax + (k,)]
            else:
                if isinstance(k, slice):
                    k = np.arange(data.shape[ax])[k]
                data = data.index_select(ax, _index_tensor(k, data.shape[ax], data.device))
            new_dims.append(dim)
            ax += 1
        return Variable(tuple(new_dims), data, self.attrs)

    # -- shaping ------------------------------------------------------------
    def transpose(self, *dims: Hashable) -> "Variable":
        if not dims:
            dims = self.dims[::-1]
        if set(dims) != set(self.dims):
            raise ValueError(f"transpose dims {dims} != variable dims {self.dims}")
        if tuple(dims) == self.dims:
            return Variable(self.dims, self.data, self.attrs)
        axes = [self.dims.index(d) for d in dims]
        if is_tensor(self.data):
            return Variable(tuple(dims), self.data.permute(*axes), self.attrs)
        return Variable(tuple(dims), np.transpose(self.data, axes), self.attrs)

    def squeeze(self, dim=None) -> "Variable":
        if dim is None:
            drop = [d for d, s in zip(self.dims, self.shape) if s == 1]
        else:
            drop = [dim] if isinstance(dim, str) else list(dim)
        return self.isel({d: 0 for d in drop})

    def expand_dims(self, dim: Hashable, axis: int = 0) -> "Variable":
        if is_tensor(self.data):
            data = self.data.unsqueeze(axis)
        else:
            data = np.expand_dims(self.data, axis=axis)
        dims = list(self.dims)
        dims.insert(axis, dim)
        return Variable(tuple(dims), data, self.attrs)

    def broadcast_to(self, dims: Sequence[Hashable], sizes: Mapping) -> "Variable":
        """Reorder and insert dimensions to match ``dims``."""
        dims = tuple(dims)
        var = self
        for d in dims:
            if d not in var.dims:
                var = var.expand_dims(d, axis=0)
        var = var.transpose(*dims)
        shape = tuple(sizes[d] for d in dims)
        if var.shape != shape:
            data = var.data.expand(shape) if is_tensor(var.data) else np.broadcast_to(var.data, shape)
            var = Variable(dims, data, var.attrs)
        return var

    # -- math ---------------------------------------------------------------
    def _binary_op(self, other, op, reflexive: bool = False):
        if isinstance(other, Variable):
            self_b, other_b = broadcast_variables(self, other)
            a, b = self_b.data, other_b.data
            dims = self_b.dims
        else:
            a, b = self.data, other
            dims = self.dims
        a, b = common_operands(a, b)
        result = op(b, a) if reflexive else op(a, b)
        return Variable(dims, result)

    def reduce(self, func_name: str, dim=None, skipna=None, **kwargs):
        if dim is None:
            axis = None
            new_dims: Tuple[Hashable, ...] = ()
        else:
            if isinstance(dim, str):
                dim = [dim]
            axis = tuple(self.dims.index(d) for d in dim)
            new_dims = tuple(d for d in self.dims if d not in dim)
        data = self.data
        use_nan = skipna or (skipna is None and func_name in _NAN_SKIPPING and is_floating(data))
        if func_name in ("argmax", "argmin") and isinstance(axis, tuple):
            if len(axis) != 1:
                raise ValueError(f"{func_name} requires a single dimension")
            axis = axis[0]
        if is_tensor(data):
            result = reduce_tensor(data, func_name, axis, bool(use_nan), **kwargs)
        else:
            fname = f"nan{func_name}" if use_nan else func_name
            func = getattr(np, fname, getattr(np, func_name))
            result = func(data, axis=axis, **kwargs)
        if new_dims == ():
            return Variable((), result)
        return Variable(new_dims, result, self.attrs)

    def fillna(self, value) -> "Variable":
        data = self.data
        if is_tensor(data):
            return Variable(self.dims, where_tensor(~torch.isnan(data), data, value), self.attrs)
        return Variable(self.dims, np.where(np.isnan(data), value, data), self.attrs)

    def notnull(self) -> "Variable":
        data = self.data
        if is_tensor(data):
            if is_floating(data):
                return Variable(self.dims, ~torch.isnan(data))
            return Variable(self.dims, torch.ones(self.shape, dtype=torch.bool, device=data.device))
        if is_floating(data):
            return Variable(self.dims, ~np.isnan(data))
        if self.dtype.kind in "mM":  # datetime64/timedelta64: NaT
            return Variable(self.dims, ~np.isnat(data))
        return Variable(self.dims, np.ones(self.shape, dtype=bool))

    def isnull(self) -> "Variable":
        nn = self.notnull()
        return Variable(nn.dims, ~nn.data)


def broadcast_variables(*variables: Variable) -> Tuple[Variable, ...]:
    """Broadcast variables against each other by dimension name."""
    all_dims: list = []
    sizes: dict = {}
    for var in variables:
        for d, s in var.sizes.items():
            if d not in sizes:
                all_dims.append(d)
                sizes[d] = s
            elif sizes[d] != s and s != 1 and sizes[d] != 1:
                raise ValueError(f"conflicting sizes for dimension {d!r}: {sizes[d]} vs {s}")
            else:
                sizes[d] = max(sizes[d], s)
    return tuple(v.broadcast_to(all_dims, sizes) for v in variables)


def _joined(parts):
    """The parts, as tensors on the first tensor's device where any part
    is a tensor."""
    like = next((p for p in parts if is_tensor(p)), None)
    if like is None:
        return parts, False
    return [as_tensor_like(p, like) for p in parts], True


def concat_variables(variables: Sequence[Variable], dim: Hashable) -> Variable:
    first = variables[0]
    if dim in first.dims:
        axis = first.dims.index(dim)
        parts, tensors = _joined([v.transpose(*first.dims).data for v in variables])
        data = torch.cat(parts, dim=axis) if tensors else np.concatenate(parts, axis=axis)
        return Variable(first.dims, data, first.attrs)
    # New dimension: stack.
    parts, tensors = _joined([v.broadcast_to(first.dims, first.sizes).data for v in variables])
    data = torch.stack(parts, dim=0) if tensors else np.stack(parts, axis=0)
    return Variable((dim,) + first.dims, data, first.attrs)
