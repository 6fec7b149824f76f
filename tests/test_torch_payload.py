"""
The payload methods of the port's labelled arrays held on the CPU against
the JAX package's (``xugrid_tpu.xdata``): the same seeded (4, 5, 6)
inputs, with NaN, ties, an all-NaN slice and an integer payload, through
both, each as a numpy payload and as a torch tensor payload.

- Values, dtype, dims, coordinates, name and attrs agree.  Selections,
  shifts, ranks, fills, arg reductions and counts are bit-equal; the
  reductions, quantiles, cumulative sums and products, dot and polyval
  agree at float64 rtol 1e-12, float32 at rtol 1e-6 (torch sums in
  another order than numpy).
- A tensor payload gives a tensor result, but where the JAX package
  leaves the array world (``to_pandas``, ``to_dataframe``) or the labels
  are not numbers (``idxmax`` over dates).
- Through ``UgridDataArray``/``UgridDataset`` on a small mesh a result
  that keeps a UGRID dimension comes back wrapped with the grid, one
  without comes back bare, as in the JAX package.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
import xugrid_tpu as xu
import xugrid_tpu_torch as xt
from xugrid_tpu import xdata as jx
from xugrid_tpu_torch import xdata as tx

PAYLOADS = ["numpy", "tensor"]
TOLERANCE = {"exact": None, "f64": (1e-12, 1e-14), "f32": (1e-6, 1e-6)}


def payload(values, kind):
    return torch.from_numpy(np.array(values)) if kind == "tensor" else np.array(values)


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(31)
    # Half steps: many ties along every dimension.
    a = np.round(rng.normal(size=(4, 5, 6)) * 2.0) / 2.0
    a[rng.random(a.shape) < 0.15] = np.nan
    a[:, 2, 3] = np.nan  # an all-NaN slice along t
    a[1:3, 0, 0] = np.nan  # an interior gap
    a[0, 1, 1] = np.nan  # a leading NaN
    a[3, 1, 2] = np.nan  # a trailing NaN
    smooth = rng.normal(size=(4, 5, 6))
    smooth[rng.random(smooth.shape) < 0.1] = np.nan
    return {
        "a": a,
        "f32": smooth.astype(np.float32),
        "i": rng.integers(0, 5, size=(4, 5, 6)),
        "w": rng.normal(size=(6, 4)),
        "coords": {"t": np.array([0.0, 10.0, 25.0, 30.0]), "x": np.linspace(0.0, 1.0, 6), "y": np.array([3, 1, 2, 5, 4])},
    }


def pair(arrays, kind, name="a", dims=("t", "y", "x"), values=None):
    """The same DataArray in both packages: (jax, port)."""
    values = arrays[name] if values is None else values
    coords = {k: v for k, v in arrays["coords"].items() if k in dims}
    attrs = {"units": "m"}
    j = jx.DataArray(values, coords=coords, dims=dims, name=name, attrs=attrs)
    t = tx.DataArray(payload(values, kind), coords=coords, dims=dims, name=name, attrs=attrs)
    return j, t


def dataset_pair(arrays, kind):
    out = []
    for pkg in (jx, tx):
        wrap = (lambda v: payload(v, kind)) if pkg is tx else np.array
        ds = pkg.Dataset(
            {
                "a": (("t", "y", "x"), wrap(arrays["a"])),
                "i": (("t", "y", "x"), wrap(arrays["i"])),
                "w": (("x", "t"), wrap(arrays["w"])),
                "s": ((), np.array(2.0)),
            },
            coords={**{k: (k, v) for k, v in arrays["coords"].items()}, "label": ("y", np.arange(5) * 2)},
            attrs={"title": "test"},
        )
        out.append(ds)
    return out


#: Variables of the test datasets that are numpy in either payload kind.
HOST_VARIABLES = {"s", "d", "label", "tag"}


def same(j, t, kind, tol="exact", tensor=True):
    """Equal dims, name, attrs, coordinates and dtype; values bit-equal or
    within ``TOLERANCE[tol]``; a tensor payload gave a tensor (``tensor``)."""
    if isinstance(j, jx.Dataset):
        assert isinstance(t, tx.Dataset)
        assert sorted(t._variables) == sorted(j._variables)
        assert t._coord_names == j._coord_names and t.attrs == j.attrs
        assert dict(t.sizes) == dict(j.sizes)
        for name in j._variables:
            is_payload = name in t.data_vars and name not in HOST_VARIABLES
            same(j[name], t[name], kind, tol, tensor and is_payload)
        return
    assert isinstance(t, tx.DataArray), type(t)
    assert tuple(t.dims) == tuple(j.dims) and t.name == j.name and t.attrs == j.attrs
    assert sorted(t.coords) == sorted(j.coords)
    for k in j.coords:
        assert t._coords[k].dims == j._coords[k].dims, k
        np.testing.assert_array_equal(t._coords[k].values, np.asarray(j._coords[k].data), err_msg=k)
    if kind == "tensor" and tensor:
        assert isinstance(t.data, torch.Tensor)
    want, got = np.asarray(j.values), t.values
    assert got.shape == want.shape
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if TOLERANCE[tol] is None or want.dtype.kind not in "fc":
        np.testing.assert_array_equal(got, want)
    else:
        rtol, atol = TOLERANCE[tol]
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# -- DataArray ------------------------------------------------------------------
@pytest.mark.parametrize("kind", PAYLOADS)
def test_index_conversion_and_passthrough(arrays, kind):
    j, t = pair(arrays, kind)
    for dim in ("t", "y"):
        pd.testing.assert_index_equal(t.get_index(dim), j.get_index(dim))
    jn, tn = j.drop_vars("y"), t.drop_vars("y")
    pd.testing.assert_index_equal(tn.get_index("y"), jn.get_index("y"))
    pd.testing.assert_series_equal(t.isel(t=1, y=2).to_pandas(), j.isel(t=1, y=2).to_pandas())
    assert t.isel(t=1, y=2, x=0).to_pandas() == j.isel(t=1, y=2, x=0).to_pandas() or np.isnan(
        t.isel(t=1, y=2, x=0).to_pandas()
    )
    pd.testing.assert_frame_equal(t.to_dataframe(), j.to_dataframe())
    pd.testing.assert_frame_equal(t.to_dataframe("v", dim_order=["x", "t", "y"]), j.to_dataframe("v", dim_order=["x", "t", "y"]))
    scalar = j.assign_coords(s=1.5), t.assign_coords(s=1.5)
    same(scalar[0].reset_coords(), scalar[1].reset_coords(), kind)
    same(scalar[0].reset_coords(["s"]), scalar[1].reset_coords(["s"]), kind)
    jb, tb = pair(arrays, kind, name="w", dims=("x", "t"))
    same(j.isel(t=0).broadcast_like(jb), t.isel(t=0).broadcast_like(tb), kind)
    same(j.assign_attrs(source="model", units="cm"), t.assign_attrs(source="model", units="cm"), kind)
    assert t.attrs == {"units": "m"}
    for name in ("compute", "load", "chunk", "persist"):
        assert getattr(t, name)() is t
    assert t.pipe(lambda da, k: da * k, 2.0).equals(t * 2.0)


ELEMENTWISE = {
    "clip": lambda da: da.clip(-0.5, 1.0),
    "clip min": lambda da: da.clip(min=0.0),
    "round": lambda da: da.round(),
    "round 1": lambda da: da.round(1),
    "isin": lambda da: da.isin([0.5, -1.0, 0.1]),
    "diff t": lambda da: da.diff("t"),
    "diff x 2": lambda da: da.diff("x", n=2),
    "shift t": lambda da: da.shift(t=2),
    "shift x -1": lambda da: da.shift({"x": -1}, fill_value=-9.0),
    "shift two": lambda da: da.shift(t=1, y=-2),
    "shift beyond": lambda da: da.shift(t=7),
    "roll": lambda da: da.roll(x=2),
    "roll coords": lambda da: da.roll(t=-1, y=3, roll_coords=True),
    "sortby y": lambda da: da.sortby("y"),
    "sortby descending": lambda da: da.sortby(["x", "t"], ascending=False),
    "ffill": lambda da: da.ffill("t"),
    "ffill limit": lambda da: da.ffill("t", limit=1),
    "bfill": lambda da: da.bfill("x"),
    "bfill limit": lambda da: da.bfill("t", limit=1),
    "rank t": lambda da: da.rank("t"),
    "rank x": lambda da: da.rank("x"),
    "dropna any": lambda da: da.dropna("x"),
    "dropna all": lambda da: da.dropna("y", how="all"),
    "count t": lambda da: da.count("t"),
    "count all": lambda da: da.count(),
    "argmax t": lambda da: da.argmax("t"),
    "argmin x": lambda da: da.argmin("x"),
    "idxmax t": lambda da: da.idxmax("t"),
    "idxmin y": lambda da: da.idxmin("y"),
    "idxmax keep NaN": lambda da: da.idxmax("t", skipna=False),
    "where drop": lambda da: da.where(da > 1.0, drop=True),
}


@pytest.mark.parametrize("case", list(ELEMENTWISE))
@pytest.mark.parametrize("kind", PAYLOADS)
def test_exact_methods(arrays, kind, case):
    """Selections, shifts, ranks, fills, counts and arg reductions: bit
    for bit, float64 and the integer payload."""
    f = ELEMENTWISE[case]
    j, t = pair(arrays, kind)
    same(f(j), f(t), kind)
    if case.startswith(("ffill", "bfill", "rank", "round", "isin", "where", "idxmax keep")):
        return  # float-only semantics, or a cast the JAX package makes
    ji, ti = pair(arrays, kind, name="i")
    same(f(ji), f(ti), kind)


@pytest.mark.parametrize("kind", PAYLOADS)
def test_integer_payload_casts(arrays, kind):
    """An integer payload: a NaN shift fill and a float reindex fill make
    float64; an integer fill keeps the dtype; ranks and fills are float64;
    a float clip bound makes float64."""
    ji, ti = pair(arrays, kind, name="i")
    for f in (
        lambda da: da.shift(t=1),
        lambda da: da.shift(t=1, fill_value=-1),
        lambda da: da.reindex(t=[0.0, 5.0, 30.0]),
        lambda da: da.reindex(t=[0.0, 5.0, 30.0], fill_value=-1),
        lambda da: da.rank("t"),
        lambda da: da.ffill("t"),
        lambda da: da.clip(0.5, 3),
        lambda da: da.clip(1, 3),
        lambda da: da.round(),
        lambda da: da.isin([1, 2.5, 3]),
        lambda da: (da > 2).diff("x"),
        lambda da: (da > 2).cumsum("t"),
    ):
        same(f(ji), f(ti), kind)


@pytest.mark.parametrize("kind", PAYLOADS)
def test_arg_reductions_on_ties_and_nan(arrays, kind):
    """The first of tied extremes, a NaN winning without skipna, the
    all-NaN slice a NaN label, labels of a date index on the host."""
    values = np.array([[1.0, 3.0, 3.0, np.nan], [np.nan, np.nan, np.nan, np.nan], [2.0, 2.0, -1.0, -1.0]])
    dates = np.array(["2000-01-01", "2000-01-02", "2000-01-03", "2000-01-04"], dtype="datetime64[ns]")
    for coords in ({"t": [0.5, 1.5, 2.5, 3.5]}, {"t": dates}, {}):
        j = jx.DataArray(values, coords=coords, dims=("y", "t"), name="v")
        t = tx.DataArray(payload(values, kind), coords=coords, dims=("y", "t"), name="v")
        numeric = "t" not in coords or coords["t"] is not dates
        for f in (
            lambda da: da.argmax("t"),
            lambda da: da.argmin("t"),
            lambda da: da.argmax(),
            lambda da: da.idxmax("t"),
            lambda da: da.idxmin("t"),
            lambda da: da.idxmax("t", skipna=False),
            lambda da: da.idxmin("y", skipna=False),
        ):
            same(f(j), f(t), kind, tensor=numeric)


@pytest.mark.parametrize("kind", PAYLOADS)
def test_cumulative_methods(arrays, kind):
    j, t = pair(arrays, kind)
    for dim in ("t", "x"):
        same(j.cumsum(dim), t.cumsum(dim), kind, "f64")
        same(j.cumprod(dim), t.cumprod(dim), kind, "f64")
    ji, ti = pair(arrays, kind, name="i")
    same(ji.cumsum("y"), ti.cumsum("y"), kind)
    same(ji.cumprod("t"), ti.cumprod("t"), kind)
    jf, tf = pair(arrays, kind, name="f32")
    same(jf.cumsum("t"), tf.cumsum("t"), kind, "f32")
    j1, t1 = j.isel(y=0, x=4), t.isel(y=0, x=4)
    same(j1.cumsum(), t1.cumsum(), kind, "f64")


QUANTILES = {
    "scalar": (0.3, "t"),
    "array": ([0.1, 0.5, 0.9], "t"),
    "two dims": ([0.25, 0.75], ["t", "x"]),
    "all": (0.5, None),
    "ends": ([0.0, 1.0], "y"),
}


@pytest.mark.parametrize("case", list(QUANTILES))
@pytest.mark.parametrize("name", ["a", "f32", "i"])
@pytest.mark.parametrize("kind", PAYLOADS)
def test_quantile(arrays, kind, name, case):
    """float64 results, as numpy gives them for a float64 ``q``.  For
    float32 data numpy subtracts the two neighbours in float32 before it
    interpolates in float64, the port in float64: rtol 1e-6 there."""
    q, dim = QUANTILES[case]
    j, t = pair(arrays, kind, name=name)
    tol = "f32" if name == "f32" else "f64"
    same(j.quantile(q, dim), t.quantile(q, dim), kind, tol)
    same(j.quantile(q, dim, skipna=False), t.quantile(q, dim, skipna=False), kind, tol)


@pytest.mark.parametrize("kind", PAYLOADS)
def test_float32_reductions(arrays, kind):
    j, t = pair(arrays, kind, name="f32")
    for func in ("sum", "mean", "std", "var", "median", "min", "max"):
        same(getattr(j, func)("t"), getattr(t, func)("t"), kind, "f32")
    # Ranks and fills of float32 data: float64, bit for bit.
    for dim in ("t", "x"):
        same(j.rank(dim), t.rank(dim), kind)
        same(j.ffill(dim), t.ffill(dim), kind)


INTERPOLATIONS = {
    "linear": {},
    "linear extrapolate": {"fill_value": "extrapolate"},
    "nearest": {"method": "nearest"},
    "nearest extrapolate": {"method": "nearest", "fill_value": "extrapolate"},
}


@pytest.mark.parametrize("case", list(INTERPOLATIONS))
@pytest.mark.parametrize("kind", PAYLOADS)
def test_interpolate_na(arrays, kind, case):
    """Along t over its uneven coordinate, along x and y over positions:
    bit for bit (the same arithmetic as np.interp), float64."""
    kwargs = INTERPOLATIONS[case]
    j, t = pair(arrays, kind)
    same(j.interpolate_na("t", **kwargs), t.interpolate_na("t", **kwargs), kind)
    jn, tn = j.drop_vars("x"), t.drop_vars("x")
    same(jn.interpolate_na("x", **kwargs), tn.interpolate_na("x", **kwargs), kind)
    jf, tf = pair(arrays, kind, name="f32")
    jf, tf = jf.sortby("y"), tf.sortby("y")
    same(jf.interpolate_na("y", **kwargs), tf.interpolate_na("y", **kwargs), kind)
    with pytest.raises(ValueError, match="increasing coordinate"):
        t.interpolate_na("y", **kwargs)


@pytest.mark.parametrize("kind", PAYLOADS)
def test_dot(arrays, kind):
    j, t = pair(arrays, kind)
    jw, tw = pair(arrays, kind, name="w", dims=("x", "t"))
    jz, tz = j.fillna(0.0), t.fillna(0.0)
    same(jz.dot(jw), tz.dot(tw), kind, "f64")
    same(jz.dot(jw, dims=["x", "t"]), tz.dot(tw, dims=["x", "t"]), kind, "f64")
    # A numpy weight vector against a float32 payload: promoted as numpy does.
    jv = jx.DataArray(arrays["coords"]["t"], dims=("t",), name="wt")
    tv = tx.DataArray(arrays["coords"]["t"], dims=("t",), name="wt")
    jf, tf = pair(arrays, kind, name="f32")
    same(jf.fillna(0.0).dot(jv), tf.fillna(0.0).dot(tv), kind, "f64")
    jf32 = jx.DataArray(arrays["coords"]["t"].astype(np.float32), dims=("t",), name="wt")
    tf32 = tx.DataArray(payload(arrays["coords"]["t"].astype(np.float32), kind), dims=("t",), name="wt")
    same(jf.fillna(0.0).dot(jf32), tf.fillna(0.0).dot(tf32), kind, "f32")


REINDEX = {
    "exact": ({"t": [30.0, 0.0, 12.0]}, {}),
    "nearest": ({"t": [-3.0, 4.0, 18.0, 27.5, 40.0]}, {"method": "nearest"}),
    "ffill": ({"t": [-1.0, 10.0, 11.0, 31.0]}, {"method": "ffill"}),
    "bfill": ({"t": [-1.0, 10.0, 11.0, 31.0]}, {"method": "bfill"}),
    "tolerance": ({"t": [1.0, 9.0, 20.0]}, {"method": "nearest", "tolerance": 2.0}),
    "fill": ({"y": [5, 6, 1]}, {"fill_value": -7.0}),
    "two dims": ({"y": [4, 3], "x": [0.2, 0.0]}, {}),
}


@pytest.mark.parametrize("case", list(REINDEX))
@pytest.mark.parametrize("kind", PAYLOADS)
def test_reindex(arrays, kind, case):
    indexers, kwargs = REINDEX[case]
    j, t = pair(arrays, kind)
    j, t = j.assign_coords(label=("t", np.arange(4))), t.assign_coords(label=("t", np.arange(4)))
    same(j.reindex(indexers, **kwargs), t.reindex(indexers, **kwargs), kind)
    target = jx.DataArray(np.zeros(3), coords={"t": [25.0, 0.0, 5.0]}, dims=("t",))
    ttarget = tx.DataArray(np.zeros(3), coords={"t": [25.0, 0.0, 5.0]}, dims=("t",))
    same(j.reindex_like(target, **kwargs), t.reindex_like(ttarget, **kwargs), kind)


def test_reindex_refuses_duplicate_labels(arrays):
    _, t = pair(arrays, "tensor")
    t = t.assign_coords(t=[0.0, 1.0, 1.0, 2.0])
    with pytest.raises(ValueError, match="duplicate labels"):
        t.reindex(t=[1.0])
    with pytest.raises(ValueError, match="unknown reindex method"):
        t.reindex(t=[1.0], method="cubic")


# -- Dataset --------------------------------------------------------------------
DATASET_REDUCE = {"t": "t", "two": ["t", "x"], "all": None, "x": "x"}


@pytest.mark.parametrize("dims", list(DATASET_REDUCE))
@pytest.mark.parametrize("func", ["sum", "mean", "std", "var", "min", "max", "prod", "all", "any", "median"])
@pytest.mark.parametrize("kind", PAYLOADS)
def test_dataset_reductions(arrays, kind, func, dims):
    """Coordinates over a reduced dimension go, others (scalars always)
    stay; variables over none of the dims stay as they are."""
    j, t = dataset_pair(arrays, kind)
    dim = DATASET_REDUCE[dims]
    exact = func in ("min", "max", "all", "any")
    same(getattr(j, func)(dim), getattr(t, func)(dim), kind, "exact" if exact else "f64")
    if func not in ("all", "any"):
        same(getattr(j, func)(dim, skipna=False), getattr(t, func)(dim, skipna=False), kind, "exact" if exact else "f64")


DATASET_METHODS = {
    "reset_coords": lambda ds: ds.reset_coords(),
    "reset_coords drop": lambda ds: ds.reset_coords("label", drop=True),
    "drop_dims": lambda ds: ds.drop_dims("x"),
    "drop_dims ignore": lambda ds: ds.drop_dims(["y", "z"], errors="ignore"),
    "rename_dims": lambda ds: ds.rename_dims(x="xx"),
    "rename_vars": lambda ds: ds.rename_vars({"a": "b", "label": "tag"}),
    "assign": lambda ds: ds.assign(c=ds["a"] * 2.0, d=(("y",), np.arange(5.0))),
    "map": lambda ds: ds.map(lambda da: da * 2),
    "apply": lambda ds: ds.apply(lambda da, k: da + k, 1),
    "pipe": lambda ds: ds.pipe(lambda d: d.drop_vars("s")),
    "where": lambda ds: ds.where(ds["a"] > 0),
    "where drop": lambda ds: ds.where(ds["a"] > 1.0, drop=True),
    "fillna": lambda ds: ds.fillna(0.0),
    "count": lambda ds: ds.count("t"),
    "count all": lambda ds: ds.count(),
    "diff": lambda ds: ds.diff("t"),
    "shift": lambda ds: ds.shift(t=1, fill_value=0.0),
    "shift NaN": lambda ds: ds.shift(x=-2),
    "roll": lambda ds: ds.roll(y=2, roll_coords=True),
    "sortby": lambda ds: ds.sortby("y"),
    "sortby label": lambda ds: ds.sortby("label", ascending=False),
    "dropna": lambda ds: ds.dropna("x"),
    "dropna subset all": lambda ds: ds.dropna("y", how="all", subset=["a"]),
    "reindex": lambda ds: ds.reindex(t=[30.0, 5.0, 0.0]),
    "reindex nearest": lambda ds: ds.reindex({"t": [2.0, 28.0]}, method="nearest"),
    "expand_dims": lambda ds: ds.expand_dims("layer"),
    "expand_dims values": lambda ds: ds.expand_dims({"layer": [1, 2]}),
}


@pytest.mark.parametrize("case", list(DATASET_METHODS))
@pytest.mark.parametrize("kind", PAYLOADS)
def test_dataset_methods(arrays, kind, case):
    f = DATASET_METHODS[case]
    j, t = dataset_pair(arrays, kind)
    same(f(j), f(t), kind)


@pytest.mark.parametrize("kind", PAYLOADS)
def test_dataset_quantile_to_array_and_frames(arrays, kind):
    j, t = dataset_pair(arrays, kind)
    same(j.quantile([0.1, 0.9], "t"), t.quantile([0.1, 0.9], "t"), kind, "f64")
    same(j.quantile(0.5), t.quantile(0.5), kind, "f64")
    jj, tt = j.drop_vars("s"), t.drop_vars("s")
    same(jj.to_array(), tt.to_array(), kind)
    same(jj.to_array("var", name="stack"), tt.to_array("var", name="stack"), kind)
    pd.testing.assert_frame_equal(tt.to_dataframe(), jj.to_dataframe())
    pd.testing.assert_frame_equal(tt.to_dataframe(["y", "x", "t"]), jj.to_dataframe(["y", "x", "t"]))
    pd.testing.assert_frame_equal(t.isel(t=0, x=0, y=0).to_dataframe(), j.isel(t=0, x=0, y=0).to_dataframe())
    other_j = jx.Dataset(coords={"t": ("t", np.array([25.0, 0.0]))})
    other_t = tx.Dataset(coords={"t": ("t", np.array([25.0, 0.0]))})
    same(j.reindex_like(other_j), t.reindex_like(other_t), kind)
    assert t.compute() is t and t.load() is t


# -- xdata functions --------------------------------------------------------------
@pytest.mark.parametrize("kind", PAYLOADS)
def test_align_and_broadcast(arrays, kind):
    j, t = pair(arrays, kind)
    jw, tw = pair(arrays, kind, name="w", dims=("x", "t"))
    assert tx.align(t, tw) == (t, tw)
    with pytest.raises(ValueError, match="cannot align"):
        tx.align(t, tw.isel(x=[0, 1]))
    for got, want in zip(tx.broadcast(t.isel(y=0), tw), jx.broadcast(j.isel(y=0), jw)):
        same(want, got, kind)


def mean_and_spread(x):
    return x.mean(), x.max() - x.min()


@pytest.mark.parametrize("kind", PAYLOADS)
def test_apply_ufunc(arrays, kind):
    j, t = pair(arrays, kind)
    jz, tz = j.fillna(0.0), t.fillna(0.0)
    kwargs = {"input_core_dims": [["t"]], "output_core_dims": [[]]}
    same(
        jx.apply_ufunc(lambda x: x.sum(-1), jz, **kwargs), tx.apply_ufunc(lambda x: x.sum(-1), tz, **kwargs), kind, "f64"
    )
    calls = []

    def counted_mean(x):
        calls.append(type(x))
        return x.mean()

    same(
        jx.apply_ufunc(counted_mean, jz, vectorize=True, **kwargs),
        tx.apply_ufunc(counted_mean, tz, vectorize=True, **kwargs),
        kind, "f64",
    )
    # np.vectorize's semantics: one call per (y, x) with a (t,) slice (the
    # JAX package's np.vectorize adds a first call to find the dtype).
    assert calls[-30:] == [torch.Tensor if kind == "tensor" else np.ndarray] * 30
    two = {"input_core_dims": [["t"]], "output_core_dims": [[], []]}
    got = tx.apply_ufunc(mean_and_spread, tz, vectorize=True, **two)
    want = jx.apply_ufunc(mean_and_spread, jz, vectorize=True, **two)
    for g, w in zip(got, want):
        same(w, g, kind, "f64")
    # Core dims on two inputs, broadcast between them, and a scalar.
    jw, tw = pair(arrays, kind, name="w", dims=("x", "t"))
    args = {"input_core_dims": [["t"], ["t"]]}
    same(
        jx.apply_ufunc(lambda a, b, k: (a * b).sum(-1) * k, jz, jw, 2.0, input_core_dims=[["t"], ["t"], []]),
        tx.apply_ufunc(lambda a, b, k: (a * b).sum(-1) * k, tz, tw, 2.0, input_core_dims=[["t"], ["t"], []]),
        kind, "f64",
    )
    same(
        jx.apply_ufunc(lambda a, b: (a * b).sum(), jz, jw, vectorize=True, **args),
        tx.apply_ufunc(lambda a, b: (a * b).sum(), tz, tw, vectorize=True, **args),
        kind, "f64",
    )


@pytest.mark.parametrize("kind", PAYLOADS)
def test_polyval(arrays, kind):
    coeffs_values = np.array([[0.5, -1.0, 2.0], [1.5, 0.0, -0.25]]).T  # (degree, y=2)
    jc = jx.DataArray(coeffs_values, coords={"degree": [2, 1, 0]}, dims=("degree", "y"), name="c")
    tc = tx.DataArray(payload(coeffs_values, kind), coords={"degree": [2, 1, 0]}, dims=("degree", "y"), name="c")
    x = arrays["coords"]["t"]
    jx_, tx_ = (pkg.DataArray(x, coords={"t": x}, dims=("t",)) for pkg in (jx, tx))
    same(jx.polyval(jx_, jc), tx.polyval(tx_, tc), kind, "f64")
    same(jx.polyval(x, jc), tx.polyval(x, tc), kind, "f64")
    jd = jx.Dataset({"h_polyfit_coefficients": jc, "other": (("y",), np.zeros(2))})
    td = tx.Dataset({"h_polyfit_coefficients": tc, "other": (("y",), np.zeros(2))})
    same(jx.polyval(jx_, jd), tx.polyval(tx_, td), kind, "f64")


@pytest.mark.parametrize("kind", PAYLOADS)
def test_testing_functions(arrays, kind):
    _, t = pair(arrays, kind)
    _, n = pair(arrays, "numpy")
    ds = dataset_pair(arrays, kind)[1]
    tx.testing.assert_equal(t, n)
    tx.testing.assert_identical(t, t.copy())
    tx.testing.assert_identical(ds, ds.copy())
    tx.testing.assert_allclose(t, n + 1e-9, rtol=0, atol=1e-8)
    tx.testing.assert_allclose(t.data, n.data)
    with pytest.raises(AssertionError):
        tx.testing.assert_identical(t, t.rename("b"))
    with pytest.raises(AssertionError):
        tx.testing.assert_equal(t, t + 1.0)
    with pytest.raises(AssertionError):
        tx.testing.assert_allclose(t, n + 1e-3)


# -- UgridDataArray / UgridDataset ------------------------------------------------
@pytest.fixture(scope="module")
def mesh():
    (verts, faces), _ = chip_smoke.bench_meshes(4, 2, np.random.default_rng(5))
    rng = np.random.default_rng(6)
    values = np.round(rng.normal(size=(5, len(faces))) * 2.0) / 2.0
    values[rng.random(values.shape) < 0.2] = np.nan
    return verts, faces, values


def ugrid_pair(mesh, kind):
    verts, faces, values = mesh
    out = []
    for pkg in (xu, xt):
        grid = pkg.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
        data = payload(values, kind) if pkg is xt else values
        ds = pkg.xdata.Dataset(
            {"h": (("time", grid.face_dimension), data), "g": (("time", grid.face_dimension), data * 2.0)},
            coords={"time": ("time", np.array([0.0, 1.0, 2.0, 4.0, 8.0]))},
        )
        out.append(pkg.UgridDataset(ds, grid))
    return out


UGRID_CASES = {
    "mean time": lambda o: o.mean("time"),
    "mean all": lambda o: o.mean(),
    "max face": lambda o: o.max(o.grid.face_dimension),
    "std time": lambda o: o.std("time"),
    "median time": lambda o: o.median("time"),
    "count time": lambda o: o.count("time"),
    "quantile": lambda o: o.quantile([0.1, 0.9], "time"),
    "quantile face": lambda o: o.quantile(0.5, o.grid.face_dimension),
    "shift": lambda o: o.shift(time=1),
    "roll": lambda o: o.roll(time=2),
    "diff": lambda o: o.diff("time"),
    "fillna": lambda o: o.fillna(0.0),
    "where drop": lambda o: o.where(o["h"] > 0.5, drop=True),
    "sortby": lambda o: o.sortby("time", ascending=False),
    "reindex": lambda o: o.reindex(time=[4.0, 0.0, 3.0]),
    "to_array": lambda o: o.to_array(),
}


@pytest.mark.parametrize("case", list(UGRID_CASES))
@pytest.mark.parametrize("kind", PAYLOADS)
def test_ugrid_dataset_methods(mesh, kind, case):
    f = UGRID_CASES[case]
    jds, tds = ugrid_pair(mesh, kind)
    want, got = f(jds), f(tds)
    wrapped = isinstance(want, (xu.UgridDataset, xu.UgridDataArray))
    assert isinstance(got, (xt.UgridDataset, xt.UgridDataArray)) == wrapped
    if wrapped:
        assert type(got).__name__ == type(want).__name__
        np.testing.assert_array_equal(got.grid.face_node_connectivity, want.grid.face_node_connectivity)
        want, got = want.obj, got.obj
    same(want, got, kind, "f64")


UGRID_ARRAY_CASES = {
    "idxmax time": lambda o: o.idxmax("time"),
    "idxmin face": lambda o: o.idxmin(o.grid.face_dimension),
    "argmax face": lambda o: o.argmax(o.grid.face_dimension),
    "rank": lambda o: o.rank("time"),
    "ffill": lambda o: o.ffill("time", limit=1),
    "bfill": lambda o: o.bfill("time"),
    "interpolate_na": lambda o: o.interpolate_na("time"),
    "cumsum": lambda o: o.cumsum("time"),
    "clip": lambda o: o.clip(-1.0, 1.0),
    "isin": lambda o: o.isin([0.5, 1.0]),
    "dot": lambda o: o.fillna(0.0).dot(o.isel({o.grid.face_dimension: 0}).fillna(1.0)),
    "dropna face": lambda o: o.dropna(o.grid.face_dimension),
    "sum face": lambda o: o.sum(o.grid.face_dimension),
}


@pytest.mark.parametrize("case", list(UGRID_ARRAY_CASES))
@pytest.mark.parametrize("kind", PAYLOADS)
def test_ugrid_dataarray_methods(mesh, kind, case):
    f = UGRID_ARRAY_CASES[case]
    jds, tds = ugrid_pair(mesh, kind)
    want, got = f(jds["h"]), f(tds["h"])
    wrapped = isinstance(want, xu.UgridDataArray)
    assert isinstance(got, xt.UgridDataArray) == wrapped
    if wrapped:
        assert got.grid.n_face == want.grid.n_face
        want, got = want.obj, got.obj
    same(want, got, kind, "f64")
