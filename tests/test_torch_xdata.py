"""
The port's labelled arrays (``xugrid_tpu_torch.xdata``) held on the CPU
against the JAX package's (``xugrid_tpu.xdata``): the same seeded numpy
inputs through both, as a numpy payload and as a torch tensor payload.

A numpy payload runs the same numpy calls as the JAX package's: results
are equal bit for bit.  A tensor payload stays a tensor through every
operation; its selections, shaping and arithmetic are bit-equal too
(but for division by a scalar and powers, one ulp apart), and its
reductions agree at float64 rtol 1e-12 (torch sums in another order
than numpy).
"""

import numpy as np
import pytest
import torch

import xugrid_tpu_torch as xt
from xugrid_tpu import xdata as jx
from xugrid_tpu_torch import xdata as tx

PAYLOADS = ["numpy", "tensor"]


def payload(values, kind):
    return torch.from_numpy(np.array(values)) if kind == "tensor" else np.array(values)


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(8)
    a = rng.normal(size=(4, 5, 6))
    a[rng.random(a.shape) < 0.1] = np.nan
    b = rng.normal(size=(6, 5))
    return {
        "a": a,
        "b": b,
        "coords": {"t": np.arange(4) * 10.0, "x": np.linspace(0.0, 1.0, 6), "y": [3, 1, 2, 5, 4]},
    }


def pair(arrays, kind, name="a", dims=("t", "y", "x")):
    """The same DataArray in both packages: (jax, port)."""
    values = arrays[name]
    coords = {k: v for k, v in arrays["coords"].items() if k in dims}
    attrs = {"units": "m"}
    j = jx.DataArray(values, coords=coords, dims=dims, name=name, attrs=attrs)
    t = tx.DataArray(payload(values, kind), coords=coords, dims=dims, name=name, attrs=attrs)
    return j, t


def assert_same(j, t, kind, exact=True):
    """Equal dims, name, attrs and coordinates; values bit-equal (``exact``)
    or within float64 rtol 1e-12; a tensor payload stayed a tensor."""
    assert isinstance(t, tx.DataArray)
    assert tuple(t.dims) == tuple(j.dims) and t.name == j.name and t.attrs == j.attrs
    assert sorted(t.coords) == sorted(j.coords)
    for k in j.coords:
        assert t._coords[k].dims == j._coords[k].dims
        np.testing.assert_array_equal(t._coords[k].values, np.asarray(j._coords[k].data))
    if kind == "tensor":
        assert isinstance(t.data, torch.Tensor)
    want = np.asarray(j.values)
    got = t.values
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("kind", PAYLOADS)
def test_construction(arrays, kind):
    j, t = pair(arrays, kind)
    assert_same(j, t, kind)
    assert (t.shape, t.sizes, t.ndim, t.size) == (j.shape, j.sizes, j.ndim, j.size)
    # Positional coordinates, a scalar coordinate, dims inferred.
    j2 = jx.DataArray(arrays["b"], coords=[np.arange(6), np.arange(5)], dims=("x", "y")).assign_coords(s=1.5)
    t2 = tx.DataArray(payload(arrays["b"], kind), coords=[np.arange(6), np.arange(5)], dims=("x", "y")).assign_coords(s=1.5)
    assert_same(j2, t2, kind)
    assert tx.DataArray(payload(arrays["b"], kind)).dims == jx.DataArray(arrays["b"]).dims
    with pytest.raises(ValueError, match="conflicting size"):
        tx.DataArray(payload(arrays["b"], kind), coords={"x": np.arange(7)}, dims=("x", "y"))


@pytest.mark.parametrize("kind", PAYLOADS)
def test_isel_integer_and_array_apart(arrays, kind):
    """An integer and an array indexer with a slice between them index
    each axis on its own, in place: numpy's joint fancy indexing would
    move the array's axis first (the JAX package's numpy path mislabels
    that case, so it is held to numpy here)."""
    _, t = pair(arrays, kind)
    out = t.isel(t=1, x=[0, 3])
    assert out.dims == ("y", "x")
    np.testing.assert_array_equal(out.values, arrays["a"][1][:, [0, 3]])
    np.testing.assert_array_equal(out["x"].values, arrays["coords"]["x"][[0, 3]])


ISEL_CASES = {
    "int": {"t": 2},
    "negative int": {"t": -1},
    "slice": {"x": slice(1, 5, 2)},
    "reversed": {"y": slice(None, None, -1)},
    "array": {"x": [4, 0, 2]},
    "negative array": {"x": [-1, 0]},
    "mask": {"y": np.array([True, False, True, True, False])},
    "two arrays": {"x": [1, 3], "y": [4, 0, 2]},
    "int and array": {"t": 1, "y": [2, 2, 0]},
}


@pytest.mark.parametrize("case", list(ISEL_CASES))
@pytest.mark.parametrize("kind", PAYLOADS)
def test_isel(arrays, kind, case):
    j, t = pair(arrays, kind)
    assert_same(j.isel(ISEL_CASES[case]), t.isel(ISEL_CASES[case]), kind)
    assert_same(j.isel(ISEL_CASES[case], drop=True), t.isel(ISEL_CASES[case], drop=True), kind)


SEL_CASES = {
    "label": ({"t": 20.0}, None),
    "labels": ({"y": [5, 3]}, None),
    "slice": ({"t": slice(10.0, 30.0)}, None),
    "nearest": ({"x": 0.43}, "nearest"),
    "no index": ({"t": 1, "y": 2}, None),
}


@pytest.mark.parametrize("case", list(SEL_CASES))
@pytest.mark.parametrize("kind", PAYLOADS)
def test_sel_and_getitem(arrays, kind, case):
    j, t = pair(arrays, kind)
    indexers, method = SEL_CASES[case]
    if case == "no index":
        j, t = j.drop_vars(["t", "y"]), t.drop_vars(["t", "y"])
    assert_same(j.sel(indexers, method=method), t.sel(indexers, method=method), kind)
    assert_same(j[1:3, ::2], t[1:3, ::2], kind)
    assert_same(j["x"], t["x"], "numpy")


@pytest.mark.parametrize("kind", PAYLOADS)
def test_shaping(arrays, kind):
    j, t = pair(arrays, kind)
    assert_same(j.transpose("x", "t", "y"), t.transpose("x", "t", "y"), kind)
    assert_same(j.T, t.T, kind)
    assert_same(j.isel(t=[0]).squeeze(), t.isel(t=[0]).squeeze(), kind)
    assert_same(j.isel(t=[0]).squeeze("t", drop=True), t.isel(t=[0]).squeeze("t", drop=True), kind)
    assert_same(j.expand_dims("layer"), t.expand_dims("layer"), kind)
    assert_same(j.expand_dims({"layer": [1, 2, 3]}), t.expand_dims({"layer": [1, 2, 3]}), kind)
    assert_same(j.expand_dims(band=2, axis=1), t.expand_dims(band=2, axis=1), kind)
    assert_same(j.stack_dims("cell", ["y", "x"]), t.stack_dims("cell", ["y", "x"]), kind)


BINARY = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "truediv": lambda a, b: a / b,
    "pow": lambda a, b: abs(a) ** b,
    "lt": lambda a, b: a < b,
    "eq": lambda a, b: a == b,
    "ge": lambda a, b: a >= b,
}


@pytest.mark.parametrize("op", list(BINARY))
@pytest.mark.parametrize("kind", PAYLOADS)
def test_arithmetic(arrays, kind, op):
    """DataArray with DataArray (broadcast by name, conflicting coordinates
    dropped), with a scalar and with a numpy array, both ways round."""
    f = BINARY[op]
    # torch divides by a scalar as a product with its reciprocal, and its
    # pow is not numpy's: one ulp apart.
    exact = kind == "numpy" or op not in ("truediv", "pow")
    j, t = pair(arrays, kind)
    jb, tb = pair(arrays, kind, name="b", dims=("x", "y"))
    assert_same(f(j, jb), f(t, tb), kind, exact)
    assert_same(f(j, 1.5), f(t, 1.5), kind, exact)
    assert_same(f(2.5, j), f(2.5, t), kind, exact)
    other = arrays["a"][0] * 0.5 + 1.0
    assert_same(f(j.isel(t=0), other), f(t.isel(t=0), other), kind, exact)
    shifted = jx.DataArray(arrays["b"], coords={"x": arrays["coords"]["x"] + 1.0}, dims=("x", "y"), name="a")
    tshifted = tx.DataArray(payload(arrays["b"], kind), coords={"x": arrays["coords"]["x"] + 1.0}, dims=("x", "y"), name="a")
    assert_same(f(j, shifted), f(t, tshifted), kind, exact)


@pytest.mark.parametrize("kind", PAYLOADS)
def test_unary(arrays, kind):
    j, t = pair(arrays, kind)
    assert_same(-j, -t, kind)
    assert_same(abs(j), abs(t), kind)
    assert_same(~(j > 0), ~(t > 0), kind)
    assert_same(j.astype(np.float32), t.astype(np.float32), kind)


REDUCE_DIMS = {"all": None, "one": "x", "two": ["t", "y"]}


@pytest.mark.parametrize("dims", list(REDUCE_DIMS))
@pytest.mark.parametrize("func", ["sum", "mean", "std", "var", "min", "max", "prod", "median"])
@pytest.mark.parametrize("kind", PAYLOADS)
def test_reductions(arrays, kind, func, dims):
    j, t = pair(arrays, kind)
    dim = REDUCE_DIMS[dims]
    exact = kind == "numpy" or func in ("min", "max")
    assert_same(getattr(j, func)(dim), getattr(t, func)(dim), kind, exact=exact)
    assert_same(getattr(j, func)(dim, skipna=False), getattr(t, func)(dim, skipna=False), kind, exact=exact)


@pytest.mark.parametrize("kind", PAYLOADS)
def test_boolean_and_integer_reductions(arrays, kind):
    j, t = pair(arrays, kind)
    for func in ("all", "any"):
        assert_same(getattr(j > 0, func)("x"), getattr(t > 0, func)("x"), kind)
        assert_same(getattr(j > 0, func)(), getattr(t > 0, func)(), kind)
    ints = np.arange(30).reshape(5, 6)
    ji = jx.DataArray(ints, dims=("y", "x"))
    ti = tx.DataArray(payload(ints, kind), dims=("y", "x"))
    for func in ("sum", "mean", "max", "median", "std"):
        assert_same(getattr(ji, func)("x"), getattr(ti, func)("x"), kind, exact=kind == "numpy")
    assert_same(j.var("x", ddof=1), t.var("x", ddof=1), kind, exact=kind == "numpy")


@pytest.mark.parametrize("kind", PAYLOADS)
def test_masking(arrays, kind):
    j, t = pair(arrays, kind)
    jb, tb = pair(arrays, kind, name="b", dims=("x", "y"))
    assert_same(j.where(j > 0), t.where(t > 0), kind)
    assert_same(j.where(jb > 0, -1.0), t.where(tb > 0, -1.0), kind)
    assert_same(j.where(j > 0, jb), t.where(t > 0, tb), kind)
    assert_same(j.fillna(0.0), t.fillna(0.0), kind)
    assert_same(j.fillna(jb), t.fillna(tb), kind)
    assert_same(j.notnull(), t.notnull(), kind)
    assert_same(j.isnull(), t.isnull(), kind)
    ji = jx.DataArray(np.arange(4), dims=("t",))
    ti = tx.DataArray(payload(np.arange(4), kind), dims=("t",))
    assert_same(ji.notnull(), ti.notnull(), kind)


@pytest.mark.parametrize("kind", PAYLOADS)
def test_conversions(arrays, kind):
    j, t = pair(arrays, kind)
    assert_same(j.rename("c"), t.rename("c"), kind)
    assert_same(j.rename({"x": "xx", "a": "c"}), t.rename({"x": "xx", "a": "c"}), kind)
    assert_same(j.drop_vars("t"), t.drop_vars("t"), kind)
    assert_same(j.assign_coords(t=np.arange(4) + 0.5), t.assign_coords(t=np.arange(4) + 0.5), kind)
    deep = t.copy()
    assert_same(j.copy(), deep, kind)
    deep[0, 0, 0] = 99.0
    assert float(t.values[0, 0, 0]) == arrays["a"][0, 0, 0]
    shallow = t.copy(deep=False)
    shallow[0, 0, 0] = 99.0
    assert float(t.values[0, 0, 0]) == 99.0
    np.testing.assert_array_equal(t.to_numpy(), t.values)
    assert isinstance(t.to_numpy(), np.ndarray)
    assert_same(j.copy(data=np.zeros(j.shape)), t.copy(data=payload(np.zeros(t.shape), kind)), kind)
    ds_j, ds_t = j.to_dataset(), t.to_dataset()
    assert sorted(ds_t._variables) == sorted(ds_j._variables) and ds_t._coord_names == ds_j._coord_names


@pytest.mark.parametrize("kind", PAYLOADS)
def test_setitem_and_equality(arrays, kind):
    j, t = pair(arrays, kind)
    j2, t2 = j.copy(), t.copy()
    j2[{"x": [0, 2]}] = 7.0
    t2[{"x": [0, 2]}] = 7.0
    j2[1] = np.ones((5, 6))
    t2[1] = np.ones((5, 6))
    assert_same(j2, t2, kind)
    assert t.equals(t.copy()) and t.identical(t.copy())
    assert t.equals(t.rename("c")) and not t.identical(t.rename("c"))
    assert not t.equals(t2) and not t.equals(t.transpose())
    # A tensor payload equals a numpy one of the same values.
    assert t.equals(pair(arrays, "numpy")[1])


def test_tensor_payload_is_not_copied_implicitly(arrays):
    _, t = pair(arrays, "tensor")
    with pytest.raises(TypeError, match="values"):
        np.asarray(t)
    assert isinstance(t.values, np.ndarray)
    _, n = pair(arrays, "numpy")
    np.testing.assert_array_equal(np.asarray(n), arrays["a"])
    assert "tensor" in repr(t)


def dataset_pair(arrays, kind):
    out = []
    for pkg in (jx, tx):
        ds = pkg.Dataset(
            {
                "a": (("t", "y", "x"), payload(arrays["a"], kind) if pkg is tx else arrays["a"]),
                "b": (("x", "y"), payload(arrays["b"], kind) if pkg is tx else arrays["b"]),
                "s": ((), np.array(2.0)),
            },
            coords={k: (k, np.asarray(v)) for k, v in arrays["coords"].items()},
            attrs={"title": "test"},
        )
        out.append(ds)
    return out


def assert_same_dataset(j, t, kind, exact=True):
    assert sorted(t._variables) == sorted(j._variables)
    assert t._coord_names == j._coord_names and t.attrs == j.attrs
    assert dict(t.sizes) == dict(j.sizes)
    for name in j._variables:
        assert_same(j[name], t[name], kind if name in t.data_vars and t[name].ndim else "numpy", exact)


@pytest.mark.parametrize("kind", PAYLOADS)
def test_dataset(arrays, kind):
    j, t = dataset_pair(arrays, kind)
    assert_same_dataset(j, t, kind)
    assert sorted(t.data_vars) == sorted(j.data_vars) and sorted(t.coords) == sorted(j.coords)
    assert_same_dataset(j.isel(t=[1], x=[0, 3]), t.isel(t=[1], x=[0, 3]), kind)
    assert_same_dataset(j.sel(t=20.0, y=[5, 3]), t.sel(t=20.0, y=[5, 3]), kind)
    assert_same_dataset(j.transpose("x"), t.transpose("x"), kind)
    assert_same_dataset(j.rename({"a": "c", "x": "xx"}), t.rename({"a": "c", "x": "xx"}), kind)
    assert_same_dataset(j.set_coords("s"), t.set_coords("s"), kind)
    assert_same_dataset(j.assign_coords(z=("t", np.ones(4))), t.assign_coords(z=("t", np.ones(4))), kind)
    assert_same_dataset(j.copy(), t.copy(), kind)
    assert_same_dataset(j.drop_vars("b"), t.drop_vars("b"), kind)
    assert t.equals(t.copy()) and t.identical(t.copy()) and not t.equals(t.drop_vars("s"))
    j2, t2 = j.copy(deep=False), t.copy(deep=False)
    j2["c"] = j["a"] * 2.0
    t2["c"] = t["a"] * 2.0
    del j2["b"]
    del t2["b"]
    assert_same_dataset(j2, t2, kind)
    with pytest.raises(ValueError, match="conflicting size"):
        t2["d"] = (("x",), np.zeros(3))


@pytest.mark.parametrize("kind", PAYLOADS)
def test_merge_and_concat(arrays, kind):
    j, t = dataset_pair(arrays, kind)
    ja, ta = pair(arrays, kind)
    jb, tb = pair(arrays, kind, name="b", dims=("x", "y"))
    assert_same_dataset(jx.merge([ja, jb]), tx.merge([ta, tb]), kind)
    assert_same_dataset(j.merge(jb.rename("e")), t.merge(tb.rename("e")), kind)
    with pytest.raises(ValueError, match="conflicting values"):
        t.merge(tb.rename("a").expand_dims("t", axis=0).isel(t=[0, 0, 0, 0]).transpose("t", "y", "x"))
    for dim in ("t", "new"):
        assert_same(jx.concat([ja, ja * 2.0], dim), tx.concat([ta, ta * 2.0], dim), kind)
        assert_same_dataset(jx.concat([j, j], dim), tx.concat([t, t], dim), kind)


@pytest.mark.parametrize("kind", PAYLOADS)
def test_full_like_and_where(arrays, kind):
    j, t = pair(arrays, kind)
    jd, td = dataset_pair(arrays, kind)
    for jf, tf in ((jx.zeros_like, tx.zeros_like), (jx.ones_like, tx.ones_like)):
        assert_same(jf(j), tf(t), kind)
        assert_same_dataset(jf(jd), tf(td), kind)
    assert_same(jx.full_like(j, 3.0, dtype=np.float32), tx.full_like(t, 3.0, dtype=np.float32), kind)
    assert_same(jx.where(j > 0, j, 0.0), tx.where(t > 0, t, 0.0), kind)
    assert_same(jx.where(j > 0, 1.0, 0.0), tx.where(t > 0, 1.0, 0.0), kind)
    np.testing.assert_array_equal(tx.where(arrays["a"] > 0, 1.0, 0.0), jx.where(arrays["a"] > 0, 1.0, 0.0))
    assert_same(jx.full_like(j, 2.0), xt.full_like(t, 2.0), kind)
