"""
The port's grouped and windowed methods of labelled arrays
(``xugrid_tpu_torch/xdata/grouped.py`` and the DataArray/Dataset methods
around them: groupby, resample, rolling, coarsen, weighted, interp and
interp_like, differentiate and integrate, polyfit, stack and unstack, the
index methods, map_blocks) held on the CPU against the JAX package's.

Every case runs on the same seeded numpy data in both packages, the
port's payload a numpy array or a CPU tensor, float32 or float64, with
NaN.  Labels, bins, dims, coordinates and counts must be equal; values
within rtol 1e-12 (float64 input), 1e-6 (float32 input) or 1e-9
(polyfit); a tensor payload's result is a tensor on the payload's device,
and a numpy payload's a numpy array.  The UGRID wrappers forward these
methods as the JAX package's do: a result that keeps the UGRID dimension
comes back wrapped from a direct method, and grouped objects pass through
unwrapped.
"""

import numpy as np
import pytest
import torch

import xugrid_tpu as xu
import xugrid_tpu_torch as xt

PACKAGES = {"jax": xu, "torch": xt}
N_TIME, NX, NY = 24, 6, 5


def source_arrays(dtype, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(N_TIME, NX, NY)).astype(dtype)
    data[rng.random(data.shape) < 0.1] = np.nan
    data[:, 0, 0] = np.nan  # an all-NaN column
    weights = rng.uniform(0.5, 2.0, size=(NX, NY))
    weights[1, 1] = 0.0
    return data, weights


def coords():
    rng = np.random.default_rng(1)
    time = np.datetime64("2000-01-01T00", "ns") + np.arange(N_TIME) * np.timedelta64(1, "h")
    return {
        "time": time,
        "x": np.cumsum(rng.uniform(0.5, 1.5, NX)),  # uneven
        "y": np.arange(NY) * 2.0,  # even
        "hour": ("time", (np.arange(N_TIME) * 5) % 4),
        "t": ("time", np.cumsum(rng.uniform(0.5, 1.5, N_TIME))),
        "label": ("x", np.array(["a", "b", "a", "c", "b", "a"])),
    }


def make(pkg, payload, dtype, seed=0):
    """The (time, x, y) DataArray of one package; the port's payload a
    numpy array or a CPU tensor."""
    data, _ = source_arrays(dtype, seed)
    if pkg is xt and payload == "tensor":
        data = torch.from_numpy(data)
    c = {k: v for k, v in coords().items()}
    return pkg.xdata.DataArray(data, dims=("time", "x", "y"), coords=c, name="h", attrs={"units": "m"})


def weights_of(pkg, payload):
    _, w = source_arrays(np.float64)
    if pkg is xt and payload == "tensor":
        w = torch.from_numpy(w)
    return pkg.xdata.DataArray(w, dims=("x", "y"))


def values_of(data):
    if isinstance(data, torch.Tensor):
        return data.numpy()
    return np.asarray(data)


def assert_same(got, want, payload, rtol):
    """Equal types, dims, coordinates (exactly), dtypes and values (within
    rtol; NaN where NaN), the port's payload of the payload's kind."""
    if isinstance(want, xu.xdata.Dataset):
        assert isinstance(got, xt.xdata.Dataset)
        assert sorted(got._variables) == sorted(want._variables)
        assert got._coord_names == want._coord_names
        for name in want._variables:
            assert_variable(got._variables[name], want._variables[name], payload, rtol, name in want._coord_names)
        return
    assert isinstance(got, xt.xdata.DataArray), type(got)
    assert got.name == want.name
    assert_variable(got.variable, want.variable, payload, rtol, False)
    assert sorted(got._coords) == sorted(want._coords)
    for name, var in want._coords.items():
        assert_variable(got._coords[name], var, "numpy", 0.0, True)


def assert_variable(got, want, payload, rtol, coordinate):
    assert got.dims == want.dims
    want_values = np.asarray(want.data)
    if coordinate or payload == "numpy" or want_values.dtype.kind not in "biufc":
        assert not isinstance(got.data, torch.Tensor)
    else:
        assert isinstance(got.data, torch.Tensor) and got.data.device.type == "cpu"
    got_values = values_of(got.data)
    assert got_values.dtype == want_values.dtype, (got_values.dtype, want_values.dtype)
    assert got_values.shape == want_values.shape
    if rtol == 0.0 or want_values.dtype.kind not in "fc":
        np.testing.assert_array_equal(got_values, want_values)
    else:
        scale = np.nanmax(np.abs(want_values)) if np.isfinite(want_values).any() else 1.0
        np.testing.assert_allclose(got_values, want_values, rtol=rtol, atol=rtol * scale)


# (name, function of (package, DataArray, payload) giving the result).
METHODS = {
    # groupby over a coordinate, every reduction, and over a DataArray key.
    **{f"groupby.{r}": (lambda r: lambda pkg, da, p: getattr(da.groupby("hour"), r)())(r)
       for r in ("mean", "sum", "min", "max", "std", "var", "median", "prod", "count", "first", "last")},
    "groupby.mean(dim=x)": lambda pkg, da, p: da.groupby("hour").mean(dim="x"),
    "groupby.sum([time, y])": lambda pkg, da, p: da.groupby("hour").sum(["time", "y"]),
    "groupby.max(...)": lambda pkg, da, p: da.groupby("hour").max(...),
    "groupby.std(ddof=1)": lambda pkg, da, p: da.groupby("hour").std(ddof=1),
    "groupby(label).mean": lambda pkg, da, p: da.groupby("label").mean(),
    "groupby(DataArray).median": lambda pkg, da, p: da.groupby(da["hour"] % 2).median(),
    "groupby.map(x-mean)": lambda pkg, da, p: da.groupby("hour").map(lambda g: g - g.mean("time")),
    "groupby.map(scalar)": lambda pkg, da, p: da.isel(x=1, y=2).groupby("hour").map(lambda g: g.sum()),
    "groupby.iter": lambda pkg, da, p: pkg.xdata.concat([sub for _, sub in da.groupby("hour")], dim="time"),
    # resample by pandas' bins, gaps included.
    **{f"resample.{r}": (lambda r: lambda pkg, da, p: getattr(da.resample(time="6h"), r)())(r)
       for r in ("mean", "sum", "max", "median", "count", "first", "last")},
    "resample(1D).mean": lambda pkg, da, p: da.resample(time="1D").mean(),
    "resample(4h) with a gap": lambda pkg, da, p: da.isel(time=list(range(0, 8)) + list(range(16, 24))).resample(time="4h").mean(),
    "resample.map": lambda pkg, da, p: da.resample(time="12h").map(lambda g: g.max("time")),
    # rolling windows.
    **{f"rolling.{r}": (lambda r: lambda pkg, da, p: getattr(da.rolling(time=3), r)())(r)
       for r in ("mean", "sum", "min", "max", "std", "median", "count")},
    "rolling(center, min_periods=1).mean": lambda pkg, da, p: da.rolling(time=4, center=True, min_periods=1).mean(),
    "rolling(time, x).mean": lambda pkg, da, p: da.rolling({"time": 3, "x": 2}, min_periods=2).mean(),
    "rolling.construct": lambda pkg, da, p: da.rolling(time=3).construct("window"),
    # coarsen, every boundary.
    # (The JAX package's coarsen pools every coordinate over a coarsened
    # dim as numbers: the string coordinate over x goes first.)
    **{f"coarsen.{r}": (lambda r: lambda pkg, da, p: getattr(da.drop_vars("label").coarsen(time=4, x=2), r)())(r)
       for r in ("mean", "sum", "min", "max", "std", "median")},
    "coarsen(trim).mean": lambda pkg, da, p: da.coarsen(y=2, boundary="trim").mean(),
    "coarsen(pad).sum": lambda pkg, da, p: da.coarsen(time=5, y=2, boundary="pad").sum(),
    # weighted.
    **{f"weighted.{r}": (lambda r: lambda pkg, da, p: getattr(da.weighted(weights_of(pkg, p)), r)(("x", "y")))(r)
       for r in ("mean", "sum", "var", "std", "sum_of_weights")},
    "weighted.mean(None)": lambda pkg, da, p: da.weighted(weights_of(pkg, p)).mean(),
    "weighted.var(x)": lambda pkg, da, p: da.weighted(weights_of(pkg, p)).var("x"),
    # interp and interp_like.
    "interp(x, linear)": lambda pkg, da, p: da.interp(x=np.linspace(0.0, 8.0, 13)),
    "interp(x, nearest)": lambda pkg, da, p: da.interp(x=np.linspace(0.0, 8.0, 13), method="nearest"),
    "interp(x, cubic)": lambda pkg, da, p: da.interp(x=np.linspace(1.0, 5.0, 9), method="cubic"),
    "interp(x, y scalar)": lambda pkg, da, p: da.interp(x=np.array([2.5, 3.0]), y=3.3),
    "interp(x at samples)": lambda pkg, da, p: da.interp(x=coords()["x"][::-1]),
    "interp_like": lambda pkg, da, p: da.interp_like(
        pkg.xdata.DataArray(np.zeros(3), dims=("y",), coords={"y": np.array([0.5, 4.0, 7.0])})),
    # calculus.
    "differentiate(x)": lambda pkg, da, p: da.differentiate("x"),
    "differentiate(y)": lambda pkg, da, p: da.differentiate("y"),
    "differentiate(time)": lambda pkg, da, p: da.differentiate("time"),
    "differentiate(t)": lambda pkg, da, p: da.differentiate("t"),
    "integrate(x)": lambda pkg, da, p: da.integrate("x"),
    "integrate(t)": lambda pkg, da, p: da.integrate("t"),
    # polyfit.
    "polyfit(x, 2)": lambda pkg, da, p: da.polyfit("x", 2),
    "polyfit(t, 1)": lambda pkg, da, p: da.assign_coords(time=coords()["t"][1]).polyfit("time", 1),
    "polyfit(y, 1, skipna=False)": lambda pkg, da, p: da.polyfit("y", 1, skipna=False),
    "polyfit(x, 1) without NaN": lambda pkg, da, p: da.fillna(0.5).polyfit("x", 1),
    # stack, unstack and the index methods.
    "stack": lambda pkg, da, p: da.stack(z=("x", "y")),
    "stack.unstack": lambda pkg, da, p: da.stack(z=("x", "y")).unstack("z"),
    "stack.isel.unstack": lambda pkg, da, p: da.stack(z=("x", "y")).isel(z=[0, 3, 7, 29]).unstack(),
    "stack.permuted.unstack": lambda pkg, da, p: da.stack(z=("x", "y")).isel(z=np.roll(np.arange(NX * NY), 3)).unstack("z"),
    "stack.sel(tuple)": lambda pkg, da, p: da.stack(z=("x", "y")).sel(z=(coords()["x"][2], 4.0)),
    "stack.sel(level)": lambda pkg, da, p: da.stack(z=("x", "y")).sel(y=4.0),
    "stack.reorder_levels.unstack": lambda pkg, da, p: da.stack(z=("x", "y")).reorder_levels(z=["y", "x"]).unstack("z"),
    "stack.reset_index": lambda pkg, da, p: da.stack(z=("x", "y")).reset_index("z"),
    "stack.reset_index(drop)": lambda pkg, da, p: da.stack(z=("x", "y")).reset_index("z", drop=True),
    "reset_index(x)": lambda pkg, da, p: da.reset_index("x"),
    "set_index(x=label)": lambda pkg, da, p: da.set_index(x="label"),
    "set_index.unstack": lambda pkg, da, p: da.isel(time=0).assign_coords(
        a=("x", np.array([0, 0, 0, 1, 1, 1])), b=("x", np.array([0, 1, 2, 0, 1, 2]))).set_index(x=["a", "b"]).unstack("x"),
    "map_blocks": lambda pkg, da, p: da.map_blocks(lambda d, k: d * k, args=(2.0,)),
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("payload", ["numpy", "tensor"])
@pytest.mark.parametrize("name", sorted(METHODS))
def test_dataarray_method(name, payload, dtype):
    func = METHODS[name]
    want = func(xu, make(xu, payload, dtype), payload)
    got = func(xt, make(xt, payload, dtype), payload)
    if name.startswith("polyfit"):
        rtol = 1e-9
    else:
        rtol = 1e-6 if dtype == "float32" else 1e-12
    assert_same(got, want, payload, rtol)


def test_stacked_indexes():
    """The stacked dim's MultiIndex, through indexes and get_index, and its
    to_pandas; a reset index drops it."""
    for payload in ("numpy", "tensor"):
        got = make(xt, payload, np.float64).stack(z=("x", "y"))
        want = make(xu, payload, np.float64).stack(z=("x", "y"))
        assert sorted(got.indexes) == sorted(want.indexes)
        for dim in want.indexes:
            assert got.indexes[dim].equals(want.indexes[dim])
        assert got.get_index("z").equals(want.get_index("z"))
        assert got.get_index("z").names == ["x", "y"]
        assert "z" not in got.reset_index("z").indexes
        sub = got.isel(time=0, z=slice(2, 9))
        assert sub.get_index("z").equals(want.isel(time=0, z=slice(2, 9)).get_index("z"))
        np.testing.assert_array_equal(sub.to_pandas().to_numpy(), want.isel(time=0, z=slice(2, 9)).to_pandas().to_numpy())


@pytest.mark.parametrize("payload", ["numpy", "tensor"])
def test_integer_payload_keeps_its_dtype(payload):
    """Integer data: groupby, coarsen and resample reduce in their own dtype
    (sum and max stay int64 or the input's), as in the JAX package."""
    ints = np.random.default_rng(4).integers(-5, 9, size=(N_TIME, NX, NY)).astype(np.int32)
    cases = {
        "groupby.sum": lambda da: da.groupby("hour").sum(),
        "groupby.max": lambda da: da.groupby("hour").max(),
        "groupby.mean": lambda da: da.groupby("hour").mean(),
        "coarsen.sum": lambda da: da.coarsen(time=4).sum(),
        "coarsen.max": lambda da: da.drop_vars("label").coarsen(x=3).max(),
        "resample.count": lambda da: da.resample(time="5h").count(),
        "stack.isel.unstack": lambda da: da.stack(z=("x", "y")).isel(z=[0, 4, 11]).unstack(),
    }
    for name, func in cases.items():
        results = {}
        for pkg_name, pkg in PACKAGES.items():
            data = torch.from_numpy(ints) if pkg is xt and payload == "tensor" else ints
            da = pkg.xdata.DataArray(data, dims=("time", "x", "y"), coords={k: v for k, v in coords().items()}, name="n")
            results[pkg_name] = func(da)
        assert_same(results["torch"], results["jax"], payload, 0.0)


def test_integrate_over_datetime_tensor_refuses():
    """numpy integrates over a datetime coordinate into timedelta64 values,
    which a tensor cannot hold: the tensor payload raises; the numpy payload
    gives the JAX package's timedelta64."""
    with pytest.raises(TypeError, match="timedelta64"):
        make(xt, "tensor", np.float64).integrate("time")
    got = make(xt, "numpy", np.float64).integrate("time")
    want = make(xu, "numpy", np.float64).integrate("time")
    np.testing.assert_array_equal(got.values, np.asarray(want.values))


def make_dataset(pkg, payload, dtype):
    da = make(pkg, payload, dtype)
    other = da.isel(x=0) * 2.0
    ds = da.to_dataset()
    ds["g"] = other.rename("g")
    static = np.arange(NX * NY, dtype=np.float64).reshape(NX, NY)
    if pkg is xt and payload == "tensor":
        static = torch.from_numpy(static)
    ds["static"] = pkg.xdata.DataArray(static, dims=("x", "y"))
    return ds


DATASET_METHODS = {
    "groupby.mean": lambda ds: ds.groupby("hour").mean(),
    "groupby.count": lambda ds: ds.groupby("hour").count(),
    "groupby.first": lambda ds: ds.groupby("hour").first(),
    "groupby.iter": lambda ds: [sub for _, sub in ds.groupby("hour")][1],
    "rolling.mean": lambda ds: ds.rolling(time=3).mean(),
    "rolling(center).max": lambda ds: ds.rolling(time=3, center=True, min_periods=1).max(),
    "coarsen.mean": lambda ds: ds.coarsen(time=4).mean(),
    "coarsen(trim).sum": lambda ds: ds.coarsen(y=2, boundary="trim").sum(),
    "resample.mean": lambda ds: ds.resample(time="6h").mean(),
    "resample.count": lambda ds: ds.resample(time="5h").count(),
    "interp": lambda ds: ds.interp(x=np.linspace(1.0, 6.0, 7)),
    "polyfit": lambda ds: ds.polyfit("x", 1),
    "stack": lambda ds: ds.stack(z=("x", "y")),
    "stack.unstack": lambda ds: ds.stack(z=("x", "y")).unstack(),
    "stack.sel(level)": lambda ds: ds.stack(z=("x", "y")).sel(y=2.0),
    "stack.reset_index": lambda ds: ds.stack(z=("x", "y")).reset_index("z"),
    "stack.reset_index(drop)": lambda ds: ds.stack(z=("x", "y")).reset_index("z", drop=True),
    "stack.reorder_levels": lambda ds: ds.stack(z=("x", "y")).reorder_levels(z=["y", "x"]),
    "reset_index(x)": lambda ds: ds.reset_index("x"),
}


@pytest.mark.parametrize("payload", ["numpy", "tensor"])
@pytest.mark.parametrize("name", sorted(DATASET_METHODS))
def test_dataset_method(name, payload):
    func = DATASET_METHODS[name]
    want = func(make_dataset(xu, payload, np.float64))
    got = func(make_dataset(xt, payload, np.float64))
    assert_same(got, want, payload, 1e-9 if name == "polyfit" else 1e-12)


def test_dataset_indexes_and_chunks():
    got = make_dataset(xt, "tensor", np.float64).stack(z=("x", "y"))
    want = make_dataset(xu, "numpy", np.float64).stack(z=("x", "y"))
    assert sorted(got.indexes) == sorted(want.indexes)
    for dim, index in want.indexes.items():
        assert got.indexes[dim].equals(index)
    assert got.chunk() is got and got.unify_chunks() is got


def ugrid_pair(pkg, payload):
    """A (time, face) UgridDataArray over a 4 x 3 quad mesh, with the
    grouping coordinates of ``coords``."""
    nx, ny = 4, 3
    xs, ys = np.meshgrid(np.arange(nx + 1.0), np.arange(ny + 1.0))
    nid = lambda i, j: j * (nx + 1) + i  # noqa: E731
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    faces = np.stack([nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)], -1).reshape(-1, 4)
    grid = pkg.Ugrid2d(xs.ravel(), ys.ravel(), -1, faces)
    data, _ = source_arrays(np.float64)
    values = data.reshape(N_TIME, -1)[:, : grid.n_face].copy()
    if pkg is xt and payload == "tensor":
        values = torch.from_numpy(values)
    c = coords()
    da = pkg.xdata.DataArray(
        values, dims=("time", grid.face_dimension), name="h",
        coords={"time": c["time"], "hour": c["hour"], "t": c["t"]},
    )
    return pkg.UgridDataArray(da, grid)


UGRID_METHODS = {
    "groupby.mean": lambda u: u.groupby("hour").mean(),
    "resample.mean": lambda u: u.resample(time="6h").mean(),
    "rolling.mean": lambda u: u.rolling(time=6).mean(),
    "coarsen.mean": lambda u: u.coarsen(time=4).mean(),
    "weighted.mean": lambda u: u.weighted(u.obj.isel(time=0).notnull().astype(np.float64)).mean("time"),
    "interp": lambda u: u.assign_coords(time=coords()["t"][1]).interp(time=[2.0, 3.5]),
    "differentiate": lambda u: u.differentiate("t"),
    "integrate": lambda u: u.integrate("t"),
    "polyfit": lambda u: u.assign_coords(time=coords()["t"][1]).polyfit("time", 1),
    "stack": lambda u: u.stack(z=("time",)),
    "map_blocks": lambda u: u.map_blocks(lambda d: d + 1.0),
    "isel(time)": lambda u: u.isel(time=slice(2, 9)),
}


TYPES = {
    xu.UgridDataArray: xt.UgridDataArray, xu.UgridDataset: xt.UgridDataset,
    xu.xdata.DataArray: xt.xdata.DataArray, xu.xdata.Dataset: xt.xdata.Dataset,
}


@pytest.mark.parametrize("payload", ["numpy", "tensor"])
@pytest.mark.parametrize("name", sorted(UGRID_METHODS))
def test_ugrid_forwarding(name, payload):
    """A UgridDataArray forwards each method: the result is wrapped (with
    the grid) where the JAX package's is, and equal to it."""
    func = UGRID_METHODS[name]
    want = func(ugrid_pair(xu, payload))
    got = func(ugrid_pair(xt, payload))
    assert type(got) is TYPES[type(want)]
    if isinstance(want, (xu.UgridDataArray, xu.UgridDataset)):
        np.testing.assert_array_equal(
            got.grids[0].face_node_connectivity, np.asarray(want.grids[0].face_node_connectivity)
        )
        got, want = got.obj, want.obj
    assert_same(got, want, payload, 1e-9 if name == "polyfit" else 1e-12)


def test_ugrid_dataset_grouped():
    """A UgridDataset's groupby and windowed methods: per variable, as the
    JAX package's."""
    results = {}
    for pkg_name, pkg in PACKAGES.items():
        uda = ugrid_pair(pkg, "tensor")
        uds = uda.to_dataset()
        results[pkg_name] = (
            uds.groupby("hour").max(), uds.resample(time="8h").mean(), uds.rolling(time=2).sum(),
            uds.coarsen(time=3).mean(),
        )
    for got, want in zip(results["torch"], results["jax"]):
        assert type(got) is TYPES[type(want)]
        got, want = getattr(got, "obj", got), getattr(want, "obj", want)
        assert_same(got, want, "tensor", 1e-12)
