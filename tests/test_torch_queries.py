"""
The port's queries on a 2D mesh held on the CPU against the JAX
package's: ``sel_points`` (every ``out_of_bounds`` mode, ``method``,
``fill_value``, ``tolerance``), the line selections (``sel`` of a slice
and a value, ``intersect_line``, ``intersect_linestring``),
``rasterize``/``rasterize_like``, ``to_node``/``to_edge``/``to_face``,
``reindex_like``, ``interpolate_na`` and the nearest lookups, through the
UgridDataArray and UgridDataset accessors, on a jittered 10 x 10 quad
mesh and a Delaunay triangle mesh.

The same seeded inputs go through both packages, the port's payload as
numpy and as a CPU tensor (which must stay a tensor).  Results have
equal dims and coordinate names; indices and values are equal (NaN
where NaN); float64 section coordinates agree at rtol 1e-12.
"""

import warnings

import numpy as np
import pytest
import torch

import chip_smoke
import xugrid_tpu as xu
import xugrid_tpu_torch as xt
from xugrid_tpu_torch.ugrid import interpolate as torch_interpolate
from xugrid_tpu_torch.xdata.variable import is_tensor

N_SIDE = 10


def meshes():
    (verts, faces), _ = chip_smoke.bench_meshes(N_SIDE, 2, np.random.default_rng(31))
    nodes, tris = chip_smoke.delaunay_mesh(8, seed=4)
    return {"quads": (verts, faces), "delaunay": (nodes / 100.0 * N_SIDE, tris)}


MESHES = meshes()
PAYLOADS = ["numpy", "tensor"]


def pair(name):
    verts, faces = MESHES[name]
    return xu.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces), xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)


def facet_data(grid, facet, n_extra=2, seed=0, nan_fraction=0.0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(n_extra, getattr(grid, f"n_{facet}")))
    if nan_fraction:
        values[rng.random(values.shape) < nan_fraction] = np.nan
    if np.issubdtype(dtype, np.integer):
        values = np.round(values * 10)
    return values.astype(dtype)


def as_payload(values, payload):
    return torch.from_numpy(values) if payload == "tensor" else values


def udas(jgrid, tgrid, facet, payload, **kwargs):
    values = facet_data(jgrid, facet, **kwargs)
    dims = ("time", getattr(jgrid, f"{facet}_dimension"))
    juda = xu.UgridDataArray(xu.xdata.DataArray(values, dims=dims, name="v"), jgrid)
    tuda = xt.UgridDataArray(xt.xdata.DataArray(as_payload(values, payload), dims=dims, name="v"), tgrid)
    return juda, tuda


def udss(jgrid, tgrid, payload):
    """UgridDatasets with a (time, face), a (node,) and an (edge,) variable."""
    specs = {"fz": "face", "nz": "node", "ez": "edge"}
    made = []
    for pkg, grid in ((xu, jgrid), (xt, tgrid)):
        ds = pkg.xdata.Dataset()
        for k, (name, facet) in enumerate(specs.items()):
            values = facet_data(jgrid, facet, seed=k)
            dims = ("time", getattr(grid, f"{facet}_dimension"))
            if facet != "face":
                values, dims = values[0], dims[1:]
            ds[name] = pkg.xdata.DataArray(values if pkg is xu else as_payload(values, payload), dims=dims)
        made.append(pkg.UgridDataset(ds, [grid]))
    return made


def values_of(obj):
    return np.asarray(obj.values)


def assert_same(want, got, payload="numpy"):
    """Equal dims, coordinates (float at rtol 1e-12) and values; a tensor
    payload stays a tensor."""
    if isinstance(want, xu.xdata.Dataset):
        assert sorted(want.data_vars) == sorted(got.data_vars)
        for name in want.data_vars:
            assert_same(want[name], got[name], payload)
        return
    assert tuple(want.dims) == tuple(got.dims)
    assert sorted(want.coords) == sorted(got.coords)
    for name in want.coords:
        a, b = np.asarray(want[name].values), np.asarray(got[name].values)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-12, atol=0.0)
        else:
            np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(values_of(got), values_of(want))
    assert values_of(got).dtype == values_of(want).dtype
    if payload == "tensor":
        assert is_tensor(got.data)


def station_points(seed=2):
    """Points over and beyond the mesh (about a sixth of them outside)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, N_SIDE + 1.0, 40), rng.uniform(-1.0, N_SIDE + 1.0, 40)


# -- nearest lookups --------------------------------------------------------------
@pytest.mark.parametrize("max_distance", [np.inf, 0.4])
@pytest.mark.parametrize("facet", ["node", "edge", "face"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_locate_nearest_matches_jax(name, facet, max_distance):
    jgrid, tgrid = pair(name)
    pts = np.column_stack(station_points(5))
    want = getattr(jgrid, f"locate_nearest_{facet}")(pts, max_distance)
    got = getattr(tgrid, f"locate_nearest_{facet}")(pts, max_distance)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64
    assert (got >= 0).any()


def test_kdtrees_start_empty_and_are_not_carried_into_subsets():
    _, tgrid = pair("quads")
    for facet in ("node", "edge", "face"):
        assert getattr(tgrid, f"_{facet}_kdtree") is None
        getattr(tgrid, f"locate_nearest_{facet}")([[1.0, 1.0]])
        assert getattr(tgrid, f"_{facet}_kdtree") is not None
    subset = tgrid.topology_subset(np.arange(10))
    assert all(getattr(subset, f"_{facet}_kdtree") is None for facet in ("node", "edge", "face"))


# -- sel_points ---------------------------------------------------------------------
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("method", [None, "nearest"])
@pytest.mark.parametrize("out_of_bounds", ["warn", "ignore", "drop"])
@pytest.mark.parametrize("facet", ["face", "node", "edge"])
def test_sel_points_matches_jax(facet, out_of_bounds, method, payload):
    jgrid, tgrid = pair("quads")
    juda, tuda = udas(jgrid, tgrid, facet, payload)
    x, y = station_points()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = juda.ugrid.sel_points(x, y, method=method, out_of_bounds=out_of_bounds)
        got = tuda.ugrid.sel_points(x, y, method=method, out_of_bounds=out_of_bounds)
    assert_same(want, got, payload)
    inside = int((tgrid.locate_points(np.column_stack([x, y])) >= 0).sum())
    assert 0 < inside < len(x)
    assert values_of(got).shape == (2, inside if out_of_bounds == "drop" else len(x))


@pytest.mark.parametrize("payload", PAYLOADS)
def test_sel_points_warns_raises_and_fills(payload):
    jgrid, tgrid = pair("delaunay")
    juda, tuda = udas(jgrid, tgrid, "face", payload)
    x, y = station_points(3)
    with pytest.warns(UserWarning, match="Not all points"):
        got = tuda.ugrid.sel_points(x, y, fill_value=-99.0)
    with pytest.warns(UserWarning):
        want = juda.ugrid.sel_points(x, y, fill_value=-99.0)
    assert_same(want, got, payload)
    assert (values_of(got) == -99.0).any()
    with pytest.raises(ValueError, match="Not all points"):
        tuda.ugrid.sel_points(x, y, out_of_bounds="raise")
    with pytest.raises(ValueError, match="method"):
        tuda.ugrid.sel_points(x, y, method="linear")
    with pytest.raises(ValueError, match="out_of_bounds"):
        tuda.ugrid.sel_points(x, y, out_of_bounds="bogus")


@pytest.mark.parametrize("tolerance", [None, 1e-3])
def test_sel_points_on_nodes_with_tolerance(tolerance):
    """Points exactly on the mesh's nodes and just off its boundary: the
    lowest face holding each, within the tolerance."""
    jgrid, tgrid = pair("quads")
    juda, tuda = udas(jgrid, tgrid, "face", "numpy")
    x = np.concatenate([jgrid.node_x[::7], [-5e-4, N_SIDE + 5e-4]])
    y = np.concatenate([jgrid.node_y[::7], [3.3, 4.4]])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = juda.ugrid.sel_points(x, y, tolerance=tolerance, out_of_bounds="ignore")
        got = tuda.ugrid.sel_points(x, y, tolerance=tolerance, out_of_bounds="ignore")
    assert_same(want, got)


@pytest.mark.parametrize("payload", PAYLOADS)
def test_sel_of_value_arrays_selects_points(payload):
    jgrid, tgrid = pair("quads")
    juda, tuda = udas(jgrid, tgrid, "face", payload)
    kwargs = {"x": [0.5, 3.3, 7.7], "y": np.array([1.5, 8.2])}
    assert_same(juda.ugrid.sel(**kwargs), tuda.ugrid.sel(**kwargs), payload)


# -- pointwise isel -------------------------------------------------------------------
@pytest.mark.parametrize("payload", PAYLOADS)
def test_pointwise_isel_matches_jax(payload):
    rng = np.random.default_rng(4)
    values = rng.normal(size=(3, 5, 6))
    coords = {"a": ("x", np.arange(5.0)), "b": (("x", "y"), rng.normal(size=(5, 6)))}
    want_da = xu.xdata.DataArray(values, dims=("t", "x", "y"), coords=coords, name="v")
    got_da = xt.xdata.DataArray(as_payload(values, payload), dims=("t", "x", "y"), coords=coords, name="v")
    idx = {"x": [4, 0, 2, 2], "y": [5, 1, 0, 3]}
    want = want_da.isel({k: xu.xdata.DataArray(np.array(v), dims=("p",)) for k, v in idx.items()})
    got = got_da.isel({k: xt.xdata.DataArray(np.array(v), dims=("p",)) for k, v in idx.items()})
    assert_same(want, got, payload)
    np.testing.assert_array_equal(values_of(got), values[:, idx["x"], idx["y"]].T)


# -- line selections -------------------------------------------------------------------
LINES = {
    "diagonal": ((0.1, 0.2), (9.7, 9.9)),
    "beyond": ((-2.0, 4.4), (12.0, 5.1)),
    "reversed": ((8.8, 1.1), (0.3, 7.6)),
}


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("line", sorted(LINES))
@pytest.mark.parametrize("name", sorted(MESHES))
def test_intersect_line_matches_jax(name, line, payload):
    jgrid, tgrid = pair(name)
    juda, tuda = udas(jgrid, tgrid, "face", payload)
    start, end = LINES[line]
    want = juda.ugrid.intersect_line(start, end)
    got = tuda.ugrid.intersect_line(start, end)
    assert_same(want, got, payload)
    assert len(values_of(got)[0]) > 5
    assert (np.diff(got[f"{tgrid.name}_s"].values) >= 0).all()


@pytest.mark.parametrize(
    "kwargs",
    [
        {"x": 3.3, "y": slice(None)},
        {"x": slice(None), "y": 6.1},
        {"x": slice(1.2, 7.0), "y": 2.2},
        {"x": 4.4, "y": slice(2.0, None)},
    ],
)
@pytest.mark.parametrize("name", sorted(MESHES))
def test_sel_line_matches_jax(name, kwargs):
    jgrid, tgrid = pair(name)
    juda, tuda = udas(jgrid, tgrid, "face", "tensor")
    assert_same(juda.ugrid.sel(**kwargs), tuda.ugrid.sel(**kwargs), "tensor")


@pytest.mark.parametrize("name", sorted(MESHES))
def test_intersect_linestring_matches_jax(name):
    jgrid, tgrid = pair(name)
    juda, tuda = udas(jgrid, tgrid, "face", "tensor")
    rng = np.random.default_rng(8)
    xy = np.cumsum(rng.normal(scale=1.5, size=(12, 2)), axis=0) + N_SIDE / 2
    want = juda.ugrid.intersect_linestring(xy)
    got = tuda.ugrid.intersect_linestring(xy)
    assert_same(want, got, "tensor")
    assert_same(juda.ugrid.intersect_linestring(xy.tolist()), tuda.ugrid.intersect_linestring(xy.tolist()), "tensor")


def test_line_selection_errors():
    _, tgrid = pair("quads")
    _, tuda = udas(tgrid, tgrid, "face", "numpy")
    with pytest.raises(ValueError, match="length two"):
        tuda.ugrid.intersect_line(start=(0.0,), end=(1.0, 1.0, 2.0))
    with pytest.raises(ValueError, match="single value"):
        tuda.ugrid.sel(x=slice(None), y=[1.0, 2.0])
    with pytest.raises(ValueError, match="n_vertex, 2"):
        tuda.ugrid.intersect_linestring(np.zeros((4, 3)))


# -- rasterization -----------------------------------------------------------------------
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("resolution", [0.37, 1.0, -0.5])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_rasterize_matches_jax(name, resolution, payload):
    jgrid, tgrid = pair(name)
    juda, tuda = udas(jgrid, tgrid, "face", payload)
    want_index = jgrid.rasterize(resolution)
    got_index = tgrid.rasterize(resolution)
    for a, b in zip(want_index, got_index):
        np.testing.assert_array_equal(b, a)
    assert_same(juda.ugrid.rasterize(resolution), tuda.ugrid.rasterize(resolution), payload)


@pytest.mark.parametrize("resolution", [0.3, 2.5, -1.0])
@pytest.mark.parametrize("bounds", [(0.0, 0.0, 1.0, 1.0), (-3.2, 4.1, 7.7, 12.9)])
def test_raster_xy_matches_jax(bounds, resolution):
    from xugrid_tpu.core.accessorbase import AbstractUgridAccessor as JaxAccessor

    want = JaxAccessor._raster_xy(bounds, resolution)
    got = xt.UgridDataArrayAccessor._raster_xy(bounds, resolution)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("dtype", [np.float32, np.int64])
@pytest.mark.parametrize("payload", PAYLOADS)
def test_rasterize_like_matches_jax(payload, dtype):
    jgrid, tgrid = pair("delaunay")
    juda, tuda = udas(jgrid, tgrid, "face", payload, dtype=dtype)
    x = np.linspace(-0.5, N_SIDE + 0.5, 13)
    y = np.linspace(N_SIDE, 0.0, 9)
    jother = xu.xdata.DataArray(np.zeros((9, 13)), coords={"y": y, "x": x}, dims=("y", "x"))
    tother = xt.xdata.DataArray(np.zeros((9, 13)), coords={"y": y, "x": x}, dims=("y", "x"))
    want = juda.ugrid.rasterize_like(jother)
    got = tuda.ugrid.rasterize_like(tother)
    assert_same(want, got, payload)
    assert np.isnan(values_of(got)).any()


# -- facet remaps ------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64])
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize(
    "source, target", [("face", "node"), ("face", "edge"), ("node", "face"), ("node", "edge"), ("edge", "node"),
                       ("edge", "face")]
)
def test_to_facet_matches_jax(source, target, payload, dtype):
    jgrid, tgrid = pair("quads")
    juda, tuda = udas(jgrid, tgrid, source, payload, dtype=dtype)
    want = getattr(juda.ugrid, f"to_{target}")()
    got = getattr(tuda.ugrid, f"to_{target}")()
    assert isinstance(got, xt.UgridDataArray)
    assert_same(want.obj, got.obj, payload)


def test_to_facet_errors():
    _, tgrid = pair("quads")
    _, tuda = udas(tgrid, tgrid, "face", "numpy")
    with pytest.raises(ValueError, match="already face"):
        tuda.ugrid.to_face()
    with pytest.raises(ValueError, match="already exists"):
        tuda.ugrid.to_node(dim="time")


# -- reindex_like --------------------------------------------------------------------------
def shuffled_pair(jgrid, seed=6):
    """The mesh with its faces and nodes permuted, in both packages."""
    rng = np.random.default_rng(seed)
    face_perm = rng.permutation(jgrid.n_face)
    node_perm = rng.permutation(jgrid.n_node)
    inverse = np.empty_like(node_perm)
    inverse[node_perm] = np.arange(len(node_perm))
    faces = jgrid.face_node_connectivity[face_perm]
    faces = np.where(faces >= 0, inverse[np.maximum(faces, 0)], -1)
    x, y = jgrid.node_x[node_perm], jgrid.node_y[node_perm]
    return xu.Ugrid2d(x, y, -1, faces), xt.Ugrid2d(x, y, -1, faces)


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("facet", ["face", "node"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_reindex_like_matches_jax(name, facet, payload):
    jgrid, tgrid = pair(name)
    jshuffled, tshuffled = shuffled_pair(jgrid)
    juda, tuda = udas(jgrid, tgrid, facet, payload)
    want = juda.ugrid.reindex_like(jshuffled)
    got = tuda.ugrid.reindex_like(tshuffled)
    assert got.grid is tshuffled
    assert_same(want.obj, got.obj, payload)
    # And back onto the original order.
    back = got.ugrid.reindex_like(tuda)
    np.testing.assert_array_equal(values_of(back), values_of(tuda))


def test_reindex_like_rejects_other_types():
    _, tgrid = pair("quads")
    _, tuda = udas(tgrid, tgrid, "face", "numpy")
    with pytest.raises(TypeError):
        tuda.ugrid.reindex_like(np.zeros(3))
    network = xt.Ugrid1d([0.0, 1.0], [0.0, 1.0], -1, np.array([[0, 1]]))
    with pytest.raises(TypeError):
        tgrid.reindex_like(network, tuda.obj)


# -- the nearest fill ------------------------------------------------------------------------
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("max_distance", [None, 0.9])
@pytest.mark.parametrize("facet", ["face", "node", "edge"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_interpolate_na_matches_jax(name, facet, max_distance, payload):
    jgrid, tgrid = pair(name)
    juda, tuda = udas(jgrid, tgrid, facet, payload, n_extra=3, nan_fraction=0.3)
    want = juda.ugrid.interpolate_na(max_distance=max_distance)
    got = tuda.ugrid.interpolate_na(max_distance=max_distance)
    assert_same(want.obj, got.obj, payload)
    if max_distance is None:
        assert not np.isnan(values_of(got)).any()


def test_interpolate_na_errors():
    _, tgrid = pair("quads")
    _, tuda = udas(tgrid, tgrid, "face", "numpy")
    with pytest.raises(ValueError, match="not a valid interpolator"):
        tuda.ugrid.interpolate_na(method="linear")
    empty = xt.UgridDataArray(xt.xdata.DataArray(np.full(tgrid.n_face, np.nan), dims=(tgrid.face_dimension,)), tgrid)
    with pytest.raises(ValueError, match="All values are NA"):
        empty.ugrid.interpolate_na()


@pytest.mark.parametrize("max_distance", [np.inf, 0.7])
def test_nearest_interpolate_function_matches_jax(max_distance):
    from xugrid_tpu.ugrid import interpolate as jax_interpolate

    rng = np.random.default_rng(12)
    coordinates = rng.uniform(0.0, 10.0, (300, 2))
    data = rng.normal(size=300)
    data[rng.random(300) < 0.4] = np.nan
    want = jax_interpolate.nearest_interpolate(coordinates, data, max_distance)
    got = torch_interpolate.nearest_interpolate(coordinates, data, max_distance)
    np.testing.assert_array_equal(got, want)
    full = rng.normal(size=300)
    np.testing.assert_array_equal(torch_interpolate.nearest_interpolate(coordinates, full, np.inf), full)


# -- the UgridDataset accessor ---------------------------------------------------------------
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize(
    "call",
    [
        ("sel_points", (np.array([0.5, 3.3, 7.9]), np.array([0.5, 6.1, 2.2])), {"out_of_bounds": "raise"}),
        ("sel_points", station_points(), {"out_of_bounds": "ignore", "method": "nearest"}),
        ("sel_points", station_points(), {"out_of_bounds": "drop"}),
        ("intersect_line", ((0.1, 0.2), (9.7, 9.9)), {}),
        ("intersect_linestring", (np.array([[0.5, 0.5], [5.0, 8.0], [9.0, 2.0]]),), {}),
        ("sel", (), {"x": slice(None), "y": 6.1}),
        ("rasterize", (0.6,), {}),
    ],
    ids=["sel_points", "sel_points_nearest", "sel_points_drop", "intersect_line", "intersect_linestring",
         "sel_line", "rasterize"],
)
def test_dataset_accessor_matches_jax(call, payload):
    name, args, kwargs = call
    jgrid, tgrid = pair("quads")
    juds, tuds = udss(jgrid, tgrid, payload)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = getattr(juds.ugrid, name)(*args, **kwargs)
        got = getattr(tuds.ugrid, name)(*args, **kwargs)
    assert isinstance(got, xt.xdata.Dataset)
    assert sorted(want.data_vars) == sorted(got.data_vars)
    for var in want.data_vars:
        # Variables off the selected dimension pass through as they were.
        assert_same(want[var], got[var], payload if var == "fz" or name.startswith("sel_points") else "numpy")


@pytest.mark.parametrize("payload", PAYLOADS)
def test_dataset_rasterize_like_and_reindex_like_match_jax(payload):
    jgrid, tgrid = pair("quads")
    juds, tuds = udss(jgrid, tgrid, payload)
    x = np.linspace(0.25, N_SIDE - 0.25, 11)
    y = np.linspace(N_SIDE - 0.25, 0.25, 7)
    jother = xu.xdata.DataArray(np.zeros((7, 11)), coords={"y": y, "x": x}, dims=("y", "x"))
    tother = xt.xdata.DataArray(np.zeros((7, 11)), coords={"y": y, "x": x}, dims=("y", "x"))
    want = juds.ugrid.rasterize_like(jother)
    got = tuds.ugrid.rasterize_like(tother)
    assert_same(want["fz"], got["fz"], payload)
    jshuffled, tshuffled = shuffled_pair(jgrid, seed=9)
    want = juds.ugrid.reindex_like(jshuffled)
    got = tuds.ugrid.reindex_like(tshuffled)
    assert isinstance(got, xt.UgridDataset) and got.grids[0] is tshuffled
    assert_same(want["fz"], got["fz"], payload)
    assert_same(want["nz"], got["nz"], payload)


# -- the JAX suite's cases on a 4 x 4 unit quad grid ------------------------------------------
def unit_quads():
    verts, faces = chip_smoke.quad_mesh(4, 4)
    return xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize(
    "call, want",
    [
        (lambda u: u.ugrid.sel(x=slice(None), y=2.5), [8.0, 9.0, 10.0, 11.0]),
        (lambda u: u.ugrid.sel_points(x=[0.5, 3.5], y=[0.5, 3.5], out_of_bounds="raise"), [0.0, 15.0]),
        (lambda u: u.ugrid.intersect_line(start=(0.0, 0.5), end=(4.0, 0.5)), [0.0, 1.0, 2.0, 3.0]),
        (lambda u: u.ugrid.rasterize(1.0)[-1], [0.0, 1.0, 2.0, 3.0]),
        (lambda u: u.ugrid.rasterize(0.5)[0, 0], [12.0]),
        (lambda u: u.ugrid.sel_points(x=[-10.0, 0.5], y=[0.5, 0.5], out_of_bounds="drop"), [0.0]),
        (lambda u: u.ugrid.to_node().mean("nmax")[6], [2.5]),
    ],
    ids=["sel_line", "sel_points", "intersect_line", "rasterize_bottom_row", "rasterize_top_left", "drop",
         "to_node_mean"],
)
def test_unit_quad_cases_of_the_jax_suite(call, want, payload):
    grid = unit_quads()
    values = np.arange(16.0)
    uda = xt.UgridDataArray(xt.xdata.DataArray(as_payload(values, payload), dims=(grid.face_dimension,)), grid)
    got = call(uda)
    np.testing.assert_array_equal(np.atleast_1d(got.values), want)
    if payload == "tensor":
        assert is_tensor(got.data)


def test_unit_quad_nearest_fill_of_the_jax_suite():
    grid = unit_quads()
    values = np.arange(16.0)
    values[0] = np.nan
    uda = xt.UgridDataArray(xt.xdata.DataArray(values, dims=(grid.face_dimension,)), grid)
    filled = uda.ugrid.interpolate_na().values
    assert not np.isnan(filled).any() and filled[0] in (1.0, 4.0)
    assert grid.locate_nearest_node([[0.1, 0.1]])[0] == 0 and grid.locate_nearest_face([[0.4, 0.4]])[0] == 0
