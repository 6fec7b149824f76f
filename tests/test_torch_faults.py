"""
Public names of ported classes that the JAX package has, held on the CPU
against it on the same seeded inputs:

- the Laplace fill of node data on a network (``Ugrid1d``'s
  ``get_connectivity_matrix`` and the grids' shared
  ``_connectivity_weights``): a line, a branching network, and a network
  with a component that holds no known node (which stays NaN), both
  solves run to atol 1e-11 and agreeing within 1e-8;
- every regridder's ``weights``: the getter is ``to_dataset()``, the
  setter takes only the class's matrix type and drops every cached
  layout (the device weights included), and ``from_weights(r.weights,
  target)`` regrids bit-equal to ``r``;
- ``Ugrid1d``/``Ugrid2d.coords``, the accessors' ``crs``, ``FILL_VALUE``
  and ``Network1d.length``;
- the ``DataArray.values`` setter, which replaces the payload (a tensor
  payload's replacement on its device);
- the accessors' ``set_crs`` (on a UgridDataArray, and on a UgridDataset
  for one or every topology), through a stand-in ``pyproj`` of EPSG codes,
  and the same ImportError without pyproj;
- iterating a UgridDataArray gives the wrapped DataArray's items, plain
  DataArrays, as the JAX package's ``__iter__`` does;
- ``TimingRegistry.summary()`` gives each stage's count, total and mean
  seconds rounded to microseconds, as the JAX package's does;
- ``CellTree2d`` and ``EdgeCellTree2d`` take the JAX package's
  ``leaf_size``, and ``spatial.geometry.mean_value_weights`` its single
  point and polygon under its argument names;
- every public name of every ``xugrid_tpu`` module that has a
  counterpart in the port, and every public attribute of the classes
  defined there, exists in the port, apart from the commented
  exceptions below.
"""

import inspect

import numpy as np
import pytest
import scipy.sparse
import torch

import xugrid_tpu as xu
import xugrid_tpu_torch as xt
from tests.test_torch_serialize import assert_weights_bit_equal, build, sources
from tests.test_torch_wrap import inputs, mesh_uda, values_of  # noqa: F401
from xugrid_tpu.regrid.unstructured import Network1d as JaxNetwork1d
from xugrid_tpu_torch.core.sparse import MatrixCOO, MatrixCSR
from xugrid_tpu_torch.regrid.unstructured import Network1d

PACKAGES = (xu, xt)

NETWORKS = {
    # A line of 5 nodes, the ends known: the fill is linear.
    "line": (
        np.arange(5.0), np.zeros(5), [[0, 1], [1, 2], [2, 3], [3, 4]],
        [0.0, np.nan, np.nan, np.nan, 4.0],
    ),
    # A junction at node 1 with three branches.
    "branching": (
        np.array([0.0, 1.0, 2.0, 3.0, 1.0, 1.0]), np.array([0.0, 0.0, 0.0, 0.0, 1.0, 2.5]),
        [[0, 1], [1, 2], [2, 3], [1, 4], [4, 5]],
        [0.0, np.nan, np.nan, 3.0, np.nan, 5.0],
    ),
    # Two lines; the second holds no known node and stays NaN.
    "unknown component": (
        np.array([0.0, 1.0, 2.0, 3.0, 4.0, 0.0, 1.0, 2.0]), np.array([0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0]),
        [[0, 1], [1, 2], [2, 3], [3, 4], [5, 6], [6, 7]],
        [1.0, np.nan, 3.0, np.nan, np.nan, np.nan, np.nan, np.nan],
    ),
}


def network_fill(pkg, name, xy_weights, stacked):
    x, y, edges, values = NETWORKS[name]
    grid = pkg.Ugrid1d(x, y, -1, np.array(edges))
    values = np.array(values)
    if stacked:
        da = pkg.xdata.DataArray(np.stack([values, 2.0 * values]), dims=("time", grid.node_dimension), name="h")
    else:
        da = pkg.xdata.DataArray(values, dims=(grid.node_dimension,), name="h")
    kwargs = {"xy_weights": xy_weights, "atol": 1e-11, "maxiter": 2000}
    if pkg is xt:
        kwargs["device"] = "cpu"
    return pkg.UgridDataArray(da, grid).ugrid.laplace_interpolate(**kwargs)


@pytest.mark.parametrize("stacked", [False, True], ids=["1d", "time stack"])
@pytest.mark.parametrize("xy_weights", [True, False])
@pytest.mark.parametrize("name", list(NETWORKS))
def test_network_laplace_fill_matches_jax(name, xy_weights, stacked):
    want, got = (network_fill(pkg, name, xy_weights, stacked) for pkg in PACKAGES)
    assert isinstance(got, xt.UgridDataArray) and isinstance(got.grid, xt.Ugrid1d)
    assert got.dims == want.dims and got.name == want.name
    w, g = np.asarray(want.obj.values), got.values
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-8)
    if name == "line":
        np.testing.assert_allclose(g.reshape(-1, 5)[0], [0.0, 1.0, 2.0, 3.0, 4.0], rtol=0, atol=1e-8)
    if name == "unknown component":
        assert np.isnan(g[..., 5:]).all() and np.isfinite(g[..., :5]).all()


@pytest.mark.parametrize("xy_weights", [True, False])
def test_network_connectivity_matrix_matches_jax(xy_weights):
    x, y, edges, _ = NETWORKS["branching"]
    want, got = (
        pkg.Ugrid1d(x, y, -1, np.array(edges)).get_connectivity_matrix("network1d_nNodes", xy_weights)
        for pkg in PACKAGES
    )
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)
    grid = xt.Ugrid1d(x, y, -1, np.array(edges))
    with pytest.raises(ValueError, match="Expected network1d_nNodes"):
        grid.get_connectivity_matrix(grid.edge_dimension, xy_weights)


def test_grid_connectivity_weights_are_shared():
    assert xt.Ugrid1d._connectivity_weights is xt.Ugrid2d._connectivity_weights
    assert "_connectivity_weights" not in vars(xt.Ugrid2d)


CLASSES = [
    ("OverlapRegridder", "mean", "mesh", "raster", MatrixCSR),
    ("RelativeOverlapRegridder", None, "mesh", "raster", MatrixCSR),
    ("CentroidLocatorRegridder", None, "mesh", "raster", MatrixCOO),
    ("BarycentricInterpolator", None, "fine raster", "mesh", MatrixCSR),
    ("NetworkGridder", "mean", "network", "mesh", MatrixCSR),
]
CLASS_IDS = [case[0] for case in CLASSES]


def regridders(data, cls, method, src, tgt):
    objs = {pkg: sources(pkg, data) for pkg in PACKAGES}
    return objs, {pkg: build(pkg, cls, method, objs[pkg][src], objs[pkg][tgt]) for pkg in PACKAGES}


@pytest.mark.parametrize("cls, method, src, tgt, matrix", CLASSES, ids=CLASS_IDS)
def test_weights_getter_is_the_dataset(inputs, cls, method, src, tgt, matrix):  # noqa: F811
    _, made = regridders(inputs, cls, method, src, tgt)
    got, want = made[xt].weights, made[xu].weights
    assert isinstance(got, xt.xdata.Dataset)
    assert sorted(got._variables) == sorted(made[xt].to_dataset()._variables)
    for name in want._variables:
        if name.startswith("__regrid_"):
            np.testing.assert_array_equal(got[name].values, np.asarray(want[name].values), err_msg=name)


@pytest.mark.parametrize("cls, method, src, tgt, matrix", CLASSES, ids=CLASS_IDS)
def test_weights_setter_checks_the_type_and_drops_the_cache(inputs, cls, method, src, tgt, matrix):  # noqa: F811
    objs, made = regridders(inputs, cls, method, src, tgt)
    regridder = made[xt]
    source = objs[xt][src]
    before = values_of(regridder.regrid(source, device="cpu"))
    assert regridder._device_weights
    other = MatrixCOO if matrix is MatrixCSR else MatrixCSR
    wrong = regridder._weights.to_coo() if matrix is MatrixCSR else regridder._weights.to_csr()
    assert isinstance(wrong, other)
    for bad in (wrong, regridder.to_dataset(), None):
        for pkg in PACKAGES:
            with pytest.raises(TypeError, match=f"Expected {matrix.__name__}"):
                made[pkg].weights = bad
    # Scaled weights: the regrid follows them, in both packages alike.
    w = regridder._weights
    scaled = w._replace(data=w.data * 0.5)
    regridder.weights = scaled
    assert regridder._device_weights == {}
    assert regridder._weights is scaled
    if matrix is MatrixCSR:
        np.testing.assert_array_equal(regridder._padded.weights[regridder._padded.indices >= 0], scaled.data)
    jw = made[xu]._weights
    made[xu].weights = jw._replace(data=jw.data * 0.5)
    got = values_of(regridder.regrid(source, device="cpu"))
    want = values_of(made[xu].regrid(objs[xu][src]))
    if cls == "CentroidLocatorRegridder":
        # The row gather takes no weight: the values stay.
        np.testing.assert_array_equal(got, before)
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("cls, method, src, tgt, matrix", CLASSES, ids=CLASS_IDS)
def test_from_weights_round_trip_is_bit_equal(inputs, cls, method, src, tgt, matrix):  # noqa: F811
    objs, made = regridders(inputs, cls, method, src, tgt)
    regridder = made[xt]
    klass = getattr(xt, cls)
    kwargs = {} if method is None else {"method": method}
    again = klass.from_weights(regridder.weights, objs[xt][tgt], **kwargs)
    assert_weights_bit_equal(again._weights, regridder._weights)
    source = objs[xt][src]
    np.testing.assert_array_equal(
        values_of(again.regrid(source, device="cpu")), values_of(regridder.regrid(source, device="cpu"))
    )
    jax_again = getattr(xu, cls).from_weights(made[xu].weights, objs[xu][tgt], **kwargs)
    np.testing.assert_allclose(
        values_of(again.regrid(source, device="cpu")), values_of(jax_again.regrid(objs[xu][src])),
        rtol=1e-12, atol=1e-14,
    )


def test_grid_coords_match_jax(inputs):  # noqa: F811
    verts, faces = inputs["verts"], inputs["faces"]
    nodes, edges = inputs["nodes"], inputs["edges"]
    for make in (
        lambda pkg: pkg.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces),
        lambda pkg: pkg.Ugrid1d(nodes[:, 0], nodes[:, 1], -1, edges),
    ):
        want, got = make(xu).coords, make(xt).coords
        assert list(got) == list(want)
        for dim in want:
            np.testing.assert_array_equal(got[dim], want[dim])


def test_accessor_crs_matches_jax(inputs):  # noqa: F811
    verts, faces = inputs["verts"], inputs["faces"]
    nodes, edges = inputs["nodes"], inputs["edges"]
    out = {}
    for pkg in PACKAGES:
        mesh = pkg.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
        network = pkg.Ugrid1d(nodes[:, 0], nodes[:, 1], -1, edges)
        uda = pkg.UgridDataArray(pkg.xdata.DataArray(np.zeros(mesh.n_face), dims=(mesh.face_dimension,)), mesh)
        ds = pkg.xdata.Dataset()
        ds["a"] = ((mesh.face_dimension,), np.zeros(mesh.n_face))
        ds["b"] = ((network.edge_dimension,), np.zeros(network.n_edge))
        uds = pkg.UgridDataset(ds, [mesh, network])
        out[pkg] = (uda.ugrid.crs, uds.ugrid.crs)
    assert out[xt] == out[xu] == ({"mesh2d": None}, {"mesh2d": None, "network1d": None})


def test_crs_read_from_a_file_is_reported(tmp_path, inputs):  # noqa: F811
    verts, faces = inputs["verts"], inputs["faces"]
    mesh = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    ds = mesh.to_dataset()
    ds["crs"] = ((), np.int32(0), {"epsg": 28992, "grid_mapping_name": "oblique_stereographic"})
    ds["v"] = ((mesh.face_dimension,), np.arange(mesh.n_face, dtype=np.float64), {"grid_mapping": "crs"})
    ds.to_netcdf(tmp_path / "crs.nc")
    uds = xt.UgridDataset(xt.xdata.open_dataset(tmp_path / "crs.nc"))
    crs = uds.ugrid.crs["mesh2d"]
    assert crs is uds.grid.crs and crs is not None
    assert uds["v"].ugrid.crs == {"mesh2d": crs}


def test_fill_value_and_network_length_match_jax(inputs):  # noqa: F811
    assert xt.FILL_VALUE == xu.FILL_VALUE == -1 and "FILL_VALUE" in xt.__all__
    nodes, edges = inputs["nodes"], inputs["edges"]
    want = JaxNetwork1d(xu.Ugrid1d(nodes[:, 0], nodes[:, 1], -1, edges)).length
    got = Network1d(xt.Ugrid1d(nodes[:, 0], nodes[:, 1], -1, edges)).length
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.hypot(*(nodes[edges[:, 1]] - nodes[edges[:, 0]]).T), rtol=1e-15)


@pytest.mark.parametrize("payload", ["numpy", "tensor"])
def test_dataarray_values_setter_matches_jax(payload):
    """``da.values = ...`` replaces the payload, as the JAX package's
    setter does (the port had no setter and raised AttributeError); a
    tensor payload's replacement lies on its device."""
    import torch

    values = np.arange(6.0).reshape(2, 3)
    new = -values[::-1]
    results = {}
    for pkg in PACKAGES:
        data = torch.from_numpy(values.copy()) if pkg is xt and payload == "tensor" else values.copy()
        da = pkg.xdata.DataArray(data, dims=("a", "b"), coords={"a": [10, 20]}, name="v")
        da.values = new
        results[pkg] = da
    got, want = results[xt], results[xu]
    np.testing.assert_array_equal(got.values, np.asarray(want.values))
    assert isinstance(got.data, torch.Tensor) == (payload == "tensor")
    np.testing.assert_array_equal(got["a"].values, [10, 20])


def _fake_pyproj():
    """A stand-in ``pyproj`` module: EPSG codes 4326 (geographic) and the
    rest projected, equal when their codes are."""
    import types

    class CRS:
        def __init__(self, code):
            self.code = int(code)
            self.is_geographic = self.code == 4326
            self.is_projected = not self.is_geographic

        @classmethod
        def from_epsg(cls, code):
            return cls(code)

        @classmethod
        def from_user_input(cls, value):
            return value if isinstance(value, cls) else cls(str(value).split(":")[-1])

        def __eq__(self, other):
            return isinstance(other, CRS) and other.code == self.code

        __hash__ = None

    return types.SimpleNamespace(CRS=CRS)


def _crs_objects(pkg, inputs):
    verts, faces = inputs["verts"], inputs["faces"]
    nodes, edges = inputs["nodes"], inputs["edges"]
    mesh = pkg.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    network = pkg.Ugrid1d(nodes[:, 0], nodes[:, 1], -1, edges)
    uda = pkg.UgridDataArray(pkg.xdata.DataArray(np.zeros(mesh.n_face), dims=(mesh.face_dimension,)), mesh)
    ds = pkg.xdata.Dataset()
    ds["a"] = ((mesh.face_dimension,), np.zeros(mesh.n_face))
    ds["b"] = ((network.edge_dimension,), np.zeros(network.n_edge))
    uds = pkg.UgridDataset(ds, [mesh.copy(), network])
    return uda, uds


def test_accessor_set_crs_matches_jax(monkeypatch, inputs):  # noqa: F811
    """``.ugrid.set_crs`` sets the grids' CRS without moving a node (the
    port's accessors had no ``set_crs``)."""
    import sys

    monkeypatch.setitem(sys.modules, "pyproj", _fake_pyproj())
    out = {}
    for pkg in PACKAGES:
        uda, uds = _crs_objects(pkg, inputs)
        uda.ugrid.set_crs(epsg=28992)
        uds.ugrid.set_crs(epsg=4326, topology="network1d")
        first = {name: None if crs is None else crs.code for name, crs in uds.ugrid.crs.items()}
        with pytest.raises(ValueError, match="already has a CRS"):
            uds.ugrid.set_crs(epsg=28992)
        uds.ugrid.set_crs(epsg=28992, allow_override=True)
        out[pkg] = (
            uda.ugrid.crs["mesh2d"].code, uda.grid.is_projected, first,
            {name: crs.code for name, crs in uds.ugrid.crs.items()},
            [grid.is_projected for grid in uds.grids],
            uda.grid.node_x.tolist(),
        )
    assert out[xt] == out[xu]
    assert out[xt][2] == {"mesh2d": None, "network1d": 4326}


def test_accessor_set_crs_needs_pyproj(monkeypatch, inputs):  # noqa: F811
    import sys

    monkeypatch.setitem(sys.modules, "pyproj", None)
    for pkg in PACKAGES:
        uda, uds = _crs_objects(pkg, inputs)
        for accessor in (uda.ugrid, uds.ugrid):
            with pytest.raises(ImportError):
                accessor.set_crs(epsg=28992)


@pytest.mark.parametrize("payload", ["numpy", "tensor"])
def test_iterating_a_ugrid_dataarray_matches_jax(payload, inputs):  # noqa: F811
    import torch

    verts, faces = inputs["verts"], inputs["faces"]
    values = np.arange(3.0 * len(faces)).reshape(3, len(faces))
    items = {}
    for pkg in PACKAGES:
        grid = pkg.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
        data = torch.from_numpy(values) if pkg is xt and payload == "tensor" else values
        uda = pkg.UgridDataArray(pkg.xdata.DataArray(data, dims=("time", grid.face_dimension)), grid)
        items[pkg] = list(uda)
    assert [type(i).__name__ for i in items[xt]] == [type(i).__name__ for i in items[xu]] == ["DataArray"] * 3
    for got, want in zip(items[xt], items[xu]):
        assert isinstance(got, xt.xdata.DataArray) and got.dims == want.dims
        np.testing.assert_array_equal(np.asarray(got.values), np.asarray(want.values))


def test_timing_summary_matches_jax():
    """The port's summary had no ``mean_s`` and did not round."""
    from xugrid_tpu.utils.profiling import TimingRegistry as JaxRegistry
    from xugrid_tpu_torch.utils.profiling import TimingRegistry

    summaries = []
    for cls in (JaxRegistry, TimingRegistry):
        registry = cls()
        with registry.timed("stage.a"):
            pass
        summaries.append({name: sorted(stats) for name, stats in registry.summary().items()})
    assert summaries[1] == summaries[0] == {"stage.a": ["count", "mean_s", "total_s"]}


def test_celltrees_take_leaf_size():
    verts = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0], [2.0, 0.0], [2.0, 1.0]])
    faces = np.array([[0, 1, 2, 3], [1, 4, 5, 2]])
    points = np.array([[0.5, 0.5], [1.5, 0.5], [3.0, 3.0]])
    from xugrid_tpu import spatial as jax_spatial
    from xugrid_tpu_torch import spatial

    for package in (jax_spatial, spatial):
        tree = package.CellTree2d(verts, faces, -1, leaf_size=4)
        np.testing.assert_array_equal(tree.locate_points(points), [0, 1, -1])
        edges = package.EdgeCellTree2d(verts, np.array([[0, 1], [1, 4]]), leaf_size=2)
        np.testing.assert_array_equal(edges.locate_points(np.array([[0.5, 0.0], [1.5, 0.0], [0.5, 1.0]])), [0, 1, -1])


def test_mean_value_weights_of_one_point_by_keyword():
    import jax.numpy as jnp
    import torch

    from xugrid_tpu.spatial import geometry as jax_geometry
    from xugrid_tpu_torch.spatial import geometry

    poly = np.array([[0.0, 0.0], [2.0, 0.0], [2.0, 1.0], [0.0, 1.0]])
    point = np.array([0.5, 0.25])
    want = np.asarray(jax_geometry.mean_value_weights(point=jnp.asarray(point), poly=jnp.asarray(poly), tolerance=1e-9))
    got = geometry.mean_value_weights(point=torch.from_numpy(point), poly=torch.from_numpy(poly), tolerance=1e-9)
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


# Calls in the JAX package's form
# -------------------------------
def path_graph(n):
    """The adjacency of a path of ``n`` nodes, unit weights."""
    i = np.arange(n - 1)
    rows, cols = np.concatenate([i, i + 1]), np.concatenate([i + 1, i])
    return scipy.sparse.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))


def test_laplace_fill_takes_the_jax_positional_order():
    """delta and relax sit at positions 6 and 7: rtol, atol and maxiter
    given by position bind to themselves, not to the next parameter."""
    from xugrid_tpu.ugrid import interpolate as jax_interpolate
    from xugrid_tpu_torch.ugrid import interpolate

    data = np.array([1.0, np.nan, np.nan, np.nan, 5.0])
    args = (data, path_graph(5), False, None, False, 0.0, 0.0, 0.0, 1e-8)
    want = jax_interpolate.laplace_interpolate(*args)
    got = interpolate.laplace_interpolate(*args, device="cpu")
    np.testing.assert_allclose(got, [1.0, 2.0, 3.0, 4.0, 5.0], rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_laplace_fill_takes_delta_and_relax_by_keyword():
    import chip_smoke
    from xugrid_tpu.ugrid import interpolate as jax_interpolate
    from xugrid_tpu_torch.ugrid import interpolate

    nodes, faces = chip_smoke.delaunay_mesh(17)  # 324 nodes
    grid = xt.Ugrid2d(nodes[:, 0], nodes[:, 1], -1, faces)
    W = grid.get_connectivity_matrix(grid.node_dimension, xy_weights=True)
    _, values = chip_smoke.laplace_inputs(nodes, known_fraction=0.1, seed=3)
    kwargs = {"delta": 0.25, "relax": 0.5, "atol": 1e-10}
    want = jax_interpolate.laplace_interpolate(values, W, **kwargs)
    got = interpolate.laplace_interpolate(values, W, device="cpu", **kwargs)
    assert np.isnan(got).sum() == 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, torch.float32])
def test_apply_weights_casts_to_dtype(dtype):
    """An integer source cast by ``dtype`` (the fifth argument), against
    the JAX ``apply_weights`` at that dtype's tolerance."""
    from xugrid_tpu.core.sparse import PaddedCSR as JaxPaddedCSR
    from xugrid_tpu.regrid import reduce as jax_reduce
    from xugrid_tpu.regrid.apply import apply_weights as jax_apply_weights
    from xugrid_tpu_torch.core.sparse import PaddedCSR
    from xugrid_tpu_torch.regrid import reduce
    from xugrid_tpu_torch.regrid.apply import apply_weights

    rng = np.random.default_rng(21)
    n, m, w = 300, 400, 5
    indices = rng.integers(-1, m, (n, w)).astype(np.int32)
    weights = np.where(indices >= 0, rng.uniform(0.1, 2.0, (n, w)), 0.0)
    source = rng.integers(-50, 50, (4, m)).astype(np.int32)
    np_dtype = np.float32 if dtype in (np.float32, torch.float32) else np.float64
    want = jax_apply_weights(JaxPaddedCSR(indices, weights, n, m, w), source, jax_reduce.mean, n, np_dtype)
    got = apply_weights(PaddedCSR(indices, weights, n, m, w), torch.from_numpy(source), reduce.mean, n, dtype)
    assert got.dtype == torch.from_numpy(np.empty(0, np_dtype)).dtype
    rtol, atol = (1e-5, 1e-6) if np_dtype == np.float32 else (1e-12, 1e-12)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def test_apply_weights_plan_cache_uploads_once_and_other_dtypes_raise():
    from xugrid_tpu_torch.core.sparse import PaddedCSR
    from xugrid_tpu_torch.regrid import reduce
    from xugrid_tpu_torch.regrid.apply import apply_weights

    rng = np.random.default_rng(22)
    indices = rng.integers(-1, 50, (40, 4)).astype(np.int32)
    padded = PaddedCSR(indices, np.where(indices >= 0, 1.0, 0.0), 40, 50, 4)
    source = rng.integers(0, 9, (2, 50))
    plan_cache = {}
    first = apply_weights(padded, source, reduce.mean, 40, np.float32, plan_cache)
    uploaded = dict(plan_cache)
    assert list(uploaded) == [(torch.float32, torch.device("cpu"))]
    second = apply_weights(padded, source, reduce.mean, 40, dtype=np.float32, plan_cache=plan_cache)
    assert plan_cache.keys() == uploaded.keys()
    assert all(a is b for a, b in zip(plan_cache[(torch.float32, torch.device("cpu"))], uploaded[(torch.float32, torch.device("cpu"))]))
    torch.testing.assert_close(first, second, rtol=0, atol=0)
    for dtype in (np.float16, torch.bfloat16, np.int32):
        with pytest.raises(TypeError, match="float32 or float64"):
            apply_weights(padded, source, reduce.mean, 40, dtype)


@pytest.mark.parametrize("cls", ["MatrixCOO", "MatrixCSR"])
def test_from_triplet_sizes_default_to_the_largest_index(cls):
    from xugrid_tpu.core import sparse as jax_sparse
    from xugrid_tpu_torch.core import sparse

    rng = np.random.default_rng(23)
    row, col = rng.integers(0, 30, 80), rng.integers(0, 20, 80)
    data = rng.normal(size=80)
    want = getattr(jax_sparse, cls).from_triplet(row, col, data)
    got = getattr(sparse, cls).from_triplet(row, col, data)
    assert (got.n, got.m, got.nnz) == (want.n, want.m, want.nnz) == (int(row.max()) + 1, int(col.max()) + 1, 80)
    for field in got._fields[:3]:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("relative", [False, True])
def test_intersection_length_relative_matches_jax(relative):
    import chip_smoke
    from xugrid_tpu.regrid import unstructured as jax_unstructured
    from xugrid_tpu_torch.regrid import unstructured

    rng = np.random.default_rng(24)
    (verts, faces), _ = chip_smoke.bench_meshes(10, 4, rng)
    nodes, edges = chip_smoke.random_network(4, 15, 10.0, rng)
    results = []
    for pkg, module in ((xu, jax_unstructured), (xt, unstructured)):
        mesh = module.UnstructuredGrid2d(pkg.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces))
        network = module.Network1d(pkg.Ugrid1d(nodes[:, 0], nodes[:, 1], -1, edges))
        results.append(mesh.intersection_length(network, relative))
    (want_edge, want_face, want), (edge, face, got) = results
    np.testing.assert_array_equal(edge, want_edge)
    np.testing.assert_array_equal(face, want_face)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    if relative:
        assert got.max() <= 1.0 + 1e-12


def test_xdata_where_takes_keep_attrs():
    rng = np.random.default_rng(25)
    cond, x = rng.random(6) < 0.5, rng.normal(size=6)
    results = []
    for pkg in PACKAGES:
        da = pkg.xdata.DataArray(cond, dims=("x",), coords={"x": np.arange(6.0)}, name="c")
        results.append(pkg.xdata.where(da, x, -1.0, True))
        np.testing.assert_array_equal(pkg.xdata.where(cond, x, 0.0, keep_attrs=False), np.where(cond, x, 0.0))
    want, got = results
    assert got.dims == want.dims and got.name == want.name
    np.testing.assert_array_equal(got.values, want.values)


def test_concat_and_merge_take_and_ignore_xarray_keywords(inputs):  # noqa: F811
    results = {}
    for pkg in PACKAGES:
        uda = mesh_uda(pkg, inputs)
        results[pkg] = (
            pkg.concat([uda, uda], "time", join="outer"),
            pkg.xdata.concat([uda.obj, uda.obj], "time", coords="minimal"),
            pkg.merge([uda.obj.to_dataset(), uda.obj.rename("w")], "no_conflicts", join="outer"),
            pkg.xdata.merge([uda.obj, uda.obj.rename("w")], join="outer"),
        )
    for want, got in zip(results[xu], results[xt]):
        assert sorted(got.dims.items() if hasattr(got.dims, "items") else got.sizes.items()) == sorted(
            want.dims.items() if hasattr(want.dims, "items") else want.sizes.items()
        )
    (juda, jda, jmerged, jds), (tuda, tda, tmerged, tds) = results[xu], results[xt]
    assert isinstance(tuda, xt.UgridDataArray) and isinstance(tmerged, xt.UgridDataset)
    np.testing.assert_array_equal(values_of(tuda), values_of(juda))
    np.testing.assert_array_equal(tda.values, jda.values)
    for name in ("v", "w"):
        np.testing.assert_array_equal(values_of(tmerged[name]), values_of(jmerged[name]))
        np.testing.assert_array_equal(tds[name].values, jds[name].values)


def test_setup_grid_takes_coordinate_names():
    from xugrid_tpu.regrid.regridder import setup_grid as jax_setup_grid
    from xugrid_tpu_torch.regrid.regridder import setup_grid

    coords = {"lat": np.arange(4.0) + 0.5, "lon": np.arange(6.0) * 2.0 + 1.0}
    grids = [
        f(pkg.xdata.DataArray(np.zeros((4, 6)), coords=coords, dims=("lat", "lon")), name_x="lon", name_y="lat")
        for pkg, f in ((xu, jax_setup_grid), (xt, setup_grid))
    ]
    want, got = grids
    for axis in ("xbounds", "ybounds"):
        np.testing.assert_array_equal(getattr(got, axis).bounds, getattr(want, axis).bounds)


def test_ugrid1d_without_edges_raises_as_jax():
    for pkg in PACKAGES:
        with pytest.raises(TypeError):
            pkg.Ugrid1d(np.arange(3.0), np.zeros(3), -1)


def _without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    return pytest.raises(RuntimeError, match="device='cpu'")


def test_angle_sort_rows_device_defaults_to_the_card(monkeypatch):
    """(8192, 4, 2) offsets reach ``DEVICE_MIN``: the sort resolves its
    device, the card, and raises without one unless told the CPU."""
    from xugrid_tpu.ugrid import voronoi as jax_voronoi
    from xugrid_tpu_torch.ugrid import voronoi

    rng = np.random.default_rng(26)
    coords = rng.normal(size=(500, 2))
    cand = rng.integers(-1, 500, (8192, 4))
    anchors = coords[rng.integers(0, 500, 8192)] + rng.normal(scale=0.1, size=(8192, 2))
    with _without_card(monkeypatch):
        voronoi.angle_sort_rows(cand, coords, anchors)
    got = voronoi.angle_sort_rows(cand, coords, anchors, device="cpu")
    want = jax_voronoi.angle_sort_rows(cand, coords, anchors)
    np.testing.assert_array_equal(got >= 0, want >= 0)
    from tests.test_torch_voronoi import polygons

    assert polygons(got) == polygons(want)


def test_voronoi_topology_device_defaults_to_the_card(monkeypatch):
    import chip_smoke
    from tests.test_torch_voronoi import assert_same_tessellation, topology_args
    from xugrid_tpu.ugrid import connectivity as jax_connectivity
    from xugrid_tpu.ugrid import voronoi as jax_voronoi
    from xugrid_tpu_torch.ugrid import connectivity, voronoi

    (nodes, faces), _ = chip_smoke.bench_meshes(100, 2, np.random.default_rng(27))
    centroids = connectivity.centroids(faces, nodes[:, 0], nodes[:, 1])
    mode = {"add_exterior": True, "add_vertices": True, "skip_concave": True}
    args = topology_args(connectivity, nodes, faces, centroids)
    with _without_card(monkeypatch):
        voronoi.voronoi_topology(*args, **mode)
    got = voronoi.voronoi_topology(*args, **mode, device="cpu")
    want = jax_voronoi.voronoi_topology(*topology_args(jax_connectivity, nodes, faces, centroids), **mode)
    assert_same_tessellation(got, want)


def test_barycentric_device_defaults_to_the_card(monkeypatch):
    import chip_smoke
    from xugrid_tpu.regrid import unstructured as jax_unstructured
    from xugrid_tpu_torch.regrid import unstructured

    (verts, faces), (tverts, tfaces) = chip_smoke.bench_meshes(8, 5, np.random.default_rng(28))
    adapters = [
        (module.UnstructuredGrid2d(pkg.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)),
         module.UnstructuredGrid2d(pkg.Ugrid2d(tverts[:, 0], tverts[:, 1], -1, tfaces)))
        for pkg, module in ((xu, jax_unstructured), (xt, unstructured))
    ]
    (jsource, jtarget), (source, target) = adapters
    with _without_card(monkeypatch):
        source.barycentric(target)
    want = jsource.barycentric(jtarget)
    got = source.barycentric(target, device="cpu")
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-12, atol=1e-14)


# Public names of ``xugrid_tpu`` that the port deliberately lacks.
NOT_PORTED = {
    # The Pallas entry points of TPU kernels #1 and #2 and their TPU plan
    # layouts: the Hopper kernels are ``window_reduce``/``csr_matvec`` and
    # ``window_select``, with their own launch shapes (``reduce_lanes``,
    # ``register_slots``); ROADMAP "Hold outputs, not layouts".
    "xugrid_tpu.regrid.aligned_apply": {
        "A_BLOCK", "AlignedPlan", "CHUNK", "GROUP", "Q_PACK", "R_BATCH", "R_STEP", "W_CHUNKS",
        "aligned_apply", "default_span_steps", "gather_aligned_apply", "matvec_apply", "matvec_triplets",
        "plan_gather_aligned", "plan_gather_matvec", "plan_triplets", "stage_source_aligned",
        "stage_source_matvec",
    },
    "xugrid_tpu.regrid.select_apply": {
        "BLOCK", "CHUNK", "MAX_WINDOW", "PAIR", "PAIR_SPAN", "ROWS", "SELECT_METHODS", "SelectPlan",
        "SplitSelectPlan", "apply_windowed_select", "covers_method", "gather_select_apply",
        "plan_gather_select",
    },
    # The JAX array tests; the port's counterpart is ``is_tensor``.
    "xugrid_tpu.xdata.variable": {"is_jax_array", "get_namespace"},
    # The sample data's download branch, not ported: neither machine has
    # a network, and every loader takes its stand-in (PR 12).
    "xugrid_tpu.data.registry": {"BASE_URL"},
}
# Modules of TPU plan layouts only (kernels #3-#6), ported by function
# through kernel #1.
NOT_PORTED_MODULES = {"xugrid_tpu.regrid.gather_apply"}


def _defined_names(module):
    """Names a module defines at its top level (functions, classes,
    assignments) or lists in ``__all__``: not the ones it imports, nor
    its optional modules."""
    import ast
    import types

    from xugrid_tpu.constants import MissingOptionalModule

    with open(module.__file__, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names = set(getattr(module, "__all__", ()))
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
    return {
        name for name in names
        if not name.startswith("_") and hasattr(module, name)
        and not isinstance(getattr(module, name), (types.ModuleType, MissingOptionalModule))
    }


def test_every_public_name_has_a_counterpart():
    import importlib
    import inspect
    import pkgutil

    missing = []
    for info in pkgutil.walk_packages(xu.__path__, "xugrid_tpu."):
        if info.name in NOT_PORTED_MODULES:
            continue
        module = importlib.import_module(info.name)
        port = importlib.import_module("xugrid_tpu_torch" + info.name[len("xugrid_tpu"):])
        skip = NOT_PORTED.get(info.name, set())
        for name in sorted(_defined_names(module) - skip):
            if not hasattr(port, name):
                missing.append(f"{info.name}.{name}")
                continue
            obj = getattr(module, name)
            if inspect.isclass(obj) and obj.__module__ == info.name:
                missing += [
                    f"{info.name}.{name}.{attr}" for attr in dir(obj)
                    if not attr.startswith("_") and not hasattr(getattr(port, name), attr)
                ]
    assert not missing, missing


# Where the port's signature differs from the JAX package's by design:
# (JAX parameter -> the port's name for it, None where the port has none;
# the parameters the port adds and requires).  Besides these, the port
# may add optional parameters after the JAX ones, or keyword-only: above
# all ``device``, where an entry point runs (the CUDA card unless the
# caller asks for the CPU).
_MESH_TO_GROUP = ({"mesh": "group", "axis": None}, ())
SIGNATURE_EXCEPTIONS = {
    # The JAX device mesh and its axis name become one torch.distributed
    # process group; the exchange that ``shard_map`` gives the JAX method
    # implicitly is the port's ``Exchange`` over that group.
    "xugrid_tpu.parallel.sharding": {
        "NeighborExchangePlan.__init__": _MESH_TO_GROUP,
        "NeighborExchangePlan.gather_neighbors": ({}, ("exchange",)),
        "ShardedRegrid.__init__": _MESH_TO_GROUP,
        "ShardedRegrid.from_regridder": _MESH_TO_GROUP,
        "halo_exchange": _MESH_TO_GROUP,
        "sharded_laplace_smooth": _MESH_TO_GROUP,
        "sharded_cg_solve": _MESH_TO_GROUP,
    },
    # ``align`` takes the old UGRID dimensions' coordinate arrays
    # (``ugridbase.dim_coordinates``), not xarray index objects, which
    # the port's labelled arrays do not have.
    "xugrid_tpu.ugrid.ugridbase": {"align": ({"old_indexes": "old_coords"}, ())},
}
_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _same_default(jax_default, port_default) -> bool:
    """Defaults agree: functions by qualified name, NaN with NaN, any
    other value by type and value."""
    if callable(jax_default) and callable(port_default):
        return jax_default.__qualname__ == port_default.__qualname__
    if isinstance(jax_default, float) and isinstance(port_default, float):
        return jax_default == port_default or (np.isnan(jax_default) and np.isnan(port_default))
    return type(jax_default) is type(port_default) and jax_default == port_default


def _signature_faults(name, jax_fn, port_fn, owner, exception):
    """Where the port's ``port_fn`` refuses a call that ``jax_fn`` takes,
    after the (renames, added) of ``exception``; a port ``None`` default
    stands for the JAX default held by ``owner._DEFAULT_<NAME>``."""
    renames, added = exception
    jax_sig, port_sig = inspect.signature(jax_fn), inspect.signature(port_fn)
    jax_params = [
        p.replace(name=renames.get(p.name, p.name)) for p in jax_sig.parameters.values()
        if renames.get(p.name, p.name) is not None
    ]
    port = port_sig.parameters
    port_positional = [p.name for p in port.values() if p.kind in _POSITIONAL]
    kinds = {p.kind for p in port.values()}
    faults = []
    for i, p in enumerate(jax_params):
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            if p.kind not in kinds:
                faults.append(f"{name}: takes no {'*' if p.kind is p.VAR_POSITIONAL else '**'}{p.name}")
            continue
        q = port.get(p.name)
        if q is None:
            faults.append(f"{name}: lacks {p.name}")
            continue
        if p.kind in _POSITIONAL and (q.kind not in _POSITIONAL or port_positional.index(p.name) != i):
            faults.append(f"{name}: {p.name} is not at position {i}")
        if q.kind is q.POSITIONAL_ONLY and p.kind is not p.POSITIONAL_ONLY:
            faults.append(f"{name}: {p.name} is positional only")
        if p.default is p.empty:
            continue
        if q.default is q.empty:
            faults.append(f"{name}: requires {p.name}, which defaults to {p.default!r}")
        elif q.default is None and p.default is not None and owner is not None:
            class_default = getattr(owner, f"_DEFAULT_{p.name.upper()}", None)
            if not _same_default(p.default, class_default):
                faults.append(f"{name}: {p.name} defaults to None, not {p.default!r}")
        elif not _same_default(p.default, q.default):
            faults.append(f"{name}: {p.name} defaults to {q.default!r}, not {p.default!r}")
    jax_names = {p.name for p in jax_params}
    for q in port.values():
        if q.name in jax_names or q.kind in (q.VAR_POSITIONAL, q.VAR_KEYWORD) or q.name in added:
            continue
        if q.default is q.empty:
            faults.append(f"{name}: requires {q.name}, which the JAX package lacks")
    return faults


def _callables(module, port):
    """(qualified name, JAX function, port function, port class or None)
    for each public function of ``module`` and each public method,
    ``__init__`` included, of the classes it defines."""
    for name in sorted(_defined_names(module) - NOT_PORTED.get(module.__name__, set())):
        obj, port_obj = getattr(module, name), getattr(port, name)
        if inspect.isfunction(obj) and obj.__module__ == module.__name__:
            yield name, obj, port_obj, None
        elif inspect.isclass(obj) and obj.__module__ == module.__name__:
            for attr in sorted(dir(obj)):
                if attr.startswith("_") and attr != "__init__":
                    continue
                method = inspect.getattr_static(obj, attr)
                port_method = inspect.getattr_static(port_obj, attr)
                if isinstance(method, (staticmethod, classmethod)):
                    method, port_method = method.__func__, getattr(port_method, "__func__", port_method)
                if inspect.isfunction(method):
                    yield f"{name}.{attr}", method, port_method, port_obj


def _walked_modules():
    import pkgutil

    return [
        info.name for info in pkgutil.walk_packages(xu.__path__, "xugrid_tpu.")
        if info.name not in NOT_PORTED_MODULES
    ]


@pytest.mark.parametrize("module_name", _walked_modules())
def test_every_signature_matches(module_name):
    import importlib

    module = importlib.import_module(module_name)
    port = importlib.import_module("xugrid_tpu_torch" + module_name[len("xugrid_tpu"):])
    exceptions = SIGNATURE_EXCEPTIONS.get(module_name, {})
    faults = []
    for name, jax_fn, port_fn, owner in _callables(module, port):
        if not callable(port_fn):
            faults.append(f"{name}: not callable in the port")
            continue
        faults += _signature_faults(name, jax_fn, port_fn, owner, exceptions.get(name, ({}, ())))
    assert not faults, faults
