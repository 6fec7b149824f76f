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

import numpy as np
import pytest

import xugrid_tpu as xu
import xugrid_tpu_torch as xt
from tests.test_torch_serialize import assert_weights_bit_equal, build, sources
from tests.test_torch_wrap import inputs, values_of  # noqa: F401
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
