"""
The port's sample data held on the CPU against the JAX package's: every
synthetic dataset bit-equal (``disk()`` through matplotlib's
triangulation; ``provinces_nl`` and ``hydamo_network`` through the
shapely and geopandas stand-ins of ``tests/fake_geo.py``); the registry's
local lookup (``fetch`` finds a file in ``XUGRID_DATA_DIR``, raises on an
unknown name, returns None for an absent file); and sample files placed
there (a small ``elevation_nl.nc``, the xoxo vertex and triangle files)
loaded equally by both packages.  ``XUGRID_DATA_DIR`` and
``XDG_CACHE_HOME`` point into the test's temporary directory, so no file
outside it is read.
"""

import numpy as np
import pandas as pd
import pytest

import xugrid_tpu as xu
import xugrid_tpu_torch as xt
from tests import fake_geo
from xugrid_tpu.data import registry as jax_registry
from xugrid_tpu_torch.data import registry

PACKAGES = (xu, xt)


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    """An empty XUGRID_DATA_DIR, and the cache directory beside it."""
    path = tmp_path / "data"
    path.mkdir()
    monkeypatch.setenv("XUGRID_DATA_DIR", str(path))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    return path


def assert_same_grid(want, got):
    assert type(got).__name__ == type(want).__name__ and got.name == want.name
    np.testing.assert_array_equal(got.node_x, want.node_x)
    np.testing.assert_array_equal(got.node_y, want.node_y)
    np.testing.assert_array_equal(got.face_node_connectivity, want.face_node_connectivity)


def assert_same_variables(want, got, names):
    for name in names:
        w, g = want.obj[name] if hasattr(want, "obj") else want[name], got.obj[name] if hasattr(got, "obj") else got[name]
        assert g.dims == w.dims and g.attrs == w.attrs, name
        np.testing.assert_array_equal(g.values, np.asarray(w.values))


def test_generate_disk_and_transform_equal_jax():
    from xugrid_tpu.data import synthetic as jax_synthetic
    from xugrid_tpu_torch.data import synthetic

    for partitions, depth in ((3, 1), (6, 8), (7, 3)):
        for w, g in zip(jax_synthetic.generate_disk(partitions, depth), synthetic.generate_disk(partitions, depth)):
            np.testing.assert_array_equal(g, w)
    vertices = np.random.default_rng(0).normal(size=(30, 2))
    np.testing.assert_array_equal(synthetic.transform(vertices, 2.0, 5.0, -1.0),
                                  jax_synthetic.transform(vertices, 2.0, 5.0, -1.0))
    with pytest.raises(ValueError, match="partitions"):
        synthetic.generate_disk(2, 4)


def test_disk_equals_jax(data_dir):
    want, got = xu.data.disk(), xt.data.disk()
    assert isinstance(got, xt.UgridDataset)
    assert_same_grid(want.grid, got.grid)
    assert_same_variables(want, got, ["node_z", "face_z", "edge_z"])


@pytest.mark.parametrize("name, kwargs", [("elevation_nl", {"n_points": 3000}), ("elevation_nl", {}),
                                          ("adh_san_diego", {"n_times": 3}), ("xoxo", {})])
def test_synthetic_datasets_equal_jax(data_dir, name, kwargs):
    want = getattr(xu.data, name)(**kwargs)
    got = getattr(xt.data, name)(**kwargs)
    if name == "xoxo":
        assert_same_grid(want, got)
        return
    assert_same_grid(want.grid, got.grid)
    if name == "elevation_nl":
        assert isinstance(got, xt.UgridDataArray) and got.obj.name == "elevation"
        assert got.obj.attrs == want.obj.attrs
        np.testing.assert_array_equal(got.values, np.asarray(want.values))
    else:
        assert_same_variables(want, got, ["elevation", "depth"])
        np.testing.assert_array_equal(got.obj["time"].values, np.asarray(want.obj["time"].values))


def test_vector_datasets_equal_jax(monkeypatch, data_dir):
    shp, _ = fake_geo.install(monkeypatch)
    want, got = xu.data.provinces_nl(), xt.data.provinces_nl()
    pd.testing.assert_frame_equal(got._df, want._df, check_exact=True)
    np.testing.assert_array_equal(shp.get_coordinates(got.geometry), shp.get_coordinates(want.geometry))
    for w, g in zip(xu.data.hydamo_network(), xt.data.hydamo_network()):
        pd.testing.assert_frame_equal(g._df, w._df, check_exact=True)
        for a, b in zip(shp.get_coordinates(g.geometry, return_index=True),
                        shp.get_coordinates(w.geometry, return_index=True)):
            np.testing.assert_array_equal(a, b)


def test_fetch_local_lookup(tmp_path, data_dir):
    for module in (jax_registry, registry):
        assert module.fetch("elevation_nl.nc") is None
        with pytest.raises(ValueError, match="Unknown sample file"):
            module.fetch("nope.nc")
    (data_dir / "hydamo_points.csv").write_text("x,y\n")
    assert registry.fetch("hydamo_points.csv") == str(data_dir / "hydamo_points.csv")
    assert registry.data_dirs() == jax_registry.data_dirs() == [str(data_dir), str(tmp_path / "cache" / "xugrid")]
    cached = tmp_path / "cache" / "xugrid"
    cached.mkdir(parents=True)
    (cached / "xoxo_vertices.txt").write_text("0 0\n")
    assert registry.fetch("xoxo_vertices.txt") == jax_registry.fetch("xoxo_vertices.txt") == str(cached / "xoxo_vertices.txt")
    assert registry.FILES == jax_registry.FILES


def test_sample_files_load_equally(data_dir):
    rng = np.random.default_rng(5)
    from scipy.spatial import Delaunay

    pts = rng.uniform(0.0, 1000.0, (200, 2))
    triangles = Delaunay(pts).simplices.astype(np.int64)
    np.savetxt(data_dir / "xoxo_vertices.txt", pts)
    np.savetxt(data_dir / "xoxo_triangles.txt", triangles, fmt="%d")
    want, got = xu.data.xoxo(), xt.data.xoxo()
    assert_same_grid(want, got)
    np.testing.assert_array_equal(got.face_node_connectivity, triangles)
    # A small elevation_nl.nc written by the port, read by both.
    grid = xt.Ugrid2d(pts[:, 0], pts[:, 1], -1, triangles)
    values = rng.normal(size=grid.n_face)
    uda = xt.UgridDataArray(xt.xdata.DataArray(values, dims=(grid.face_dimension,), name="elevation"), grid)
    uda.ugrid.to_netcdf(data_dir / "elevation_nl.nc")
    want, got = xu.data.elevation_nl(), xt.data.elevation_nl()
    assert isinstance(got, xt.UgridDataArray)
    assert_same_grid(want.grid, got.grid)
    np.testing.assert_array_equal(got.values, values)
    np.testing.assert_array_equal(got.values, np.asarray(want.values))
