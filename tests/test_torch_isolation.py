"""
The port stands alone: in a fresh interpreter, ``import xugrid_tpu_torch``,
a CPU regrid through each regridder (overlap, relative overlap, centroid
locator, barycentric interpolator, network gridder), a CPU Laplace fill,
a CPU ``cg_solve``, a UgridDataArray and a raster DataArray regridded
onto each other and filled through ``.ugrid.laplace_interpolate``, a
UGRID netCDF file and zarr store written and opened, a CPU regrid
through weights stored to netCDF and reloaded with ``from_dataset``, and
a UgridDataArray partitioned, merged with ``merge_partitions`` and
regridded, and the queries (the nearest scan forced on the CPU, the
KDTree lookups, ``sel_points``, the line selections, ``rasterize``,
``to_node``, ``reindex_like``, ``interpolate_na`` on a mesh and along a
network's edge index), and the topology operations (erosion, components,
reordering, the periodic conversion, triangulation, a tessellation, a
network's cycle test), and the payload methods (rank, ffill,
interpolate_na, quantile, idxmax) and a regrid through ``from_weights``
of a regridder's ``weights``, and the vector geometry and sample data
(``ops``, ``data``, burn, snapping, polygonize through the stand-ins of
``tests/fake_geo.py``), and a world-of-1 gloo ``ShardedRegrid`` and
``sharded_cg_solve`` on the CPU (``xugrid_tpu_torch.parallel``), a
``StructuredGrid3d`` overlap applied through ``PaddedCSR.from_coo``, a
curvilinear ``UgridDataArray.from_structured2d`` and a ``trace()`` of an
``annotate`` region load neither jax nor xugrid_tpu, and launch no
kernel.
A subprocess is needed because the test session itself imports jax.

``chip_smoke.py`` refuses to run without a CUDA device: exit code 2 and
no result printed.
"""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REGRID_ON_CPU = textwrap.dedent(
    """
    import sys

    import numpy as np
    import torch

    import xugrid_tpu_torch as xt
    from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec, window_reduce
    from xugrid_tpu_torch.regrid.select_apply import window_select
    from xugrid_tpu_torch.ugrid import interpolate

    def quad(n, dx):
        x = np.arange(n + 1.0) * dx
        yy, xx = np.meshgrid(x, x, indexing="ij")
        j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        nid = lambda ii, jj: jj * (n + 1) + ii
        faces = np.stack([nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)], -1)
        return xt.Ugrid2d(xx.ravel(), yy.ravel(), -1, faces.reshape(-1, 4))

    source, target = quad(12, 1.0), quad(5, 12 / 5)
    data = torch.from_numpy(np.random.default_rng(0).normal(size=(2, source.n_face)))
    for cls, method in [(xt.OverlapRegridder, "mean"), (xt.OverlapRegridder, "median"),
                        (xt.RelativeOverlapRegridder, "first_order_conservative")]:
        out = cls(source, target, method=method).regrid(data, device="cpu")
        assert out.shape == (2, target.n_face) and bool(torch.isfinite(out).all()), method
    for regridder in (xt.CentroidLocatorRegridder(source, target),
                      xt.BarycentricInterpolator(source, target, device="cpu")):
        out = regridder.regrid(data, device="cpu")
        assert out.shape == (2, target.n_face) and bool(torch.isfinite(out).all())
    network = xt.Ugrid1d([0.5, 6.0, 11.5], [0.5, 7.0, 3.0], -1, np.array([[0, 1], [1, 2]]))
    for method in ("mean", "mode"):
        out = xt.NetworkGridder(network, source, method=method).regrid(data[:, :2], device="cpu")
        assert out.shape == (2, source.n_face) and int(torch.isfinite(out).sum()) > 0
    W = source.get_connectivity_matrix(source.node_dimension, xy_weights=True)
    values = np.where(np.arange(source.n_node) % 7 == 0, 1.0 + np.arange(source.n_node), np.nan)
    filled = interpolate.laplace_interpolate(values, W, device="cpu")
    assert np.isfinite(filled).all() and interpolate.last_solve_info["mode"] == "cg"
    n = 50
    rows = np.concatenate([np.arange(1, n), np.arange(n - 1), np.arange(n)])
    cols = np.concatenate([np.arange(n - 1), np.arange(1, n), np.arange(n)])
    vals = np.concatenate([-np.ones(2 * n - 2), np.full(n, 3.0)])
    x, _ = interpolate.cg_solve(rows, cols, vals, np.full(n, 3.0), np.ones(n), np.zeros(n),
                                0.0, 1e-10, 200, device="cpu")
    assert np.isfinite(x).all()
    # Labelled arrays: a UgridDataArray onto a raster DataArray, the
    # raster back onto the mesh, and the accessor's fill.
    uda = xt.UgridDataArray(xt.xdata.DataArray(data, dims=("time", source.face_dimension)), source)
    cells = (np.arange(6) + 0.5) * 2.0
    raster = xt.xdata.DataArray(np.ones((2, 6, 6)), coords={"y": cells[::-1], "x": cells}, dims=("time", "y", "x"))
    on_raster = xt.OverlapRegridder(uda, raster).regrid(uda, device="cpu")
    assert on_raster.dims == ("time", "y", "x") and bool(torch.isfinite(on_raster.data).all())
    on_mesh = xt.BarycentricInterpolator(raster, uda, device="cpu").regrid(raster, device="cpu")
    assert isinstance(on_mesh, xt.UgridDataArray) and on_mesh.shape == (2, source.n_face)
    nodes = xt.UgridDataArray(xt.xdata.DataArray(np.stack([values, 2.0 * values]), dims=("time", source.node_dimension)), source)
    assert np.isfinite(nodes.ugrid.laplace_interpolate(device="cpu").values).all()
    # Files: a UGRID netCDF file and zarr store, and stored weights.
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp()
    uda.ugrid.to_netcdf(tmp + "/mesh.nc")
    uda.ugrid.to_zarr(tmp + "/mesh.zarr")
    for opened in (xt.open_dataset(tmp + "/mesh.nc"), xt.open_zarr(tmp + "/mesh.zarr")):
        assert np.array_equal(opened.grid.face_node_connectivity, source.face_node_connectivity)
        assert np.array_equal(opened["mesh2d_data"].values, data.numpy())
    xt.OverlapRegridder(uda, raster).to_dataset().to_netcdf(tmp + "/weights.nc")
    loaded = xt.OverlapRegridder.from_dataset(xt.xdata.open_dataset(tmp + "/weights.nc"))
    reloaded = loaded.regrid(opened["mesh2d_data"], device="cpu")
    assert torch.equal(reloaded.data, on_raster.data)
    shutil.rmtree(tmp)
    # Partitions: split, merged back and regridded.
    parts = uda.rename("v").ugrid.partition(n_part=3)
    merged = xt.merge_partitions(parts)
    assert merged.grid.n_face == source.n_face and isinstance(merged["v"].data, torch.Tensor)
    out = xt.OverlapRegridder(merged["v"], raster).regrid(merged["v"], device="cpu")
    assert out.dims == ("time", "y", "x")
    assert torch.allclose(out.data, on_raster.data, rtol=1e-12, atol=1e-12)
    # Queries: nearest lookups, point and line selections, rasterize,
    # the facet remaps, reindexing and the nearest fill.
    import os
    import warnings

    from xugrid_tpu_torch.spatial import nearest

    stations = source.node_coordinates + [0.123, 0.311]
    os.environ["XUGRID_TPU_NEAREST"] = "device"
    scanned = nearest.nearest_points(source.face_coordinates, stations, device="cpu")
    del os.environ["XUGRID_TPU_NEAREST"]
    assert np.array_equal(scanned, source.locate_nearest_face(stations))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        at_points = uda.ugrid.sel_points(x=[0.5, 6.2, 40.0], y=[0.5, 3.3, 40.0], method="nearest")
    assert isinstance(at_points.data, torch.Tensor) and bool(torch.isnan(at_points.data[:, 2]).all())
    assert uda.ugrid.intersect_line((0.1, 0.2), (11.5, 11.9)).shape[1] > 11
    assert uda.ugrid.sel(x=slice(None), y=5.5).shape == (2, 12)
    assert uda.ugrid.rasterize(2.0).dims == ("time", "y", "x")
    assert uda.ugrid.to_node().dims == ("time", source.node_dimension, "nmax")
    assert torch.equal(uda.ugrid.reindex_like(source).data, uda.data)
    gappy = xt.UgridDataArray(xt.xdata.DataArray(np.where(np.arange(source.n_face) % 3, np.nan, 1.0),
                              dims=(source.face_dimension,)), source)
    assert np.isfinite(gappy.ugrid.interpolate_na().values).all()
    assert network.locate_points([[3.25, 3.75]])[0] == 0
    wet = xt.UgridDataArray(xt.xdata.DataArray(torch.from_numpy(np.arange(source.n_face) % 4 > 0),
                            dims=(source.face_dimension,)), source)
    assert wet.ugrid.binary_erosion(border_value=True).ugrid.connected_components().data.dtype == torch.int32
    assert uda.ugrid.reverse_cuthill_mckee().ugrid.to_periodic().ugrid.grid.n_face == source.n_face
    assert source.triangulate().tesselate_circumcenter_voronoi(device="cpu").n_face == source.n_node
    assert not network.is_cyclic
    stats = uda.rank("time").ffill("time").interpolate_na("time").quantile([0.1, 0.9], "time")
    assert stats.dims == ("quantile", source.face_dimension)
    assert isinstance(uda.mean("time").idxmax(source.face_dimension).data, torch.Tensor)
    assert xt.OverlapRegridder.from_weights(xt.OverlapRegridder(uda, raster).weights, raster).regrid(
        uda, device="cpu").dims == ("time", "y", "x")
    # Vector geometry and the sample data, through the numpy stand-ins of
    # shapely and geopandas placed in sys.modules.
    from tests.fake_geo import _make_geopandas_module, _make_shapely_module

    sys.modules["shapely"], sys.modules["geopandas"] = shp, gpd = _make_shapely_module(), _make_geopandas_module()
    provinces = xt.data.provinces_nl()
    scale = 12.0 / 300e3
    squeezed = gpd.GeoDataFrame({"id": provinces["id"].to_numpy()}, geometry=[
        shp.Polygon(shp.get_coordinates(p.exterior) * scale) for p in provinces.geometry])
    burned = xt.burn_vector_geometry(squeezed, source, column="id")
    assert np.isfinite(burned.values).sum() > 0 and isinstance(burned.obj.data, np.ndarray)
    assert xt.polygonize(burned)["values"].size > 0
    assert xt.earcut_triangulate_polygons(squeezed, column="id").grid.n_face > 12
    objects, _, _ = xt.data.hydamo_network()
    channels = gpd.GeoDataFrame({"id": objects["id"].to_numpy()}, geometry=[
        shp.LineString(shp.get_coordinates(g) / 50e3 * 11.0 + [0.5, 6.0]) for g in objects.geometry])
    snapped, snapped_gdf = xt.snap_to_grid(channels, source, 0.5)
    assert np.isfinite(snapped["line_index"].values).sum() > 0
    assert xt.Ugrid1d.from_geodataframe(snapped_gdf).n_edge == len(snapped_gdf)
    assert xt.snap_nodes(np.array([0.0, 1e-9, 1.0]), np.zeros(3), 1e-6)[0].tolist() == [0, 0, 1]
    assert xt.data.disk()["face_z"].shape[0] > 0
    # The sharded regrid and CG in a world of one gloo rank, the 3-D
    # structured grids, curvilinear bounds and the profiler hooks.
    import torch.distributed as dist

    from xugrid_tpu_torch.core.sparse import MatrixCOO, PaddedCSR
    from xugrid_tpu_torch.parallel import ShardedRegrid, hilbert_layout, sharded_cg_solve
    from xugrid_tpu_torch.regrid import StructuredGrid3d, reduce
    from xugrid_tpu_torch.regrid.apply import apply_weights
    from xugrid_tpu_torch.utils.profiling import annotate, trace

    tmp = tempfile.mkdtemp()
    dist.init_process_group("gloo", init_method="file://" + tmp + "/store", world_size=1, rank=0)
    regridder = xt.OverlapRegridder(source, target, method="mean")
    coo = regridder._weights.to_coo()
    _, _, hilbert = hilbert_layout(source.centroids, target.centroids, coo.row, coo.col, coo.data)
    for method in ("halo", "allgather"):
        sharded = ShardedRegrid(None, hilbert, method=method, device="cpu")
        assert sharded.method == method and sharded.gather(sharded(data)).shape == (2, target.n_face)
    x, k = sharded_cg_solve(None, np.array([[1], [0]]), -np.ones((2, 1)), np.full(2, 3.0), np.ones(2), device="cpu")
    assert np.allclose(x, 0.5) and k > 0
    dist.destroy_process_group()
    voxels = xt.xdata.DataArray(np.zeros((4, 6, 6)), coords={"z": np.arange(4.0), "y": np.arange(6.0),
                                "x": np.arange(6.0)}, dims=("z", "y", "x"))
    coarse = xt.xdata.DataArray(np.zeros((2, 3, 3)), coords={"z": np.arange(2) * 2.0 + 0.5,
                                "y": np.arange(3) * 2.0 + 0.5, "x": np.arange(3) * 2.0 + 0.5}, dims=("z", "y", "x"))
    s3, t3, w3 = StructuredGrid3d(voxels).overlap(StructuredGrid3d(coarse), relative=False)
    voxel_weights = PaddedCSR.from_coo(MatrixCOO.from_triplet(t3, s3, w3, n=18, m=144))
    with trace(tmp):
        with annotate("isolation.apply"):
            voxel_mean = apply_weights(voxel_weights, torch.ones(1, 144), reduce.mean, 18)
    assert bool(torch.all(voxel_mean == 1.0))
    corners = np.array([[[0.0, 1.0, 1.0, 0.0], [1.0, 2.0, 2.0, 1.0]]])
    curvilinear = xt.UgridDataArray.from_structured2d(
        xt.xdata.DataArray(np.ones((1, 2)), dims=("eta", "xi")), x="xi", y="eta",
        x_bounds=corners, y_bounds=np.array([[[0.0, 0.0, 1.0, 1.0], [0.0, 0.0, 1.0, 1.0]]]))
    assert curvilinear.grid.n_face == 2
    shutil.rmtree(tmp)
    loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                    or m == "xugrid_tpu" or m.startswith("xugrid_tpu."))
    assert not loaded, loaded
    assert window_reduce.launches == 0 and window_select.launches == 0 and csr_matvec.launches == 0
    print("isolated")
    """
)


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


def test_port_imports_neither_jax_nor_xugrid_tpu():
    proc = _run(["-c", REGRID_ON_CPU], cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "isolated"


IMPORTS_ONLY = textwrap.dedent(
    """
    import sys

    import numpy as np

    import xugrid_tpu_torch
    import xugrid_tpu_torch.plot
    import xugrid_tpu_torch.spatial.queries as q
    from xugrid_tpu_torch.spatial import build_bvh

    tree = q.bvh_to_device(build_bvh(np.array([[0.0, 0.0, 1.0, 1.0], [1.0, 0.0, 2.0, 1.0]]), 1), device="cpu")
    counts = q.count_box_overlaps_kernel(np.array([[0.5, 0.5, 1.5, 0.6]]), tree, tree.node_bbox[1:], 1, 1)
    assert counts.tolist() == [2]
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "xugrid_tpu", "matplotlib"))
    assert not loaded, loaded
    print("isolated")
    """
)


def test_imports_load_neither_jax_nor_matplotlib():
    """``import xugrid_tpu_torch``, ``xugrid_tpu_torch.plot`` and
    ``xugrid_tpu_torch.spatial.queries`` and a BVH query on the CPU load
    none of jax, xugrid_tpu and matplotlib (the card machine has no
    matplotlib)."""
    proc = _run(["-c", IMPORTS_ONLY], cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "isolated"


def test_chip_smoke_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run(["chip_smoke.py"], cwd=REPO)
    assert proc.returncode == 2, proc.stderr
    assert proc.stdout == ""
