"""
The port's vector geometry held on the CPU against the JAX package's, on
the same numpy-seeded inputs, through the numpy stand-ins of shapely and
geopandas in ``tests/fake_geo.py`` (``fake_geo.install`` places them in
``sys.modules``, where the port looks them up at each call):

- ``earcut_triangulate`` on random rings with holes: triangles bit-equal;
- ``burn_vector_geometry`` of mixed polygons (one with a hole), lines and
  points, with and without ``all_touched``, ``column`` and ``fill``:
  values bit-equal; the type errors alike;
- ``earcut_triangulate_polygons``: the mesh and its values bit-equal;
- ``polygonize``: rings bit-equal, each polygon's value its region's
  (scipy's components; the JAX package can give an enclosed region the
  value of the region around it);
- ``snap_nodes``, ``snap_to_nodes`` (both tiebreakers and the tie error),
  ``snap_to_edges``, ``create_snap_to_grid_dataframe`` and
  ``snap_to_grid``: bit-equal; the error on a string column alike;
- the ``conversion`` round trips, ``from_geodataframe`` and
  ``to_geodataframe`` of both grids and both accessors,
  ``bounding_polygon``, and ``to_crs`` raising as the JAX package does;
- the slice: a burn, its mode and mean regrids onto a raster on
  ``device="cpu"`` and its polygonize against the JAX package's
  (oracle (a)): the mode bit-equal, the mean within rtol 1e-6, the
  polygons' rings bit-equal and their values their regions'.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
import xugrid_tpu as xu
import xugrid_tpu_torch as xt
from tests import fake_geo
from xugrid_tpu.ops.earcut import earcut_triangulate as jax_earcut
from xugrid_tpu_torch import conversion
from xugrid_tpu_torch.ops.earcut import earcut_triangulate
from xugrid_tpu_torch.ugrid import snapping

PACKAGES = (xu, xt)
N_SIDE = 16


@pytest.fixture
def geo(monkeypatch):
    return fake_geo.install(monkeypatch)


@pytest.fixture(scope="module")
def mesh():
    rng = np.random.default_rng(12)
    (verts, faces), (tverts, tfaces) = chip_smoke.bench_meshes(N_SIDE, 5, rng)
    return {pkg: (pkg.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces), pkg.Ugrid2d(tverts[:, 0], tverts[:, 1], -1, tfaces))
            for pkg in PACKAGES}


def blob(rng, cx, cy, radius, n, clockwise=False):
    """A star-shaped ring of n vertices around (cx, cy)."""
    angle = np.sort(rng.uniform(0.0, 2.0 * np.pi, n))
    r = radius * rng.uniform(0.6, 1.0, n)
    ring = np.column_stack([cx + r * np.cos(angle), cy + r * np.sin(angle)])
    return ring[::-1] if clockwise else ring


def polygons(shp, gpd, rng):
    """Provinces over the 16 x 16 mesh: three blobs, one with a hole, an
    aligned square; three channel lines; four gauge points (one outside)."""
    geoms = [
        shp.Polygon(blob(rng, 4.0, 4.0, 3.0, 12)),
        shp.Polygon(blob(rng, 11.0, 5.0, 3.5, 15, clockwise=True), [blob(rng, 11.0, 5.0, 1.2, 6)]),
        shp.Polygon(blob(rng, 8.0, 12.0, 3.2, 9)),
        shp.Polygon(np.array([[1.0, 9.0], [4.0, 9.0], [4.0, 12.0], [1.0, 12.0]])),
        shp.LineString(np.column_stack([np.linspace(0.5, 15.5, 9), 8.0 + 2.0 * np.sin(np.linspace(0, 3, 9))])),
        shp.LineString([[2.2, 0.3], [2.7, 15.1]]),
        shp.LineString([[14.5, 14.5], [10.0, 9.0], [15.2, 1.0]]),
        shp.Point(3.3, 3.1), shp.Point(12.4, 12.9), shp.Point(7.7, 0.2), shp.Point(30.0, 30.0),
    ]
    values = np.arange(len(geoms), dtype=float) * 1.5 + 1.0
    return gpd.GeoDataFrame({"value": values, "id": np.arange(len(geoms))}, geometry=geoms)


def coordinates(shp, geometry):
    xy, index = shp.get_coordinates(geometry, return_index=True)
    return xy, index


def assert_same_geometry(shp, want, got):
    wxy, wi = coordinates(shp, want)
    gxy, gi = coordinates(shp, got)
    np.testing.assert_array_equal(gxy, wxy)
    np.testing.assert_array_equal(gi, wi)
    assert [g.type_id for g in shp_list(got)] == [g.type_id for g in shp_list(want)]


def shp_list(geometry):
    return list(fake_geo._as_geom_list(geometry))


def assert_same_grid(want, got):
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_array_equal(got.node_x, want.node_x)
    np.testing.assert_array_equal(got.node_y, want.node_y)
    conn = "face_node_connectivity" if hasattr(want, "face_node_connectivity") else "edge_node_connectivity"
    np.testing.assert_array_equal(getattr(got, conn), getattr(want, conn))


def raises_alike(fn_jax, fn_torch, exc=Exception):
    with pytest.raises(exc) as want:
        fn_jax()
    with pytest.raises(type(want.value)) as got:
        fn_torch()
    assert str(got.value) == str(want.value)


# -- earcut ------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n_holes", [0, 1, 3])
def test_earcut_equals_jax(seed, n_holes):
    rng = np.random.default_rng(seed)
    rings = [blob(rng, 0.0, 0.0, 10.0, int(rng.integers(8, 40)), clockwise=bool(seed % 2))]
    for k in range(n_holes):
        angle = 2.0 * np.pi * k / max(n_holes, 1)
        rings.append(blob(rng, 3.0 * np.cos(angle), 3.0 * np.sin(angle), 1.0, int(rng.integers(3, 9))))
    if seed % 3 == 0:  # closed rings, as GEOS gives them
        rings = [np.vstack([r, r[:1]]) for r in rings]
    vertices = np.vstack(rings)
    ends = np.cumsum([len(r) for r in rings])
    want = jax_earcut(vertices, ends)
    got = earcut_triangulate(vertices, ends)
    np.testing.assert_array_equal(got, want)
    # The triangles cover the exterior less the holes.
    tri = vertices[got]
    areas = 0.5 * ((tri[:, 1, 0] - tri[:, 0, 0]) * (tri[:, 2, 1] - tri[:, 0, 1])
                   - (tri[:, 2, 0] - tri[:, 0, 0]) * (tri[:, 1, 1] - tri[:, 0, 1]))
    shoelace = [0.5 * abs(np.sum(r[:, 0] * np.roll(r[:, 1], -1) - np.roll(r[:, 0], -1) * r[:, 1])) for r in rings]
    np.testing.assert_allclose(np.abs(areas).sum(), shoelace[0] - sum(shoelace[1:]), rtol=1e-9)


def test_celltree_locate_faces_equals_jax(mesh):
    """The (query polygon, tree face) pairs of positive overlap, and the
    area tolerance of the burn's all_touched."""
    raster = mesh[xt][1]
    args = (raster.node_coordinates, raster.face_node_connectivity)
    trees = {pkg: mesh[pkg][0].celltree for pkg in PACKAGES}
    pairs = {}
    for pkg in PACKAGES:
        qi, ti = trees[pkg].locate_faces(*args)
        order = np.lexsort((ti, qi))
        pairs[pkg] = (qi[order], ti[order])
    for w, g in zip(pairs[xu], pairs[xt]):
        np.testing.assert_array_equal(g, w)
    assert len(pairs[xt][0]) >= mesh[xt][0].n_face
    assert trees[xt].default_area_tolerance() == trees[xu].default_area_tolerance()


# -- burn --------------------------------------------------------------------
@pytest.mark.parametrize("all_touched", [False, True])
@pytest.mark.parametrize("column, fill", [(None, np.nan), ("value", np.nan), ("id", -1)])
def test_burn_equals_jax(geo, mesh, all_touched, column, fill):
    shp, gpd = geo
    gdf = polygons(shp, gpd, np.random.default_rng(5))
    out = {}
    for pkg in PACKAGES:
        grid = mesh[pkg][0]
        like = pkg.UgridDataArray(pkg.xdata.DataArray(np.zeros(grid.n_face), dims=(grid.face_dimension,)), grid)
        out[pkg] = xu.burn_vector_geometry if pkg is xu else xt.burn_vector_geometry
        out[pkg] = out[pkg](gdf, like, column=column, fill=fill, all_touched=all_touched)
    want, got = out[xu], out[xt]
    assert isinstance(got, xt.UgridDataArray) and got.obj.name == want.obj.name
    assert got.obj.dims == want.obj.dims and isinstance(got.obj.data, np.ndarray)
    np.testing.assert_array_equal(got.obj.data, np.asarray(want.obj.data))
    assert np.isfinite(got.obj.data).sum() > 50 if fill != -1 else (got.obj.data != -1).sum() > 50


def test_burn_all_touched_covers_centroids(geo, mesh):
    shp, gpd = geo
    gdf = polygons(shp, gpd, np.random.default_rng(5))
    grid = mesh[xt][0]
    inside = xt.burn_vector_geometry(gdf, grid).values
    touched = xt.burn_vector_geometry(gdf, grid, all_touched=True).values
    assert (np.isfinite(touched) >= np.isfinite(inside)).all() and np.isfinite(touched).sum() > np.isfinite(inside).sum()


def test_burn_type_errors_alike(geo, mesh):
    shp, gpd = geo
    gdf = polygons(shp, gpd, np.random.default_rng(5))
    raises_alike(lambda: xu.burn_vector_geometry(gdf._df, mesh[xu][0]),
                 lambda: xt.burn_vector_geometry(gdf._df, mesh[xt][0]), TypeError)
    raises_alike(lambda: xu.burn_vector_geometry(gdf, mesh[xu][0].node_coordinates),
                 lambda: xt.burn_vector_geometry(gdf, mesh[xt][0].node_coordinates), TypeError)
    collection = gpd.GeoDataFrame(geometry=[shp.GeometryCollection([]), shp.Point(1.0, 1.0)])
    raises_alike(lambda: xu.burn_vector_geometry(collection, mesh[xu][0]),
                 lambda: xt.burn_vector_geometry(collection, mesh[xt][0]), TypeError)
    raises_alike(lambda: xu.earcut_triangulate_polygons(collection),
                 lambda: xt.earcut_triangulate_polygons(collection), TypeError)


@pytest.mark.parametrize("column", [None, "value"])
def test_earcut_triangulate_polygons_equals_jax(geo, column):
    shp, gpd = geo
    gdf = polygons(shp, gpd, np.random.default_rng(5)).loc[np.arange(11) < 4]
    want = xu.earcut_triangulate_polygons(gdf, column=column)
    got = xt.earcut_triangulate_polygons(gdf, column=column)
    assert_same_grid(want.grid, got.grid)
    assert got.obj.name == want.obj.name
    np.testing.assert_array_equal(got.obj.data, np.asarray(want.obj.data))
    grid, index = xt.Ugrid2d.earcut_triangulate_polygons(gdf, return_index=True)
    assert_same_grid(want.grid, grid)
    np.testing.assert_array_equal(index, xu.Ugrid2d.earcut_triangulate_polygons(gdf, return_index=True)[1])
    # Every polygon's triangles cover its area.
    areas = np.bincount(index, weights=grid.area)
    for k, polygon in enumerate(shp_list(gdf.geometry)):
        rings = [polygon.exterior.coords] + [r.coords for r in polygon.interiors]
        shoelace = [0.5 * abs(np.sum(r[:-1, 0] * r[1:, 1] - r[1:, 0] * r[:-1, 1])) for r in rings]
        np.testing.assert_allclose(areas[k], shoelace[0] - sum(shoelace[1:]), rtol=1e-12)


# -- polygonize --------------------------------------------------------------
def classified(pkg, grid, payload, layout):
    x, y = grid.face_x, grid.face_y
    if layout == "bands":
        values = np.where(x < 5.0, 1.0, np.where(y < 8.0, 2.0, 3.0))
        values[(np.abs(x - 11.0) < 2.0) & (np.abs(y - 12.0) < 2.0)] = 1.0  # an island inside region 3
        values[(x > 14.0) & (y < 2.0)] = np.nan
    else:  # regions enclosed by others, and a NaN hole
        values = np.where(x < 6.0, 1.0, 2.0)
        values[(np.abs(x - 10.0) < 3.0) & (np.abs(y - 8.0) < 3.0)] = 3.0
        values[(np.abs(x - 10.0) < 1.0) & (np.abs(y - 8.0) < 1.0)] = 5.0
        values[(np.abs(x - 3.0) < 1.5) & (np.abs(y - 8.0) < 1.5)] = np.nan
        values[(x > 13.0) & (y > 13.0)] = 4.0
    data = torch.from_numpy(values) if payload == "tensor" else values
    return pkg.UgridDataArray(pkg.xdata.DataArray(data, dims=(grid.face_dimension,)), grid)


def region_values(grid, values):
    """The value of each connected region of equal-valued faces (scipy),
    regions numbered by their lowest face."""
    import scipy.sparse
    import scipy.sparse.csgraph

    ok = ~np.isnan(values)
    i, j = grid.edge_face_connectivity.T
    same = (i >= 0) & (j >= 0)
    same &= ok[np.maximum(i, 0)] & ok[np.maximum(j, 0)] & (values[np.maximum(i, 0)] == values[np.maximum(j, 0)])
    graph = scipy.sparse.coo_matrix((np.ones(int(same.sum())), (i[same], j[same])), shape=(grid.n_face,) * 2)
    _, labels = scipy.sparse.csgraph.connected_components(graph, directed=False)
    _, first = np.unique(labels[ok], return_index=True)
    return values[ok][first]


@pytest.mark.parametrize("layout", ["bands", "nested"])
@pytest.mark.parametrize("payload", ["numpy", "tensor"])
def test_polygonize_equals_jax(geo, payload, layout):
    """The rings bit-equal to the JAX package's; each polygon's value that
    of its region (the JAX package gives an enclosed region the value of
    the region around it)."""
    grids = {pkg: fake_quad(pkg, 16) for pkg in PACKAGES}
    want = xu.polygonize(classified(xu, grids[xu], "numpy", layout))
    source = classified(xt, grids[xt], payload, layout)
    got = xt.polygonize(source)
    regions = region_values(grids[xt], source.values)
    assert len(got) == len(want) == len(regions) == (4 if layout == "bands" else 5)
    np.testing.assert_array_equal(got["values"].to_numpy(), regions)
    for g, w in zip(shp_list(got.geometry), shp_list(want.geometry)):
        np.testing.assert_array_equal(g.exterior.coords, w.exterior.coords)


def test_polygonize_refuses_other_dims(geo, mesh):
    grid = mesh[xt][0]
    uda = {pkg: pkg.UgridDataArray(pkg.xdata.DataArray(np.zeros((2, grid.n_face)), dims=("time", grid.face_dimension)),
                                   mesh[pkg][0]) for pkg in PACKAGES}
    raises_alike(lambda: xu.polygonize(uda[xu]), lambda: xt.polygonize(uda[xt]), ValueError)


def fake_quad(pkg, n):
    verts, faces = chip_smoke.quad_mesh(n, n)
    return pkg.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)


# -- snapping ----------------------------------------------------------------
def test_snap_nodes_equals_jax():
    rng = np.random.default_rng(7)
    base = rng.uniform(0.0, 10.0, (60, 2))
    copies = base[rng.integers(0, 60, 40)] + rng.uniform(-0.05, 0.05, (40, 2))
    xy = np.vstack([base, copies])[rng.permutation(100)]
    for distance in (0.01, 0.1, 0.5):
        want = xu.snap_nodes(xy[:, 0], xy[:, 1], distance)
        got = xt.snap_nodes(xy[:, 0], xy[:, 1], distance)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    inverse, _, _ = xt.snap_nodes(xy[:, 0], xy[:, 1], 1e-9)
    assert inverse is None


def test_snap_to_nearest_numpy_loop_equals_native():
    """The numpy greedy (taken without the native library) against the
    native kernel on the same distance matrix."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(8)
    xy = rng.uniform(0.0, 5.0, (300, 2))
    tree = cKDTree(xy)
    distances = tree.sparse_distance_matrix(tree, max_distance=0.4, output_type="coo_matrix").tocsr()
    candidates = np.flatnonzero(distances.getnnz(axis=1) > 1)
    native = snapping._snap_to_nearest(distances, candidates, 0.4)
    from xugrid_tpu_torch.utils import native as native_module

    original = native_module.snap_to_nearest_native
    native_module.snap_to_nearest_native = lambda *args: None
    try:
        loop = snapping._snap_to_nearest(distances, candidates, 0.4)
    finally:
        native_module.snap_to_nearest_native = original
    np.testing.assert_array_equal(loop, native)


@pytest.mark.parametrize("tiebreaker", [None, "nearest"])
def test_snap_to_nodes_equals_jax(tiebreaker):
    rng = np.random.default_rng(9)
    to = rng.uniform(0.0, 10.0, (50, 2))
    xy = np.vstack([to[:20] + rng.uniform(-0.01, 0.01, (20, 2)), rng.uniform(0.0, 10.0, (30, 2))])
    distance = 0.05 if tiebreaker is None else 1.5  # ties only at the larger reach
    want = xu.ugrid.snapping.snap_to_nodes(xy[:, 0], xy[:, 1], to[:, 0], to[:, 1], distance, tiebreaker)
    got = snapping.snap_to_nodes(xy[:, 0], xy[:, 1], to[:, 0], to[:, 1], distance, tiebreaker)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_snap_to_nodes_errors_alike():
    xy = np.array([[0.0, 0.0], [5.0, 5.0]])
    to = np.array([[0.1, 0.0], [0.0, 0.1], [9.0, 9.0]])
    args = (xy[:, 0], xy[:, 1], to[:, 0], to[:, 1], 0.5)
    raises_alike(lambda: xu.ugrid.snapping.snap_to_nodes(*args), lambda: snapping.snap_to_nodes(*args), ValueError)
    raises_alike(lambda: xu.ugrid.snapping.snap_to_nodes(*args, tiebreaker="first"),
                 lambda: snapping.snap_to_nodes(*args, tiebreaker="first"), ValueError)


def channels(shp, gpd, rng, strings=False):
    lines = [
        shp.LineString(np.column_stack([np.linspace(0.3, 15.6, 12), 7.0 + 3.0 * np.sin(np.linspace(0, 4, 12))])),
        shp.LineString([[3.1, 0.4], [3.9, 8.2], [2.2, 15.3]]),
        shp.LineString(np.column_stack([12.0 + rng.uniform(-1, 1, 6), np.linspace(1.0, 14.0, 6)])),
    ]
    columns = {"depth": np.array([1.5, 2.0, 3.5]), "id": np.arange(3)}
    if strings:
        columns["code"] = ["main", "north", "east"]
    return gpd.GeoDataFrame(columns, geometry=lines)


def test_snap_to_edges_and_dataframe_equal_jax(geo, mesh):
    shp, gpd = geo
    lines = channels(shp, gpd, np.random.default_rng(10))
    want = xu.create_snap_to_grid_dataframe(lines, mesh[xu][0], 0.5)
    got = xt.create_snap_to_grid_dataframe(lines, mesh[xt][0], 0.5)
    assert len(got) > 20
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    raises_alike(lambda: xu.create_snap_to_grid_dataframe(lines, mesh[xu][0].node_coordinates, 0.5),
                 lambda: xt.create_snap_to_grid_dataframe(lines, mesh[xt][0].node_coordinates, 0.5), TypeError)
    points = gpd.GeoDataFrame(geometry=[shp.Point(1.0, 1.0)])
    raises_alike(lambda: xu.ugrid.snapping.coerce_geometry(points), lambda: snapping.coerce_geometry(points), ValueError)


def test_snap_to_edges_direct_equals_jax(mesh):
    grids = {pkg: mesh[pkg][0] for pkg in PACKAGES}
    rng = np.random.default_rng(11)
    p = rng.uniform(0.0, 16.0, (40, 2))
    segments = np.stack([p, p + rng.normal(0.0, 3.0, (40, 2))], axis=1)
    segments[5, 1] = segments[5, 0]  # a degenerate segment
    out = {}
    for pkg, module in ((xu, xu.ugrid.snapping), (xt, snapping)):
        grid = grids[pkg]
        _, face_index, segment_edges = grid.celltree.intersect_edges(segments)
        out[pkg] = module.snap_to_edges(face_index, segment_edges, grid.face_edge_connectivity,
                                        grid.edge_face_connectivity, grid.centroids, 1e-12)
    for w, g in zip(out[xu], out[xt]):
        np.testing.assert_array_equal(g, w)
    assert len(out[xt][0]) > 40


@pytest.mark.parametrize("target", ["grid", "uda"])
def test_snap_to_grid_equals_jax(geo, mesh, target):
    shp, gpd = geo
    lines = channels(shp, gpd, np.random.default_rng(10))
    out = {}
    for pkg in PACKAGES:
        grid = mesh[pkg][0]
        like = grid if target == "grid" else pkg.UgridDataArray(
            pkg.xdata.DataArray(np.zeros(grid.n_face), dims=(grid.face_dimension,)), grid)
        out[pkg] = pkg.snap_to_grid(lines, like, 0.5)
    (wuds, wgdf), (guds, ggdf) = out[xu], out[xt]
    assert isinstance(guds, xt.UgridDataset)
    assert sorted(guds.obj.data_vars) == sorted(wuds.obj.data_vars) == ["depth", "id", "line_index"]
    for var in wuds.obj.data_vars:
        np.testing.assert_array_equal(guds[var].values, np.asarray(wuds[var].values))
    assert np.isfinite(guds["line_index"].values).sum() > 20
    pd.testing.assert_frame_equal(ggdf._df, wgdf._df, check_exact=True)
    assert_same_geometry(shp, wgdf.geometry, ggdf.geometry)


def test_snap_to_grid_string_column_raises_alike(geo, mesh):
    shp, gpd = geo
    lines = channels(shp, gpd, np.random.default_rng(10), strings=True)
    raises_alike(lambda: xu.snap_to_grid(lines, mesh[xu][0], 0.5), lambda: xt.snap_to_grid(lines, mesh[xt][0], 0.5),
                 ValueError)


# -- conversions -------------------------------------------------------------
def test_conversion_round_trips_equal_jax(geo, mesh):
    shp, _ = geo
    from xugrid_tpu import conversion as jax_conversion

    grid = mesh[xt][0]
    x, y = grid.node_x, grid.node_y
    for name, args in (
        ("nodes_to_points", (x, y)),
        ("edges_to_linestrings", (x, y, grid.edge_node_connectivity)),
        ("faces_to_polygons", (x, y, grid.face_node_connectivity)),
    ):
        want = getattr(jax_conversion, name)(*args)
        got = getattr(conversion, name)(*args)
        assert_same_geometry(shp, want, got)
    points = conversion.nodes_to_points(x, y)
    for w, g in zip(jax_conversion.points_to_nodes(points), conversion.points_to_nodes(points)):
        np.testing.assert_array_equal(g, w)
    lines = conversion.edges_to_linestrings(x, y, grid.edge_node_connectivity)
    for w, g in zip(jax_conversion.linestrings_to_edges(lines), conversion.linestrings_to_edges(lines)):
        np.testing.assert_array_equal(g, w)
    faces = conversion.faces_to_polygons(x, y, grid.face_node_connectivity)
    fx, fy, fconn = conversion.polygons_to_faces(faces)
    for w, g in zip(jax_conversion.polygons_to_faces(faces), (fx, fy, fconn)):
        np.testing.assert_array_equal(g, w)
    # The round trip gives every face its node coordinates back.
    np.testing.assert_array_equal(np.stack([fx[fconn], fy[fconn]], -1), grid.node_coordinates[grid.face_node_connectivity])


def test_grids_from_and_to_geodataframe_equal_jax(geo, mesh):
    shp, gpd = geo
    rng = np.random.default_rng(4)
    nodes, edges = chip_smoke.random_network(3, 10, float(N_SIDE), rng)
    for kind in ("Ugrid2d", "Ugrid1d"):
        grids = {pkg: mesh[pkg][0] if kind == "Ugrid2d" else pkg.Ugrid1d(nodes[:, 0], nodes[:, 1], -1, edges)
                 for pkg in PACKAGES}
        dims = [grids[xt].node_dimension, grids[xt].edge_dimension]
        if kind == "Ugrid2d":
            dims.append(grids[xt].face_dimension)
        for dim in dims:
            assert_same_geometry(shp, grids[xu].to_shapely(dim), grids[xt].to_shapely(dim))
        raises_alike(lambda: grids[xu].to_shapely("nope"), lambda: grids[xt].to_shapely("nope"), ValueError)
        core = dims[-1]
        gdf = gpd.GeoDataFrame({"v": np.arange(len(grids[xt].to_shapely(core)))}, geometry=grids[xt].to_shapely(core))
        want = getattr(xu, kind).from_geodataframe(gdf)
        got = getattr(xt, kind).from_geodataframe(gdf)
        assert_same_grid(want, got)
        assert_same_grid(xu.conversion.grid_from_geodataframe(gdf), conversion.grid_from_geodataframe(gdf))
        raises_alike(lambda: getattr(xu, kind).from_geodataframe(gdf._df),
                     lambda: getattr(xt, kind).from_geodataframe(gdf._df), TypeError)
        wrong = grids[xt].to_shapely(grids[xt].node_dimension)
        raises_alike(lambda: getattr(xu, kind).from_shapely(wrong), lambda: getattr(xt, kind).from_shapely(wrong),
                     TypeError)
    with pytest.warns(DeprecationWarning):
        got = grids[xt].to_pygeos(grids[xt].edge_dimension)
    assert_same_geometry(shp, grids[xu].to_shapely(grids[xu].edge_dimension), got)
    mixed = gpd.GeoDataFrame(geometry=[shp.Point(0.0, 0.0), shp.LineString([[0.0, 0.0], [1.0, 1.0]])])
    points = gpd.GeoDataFrame(geometry=[shp.Point(0.0, 0.0)])
    for gdf in (mixed, points, mixed._df):
        raises_alike(lambda: xu.conversion.grid_from_geodataframe(gdf), lambda: conversion.grid_from_geodataframe(gdf))


def test_grid_from_dataset_equals_jax(mesh):
    for pkg, module in ((xu, xu.conversion), (xt, conversion)):
        ds = mesh[pkg][0].to_dataset()
        assert type(module.grid_from_dataset(ds, "mesh2d")).__name__ == "Ugrid2d"
    assert_same_grid(xu.conversion.grid_from_dataset(mesh[xu][0].to_dataset(), "mesh2d"),
                     conversion.grid_from_dataset(mesh[xt][0].to_dataset(), "mesh2d"))


@pytest.mark.parametrize("payload", ["numpy", "tensor"])
def test_accessors_to_geodataframe_equal_jax(geo, mesh, payload):
    shp, _ = geo
    rng = np.random.default_rng(13)
    grid = mesh[xt][0]
    face = rng.normal(size=(2, grid.n_face))
    node = rng.normal(size=grid.n_node)
    out = {}
    for pkg in PACKAGES:
        wrap = torch.from_numpy if (pkg is xt and payload == "tensor") else (lambda a: a)
        g = mesh[pkg][0]
        uda = pkg.UgridDataArray(pkg.xdata.DataArray(wrap(face), coords={"time": [1.0, 2.0]},
                                                     dims=("time", g.face_dimension), name="h"), g)
        ds = pkg.xdata.Dataset({"h": (("time", g.face_dimension), wrap(face)), "z": ((g.node_dimension,), wrap(node))},
                               coords={"time": [1.0, 2.0]})
        uds = pkg.UgridDataset(ds, [g])
        out[pkg] = [uda.ugrid.to_geodataframe(), uda.ugrid.to_geodataframe(name="renamed"),
                    uds.ugrid.to_geodataframe(dim=g.face_dimension), uds.ugrid.to_geodataframe(dim=g.node_dimension)]
    for want, got in zip(out[xu], out[xt]):
        pd.testing.assert_frame_equal(got._df, want._df, check_exact=True)
        assert_same_geometry(shp, want.geometry, got.geometry)
        assert got.crs == want.crs
    # Both facets: pandas' concat of the two frames, as the JAX package.
    faces = {pkg: pkg.UgridDataset(pkg.xdata.Dataset({"z": ((mesh[pkg][0].node_dimension,), node)}), [mesh[pkg][0]])
             for pkg in PACKAGES}
    pd.testing.assert_frame_equal(faces[xt].ugrid.to_geodataframe()._df, faces[xu].ugrid.to_geodataframe()._df)
    empty = {pkg: pkg.UgridDataset(grids=[mesh[pkg][0]]) for pkg in PACKAGES}
    raises_alike(lambda: empty[xu].ugrid.to_geodataframe(), lambda: empty[xt].ugrid.to_geodataframe(), ValueError)


def test_ugrid_dataset_from_geodataframe_round_trip(geo, mesh):
    _, gpd = geo
    grid = mesh[xt][0]
    rng = np.random.default_rng(14)
    gdf = gpd.GeoDataFrame({"a": rng.normal(size=grid.n_face), "b": np.arange(grid.n_face)},
                           geometry=grid.to_shapely(grid.face_dimension))
    want = xu.UgridDataset.from_geodataframe(gdf)
    got = xt.UgridDataset.from_geodataframe(gdf)
    assert_same_grid(want.grid, got.grid)
    for var in ("a", "b"):
        np.testing.assert_array_equal(got[var].values, np.asarray(want[var].values))
    back = got.ugrid.to_geodataframe()
    np.testing.assert_array_equal(back["a"].to_numpy(), gdf["a"].to_numpy())
    node_xy = grid.node_coordinates[grid.face_node_connectivity]
    again = xt.Ugrid2d.from_geodataframe(back)
    np.testing.assert_array_equal(again.node_coordinates[again.face_node_connectivity], node_xy)


def rowwise_linestrings(flat):
    """shapely's ``linestrings`` of an (n, m, 2) array: one linestring
    per row (the stand-in's takes flat coordinates only)."""

    def linestrings(xy, y=None, indices=None):
        xy = np.asarray(xy)
        if y is None and indices is None and xy.ndim == 3:
            return flat(xy.reshape(-1, 2), indices=np.repeat(np.arange(len(xy)), xy.shape[1]))
        return flat(xy, y, indices)

    return linestrings


@pytest.mark.parametrize("rowwise", [False, True])
def test_bounding_polygon_equals_jax(geo, mesh, monkeypatch, rowwise):
    shp, _ = geo
    if rowwise:
        monkeypatch.setattr(shp, "linestrings", rowwise_linestrings(shp.linestrings))
    want = mesh[xu][0].bounding_polygon()
    got = mesh[xt][0].bounding_polygon()
    np.testing.assert_array_equal(got.exterior.coords, want.exterior.coords)
    if not rowwise:
        return
    ring = got.exterior.coords
    area = 0.5 * abs(np.sum(ring[:-1, 0] * ring[1:, 1] - ring[1:, 0] * ring[:-1, 1]))
    np.testing.assert_allclose(area, mesh[xt][0].area.sum(), rtol=1e-12)


def test_to_crs_raises_as_jax(mesh):
    grids = {pkg: mesh[pkg][0] for pkg in PACKAGES}
    raises_alike(lambda: grids[xu].to_crs(epsg=28992), lambda: grids[xt].to_crs(epsg=28992))
    uda = {pkg: pkg.UgridDataArray(pkg.xdata.DataArray(np.zeros(grids[pkg].n_face), dims=(grids[pkg].face_dimension,)),
                                   grids[pkg]) for pkg in PACKAGES}
    raises_alike(lambda: uda[xu].ugrid.to_crs(epsg=28992), lambda: uda[xt].ugrid.to_crs(epsg=28992))
    uds = {pkg: pkg.UgridDataset(grids=[grids[pkg]]) for pkg in PACKAGES}
    raises_alike(lambda: uds[xu].ugrid.to_crs(epsg=28992), lambda: uds[xt].ugrid.to_crs(epsg=28992))


# -- the slice ---------------------------------------------------------------
def test_burn_regrid_polygonize_equals_jax(geo, mesh):
    """Burn provinces, gauges and channels; regrid the burned ids by mode
    and a burned depth by mean onto the raster (the port on the CPU);
    polygonize the ids."""
    shp, gpd = geo
    gdf = polygons(shp, gpd, np.random.default_rng(5))
    out = {}
    for pkg in PACKAGES:
        grid, raster = mesh[pkg]
        ids = pkg.burn_vector_geometry(gdf, grid, column="id")
        depth = pkg.burn_vector_geometry(gdf, grid, column="value", fill=0.0)
        kwargs = {"device": "cpu"} if pkg is xt else {}
        mode = pkg.OverlapRegridder(ids, raster, method="mode").regrid(ids, **kwargs)
        mean = pkg.OverlapRegridder(depth, raster, method="mean").regrid(depth, **kwargs)
        out[pkg] = (ids, mode, mean, pkg.polygonize(ids))
    (wids, wmode, wmean, wpoly), (gids, gmode, gmean, gpoly) = out[xu], out[xt]
    np.testing.assert_array_equal(gids.values, np.asarray(wids.values))
    assert isinstance(gmode, xt.UgridDataArray) and isinstance(gmode.obj.data, torch.Tensor)
    np.testing.assert_array_equal(gmode.values, np.asarray(wmode.values))
    assert np.isfinite(gmode.values).sum() > 5
    np.testing.assert_allclose(gmean.values, np.asarray(wmean.values), rtol=1e-6)
    np.testing.assert_array_equal(gpoly["values"].to_numpy(), region_values(gids.grid, gids.values))
    for g, w in zip(shp_list(gpoly.geometry), shp_list(wpoly.geometry)):
        np.testing.assert_array_equal(g.exterior.coords, w.exterior.coords)
