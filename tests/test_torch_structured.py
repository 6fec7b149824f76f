"""
The port's structured (raster) grids held on the CPU against the JAX
package's: ``regrid/structured.py``'s 1D and 2D grids on the cases of
``tests/test_regrid_structured.py`` (equidistant, descending, ``dx`` and
``bounds`` coordinates), ``overlap_1d``, ``utils.broadcast``,
``conversion.py`` and the structured constructors of ``Ugrid2d``.  The
same seeded inputs through both: every array and every
``(source, target, weight)`` triplet is equal bit for bit (the same numpy
arithmetic).
"""

import numpy as np
import pytest

import xugrid_tpu as xu
import xugrid_tpu_torch as xt
from xugrid_tpu import conversion as jconversion
from xugrid_tpu.regrid import overlap_1d as joverlap
from xugrid_tpu.regrid import structured as jstructured
from xugrid_tpu.regrid import utils as jutils
from xugrid_tpu_torch import conversion as tconversion
from xugrid_tpu_torch.regrid import overlap_1d as toverlap
from xugrid_tpu_torch.regrid import structured as tstructured
from xugrid_tpu_torch.regrid import utils as tutils

PACKAGES = {"jax": (xu, jstructured), "torch": (xt, tstructured)}


def make_obj(pkg, coords_dict, sizes):
    """A Dataset with a dummy variable over the given dims and the given
    coordinates (as tests/test_regrid_structured.py builds them)."""
    ds = pkg.xdata.Dataset()
    ds["dummy"] = pkg.xdata.DataArray(np.zeros(tuple(sizes.values())), dims=tuple(sizes))
    coord_das = {}
    for name, value in coords_dict.items():
        value = np.asarray(value)
        if value.ndim == 0:
            coord_das[name] = pkg.xdata.DataArray(value)
        elif value.ndim == 1:
            dim = name if name in sizes else name[1:]  # dx -> x
            coord_das[name] = pkg.xdata.DataArray(value, dims=(dim,))
        else:  # bounds (n, 2)
            coord_das[name] = pkg.xdata.DataArray(value, dims=(name.replace("bounds", ""), "nbounds"))
    return ds.assign_coords(**coord_das)


def both(cls, coords, sizes, *names):
    """The grid ``cls`` over the same coordinates in both packages."""
    return [getattr(mod, cls)(make_obj(pkg, coords, sizes), *names) for pkg, mod in PACKAGES.values()]


def assert_equal_triplets(a, b):
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)
        assert np.asarray(y).dtype == np.asarray(x).dtype


AXES = {
    "equidistant": ({"x": [0.5, 1.5, 2.5]}, {"x": 3}),
    "descending": ({"x": [2.5, 1.5, 0.5]}, {"x": 3}),
    "dx": ({"x": [0.5, 2.0, 4.0], "dx": [1.0, 2.0, 2.0]}, {"x": 3}),
    "descending dx": ({"x": [4.0, 2.0, 0.5], "dx": [-2.0, -2.0, -1.0]}, {"x": 3}),
    "scalar dx": ({"x": [1.0, 2.0, 3.0, 4.0], "dx": np.array(1.0)}, {"x": 4}),
    "bounds": ({"x": [0.5, 2.0], "xbounds": np.array([[0.0, 1.0], [1.0, 3.0]])}, {"x": 2}),
    "descending bounds": ({"x": [2.0, 0.5], "xbounds": np.array([[3.0, 1.0], [1.0, 0.0]])}, {"x": 2}),
}
TARGETS = {
    "inside": ({"x": [1.0, 2.0]}, {"x": 2}),
    "descending": ({"x": [2.2, 1.25, 0.3]}, {"x": 3}),
    "partly outside": ({"x": [-0.5, 1.25, 3.5], "dx": np.array(1.0)}, {"x": 3}),
}


@pytest.mark.parametrize("axis", list(AXES))
def test_grid1d_properties(axis):
    j, t = both("StructuredGrid1d", *AXES[axis], "x")
    for attr in ("midpoints", "bounds", "flipped", "dvalue", "index", "length", "directional_bounds", "size"):
        np.testing.assert_array_equal(getattr(t, attr), getattr(j, attr))
    assert t.dims == j.dims and t.ndim == j.ndim and t.dname == j.dname
    for key, value in j.coords.items():
        got = t.coords[key]
        if isinstance(value, tuple):
            assert got[0] == value[0]
            np.testing.assert_array_equal(got[1], value[1])
        else:
            np.testing.assert_array_equal(got, value)
    np.testing.assert_array_equal(t.flip_if_needed(np.arange(t.size)), j.flip_if_needed(np.arange(j.size)))


@pytest.mark.parametrize("target", list(TARGETS))
@pytest.mark.parametrize("axis", list(AXES))
@pytest.mark.parametrize("join", ["overlap", "relative", "locate_centroids", "linear_weights"])
def test_grid1d_joins(axis, target, join):
    (js, ts), (jt, tt) = both("StructuredGrid1d", *AXES[axis], "x"), both("StructuredGrid1d", *TARGETS[target], "x")
    if join in ("overlap", "relative"):
        want, got = js.overlap(jt, relative=join == "relative"), ts.overlap(tt, relative=join == "relative")
    else:
        want, got = getattr(js, join)(jt), getattr(ts, join)(tt)
    assert_equal_triplets(want, got)


def test_grid1d_errors():
    for coords, sizes, match in (
        ({"x": [0.5, 1.5, 4.0]}, {"x": 3}, "equidistant"),
        ({"x": [0.5, 2.0, 1.0]}, {"x": 3}, "not monotonic"),
        ({"x": [0.5]}, {"x": 1}, "single"),
    ):
        with pytest.raises(ValueError, match=match):
            tstructured.StructuredGrid1d(make_obj(xt, coords, sizes), "x")
    with pytest.raises(ValueError, match="not present"):
        tstructured.StructuredGrid1d(make_obj(xt, {"x": [0.5, 1.5]}, {"x": 2}), "y")
    one = tstructured.StructuredGrid1d(make_obj(xt, {"x": [0.5], "dx": np.array(1.0)}, {"x": 1}), "x")
    other = tstructured.StructuredGrid1d(make_obj(xt, {"x": [0.5, 1.5]}, {"x": 2}), "x")
    with pytest.raises(ValueError, match="At least two points"):
        one.linear_weights(other)


RASTERS = {
    "ascending": {"x": [0.5, 1.5, 2.5], "y": [0.5, 1.5]},
    "descending y": {"x": [0.5, 1.5, 2.5], "y": [1.5, 0.5]},
    "descending both, dx": {"x": [2.5, 1.5, 0.5], "dx": np.array(-1.0), "y": [1.6, 0.4], "dy": [-1.2, -1.2]},
}
TARGET_RASTERS = {
    "one cell": {"x": np.array([1.0]), "dx": np.array(2.0), "y": np.array([1.0]), "dy": np.array(2.0)},
    "fine, descending y": {"x": [0.6, 1.2, 1.8, 2.4], "y": [1.5, 1.0, 0.5]},
}


def raster_pair(coords):
    sizes = {"y": len(coords["y"]), "x": len(coords["x"])}
    return both("StructuredGrid2d", coords, sizes, "x", "y")


@pytest.mark.parametrize("target", list(TARGET_RASTERS))
@pytest.mark.parametrize("source", list(RASTERS))
@pytest.mark.parametrize("join", ["overlap", "relative", "locate_centroids", "linear_weights"])
def test_grid2d_joins(source, target, join):
    (js, ts), (jt, tt) = raster_pair(RASTERS[source]), raster_pair(TARGET_RASTERS[target])
    assert (ts.shape, ts.size, ts.dims, ts.ndim) == (js.shape, js.size, js.dims, js.ndim)
    np.testing.assert_array_equal(ts.area, js.area)
    if join in ("overlap", "relative"):
        want, got = js.overlap(jt, relative=join == "relative"), ts.overlap(tt, relative=join == "relative")
    else:
        want, got = getattr(js, join)(jt), getattr(ts, join)(tt)
    assert_equal_triplets(want, got)


@pytest.mark.parametrize("source", list(RASTERS))
def test_grid2d_convert_to_ugrid2d(source):
    """A raster as an unstructured grid: the Ugrid2d of its directional
    bounds, faces y-major in the coordinates' own order."""
    from xugrid_tpu.regrid.unstructured import UnstructuredGrid2d as JU
    from xugrid_tpu_torch.regrid.unstructured import UnstructuredGrid2d as TU

    js, ts = raster_pair(RASTERS[source])
    assert ts.convert_to(tstructured.StructuredGrid2d) is ts
    jg, tg = js.convert_to(JU).ugrid_topology, ts.convert_to(TU).ugrid_topology
    for attr in ("node_x", "node_y", "face_node_connectivity", "area", "centroids"):
        np.testing.assert_array_equal(getattr(tg, attr), getattr(jg, attr))
    # Face k is raster cell (k // nx, k % nx): its centroid is that cell's.
    yy, xx = np.meshgrid(np.asarray(RASTERS[source]["y"], float), np.asarray(RASTERS[source]["x"], float), indexing="ij")
    np.testing.assert_allclose(tg.centroids, np.column_stack([xx.ravel(), yy.ravel()]), rtol=0, atol=1e-12)
    assert tg.area.min() > 0  # counter-clockwise faces


def test_overlap_1d_and_broadcast():
    rng = np.random.default_rng(6)
    source = np.column_stack([np.arange(0.0, 10.0), np.arange(1.0, 11.0)])
    source[3] = np.nan
    target = np.sort(rng.uniform(-1.0, 11.0, (7, 2)), axis=1)
    target = target[np.argsort(target[:, 0])]
    assert_equal_triplets(joverlap.overlap_1d(source, target), toverlap.overlap_1d(source, target))
    stacks = rng.uniform(0.0, 1.0, (3, 5, 2)).cumsum(axis=1)
    stacks.sort(axis=2)
    pairs = (np.array([0, 2, 1]), np.array([1, 0, 2]))
    for a, b in zip(joverlap.overlap_1d_nd(stacks, stacks, *pairs), toverlap.overlap_1d_nd(stacks, stacks, *pairs)):
        np.testing.assert_array_equal(b, a)
    args = ((3, 4), (2, 5), (np.array([0, 2]), np.array([1, 3])), (np.array([1, 0]), np.array([4, 2])),
            (np.array([0.5, 2.0]), np.array([0.25, 4.0])))
    for a, b in zip(jutils.broadcast(*args), tutils.broadcast(*args)):
        np.testing.assert_array_equal(b, a)
    counts = np.array([3, 0, 2, 5])
    np.testing.assert_array_equal(tutils.alt_cumsum(counts), jutils.alt_cumsum(counts))


CONVERSION_COORDS = {
    "ascending": ({"x": [0.5, 1.5, 2.5]}, {"x": 3}),
    "descending": ({"x": [2.5, 1.5, 0.5]}, {"x": 3}),
    "dx array": ({"x": [0.5, 2.0, 4.0], "dx": [1.0, 2.0, 2.0]}, {"x": 3}),
    "scalar dx": ({"x": [4.0, 3.0, 2.0], "dx": np.array(-1.0)}, {"x": 3}),
    "one value": ({"x": [4.0], "dx": np.array(2.0)}, {"x": 1}),
}


@pytest.mark.parametrize("case", list(CONVERSION_COORDS))
def test_conversion_matches_jax(case):
    coords, sizes = CONVERSION_COORDS[case]
    want = jconversion.infer_interval_breaks1d(make_obj(xu, coords, sizes), "x")
    got = tconversion.infer_interval_breaks1d(make_obj(xt, coords, sizes), "x")
    np.testing.assert_array_equal(got, want)
    bounds = np.column_stack([want[:-1], want[1:]])
    np.testing.assert_array_equal(tconversion.bounds1d_to_vertices(bounds), jconversion.bounds1d_to_vertices(bounds))
    values = np.asarray(coords["x"], float)
    np.testing.assert_array_equal(tconversion.infer_interval_breaks(values), jconversion.infer_interval_breaks(values))


def test_conversion_errors_and_xy_inference():
    with pytest.raises(ValueError, match="1-sized"):
        tconversion.infer_interval_breaks1d(make_obj(xt, {"x": [4.0]}, {"x": 1}), "x")
    with pytest.raises(ValueError, match="does not match"):
        tconversion.infer_interval_breaks1d(make_obj(xt, {"x": [0.0, 1.0], "dx": np.array(3.0)}, {"x": 2}), "x")
    with pytest.raises(ValueError, match="not monotonic"):
        tconversion.bounds1d_to_vertices(np.array([[0.0, 1.0], [2.0, 3.0], [1.0, 2.0]]))
    for pkg, conv in ((xu, jconversion), (xt, tconversion)):
        da = pkg.xdata.DataArray(np.zeros((2, 3)), coords={"b": [1.0, 2.0], "a": [0.0, 1.0, 2.0]}, dims=("b", "a"))
        da._coords["b"].attrs["standard_name"] = "latitude"
        da._coords["a"].attrs["axis"] = "X"
        assert conv.infer_xy_coords(da) == ("a", "b")
    with pytest.raises(ValueError, match="no matching"):
        tconversion.infer_xy_coords(xt.xdata.DataArray(np.zeros((2, 2)), dims=("y", "x")))


@pytest.mark.parametrize("y_order", ["ascending", "descending"])
@pytest.mark.parametrize("x_order", ["ascending", "descending"])
def test_ugrid2d_from_structured_matches_jax(x_order, y_order):
    x = np.array([0.5, 1.5, 2.5, 3.5])
    y = np.array([1.0, 3.0, 5.0])
    x, y = (x if x_order == "ascending" else x[::-1]), (y if y_order == "ascending" else y[::-1])
    xb = np.column_stack([x - 0.5, x + 0.5])
    yb = np.column_stack([y - 1.0, y + 1.0])
    if x_order == "descending":
        xb = xb[:, ::-1]
    if y_order == "descending":
        yb = yb[:, ::-1]
    grids = {}
    for pkg in (xu, xt):
        da = pkg.xdata.DataArray(np.zeros((3, 4)), coords={"y": y, "x": x}, dims=("y", "x"))
        grids[pkg.__name__] = (
            pkg.Ugrid2d.from_structured(da),
            pkg.Ugrid2d.from_structured(da, "x", "y", return_dims=True)[1],
            pkg.Ugrid2d.from_structured_bounds(xb, yb, name="raster"),
        )
    (j1, jdims, j2), (t1, tdims, t2) = grids["xugrid_tpu"], grids["xugrid_tpu_torch"]
    assert tdims == jdims == ("y", "x")
    for jg, tg in ((j1, t1), (j2, t2)):
        assert tg.name == jg.name and tg.face_dimension == jg.face_dimension
        for attr in ("node_x", "node_y", "face_node_connectivity", "area", "centroids"):
            np.testing.assert_array_equal(getattr(tg, attr), getattr(jg, attr))
    assert (t2.area > 0).all()


def test_ugrid_dimensions_and_lookup():
    verts, faces = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]), np.array([[0, 1, 2, 3]])
    for pkg in (xu, xt):
        grid = pkg.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
        network = pkg.Ugrid1d(verts[:, 0], verts[:, 1], -1, np.array([[0, 1], [1, 2]]))
        assert grid.core_dimension == "mesh2d_nFaces" and network.core_dimension == "network1d_nEdges"
        assert grid.dims == {"mesh2d_nNodes", "mesh2d_nEdges", "mesh2d_nFaces"}
        assert network.dims == {"network1d_nNodes", "network1d_nEdges"}
        assert tuple(float(b) for b in grid.bounds) == (0.0, 0.0, 1.0, 1.0)
        da = pkg.xdata.DataArray(np.zeros((2, 4)), dims=("time", grid.node_dimension))
        assert grid.find_ugrid_dim(da) == grid.node_dimension
        with pytest.raises(ValueError, match="exactly one"):
            grid.find_ugrid_dim(pkg.xdata.DataArray(np.zeros(2), dims=("time",)))
        uda = pkg.UgridDataArray.from_data(np.arange(4.0), grid, "node")
        assert uda.dims == (grid.node_dimension,) and uda.grid is grid
        with pytest.raises(ValueError, match="Conflicting sizes"):
            pkg.UgridDataArray.from_data(np.arange(3.0), grid, "node")
