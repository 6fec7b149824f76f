"""
The port's curvilinear and 3-D structured grids held on the CPU against
the JAX package's, on the same seeded numpy inputs:

- ``conversion.bounds2d_to_topology2d`` and the ``Ugrid2d`` structured
  constructors (``from_structured_bounds`` with (N, M, 4) corner bounds,
  ``from_structured_intervals2d``, ``from_structured`` and the deprecated
  ``from_structured_multicoord`` on rotated and curvilinear coordinates):
  topology bit-equal, the same warnings;
- ``UgridDataArray``/``UgridDataset.from_structured2d`` with corner
  bounds, and a curvilinear grid regridded onto a small mesh (rtol 1e-6);
- ``StructuredGrid3d`` and ``ExplicitStructuredGrid3d`` triplets bit-equal
  (the cases of ``tests/test_regrid_structured.py`` and seeded voxel and
  layered models), ``overlap_1d.overlap_1d_nd`` bit-equal to the JAX
  package's pair-by-pair loop;
- a 3-D overlap through ``PaddedCSR.from_coo`` and the port's
  ``apply_weights`` against ``xugrid_tpu.regrid.apply.apply_weights``
  (oracle a), float32 at rtol 1e-6;
- ``core/sparse.py``'s ``nzrange``, ``row_slice``, ``columns_and_values``.
"""

import warnings

import numpy as np
import pytest
import torch

import xugrid_tpu as xu
import xugrid_tpu_torch as xt
from xugrid_tpu import conversion as jconversion
from xugrid_tpu.core import sparse as jsparse
from xugrid_tpu.regrid import apply as japply
from xugrid_tpu.regrid import overlap_1d as joverlap
from xugrid_tpu.regrid import reduce as jreduce
from xugrid_tpu.regrid import structured as jstructured
from xugrid_tpu_torch import conversion as tconversion
from xugrid_tpu_torch.core import sparse as tsparse
from xugrid_tpu_torch.regrid import apply as tapply
from xugrid_tpu_torch.regrid import overlap_1d as toverlap
from xugrid_tpu_torch.regrid import reduce as treduce
from xugrid_tpu_torch.regrid import structured as tstructured

PACKAGES = {"jax": xu, "torch": xt}
MODULES = {"jax": jstructured, "torch": tstructured}


def curvilinear_nodes(ny, nx, seed, angle=0.5, warp=0.15):
    """(ny + 1, nx + 1) node coordinates of a rotated grid whose lines are
    sinusoidally warped, with a little seeded jitter."""
    rng = np.random.default_rng(seed)
    j, i = np.meshgrid(np.arange(ny + 1.0), np.arange(nx + 1.0), indexing="ij")
    u = i + warp * np.sin(j * 0.7) + rng.uniform(-0.05, 0.05, i.shape)
    v = j + warp * np.sin(i * 0.5) + rng.uniform(-0.05, 0.05, j.shape)
    c, s = np.cos(angle), np.sin(angle)
    return c * u - s * v, s * u + c * v


def corner_bounds(nodes_x, nodes_y, land=None, degenerate=(), triangles=()):
    """(N, M, 4) corner bounds of the cells of a node grid; ``land`` cells
    NaN, ``degenerate`` cells collapsed to a point, ``triangles`` cells
    with two corners merged."""
    def corners(a):
        return np.stack([a[:-1, :-1], a[:-1, 1:], a[1:, 1:], a[1:, :-1]], axis=-1)

    xb, yb = corners(nodes_x), corners(nodes_y)
    if land is not None:
        xb[land], yb[land] = np.nan, np.nan
    for cell in degenerate:
        xb[cell] = xb[cell][0]
        yb[cell] = yb[cell][0]
    for cell in triangles:
        xb[cell + (3,)] = xb[cell + (0,)]
        yb[cell + (3,)] = yb[cell + (0,)]
    return xb, yb


def ocean_bounds(ny=9, nx=12, seed=0):
    nodes_x, nodes_y = curvilinear_nodes(ny, nx, seed)
    land = np.random.default_rng(seed + 1).random((ny, nx)) < 0.1
    degenerate, triangles = [(2, 3)], [(4, 5), (0, 0)]
    for cell in degenerate + triangles:
        land[cell] = False
    return corner_bounds(nodes_x, nodes_y, land, degenerate, triangles)


def assert_grid_equal(tg, jg):
    assert tg.name == jg.name and tg.face_dimension == jg.face_dimension
    for attr in ("node_x", "node_y", "face_node_connectivity"):
        got, want = getattr(tg, attr), getattr(jg, attr)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def recorded(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, [(w.category, str(w.message)) for w in caught]


# -- curvilinear bounds and constructors ------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bounds2d_to_topology2d_matches_jax(seed):
    xb, yb = ocean_bounds(seed=seed)
    got, got_warnings = recorded(lambda: tconversion.bounds2d_to_topology2d(xb, yb))
    want, want_warnings = recorded(lambda: jconversion.bounds2d_to_topology2d(xb, yb))
    assert got_warnings == want_warnings and len(got_warnings) == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (got[2][:, -1] == -1).sum() == 2  # the two triangles


def test_bounds2d_without_degenerate_cells_does_not_warn():
    nodes_x, nodes_y = curvilinear_nodes(4, 5, seed=3)
    xb, yb = corner_bounds(nodes_x, nodes_y)
    _, caught = recorded(lambda: tconversion.bounds2d_to_topology2d(xb, yb))
    assert caught == []


@pytest.mark.parametrize("shape", ["2d", "3d"])
def test_from_structured_bounds_return_index(shape):
    if shape == "3d":
        xb, yb = ocean_bounds(seed=4)
    else:
        xb = np.column_stack([np.arange(4.0), np.arange(4.0) + 1.0])
        yb = np.column_stack([np.arange(3.0, 0.0, -1.0), np.arange(2.0, -1.0, -1.0)])
    out = {}
    for key, pkg in PACKAGES.items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            out[key] = pkg.Ugrid2d.from_structured_bounds(xb, yb, name="ocean", return_index=True)
    (jg, jindex), (tg, tindex) = out["jax"], out["torch"]
    assert_grid_equal(tg, jg)
    if shape == "2d":
        assert tindex == jindex == slice(None, None)
    else:
        np.testing.assert_array_equal(tindex, jindex)


def test_from_structured_bounds_errors():
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError, match="Bounds shapes do not match"):
            pkg.Ugrid2d.from_structured_bounds(np.zeros((2, 3, 4)), np.zeros((3, 2, 4)))
        with pytest.raises(ValueError, match="Expected 2 or 3 dimensions"):
            pkg.Ugrid2d.from_structured_bounds(np.zeros(4), np.zeros(4))


def test_from_structured_intervals2d_matches_jax():
    nodes_x, nodes_y = curvilinear_nodes(5, 7, seed=5)
    grids = [pkg.Ugrid2d.from_structured_intervals2d(nodes_x, nodes_y, name="c") for pkg in PACKAGES.values()]
    assert_grid_equal(grids[1], grids[0])
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError, match="must be 2D"):
            pkg.Ugrid2d.from_structured_intervals2d(nodes_x[0], nodes_y[0])
        with pytest.raises(ValueError, match="Interval shapes must match"):
            pkg.Ugrid2d.from_structured_intervals2d(nodes_x, nodes_y[:-1])


def multicoord_data(pkg, seed=6, ny=6, nx=8):
    """A (time, eta, xi) DataArray on a rotated, warped grid given by its
    2D cell-centre coordinates."""
    nodes_x, nodes_y = curvilinear_nodes(ny, nx, seed, warp=0.0)
    cx = 0.25 * (nodes_x[:-1, :-1] + nodes_x[:-1, 1:] + nodes_x[1:, 1:] + nodes_x[1:, :-1])
    cy = 0.25 * (nodes_y[:-1, :-1] + nodes_y[:-1, 1:] + nodes_y[1:, 1:] + nodes_y[1:, :-1])
    values = np.random.default_rng(seed).normal(size=(2, ny, nx))
    return pkg.xdata.DataArray(
        values, dims=("time", "eta", "xi"),
        coords={"lon": (("eta", "xi"), cx), "lat": (("eta", "xi"), cy)},
    )


def test_from_structured_multicoord_matches_jax():
    out = {}
    for key, pkg in PACKAGES.items():
        da = multicoord_data(pkg)
        grid, dims = pkg.Ugrid2d.from_structured(da, "lon", "lat", return_dims=True)
        deprecated, caught = recorded(lambda: pkg.Ugrid2d.from_structured_multicoord(da, "lon", "lat"))
        out[key] = (grid, dims, deprecated, caught)
    (jg, jdims, jdep, jcaught), (tg, tdims, tdep, tcaught) = out["jax"], out["torch"]
    assert tdims == jdims == ("eta", "xi")
    assert_grid_equal(tg, jg)
    assert_grid_equal(tdep, jdep)
    assert tcaught == jcaught and tcaught[0][0] is FutureWarning


def test_from_structured_rejects_3d_coordinates():
    for pkg in PACKAGES.values():
        da = pkg.xdata.DataArray(
            np.zeros((2, 2, 2)), dims=("a", "b", "c"),
            coords={"x": (("a", "b", "c"), np.zeros((2, 2, 2))), "y": (("a", "b", "c"), np.zeros((2, 2, 2)))},
        )
        with pytest.raises(ValueError, match="1D or 2D"):
            pkg.Ugrid2d.from_structured(da, "x", "y")


@pytest.mark.parametrize("payload", ["numpy", "tensor"])
def test_uda_from_structured2d_bounds_matches_jax(payload):
    xb, yb = ocean_bounds(seed=7)
    values = np.random.default_rng(7).normal(size=(3,) + xb.shape[:2]).astype(np.float32)
    out = {}
    for key, pkg in PACKAGES.items():
        data = torch.from_numpy(values) if key == "torch" and payload == "tensor" else values
        da = pkg.xdata.DataArray(data, dims=("time", "eta", "xi"))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            out[key] = pkg.UgridDataArray.from_structured2d(da, x="xi", y="eta", x_bounds=xb, y_bounds=yb)
    juda, tuda = out["jax"], out["torch"]
    assert_grid_equal(tuda.grid, juda.grid)
    assert tuda.dims == juda.dims
    if payload == "tensor":
        assert isinstance(tuda.obj.data, torch.Tensor)
    np.testing.assert_array_equal(np.asarray(tuda.values), np.asarray(juda.values))
    with pytest.raises(ValueError, match="x and y must be provided"):
        xt.UgridDataArray.from_structured2d(xt.xdata.DataArray(values, dims=("time", "eta", "xi")), x_bounds=xb, y_bounds=yb)


@pytest.mark.parametrize("by_name", [True, False])
def test_uds_from_structured2d_bounds_matches_jax(by_name):
    xb, yb = ocean_bounds(seed=8)
    rng = np.random.default_rng(8)
    temp = rng.normal(size=(2,) + xb.shape[:2])
    depth = rng.normal(size=xb.shape[:2])
    out = {}
    for key, pkg in PACKAGES.items():
        ds = pkg.xdata.Dataset()
        ds["temp"] = pkg.xdata.DataArray(temp, dims=("time", "eta", "xi"))
        ds["depth"] = pkg.xdata.DataArray(depth, dims=("eta", "xi"))
        ds["time_scale"] = pkg.xdata.DataArray(np.arange(2.0), dims=("time",))
        if by_name:
            ds["xb"] = pkg.xdata.DataArray(xb, dims=("eta", "xi", "corner"))
            ds["yb"] = pkg.xdata.DataArray(yb, dims=("eta", "xi", "corner"))
            options = {"x": "xi", "y": "eta", "bounds_x": "xb", "bounds_y": "yb"}
        else:
            options = {"x": "xi", "y": "eta", "bounds_x": pkg.xdata.DataArray(xb), "bounds_y": pkg.xdata.DataArray(yb)}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            out[key] = pkg.UgridDataset.from_structured2d(ds, topology={"ocean": options})
    juds, tuds = out["jax"], out["torch"]
    assert_grid_equal(tuds.grids[0], juds.grids[0])
    assert sorted(tuds.data_vars) == sorted(juds.data_vars)
    for name in juds.data_vars:
        np.testing.assert_array_equal(np.asarray(tuds[name].values), np.asarray(juds[name].values))


def test_curvilinear_regrid_onto_mesh_matches_jax():
    """A curvilinear ocean grid (10 % land) regridded onto a small quad
    mesh by overlap mean and mode, float32, against the JAX package."""
    xb, yb = ocean_bounds(ny=12, nx=14, seed=9)
    values = np.random.default_rng(9).normal(size=(3,) + xb.shape[:2]).astype(np.float32)
    values = np.round(values * 2.0) / 2.0
    tx, ty = np.meshgrid(np.linspace(-4.0, 12.0, 9), np.linspace(0.0, 16.0, 9))
    nid = np.arange(81).reshape(9, 9)
    faces = np.stack([nid[:-1, :-1], nid[:-1, 1:], nid[1:, 1:], nid[1:, :-1]], -1).reshape(-1, 4)
    out = {}
    for key, pkg in PACKAGES.items():
        da = pkg.xdata.DataArray(values, dims=("time", "eta", "xi"))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            uda = pkg.UgridDataArray.from_structured2d(da, x="xi", y="eta", x_bounds=xb, y_bounds=yb)
        target = pkg.Ugrid2d(tx.ravel(), ty.ravel(), -1, faces)
        kwargs = {"device": "cpu"} if key == "torch" else {}
        out[key] = [
            np.asarray(pkg.OverlapRegridder(uda, target, method=method).regrid(uda, **kwargs).values)
            for method in ("mean", "mode")
        ]
    for got, want in zip(out["torch"], out["jax"]):
        assert np.isfinite(want).mean() > 0.5
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- 3-D grids -----------------------------------------------------------------
def voxel_obj(pkg, x, y, z, **spacing):
    ds = pkg.xdata.Dataset()
    ds["dummy"] = pkg.xdata.DataArray(np.zeros((len(z), len(y), len(x))), dims=("z", "y", "x"))
    coords = {name: pkg.xdata.DataArray(np.asarray(v), dims=(name,)) for name, v in (("x", x), ("y", y), ("z", z))}
    for name, value in spacing.items():
        value = np.asarray(value)
        coords[name] = pkg.xdata.DataArray(value, dims=() if value.ndim == 0 else (name[1:],))
    return ds.assign_coords(**coords)


VOXELS = {
    "aligned": (
        dict(x=np.arange(6) + 0.5, y=np.arange(5) + 0.5, z=np.arange(4) + 0.5),
        dict(x=np.arange(3) * 2.0 + 1.0, y=np.arange(2) * 2.0 + 1.5, z=np.arange(2) * 2.0 + 1.0),
    ),
    "offset": (
        dict(x=np.arange(6) + 0.5, y=np.arange(5) + 0.5, z=np.arange(8) * 0.5 + 0.25),
        dict(x=np.arange(3) * 2.0 + 1.3, y=np.arange(3) * 1.7 + 0.9, z=np.arange(3) * 1.3 + 0.7),
    ),
    "descending": (
        dict(x=np.arange(6) + 0.5, y=(np.arange(5) + 0.5)[::-1], z=(np.arange(4) * 2.0 + 1.0)[::-1]),
        dict(x=np.arange(4) * 1.5 + 0.75, y=np.arange(3) * 1.5 + 0.75, z=np.arange(5) * 1.5 + 0.75),
    ),
}


@pytest.mark.parametrize("config", sorted(VOXELS))
@pytest.mark.parametrize("join", ["overlap", "overlap_relative", "locate_centroids", "linear_weights"])
def test_voxel_triplets_match_jax(config, join):
    src, tgt = VOXELS[config]
    out = {}
    for key, pkg in PACKAGES.items():
        source = MODULES[key].StructuredGrid3d(voxel_obj(pkg, **src), "x", "y", "z")
        target = MODULES[key].StructuredGrid3d(voxel_obj(pkg, **tgt), "x", "y", "z")
        assert source.shape == (len(src["z"]), len(src["y"]), len(src["x"])) and source.ndim == 3
        if join.startswith("overlap"):
            out[key] = source.overlap(target, relative=join == "overlap_relative")
        else:
            out[key] = getattr(source, join)(target)
        out[key + "_volume"] = source.volume
        out[key + "_dims"] = source.dims
    assert out["torch_dims"] == out["jax_dims"]
    np.testing.assert_array_equal(out["torch_volume"], out["jax_volume"])
    assert len(out["torch"][0]) > 0
    for got, want in zip(out["torch"], out["jax"]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_voxel_overlap_volume():
    """tests/test_regrid_structured.py's case: four unit voxels in one
    2 x 2 x 1 voxel, in both packages."""
    for key, pkg in PACKAGES.items():
        source = MODULES[key].StructuredGrid3d(
            voxel_obj(pkg, [0.5, 1.5], [0.5, 1.5], [0.5], dz=np.array(1.0)), "x", "y", "z"
        )
        target = MODULES[key].StructuredGrid3d(
            voxel_obj(pkg, [1.0], [1.0], [0.5], dx=np.array(2.0), dy=np.array(2.0), dz=np.array(1.0)), "x", "y", "z"
        )
        assert source.size == 4
        s, t, w = source.overlap(target, relative=False)
        assert len(s) == 4
        np.testing.assert_allclose(w, 1.0)


def layered_obj(pkg, zb, x=(0.5, 1.5), y=(0.5,)):
    ds = pkg.xdata.Dataset()
    ds["dummy"] = pkg.xdata.DataArray(np.zeros((zb.shape[0], len(y), len(x))), dims=("z", "y", "x"))
    return ds.assign_coords(
        x=pkg.xdata.DataArray(np.asarray(x, float), dims=("x",)),
        y=pkg.xdata.DataArray(np.asarray(y, float), dims=("y",)),
        dx=pkg.xdata.DataArray(np.array(1.0)),
        dy=pkg.xdata.DataArray(np.array(1.0)),
        zbounds=pkg.xdata.DataArray(zb, dims=("z", "yx", "nb")),
    )


TWO_LAYERS = np.array([[[0.0, 1.0], [0.0, 1.0]], [[1.0, 2.0], [1.0, 2.0]]])
SLOPED = np.array([[[0.0, 1.0], [-10.0, -9.0]], [[1.0, 2.0], [-9.0, -8.0]]])
LAYERED_CASES = {
    "overlap_with_voxel": (TWO_LAYERS, [1.0], 2.0, 4),
    "partial_z_overlap": (TWO_LAYERS, [1.0], 1.0, 4),
    "sloped_columns": (SLOPED, [1.0], 2.0, 2),
}


@pytest.mark.parametrize("name", sorted(LAYERED_CASES))
def test_layered_onto_voxel_matches_jax(name):
    zb, z_mid, dz, count = LAYERED_CASES[name]
    out = {}
    for key, pkg in PACKAGES.items():
        grid = MODULES[key].ExplicitStructuredGrid3d(layered_obj(pkg, zb), "x", "y", "z")
        assert grid.shape == (2, 1, 2) and grid.size == 4
        np.testing.assert_allclose(grid.area, 1.0)
        target = MODULES[key].StructuredGrid3d(
            voxel_obj(pkg, [1.0], [0.5], z_mid, dx=np.array(2.0), dy=np.array(1.0), dz=np.asarray(dz)), "x", "y", "z"
        )
        out[key] = grid.overlap(target, relative=False)
    assert len(out["torch"][0]) == count
    for got, want in zip(out["torch"], out["jax"]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def seeded_layers(rng, n_layer, n_col, nan_fraction=0.05):
    """(n_layer, n_col, 2) ascending layer bounds of varying thickness per
    column, some layers pinched out to zero thickness and some NaN."""
    thickness = rng.uniform(0.2, 3.0, (n_col, n_layer))
    thickness[rng.random(thickness.shape) < 0.1] = 0.0
    top = np.cumsum(thickness, axis=1) + rng.uniform(-2.0, 2.0, (n_col, 1))
    zb = np.stack([top - thickness, top], axis=-1)
    zb[rng.random((n_col, n_layer)) < nan_fraction] = np.nan
    return np.ascontiguousarray(np.swapaxes(zb, 0, 1))


@pytest.mark.parametrize("target_kind", ["voxel", "layered"])
@pytest.mark.parametrize("relative", [False, True])
def test_seeded_layered_model_matches_jax(target_kind, relative):
    rng = np.random.default_rng(10)
    x, y = np.arange(6) + 0.5, np.arange(4) + 0.5
    zb = seeded_layers(rng, 12, len(x) * len(y))
    tzb = seeded_layers(rng, 5, 3 * 2, nan_fraction=0.0)
    out = {}
    for key, pkg in PACKAGES.items():
        grid = MODULES[key].ExplicitStructuredGrid3d(layered_obj(pkg, zb, x, y), "x", "y", "z")
        if target_kind == "voxel":
            target = MODULES[key].StructuredGrid3d(
                voxel_obj(pkg, np.arange(3) * 2.0 + 1.2, np.arange(2) * 2.0 + 1.1, np.arange(6) * 2.5 - 1.0),
                "x", "y", "z",
            )
        else:
            target = MODULES[key].ExplicitStructuredGrid3d(
                layered_obj(pkg, tzb, np.arange(3) * 2.0 + 1.2, np.arange(2) * 2.0 + 1.1), "x", "y", "z"
            )
        out[key] = grid.overlap(target, relative=relative)
    assert len(out["torch"][0]) > 20
    for got, want in zip(out["torch"], out["jax"]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_layered_rejects_other_targets_and_bad_zbounds():
    grid = tstructured.ExplicitStructuredGrid3d(layered_obj(xt, TWO_LAYERS), "x", "y", "z")
    raster = tstructured.StructuredGrid2d(voxel_obj(xt, [0.5, 1.5], [0.5, 1.5], [0.5]), "x", "y")
    with pytest.raises(TypeError, match="Cannot overlap with StructuredGrid2d"):
        grid.overlap(raster, relative=False)
    for key, pkg in PACKAGES.items():
        ds = pkg.xdata.Dataset()
        ds["dummy"] = pkg.xdata.DataArray(np.zeros((1, 1, 2)), dims=("z", "y", "x"))
        ds = ds.assign_coords(
            x=pkg.xdata.DataArray(np.array([0.5, 1.5]), dims=("x",)),
            y=pkg.xdata.DataArray(np.array([0.5]), dims=("y",)),
            dy=pkg.xdata.DataArray(np.array(1.0)),
            zbounds=pkg.xdata.DataArray(np.zeros((2, 2)), dims=("zb", "nb")),
        )
        with pytest.raises(ValueError, match="nlayer, n_yx, 2"):
            MODULES[key].ExplicitStructuredGrid3d(ds, "x", "y", "z")


def test_regrid_exports_the_3d_grids():
    import xugrid_tpu.regrid as jregrid
    import xugrid_tpu_torch.regrid as tregrid

    assert sorted(tregrid.__all__) == sorted(jregrid.__all__)
    assert tregrid.StructuredGrid3d is tstructured.StructuredGrid3d
    assert tregrid.ExplicitStructuredGrid3d is tstructured.ExplicitStructuredGrid3d


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("block", [3, 1 << 18])
def test_overlap_1d_nd_matches_jax_loop(seed, block, monkeypatch):
    """The batched join against the JAX package's pair-by-pair loop on
    ascending stacks with NaN rows, zero-thickness rows and unmatched
    pairs, in blocks of 3 pairs and in one block."""
    monkeypatch.setattr(toverlap, "ND_BLOCK_PAIRS", block)
    rng = np.random.default_rng(seed)

    def stack(n, size):
        th = rng.uniform(0.0, 2.0, (n, size))
        th[rng.random((n, size)) < 0.2] = 0.0
        top = np.cumsum(th, axis=1) + rng.uniform(-3, 3, (n, 1))
        b = np.stack([top - th, top], -1)
        b[rng.random((n, size)) < 0.15] = np.nan
        return b

    for _ in range(10):
        n_source, n_target = rng.integers(1, 12, 2)
        sb, tb = stack(n_source, rng.integers(1, 15)), stack(n_target, rng.integers(1, 9))
        k = rng.integers(0, 30)
        si, ti = rng.integers(0, n_source, k), rng.integers(0, n_target, k)
        got, want = toverlap.overlap_1d_nd(sb, tb, si, ti), joverlap.overlap_1d_nd(sb, tb, si, ti)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_extra", [1, 4])
def test_voxel_overlap_applied_matches_jax_apply(n_extra):
    """A 3-D overlap (12 x 10 x 8 voxels onto 6 x 5 x 4, shifted) through
    ``PaddedCSR.from_coo`` and each package's apply_weights, mean,
    float32: the port against oracle (a) at rtol 1e-6."""
    src = dict(x=np.arange(8) + 0.5, y=np.arange(10) + 0.5, z=np.arange(12) * 0.5 + 0.25)
    tgt = dict(x=np.arange(4) * 2.0 + 1.3, y=np.arange(5) * 2.0 + 0.9, z=np.arange(6) * 1.0 + 0.6)
    rng = np.random.default_rng(n_extra)
    values = rng.normal(size=(n_extra, 12 * 10 * 8)).astype(np.float32)
    values[rng.random(values.shape) < 0.02] = np.nan
    out = {}
    for key, pkg in PACKAGES.items():
        source = MODULES[key].StructuredGrid3d(voxel_obj(pkg, **src), "x", "y", "z")
        target = MODULES[key].StructuredGrid3d(voxel_obj(pkg, **tgt), "x", "y", "z")
        s, t, w = source.overlap(target, relative=False)
        sparse = jsparse if key == "jax" else tsparse
        padded = sparse.PaddedCSR.from_coo(sparse.MatrixCOO.from_triplet(t, s, w, n=target.size, m=source.size))
        out[key + "_padded"] = padded
        if key == "jax":
            out[key] = np.asarray(japply.apply_weights(padded, values, jreduce.mean, target.size))
        else:
            out[key] = tapply.apply_weights(padded, torch.from_numpy(values), treduce.mean, target.size).numpy()
    jp, tp = out["jax_padded"], out["torch_padded"]
    assert (tp.n, tp.m, tp.w_max) == (jp.n, jp.m, jp.w_max) == (120, 960, 27)
    np.testing.assert_array_equal(tp.indices, jp.indices)
    np.testing.assert_array_equal(tp.weights, jp.weights)
    assert out["torch"].dtype == np.float32 and np.isfinite(out["torch"]).all()
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=1e-6, atol=1e-7)


def test_sparse_row_helpers_match_jax():
    rng = np.random.default_rng(11)
    rows, cols, data = rng.integers(0, 7, 30), rng.integers(0, 9, 30), rng.normal(size=30)
    A_j = jsparse.MatrixCSR.from_triplet(rows, cols, data, n=8, m=9)
    A_t = tsparse.MatrixCSR.from_triplet(rows, cols, data, n=8, m=9)
    for row in range(8):
        assert tuple(tsparse.nzrange(A_t, row)) == tuple(jsparse.nzrange(A_j, row))
        sl_t, sl_j = tsparse.row_slice(A_t, row), jsparse.row_slice(A_j, row)
        assert (sl_t.start, sl_t.stop) == (sl_j.start, sl_j.stop)
        for g, w in zip(tsparse.columns_and_values(A_t, sl_t), jsparse.columns_and_values(A_j, sl_j)):
            np.testing.assert_array_equal(g, w)
