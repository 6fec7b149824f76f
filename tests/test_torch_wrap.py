"""
The port's labelled regrid and fill held on the CPU against the JAX
package's: ``UgridDataArray`` and raster ``DataArray`` inputs through
every regridder between a jittered 12 x 12 quad mesh and rasters over
the same extent (9 x 9 ascending, 7 x 7 with descending ``y`` and
``dx``/``dy``), both ways and raster to raster and mesh to mesh,
``NetworkGridder`` onto a raster, and ``uda.ugrid.laplace_interpolate()``.

The same seeded inputs through both.  The results' type, dims,
coordinates, name and attrs are equal; values agree at float64 rtol
1e-12 for float64 data (only a sum's order differs; selections are
bit-equal) and at float32 rtol 1e-5 / atol 1e-6 for float32 data (the
mode at float64 only); the
fills agree within 1e-8 with both solves run to atol 1e-11.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import xugrid_tpu as xu
import xugrid_tpu_torch as xt
from xugrid_tpu_torch.regrid import regridder as torch_regridder

N_SIDE = 12


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(21)
    (verts, faces), _ = chip_smoke.bench_meshes(N_SIDE, 4, rng)
    nodes, edges = chip_smoke.random_network(4, 30, float(N_SIDE), rng)
    mesh_data = rng.normal(size=(3, len(faces)))
    mesh_data[rng.random(mesh_data.shape) < 0.05] = np.nan
    fine = rng.normal(size=(3, 9, 9))
    fine[rng.random(fine.shape) < 0.05] = np.nan
    network = np.round(rng.normal(size=(3, len(edges))) * 2.0) / 2.0
    return {"verts": verts, "faces": faces, "mesh": mesh_data, "fine": fine,
            "nodes": nodes, "edges": edges, "network": network}


def raster(pkg, n, descending, values=None, dtype=np.float64):
    """An n x n raster DataArray over [0, 12]^2 (time, y, x)."""
    cell = N_SIDE / n
    x = (np.arange(n) + 0.5) * cell
    y = x[::-1].copy() if descending else x.copy()
    if values is None:
        values = np.zeros((3, n, n))
    coords = {"time": [1.0, 2.0, 3.0], "y": y, "x": x}
    if descending:
        coords.update(dx=cell, dy=-cell)
    return pkg.xdata.DataArray(values.astype(dtype), coords=coords, dims=("time", "y", "x"), name="v",
                               attrs={"units": "m"})


def mesh_uda(pkg, inputs, dtype=np.float64):
    verts, faces = inputs["verts"], inputs["faces"]
    grid = pkg.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    da = pkg.xdata.DataArray(inputs["mesh"].astype(dtype), coords={"time": [1.0, 2.0, 3.0]},
                             dims=("time", grid.face_dimension), name="v", attrs={"units": "m"})
    return pkg.UgridDataArray(da, grid)


def objects(pkg, inputs, dtype):
    return {
        "mesh": mesh_uda(pkg, inputs, dtype),
        "fine raster": raster(pkg, 9, False, inputs["fine"], dtype),
        "raster": raster(pkg, 7, True, dtype=dtype),
    }


def make(pkg, cls, source, target, method):
    kwargs = {} if method is None else {"method": method}
    if pkg is xt and cls in ("BarycentricInterpolator", "OverlapRegridder", "RelativeOverlapRegridder"):
        kwargs["device"] = "cpu"
    return getattr(pkg, cls)(source, target, **kwargs)


def values_of(obj):
    data = obj.obj.data if isinstance(obj, (xu.UgridDataArray, xt.UgridDataArray)) else obj.data
    return data.numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


def assert_same_labelled(want, got, exact, dtype):
    """Same wrapper type, dims, coordinates, name and attrs; values within
    the stated tolerance."""
    wrapped = isinstance(want, xu.UgridDataArray)
    assert isinstance(got, xt.UgridDataArray) == wrapped
    wobj, gobj = (want.obj, got.obj) if wrapped else (want, got)
    assert gobj.dims == wobj.dims and gobj.name == wobj.name and gobj.attrs == wobj.attrs
    assert sorted(gobj.coords) == sorted(wobj.coords)
    for k in wobj.coords:
        assert gobj._coords[k].dims == wobj._coords[k].dims, k
        np.testing.assert_array_equal(gobj._coords[k].values, np.asarray(wobj._coords[k].data))
    if wrapped:
        for attr in ("node_x", "node_y", "face_node_connectivity"):
            np.testing.assert_array_equal(getattr(got.grid, attr), getattr(want.grid, attr))
    assert isinstance(gobj.data, torch.Tensor)
    w, g = np.asarray(wobj.values, dtype=np.float64), values_of(got).astype(np.float64)
    if exact:
        np.testing.assert_array_equal(g, w)
    elif dtype == np.float64:
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-14)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


CASES = [
    ("OverlapRegridder", "mean"),
    ("OverlapRegridder", "mode"),
    ("RelativeOverlapRegridder", "first_order_conservative"),
    ("CentroidLocatorRegridder", None),
    ("BarycentricInterpolator", None),
]
DIRECTIONS = [("mesh", "raster"), ("fine raster", "raster"), ("fine raster", "mesh"), ("mesh", "mesh")]


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("src, tgt", DIRECTIONS, ids=[f"{s}->{t}" for s, t in DIRECTIONS])
@pytest.mark.parametrize("cls, method", CASES, ids=[f"{c}-{m}" for c, m in CASES])
def test_labelled_regrid_matches_jax(inputs, cls, method, src, tgt, dtype):
    """The mode is held at float64 only: equal overlap areas in float32
    weights round apart and break the mode's ties otherwise."""
    if method == "mode" and dtype == np.float32:
        dtype = np.float64
    jobj, tobj = objects(xu, inputs, dtype), objects(xt, inputs, dtype)
    jr = make(xu, cls, jobj[src], jobj[tgt], method)
    tr = make(xt, cls, tobj[src], tobj[tgt], method)
    want = jr.regrid(jobj[src])
    got = tr.regrid(tobj[src], device="cpu")
    exact = method == "mode" or cls == "CentroidLocatorRegridder"
    assert_same_labelled(want, got, exact, dtype)


def test_network_gridder_onto_a_raster(inputs):
    out = {}
    for pkg in (xu, xt):
        network = pkg.Ugrid1d(inputs["nodes"][:, 0], inputs["nodes"][:, 1], -1, inputs["edges"])
        da = pkg.xdata.DataArray(inputs["network"], dims=("time", network.edge_dimension), name="q")
        uda = pkg.UgridDataArray(da, network)
        gridder = pkg.NetworkGridder(uda, raster(pkg, 7, True), method="mean")
        out[pkg] = gridder.regrid(uda, device="cpu") if pkg is xt else gridder.regrid(uda)
    assert_same_labelled(out[xu], out[xt], False, np.float64)
    assert out[xt].grid.n_face == 49


def test_labelled_equals_bare_through_structured_bounds(inputs):
    """A descending raster target: the labelled result is bit-equal to the
    bare-tensor regrid onto the Ugrid2d of its directional bounds,
    reshaped (chip_smoke.py phase 8 runs this at 1M), and equal to the
    regrid onto the ascending bounds' Ugrid2d flipped along y."""
    from xugrid_tpu_torch.regrid.structured import StructuredGrid2d

    uda = mesh_uda(xt, inputs)
    target = raster(xt, 7, True)
    grid = StructuredGrid2d(target)
    directional = xt.Ugrid2d.from_structured_bounds(grid.xbounds.directional_bounds, grid.ybounds.directional_bounds)
    ascending = xt.Ugrid2d.from_structured_bounds(grid.xbounds.bounds, grid.ybounds.bounds)
    source = torch.from_numpy(inputs["mesh"])
    for cls, method in (("OverlapRegridder", "mean"), ("OverlapRegridder", "mode"),
                        ("RelativeOverlapRegridder", "first_order_conservative")):
        labelled = getattr(xt, cls)(uda, target, method=method).regrid(uda, device="cpu")
        assert labelled.dims == ("time", "y", "x")
        bare = getattr(xt, cls)(uda.grid, directional, method=method).regrid(source)
        torch.testing.assert_close(labelled.data, bare.reshape(3, 7, 7), rtol=0, atol=0, equal_nan=True)
        # The ascending raster's faces in y order, flipped: the same values
        # (a window's sum may run in another order).
        flipped = getattr(xt, cls)(uda.grid, ascending, method=method).regrid(source).reshape(3, 7, 7).flip(1)
        torch.testing.assert_close(labelled.data, flipped, rtol=1e-12, atol=1e-14, equal_nan=True)


def test_payloads_stay_where_they_are(inputs):
    """A tensor payload is regridded on its device and stays a tensor; a
    numpy payload gives a tensor on ``device``; a bare array keeps the
    raster's trailing (y, x) axes."""
    uda = mesh_uda(xt, inputs)
    target = raster(xt, 7, True)
    regridder = xt.OverlapRegridder(uda, target)
    on_cpu = xt.UgridDataArray(uda.obj.copy(data=torch.from_numpy(inputs["mesh"])), uda.grid)
    out = regridder.regrid(on_cpu)
    assert isinstance(out.data, torch.Tensor) and out.data.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            regridder.regrid(uda)
    bare = xt.OverlapRegridder(raster(xt, 9, False, inputs["fine"]), target).regrid(inputs["fine"], device="cpu")
    assert bare.shape == (3, 7, 7)
    with pytest.raises(ValueError, match="source dimensions"):
        regridder.regrid(target)
    w = regridder._weights
    carried = xt.OverlapRegridder.from_csr_arrays(w.data, w.indices, w.indptr, w.n, w.m, target)
    torch.testing.assert_close(carried.regrid(on_cpu).data, out.data, rtol=0, atol=0, equal_nan=True)
    assert carried.regrid(on_cpu).dims == ("time", "y", "x")
    with pytest.raises(ValueError, match="no source grid"):
        carried.regrid(raster(xt, 9, False, inputs["fine"]))


def test_regrid_chunks_a_labelled_stack(inputs, monkeypatch):
    uda = mesh_uda(xt, inputs)
    regridder = xt.OverlapRegridder(uda, raster(xt, 7, True))
    whole = regridder.regrid(uda, device="cpu")
    per_slice = 8 * (regridder._weights.m + regridder._weights.n)
    monkeypatch.setattr(torch_regridder, "APPLY_CHUNK_BYTES", per_slice)
    torch.testing.assert_close(regridder.regrid(uda, device="cpu").data, whole.data, rtol=0, atol=0, equal_nan=True)


def fill_values(grid, facet, n_extra, mixed, seed=3):
    """(n_extra, n) values of a smooth field, 30 % known at one pattern,
    or with two more unknowns in the second slice (``mixed``)."""
    xy = grid.node_coordinates if facet == "node" else grid.centroids
    field = np.sin(xy[:, 0] / 3.0) + np.cos(xy[:, 1] / 4.0)
    stack = field[None, :] * (1.0 + 0.1 * np.arange(n_extra))[:, None]
    known = np.random.default_rng(seed).random(len(field)) < 0.3
    stack[:, ~known] = np.nan
    if mixed:
        stack[1, np.flatnonzero(known)[:2]] = np.nan
    return stack


@pytest.mark.parametrize("facet", ["node", "face"])
@pytest.mark.parametrize("xy_weights", [True, False])
@pytest.mark.parametrize("mixed", [False, True], ids=["one pattern", "mixed patterns"])
def test_laplace_interpolate_accessor_matches_jax(inputs, facet, xy_weights, mixed):
    """(dim, time) data, the UGRID dimension first: the fill runs along it
    over every time slice and keeps the order of the dims."""
    from xugrid_tpu_torch.ugrid import interpolate

    verts, faces = inputs["verts"], inputs["faces"]
    out = {}
    for pkg in (xu, xt):
        grid = pkg.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
        values = fill_values(xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces), facet, 3, mixed)
        dim = grid.node_dimension if facet == "node" else grid.face_dimension
        da = pkg.xdata.DataArray(values.T, dims=(dim, "time"), coords={"time": [1, 2, 3]}, name="h")
        uda = pkg.UgridDataArray(da, grid)
        kwargs = {"xy_weights": xy_weights, "atol": 1e-11, "maxiter": 2000}
        if pkg is xt:
            launches = interpolate.csr_matvec.launches
            out[pkg] = uda.ugrid.laplace_interpolate(device="cpu", **kwargs)
            assert interpolate.csr_matvec.launches == launches
        else:
            out[pkg] = uda.ugrid.laplace_interpolate(**kwargs)
    want, got = out[xu], out[xt]
    assert got.dims == want.dims and got.dims[1] == "time"
    assert got.name == "h" and sorted(got.obj.coords) == sorted(want.obj.coords)
    assert isinstance(got.obj.data, np.ndarray) and got.obj.data.dtype == np.float64
    assert np.isfinite(got.values).all()
    np.testing.assert_allclose(got.values, np.asarray(want.obj.values), rtol=0, atol=1e-8)


def test_laplace_interpolate_accessor_batches_one_pattern(inputs, monkeypatch):
    """Slices sharing one NaN pattern take one call (one batched solve),
    mixed patterns one call per slice, each equal to the direct call; a
    tensor payload comes back a float64 tensor on its device, equal to
    the numpy payload's fill."""
    from xugrid_tpu_torch.ugrid import interpolate

    verts, faces = inputs["verts"], inputs["faces"]
    grid = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    W = grid.get_connectivity_matrix(grid.node_dimension, xy_weights=True)
    calls = []
    solve = interpolate.laplace_interpolate
    monkeypatch.setattr(
        interpolate, "laplace_interpolate", lambda data, *a, **k: calls.append(np.shape(data)) or solve(data, *a, **k)
    )
    for mixed, expected in ((False, [(4, grid.n_node)]), (True, [(grid.n_node,)] * 4)):
        calls.clear()
        values = fill_values(grid, "node", 4, mixed)
        uda = xt.UgridDataArray(xt.xdata.DataArray(values, dims=("time", grid.node_dimension)), grid)
        filled = uda.ugrid.laplace_interpolate(device="cpu", atol=1e-10)
        assert calls == expected
        if mixed:
            direct = np.stack([solve(row, W, device="cpu", atol=1e-10) for row in values])
        else:
            direct = solve(values, W, device="cpu", atol=1e-10)
        np.testing.assert_array_equal(filled.values, direct)
        as_tensor = xt.UgridDataArray(uda.obj.copy(data=torch.from_numpy(values)), grid)
        tfilled = as_tensor.ugrid.laplace_interpolate(atol=1e-10)
        assert isinstance(tfilled.data, torch.Tensor) and tfilled.data.dtype == torch.float64
        np.testing.assert_array_equal(tfilled.values, filled.values)
    edges = xt.UgridDataArray(xt.xdata.DataArray(np.zeros(grid.n_edge), dims=(grid.edge_dimension,)), grid)
    with pytest.raises(ValueError, match="edges"):
        edges.ugrid.laplace_interpolate(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            uda.ugrid.laplace_interpolate()


def test_wrapper_forwarding_and_operators(inputs):
    """Forwarded methods and operators come back wrapped while a UGRID
    dimension remains, plain once none does, as the JAX package's."""
    j, t = mesh_uda(xu, inputs), mesh_uda(xt, inputs)
    for f in (
        lambda u: u.isel(time=[0, 2]),
        lambda u: u.sel(time=2.0),
        lambda u: u.mean("time"),
        lambda u: (u * 2.0 + u).where(u > 0.0),
        lambda u: 1.0 - abs(-u),
        lambda u: u.transpose(),
        lambda u: u.fillna(0.0).astype(np.float32),
        lambda u: u.rename("w"),
        lambda u: u.assign_coords(time=[4.0, 5.0, 6.0]),
        lambda u: u["time"],
    ):
        want, got = f(j), f(t)
        assert isinstance(got, xt.UgridDataArray) == isinstance(want, xu.UgridDataArray)
        wobj = want.obj if isinstance(want, xu.UgridDataArray) else want
        gobj = got.obj if isinstance(got, xt.UgridDataArray) else got
        assert gobj.dims == wobj.dims and sorted(gobj.coords) == sorted(wobj.coords) and gobj.name == wobj.name
        np.testing.assert_array_equal(gobj.values, np.asarray(wobj.values))
    reduced = t.mean(t.grid.face_dimension)
    assert isinstance(reduced, xt.xdata.DataArray) and reduced.dims == ("time",)
    assert t.shape == (3, t.grid.n_face) and t.sizes["time"] == 3 and len(t) == 3
    jsub, tsub = j.isel({j.grid.face_dimension: [0, 1]}), t.isel({t.grid.face_dimension: [0, 1]})
    assert isinstance(tsub, xt.UgridDataArray) and tsub.dims == jsub.dims and tsub.grid.n_face == 2
    for attr in ("node_x", "node_y", "face_node_connectivity"):
        np.testing.assert_array_equal(getattr(tsub.grid, attr), getattr(jsub.grid, attr))
    np.testing.assert_array_equal(tsub.values, np.asarray(jsub.values))
    accessor, jaccessor = t.ugrid, j.ugrid
    assert accessor.name == jaccessor.name and accessor.names == jaccessor.names
    assert list(accessor.topology) == list(jaccessor.topology) and accessor.grids == [t.grid]
    assert tuple(map(float, accessor.total_bounds)) == tuple(map(float, jaccessor.total_bounds))
    assert {k: tuple(map(float, v)) for k, v in accessor.bounds.items()} == {
        k: tuple(map(float, v)) for k, v in jaccessor.bounds.items()
    }


@pytest.mark.parametrize("descending", [False, True])
def test_from_structured2d_matches_jax(inputs, descending):
    out = {}
    for pkg in (xu, xt):
        da = raster(pkg, 9, descending, inputs["fine"])
        uda = pkg.UgridDataArray.from_structured2d(da)
        uds = pkg.UgridDataset.from_structured2d(da.to_dataset())
        out[pkg] = (uda, uds)
    (juda, juds), (tuda, tuds) = out[xu], out[xt]
    assert tuda.dims == juda.dims and sorted(tuda.coords) == sorted(juda.coords)
    np.testing.assert_array_equal(tuda.values, np.asarray(juda.values))
    for attr in ("node_x", "node_y", "face_node_connectivity"):
        np.testing.assert_array_equal(getattr(tuda.grid, attr), getattr(juda.grid, attr))
    assert sorted(tuds.obj.data_vars) == sorted(juds.obj.data_vars) and tuds.grid.name == juds.grid.name
    np.testing.assert_array_equal(tuds["v"].values, np.asarray(juds["v"].values))


def test_dataset_wrapper_and_combinations(inputs):
    t = mesh_uda(xt, inputs)
    j = mesh_uda(xu, inputs)
    uds = t.to_dataset()
    assert isinstance(uds, xt.UgridDataset) and uds.grid is t.grid and "v" in uds
    assert isinstance(uds["v"], xt.UgridDataArray)
    uds["w"] = t * 2.0
    assert sorted(uds.obj.data_vars) == ["v", "w"]
    np.testing.assert_array_equal(uds["w"].values, 2.0 * t.values)
    for jf, tf in ((xu.zeros_like, xt.zeros_like), (xu.ones_like, xt.ones_like)):
        assert isinstance(tf(t), xt.UgridDataArray)
        np.testing.assert_array_equal(tf(t).values, np.asarray(jf(j).values))
    np.testing.assert_array_equal(xt.full_like(t, 2.5).values, np.asarray(xu.full_like(j, 2.5).values))
    cat = xt.concat([t, t], "time")
    assert isinstance(cat, xt.UgridDataArray) and cat.sizes["time"] == 6 and cat.grid.equals(t.grid)
    np.testing.assert_array_equal(cat.values, np.asarray(xu.concat([j, j], "time").values))
    merged = xt.merge([t, t.rename("w")])
    assert isinstance(merged, xt.UgridDataset) and len(merged.grids) == 1
    assert sorted(merged.obj.data_vars) == sorted(xu.merge([j, j.rename("w")]).obj.data_vars)
    # Without grids, the topologies are read from the UGRID variables:
    # a dataset holding none gives none, as in the JAX package.
    assert xt.UgridDataset(uds.obj).grids == [] == xu.UgridDataset(j.to_dataset().obj).grids
    with pytest.raises(ValueError, match="At least one of obj and grids is required"):
        xt.UgridDataset()
