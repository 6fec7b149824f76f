"""
The port's CentroidLocatorRegridder, BarycentricInterpolator and
NetworkGridder held on the CPU against the JAX package's: a jittered
24 x 24 quad mesh and a 15 x 15 raster over the same extent, regridded
both ways, and a network of random-walk polylines gridded onto the
quad mesh.

Both packages build the weights with the same C++
(csrc/host_kernels.cpp) and numpy, so the weight triplets must be
identical; the regridded values must agree at float64 rtol 1e-12 (only
the summation order of a sum differs), selections bit for bit.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import xugrid_tpu as xu
import xugrid_tpu_torch as xt
from tests.test_torch_reduce import assert_matches
from tests.test_torch_regrid import gathered, quad_mesh
from xugrid_tpu import xdata
from xugrid_tpu_torch.regrid.aligned_apply import window_reduce
from xugrid_tpu_torch.regrid.select_apply import window_select

N_SIDE, T_SIDE = 24, 15


@pytest.fixture(scope="module")
def meshes():
    rng = np.random.default_rng(3)
    (verts, faces), (tverts, tfaces) = chip_smoke.bench_meshes(N_SIDE, T_SIDE, rng)
    nodes, edges = chip_smoke.random_network(6, 40, float(N_SIDE), rng)
    source = rng.normal(size=(3, len(faces)))
    source[rng.random(source.shape) < 0.05] = np.nan
    raster = rng.normal(size=(3, len(tfaces)))
    network = np.round(rng.normal(size=(3, len(edges))) * 2.0) / 2.0
    network[rng.random(network.shape) < 0.05] = np.nan
    grids = {}
    for pkg in (xu, xt):
        grids[pkg.__name__] = {
            "mesh": pkg.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces),
            "raster": pkg.Ugrid2d(tverts[:, 0], tverts[:, 1], -1, tfaces),
            "network": pkg.Ugrid1d(nodes[:, 0], nodes[:, 1], -1, edges),
        }
    return {"jax": grids["xugrid_tpu"], "torch": grids["xugrid_tpu_torch"],
            "data": {"mesh": source, "raster": raster, "network": network}}


def jax_regrid(regridder, grid, core_dim, values):
    da = xdata.DataArray(values, dims=("time", core_dim))
    return np.asarray(regridder.regrid(xu.UgridDataArray(da, grid)).values)


def make(pkg, cls, source, target, **kwargs):
    if pkg is xt and cls == "BarycentricInterpolator":
        kwargs["device"] = "cpu"
    return getattr(pkg, cls)(source, target, **kwargs)


DIRECTIONS = [("mesh", "raster"), ("raster", "mesh")]
TRIPLET_CASES = [
    (cls, s, t) for cls in ("CentroidLocatorRegridder", "BarycentricInterpolator") for s, t in DIRECTIONS
] + [("NetworkGridder", "network", "mesh")]


def triplets(weights):
    """(row, col, data) of a COO or CSR weight matrix, in storage order."""
    if hasattr(weights, "row"):
        return weights.row, weights.col, weights.data
    return np.repeat(np.arange(weights.n), np.diff(weights.indptr)), weights.indices, weights.data


@pytest.mark.parametrize("cls, src, tgt", TRIPLET_CASES)
def test_weight_triplets_equal_jax(meshes, cls, src, tgt):
    jr = make(xu, cls, meshes["jax"][src], meshes["jax"][tgt])
    tr = make(xt, cls, meshes["torch"][src], meshes["torch"][tgt])
    jw, tw = jr._weights, tr._weights
    assert type(jw).__name__ == type(tw).__name__
    assert (jw.n, jw.m, jw.nnz) == (tw.n, tw.m, tw.nnz) and tw.nnz > 0
    for a, b in zip(triplets(jw)[:2], triplets(tw)[:2]):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(triplets(tw)[2], triplets(jw)[2], rtol=1e-12, atol=0)


@pytest.mark.parametrize("cls, src, tgt", TRIPLET_CASES[:4])
def test_grid_regrid_matches_jax(meshes, cls, src, tgt):
    values = meshes["data"][src]
    jr = make(xu, cls, meshes["jax"][src], meshes["jax"][tgt])
    tr = make(xt, cls, meshes["torch"][src], meshes["torch"][tgt])
    launches = (window_reduce.launches, window_select.launches)
    got = tr.regrid(values, device="cpu")
    assert (window_reduce.launches, window_select.launches) == launches
    n_target = meshes["torch"][tgt].n_face
    assert isinstance(got, torch.Tensor) and got.shape == (3, n_target) and got.dtype == torch.float64
    jgrid = meshes["jax"][src]
    want = jax_regrid(jr, jgrid, jgrid.face_dimension, values)
    # The same weights carried across from the JAX regridder.
    w = jr._weights
    if cls == "CentroidLocatorRegridder":
        np.testing.assert_array_equal(got.numpy(), want)
        carried = xt.CentroidLocatorRegridder.from_coo_arrays(
            w.data, w.row, w.col, w.n, w.m, meshes["torch"][tgt]
        )
        np.testing.assert_array_equal(carried.regrid(values, device="cpu").numpy(), want)
    else:
        windows, weights = gathered(tr._weights, values)
        assert_matches(got.numpy().T, want.T, "mean", windows, weights)
        carried = xt.BarycentricInterpolator.from_csr_arrays(
            w.data, w.indices, w.indptr, w.n, w.m, meshes["torch"][tgt]
        )
        assert_matches(carried.regrid(values, device="cpu").numpy().T, want.T, "mean", windows, weights)


@pytest.mark.parametrize("method", sorted(xt.NetworkGridder._METHODS))
def test_network_gridder_matches_jax(meshes, method):
    values = meshes["data"]["network"]
    network = meshes["jax"]["network"]
    jr = xu.NetworkGridder(network, meshes["jax"]["mesh"], method=method)
    tr = xt.NetworkGridder(meshes["torch"]["network"], meshes["torch"]["mesh"], method=method)
    got = tr.regrid(values, device="cpu")
    assert got.shape == (3, N_SIDE * N_SIDE)
    want = jax_regrid(jr, network, network.edge_dimension, values)
    windows, weights = gathered(tr._weights, values)
    assert_matches(got.numpy().T, want.T, method, windows, weights)
    # The same weights carried across from the JAX regridder.  (torch's
    # CPU log and exp round by where a vectorized chunk ends, so repeated
    # calls may differ in the last bit: held to JAX at the same rtol.)
    w = jr._weights
    carried = xt.NetworkGridder.from_csr_arrays(
        w.data, w.indices, w.indptr, w.n, w.m, meshes["torch"]["mesh"], method
    )
    assert_matches(carried.regrid(values, device="cpu").numpy().T, want.T, method, windows, weights)


def test_barycentric_rows_sum_to_one(meshes):
    for src, tgt in DIRECTIONS:
        w = make(xt, "BarycentricInterpolator", meshes["torch"][src], meshes["torch"][tgt])._weights
        sums = np.add.reduceat(w.data, w.indptr[:-1][np.diff(w.indptr) > 0])
        np.testing.assert_allclose(sums, 1.0, rtol=0, atol=1e-12)


def quad(nx, ny, dx=1.0, x0=0.0, y0=0.0):
    verts, faces = quad_mesh(nx, ny, dx)
    return xt.Ugrid2d(verts[:, 0] + x0, verts[:, 1] + y0, -1, faces)


# Ports of tests/test_regrid.py's unstructured cases.
def test_centroid_locator_refine():
    source, target = quad(2, 2, dx=2.0), quad(4, 4)
    out = xt.CentroidLocatorRegridder(source, target).regrid(np.arange(4.0), device="cpu")
    expected = np.repeat(np.repeat(np.arange(4.0).reshape(2, 2), 2, 0), 2, 1)
    np.testing.assert_array_equal(out.numpy().reshape(4, 4), expected)


def test_centroid_locator_out_of_bounds_nan():
    regridder = xt.CentroidLocatorRegridder(quad(2, 2), quad(2, 2, x0=10.0))
    assert torch.isnan(regridder.regrid(np.arange(4.0), device="cpu")).all()


def test_centroid_locator_casts_integers_and_checks_size():
    regridder = xt.CentroidLocatorRegridder(quad(2, 2, dx=2.0), quad(4, 4))
    out = regridder.regrid(np.arange(8).reshape(2, 4), device="cpu")
    assert out.dtype == torch.float64 and out.shape == (2, 16)
    with pytest.raises(ValueError, match="does not match"):
        regridder.regrid(np.zeros((2, 7)), device="cpu")
    assert regridder.regrid(np.zeros((0, 4)), device="cpu").shape == (0, 16)
    w = regridder._weights
    with pytest.raises(TypeError, match="COO weights"):
        xt.CentroidLocatorRegridder.from_csr_arrays(w.data, w.col, np.arange(17), 16, 4, quad(4, 4))
    with pytest.raises(ValueError, match="target has 16 faces"):
        xt.CentroidLocatorRegridder.from_coo_arrays(w.data, w.row, w.col, 17, 4, quad(4, 4))


def test_barycentric_linear_precision():
    def f(c):
        return 2.0 * c[:, 0] + 3.0 * c[:, 1] + 1.0

    source = quad(8, 8)
    target = quad(12, 12, dx=0.5, x0=1.0, y0=1.0)
    out = xt.BarycentricInterpolator(source, target, device="cpu").regrid(f(source.centroids), device="cpu")
    c = target.centroids
    interior = (c[:, 0] > 2) & (c[:, 0] < 6) & (c[:, 1] > 2) & (c[:, 1] < 6)
    np.testing.assert_allclose(out.numpy()[interior], f(c)[interior], rtol=0, atol=1e-8)


def test_network_gridder_intersection_mean():
    network = xt.Ugrid1d(np.array([0.0, 2.0, 4.0]), np.array([1.5, 1.5, 1.5]), -1, np.array([[0, 1], [1, 2]]))
    gridder = xt.NetworkGridder(network, quad(4, 4), method="mean")
    values = gridder.regrid(np.array([10.0, 20.0]), device="cpu").numpy().reshape(4, 4)
    np.testing.assert_array_equal(values[1], [10.0, 10.0, 20.0, 20.0])
    assert np.isnan(values[0]).all() and np.isnan(values[2:]).all()


def test_regridders_run_on_the_card_by_default(meshes):
    """A numpy source goes to the CUDA card unless the caller asks for the
    CPU; without a card that is an error, not a CPU fallback.  The
    barycentric weight build's angle sort goes there too."""
    g = meshes["torch"]
    regridders = [
        (xt.CentroidLocatorRegridder(g["mesh"], g["raster"]), "mesh"),
        (xt.BarycentricInterpolator(g["mesh"], g["raster"], device="cpu"), "mesh"),
        (xt.NetworkGridder(g["network"], g["mesh"]), "network"),
    ]
    for regridder, src in regridders:
        values = meshes["data"][src]
        if torch.cuda.is_available():
            assert regridder.regrid(values).device == torch.device("cuda", 0)
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                regridder.regrid(values)
        assert regridder.regrid(torch.from_numpy(values)).device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            xt.BarycentricInterpolator(g["mesh"], g["raster"])


def test_regridders_reject_wrong_topologies(meshes):
    g = meshes["torch"]
    with pytest.raises(TypeError, match="Ugrid1d"):
        xt.NetworkGridder(g["mesh"], g["raster"])
    with pytest.raises(TypeError, match="Ugrid2d"):
        xt.CentroidLocatorRegridder(g["network"], g["raster"])
    with pytest.raises(ValueError, match="Invalid regridding method"):
        xt.NetworkGridder(g["network"], g["mesh"], method="first_order_conservative")
