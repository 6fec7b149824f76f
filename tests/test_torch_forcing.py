"""
The port's labelled raster -> mesh mean (``OverlapRegridder(raster, mesh,
method="mean")`` of a (time, y, x) DataArray onto a UGRID mesh), held
on the CPU to the benchmark's plain reference,
``portbench/reference/forcing.py``, on seeded payloads: 1 km maps over a
mesh of 250 m faces, aligned with it (each face in one map cell) and
moved by a part of a cell (windows of 1, 2 or 4 cells), with ``y``
descending (north first) and ascending, and with no NaN, 1 % NaN, and a
map cell all NaN.  Then the span ``regrid.wrap`` and the counter
``wrap.coord_bytes`` onto both kinds of target.

Tolerances: the port computes sum(w v) / sum(w) in float32 over the
valid values, the reference in float64.  All values lie near 10 (10 +
N(0, 1)), so no sum cancels.  Aligned, a window is one cell: v w / w,
two roundings, each at most half a float32 ulp of the result's binade
times two, so within 2 ulps of the largest value.  Moved, a window has
up to 4 cells: the float32 weights (4 roundings), the products (4), the
sums of the numerator and of the denominator (3 each) and the division
give at most 15 relative roundings of u = 2^-24, within 8 ulps of the
largest value.
"""

import math

import numpy as np
import pytest
import torch

import xugrid_tpu_torch as xt
from portbench import inputs
from portbench.generators import common
from portbench.reference import forcing
from xugrid_tpu_torch.utils.profiling import timings

CPU = torch.device("cpu")
#: The 1 km map's origin moved by half a face in x and a third of one in y.
SHIFTS = {"aligned": (0.0, 0.0), "shifted": (125.0, -90.0)}
ULPS = {"aligned": 2, "shifted": 8}


def forcing_case(kind, descending, nan, nx=16, ny=20, time=5, seed=2147483659):
    """A quad mesh of 250 m faces, its 1 km map and a (time, y, x)
    float32 payload over the map; ``nan`` "cell" adds to 1 % NaN every
    slice of the map's cell 5."""
    mesh = inputs.quad_mesh(nx, ny, 250.0, (0.0, 300000.0))
    raster = inputs.raster(mesh.bounds, 1000.0, SHIFTS[kind], descending)
    share = 0.01 if nan == "cell" else nan
    pool = inputs.payload_pool(time, raster.size, share, seed, CPU)
    if nan == "cell":
        pool[:, 5] = math.nan
    return mesh, raster, pool


def raster_array(raster, pool):
    coords = common.port_raster(xt, raster).coords.variables
    return xt.xdata.DataArray(pool.view(-1, raster.ny, raster.nx), coords=coords, dims=("time", "y", "x"))


def labelled_regrid(mesh, raster, pool):
    grid = common.port_grid(xt, mesh)
    source = raster_array(raster, pool)
    out = xt.OverlapRegridder(source, grid, method="mean").regrid(source)
    assert isinstance(out, xt.UgridDataArray)
    assert out.dims == ("time", grid.face_dimension) and out.shape == (pool.shape[0], len(mesh.faces))
    assert out.grid.n_face == len(mesh.faces) and out.grid.face_dimension == grid.face_dimension
    assert out.data.device == CPU and out.data.dtype == torch.float32
    return out.data


@pytest.mark.parametrize("nan", [0.0, 0.01, "cell"], ids=["no_nan", "nan_1pct", "nan_cell"])
@pytest.mark.parametrize("descending", [True, False], ids=["y_descending", "y_ascending"])
@pytest.mark.parametrize("kind", sorted(SHIFTS))
def test_labelled_raster_to_mesh_mean_matches_the_reference(kind, descending, nan):
    mesh, raster, pool = forcing_case(kind, descending, nan)
    triplets = forcing.face_triplets(mesh.nodes, mesh.faces, raster, CPU)
    widths = torch.bincount(triplets[0], minlength=len(mesh.faces))
    assert set(widths.tolist()) == ({1} if kind == "aligned" else {1, 2, 4})
    expected = torch.cat([block for _, block in forcing.face_means(triplets, pool, len(mesh.faces), block=2)])
    got = labelled_regrid(mesh, raster, pool)
    assert torch.equal(torch.isnan(got), torch.isnan(expected))
    if nan == "cell":
        inside = triplets[0][triplets[1] == 5]
        assert bool(torch.isnan(expected[:, inside]).any())
    valid = ~torch.isnan(expected)
    ulp = float(np.spacing(np.float32(expected[valid].abs().max())))
    torch.testing.assert_close(got.double()[valid], expected[valid], rtol=0, atol=ULPS[kind] * ulp)


def test_reference_flips_with_the_rows():
    """The same values with the rows in the other order give the same
    means: the reference numbers map cells in the raster's row order."""
    mesh, north_first, pool = forcing_case("shifted", True, 0.01)
    south_first = inputs.raster(mesh.bounds, 1000.0, SHIFTS["shifted"], False)
    flipped = pool.view(-1, north_first.ny, north_first.nx).flip(1).reshape(pool.shape)
    means = [
        torch.cat([b for _, b in forcing.face_means(forcing.face_triplets(mesh.nodes, mesh.faces, r, CPU), p, len(mesh.faces))])
        for r, p in ((north_first, pool), (south_first, flipped))
    ]
    torch.testing.assert_close(means[0], means[1], rtol=0, atol=0, equal_nan=True)


def recorded(call):
    timings.reset()
    timings.start_spans()
    try:
        out = call()
    finally:
        records = timings.stop_spans()
    counters = timings.counters()
    timings.reset()
    return out, records, counters


@pytest.mark.parametrize("target", ["mesh", "raster"])
def test_wrap_span_nests_in_regrid_after_apply(target):
    """``regrid.wrap`` is the last child of the ``regrid`` root, after
    ``regrid.apply``; onto a mesh it counts the 8-byte position
    coordinates of the faces, onto a raster nothing."""
    mesh, raster, pool = forcing_case("aligned", True, 0.01)
    grid = common.port_grid(xt, mesh)
    if target == "mesh":
        source = raster_array(raster, pool)
        regridder = xt.OverlapRegridder(source, grid)
    else:
        values = torch.from_numpy(np.random.default_rng(5).normal(size=(3, grid.n_face)).astype(np.float32))
        source = xt.UgridDataArray(xt.xdata.DataArray(values, dims=("time", grid.face_dimension)), grid)
        regridder = xt.OverlapRegridder(source, common.port_raster(xt, raster))
    regridder.regrid(source, device="cpu")  # the weights uploaded before the recording
    out, records, counters = recorded(lambda: regridder.regrid(source, device="cpu"))
    by_id = {r.id: r for r in records}
    root = records[0]
    assert root.name == "regrid" and root.parent == -1
    children = [r.name for r in records if r.parent == root.id]
    assert children == ["regrid.apply", "regrid.wrap"]
    wrap = next(r for r in records if r.name == "regrid.wrap")
    apply = next(r for r in records if r.name == "regrid.apply")
    assert apply.end_ns <= wrap.start_ns <= wrap.end_ns <= root.end_ns
    assert by_id[wrap.parent] is root
    expected = 8 * grid.n_face if target == "mesh" else 0
    assert wrap.counts.get("wrap.coord_bytes", 0) == expected
    assert counters.get("wrap.coord_bytes", 0) == expected
    assert isinstance(out, xt.UgridDataArray) == (target == "mesh")


def test_wrap_records_nothing_while_recording_is_off():
    mesh, raster, pool = forcing_case("aligned", True, 0.0)
    source = raster_array(raster, pool)
    regridder = xt.OverlapRegridder(source, common.port_grid(xt, mesh))
    timings.reset()
    regridder.regrid(source, device="cpu")
    assert timings.stop_spans() == [] and timings.counters() == {}
