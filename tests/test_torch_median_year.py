"""
The port's labelled median upscaling (``OverlapRegridder(method="median")``
of a (time, layer, face) UgridDataArray onto a raster DataArray), and
its p5 and p95, held on the CPU to the benchmark's plain reference,
``portbench/reference/select.py``, on seeded payloads over small meshes
of 250 m faces: onto a 1 km map aligned with them (windows of 16 faces)
and onto one shifted by a part of a face (ragged windows of up to 25),
with no NaN, 1 % NaN, and a window all NaN.

Tolerances: the port ranks float32 values exactly and interpolates
between the two closest in float32, ``lower * (1 - m) + upper * m``;
the reference does the same in float64.  For the median (m = 1/2, both
products exact) the port's result is the reference's rounded once, at
most half a float32 ulp of the largest value.  For the other
percentiles m is itself rounded in float32 and the products and the sum
are rounded, at most 4 ulps in all.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import xugrid_tpu_torch as xt
from portbench import inputs
from portbench.generators import common
from portbench.reference import overlap, select

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
#: The 1 km map's origin moved by half a face in x and a third of one in y.
SHIFTS = {"aligned": (0.0, 0.0), "shifted": (125.0, -90.0)}
METHODS = {"p5": 5.0, "median": 50.0, "p95": 95.0}


def lhm_case(kind, nan, nx=16, ny=20, time=3, layer=2, seed=2147483659):
    """A quad mesh of 250 m faces, its 1 km map and a (time, layer, face)
    float32 payload; ``nan`` "window" adds to 1 % NaN every face of the
    map's cell 5."""
    mesh = inputs.quad_mesh(nx, ny, 250.0, (0.0, 300000.0))
    raster = inputs.raster(mesh.bounds, 1000.0, SHIFTS[kind])
    share = 0.01 if nan == "window" else nan
    pool = inputs.payload_pool(time * layer, len(mesh.faces), share, seed, CPU)
    window = select.windows(overlap.overlap_triplets(mesh.nodes, mesh.faces, raster, CPU), raster.size)
    if nan == "window":
        faces = window[5]
        pool[:, faces[faces >= 0]] = math.nan
    return mesh, raster, pool.reshape(time, layer, -1), window


def labelled_regrid(mesh, raster, payload, method):
    grid = common.port_grid(xt, mesh)
    uda = xt.UgridDataArray(xt.xdata.DataArray(payload, dims=("time", "layer", grid.face_dimension)), grid)
    out = xt.OverlapRegridder(uda, common.port_raster(xt, raster), method=method).regrid(uda)
    assert out.dims == ("time", "layer", "y", "x") and out.shape == payload.shape[:2] + (raster.ny, raster.nx)
    assert np.array_equal(out["x"].values, raster.x) and np.array_equal(out["y"].values, raster.y)
    assert out.data.device == CPU and out.data.dtype == torch.float32
    return out.data.reshape(payload.shape[0] * payload.shape[1], -1)


def assert_matches(got, expected, p):
    """NaN in the same places; elsewhere within the module's tolerance."""
    assert torch.equal(torch.isnan(got), torch.isnan(expected))
    valid = ~torch.isnan(expected)
    ulp = float(np.spacing(np.float32(expected[valid].abs().max())))
    atol = 0.5 * ulp if p == 50.0 else 4 * ulp
    torch.testing.assert_close(got.double()[valid], expected[valid], rtol=0, atol=atol)


@pytest.mark.parametrize("nan", [0.0, 0.01, "window"], ids=["no_nan", "nan_1pct", "nan_window"])
@pytest.mark.parametrize("kind", sorted(SHIFTS))
def test_labelled_median_matches_the_reference(kind, nan):
    mesh, raster, payload, window = lhm_case(kind, nan)
    widths = (window >= 0).sum(dim=1)
    assert int(widths.max()) == (16 if kind == "aligned" else 25)
    got = labelled_regrid(mesh, raster, payload, "median")
    expected = select.percentile(window, payload.reshape(got.shape[0], -1), 50.0)
    assert_matches(got, expected, 50.0)
    assert bool(torch.isnan(got[:, 5]).all()) == (nan == "window")


@pytest.mark.parametrize("kind", sorted(SHIFTS))
@pytest.mark.parametrize("method", sorted(METHODS))
def test_percentiles_beside_the_median_match_the_reference(method, kind):
    mesh, raster, payload, window = lhm_case(kind, 0.01, seed=2147483701)
    got = labelled_regrid(mesh, raster, payload, method)
    expected = select.percentile(window, payload.reshape(got.shape[0], -1), METHODS[method])
    assert_matches(got, expected, METHODS[method])


@pytest.mark.parametrize("method", sorted(METHODS))
def test_odd_and_even_counts_of_valid_values(method):
    """Cell t of the aligned 4 x 5 map keeps 16 - t % 16 of its faces
    valid (16 down to 1, odd and even): the port, the reference and
    numpy's ``nanpercentile`` over the cell's 4 x 4 faces agree."""
    p = METHODS[method]
    mesh, raster, payload, window = lhm_case("aligned", 0.0, time=2, layer=1)
    values = payload.reshape(2, -1)
    for t in range(raster.size):
        faces = window[t]
        values[:, faces[: t % 16]] = math.nan
    got = labelled_regrid(mesh, raster, payload, method)
    expected = select.percentile(window, values, p)
    assert_matches(got, expected, p)
    # Row 0 of the map is north: cell (row, col) holds faces of rows
    # 4 (ny / 4 - 1 - row) onwards and columns 4 col onwards.
    by_face = values.double().numpy().reshape(2, 20, 16)
    for t in range(raster.size):
        row, col = divmod(t, raster.nx)
        block = by_face[:, 4 * (raster.ny - 1 - row) : 4 * (raster.ny - row), 4 * col : 4 * col + 4].reshape(2, 16)
        assert int((~np.isnan(block[0])).sum()) == 16 - t % 16
        np.testing.assert_allclose(expected[:, t].numpy(), np.nanpercentile(block, p, axis=1), rtol=0, atol=1e-12)


def test_reference_one_precision_below_float32_departs():
    """The control of the benchmark's limit (1e-5 of the largest value):
    the reference in bfloat16 and in float16 misses it, in float32 it
    keeps it."""
    mesh, raster, payload, window = lhm_case("shifted", 0.01)
    values = payload.reshape(6, -1)
    exact = select.percentile(window, values, 50.0)
    scale = float(exact[~torch.isnan(exact)].abs().max())

    def rel_err(dtype):
        low = select.percentile(window, values, 50.0, dtype)
        assert torch.equal(torch.isnan(low), torch.isnan(exact))
        valid = ~torch.isnan(exact)
        return float((low[valid] - exact[valid]).abs().max()) / scale

    assert rel_err(torch.bfloat16) > 1e-3
    assert rel_err(torch.float16) > 1e-4
    assert rel_err(torch.float32) < 1e-7


def test_reference_windows_hold_every_positive_overlap_once():
    mesh, raster, _, window = lhm_case("shifted", 0.0)
    target, source, _ = overlap.overlap_triplets(mesh.nodes, mesh.faces, raster, CPU)
    pairs = {(int(t), int(s)) for t, s in zip(target, source)}
    held = {(t, int(s)) for t in range(raster.size) for s in window[t] if s >= 0}
    assert held == pairs and len(pairs) == len(target)


def test_reference_loads_neither_the_port_nor_jax():
    probe = (
        "import json, sys; import portbench.reference.select; "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, check=True, timeout=300)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded and not loaded & {"jax", "jaxlib", "xugrid_tpu", "xugrid_tpu_torch"}
