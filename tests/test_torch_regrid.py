"""
The port's main path, the overlap regridders, held on the CPU against
the JAX package's: one jittered 40 x 40 quad mesh regridded onto a
24 x 24 raster by both packages.

Both build the weights with the same C++ (csrc/host_kernels.cpp), so the
weight triplets must be identical.  The regridded values must agree at
rtol 1e-12 in float64 (only the summation order differs; see
tests/test_torch_reduce.py), for every built-in method of both
regridders, on a (3, n_face) source with 10 % NaN.
"""

import numpy as np
import pytest
import torch

import xugrid_tpu as xu
import xugrid_tpu_torch as xt
from tests.test_torch_reduce import assert_matches
from xugrid_tpu import xdata
from xugrid_tpu_torch.regrid import regridder as torch_regridder
from xugrid_tpu_torch.regrid.aligned_apply import window_reduce
from xugrid_tpu_torch.regrid.select_apply import window_select

N_SIDE, T_SIDE = 40, 24


def quad_mesh(nx, ny, dx=1.0):
    x = np.arange(nx + 1.0) * dx
    y = np.arange(ny + 1.0) * dx
    yy, xx = np.meshgrid(y, x, indexing="ij")
    verts = np.column_stack([xx.ravel(), yy.ravel()])
    j, i = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    nid = lambda ii, jj: jj * (nx + 1) + ii  # noqa: E731
    faces = np.stack(
        [nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)], axis=-1
    ).reshape(-1, 4)
    return verts, faces


@pytest.fixture(scope="module")
def meshes():
    rng = np.random.default_rng(42)
    verts, faces = quad_mesh(N_SIDE, N_SIDE)
    jitter = rng.uniform(-0.15, 0.15, verts.shape)
    edge = (verts == 0).any(axis=1) | (verts == N_SIDE).any(axis=1)
    jitter[edge] = 0.0
    verts = verts + jitter
    tverts, tfaces = quad_mesh(T_SIDE, T_SIDE, dx=N_SIDE / T_SIDE)
    source = rng.normal(size=(3, len(faces)))
    source[:, : len(faces) // 2] = np.round(source[:, : len(faces) // 2] * 2.0) / 2.0
    source[rng.random(source.shape) < 0.10] = np.nan
    return {
        "jax": (xu.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces),
                xu.Ugrid2d(tverts[:, 0], tverts[:, 1], -1, tfaces)),
        "torch": (xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces),
                  xt.Ugrid2d(tverts[:, 0], tverts[:, 1], -1, tfaces)),
        "source": source,
    }


CASES = [("OverlapRegridder", m) for m in sorted(xt.OverlapRegridder._METHODS)] + [
    ("RelativeOverlapRegridder", m) for m in sorted(xt.RelativeOverlapRegridder._METHODS)
]


def jax_regrid(regridder, grid, source):
    da = xdata.DataArray(source, dims=("time", grid.face_dimension))
    return np.asarray(regridder.regrid(xu.UgridDataArray(da, grid)).values)


def gathered(weights, source):
    """(n, E, w) windows and (n, 1, w) weights of a CSR weight matrix."""
    rows = np.diff(weights.indptr)
    w = max(int(rows.max()), 1)
    slot = np.arange(w)[None, :] < rows[:, None]
    idx = np.full(slot.shape, -1)
    idx[slot] = weights.indices
    wts = np.zeros(slot.shape)
    wts[slot] = weights.data
    values = np.where(idx[None] < 0, np.nan, source[:, np.maximum(idx, 0)])
    return np.moveaxis(values, 0, 1), wts[:, None, :]


@pytest.mark.parametrize("cls", ["OverlapRegridder", "RelativeOverlapRegridder"])
def test_weight_triplets_identical(meshes, cls):
    jr = getattr(xu, cls)(*meshes["jax"])
    tr = getattr(xt, cls)(*meshes["torch"])
    jw, tw = jr._weights, tr._weights
    assert (jw.n, jw.m, jw.nnz) == (tw.n, tw.m, tw.nnz)
    np.testing.assert_array_equal(tw.indptr, jw.indptr)
    np.testing.assert_array_equal(tw.indices, jw.indices)
    np.testing.assert_array_equal(tw.data, jw.data)


@pytest.mark.parametrize("cls, method", CASES)
def test_regrid_matches_jax(meshes, cls, method):
    source = meshes["source"]
    jr = getattr(xu, cls)(*meshes["jax"], method=method)
    tr = getattr(xt, cls)(*meshes["torch"], method=method)
    launches = (window_reduce.launches, window_select.launches)
    got = tr.regrid(source, device="cpu")
    assert (window_reduce.launches, window_select.launches) == launches
    assert isinstance(got, torch.Tensor) and got.shape == (3, T_SIDE * T_SIDE)
    want = jax_regrid(jr, meshes["jax"][0], source)
    values, weights = gathered(tr._weights, source)
    assert_matches(got.numpy().T, want.T, method, values, weights)
    # The same weights carried across from the JAX regridder.
    w = jr._weights
    carried = getattr(xt, cls).from_csr_arrays(
        w.data, w.indices, w.indptr, w.n, w.m, meshes["torch"][1], method
    )
    torch.testing.assert_close(carried.regrid(source, device="cpu"), got, rtol=0, atol=0, equal_nan=True)


def test_regrid_keeps_leading_dims_and_chunks(meshes, monkeypatch):
    source = meshes["source"]
    tr = xt.OverlapRegridder(*meshes["torch"], method="mean")
    whole = tr.regrid(torch.from_numpy(source))
    stacked = torch.from_numpy(np.stack([source, 2.0 * source]))  # (2, 3, n_face)
    per_slice = stacked.element_size() * (tr._weights.m + tr._weights.n)
    monkeypatch.setattr(torch_regridder, "APPLY_CHUNK_BYTES", 2 * per_slice)
    out = tr.regrid(stacked)
    assert out.shape == (2, 3, T_SIDE * T_SIDE)
    torch.testing.assert_close(out[0], whole, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(out[1], 2.0 * whole, rtol=1e-15, atol=0, equal_nan=True)
    assert len(tr._device_weights) == 1


def test_regrid_rejects_bad_input(meshes):
    tr = xt.OverlapRegridder(*meshes["torch"])
    with pytest.raises(ValueError, match="does not match"):
        tr.regrid(np.zeros((2, 7)), device="cpu")
    with pytest.raises(ValueError, match="Invalid regridding method"):
        xt.OverlapRegridder(*meshes["torch"], method="first_order_conservative")
    empty = tr.regrid(np.zeros((0, N_SIDE * N_SIDE)), device="cpu")
    assert empty.shape == (0, T_SIDE * T_SIDE)


def test_regrid_runs_on_the_card_by_default(meshes):
    """A numpy source goes to the CUDA card unless the caller asks for
    the CPU; without a card that is an error, not a CPU fallback.  A CPU
    tensor stays on the CPU."""
    source = meshes["source"]
    tr = xt.OverlapRegridder(*meshes["torch"], method="mean")
    if torch.cuda.is_available():
        assert tr.regrid(source).device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tr.regrid(source)
    assert tr.regrid(torch.from_numpy(source)).device == torch.device("cpu")


def test_custom_percentile_method(meshes):
    source = meshes["source"]
    p33 = xt.OverlapRegridder.create_percentile_method(33.3)
    tr = xt.OverlapRegridder(*meshes["torch"], method=p33)
    jr = xu.OverlapRegridder(
        *meshes["jax"], method=xu.OverlapRegridder.create_percentile_method(33.3)
    )
    want = jax_regrid(jr, meshes["jax"][0], source)
    values, weights = gathered(tr._weights, source)
    assert_matches(tr.regrid(source, device="cpu").numpy().T, want.T, "p33.3", values, weights)


def test_host_fallbacks_match_native(meshes, monkeypatch):
    """Without the native host library the weight build's numpy
    fallbacks give the same boxes, candidate pairs, polygons and CSR;
    the exact overlap areas need the library and say so."""
    from xugrid_tpu_torch.core.sparse import MatrixCOO
    from xugrid_tpu_torch.spatial.bvh import face_bounding_boxes
    from xugrid_tpu_torch.spatial.celltree import CellTree2d
    from xugrid_tpu_torch.spatial.geometry import pad_polygons
    from xugrid_tpu_torch.spatial.grid_hash import GridHash
    from xugrid_tpu_torch.utils import native

    source, target = meshes["torch"]
    conn, x, y = target.face_node_connectivity, target.node_x, target.node_y
    rng = np.random.default_rng(5)
    row, col = rng.integers(0, 50, 400), rng.integers(0, 70, 400)
    coo = MatrixCOO.from_triplet(row, col, rng.random(400), n=50, m=70)

    def build():
        boxes = face_bounding_boxes(conn, x, y)
        q, p = GridHash(source.celltree.bb_coords).query_boxes(boxes)
        order = np.lexsort((p, q))
        return boxes, q[order], p[order], pad_polygons(conn, x, y), coo.to_csr()

    assert native.get_lib() is not None
    with_lib = build()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    without = build()
    for a, b in zip(with_lib[:4], without[:4]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(with_lib[4], without[4]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="native host library"):
        CellTree2d(source.node_coordinates, source.face_node_connectivity).intersect_faces(
            target.node_coordinates, conn
        )


# Slabs written in place: a stack over the apply budget streams through
# slabs, each written into its rows of one output allocated once.


def window_range(values, weights):
    """A custom reduction: each window's largest value less its smallest
    (NaN where the window holds none)."""
    nan = torch.isnan(values)
    hi = torch.where(nan, -torch.inf, values).amax(-1)
    lo = torch.where(nan, torch.inf, values).amin(-1)
    return torch.where(torch.isfinite(hi), hi - lo, torch.nan)


IN_PLACE_METHODS = {"mean": "mean", "median": "median", "custom": window_range}


def stacked_source(meshes, copies=3):
    """(3 * copies, n_face) float64: the mesh source and its multiples."""
    source = meshes["source"]
    return torch.from_numpy(np.concatenate([source * (k + 1) for k in range(copies)]))


def slab_budget(monkeypatch, regridder, itemsize, per_slab):
    """Make ``regridder`` apply stacks in slabs of ``per_slab`` slices."""
    per_slice = itemsize * (regridder._weights.m + regridder._weights.n)
    monkeypatch.setattr(torch_regridder, "APPLY_CHUNK_BYTES", per_slab * per_slice)


def in_place_slabs(regrid):
    """``regrid()`` with spans recorded: (its result, slabs written in place)."""
    from xugrid_tpu_torch.utils.profiling import timings

    timings.reset()
    timings.start_spans()
    try:
        out = regrid()
    finally:
        timings.stop_spans()
    slabs = timings.counters().get("apply.slabs_in_place", 0)
    timings.reset()
    return out, slabs


@pytest.mark.parametrize("method", sorted(IN_PLACE_METHODS))
def test_slabs_written_in_place_equal_one_slab(meshes, monkeypatch, method):
    """window_reduce (mean), window_select (median) and a custom
    reduction: 9 slices in slabs of 2, 2, 2, 2, 1, each written in place,
    give the bits of the stack applied in one slab."""
    tr = xt.OverlapRegridder(*meshes["torch"], method=IN_PLACE_METHODS[method])
    source = stacked_source(meshes)
    whole, slabs = in_place_slabs(lambda: tr.regrid(source))
    assert slabs == 0
    slab_budget(monkeypatch, tr, source.element_size(), 2)
    sliced, slabs = in_place_slabs(lambda: tr.regrid(source))
    assert slabs == 5
    assert sliced.shape == (9, T_SIDE * T_SIDE) and sliced.is_contiguous() and sliced.dtype == torch.float64
    torch.testing.assert_close(sliced, whole, rtol=0, atol=0, equal_nan=True)


def test_integer_source_in_slabs_comes_back_float64(meshes, monkeypatch):
    tr = xt.OverlapRegridder(*meshes["torch"], method="mean")
    values = np.round(np.nan_to_num(meshes["source"]) * 4.0)
    source = torch.from_numpy(np.concatenate([values, -values]).astype(np.int32))
    whole = tr.regrid(source.double())
    slab_budget(monkeypatch, tr, source.element_size(), 2)
    sliced, slabs = in_place_slabs(lambda: tr.regrid(source))
    assert slabs == 3 and sliced.dtype == torch.float64
    torch.testing.assert_close(sliced, whole, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("method", sorted(IN_PLACE_METHODS))
def test_apply_weights_writes_only_the_rows_of_out(meshes, method):
    """``out`` a view of rows 2-4 of a larger buffer: the result lands
    there, bit-equal to the apply's own output, and the sentinel rows on
    either side stay as they were."""
    from xugrid_tpu_torch.regrid.apply import apply_weights

    tr = xt.OverlapRegridder(*meshes["torch"], method=IN_PLACE_METHODS[method])
    source, n = torch.from_numpy(meshes["source"]), tr._weights.n
    buffer = torch.full((7, n), -7.5, dtype=torch.float64)
    view = buffer[2:5]
    got = apply_weights(tr._padded, source, tr._reduction, n, out=view)
    assert got.data_ptr() == view.data_ptr() and got.shape == (3, n)
    want = apply_weights(tr._padded, source, tr._reduction, n)
    torch.testing.assert_close(view, want, rtol=0, atol=0, equal_nan=True)
    assert bool((buffer[:2] == -7.5).all()) and bool((buffer[5:] == -7.5).all())


OUT_FAULTS = {
    "shape": (lambda n: torch.empty((4, n), dtype=torch.float64), ValueError, "shape"),
    "dtype": (lambda n: torch.empty((3, n), dtype=torch.float32), TypeError, "dtype"),
    "strides": (lambda n: torch.empty((n, 3), dtype=torch.float64).t(), ValueError, "contiguous"),
    "not_a_tensor": (lambda n: np.empty((3, n)), TypeError, "tensor"),
}


@pytest.mark.parametrize("fault", sorted(OUT_FAULTS))
@pytest.mark.parametrize("method", sorted(IN_PLACE_METHODS))
def test_apply_weights_rejects_a_wrong_out(meshes, method, fault):
    from xugrid_tpu_torch.regrid.apply import apply_weights

    tr = xt.OverlapRegridder(*meshes["torch"], method=IN_PLACE_METHODS[method])
    make, error, match = OUT_FAULTS[fault]
    source, n = torch.from_numpy(meshes["source"]), tr._weights.n
    with pytest.raises(error, match=match):
        apply_weights(tr._padded, source, tr._reduction, n, out=make(n))
