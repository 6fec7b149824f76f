"""
The port's flat BVH build (``xugrid_tpu_torch/spatial/bvh.py``) held to
``xugrid_tpu.spatial.bvh`` on the CPU: ``node_bbox``, ``skip``,
``prim_index``, ``n_leaves`` and ``leaf_size`` bit-equal on quad grids,
jittered meshes, NaN boxes and primitive counts that no leaf size
divides; ``morton_order`` and ``kd_order`` equal, through the native
host library and through the numpy branch of both packages.
"""

import numpy as np
import pytest

import xugrid_tpu.utils.native as jax_native
import xugrid_tpu_torch.utils.native as torch_native
from xugrid_tpu.spatial import bvh as jax_bvh
from xugrid_tpu_torch.spatial import BVH, build_bvh
from xugrid_tpu_torch.spatial import bvh as torch_bvh
from tests.test_torch_spatial_queries import jittered_mesh


def quad_boxes(n):
    x = np.arange(float(n))
    yy, xx = np.meshgrid(x, x, indexing="ij")
    lo = np.column_stack([xx.ravel(), yy.ravel()])
    return np.column_stack([lo, lo + 1.0])


def jittered_boxes(n, seed):
    verts, faces = jittered_mesh(n, np.random.default_rng(seed))
    return torch_bvh.face_bounding_boxes(faces, verts[:, 0], verts[:, 1])


def nan_boxes():
    boxes = jittered_boxes(9, 4)
    boxes[[0, 5, 40, 41]] = np.nan
    return boxes


CASES = {
    "quads 16x16": lambda: quad_boxes(16),
    "quads 5x5": lambda: quad_boxes(5),
    "jittered 11x11": lambda: jittered_boxes(11, 1),
    "jittered 30x30": lambda: jittered_boxes(30, 2),
    "NaN boxes": nan_boxes,
    "one primitive": lambda: np.array([[0.0, 0.0, 1.0, 2.0]]),
}


@pytest.fixture(params=["native", "numpy"])
def branch(request, monkeypatch):
    """Both packages' kd order through the native library, or both
    through their numpy branch."""
    if request.param == "numpy":
        monkeypatch.setattr(jax_native, "kd_order_native", lambda *args: None)
        monkeypatch.setattr(torch_native, "kd_order_native", lambda *args: None)
    else:
        assert torch_native.get_lib() is not None
    return request.param


@pytest.mark.parametrize("leaf_size", [1, 4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_build_bvh_bit_equal(case, leaf_size, branch):
    boxes = CASES[case]()
    want = jax_bvh.build_bvh(boxes, leaf_size)
    got = build_bvh(boxes, leaf_size)
    assert isinstance(got, BVH)
    for field in ("node_bbox", "skip", "prim_index"):
        a, b = getattr(want, field), getattr(got, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(b, a, err_msg=field)
    assert (got.n_leaves, got.leaf_size, got.n_nodes, got.n_internal) == (
        want.n_leaves, want.leaf_size, want.n_nodes, want.n_internal
    )


def test_build_bvh_refuses_no_primitives():
    with pytest.raises(ValueError):
        build_bvh(np.empty((0, 4)))


@pytest.mark.parametrize("n_levels, capacity", [(3, 64), (6, 512), (0, 16)])
def test_kd_order_equal(n_levels, capacity, branch):
    xy = np.random.default_rng(n_levels).uniform(0.0, 10.0, (capacity - 5, 2))
    xy[3] = xy[4]  # a tie
    np.testing.assert_array_equal(torch_bvh.kd_order(xy, n_levels, capacity), jax_bvh.kd_order(xy, n_levels, capacity))


def test_kd_order_native_binding():
    xy = np.random.default_rng(0).uniform(0.0, 1.0, (100, 2))
    np.testing.assert_array_equal(torch_native.kd_order_native(xy, 4, 128), jax_native.kd_order_native(xy, 4, 128))


@pytest.mark.parametrize("bounds", [None, (-1.0, -1.0, 11.0, 11.0)])
def test_morton_order_equal(bounds):
    rng = np.random.default_rng(8)
    xy = rng.uniform(0.0, 10.0, (500, 2))
    np.testing.assert_array_equal(torch_bvh.morton_order(xy, bounds), jax_bvh.morton_order(xy, bounds))
    x, y = rng.integers(0, 1 << 16, 50), rng.integers(0, 1 << 16, 50)
    np.testing.assert_array_equal(torch_bvh.morton_encode2d(x, y), jax_bvh.morton_encode2d(x, y))


def test_celltree_bounds_distances_and_chunk_equal():
    from xugrid_tpu.spatial import CellTree2d as JaxCellTree2d, EdgeCellTree2d as JaxEdgeCellTree2d
    from xugrid_tpu_torch.spatial import CellTree2d, EdgeCellTree2d

    verts, faces = jittered_mesh(6, np.random.default_rng(9))
    want, got = JaxCellTree2d(verts, faces), CellTree2d(verts, faces)
    np.testing.assert_array_equal(got.bb_distances, want.bb_distances)
    assert got.bounds == want.bounds and got.CHUNK == want.CHUNK
    edges = faces[:, :2]
    want, got = JaxEdgeCellTree2d(verts, edges), EdgeCellTree2d(verts, edges)
    np.testing.assert_array_equal(got.bb_distances, want.bb_distances)
    assert got.CHUNK == want.CHUNK
