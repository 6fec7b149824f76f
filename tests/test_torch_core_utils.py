"""
The port's ``xugrid_tpu_torch.core.utils`` held on the CPU against the
JAX package's ``xugrid_tpu.core.utils``, after ``tests/test_core_utils.py``.
"""

import numpy as np
import pytest

import xugrid_tpu as xu
import xugrid_tpu.core.utils as jax_utils
import xugrid_tpu_torch as xt
import xugrid_tpu_torch.core.utils as torch_utils


@pytest.mark.parametrize(
    "positional, keywords",
    [({"x": 1}, {}), (None, {"x": 1}), (None, {}), ({"x": 1}, {"y": 2})],
)
def test_either_dict_or_kwargs_matches_jax(positional, keywords):
    results = []
    for utils in (jax_utils, torch_utils):
        try:
            results.append(utils.either_dict_or_kwargs(positional, keywords, "sel"))
        except ValueError as e:
            results.append(("ValueError", str(e)))
    assert results[0] == results[1]


def test_uncached_accessor():
    class Accessor:
        def __init__(self, obj):
            self.obj = obj

    class Host:
        acc = torch_utils.UncachedAccessor(Accessor)

    host = Host()
    first, second = host.acc, host.acc
    assert first is not second and first.obj is host
    assert Host.acc is Accessor


def test_unique_grids_matches_jax():
    picked = {}
    for name, pkg, utils in (("jax", xu, jax_utils), ("torch", xt, torch_utils)):
        grid = pkg.Ugrid2d(np.array([0.0, 1.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0, 1.0]), -1, np.array([[0, 1, 2, 3]]))
        same = pkg.Ugrid2d(grid.node_x, grid.node_y, -1, grid.face_node_connectivity)
        other = grid.rename("other")
        grids = [grid, same, other, same]
        picked[name] = [grids.index(g) for g in utils.unique_grids(grids)]
    assert picked["torch"] == picked["jax"] == [0, 2]
