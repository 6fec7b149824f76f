"""
The port's meshkernel bridge held to the JAX package's
(``tests/test_meshkernel_utils.py``'s four cases): the enum coercion,
the stand-in module that raises on use, and the gated conversions, which
skip where meshkernel or shapely is missing.  Without meshkernel every
gated grid method raises the JAX package's exception type, and
``from_meshkernel`` of a mesh object builds the same grid in both.
"""

import enum
import types

import numpy as np
import pytest

import xugrid_tpu as xu
import xugrid_tpu_torch as xt
from tests import has_meshkernel, requires_meshkernel, requires_shapely
from xugrid_tpu_torch import meshkernel_utils


class FakeEnum(enum.Enum):
    WACHSPRESS = 1
    MEAN_VALUE = 2


def test_either_string_or_enum():
    f = meshkernel_utils.either_string_or_enum
    assert f("wachspress", FakeEnum) is FakeEnum.WACHSPRESS
    assert f("MEAN_VALUE", FakeEnum) is FakeEnum.MEAN_VALUE
    assert f(FakeEnum.WACHSPRESS, FakeEnum) is FakeEnum.WACHSPRESS
    with pytest.raises(ValueError, match="Invalid option"):
        f("nonsense", FakeEnum)
    with pytest.raises(TypeError, match="Expected str or FakeEnum"):
        f(123, FakeEnum)


def test_missing_module_raises_on_use():
    from xugrid_tpu_torch.constants import MissingOptionalModule

    if not isinstance(meshkernel_utils.mk, MissingOptionalModule):
        pytest.skip("meshkernel installed")
    with pytest.raises(ImportError, match="meshkernel"):
        meshkernel_utils.mk.GeometryList


@requires_shapely
@requires_meshkernel
def test_to_geometry_list():
    import shapely

    square = shapely.Polygon([(0, 0), (1, 0), (1, 1), (0, 1)])
    gl = meshkernel_utils.to_geometry_list(square)
    assert len(gl.x_coordinates) == 5


@requires_meshkernel
def test_ugrid2d_meshkernel_bridge():
    grid = xt.Ugrid2d(np.array([0.0, 1.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0, 1.0]), -1, np.array([[0, 1, 2, 3]]))
    mesh = grid.mesh
    assert mesh.node_x.size == 4
    back = xt.Ugrid2d.from_meshkernel(mesh)
    assert back.n_face == 1


def _square(pkg):
    return pkg.Ugrid2d(np.array([0.0, 1.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0, 1.0]), -1, np.array([[0, 1, 2, 3]]))


def _line(pkg):
    return pkg.Ugrid1d(np.array([0.0, 1.0, 2.0]), np.array([0.0, 1.0, 0.0]), -1, np.array([[0, 1], [1, 2]]))


GATED = {
    "Ugrid2d.mesh": lambda pkg: _square(pkg).mesh,
    "Ugrid2d.meshkernel": lambda pkg: _square(pkg).meshkernel,
    "Ugrid2d.refine_polygon": lambda pkg: _square(pkg).refine_polygon(None, 0.1),
    "Ugrid2d.delete_polygon": lambda pkg: _square(pkg).delete_polygon(None),
    "Ugrid2d.from_polygon": lambda pkg: pkg.Ugrid2d.from_polygon(None),
    "Ugrid1d.mesh": lambda pkg: _line(pkg).mesh,
    "Ugrid1d.meshkernel": lambda pkg: _line(pkg).meshkernel,
}


@pytest.mark.parametrize("name", sorted(GATED))
def test_gated_methods_raise_as_jax(name, monkeypatch):
    import sys

    if has_meshkernel:
        pytest.skip("meshkernel installed")
    monkeypatch.setitem(sys.modules, "meshkernel", None)
    raised = {}
    for pkg in (xu, xt):
        with pytest.raises(Exception) as info:
            GATED[name](pkg)
        raised[pkg] = type(info.value)
    assert raised[xt] is raised[xu]
    assert issubclass(raised[xt], ImportError)


def test_from_meshkernel_matches_jax():
    """A Mesh2d and a Mesh1d stand-in (meshkernel's attribute names)."""
    mesh2d = types.SimpleNamespace(
        node_x=np.array([0.0, 1.0, 1.0, 0.0, 2.0]),
        node_y=np.array([0.0, 0.0, 1.0, 1.0, 0.5]),
        edge_nodes=np.array([0, 1, 1, 2, 2, 3, 3, 0, 1, 4, 4, 2], np.int32),
        face_nodes=np.array([0, 1, 2, 3, 1, 4, 2], np.int32),
        nodes_per_face=np.array([4, 3], np.int32),
    )
    mesh1d = types.SimpleNamespace(
        node_x=np.array([0.0, 1.0, 2.0]), node_y=np.array([0.0, 1.0, 0.0]),
        edge_nodes=np.array([0, 1, 1, 2], np.int32),
    )
    for cls, mesh in (("Ugrid2d", mesh2d), ("Ugrid1d", mesh1d)):
        want = getattr(xu, cls).from_meshkernel(mesh, crs=None)
        got = getattr(xt, cls).from_meshkernel(mesh, crs=None)
        assert got.name == want.name
        for attr in ("node_x", "node_y", "edge_node_connectivity") + (
            ("face_node_connectivity",) if cls == "Ugrid2d" else ()
        ):
            np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))
