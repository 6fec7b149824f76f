"""
The topology operations of the port's ``.ugrid`` accessors held on the
CPU against the JAX package's: ``binary_dilation``/``binary_erosion``
(with and without ``mask=`` as an array, a tensor or a DataArray, both
``border_value``s), ``connected_components``, ``reverse_cuthill_mckee``,
``to_periodic``/``to_nonperiodic`` of a UgridDataArray on nodes, edges
and faces and of a UgridDataset, and ``set_node_coords``.  The same
seeded inputs go through both packages; results are equal exactly, and
a payload keeps its type (numpy or a CPU tensor) and device.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import xugrid_tpu as xu
import xugrid_tpu_torch as xt

PKGS = (xu, xt)
PAYLOADS = ["numpy", "tensor"]


def meshes():
    (verts, faces), _ = chip_smoke.bench_meshes(8, 2, np.random.default_rng(21))
    # Two separate squares of 2 x 2 quads: two components.
    left, lfaces = chip_smoke.quad_mesh(2, 2)
    right = left + [5.0, 0.0]
    pieces = (np.concatenate([left, right]), np.concatenate([lfaces, lfaces + len(left)]))
    return {"jittered": (verts, faces), "two_pieces": pieces}


MESHES = meshes()


def pair(mesh):
    verts, faces = MESHES[mesh]
    return [pkg.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces) for pkg in PKGS]


def udas(mesh, values, dims, payload):
    """The same values as a UgridDataArray of each package; the port's
    payload numpy or a CPU tensor."""
    out = []
    for pkg, grid in zip(PKGS, pair(mesh)):
        data = torch.from_numpy(values) if pkg is xt and payload == "tensor" else values
        dims_ = tuple(getattr(grid, d) if d.endswith("_dimension") else d for d in dims)
        out.append(pkg.UgridDataArray(pkg.xdata.DataArray(data, dims=dims_, name="v"), grid))
    return out


def assert_payload(got, want, payload):
    assert isinstance(got.data, torch.Tensor) == (payload == "tensor")
    if payload == "tensor":
        assert got.data.device == torch.device("cpu")
    np.testing.assert_array_equal(got.values, np.asarray(want.values))
    assert got.dims == want.dims


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("op", ["binary_dilation", "binary_erosion"])
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("mask", [None, "numpy", "tensor", "dataarray"])
@pytest.mark.parametrize("border_value", [False, True])
def test_binary_morphology_matches_jax(mesh, op, payload, mask, border_value):
    jgrid, _ = pair(mesh)
    rng = np.random.default_rng(5)
    values = rng.random(jgrid.n_face) < (0.25 if op == "binary_dilation" else 0.75)
    juda, tuda = udas(mesh, values, ("face_dimension",), payload)
    jmask = tmask = None
    if mask is not None:
        mask_values = rng.random(jgrid.n_face) < 0.2
        jmask = mask_values
        if mask == "numpy":
            tmask = mask_values
        elif mask == "tensor":
            tmask = torch.from_numpy(mask_values)
        else:
            tmask = udas(mesh, mask_values, ("face_dimension",), "tensor")[1]
    want = getattr(juda.ugrid, op)(iterations=2, mask=jmask, border_value=border_value)
    got = getattr(tuda.ugrid, op)(iterations=2, mask=tmask, border_value=border_value)
    assert isinstance(got, xt.UgridDataArray)
    assert got.data.dtype == (torch.bool if payload == "tensor" else np.bool_)
    assert_payload(got, want, payload)
    assert got.ugrid.grid is not tuda.ugrid.grid
    np.testing.assert_array_equal(got.ugrid.grid.face_node_connectivity, tuda.ugrid.grid.face_node_connectivity)


@pytest.mark.parametrize("payload", PAYLOADS)
def test_binary_morphology_refuses_non_bool(payload):
    values = np.arange(pair("jittered")[0].n_face) % 2
    for uda in udas("jittered", values, ("face_dimension",), payload):
        with pytest.raises(TypeError, match="input dtype should be bool"):
            uda.ugrid.binary_dilation()


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("payload", PAYLOADS)
def test_connected_components_matches_jax(mesh, payload):
    jgrid, _ = pair(mesh)
    juda, tuda = udas(mesh, np.ones(jgrid.n_face), ("face_dimension",), payload)
    got = tuda.ugrid.connected_components()
    want = juda.ugrid.connected_components()
    assert_payload(got, want, payload)
    assert int(got.values.max()) + 1 == (2 if mesh == "two_pieces" else 1)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("payload", PAYLOADS)
def test_reverse_cuthill_mckee_matches_jax(mesh, payload):
    jgrid, _ = pair(mesh)
    values = np.random.default_rng(3).normal(size=(3, jgrid.n_face))
    juda, tuda = udas(mesh, values, ("time", "face_dimension"), payload)
    got = tuda.ugrid.reverse_cuthill_mckee()
    want = juda.ugrid.reverse_cuthill_mckee()
    assert_payload(got, want, payload)
    np.testing.assert_array_equal(got.ugrid.grid.face_node_connectivity, want.ugrid.grid.face_node_connectivity)


@pytest.mark.parametrize("facet", ["node", "edge", "face"])
@pytest.mark.parametrize("payload", PAYLOADS)
def test_dataarray_to_periodic_and_back_match_jax(facet, payload):
    jgrid, _ = pair("jittered")
    values = np.random.default_rng(4).normal(size=(2, getattr(jgrid, f"n_{facet}")))
    juda, tuda = udas("jittered", values, ("time", f"{facet}_dimension"), payload)
    got = tuda.ugrid.to_periodic()
    want = juda.ugrid.to_periodic()
    assert_payload(got, want, payload)
    np.testing.assert_array_equal(got.ugrid.grid.face_node_connectivity, want.ugrid.grid.face_node_connectivity)
    xmax = jgrid.bounds[2]
    back, want_back = got.ugrid.to_nonperiodic(xmax), want.ugrid.to_nonperiodic(xmax)
    assert_payload(back, want_back, payload)
    assert back.ugrid.grid.n_node == jgrid.n_node
    if facet == "face":
        np.testing.assert_array_equal(back.values, values)


@pytest.mark.parametrize("payload", PAYLOADS)
def test_dataset_to_periodic_and_back_match_jax(payload):
    jgrid, tgrid = pair("jittered")
    jgrid.edge_node_connectivity, tgrid.edge_node_connectivity
    rng = np.random.default_rng(6)
    values = {facet: rng.normal(size=getattr(jgrid, f"n_{facet}")) for facet in ("node", "edge", "face")}
    uds = []
    for pkg, grid in zip(PKGS, (jgrid, tgrid)):
        ds = pkg.xdata.Dataset()
        for facet, v in values.items():
            data = torch.from_numpy(v) if pkg is xt and payload == "tensor" else v
            ds[facet] = ((getattr(grid, f"{facet}_dimension"),), data)
        uds.append(pkg.UgridDataset(ds, [grid]))
    got, want = uds[1].ugrid.to_periodic(), uds[0].ugrid.to_periodic()
    xmax = jgrid.bounds[2]
    back, want_back = got.ugrid.to_nonperiodic(xmax), want.ugrid.to_nonperiodic(xmax)
    for g, w in ((got, want), (back, want_back)):
        assert isinstance(g, xt.UgridDataset)
        for facet in values:
            assert_payload(g[facet], w[facet], payload)
    assert back.ugrid.grid.n_edge == jgrid.n_edge


@pytest.mark.parametrize("kind", ["dataarray", "dataset"])
def test_set_node_coords_matches_jax(kind):
    grids = pair("jittered")
    for pkg, grid in zip(PKGS, grids):
        ds = pkg.xdata.Dataset()
        ds["v"] = ((grid.node_dimension,), np.zeros(grid.n_node))
        ds = ds.assign_coords(
            qx=pkg.xdata.DataArray(grid.node_x * 3.0, dims=(grid.node_dimension,)),
            qy=pkg.xdata.DataArray(grid.node_y + 1.0, dims=(grid.node_dimension,)),
        )
        obj = pkg.UgridDataArray(ds["v"], grid) if kind == "dataarray" else pkg.UgridDataset(ds, [grid])
        obj.ugrid.set_node_coords("qx", "qy")
    jgrid, tgrid = grids
    np.testing.assert_array_equal(tgrid.node_x, jgrid.node_x)
    np.testing.assert_array_equal(tgrid.node_y, jgrid.node_y)
    np.testing.assert_array_equal(tgrid.perimeter, jgrid.perimeter)
    assert tgrid.attrs == jgrid.attrs
