"""
The port's topology subsets held on the CPU against the JAX package's:
``topology_subset`` (positions, masks, pandas Indexes, the whole grid),
``isel`` on the node, edge and face dimensions and its errors, box
``sel`` and ``clip_box`` of a ``Ugrid2d`` and a ``Ugrid1d`` and of the
``.ugrid`` accessors, a forwarded ``isel`` along a UGRID dimension
(``align``), and the edge adjacency.  The same seeded inputs through
both packages; grids, returned positions and data are equal, exactly.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
import xugrid_tpu as xu
import xugrid_tpu_torch as xt

PKGS = (xu, xt)


def jittered(pkg, n=7):
    (verts, faces), _ = chip_smoke.bench_meshes(n, 2, np.random.default_rng(5))
    return pkg.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)


def network(pkg):
    nodes, edges = chip_smoke.random_network(3, 15, 10.0, np.random.default_rng(6))
    return pkg.Ugrid1d(nodes[:, 0], nodes[:, 1], -1, edges)


GRIDS = {"mesh": jittered, "network": network}


def assert_grids_equal(got, want):
    assert type(got).__name__ == type(want).__name__ and got.name == want.name and got.attrs == want.attrs
    assert got.fill_value == want.fill_value and got.start_index == want.start_index
    for name in ("node_x", "node_y", "edge_node_connectivity"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    if want.topology_dimension == 2:
        np.testing.assert_array_equal(got.face_node_connectivity, want.face_node_connectivity)


def assert_indexes_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert isinstance(got[k], pd.Index)
        np.testing.assert_array_equal(got[k].to_numpy(), want[k].to_numpy())


def with_edges(grid):
    """The grid with its edges derived, so subsets carry them."""
    grid.edge_node_connectivity
    return grid


@pytest.mark.parametrize(
    "index",
    [
        lambda n: np.array([4, 1, 7, 30]),
        lambda n: np.arange(n) % 3 == 0,
        lambda n: pd.Index([2, 3, 5]),
        lambda n: np.arange(n),
        lambda n: np.ones(n, dtype=bool),
    ],
    ids=["positions", "mask", "pandas", "range", "all"],
)
@pytest.mark.parametrize("kind", list(GRIDS))
@pytest.mark.parametrize("edges", [False, True])
def test_topology_subset_matches_jax(kind, index, edges):
    out = {}
    for pkg in PKGS:
        grid = GRIDS[kind](pkg)
        if edges:
            with_edges(grid)
        facet = {v: k for k, v in grid.facets.items()}[grid.core_dimension]
        subset, indexes = grid.topology_subset(index(getattr(grid, f"n_{facet}")), return_index=True)
        out[pkg] = (grid, subset, indexes, grid.topology_subset(index(getattr(grid, f"n_{facet}"))))
    (jgrid, jsub, jidx, jplain), (tgrid, tsub, tidx, tplain) = out[xu], out[xt]
    assert_grids_equal(tsub, jsub)
    assert_grids_equal(tplain, jplain)
    assert_indexes_equal(tidx, jidx)
    assert (tsub is tgrid) == (jsub is jgrid)


@pytest.mark.parametrize("kind", list(GRIDS))
def test_topology_subset_errors(kind):
    for pkg in PKGS:
        grid = GRIDS[kind](pkg)
        with pytest.raises(ValueError, match="repeated values"):
            grid.topology_subset(np.array([1, 1, 2]))
        with pytest.raises(TypeError, match="bool or integer"):
            grid.topology_subset(np.array([1.0, 2.0]))
        with pytest.raises(TypeError, match="pandas Index or numpy array"):
            grid.topology_subset([1, 2])
        with pytest.raises(ValueError, match="larger than dimension size"):
            grid.topology_subset(np.zeros(10_000, dtype=bool))


MESH_SELECTIONS = {
    "face": lambda g: {g.face_dimension: [3, 8, 9, 10]},
    "face_mask": lambda g: {g.face_dimension: np.arange(g.n_face) < 12},
    "all_nodes": lambda g: {g.node_dimension: np.arange(g.n_node)},
    "all_edges_and_faces": lambda g: {g.edge_dimension: np.arange(g.n_edge), g.face_dimension: np.arange(g.n_face)},
}


@pytest.mark.parametrize("selection", list(MESH_SELECTIONS))
def test_ugrid2d_isel_matches_jax(selection):
    out = {}
    for pkg in PKGS:
        grid = with_edges(jittered(pkg))
        out[pkg] = grid.isel(MESH_SELECTIONS[selection](grid), return_index=True)
    (jsub, jidx), (tsub, tidx) = out[xu], out[xt]
    assert_grids_equal(tsub, jsub)
    assert_indexes_equal(tidx, jidx)
    j, t = jittered(xu), jittered(xt)
    assert_grids_equal(t.isel(**MESH_SELECTIONS[selection](t)), j.isel(MESH_SELECTIONS[selection](j)))


@pytest.mark.parametrize(
    "indexers, error, match",
    [
        (lambda g: {g.node_dimension: [0, 1, 2]}, ValueError, "invalid topology"),
        (lambda g: {g.node_dimension: np.unique(g.face_node_connectivity[[4, 5, 11]])}, ValueError, "invalid topology"),
        (lambda g: {g.edge_dimension: [0]}, ValueError, "invalid topology"),
        (lambda g: {g.node_dimension: np.arange(g.n_node)[::-1]}, ValueError, "invalid topology"),
        (lambda g: {g.face_dimension: [1, 2], g.node_dimension: [0, 1]}, ValueError, "do not align"),
        (lambda g: {"time": [0]}, ValueError, "do not exist"),
    ],
)
def test_ugrid2d_isel_errors(indexers, error, match):
    for pkg in PKGS:
        grid = jittered(pkg)
        with pytest.raises(error, match=match):
            grid.isel(indexers(grid))
    with pytest.raises(ValueError, match="both indexers and keyword"):
        jittered(xt).isel({"a": [0]}, b=[1])


@pytest.mark.parametrize(
    "selection",
    [
        lambda g: {g.edge_dimension: [2, 3, 4, 20]},
        # The nodes of the first of three separate lines: a valid network.
        lambda g: {g.node_dimension: np.arange(16)},
    ],
    ids=["edges", "nodes"],
)
def test_ugrid1d_isel_matches_jax(selection):
    (jsub, jidx), (tsub, tidx) = (network(pkg).isel(selection(network(pkg)), return_index=True) for pkg in PKGS)
    assert_grids_equal(tsub, jsub)
    assert_indexes_equal(tidx, jidx)
    for pkg in PKGS:
        grid = network(pkg)
        with pytest.raises(ValueError, match="invalid topology"):
            grid.isel({grid.node_dimension: [grid.edge_node_connectivity[5, 0]]})


BOXES = [
    (slice(1.0, 4.5), slice(2.0, 6.0)),
    (slice(None, 3.0), slice(4.0, None)),
    (slice(None, None), slice(None, None)),
    (slice(2.0, None), None),
]


def data_on(pkg, grid, payload="numpy"):
    """A UgridDataset with a (time, face), a node and an edge variable."""
    rng = np.random.default_rng(8)
    values = {
        "face": rng.normal(size=(2, grid.n_face)),
        "node": rng.normal(size=grid.n_node),
        "edge": rng.normal(size=grid.n_edge),
    }
    if payload == "tensor":
        values = {k: torch.from_numpy(v) for k, v in values.items()}
    ds = pkg.xdata.Dataset()
    ds["face_v"] = pkg.xdata.DataArray(values["face"], dims=("time", grid.face_dimension), coords={"time": [1.0, 2.0]})
    ds["node_v"] = pkg.xdata.DataArray(values["node"], dims=(grid.node_dimension,))
    ds["edge_v"] = pkg.xdata.DataArray(values["edge"], dims=(grid.edge_dimension,))
    return pkg.UgridDataset(ds, grids=[grid])


def assert_wrapped_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(got.grids, want.grids):
        assert_grids_equal(g, w)
    gobj, wobj = got.obj, want.obj
    if isinstance(wobj, xu.xdata.DataArray):
        gobj, wobj = gobj.to_dataset(), wobj.to_dataset()
    assert sorted(gobj._variables) == sorted(wobj._variables)
    for name, var in wobj._variables.items():
        assert gobj._variables[name].dims == var.dims
        np.testing.assert_array_equal(gobj._variables[name].values, np.asarray(var.data), err_msg=name)


@pytest.mark.parametrize("box", BOXES)
@pytest.mark.parametrize("payload", ["numpy", "tensor"])
def test_sel_box_matches_jax(box, payload):
    x, y = box
    out = {}
    for pkg in PKGS:
        uds = data_on(pkg, with_edges(jittered(pkg)), payload if pkg is xt else "numpy")
        out[pkg] = (uds.ugrid.sel(x=x, y=y), uds["face_v"].ugrid.sel(x=x, y=y), uds.grid.sel(uds.obj, x, y))
    (jds, jda, (jobj, jgrid)), (tds, tda, (tobj, tgrid)) = out[xu], out[xt]
    assert_wrapped_equal(tds, jds)
    assert_wrapped_equal(tda, jda)
    assert_grids_equal(tgrid, jgrid)
    if payload == "tensor":
        assert isinstance(tds.obj["face_v"].data, torch.Tensor) and isinstance(tda.data, torch.Tensor)


def test_clip_box_matches_jax():
    out = {}
    for pkg in PKGS:
        uds = data_on(pkg, with_edges(jittered(pkg)))
        out[pkg] = (uds.ugrid.clip_box(1.0, 2.0, 5.0, 6.0), uds["node_v"].ugrid.clip_box(1.0, 2.0, 5.0, 6.0),
                    uds.grid.clip_box(1.0, 2.0, 5.0, 6.0), network(pkg).clip_box(2.0, 1.0, 8.0, 7.0),
                    uds.grid.locate_bounding_box(1.0, 2.0, 5.0, 6.0))
    for got, want in zip(out[xt][:2], out[xu][:2]):
        assert_wrapped_equal(got, want)
    for got, want in zip(out[xt][2:4], out[xu][2:4]):
        assert_grids_equal(got, want)
    np.testing.assert_array_equal(out[xt][4], out[xu][4])


@pytest.mark.parametrize("box", [(slice(2.0, 7.0), slice(1.0, 6.0)), (slice(None, 5.0), slice(None, None))])
def test_ugrid1d_sel_box_matches_jax(box):
    out = {}
    for pkg in PKGS:
        grid = network(pkg)
        ds = pkg.xdata.Dataset()
        ds["edge_v"] = pkg.xdata.DataArray(np.arange(grid.n_edge, dtype=float), dims=(grid.edge_dimension,))
        ds["node_v"] = pkg.xdata.DataArray(np.arange(grid.n_node, dtype=float), dims=(grid.node_dimension,))
        out[pkg] = pkg.UgridDataset(ds, grids=[grid]).ugrid.sel(x=box[0], y=box[1])
    assert_wrapped_equal(out[xt], out[xu])


@pytest.mark.parametrize(
    "kind, x, y, error, match",
    [
        ("mesh", slice(3.0, 1.0), None, ValueError, "larger than slice start"),
        ("mesh", slice(None, 2.0, 0.5), None, ValueError, "step should be None"),
        ("mesh", "a", None, TypeError, "Invalid indexer type"),
        ("mesh", np.zeros((2, 2)), None, ValueError, "0d or 1d"),
        ("network", slice(1.0, 3.0, 0.5), slice(None, None), ValueError, "steps in slices"),
        ("network", slice(3.0, 1.0), slice(None, None), ValueError, "smaller than slice stop"),
        ("network", 1.0, slice(None, None), ValueError, "only supports slice"),
    ],
)
def test_sel_errors(kind, x, y, error, match):
    for pkg in PKGS:
        grid = GRIDS[kind](pkg)
        obj = pkg.xdata.DataArray(np.zeros(grid.n_edge), dims=(grid.edge_dimension,))
        with pytest.raises(error, match=match):
            grid.sel(obj, x, y if y is not None else slice(None, None))


@pytest.mark.parametrize(
    "x, y",
    [(slice(1.0, 5.0), 3.0), (2.0, slice(None, None)), ([1.0, 2.0], [3.0]), (slice(1.0, 4.0, 1.0), slice(2.0, 3.0))],
)
def test_sel_line_and_points_are_not_ported(x, y):
    """Selections along a line or at points, once stubs in the port, now
    give the JAX package's result, or its error (a stepped slice beside a
    slice: several values along a line)."""
    results = []
    for pkg in PKGS:
        grid = jittered(pkg)
        values = np.arange(grid.n_face, dtype=float)
        uda = pkg.UgridDataArray(pkg.xdata.DataArray(values, dims=(grid.face_dimension,)), grid)
        try:
            results.append(uda.ugrid.sel(x=x, y=y))
        except ValueError as error:
            results.append(str(error))
    want, got = results
    if isinstance(want, str):
        assert got == want and "single value" in got
        return
    assert tuple(got.dims) == tuple(want.dims) and sorted(got.coords) == sorted(want.coords)
    np.testing.assert_array_equal(got.values, np.asarray(want.values))
    for name in want.coords:
        np.testing.assert_allclose(got[name].values, np.asarray(want[name].values), rtol=1e-12)


@pytest.mark.parametrize("payload", ["numpy", "tensor"])
def test_forwarded_isel_subsets_the_grid(payload):
    """A forwarded isel along the face dimension returns the subset grid
    and data, as the JAX package's; a tensor payload stays a tensor.  A
    node or edge selection that leaves an invalid topology raises in
    both."""
    out = {}
    for pkg in PKGS:
        uds = data_on(pkg, with_edges(jittered(pkg)), payload if pkg is xt else "numpy")
        face = {uds.grid.face_dimension: [0, 2, 3, 9]}
        out[pkg] = (uds.isel(face), uds["face_v"].isel(face), uds["face_v"].isel(time=0).isel(face))
        for invalid in ({uds.grid.node_dimension: [0, 1, 2]}, {uds.grid.edge_dimension: [3]}):
            with pytest.raises(ValueError, match="invalid topology"):
                uds.isel(invalid)
    for got, want in zip(out[xt], out[xu]):
        assert_wrapped_equal(got, want)
    assert isinstance(out[xt][0].obj["node_v"].data, torch.Tensor) == (payload == "tensor")
    assert isinstance(out[xt][1].data, torch.Tensor) == (payload == "tensor")


def test_chained_isel_takes_positions_of_the_subset():
    """A second isel on a subset selects by positions in the subset: the
    result equals the JAX package's single isel of the composed
    positions."""
    first, second = np.array([1, 4, 5, 8, 12, 20]), np.array([0, 2, 3])
    tds = data_on(xt, with_edges(jittered(xt)))
    jds = data_on(xu, with_edges(jittered(xu)))
    face = tds.grid.face_dimension
    got = tds.isel({face: first}).isel({face: second})
    want = jds.isel({face: first[second]})
    assert_wrapped_equal(got, want)


def test_wrapped_selection_without_ugrid_change_keeps_grid():
    uds = data_on(xt, jittered(xt))
    assert uds.isel(time=[1]).grids[0] is uds.grid
    assert uds["face_v"].sel(time=2.0).grid is uds.grid


@pytest.mark.parametrize("kind", list(GRIDS))
def test_connectivity_helpers_match_jax(kind):
    j, t = GRIDS[kind](xu), GRIDS[kind](xt)
    for dim in t.dims:
        np.testing.assert_array_equal(t.get_coordinates(dim), j.get_coordinates(dim))
    with pytest.raises(ValueError, match="Expected"):
        t.get_coordinates("time")
    for name in ("edge_edge_connectivity", "node_edge_connectivity"):
        got, want = getattr(t, name), getattr(j, name)
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.data, want.data)
    assert t.max_connectivity_sizes == j.max_connectivity_sizes
    assert t.max_connectivity_dimensions == j.max_connectivity_dimensions
    if kind == "mesh":
        np.testing.assert_array_equal(t.n_node_per_face, j.n_node_per_face)
