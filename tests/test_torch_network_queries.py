"""
The port's queries on a 1D network held on the CPU against the JAX
package's: the edge index ``EdgeCellTree2d`` (points on edges within a
tolerance, segment intersections, the degenerate and collinear cases of
``_segment_intersections``), ``sel_points``, ``intersect_line``,
``intersect_linestring``, ``to_node``/``to_edge``, ``reindex_like`` and
``interpolate_na`` (Dijkstra along the network, also held to scipy's
``dijkstra`` called directly), through the UgridDataArray and UgridDataset
accessors, on a zigzag and on four random-walk polylines of 30 segments.

Indices and values are equal; float64 section coordinates agree at rtol
1e-12.
"""

import warnings

import numpy as np
import pytest
import torch
from scipy.sparse.csgraph import dijkstra

import chip_smoke
import xugrid_tpu as xu
import xugrid_tpu_torch as xt
from xugrid_tpu.spatial.celltree import EdgeCellTree2d as JaxEdgeCellTree2d
from xugrid_tpu.spatial.celltree import _segment_intersections as jax_segment_intersections
from xugrid_tpu_torch.spatial.celltree import EdgeCellTree2d, _segment_intersections
from xugrid_tpu_torch.xdata.variable import is_tensor

EXTENT = 10.0


def networks():
    nodes, edges = chip_smoke.random_network(4, 30, EXTENT, np.random.default_rng(13))
    zigzag = (np.array([[0.0, 0.0], [1.0, 1.0], [2.0, 0.0], [3.0, 1.0]]), np.array([[0, 1], [1, 2], [2, 3]]))
    return {"walks": (nodes, edges), "zigzag": zigzag}


NETWORKS = networks()
PAYLOADS = ["numpy", "tensor"]


def pair(name):
    nodes, edges = NETWORKS[name]
    return (xu.Ugrid1d(nodes[:, 0], nodes[:, 1], -1, edges), xt.Ugrid1d(nodes[:, 0], nodes[:, 1], -1, edges))


def udas(jgrid, tgrid, facet, payload, n_extra=2, nan_fraction=0.0, seed=0):
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(n_extra, getattr(jgrid, f"n_{facet}")))
    if nan_fraction:
        values[rng.random(values.shape) < nan_fraction] = np.nan
    dims = ("time", getattr(jgrid, f"{facet}_dimension"))
    tvalues = torch.from_numpy(values) if payload == "tensor" else values
    return (
        xu.UgridDataArray(xu.xdata.DataArray(values, dims=dims, name="q"), jgrid),
        xt.UgridDataArray(xt.xdata.DataArray(tvalues, dims=dims, name="q"), tgrid),
    )


def assert_same(want, got, payload="numpy"):
    assert tuple(want.dims) == tuple(got.dims)
    assert sorted(want.coords) == sorted(got.coords)
    for name in want.coords:
        a, b = np.asarray(want[name].values), np.asarray(got[name].values)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-12, atol=0.0)
        else:
            np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(np.asarray(got.values), np.asarray(want.values))
    if payload == "tensor":
        assert is_tensor(got.data)


def on_and_off_points(nodes, edges, seed=1):
    """Edge midpoints and quarter points (on the network), nodes, points
    just off the edges and random points."""
    rng = np.random.default_rng(seed)
    a, b = nodes[edges[:, 0]], nodes[edges[:, 1]]
    d = b - a
    normal = np.column_stack([-d[:, 1], d[:, 0]]) / np.linalg.norm(d, axis=1)[:, None]
    return np.concatenate(
        [0.5 * (a + b), 0.75 * a + 0.25 * b, nodes, 0.5 * (a + b) + 1e-7 * normal,
         rng.uniform(0.0, EXTENT, (50, 2))]
    )


# -- EdgeCellTree2d ----------------------------------------------------------------
@pytest.mark.parametrize("tolerance", [None, 1e-6, 0.05])
@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_edge_tree_locate_points_matches_jax(name, tolerance):
    nodes, edges = NETWORKS[name]
    want_tree, got_tree = JaxEdgeCellTree2d(nodes, edges), EdgeCellTree2d(nodes, edges)
    assert got_tree.default_tolerance() == want_tree.default_tolerance()
    np.testing.assert_array_equal(got_tree.bb_distances, want_tree.bb_distances)
    pts = on_and_off_points(nodes, edges)
    want = want_tree.locate_points(pts, tolerance)
    got = got_tree.locate_points(pts, tolerance)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[: len(edges)] >= 0).all()


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_edge_tree_intersect_edges_matches_jax(name):
    nodes, edges = NETWORKS[name]
    rng = np.random.default_rng(2)
    segments = rng.uniform(-1.0, EXTENT + 1.0, (25, 2, 2))
    segments = np.concatenate([segments, [[[0.0, 0.5], [3.0, 0.5]], [[-1.0, -1.0], [4.0, 4.0]]]])
    want = JaxEdgeCellTree2d(nodes, edges).intersect_edges(segments)
    got = EdgeCellTree2d(nodes, edges).intersect_edges(segments)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert len(got[0]) > 0
    none = EdgeCellTree2d(nodes, edges).intersect_edges(np.array([[[50.0, 50.0], [60.0, 60.0]]]))
    assert [len(a) for a in none] == [0, 0, 0] and none[2].shape == (0, 2)


def test_segment_intersections_degenerate_and_collinear():
    """Crossing, touching, parallel, collinear overlapping and disjoint,
    degenerate (point) tree and query segments."""
    p0 = np.array([[0, 0], [0, 0], [0, 0], [0, 0], [0, 0], [0, 0], [0, 0], [1, 1], [1, 1], [0, 0]], dtype=float)
    p1 = np.array([[2, 2], [2, 0], [2, 0], [4, 0], [2, 0], [2, 0], [2, 0], [1, 1], [1, 1], [2, 2]], dtype=float)
    q0 = np.array([[0, 2], [2, 0], [0, 1], [1, 0], [3, 0], [1, 0], [1, 1], [0, 0], [1, 1], [3, 3]], dtype=float)
    q1 = np.array([[2, 0], [2, 5], [2, 1], [6, 0], [5, 0], [1, 0], [1, 1], [2, 2], [1, 1], [4, 4]], dtype=float)
    want_hit, want_xy = jax_segment_intersections(p0, p1, q0, q1)
    got_hit, got_xy = _segment_intersections(p0, p1, q0, q1)
    np.testing.assert_array_equal(got_hit, want_hit)
    np.testing.assert_array_equal(got_xy, want_xy)
    np.testing.assert_array_equal(got_hit, [True, True, False, True, False, True, False, False, False, False])


# -- selections ----------------------------------------------------------------------
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("method", [None, "nearest"])
@pytest.mark.parametrize("out_of_bounds", ["warn", "ignore", "drop"])
@pytest.mark.parametrize("facet", ["edge", "node"])
def test_sel_points_matches_jax(facet, out_of_bounds, method, payload):
    jgrid, tgrid = pair("walks")
    juda, tuda = udas(jgrid, tgrid, facet, payload)
    nodes, edges = NETWORKS["walks"]
    pts = on_and_off_points(nodes, edges)[::5]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = juda.ugrid.sel_points(pts[:, 0], pts[:, 1], method=method, out_of_bounds=out_of_bounds)
        got = tuda.ugrid.sel_points(pts[:, 0], pts[:, 1], method=method, out_of_bounds=out_of_bounds)
    assert_same(want, got, payload)
    assert got.dims[-1] == f"{tgrid.name}_points"


def test_sel_points_zigzag():
    jgrid, tgrid = pair("zigzag")
    values = np.arange(3.0)
    uda = xt.UgridDataArray(xt.xdata.DataArray(values, dims=(tgrid.edge_dimension,), name="q"), tgrid)
    out = uda.ugrid.sel_points(x=[0.5, 2.5, 9.0], y=[0.5, 0.5, 9.0], out_of_bounds="drop")
    np.testing.assert_array_equal(out.values, [0.0, 2.0])
    with pytest.raises(ValueError, match="Not all points"):
        uda.ugrid.sel_points(x=[9.0], y=[9.0], out_of_bounds="raise")


LINES = {"across": ((0.0, 5.1), (EXTENT, 4.7)), "diagonal": ((0.2, 0.1), (9.9, 9.6)), "zigzag": ((0.0, 0.5), (3.0, 0.5))}


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("line", sorted(LINES))
def test_intersect_line_matches_jax(line, payload):
    jgrid, tgrid = pair("zigzag" if line == "zigzag" else "walks")
    juda, tuda = udas(jgrid, tgrid, "edge", payload)
    start, end = LINES[line]
    want = juda.ugrid.intersect_line(start, end)
    got = tuda.ugrid.intersect_line(start, end)
    assert_same(want, got, payload)
    assert len(got.values[0]) >= 3
    assert (np.diff(got[f"{tgrid.name}_s"].values) >= 0).all()
    # Node data has no section along the edges, in either package.
    jnodes, tnodes = udas(jgrid, tgrid, "node", payload)
    for uda in (jnodes, tnodes):
        with pytest.raises(ValueError, match="do not exist"):
            uda.ugrid.intersect_line(start, end)


@pytest.mark.parametrize("payload", PAYLOADS)
def test_intersect_linestring_matches_jax(payload):
    jgrid, tgrid = pair("walks")
    juda, tuda = udas(jgrid, tgrid, "edge", payload)
    xy = np.array([[0.5, 0.5], [9.0, 2.0], [5.0, 9.5], [1.0, 6.0]])
    assert_same(juda.ugrid.intersect_linestring(xy), tuda.ugrid.intersect_linestring(xy), payload)


# -- remaps and reindexing ---------------------------------------------------------------
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("source, target", [("edge", "node"), ("node", "edge")])
def test_to_facet_matches_jax(source, target, payload):
    jgrid, tgrid = pair("walks")
    juda, tuda = udas(jgrid, tgrid, source, payload)
    assert_same(getattr(juda.ugrid, f"to_{target}")().obj, getattr(tuda.ugrid, f"to_{target}")().obj, payload)
    with pytest.raises(ValueError, match="Cannot map to face"):
        tuda.ugrid.to_face()


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("facet", ["edge", "node"])
def test_reindex_like_matches_jax(facet, payload):
    jgrid, tgrid = pair("walks")
    nodes, edges = NETWORKS["walks"]
    rng = np.random.default_rng(4)
    edge_perm, node_perm = rng.permutation(len(edges)), rng.permutation(len(nodes))
    inverse = np.empty_like(node_perm)
    inverse[node_perm] = np.arange(len(nodes))
    shuffled_nodes, shuffled_edges = nodes[node_perm], inverse[edges[edge_perm]]
    jshuffled = xu.Ugrid1d(shuffled_nodes[:, 0], shuffled_nodes[:, 1], -1, shuffled_edges)
    tshuffled = xt.Ugrid1d(shuffled_nodes[:, 0], shuffled_nodes[:, 1], -1, shuffled_edges)
    juda, tuda = udas(jgrid, tgrid, facet, payload)
    want = juda.ugrid.reindex_like(jshuffled)
    got = tuda.ugrid.reindex_like(tshuffled)
    assert got.grid is tshuffled
    assert_same(want.obj, got.obj, payload)
    perm = edge_perm if facet == "edge" else node_perm
    np.testing.assert_array_equal(np.asarray(got.values), np.asarray(tuda.values)[:, perm])
    with pytest.raises(TypeError):
        tgrid.reindex_like(xt.Ugrid2d([0.0, 1.0, 1.0], [0.0, 0.0, 1.0], -1, np.array([[0, 1, 2]])), tuda.obj)


# -- the nearest fill along the network ------------------------------------------------------
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("max_distance", [None, 2.0])
@pytest.mark.parametrize("facet", ["node", "edge"])
def test_interpolate_na_matches_jax(facet, max_distance, payload):
    jgrid, tgrid = pair("walks")
    juda, tuda = udas(jgrid, tgrid, facet, payload, n_extra=3, nan_fraction=0.3)
    want = juda.ugrid.interpolate_na(max_distance=max_distance)
    got = tuda.ugrid.interpolate_na(max_distance=max_distance)
    assert_same(want.obj, got.obj, payload)


def test_interpolate_na_against_scipy_dijkstra():
    """Each filled node takes the value of the known node nearest along the
    network, from scipy's dijkstra over the edge lengths called directly."""
    _, tgrid = pair("walks")
    nodes, edges = NETWORKS["walks"]
    rng = np.random.default_rng(6)
    values = rng.normal(size=len(nodes))
    values[rng.random(len(nodes)) < 0.3] = np.nan
    uda = xt.UgridDataArray(xt.xdata.DataArray(torch.from_numpy(values), dims=(tgrid.node_dimension,)), tgrid)
    filled = uda.ugrid.interpolate_na().values
    from scipy.sparse import coo_matrix

    length = np.linalg.norm(nodes[edges[:, 1]] - nodes[edges[:, 0]], axis=1)
    graph = coo_matrix((np.concatenate([length, length]),
                        (np.concatenate([edges[:, 0], edges[:, 1]]), np.concatenate([edges[:, 1], edges[:, 0]]))),
                       shape=(len(nodes),) * 2).tocsr()
    known = np.flatnonzero(~np.isnan(values))
    distance = dijkstra(graph, indices=known)
    nearest = known[np.argmin(distance, axis=0)]
    reachable = np.isfinite(distance.min(axis=0))
    np.testing.assert_array_equal(filled[reachable], values[nearest[reachable]])
    assert np.isnan(filled[~reachable]).all()


def test_zigzag_fill_and_errors():
    _, tgrid = pair("zigzag")
    filled = tgrid._nearest_interpolate(np.array([1.0, np.nan, np.nan, 4.0]), tgrid.node_dimension, np.inf)
    np.testing.assert_array_equal(filled, [1.0, 1.0, 4.0, 4.0])
    limited = tgrid._nearest_interpolate(np.array([1.0, np.nan, np.nan, np.nan]), tgrid.node_dimension, 1.5)
    np.testing.assert_array_equal(limited, [1.0, 1.0, np.nan, np.nan])
    with pytest.raises(ValueError, match="All values are NA"):
        tgrid._nearest_interpolate(np.full(4, np.nan), tgrid.node_dimension, np.inf)
    with pytest.raises(ValueError, match="Expected"):
        tgrid._nearest_interpolate(np.ones(4), "bogus", np.inf)


# -- the UgridDataset accessor ----------------------------------------------------------------
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize(
    "call",
    [
        ("sel_points", ([0.5, 2.5, 1.5], [0.5, 0.5, 0.5]), {"out_of_bounds": "raise"}),
        ("sel_points", ([0.5, 2.5, 8.0], [0.5, 0.5, 8.0]), {"out_of_bounds": "drop", "method": "nearest"}),
        ("intersect_line", ((0.0, 0.5), (3.0, 0.5)), {}),
        ("intersect_linestring", (np.array([[0.0, 0.5], [1.5, 0.2], [3.0, 0.5]]),), {}),
    ],
    ids=["sel_points", "sel_points_nearest_drop", "intersect_line", "intersect_linestring"],
)
def test_dataset_accessor_matches_jax(call, payload):
    name, args, kwargs = call
    jgrid, tgrid = pair("zigzag")
    made = []
    for pkg, grid in ((xu, jgrid), (xt, tgrid)):
        ds = pkg.xdata.Dataset()
        edge_values, node_values = np.arange(3.0), 10.0 + np.arange(4.0)
        if pkg is xt and payload == "tensor":
            edge_values, node_values = torch.from_numpy(edge_values), torch.from_numpy(node_values)
        ds["e"] = pkg.xdata.DataArray(edge_values, dims=(grid.edge_dimension,))
        ds["n"] = pkg.xdata.DataArray(node_values, dims=(grid.node_dimension,))
        made.append(pkg.UgridDataset(ds, [grid]))
    want = getattr(made[0].ugrid, name)(*args, **kwargs)
    got = getattr(made[1].ugrid, name)(*args, **kwargs)
    for var in ("e", "n"):
        assert_same(want[var], got[var], payload)
