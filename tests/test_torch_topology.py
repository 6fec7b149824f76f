"""
The port's topology operations held on the CPU against the JAX
package's: the graph utilities, orientation, edge validation, directed
and structured connectivity, perimeter, circumcenters, triangulation and
binary morphology of ``ugrid/connectivity.py``; the derived geometry,
triangulations, voronoi tessellations, periodic conversion and reverse
Cuthill-McKee of ``Ugrid2d``; the graph edits of ``Ugrid1d``.

The same seeded inputs go through both packages, on quads, triangles,
mixed faces with fill values, a concave mesh, a mesh with a hole and a
network with a cycle and with self-loops.  Integer topology and orders
are equal exactly; float geometry is equal bit for bit where the
arithmetic is copied, else within rtol 1e-12.
"""

import numpy as np
import pytest
import torch
from scipy import sparse
from scipy.spatial import Delaunay

import chip_smoke
import xugrid_tpu as xu
import xugrid_tpu_torch as xt
from xugrid_tpu.ugrid import connectivity as jax_connectivity
from xugrid_tpu_torch.ugrid import connectivity
from xugrid_tpu_torch.utils import native

PKGS = (xu, xt)


def quads():
    (verts, faces), _ = chip_smoke.bench_meshes(6, 2, np.random.default_rng(3))
    return verts, faces


def triangles():
    pts = np.random.default_rng(4).uniform(0.0, 10.0, (40, 2))
    return pts, Delaunay(pts).simplices


def mixed():
    """A 4 x 4 quad mesh with every third quad split in two triangles,
    padded with -1."""
    verts, faces = chip_smoke.quad_mesh(4, 4)
    rows = []
    for k, f in enumerate(faces):
        if k % 3 == 0:
            rows += [[f[0], f[1], f[2], -1], [f[0], f[2], f[3], -1]]
        else:
            rows.append(list(f))
    return verts, np.array(rows)


def subset_mesh(keep):
    verts, faces = chip_smoke.quad_mesh(5, 5)
    faces = faces[keep(faces, verts)]
    used = np.unique(faces)
    inverse = np.full(len(verts), -1)
    inverse[used] = np.arange(len(used))
    return verts[used], inverse[faces]


def concave():
    """An L-shaped quad mesh: one reentrant corner."""
    return subset_mesh(lambda f, v: ~((v[f].mean(axis=1) > 2.5).all(axis=1)))


def hole():
    """A 5 x 5 quad mesh without its middle face."""
    return subset_mesh(lambda f, v: ~(np.abs(v[f].mean(axis=1) - 2.5) < 1.0).all(axis=1))


MESHES = {"quads": quads(), "triangles": triangles(), "mixed": mixed(), "concave": concave(), "hole": hole()}


def grids(name):
    verts, faces = MESHES[name]
    return [pkg.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces) for pkg in PKGS]


def network_arrays(kind):
    nodes, edges = chip_smoke.random_network(3, 12, 10.0, np.random.default_rng(8))
    if kind == "cycle":
        # Close the second line into a loop: its last node back to its first.
        edges = np.concatenate([edges, [[25, 13]]])
    elif kind == "self_loops":
        edges = np.concatenate([edges, [[4, 4], [20, 20], [30, 30]]])
    return nodes, edges


NETWORKS = ("dag", "cycle", "self_loops")


def networks(kind):
    nodes, edges = network_arrays(kind)
    return [pkg.Ugrid1d(nodes[:, 0], nodes[:, 1], -1, edges) for pkg in PKGS]


def assert_csr_equal(got, want):
    assert got.shape == want.shape
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def assert_grid_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_array_equal(got.node_x, want.node_x)
    np.testing.assert_array_equal(got.node_y, want.node_y)
    np.testing.assert_array_equal(got.edge_node_connectivity, want.edge_node_connectivity)
    assert got.fill_value == want.fill_value and got.start_index == want.start_index
    if want.topology_dimension == 2:
        np.testing.assert_array_equal(got.face_node_connectivity, want.face_node_connectivity)


# Connectivity functions
# ----------------------
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sparse_inversion_and_ranks_match_jax(mesh):
    _, faces = MESHES[mesh]
    for mod in (connectivity, jax_connectivity):
        assert isinstance(mod.to_adjacency(mod.to_sparse(faces)), mod.AdjacencyMatrix)
    csr = connectivity.to_sparse(faces)
    assert_csr_equal(connectivity.invert_sparse(csr), jax_connectivity.invert_sparse(csr))
    np.testing.assert_array_equal(
        connectivity.invert_sparse_to_dense(csr), jax_connectivity.invert_sparse_to_dense(csr)
    )
    adj = connectivity.to_adjacency(csr)
    for v in range(len(faces)):
        np.testing.assert_array_equal(
            connectivity.neighbors(adj, v), jax_connectivity.neighbors(jax_connectivity.to_adjacency(csr), v)
        )
    np.testing.assert_array_equal(connectivity._dense_rank(faces), jax_connectivity._dense_rank(faces))
    np.testing.assert_array_equal(connectivity.renumber(faces * 3), jax_connectivity.renumber(faces * 3))
    with pytest.raises(TypeError, match="Expected csr_matrix"):
        connectivity.to_adjacency(csr.tocoo())


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_orientation_matches_jax(mesh):
    verts, faces = MESHES[mesh]
    flipped = faces.copy()
    flipped[::2] = jax_connectivity.reverse_orientation(faces[::2])
    np.testing.assert_array_equal(
        connectivity.reverse_orientation(flipped), jax_connectivity.reverse_orientation(flipped)
    )
    got = connectivity.counterclockwise(flipped, verts)
    np.testing.assert_array_equal(got, jax_connectivity.counterclockwise(flipped, verts))
    np.testing.assert_array_equal(connectivity.counterclockwise(got, verts), got)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("edit", ["as_derived", "shuffled", "duplicate", "foreign", "too_few"])
def test_validate_edge_node_connectivity_matches_jax(mesh, edit):
    _, faces = MESHES[mesh]
    edges, _ = connectivity.edge_connectivity(faces)
    rng = np.random.default_rng(1)
    if edit == "shuffled":
        edges = edges[rng.permutation(len(edges))][:, ::-1]
    elif edit == "duplicate":
        edges = np.concatenate([edges, edges[[3, 0]]])
    elif edit == "foreign":
        edges = np.concatenate([edges, [[0, faces.max()]]])
    elif edit == "too_few":
        edges = edges[:-2]
    results = []
    for mod in (connectivity, jax_connectivity):
        try:
            results.append(mod.validate_edge_node_connectivity(faces, edges))
        except ValueError as e:
            results.append(str(e))
    if edit == "too_few":
        assert isinstance(results[0], str) and results[0] == results[1]
    else:
        np.testing.assert_array_equal(*results)
        assert results[0].sum() == len(connectivity.edge_connectivity(faces)[0])


@pytest.mark.parametrize("kind", NETWORKS)
def test_directed_connectivity_matches_jax(kind):
    _, edges = network_arrays(kind)
    assert_csr_equal(
        connectivity.directed_node_node_connectivity(edges), jax_connectivity.directed_node_node_connectivity(edges)
    )
    node_edge = connectivity.invert_dense_to_sparse(edges)
    assert_csr_equal(
        connectivity.directed_edge_edge_connectivity(edges, node_edge),
        jax_connectivity.directed_edge_edge_connectivity(edges, node_edge),
    )


@pytest.mark.parametrize("shape", [(5, 7), (1, 9), (12, 3)])
def test_structured_connectivity_matches_jax(shape):
    active = np.random.default_rng(shape[0]).random(shape) < 0.7
    got = connectivity.structured_connectivity(active)
    want = jax_connectivity.structured_connectivity(active)
    assert got.nnz == want.nnz and got.n == want.n and got.m == want.m
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.indptr, want.indptr)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_perimeter_and_circumcenters_match_jax(mesh):
    verts, faces = MESHES[mesh]
    x, y = verts[:, 0], verts[:, 1]
    np.testing.assert_array_equal(connectivity.perimeter(faces, x, y), jax_connectivity.perimeter(faces, x, y))
    if faces.shape[1] == 3:
        np.testing.assert_array_equal(
            connectivity.circumcenters(faces, x, y), jax_connectivity.circumcenters(faces, x, y)
        )
    else:
        with pytest.raises(NotImplementedError, match="triangular grids"):
            connectivity.circumcenters(faces, x, y)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("form", ["dense", "coo"])
def test_triangulate_matches_jax(mesh, form):
    _, faces = MESHES[mesh]
    conn = faces if form == "dense" else connectivity.to_sparse(faces, sort_indices=False).tocoo()
    got = connectivity.triangulate(conn)
    want = jax_connectivity.triangulate(conn)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    with pytest.raises(TypeError, match="ndarray or sparse matrix"):
        connectivity.triangulate(faces.tolist())


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("value", [True, False], ids=["dilation", "erosion"])
@pytest.mark.parametrize("iterations", [0, 1, 3])
@pytest.mark.parametrize("border_value", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_binary_morphology_matches_jax(mesh, value, iterations, border_value, masked):
    jgrid, _ = grids(mesh)
    rng = np.random.default_rng(iterations)
    face_face = jgrid.face_face_connectivity
    n = jgrid.n_face
    start = rng.random(n) < (0.2 if value else 0.8)
    mask = rng.random(n) < 0.15 if masked else None
    exterior = jgrid.exterior_faces
    name = "binary_dilation" if value else "binary_erosion"
    got = getattr(connectivity, name)(face_face, start, iterations, mask, exterior, border_value)
    want = getattr(jax_connectivity, name)(face_face, start, iterations, mask, exterior, border_value)
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    assert start is not got


def test_binary_morphology_counts_edge_zero_and_checks_input():
    # Two faces joined by edge 0: the stored 0 still makes them neighbours.
    face_face = sparse.csr_matrix((np.array([0, 0]), np.array([1, 0]), np.array([0, 1, 2])), shape=(2, 2))
    start = np.array([True, False])
    for mod in (connectivity, jax_connectivity):
        np.testing.assert_array_equal(mod.binary_dilation(face_face, start), [True, True])
        np.testing.assert_array_equal(mod.binary_erosion(face_face, start), [False, False])
        with pytest.raises(TypeError, match="input dtype should be bool"):
            mod.binary_dilation(face_face, start.astype(int))
        with pytest.raises(ValueError, match="single \\(face\\) dimension"):
            mod.binary_dilation(face_face, np.ones((2, 2), dtype=bool))


@pytest.mark.parametrize("kind", NETWORKS)
@pytest.mark.parametrize("library", ["native", "numpy"])
def test_graph_walks_match_jax(kind, library, monkeypatch):
    _, edges = network_arrays(kind)
    A = connectivity.directed_node_node_connectivity(edges)
    if library == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    else:
        assert native.get_lib() is not None
    keep = np.arange(0, A.shape[0], 4)
    outcomes = []
    for mod in (connectivity, jax_connectivity):
        result = []
        for call in (lambda: mod.topological_sort_by_dfs(A), lambda: mod.contract_vertices(A, keep)):
            try:
                result.append(call())
            except ValueError as e:
                result.append(str(e))
        outcomes.append(result)
    for got, want in zip(*outcomes):
        if isinstance(want, str):
            assert got == want == "The graph contains at least one cycle"
        else:
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    if kind == "dag":
        order = outcomes[0][0]
        position = np.empty_like(order)
        position[order] = np.arange(len(order))
        assert (position[edges[:, 0]] <= position[edges[:, 1]]).all()


# Ugrid2d
# -------
GEOMETRY = (
    "validate_edge_node_connectivity", "perimeter", "face_bounds", "edge_bounds", "face_node_coordinates",
    "exterior_edges", "exterior_faces", "directed_node_node_connectivity", "directed_edge_edge_connectivity",
)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", GEOMETRY)
def test_grid_geometry_matches_jax(mesh, name):
    jgrid, tgrid = grids(mesh)
    attr = lambda grid: getattr(grid, name)() if callable(getattr(grid, name)) else getattr(grid, name)  # noqa: E731
    got, want = attr(tgrid), attr(jgrid)
    if sparse.issparse(want):
        assert_csr_equal(got, want)
    else:
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_circumcenters_and_triangulations_match_jax(mesh):
    jgrid, tgrid = grids(mesh)
    if jgrid.n_max_node_per_face == 3:
        np.testing.assert_array_equal(tgrid.circumcenters, jgrid.circumcenters)
    else:
        with pytest.raises(NotImplementedError):
            tgrid.circumcenters
    (gx, gy, gtri), gface = tgrid.triangulation
    (wx, wy, wtri), wface = jgrid.triangulation
    for a, b in ((gx, wx), (gy, wy), (gtri, wtri), (gface, wface)):
        np.testing.assert_array_equal(a, b)
    assert tgrid.triangulation is tgrid.triangulation
    for got, want in zip(tgrid.voronoi_topology, jgrid.voronoi_topology):
        np.testing.assert_array_equal(got, want)
    (gx, gy, gtri), gface = tgrid.centroid_triangulation
    (wx, wy, wtri), wface = jgrid.centroid_triangulation
    for a, b in ((gx, wx), (gy, wy), (gtri, wtri), (gface, wface)):
        np.testing.assert_array_equal(a, b)
    assert_grid_equal(tgrid.triangulate(), jgrid.triangulate())


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind", ["centroidal", "circumcenter"])
@pytest.mark.parametrize(
    "options",
    [{}, {"add_exterior": False}, {"add_vertices": False}, {"skip_concave": True}],
    ids=["default", "interior", "no_vertices", "skip_concave"],
)
def test_tesselations_match_jax(mesh, kind, options):
    jgrid, tgrid = grids(mesh)
    if kind == "circumcenter" and jgrid.n_max_node_per_face != 3:
        jgrid, tgrid = jgrid.triangulate(), tgrid.triangulate()
    method = f"tesselate_{kind}_voronoi"
    got = getattr(tgrid, method)(**options, device="cpu")
    assert_grid_equal(got, getattr(jgrid, method)(**options))
    assert got.n_face > 0


def test_voronoi_topology_resolves_no_device_below_the_device_size(monkeypatch):
    """The cached property sorts a small table in numpy: the card is
    never asked for."""
    from xugrid_tpu_torch.ugrid import voronoi

    def refuse(*args, **kwargs):
        raise AssertionError("a device was resolved")

    monkeypatch.setattr(voronoi, "resolve_device", refuse)
    _, tgrid = grids("quads")
    tgrid.voronoi_topology
    tgrid.centroid_triangulation


@pytest.mark.parametrize("kind", ["centroidal", "circumcenter"])
def test_tesselations_run_on_the_card_by_default(kind, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tgrid = grids("triangles")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tgrid, f"tesselate_{kind}_voronoi")()


@pytest.mark.parametrize("mesh", ["quads", "mixed"])
@pytest.mark.parametrize("edges", [False, True])
@pytest.mark.parametrize("payload", ["numpy", "tensor"])
def test_to_periodic_and_back_match_jax(mesh, edges, payload):
    jgrid, tgrid = grids(mesh)
    if edges:
        jgrid.edge_node_connectivity, tgrid.edge_node_connectivity
    facets = ("node", "edge", "face") if edges else ("node", "face")
    rng = np.random.default_rng(2)
    values = {facet: rng.normal(size=(2, getattr(jgrid, f"n_{facet}"))) for facet in facets}
    objs = []
    for pkg, grid in zip(PKGS, (jgrid, tgrid)):
        obj = pkg.xdata.Dataset()
        for facet in facets:
            data = torch.from_numpy(values[facet]) if pkg is xt and payload == "tensor" else values[facet]
            obj[facet] = (("time", getattr(grid, f"{facet}_dimension")), data)
        objs.append(obj)
    assert (tgrid._edge_node_connectivity is not None) == edges
    jperiodic, jobj = jgrid.to_periodic(obj=objs[0])
    tperiodic, tobj = tgrid.to_periodic(obj=objs[1])
    assert_grid_equal(tperiodic, jperiodic)
    n_left = int((tgrid.node_x == tgrid.node_x.min()).sum())
    assert tperiodic.n_node == tgrid.n_node - n_left
    assert_grid_equal(tgrid.to_periodic(), jperiodic)
    jback, jobj2 = jperiodic.to_nonperiodic(xmax=jgrid.bounds[2], obj=jobj)
    tback, tobj2 = tperiodic.to_nonperiodic(xmax=tgrid.bounds[2], obj=tobj)
    assert_grid_equal(tback, jback)
    assert tback.n_node == tgrid.n_node
    for tgot, jwant in ((tobj, jobj), (tobj2, jobj2)):
        for facet in facets:
            assert isinstance(tgot[facet].data, torch.Tensor) == (payload == "tensor")
            np.testing.assert_array_equal(tgot[facet].values, np.asarray(jwant[facet].values))
    np.testing.assert_array_equal(tobj2["face"].values, values["face"])


def test_to_periodic_refuses_unmatched_boundaries():
    verts, faces = MESHES["triangles"]
    for pkg in PKGS:
        with pytest.raises(ValueError, match="do not match"):
            pkg.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces).to_periodic()


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_reverse_cuthill_mckee_matches_jax(mesh):
    jgrid, tgrid = grids(mesh)
    got, got_order = tgrid.reverse_cuthill_mckee()
    want, want_order = jgrid.reverse_cuthill_mckee()
    a, b = tgrid.face_face_connectivity, jgrid.face_face_connectivity
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(got_order, want_order)
    assert_grid_equal(got, want)


def test_caches_reset_with_the_geometry_and_on_new_grids():
    _, tgrid = grids("quads")
    tgrid.perimeter, tgrid.triangulation, tgrid.voronoi_topology, tgrid.centroid_triangulation
    ds = xt.xdata.Dataset()
    ds["qx"] = ((tgrid.node_dimension,), tgrid.node_x * 2.0)
    ds["qy"] = ((tgrid.node_dimension,), tgrid.node_y)
    tgrid.set_node_coords("qx", "qy", ds)
    for name in ("_perimeter", "_circumcenters", "_triangulation", "_voronoi_topology", "_centroid_triangulation"):
        assert getattr(tgrid, name) is None
    np.testing.assert_array_equal(tgrid.triangulation[0][0], tgrid.node_x)
    subset = tgrid.topology_subset(np.arange(5))
    assert subset._triangulation is None and subset._voronoi_topology is None
    assert len(subset.triangulation[1]) == 10


# Ugrid1d
# -------
@pytest.mark.parametrize("kind", NETWORKS)
def test_network_graph_edits_match_jax(kind):
    jnet, tnet = networks(kind)
    # A self-loop is a cycle of one edge.
    assert tnet.is_cyclic == jnet.is_cyclic == (kind != "dag")
    if kind != "dag":
        with pytest.raises(ValueError, match="cycle"):
            tnet.topological_sort_by_dfs()
    else:
        np.testing.assert_array_equal(tnet.topological_sort_by_dfs(), jnet.topological_sort_by_dfs())
    assert_grid_equal(tnet.remove_self_loops(), jnet.remove_self_loops())
    assert not tnet.remove_self_loops().is_cyclic or kind == "cycle"
    if kind == "dag":
        keep = np.array([0, 5, 12, 13, 20, 25, 26, 33, 38])
        got = tnet.contract_vertices(keep)
        assert_grid_equal(got, jnet.contract_vertices(keep))
        np.testing.assert_array_equal(got.node_coordinates, tnet.node_coordinates[keep])
    for edge_directions in (tnet.directed_node_node_connectivity, tnet.directed_edge_edge_connectivity):
        assert sparse.issparse(edge_directions)
    assert tnet.to_periodic() is tnet and tnet.to_nonperiodic(1.0) is tnet
    obj = object()
    assert tnet.to_periodic(obj=obj) == (tnet, obj) and tnet.to_nonperiodic(1.0, obj=obj) == (tnet, obj)


@pytest.mark.parametrize("kind", ["dag", "self_loops"])
@pytest.mark.parametrize("existing", [False, True])
def test_refine_by_vertices_matches_jax(kind, existing):
    jnet, tnet = networks(kind)
    rng = np.random.default_rng(12)
    chosen = rng.choice(12, size=5, replace=False)
    a, b = (tnet.node_coordinates[tnet.edge_node_connectivity[chosen, k]] for k in (0, 1))
    vertices = np.concatenate([0.25 * a + 0.75 * b, 0.6 * a + 0.4 * b])
    if existing:
        vertices = np.concatenate([vertices, tnet.node_coordinates[[3]]])
    got, got_index = tnet.refine_by_vertices(vertices, return_index=True)
    want, want_index = jnet.refine_by_vertices(vertices, return_index=True)
    assert_grid_equal(got, want)
    np.testing.assert_array_equal(got_index, want_index)
    np.testing.assert_array_equal(got.node_coordinates[tnet.n_node :], vertices[:10])
    assert got.n_edge == tnet.n_edge + 10
    with pytest.raises(ValueError, match="not located on any edge"):
        tnet.refine_by_vertices(np.array([[-50.0, -50.0]]))
