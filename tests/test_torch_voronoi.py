"""
The port's centroidal voronoi tessellation (``ugrid/voronoi.py``) held
on the CPU against the JAX package's: ``voronoi_topology`` in all three
exterior modes on the meshes of tests/test_voronoi.py (the rectangular
mesh, a degenerate projection, the concave case) and on jittered quad
and Delaunay meshes; and ``angle_sort_rows`` below and above the size
from which it sorts on the torch device.

The tessellations are compared as polygon sets: the vertex arrays in
order within 1e-12, the face-index and interpolation maps exactly, and
each polygon as its cycle of vertex ids, whatever vertex it starts at
(an angle that rounds differently may rotate a row).
"""

import numpy as np
import pytest
import torch
from scipy.spatial import Delaunay

import chip_smoke
from xugrid_tpu.ugrid import connectivity as jax_connectivity
from xugrid_tpu.ugrid import voronoi as jax_voronoi
from xugrid_tpu_torch.ugrid import connectivity
from xugrid_tpu_torch.ugrid import voronoi

MODES = {
    "interior": {},
    "exterior": {"add_exterior": True},
    "exterior_vertices": {"add_exterior": True, "add_vertices": True},
    "exterior_vertices_convex": {"add_exterior": True, "add_vertices": True, "skip_concave": True},
}


def circumcenters(nodes, faces):
    a, b, c = (nodes[faces[:, k]] for k in range(3))
    d = 2.0 * (a[:, 0] * (b[:, 1] - c[:, 1]) + b[:, 0] * (c[:, 1] - a[:, 1]) + c[:, 0] * (a[:, 1] - b[:, 1]))
    sa, sb, sc = ((p * p).sum(axis=1) for p in (a, b, c))
    ux = (sa * (b[:, 1] - c[:, 1]) + sb * (c[:, 1] - a[:, 1]) + sc * (a[:, 1] - b[:, 1])) / d
    uy = (sa * (c[:, 0] - b[:, 0]) + sb * (a[:, 0] - c[:, 0]) + sc * (b[:, 0] - a[:, 0])) / d
    return np.column_stack([ux, uy])


def mesh_cases():
    rect = np.array([[i, j] for j in range(3) for i in range(4)], dtype=float)
    rect_faces = np.array([[0, 1, 5, 4], [1, 2, 6, 5], [2, 3, 7, 6], [4, 5, 9, 8], [5, 6, 10, 9], [6, 7, 11, 10]])
    # Circumcenters on the boundary edges: degenerate projections.
    fan = np.array([[0.0, 0.0], [2.0, 0.0], [2.0, 2.0], [0.0, 2.0], [1.0, 1.0]])
    fan_faces = np.array([[0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4]])
    concave = np.array([[0.0, 0.0], [3.0, 0.0], [1.0, 1.0], [0.0, 2.0], [3.0, 2.0]])
    concave_faces = np.array([[0, 1, 2], [0, 2, 3], [2, 4, 3]])
    (jitter, jitter_faces), _ = chip_smoke.bench_meshes(9, 2, np.random.default_rng(4))
    pts = np.random.default_rng(5).uniform(0.0, 10.0, (60, 2))
    delaunay = Delaunay(pts).simplices
    centroid = lambda n, f: connectivity.centroids(f, n[:, 0], n[:, 1])  # noqa: E731
    return {
        "rectangle": (rect, rect_faces, centroid(rect, rect_faces)),
        "degenerate": (fan, fan_faces, circumcenters(fan, fan_faces)),
        "concave": (concave, concave_faces, centroid(concave, concave_faces)),
        "jittered": (jitter, jitter_faces, centroid(jitter, jitter_faces)),
        "delaunay": (pts, delaunay, centroid(pts, delaunay)),
    }


CASES = mesh_cases()


def topology_args(mod, nodes, faces, centroids):
    edge_nodes, face_edges = mod.edge_connectivity(faces)
    edge_faces = mod.invert_dense(face_edges)
    if edge_faces.shape[1] == 1:
        edge_faces = np.column_stack([edge_faces[:, 0], np.full(len(edge_faces), -1)])
    return (mod.invert_dense_to_sparse(faces), nodes, centroids, edge_faces, edge_nodes)


def polygons(faces):
    """Each row's cycle of vertex ids, started at its smallest id."""
    out = []
    for row in faces:
        ids = row[row >= 0]
        k = int(np.argmin(ids))
        out.append(tuple(np.roll(ids, -k)))
    return out


def assert_same_tessellation(got, want):
    vertices, faces, face_index, interp = got
    np.testing.assert_allclose(vertices, want[0], rtol=0, atol=1e-12)
    assert polygons(faces) == polygons(want[1])
    np.testing.assert_array_equal(face_index, want[2])
    if want[3] is None:
        assert interp is None
    else:
        np.testing.assert_array_equal(interp, want[3])


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_voronoi_topology_matches_jax(case, mode):
    nodes, faces, centroids = CASES[case]
    want = jax_voronoi.voronoi_topology(*topology_args(jax_connectivity, nodes, faces, centroids), **MODES[mode])
    got = voronoi.voronoi_topology(
        *topology_args(connectivity, nodes, faces, centroids), **MODES[mode], device="cpu"
    )
    assert_same_tessellation(got, want)
    assert len(got[1]) > 0


def test_degenerate_projection_maps_to_its_centroid():
    nodes, faces, centroids = CASES["degenerate"]
    vertices, _, face_index, interp = voronoi.voronoi_topology(
        *topology_args(connectivity, nodes, faces, centroids),
        add_exterior=True, add_vertices=True, device="cpu",
    )
    # Every circumcenter lies on its boundary edge: no projection is kept.
    assert len(vertices) == len(faces) + 4 and (face_index[len(faces):] == -1).all()
    assert (interp < len(faces)).all()


def test_concave_case_skips_concave_cells():
    nodes, faces, centroids = CASES["concave"]
    args = topology_args(connectivity, nodes, faces, centroids)
    areas = []
    for skip in (False, True):
        vertices, cells, _, _ = voronoi.voronoi_topology(
            *args, add_exterior=True, add_vertices=True, skip_concave=skip, device="cpu"
        )
        areas.append(np.abs(voronoi.padded_row_areas(cells, vertices)).sum())
    assert areas[0] < areas[1]


def test_missing_edge_connectivity_raises():
    nodes, faces, centroids = CASES["rectangle"]
    with pytest.raises(ValueError, match="must be provided if add_exterior is True"):
        voronoi.voronoi_topology(
            connectivity.invert_dense_to_sparse(faces), nodes, centroids, add_exterior=True, device="cpu"
        )


@pytest.mark.parametrize("rows", [8191, 8192, 20000], ids=["numpy", "device_edge", "device"])
def test_angle_sort_rows_matches_jax(rows):
    """(rows, 4, 2) offsets: 65,528 values sort in numpy, 65,536 and more
    as torch ops on the given device (here the CPU)."""
    rng = np.random.default_rng(rows)
    coords = rng.normal(size=(500, 2)) * 1e5 + 5e5  # UTM-like magnitudes
    cand = rng.integers(-1, 500, (rows, 4))
    anchors = coords[rng.integers(0, 500, rows)] + rng.normal(scale=10.0, size=(rows, 2))
    assert (rows * 4 * 2 >= voronoi.DEVICE_MIN) == (rows >= 8192)
    got = voronoi.angle_sort_rows(cand, coords, anchors, torch.device("cpu"))
    want = jax_voronoi.angle_sort_rows(cand, coords, anchors)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got >= 0, want >= 0)
    assert polygons(got) == polygons(want)


def test_angle_sort_rows_device_path_matches_numpy(monkeypatch):
    rng = np.random.default_rng(9)
    coords = rng.normal(size=(300, 2))
    cand = rng.integers(-1, 300, (400, 6))
    anchors = rng.normal(scale=0.01, size=(400, 2))
    host = voronoi.angle_sort_rows(cand, coords, anchors, "cpu")
    monkeypatch.setattr(voronoi, "DEVICE_MIN", 0)
    assert polygons(voronoi.angle_sort_rows(cand, coords, anchors, "cpu")) == polygons(host)


def test_renumber_matches_jax():
    a = np.array([[7, 3, -1], [3, 12, 7], [-1, -1, 40]])
    np.testing.assert_array_equal(connectivity.renumber(a), jax_connectivity.renumber(a))
