"""
Unstructured-grid adapters of the regridders: each join returns flat
triplets ``(source_index, target_index, weights)``.

The geometry runs on the host: the celltree's grid hash and native
kernels (``spatial/celltree.py``, whose exact geometry of faces above
the native sizes runs on the caller's torch device), the centroidal
voronoi tessellation (``ugrid/voronoi.py``, whose angle sort of a large
mesh runs on that device too), and vectorized numpy weight fix-ups.
The adapters take a topology or a UgridDataArray / UgridDataset over
one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from xugrid_tpu_torch.constants import FloatDType
from xugrid_tpu_torch.ugrid import voronoi
from xugrid_tpu_torch.ugrid.ugrid1d import Ugrid1d
from xugrid_tpu_torch.ugrid.ugrid2d import Ugrid2d
from xugrid_tpu_torch.utils.device import resolve_device
from xugrid_tpu_torch.utils.profiling import timed


def _topology_of(obj, allowed, options):
    from xugrid_tpu_torch.core.wrap import UgridDataArray, UgridDataset

    if isinstance(obj, (UgridDataArray, UgridDataset)):
        obj = obj.grid
    if isinstance(obj, allowed):
        return obj
    raise TypeError(f"Expected one of {options}, received: {type(obj).__name__}")


def _by_target(source_index, target_index, weights):
    """Canonical triplet ordering: stable sort on the target column."""
    order = np.argsort(target_index, kind="stable")
    return source_index[order], target_index[order], weights[order]


def replace_interpolated_weights(
    vertices,
    faces,
    face_index,
    weights,
    node_to_node_map,
    node_index_threshold,
):
    """
    Redistribute the barycentric weight of interpolated exterior vertices
    to the two projection nodes they were interpolated from, by inverse
    distance.  Mutates ``weights`` in place.
    """
    n, m = weights.shape
    face_nodes = faces[face_index]  # (n, m) voronoi node ids per point
    is_interp = (face_nodes >= node_index_threshold) & (weights > 0)
    if not is_interp.any():
        return

    rows, cols = np.nonzero(is_interp)
    p = face_nodes[rows, cols]
    qr = node_to_node_map[p - node_index_threshold]
    q, r = qr[:, 0], qr[:, 1]
    pxy = vertices[p]
    d_q = np.linalg.norm(vertices[q] - pxy, axis=1)
    d_r = np.linalg.norm(vertices[r] - pxy, axis=1)
    total = d_q + d_r
    w = weights[rows, cols]
    weight_q = (d_r / total) * w
    weight_r = (d_q / total) * w
    weights[rows, cols] = 0.0

    # Scatter-add onto the slots holding q and r within each row.
    row_nodes = face_nodes[rows]  # (k, m)
    match_q = row_nodes == q[:, None]
    match_r = row_nodes == r[:, None]
    np.add.at(weights, (np.repeat(rows, m), np.tile(np.arange(m), len(rows))),
              (match_q * weight_q[:, None] + match_r * weight_r[:, None]).ravel())


class UnstructuredGrid2d:
    """Weight-building adapter around a Ugrid2d topology."""

    def __init__(self, obj):
        self.ugrid_topology = _topology_of(obj, Ugrid2d, ["Ugrid2d", "UgridDataArray", "UgridDataset"])

    @property
    def ndim(self):
        return 1

    @property
    def dims(self):
        return (self.ugrid_topology.face_dimension,)

    @property
    def shape(self):
        return (self.ugrid_topology.n_face,)

    @property
    def size(self):
        return self.ugrid_topology.n_face

    @property
    def area(self):
        return self.ugrid_topology.area

    def convert_to(self, matched_type):
        if isinstance(self, matched_type):
            return self
        raise TypeError(f"Cannot convert UnstructuredGrid2d to {matched_type.__name__}")

    def overlap(self, other, relative: bool, device=None):
        """
        Area-of-overlap join.  The index lives on this (source) grid and
        the probes are ``other``'s (target's) polygons, so the celltree
        hands back (target, source) pairs.  With ``relative=True`` each
        area is divided by its SOURCE cell area (first-order conservative
        weighting).  Faces above the native clips' sizes are clipped on
        ``device``.
        """
        topo = other.ugrid_topology
        tgt, src, area = self.ugrid_topology.celltree.intersect_faces(
            vertices=topo.node_coordinates,
            faces=topo.face_node_connectivity,
            fill_value=topo.fill_value,
            device=device,
        )
        if relative:
            area = area / self.area[src]
        return src, tgt, area

    def locate_centroids(self, other, tolerance: Optional[float] = None):
        """Point-in-face join at the target centroids (weight 1 each)."""
        homes = self.ugrid_topology.celltree.locate_points(other.ugrid_topology.centroids, tolerance)
        hit = np.flatnonzero(homes >= 0)
        return homes[hit], hit.astype(homes.dtype), np.ones(hit.size, dtype=FloatDType)

    def _voronoi_support(self, device):
        """Centroidal voronoi tessellation of this grid, as a Ugrid2d,
        plus the voronoi-node -> source-face map and the interpolated
        exterior-node bookkeeping.  The angle sort runs on ``device``."""
        grid = self.ugrid_topology
        with timed("voronoi.topology"):
            vertices, faces, node_to_face_index, node_to_node_map = voronoi.voronoi_topology(
                grid.node_face_connectivity,
                grid.node_coordinates,
                grid.centroids,
                edge_face_connectivity=grid.edge_face_connectivity,
                edge_node_connectivity=grid.edge_node_connectivity,
                add_exterior=True,
                add_vertices=True,
                skip_concave=True,
                device=device,
            )
        tess = Ugrid2d(vertices[:, 0], vertices[:, 1], -1, faces)
        return tess, vertices, node_to_face_index, node_to_node_map

    def barycentric(self, other, tolerance: Optional[float] = None, *, device=None):
        """
        Smooth-interpolation join: barycentric weights of each target
        centroid within the source's centroidal voronoi tessellation.
        Voronoi nodes ARE source centroids, so a weight on a voronoi
        node is a weight on a source face.  The angle sort and the
        weights in cells above the native kernel's 64 nodes run on
        ``device``: None means the CUDA card, and raises without one.
        """
        device = resolve_device(None, device)
        points = other.ugrid_topology.centroids
        tess, vertices, node_to_face, node_pairs = self._voronoi_support(device)

        with timed("barycentric.locate_and_weigh_in_tessellation"):
            cell_of, table = tess.compute_barycentric_weights(points, tolerance, device=device)

        # Exterior voronoi nodes interpolated between two projections
        # carry no source face: push their weight onto the projections.
        n_interp = 0 if node_pairs is None else len(node_pairs)
        if n_interp:
            replace_interpolated_weights(
                vertices=vertices,
                faces=tess.face_node_connectivity,
                face_index=cell_of,
                weights=table,
                node_to_node_map=node_pairs,
                node_index_threshold=len(vertices) - n_interp,
            )

        # Kill rows whose point missed the original grid, then collapse
        # the dense (point, slot) table to triplets on positive weight.
        with timed("barycentric.locate_in_source"):
            outside = self.ugrid_topology.locate_points(points) < 0
        table[outside] = 0.0
        point_ix, slot = np.nonzero(table > 0)
        slot_nodes = tess.face_node_connectivity[cell_of[point_ix], slot]
        return _by_target(
            node_to_face[np.maximum(slot_nodes, 0)],  # -1 pads: w=0 rows never reach here
            point_ix,
            table[point_ix, slot],
        )

    def intersection_length(self, other, relative: bool):
        """
        Length-of-intersection join with a 1D network: the probes are the
        network edges, the tree holds this grid's faces.  Returns
        (network_edge_index, face_index, length), sorted by face; with
        ``relative`` each length is divided by its network edge's length.
        """
        edge_ix, face_ix, segs = self.ugrid_topology.celltree.intersect_edges(
            other.ugrid_topology.edge_node_coordinates
        )
        delta = segs[:, 1, :] - segs[:, 0, :]
        length = np.hypot(delta[:, 0], delta[:, 1])
        if relative:
            length = length / other.length[edge_ix]
        face_s, edge_s, length_s = _by_target(face_ix, edge_ix, length)
        return edge_s, face_s, length_s

    def to_dataset(self, name: str):
        """The topology's UGRID dataset under the name ``name``, with a
        ``{name}_type`` variable naming this adapter."""
        ds = self.ugrid_topology.rename(name).to_dataset()
        ds[name + "_type"] = ((), np.int64(-1), {"type": "UnstructuredGrid2d"})
        return ds


class Network1d:
    """Weight-building adapter around a Ugrid1d network."""

    def __init__(self, obj):
        self.ugrid_topology = _topology_of(obj, Ugrid1d, ["Ugrid1d", "UgridDataArray", "UgridDataset"])

    @property
    def ndim(self):
        return 1

    @property
    def dims(self):
        return (self.ugrid_topology.edge_dimension,)

    @property
    def shape(self):
        return (self.ugrid_topology.n_edge,)

    @property
    def size(self):
        return self.ugrid_topology.n_edge

    @property
    def length(self) -> np.ndarray:
        """The length of each edge."""
        return self.ugrid_topology.edge_length

    def to_dataset(self, name: str):
        """The network's UGRID dataset under the name ``name``, with a
        ``{name}_type`` variable naming this adapter."""
        ds = self.ugrid_topology.rename(name).to_dataset()
        ds[name + "_type"] = ((), np.int64(-1), {"type": "Network1d"})
        return ds
