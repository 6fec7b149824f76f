"""
Unstructured-grid adapter for the overlap regridders: exposes the
area-of-overlap join as flat triplets ``(source_index, target_index,
weights)``.
"""

from __future__ import annotations

from xugrid_tpu_torch.ugrid.ugrid2d import Ugrid2d


class UnstructuredGrid2d:
    """Weight-building adapter around a Ugrid2d topology."""

    def __init__(self, obj):
        if not isinstance(obj, Ugrid2d):
            raise TypeError(f"Expected Ugrid2d, received: {type(obj).__name__}")
        self.ugrid_topology = obj

    @property
    def size(self):
        return self.ugrid_topology.n_face

    @property
    def area(self):
        return self.ugrid_topology.area

    def overlap(self, other, relative: bool):
        """
        Area-of-overlap join.  The index lives on this (source) grid and
        the probes are ``other``'s (target's) polygons, so the celltree
        hands back (target, source) pairs.  With ``relative=True`` each
        area is divided by its SOURCE cell area (first-order conservative
        weighting).
        """
        topo = other.ugrid_topology
        tgt, src, area = self.ugrid_topology.celltree.intersect_faces(
            vertices=topo.node_coordinates,
            faces=topo.face_node_connectivity,
            fill_value=topo.fill_value,
        )
        if relative:
            area = area / self.area[src]
        return src, tgt, area
