"""Spatial index subsystem: the celltrees of the weight build (host), and
a flat BVH with batched queries as torch ops (``spatial/queries.py``)."""

from xugrid_tpu_torch.spatial.bvh import BVH, build_bvh
from xugrid_tpu_torch.spatial.celltree import CellTree2d, EdgeCellTree2d

__all__ = ["BVH", "build_bvh", "CellTree2d", "EdgeCellTree2d"]
