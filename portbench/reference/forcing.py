"""The area-weighted mean of raster values over each mesh face, in plain
PyTorch on any device: the regrid of a raster (the source) onto a mesh
(the target), as xugrid's ``OverlapRegridder(raster, mesh,
method="mean")`` gives it.

A face's window is the raster cells whose area of overlap with it is
positive: the pairs of ``overlap.overlap_triplets`` with their roles
swapped, the face as the target and the map cell as the source.  Its
mean is that of ``overlap.weighted_mean``: the non-NaN values weighted
by their areas, NaN where none is valid.  Map cells are numbered
row-major in the raster's own row order (north first when it is
descending), as a (y, x) payload reshaped to (y * x) holds them.

It follows xugrid's ``reduce.mean`` (the sum of w v over the sum of w,
over the valid values, NaN where that sum of weights is 0).
Departures: the products and sums are in float64 (the port's in the
values' dtype); pairs of zero area (faces that only touch a cell) are
left out, where xugrid keeps them at weight 0, which moves no mean.
"""

from __future__ import annotations

import torch

from portbench.reference.overlap import overlap_triplets, weighted_mean

#: Slices worked out at a time (the float64 block of a 1,560,000-face
#: mesh is 12.5 MB a slice).
BLOCK = 64


def face_triplets(nodes, faces, raster, device) -> tuple:
    """(face, map cell, area) of every pair with a positive area of
    overlap, float64."""
    cell, face, area = overlap_triplets(nodes, faces, raster, device)
    return face, cell, area


def face_means(triplets, values: torch.Tensor, n_face: int, dtype=torch.float64, block: int = BLOCK):
    """Per block of ``block`` slices of ``values`` (E, map cells): its
    first slice and the (rows, n_face) float64 mean over each face.
    ``dtype`` is the precision of the products and the sums."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for start in range(0, values.shape[0], block):
        yield start, weighted_mean(triplets, values[start : start + block], n_face, dtype)
