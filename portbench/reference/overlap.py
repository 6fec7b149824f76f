"""Areas of overlap between convex mesh faces and the cells of an
axis-aligned raster, and the area-weighted mean over them, in plain
PyTorch on any device."""

from __future__ import annotations

import math

import numpy as np
import torch

#: Candidate pairs clipped at once.
PAIR_BLOCK = 1 << 19


def _clip(poly: torch.Tensor, count: torch.Tensor, signed: torch.Tensor, value: torch.Tensor, axis: int):
    """Sutherland-Hodgman: keep the part of each polygon where
    ``signed`` times (coordinate ``axis`` - ``value``) >= 0.  poly (B, V,
    2) holds ``count`` vertices per row; returns (B, V + 1, 2) and the
    new counts.  Points on the clip line get the line's coordinate
    exactly."""
    B, V, _ = poly.shape
    slot = torch.arange(V, device=poly.device)
    valid = slot[None, :] < count[:, None]
    nxt_index = torch.where(slot[None, :] + 1 < count[:, None], slot[None, :] + 1, 0)
    nxt = torch.gather(poly, 1, nxt_index[..., None].expand(B, V, 2))
    s_cur = signed[:, None] * (poly[..., axis] - value[:, None])
    s_nxt = signed[:, None] * (nxt[..., axis] - value[:, None])
    inside_cur, inside_nxt = s_cur >= 0, s_nxt >= 0
    crossing = valid & (inside_cur != inside_nxt)
    t = s_cur / torch.where(crossing, s_cur - s_nxt, 1.0)
    cross = poly + t[..., None] * (nxt - poly)
    cross[..., axis] = value[:, None].expand(B, V)
    # Candidates in cyclic order: vertex i if inside, then the crossing
    # of edge (i, i + 1) if the edge crosses the line.
    cand = torch.stack([poly, cross], dim=2).reshape(B, 2 * V, 2)
    keep = torch.stack([valid & inside_cur, crossing], dim=2).reshape(B, 2 * V)
    position = torch.cumsum(keep, dim=1) - 1
    out = torch.zeros((B, V + 1, 2), dtype=poly.dtype, device=poly.device)
    rows = torch.arange(B, device=poly.device)[:, None].expand(B, 2 * V)
    out[rows[keep], position[keep]] = cand[keep]
    return out, keep.sum(dim=1)


def _area(poly: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    B, V, _ = poly.shape
    slot = torch.arange(V, device=poly.device)
    nxt_index = torch.where(slot[None, :] + 1 < count[:, None], slot[None, :] + 1, 0)
    nxt = torch.gather(poly, 1, nxt_index[..., None].expand(B, V, 2))
    cross = poly[..., 0] * nxt[..., 1] - nxt[..., 0] * poly[..., 1]
    return 0.5 * torch.where(slot[None, :] < count[:, None], cross, 0.0).sum(dim=1)


def clip_areas(quads: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Area of each convex counterclockwise polygon (B, V, 2) inside its
    box (B, 4) = (xmin, xmax, ymin, ymax)."""
    B, V, _ = quads.shape
    # About the box's corner, so that the shoelace sums small numbers.
    corner = boxes[:, [0, 2]]
    poly = quads - corner[:, None, :]
    boxes = boxes - corner.repeat_interleave(2, dim=1)
    count = torch.full((B,), V, dtype=torch.long, device=quads.device)
    one = torch.ones(B, dtype=quads.dtype, device=quads.device)
    for column, axis, signed in ((0, 0, one), (1, 0, -one), (2, 1, one), (3, 1, -one)):
        poly, count = _clip(poly, count, signed, boxes[:, column], axis)
    return _area(poly, count)


def overlap_triplets(nodes, faces, raster, device) -> tuple:
    """(target cell, source face, area) of every pair with a positive
    area of overlap, float64.  Target cells are numbered row-major in the
    raster's row order (north first when it is descending)."""
    nodes_t = torch.as_tensor(np.asarray(nodes, dtype=np.float64), device=device)
    faces_t = torch.as_tensor(np.asarray(faces, dtype=np.int64), device=device)
    quads = nodes_t[faces_t]  # (F, V, 2)
    cell = raster.cell
    lo = torch.floor((quads.amin(dim=1) - torch.tensor([raster.left, raster.bottom], device=device)) / cell).long()
    hi = torch.floor((quads.amax(dim=1) - torch.tensor([raster.left, raster.bottom], device=device)) / cell).long()
    top = torch.tensor([raster.nx - 1, raster.ny - 1], device=device)
    lo, hi = torch.minimum(lo.clamp(min=0), top), torch.minimum(hi.clamp(min=0), top)
    span = int((hi - lo).max()) + 1 if len(faces_t) else 0
    targets, sources, areas = [], [], []
    offsets = torch.cartesian_prod(torch.arange(span, device=device), torch.arange(span, device=device))
    for start in range(0, len(faces_t), max(PAIR_BLOCK // max(span * span, 1), 1)):
        f = torch.arange(start, min(start + PAIR_BLOCK // max(span * span, 1), len(faces_t)), device=device)
        col = lo[f, 0][:, None] + offsets[None, :, 0]
        row = lo[f, 1][:, None] + offsets[None, :, 1]  # counted from the south
        ok = (col <= hi[f, 0][:, None]) & (row <= hi[f, 1][:, None])
        face = f[:, None].expand_as(col)[ok]
        col, row = col[ok], row[ok]
        xmin = raster.left + col.double() * cell
        ymin = raster.bottom + row.double() * cell
        boxes = torch.stack([xmin, xmin + cell, ymin, ymin + cell], dim=1)
        area = clip_areas(quads[face], boxes)
        positive = area > 0
        north_row = (raster.ny - 1 - row) if raster.descending else row
        targets.append((north_row * raster.nx + col)[positive])
        sources.append(face[positive])
        areas.append(area[positive])
    return torch.cat(targets), torch.cat(sources), torch.cat(areas)


def weighted_mean(triplets, values: torch.Tensor, n_target: int, dtype=torch.float64, block: int = 16) -> torch.Tensor:
    """(E, n_target): per target the area-weighted mean of the non-NaN
    source values, NaN where none overlaps.  ``dtype`` is the precision
    of the products and the sums; the result is float64."""
    target, source, area = triplets
    w = area.to(dtype)
    out = torch.empty((values.shape[0], n_target), dtype=torch.float64, device=values.device)
    for start in range(0, values.shape[0], block):
        v = values[start : start + block][:, source].to(dtype)
        valid = ~torch.isnan(v)
        wv = torch.where(valid, w[None, :], 0.0)
        numerator = torch.zeros((v.shape[0], n_target), dtype=dtype, device=v.device)
        denominator = torch.zeros_like(numerator)
        numerator.index_add_(1, target, wv * torch.where(valid, v, 0.0))
        denominator.index_add_(1, target, wv)
        ratio = numerator / torch.where(denominator > 0, denominator, 1.0)
        out[start : start + block] = torch.where(denominator > 0, ratio.double(), math.nan)
    return out
