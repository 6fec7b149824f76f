"""
Padded polygon buffers (host, numpy), and the exact geometry that the
native host kernels decline by size, as batched torch ops on a device.

A padded polygon is ``(n_max, 2)`` vertices whose unused trailing slots
repeat the first vertex: zero-length edges that every predicate ignores.
``convex_overlap_areas`` and ``mean_value_weights`` are the
counterparts of ``xugrid_tpu/spatial/geometry.py``'s
``convex_overlap_area`` and ``mean_value_weights`` (under
``spatial/queries.py``'s ``polygon_overlap_areas_kernel`` and
``barycentric_weights_kernel``), with the same arithmetic over a batch
axis in place of ``vmap``.
"""

from __future__ import annotations

import numpy as np
import torch


def pad_polygons(face_node_connectivity, node_x, node_y):
    """
    Gather per-face vertex buffers, replacing -1 fills with the first
    valid vertex so padding edges have zero length.

    Returns (n_face, n_max, 2) float64.
    """
    from xugrid_tpu_torch.utils.native import pad_and_bbox_native

    native = pad_and_bbox_native(face_node_connectivity, node_x, node_y)
    if native is not None:
        return native[0]
    conn = np.asarray(face_node_connectivity)
    # First VALID node per row: a malformed row may lead with a fill.
    valid = conn >= 0
    rows = np.arange(len(conn))
    first = np.where(
        valid.any(axis=1), conn[rows, np.argmax(valid, axis=1)], 0
    )[:, None]
    filled = np.where(conn < 0, first, conn)
    x = np.asarray(node_x, dtype=np.float64)
    y = np.asarray(node_y, dtype=np.float64)
    out = np.empty(filled.shape + (2,), dtype=np.float64)
    out[..., 0] = x[filled]
    out[..., 1] = y[filled]
    return out


def _points_in_polygons(points, polys):
    """Crossing-number point in polygon, or on an edge (distance 0):
    points (B, P, 2) in polys (B, k, 2) -> (B, P) bool."""
    a = polys[:, None, :, :]  # (B, 1, k, 2)
    b = torch.roll(polys, -1, dims=-2)[:, None, :, :]
    ax, ay, bx, by = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    px, py = points[..., 0, None], points[..., 1, None]  # (B, P, 1)
    straddle = (ay > py) != (by > py)
    denom = torch.where(by - ay == 0.0, 1.0, by - ay)
    x_at = ax + (py - ay) * (bx - ax) / denom
    inside = (straddle & (px < x_at)).sum(dim=-1) % 2 == 1
    dx, dy = bx - ax, by - ay
    len2 = dx * dx + dy * dy
    t = torch.where(len2 == 0.0, 0.0, ((px - ax) * dx + (py - ay) * dy) / torch.clamp(len2, min=1e-300))
    t = torch.clamp(t, 0.0, 1.0)
    d2 = (px - (ax + t * dx)) ** 2 + (py - (ay + t * dy)) ** 2
    return inside | (d2.amin(dim=-1) <= 0.0)


def _segment_intersections(p0, p1, q0, q1):
    """Intersections of segments p and q (broadcast over leading axes,
    coordinates last): (hit, point); collinear overlaps report the
    q0-side entry point, a miss NaN."""
    r = p1 - p0
    s = q1 - q0
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qp = q0 - p0
    t_num = qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]
    u_num = qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]
    parallel = denom == 0.0
    safe = torch.where(parallel, 1.0, denom)
    t = t_num / safe
    u = u_num / safe
    hit = ~parallel & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u <= 1.0)
    point = p0 + t[..., None] * r
    rr = r[..., 0] * r[..., 0] + r[..., 1] * r[..., 1]
    safe_rr = torch.where(rr == 0.0, 1.0, rr)
    s0 = ((q0[..., 0] - p0[..., 0]) * r[..., 0] + (q0[..., 1] - p0[..., 1]) * r[..., 1]) / safe_rr
    s1 = ((q1[..., 0] - p0[..., 0]) * r[..., 0] + (q1[..., 1] - p0[..., 1]) * r[..., 1]) / safe_rr
    lo = torch.clamp(torch.minimum(s0, s1), min=0.0)
    hi = torch.clamp(torch.maximum(s0, s1), max=1.0)
    col_hit = parallel & (t_num == 0.0) & (rr > 0.0) & (lo <= hi)
    hit = hit | col_hit
    point = torch.where(col_hit[..., None], p0 + lo[..., None] * r, point)
    return hit, torch.where(hit[..., None], point, torch.nan)


def convex_overlap_areas(subject: torch.Tensor, clip: torch.Tensor) -> torch.Tensor:
    """
    Area of intersection of convex padded polygons, pair by pair:
    subject (B, m, 2), clip (B, k, 2) -> (B,).

    The intersection's vertices are among the subject vertices inside the
    clip, the clip vertices inside the subject and the edge-edge
    intersections: all m + k + m k candidates are sorted by angle about
    the valid ones' centre, and a shoelace runs over the valid ones (the
    invalid, sorted last, repeat the first vertex and add no area).
    """
    m, k = subject.shape[1], clip.shape[1]
    sa, sb = subject, torch.roll(subject, -1, dims=1)
    ca, cb = clip, torch.roll(clip, -1, dims=1)
    sub_in = _points_in_polygons(subject, clip)
    clip_in = _points_in_polygons(clip, subject)
    hit, pts = _segment_intersections(sa[:, :, None], sb[:, :, None], ca[:, None, :], cb[:, None, :])
    s_degen = (sa == sb).all(dim=-1)
    c_degen = (ca == cb).all(dim=-1)
    hit = hit & ~s_degen[:, :, None] & ~c_degen[:, None, :]

    candidates = torch.cat([subject, clip, pts.reshape(-1, m * k, 2)], dim=1)
    valid = torch.cat([sub_in, clip_in, hit.reshape(-1, m * k)], dim=1)
    candidates = torch.where(valid[..., None], candidates, 0.0)
    n_valid = valid.sum(dim=1)
    center = candidates.sum(dim=1) / torch.clamp(n_valid, min=1)[:, None]
    angle = torch.where(
        valid,
        torch.atan2(candidates[..., 1] - center[:, None, 1], candidates[..., 0] - center[:, None, 0]),
        torch.inf,
    )
    order = torch.argsort(angle, dim=1, stable=True)
    pts_sorted = torch.gather(candidates, 1, order[..., None].expand(-1, -1, 2))
    valid_sorted = torch.gather(valid, 1, order)
    pts_final = torch.where(valid_sorted[..., None], pts_sorted, pts_sorted[:, :1])
    b = torch.roll(pts_final, -1, dims=1)
    cross = pts_final[..., 0] * b[..., 1] - pts_final[..., 1] * b[..., 0]
    area = 0.5 * torch.abs(cross.sum(dim=1))
    return torch.where(n_valid >= 3, area, 0.0)


def mean_value_weights(points: torch.Tensor, polys: torch.Tensor, tolerance: float) -> torch.Tensor:
    """
    Mean-value (generalized barycentric) coordinates of points (B, 2) in
    padded polygons (B, m, 2) -> (B, m).  Padding vertices get zero
    weight; a point on an edge interpolates linearly between its two
    ends, and a point within ``tolerance`` of a vertex snaps to it.
    """
    n, m = polys.shape[0], polys.shape[1]
    first = polys[:, :1]
    is_pad = torch.cat(
        [torch.zeros((n, 1), dtype=torch.bool, device=polys.device), (polys[:, 1:] == first).all(dim=-1)], dim=1
    )
    n_vert = torch.where(is_pad.any(dim=1), is_pad.to(torch.int8).argmax(dim=1), m)
    n_vert = torch.clamp(n_vert, min=3)[:, None]
    idx = torch.arange(m, device=polys.device)[None, :]
    valid = idx < n_vert

    d = polys - points[:, None, :]
    r = torch.sqrt((d * d).sum(dim=-1))
    nxt = torch.where(idx + 1 < n_vert, idx + 1, 0)
    d_next = torch.gather(d, 1, nxt[..., None].expand(-1, -1, 2))
    r_next = torch.gather(r, 1, nxt)
    cross = d[..., 0] * d_next[..., 1] - d[..., 1] * d_next[..., 0]
    dot = (d * d_next).sum(dim=-1)
    # tan(alpha_i / 2) = (r_i r_{i+1} - dot) / cross
    denom = torch.where(cross == 0.0, 1.0, cross)
    tan_half = torch.where(cross == 0.0, 0.0, (r * r_next - dot) / denom)
    prev = torch.where(idx == 0, n_vert - 1, idx - 1)
    safe_r = torch.where(r == 0.0, 1.0, r)
    w = torch.where(valid, (torch.gather(tan_half, 1, prev) + tan_half) / safe_r, 0.0)

    # On an edge alpha -> pi, where the mean-value limit is linear
    # interpolation between the edge's two ends.
    on_edge = valid & (torch.abs(cross) <= 1e-12 * r * r_next) & (dot < 0.0)
    i_edge = on_edge.to(torch.int8).argmax(dim=1, keepdim=True)
    r_i, r_n = torch.gather(r, 1, i_edge), torch.gather(r_next, 1, i_edge)
    r_sum = r_i + r_n
    r_sum = torch.where(r_sum == 0.0, 1.0, r_sum)
    w_edge = torch.zeros_like(w).scatter_add_(1, i_edge, r_n / r_sum)
    w_edge = w_edge.scatter_add_(1, torch.gather(nxt, 1, i_edge), r_i / r_sum)
    w = torch.where(on_edge.any(dim=1, keepdim=True), w_edge, w)

    # A vertex hit takes precedence over an edge.
    on_vertex = valid & (r <= tolerance)
    w = torch.where(on_vertex.any(dim=1, keepdim=True), on_vertex.to(w.dtype), w)
    total = w.sum(dim=1, keepdim=True)
    return w / torch.where(total == 0.0, 1.0, total)
