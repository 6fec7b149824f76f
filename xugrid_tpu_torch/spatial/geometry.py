"""
Padded polygon buffers (host, numpy), and 2D geometry primitives as torch
ops on any device: the exact tests of the BVH queries
(``spatial/queries.py``) and of the faces the native host kernels
decline by size.

A padded polygon is ``(n_max, 2)`` vertices whose unused trailing slots
repeat the first vertex: zero-length edges that every predicate ignores.
Each primitive carries the name and arithmetic of its counterpart in
``xugrid_tpu/spatial/geometry.py`` and broadcasts over leading
dimensions: one call on a single primitive equals that function, one
call on a batch equals its ``vmap``.
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


def polygon_edges(poly):
    """Consecutive vertex pairs including the closing edge.

    poly: (..., n_max, 2) -> (a, b) each (..., n_max, 2)."""
    return poly, torch.roll(poly, -1, dims=-2)


def _point_segment_dist2(px, py, ax, ay, bx, by):
    """Squared distance from points to segments (broadcast)."""
    dx = bx - ax
    dy = by - ay
    len2 = dx * dx + dy * dy
    t = torch.where(len2 == 0.0, 0.0, ((px - ax) * dx + (py - ay) * dy) / torch.clamp(len2, min=1e-300))
    t = torch.clamp(t, 0.0, 1.0)
    return (px - (ax + t * dx)) ** 2 + (py - (ay + t * dy)) ** 2


def point_in_polygon(point, poly, tolerance=0.0):
    """
    Crossing-number point in polygon, or within ``tolerance`` of an edge
    (``None``: no edge test).

    point: (..., 2); poly: (..., n_max, 2) padded; leading dimensions
    broadcast.  Returns (...) bool.
    """
    a, b = polygon_edges(poly)
    ax, ay, bx, by = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    px, py = point[..., 0, None], point[..., 1, None]
    # Ray casting to +x: count crossings of edges straddling py.
    straddle = (ay > py) != (by > py)
    denom = torch.where(by - ay == 0.0, 1.0, by - ay)
    x_at = ax + (py - ay) * (bx - ax) / denom
    inside = (straddle & (px < x_at)).sum(dim=-1) % 2 == 1
    if tolerance is not None:
        d2 = _point_segment_dist2(px, py, ax, ay, bx, by)
        inside = inside | (d2.amin(dim=-1) <= tolerance * tolerance)
    return inside


def point_on_segment_param(point, a, b, tolerance):
    """
    Parametric position of ``point`` along segment a->b if within
    ``tolerance`` of it: (on_segment, t), broadcast over leading
    dimensions (coordinates last).
    """
    px, py, ax, ay, bx, by = point[..., 0], point[..., 1], a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    d2 = _point_segment_dist2(px, py, ax, ay, bx, by)
    dx, dy = bx - ax, by - ay
    len2 = torch.clamp(dx * dx + dy * dy, min=1e-300)
    t = torch.clamp(((px - ax) * dx + (py - ay) * dy) / len2, 0.0, 1.0)
    return d2 <= tolerance * tolerance, t


def clip_segment_by_convex_polygon(p0, p1, poly):
    """
    Liang-Barsky style parametric clip of segment p0->p1 against a convex
    CCW polygon: (valid, t0, t1), the segment parameter interval inside
    the polygon.  p0, p1: (..., 2); poly: (..., n_max, 2); leading
    dimensions broadcast.
    """
    a, b = polygon_edges(poly)
    # CCW edge normals point inward: n = (-(by - ay), bx - ax)
    ex = b[..., 0] - a[..., 0]
    ey = b[..., 1] - a[..., 1]
    nx, ny = -ey, ex
    degenerate = (ex == 0.0) & (ey == 0.0)
    dx = (p1[..., 0] - p0[..., 0])[..., None]
    dy = (p1[..., 1] - p0[..., 1])[..., None]
    denom = nx * dx + ny * dy  # > 0: entering, < 0: leaving
    num = nx * (a[..., 0] - p0[..., 0, None]) + ny * (a[..., 1] - p0[..., 1, None])
    t_edge = torch.where(denom == 0.0, 0.0, num / torch.where(denom == 0.0, 1.0, denom))
    # Parallel to an edge and outside its half-plane (n . (p0 - a) >= 0,
    # i.e. -num >= 0): no intersection.
    parallel_outside = (denom == 0.0) & (num > 0.0) & ~degenerate
    entering = denom > 0.0
    t0 = torch.where(entering & ~degenerate, t_edge, 0.0).amax(dim=-1)
    t1 = torch.where(~entering & (denom != 0.0) & ~degenerate, t_edge, 1.0).amin(dim=-1)
    t0 = torch.clamp(t0, min=0.0)
    t1 = torch.clamp(t1, max=1.0)
    return (t0 < t1) & ~parallel_outside.any(dim=-1), t0, t1


def segment_segment_intersection(p0, p1, q0, q1):
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


def polygon_area(poly):
    """Shoelace area of padded polygon(s): (..., n_max, 2) -> (...)."""
    a, b = polygon_edges(poly)
    cross = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    return 0.5 * torch.abs(cross.sum(dim=-1))


def _leading_count(poly):
    """Vertices before the first-vertex padding of (B, m, 2) polygons (the
    padding is a suffix), and m where there is none: (B,) int64."""
    m = poly.shape[-2]
    is_pad = torch.cat(
        [torch.zeros_like(poly[:, :1, 0], dtype=torch.bool), (poly[:, 1:] == poly[:, :1]).all(dim=-1)], dim=1
    )
    return torch.where(is_pad.any(dim=1), is_pad.to(torch.int8).argmax(dim=1), m)


def clip_polygons_area(subject, clip, n_out: int | None = None):
    """
    Area of intersection of ``subject`` with the convex CCW polygon
    ``clip`` by Sutherland-Hodgman clipping in fixed-size buffers.

    subject: (..., m, 2) padded (first-vertex padding); clip: (..., k, 2)
    padded convex CCW; leading dimensions broadcast.  Returns (...).
    """
    lead = torch.broadcast_shapes(subject.shape[:-2], clip.shape[:-2])
    m, k = subject.shape[-2], clip.shape[-2]
    subject = subject.expand(lead + subject.shape[-2:]).reshape(-1, m, 2)
    clip = clip.expand(lead + clip.shape[-2:]).reshape(-1, k, 2)
    if n_out is None:
        n_out = m + k + 1
    n_batch = subject.shape[0]
    buf = torch.zeros((n_batch, n_out, 2), dtype=subject.dtype, device=subject.device)
    buf[:, :m] = subject
    count = torch.clamp(_leading_count(subject), min=1)
    idx = torch.arange(n_out, device=subject.device)[None, :]
    ca, cb = polygon_edges(clip)
    for i in range(k):
        a, b = ca[:, i], cb[:, i]
        ex, ey = (b[:, 0] - a[:, 0])[:, None], (b[:, 1] - a[:, 1])[:, None]
        degenerate = (ex == 0.0) & (ey == 0.0)
        # Signed distance to the (inward-normal) half plane.
        sd = -ey * (buf[..., 0] - a[:, None, 0]) + ex * (buf[..., 1] - a[:, None, 1])
        valid = idx < count[:, None]
        inside = (sd >= 0.0) & valid
        nxt = torch.where(idx + 1 < count[:, None], idx + 1, 0)
        sd_next = torch.gather(sd, 1, nxt)
        inside_next = sd_next >= 0.0
        q = torch.gather(buf, 1, nxt[..., None].expand(-1, -1, 2))
        denom = sd - sd_next
        t = torch.where(denom == 0.0, 0.0, sd / torch.where(denom == 0.0, 1.0, denom))
        inter = buf + t[..., None] * (q - buf)
        # Each edge (p -> q) emits up to two vertices: p where p is inside,
        # the crossing where the edge crosses the clip line.
        emit_p = inside
        emit_i = valid & (inside != inside_next)
        n_emit = emit_p.to(torch.int64) + emit_i.to(torch.int64)
        offsets = torch.cumsum(n_emit, dim=1) - n_emit
        # Rows that emit nothing write the dump slot n_out - 1, which no
        # real vertex reaches (count <= n_out - 1) and which is zeroed.
        new_buf = torch.zeros_like(buf)
        pos_p = torch.where(emit_p, offsets, n_out - 1)
        new_buf.scatter_(1, pos_p[..., None].expand(-1, -1, 2), buf)
        pos_i = torch.where(emit_i, offsets + emit_p.to(torch.int64), n_out - 1)
        new_buf.scatter_(1, pos_i[..., None].expand(-1, -1, 2), torch.where(emit_i[..., None], inter, 0.0))
        new_buf[:, n_out - 1] = 0.0
        buf = torch.where(degenerate[..., None], buf, new_buf)
        count = torch.where(degenerate[:, 0], count, n_emit.sum(dim=1))
    valid = idx < count[:, None]
    nxt = torch.where(idx + 1 < count[:, None], idx + 1, 0)
    b = torch.gather(buf, 1, nxt[..., None].expand(-1, -1, 2))
    cross = buf[..., 0] * b[..., 1] - buf[..., 1] * b[..., 0]
    area = 0.5 * torch.abs(torch.where(valid, cross, 0.0).sum(dim=1))
    return torch.where(count >= 3, area, 0.0).reshape(lead)


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
    sub_in = point_in_polygon(subject, clip[:, None], 0.0)
    clip_in = point_in_polygon(clip, subject[:, None], 0.0)
    hit, pts = segment_segment_intersection(sa[:, :, None], sb[:, :, None], ca[:, None, :], cb[:, None, :])
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


def convex_overlap_area(subject: torch.Tensor, clip: torch.Tensor) -> torch.Tensor:
    """Area of intersection of convex padded polygons: subject (..., m, 2),
    clip (..., k, 2), leading dimensions broadcast -> (...)."""
    lead = torch.broadcast_shapes(subject.shape[:-2], clip.shape[:-2])
    subject = subject.expand(lead + subject.shape[-2:]).reshape((-1,) + subject.shape[-2:])
    clip = clip.expand(lead + clip.shape[-2:]).reshape((-1,) + clip.shape[-2:])
    return convex_overlap_areas(subject, clip).reshape(lead)


def mean_value_weights(point: torch.Tensor, poly: torch.Tensor, tolerance: float) -> torch.Tensor:
    """
    Mean-value (generalized barycentric) coordinates of points (..., 2) in
    padded polygons (..., m, 2) -> (..., m), leading dimensions
    broadcast.  Padding vertices get zero weight; a point on an edge
    interpolates linearly between its two ends, and a point within
    ``tolerance`` of a vertex snaps to it.
    """
    lead = torch.broadcast_shapes(point.shape[:-1], poly.shape[:-2])
    m = poly.shape[-2]
    points = point.expand(lead + (2,)).reshape(-1, 2)
    polys = poly.expand(lead + (m, 2)).reshape(-1, m, 2)
    return _mean_value_weights(points, polys, tolerance).reshape(lead + (m,))


def _mean_value_weights(points: torch.Tensor, polys: torch.Tensor, tolerance: float) -> torch.Tensor:
    """``mean_value_weights`` of points (B, 2) in polygons (B, m, 2)."""
    m = polys.shape[1]
    n_vert = torch.clamp(_leading_count(polys), min=3)[:, None]
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
