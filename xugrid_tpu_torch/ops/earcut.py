"""
Ear-clipping polygon triangulation with hole support (host, numpy).

Polygons arrive through vector input, are triangulated once, and the
triangles feed the burn and the earcut mesh.  Holes are joined to the
outer ring with the bridge construction (rightmost hole vertex connected
to the first visible outer vertex), after which plain ear clipping
applies; rings that the bridges leave only weakly simple get the extra
tests named in ``_ear_clip``.  Copied line by line from
``xugrid_tpu/ops/earcut.py``, so that both packages give the same
triangles.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def _signed_area(ring: np.ndarray) -> float:
    x = ring[:, 0]
    y = ring[:, 1]
    return 0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)


def _is_ccw(ring: np.ndarray) -> bool:
    return _signed_area(ring) > 0


def _point_in_triangle(p, a, b, c, eps=0.0):
    d1 = (p[0] - b[0]) * (a[1] - b[1]) - (a[0] - b[0]) * (p[1] - b[1])
    d2 = (p[0] - c[0]) * (b[1] - c[1]) - (b[0] - c[0]) * (p[1] - c[1])
    d3 = (p[0] - a[0]) * (c[1] - a[1]) - (c[0] - a[0]) * (p[1] - a[1])
    has_neg = (d1 < -eps) or (d2 < -eps) or (d3 < -eps)
    has_pos = (d1 > eps) or (d2 > eps) or (d3 > eps)
    return not (has_neg and has_pos)


def _find_bridge_target(ring_xy: np.ndarray, hx: float, hy: float) -> int:
    """
    Position (in ring order) of a ring vertex VISIBLE from the hole
    point (hx, hy) along the +x direction — the Eberly/mapbox bridge
    search: closest ray-edge intersection, then the intersected edge's
    right endpoint, demoted to the best reflex vertex inside the
    (M, I, P) triangle when one blocks the line of sight.
    """
    p = ring_xy
    q = np.roll(ring_xy, -1, axis=0)
    denom = q[:, 1] - p[:, 1]
    straddle = ((p[:, 1] <= hy) & (q[:, 1] >= hy)) | (
        (q[:, 1] <= hy) & (p[:, 1] >= hy)
    )
    safe = np.where(denom == 0.0, 1.0, denom)
    t = (hy - p[:, 1]) / safe
    xint = p[:, 0] + t * (q[:, 0] - p[:, 0])
    valid = straddle & (denom != 0.0) & (xint >= hx)
    if not valid.any():
        # A point inside the ring always has a ray crossing to the
        # right; none means the hole anchor lies OUTSIDE the ring
        # (invalid input).  Signal the caller to drop the hole rather
        # than splice a crossing bridge that corrupts the whole
        # triangulation.
        return -1

    xv = np.where(valid, xint, np.inf)
    e = int(np.argmin(xv))
    ix = xint[e]
    # Right endpoint of the intersected edge.
    e_next = (e + 1) % len(ring_xy)
    cand = e if ring_xy[e, 0] > ring_xy[e_next, 0] else e_next
    if ring_xy[cand, 0] < hx:
        cand = e if cand == e_next else e_next

    # Vertices inside triangle (M, I, P) block visibility; among them the
    # one with the smallest |tan| to the ray (ties: nearest) is visible.
    m = np.array([hx, hy])
    i_pt = np.array([ix, hy])
    c_pt = ring_xy[cand]
    vx = ring_xy[:, 0]
    # Only REFLEX vertices can block visibility (Eberly's construction).
    prev_xy = np.roll(ring_xy, 1, axis=0)
    next_xy = np.roll(ring_xy, -1, axis=0)
    corner_cross = (ring_xy[:, 0] - prev_xy[:, 0]) * (
        next_xy[:, 1] - ring_xy[:, 1]
    ) - (ring_xy[:, 1] - prev_xy[:, 1]) * (next_xy[:, 0] - ring_xy[:, 0])
    reflex = corner_cross < 0.0
    inside = np.zeros(len(ring_xy), dtype=bool)
    box_lo = min(hx, ix, c_pt[0])
    box_hi = max(hx, ix, c_pt[0])
    scan = np.flatnonzero((vx >= box_lo) & (vx <= box_hi) & reflex)
    for j in scan:
        if j == cand:
            continue
        if _point_in_triangle(ring_xy[j], m, i_pt, c_pt):
            inside[j] = True
    if inside.any():
        js = np.flatnonzero(inside)
        dx = ring_xy[js, 0] - hx
        dx = np.where(dx <= 0.0, np.inf, dx)
        tan = np.abs(ring_xy[js, 1] - hy) / dx
        d2 = np.sum((ring_xy[js] - m) ** 2, axis=1)
        order = np.lexsort((d2, tan))
        cand = int(js[order[0]])

    # Visibility certificate: the Eberly construction assumes a strictly
    # simple polygon, but previously spliced bridges make the ring only
    # WEAKLY simple and the chosen vertex can be occluded.  Verify the
    # bridge crosses no ring edge; otherwise take the nearest vertex
    # with a crossing-free bridge.
    if _bridge_crosses_ring(ring_xy, m, cand):
        d2_all = np.sum((ring_xy - m) ** 2, axis=1)
        for j in np.argsort(d2_all):
            j = int(j)
            if not _bridge_crosses_ring(ring_xy, m, j):
                return j
    return int(cand)


def _bridge_crosses_ring(ring_xy: np.ndarray, m: np.ndarray, cand: int) -> bool:
    """Does segment m -> ring_xy[cand] properly cross any ring edge?
    Edges sharing the candidate's coordinates (bridge duplicates) and
    mere endpoint touches do not count."""
    c = ring_xy[cand]
    p = ring_xy
    q = np.roll(ring_xy, -1, axis=0)

    def cross(ux, uy, vx, vy, wx, wy):
        return (vx - ux) * (wy - uy) - (vy - uy) * (wx - ux)

    d1 = cross(m[0], m[1], c[0], c[1], p[:, 0], p[:, 1])
    d2 = cross(m[0], m[1], c[0], c[1], q[:, 0], q[:, 1])
    d3 = cross(p[:, 0], p[:, 1], q[:, 0], q[:, 1], m[0], m[1])
    d4 = cross(p[:, 0], p[:, 1], q[:, 0], q[:, 1], c[0], c[1])
    proper = (d1 * d2 < 0.0) & (d3 * d4 < 0.0)
    # Ignore edges touching the candidate's coordinates.
    touches_c = (
        ((p[:, 0] == c[0]) & (p[:, 1] == c[1]))
        | ((q[:, 0] == c[0]) & (q[:, 1] == c[1]))
    )
    return bool((proper & ~touches_c).any())


def _locally_inside(prev_xy, v_xy, next_xy, b_xy) -> bool:
    """Is direction v -> b locally inside the CCW ring corner
    (prev, v, next)?  The mapbox-earcut ``locallyInside`` test —
    required to pick the right OCCURRENCE of a duplicated bridge vertex
    so the spliced ring stays planar at the shared point."""

    def cross(p, q, r):
        return (q[0] - p[0]) * (r[1] - p[1]) - (q[1] - p[1]) * (
            r[0] - p[0]
        )

    if cross(prev_xy, v_xy, next_xy) >= 0.0:  # convex corner
        return (
            cross(v_xy, b_xy, next_xy) <= 0.0
            and cross(v_xy, prev_xy, b_xy) <= 0.0
        )
    return (
        cross(v_xy, b_xy, prev_xy) > 0.0
        or cross(v_xy, next_xy, b_xy) > 0.0
    )


def _bridge_holes(outer: np.ndarray, holes: List[np.ndarray]):
    """
    Merge holes into the outer ring via bridges.  Returns the merged ring
    as an index list into the stacked vertex array (outer first, then
    holes in input order).
    """
    n_outer = len(outer)
    vertices = [outer]
    ring = list(range(n_outer))
    offset = n_outer

    # Process holes by decreasing rightmost x (robust bridging order).
    order = sorted(
        range(len(holes)), key=lambda k: -holes[k][:, 0].max()
    )
    spliced = []
    for k in order:
        hole = holes[k]
        nh = len(hole)
        # rightmost hole vertex
        h_local = int(np.argmax(hole[:, 0]))
        hx, hy = hole[h_local]
        coords = np.concatenate(vertices)
        ring_xy = coords[ring]
        best = _find_bridge_target(ring_xy, hx, hy)
        if best < 0:  # hole anchor outside the ring: skip the hole
            continue

        # If the target's coordinates occur more than once (earlier
        # bridges duplicate their anchor vertex), splice into the
        # occurrence whose corner wedge contains the bridge direction —
        # otherwise the ring crosses itself AT the shared vertex even
        # though no two edges properly intersect.
        t_xy = ring_xy[best]
        same = np.flatnonzero(
            (ring_xy[:, 0] == t_xy[0]) & (ring_xy[:, 1] == t_xy[1])
        )
        if len(same) > 1:
            m_xy = np.array([hx, hy])
            nr = len(ring_xy)
            for pos in same:
                pos = int(pos)
                if _locally_inside(
                    ring_xy[(pos - 1) % nr],
                    ring_xy[pos],
                    ring_xy[(pos + 1) % nr],
                    m_xy,
                ):
                    best = pos
                    break

        # Splice: ring[:best+1] + hole(h..h) + ring[best:]
        hole_indices = [offset + (h_local + i) % nh for i in range(nh)]
        new_ring = (
            ring[: best + 1]
            + hole_indices
            + [hole_indices[0], ring[best]]
            + ring[best + 1 :]
        )
        ring = new_ring
        vertices.append(hole)
        offset += nh
        spliced.append(k)

    return np.concatenate(vertices), ring, spliced


def _ear_clip(
    coords: np.ndarray, ring: Sequence[int], bridged: bool = False
) -> np.ndarray:
    """Triangulate a (possibly bridged) simple ring by ear clipping.

    ``bridged=True`` enables the extra tests required for weakly simple
    rings produced by hole bridging (all-vertex ear blocking plus a
    diagonal-crossing check, O(n) more work per candidate ear); plain
    simple polygons use the classic reflex-only test.
    """
    ring = list(ring)
    triangles = []
    guard = 0
    max_iter = 2 * len(ring) * len(ring) + 10
    extent = max(
        float(np.ptp(coords[:, 0])) if len(coords) else 1.0,
        float(np.ptp(coords[:, 1])) if len(coords) else 1.0,
    )
    eps = 1e-12 * extent * extent

    while len(ring) > 3 and guard < max_iter:
        n = len(ring)
        r_arr = np.array(ring, dtype=np.int64)
        xy = coords[r_arr]
        if bridged:
            # ANY ring vertex strictly inside the candidate ear blocks
            # it.  The classic reflex-only shortcut is a theorem for
            # strictly simple polygons, but bridged (weakly simple)
            # rings violate it: a hole chain can dip into an ear with
            # only a CONVEX vertex inside (both its edges crossing the
            # ear's diagonal).  Corner-coincident bridge duplicates are
            # exempted in the inner test below.
            reflex_pos = np.arange(n)
        else:
            prev_xy = np.roll(xy, 1, axis=0)
            next_xy = np.roll(xy, -1, axis=0)
            rcross = (xy[:, 0] - prev_xy[:, 0]) * (
                next_xy[:, 1] - xy[:, 1]
            ) - (xy[:, 1] - prev_xy[:, 1]) * (
                next_xy[:, 0] - xy[:, 0]
            )
            reflex_pos = np.flatnonzero(rcross <= eps)
        clipped = False
        for i in range(n):
            guard += 1
            i0, i1, i2 = ring[i - 1], ring[i], ring[(i + 1) % n]
            a, b, c = coords[i0], coords[i1], coords[i2]
            cross = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (
                c[0] - a[0]
            )
            if cross <= eps:  # reflex or degenerate corner
                continue
            # No ring vertex strictly inside the candidate ear (points
            # coinciding with an ear corner sit on the boundary and do
            # not block — bridge duplicates).
            ear_positions = {(i - 1) % n, i, (i + 1) % n}
            others = np.array(
                [p_ for p_ in reflex_pos if p_ not in ear_positions],
                dtype=np.int64,
            )
            ear_ok = True
            if len(others):
                pts = xy[others]
                dup = (
                    ((pts[:, 0] == a[0]) & (pts[:, 1] == a[1]))
                    | ((pts[:, 0] == b[0]) & (pts[:, 1] == b[1]))
                    | ((pts[:, 0] == c[0]) & (pts[:, 1] == c[1]))
                )
                d1 = (pts[:, 0] - b[0]) * (a[1] - b[1]) - (
                    a[0] - b[0]
                ) * (pts[:, 1] - b[1])
                d2 = (pts[:, 0] - c[0]) * (b[1] - c[1]) - (
                    b[0] - c[0]
                ) * (pts[:, 1] - c[1])
                d3 = (pts[:, 0] - a[0]) * (c[1] - a[1]) - (
                    c[0] - a[0]
                ) * (pts[:, 1] - a[1])
                has_neg = (d1 < -eps) | (d2 < -eps) | (d3 < -eps)
                has_pos = (d1 > eps) | (d2 > eps) | (d3 > eps)
                ear_ok = bool(((has_neg & has_pos) | dup).all())
            if ear_ok and bridged and n > 4:
                # The point test alone cannot catch a chain that dives
                # through the ear via a corner-coincident bridge
                # duplicate: also reject if any ring edge properly
                # crosses the new diagonal a -> c.  (Edges touching the
                # diagonal's endpoints give a zero cross product and
                # pass, so bridge slits along the diagonal are fine.)
                ep = xy
                eq = np.roll(xy, -1, axis=0)
                e1 = (c[0] - a[0]) * (ep[:, 1] - a[1]) - (
                    c[1] - a[1]
                ) * (ep[:, 0] - a[0])
                e2 = (c[0] - a[0]) * (eq[:, 1] - a[1]) - (
                    c[1] - a[1]
                ) * (eq[:, 0] - a[0])
                e3 = (eq[:, 0] - ep[:, 0]) * (a[1] - ep[:, 1]) - (
                    eq[:, 1] - ep[:, 1]
                ) * (a[0] - ep[:, 0])
                e4 = (eq[:, 0] - ep[:, 0]) * (c[1] - ep[:, 1]) - (
                    eq[:, 1] - ep[:, 1]
                ) * (c[0] - ep[:, 0])
                crossing = (e1 * e2 < 0.0) & (e3 * e4 < 0.0)
                crossing[(i - 1) % n] = False
                crossing[i] = False
                crossing[(i + 1) % n] = False
                if crossing.any():
                    ear_ok = False
            if ear_ok:
                triangles.append((i0, i1, i2))
                del ring[i]
                clipped = True
                break
        if not clipped:
            # Degenerate input: guarantee progress by removing a vertex,
            # but only EMIT the fallback corner when it is CCW — a CW
            # emission would double-cover exterior/hole area.
            a, b, c = coords[ring[0]], coords[ring[1]], coords[ring[2]]
            cross = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (
                c[0] - a[0]
            )
            if cross > 0.0:
                triangles.append((ring[0], ring[1], ring[2]))
            del ring[1]
    if len(ring) == 3:
        triangles.append((ring[0], ring[1], ring[2]))
    return np.array(triangles, dtype=np.int64).reshape(-1, 3)


def earcut_triangulate(vertices: np.ndarray, rings: np.ndarray) -> np.ndarray:
    """
    Triangulate a polygon with optional holes.

    Parameters
    ----------
    vertices: (n, 2) float array
        Stacked ring coordinates: exterior first, then holes.  Rings may
        be closed (first == last vertex) or open.
    rings: 1D int array
        Cumulative end offsets per ring, e.g. [len(exterior),
        len(exterior) + len(hole0), ...] (mapbox_earcut convention).

    Returns
    -------
    triangles: (n_triangle, 3) int array of indices into ``vertices``.
    """
    vertices = np.asarray(vertices, dtype=np.float64)
    rings = np.asarray(rings)
    starts = np.concatenate([[0], rings[:-1]])

    ring_list = []
    index_maps = []
    for s, e in zip(starts, rings):
        ring = vertices[s:e]
        indices = np.arange(s, e)
        # Drop an EXACT closing duplicate vertex (a relative-tolerance
        # comparison would eat legitimate short closing edges at large
        # coordinate magnitudes).
        if len(ring) > 1 and np.array_equal(ring[0], ring[-1]):
            ring = ring[:-1]
            indices = indices[:-1]
        ring_list.append((ring, indices))

    outer, outer_idx = ring_list[0]
    if not _is_ccw(outer):
        outer = outer[::-1]
        outer_idx = outer_idx[::-1]
    holes = []
    hole_idx = []
    for ring, indices in ring_list[1:]:
        if _is_ccw(ring):  # holes must be clockwise
            ring = ring[::-1]
            indices = indices[::-1]
        holes.append(ring)
        hole_idx.append(indices)

    if holes:
        merged_coords, merged_ring, hole_order = _bridge_holes(outer, holes)
        # Map local merged indices back to the original vertex numbering.
        # _bridge_holes appends holes in ITS processing order (sorted by
        # rightmost x), so the mapping must follow that order too.
        local_to_global = np.concatenate(
            [outer_idx] + [hole_idx[k] for k in hole_order]
        )
        tris_local = _ear_clip(merged_coords, merged_ring, bridged=True)
        return local_to_global[tris_local]
    tris_local = _ear_clip(outer, range(len(outer)))
    return outer_idx[tris_local]
