"""Polygon primitives of the serving postprocess and the detection
trainer: hulls, min-area rectangles, mitre offsets (expansion of word
quads, shrinking of mask polygons) and convex clip areas (counterpart of
``ocrs_models_tpu/geometry/polygon.py``).

Each public function uses the C++ core (:mod:`.native`) when it is
available and its numpy version (the ``*_numpy`` functions) otherwise.
"""

from __future__ import annotations

import numpy as np

from . import native

_EPS = 1e-9


def polygon_area(poly: np.ndarray) -> float:
    """Signed shoelace area (positive = counter-clockwise in a y-up frame)."""
    p = np.asarray(poly, dtype=np.float64)
    if len(p) < 3:
        return 0.0
    x, y = p[:, 0], p[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain; counter-clockwise vertices (y-up sense)."""
    pts = np.unique(np.asarray(points, dtype=np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: list[np.ndarray] = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper: list[np.ndarray] = []
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.array(lower[:-1] + upper[:-1])


def min_area_rect_numpy(points: np.ndarray) -> np.ndarray:
    """Minimum-area enclosing rotated rectangle (rotating calipers over the
    convex hull); ``4x2`` corners, consecutive around the rectangle."""
    hull = convex_hull(np.asarray(points, dtype=np.float64))
    if len(hull) == 0:
        return np.zeros((4, 2))
    if len(hull) == 1:
        return np.tile(hull[0], (4, 1))
    if len(hull) == 2:  # zero-width rect along the segment
        a, b = hull
        return np.array([a, b, b, a])
    edges = np.roll(hull, -1, axis=0) - hull
    lengths = np.hypot(edges[:, 0], edges[:, 1])
    keep = lengths > _EPS
    dirs = edges[keep] / lengths[keep][:, None]
    normals = np.stack([-dirs[:, 1], dirs[:, 0]], axis=1)
    proj_d = dirs @ hull.T  # [E, H]
    proj_n = normals @ hull.T
    areas = (proj_d.max(axis=1) - proj_d.min(axis=1)) * (
        proj_n.max(axis=1) - proj_n.min(axis=1)
    )
    i = int(np.argmin(areas))
    d, n = dirs[i], normals[i]
    x0, x1 = proj_d[i].min(), proj_d[i].max()
    y0, y1 = proj_n[i].min(), proj_n[i].max()
    return np.array([x0 * d + y0 * n, x1 * d + y0 * n, x1 * d + y1 * n, x0 * d + y1 * n])


def min_area_rect(points: np.ndarray) -> np.ndarray:
    if native.available():
        return native.min_area_rect(points)
    return min_area_rect_numpy(points)


def offset_ring_numpy(poly: np.ndarray, dist: float) -> np.ndarray:
    """Offset a simple closed ring by ``dist`` with mitre joins; positive
    shrinks, negative expands, for either vertex orientation."""
    p = np.asarray(poly, dtype=np.float64)
    keep = np.linalg.norm(p - np.roll(p, 1, axis=0), axis=1) > _EPS
    p = p[keep]
    if len(p) < 3:
        return np.zeros((0, 2))
    area = polygon_area(p)
    if abs(area) < _EPS:
        return np.zeros((0, 2))
    sign = 1.0 if area > 0 else -1.0
    edges = np.roll(p, -1, axis=0) - p
    dirs = edges / np.hypot(edges[:, 0], edges[:, 1])[:, None]
    inward = sign * np.stack([-dirs[:, 1], dirs[:, 0]], axis=1)
    # New vertex i = intersection of the offset lines of edges i-1 and i.
    o_pts = p + dist * inward
    out = np.empty_like(p)
    n = len(p)
    for i in range(n):
        j = (i - 1) % n
        d1, d2 = dirs[j], dirs[i]
        p1, p2 = o_pts[j], o_pts[i]
        denom = d1[0] * d2[1] - d1[1] * d2[0]
        if abs(denom) < 1e-12:
            out[i] = p[i] + dist * inward[i]
        else:
            t = ((p2[0] - p1[0]) * d2[1] - (p2[1] - p1[1]) * d2[0]) / denom
            out[i] = p1 + t * d1
    return out


def expand_polygon(poly, dist: float) -> np.ndarray:
    """Offset every edge of a polygon outward by ``dist`` (mitre joins)."""
    p = np.asarray(poly, dtype=np.float64)
    if native.available():
        return native.polygon_offset(p, -dist)
    return offset_ring_numpy(p, -dist)


def expand_quad(quad: np.ndarray, dist: float) -> np.ndarray:
    """Outward offset by ``dist``, then the min-area rect of the result."""
    quad = np.asarray(quad, dtype=np.float64)
    if np.ptp(quad, axis=0).max() < _EPS:  # point-like: cannot offset
        return quad
    expanded = expand_polygon(quad, dist)
    if len(expanded) < 3:
        return quad
    return min_area_rect(expanded)


def expand_quads(quads: np.ndarray, dist: float) -> np.ndarray:
    """Expand each quad of an ``Nx4x2`` array."""
    quads = np.asarray(quads, dtype=np.float64)
    if len(quads) == 0:
        return quads.reshape(0, 4, 2)
    return np.stack([expand_quad(q, dist) for q in quads])


def _segments_intersect(p1, p2, p3, p4) -> bool:
    def orient(a, b, c):
        v = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        if v > _EPS:
            return 1
        if v < -_EPS:
            return -1
        return 0

    o1, o2 = orient(p1, p2, p3), orient(p1, p2, p4)
    o3, o4 = orient(p3, p4, p1), orient(p3, p4, p2)
    return o1 != o2 and o3 != o4


def _ring_is_simple(poly: np.ndarray) -> bool:
    """True if no two non-adjacent edges of the ring intersect."""
    p = np.asarray(poly, dtype=np.float64)
    n = len(p)
    if n < 3:
        return False
    b = np.roll(p, -1, axis=0)
    for i in range(n):
        for j in range(i + 1, n):
            if (j + 1) % n == i or (i + 1) % n == j:
                continue
            if _segments_intersect(p[i], b[i], p[j], b[j]):
                return False
    return True


def shrink_polygon_numpy(poly, dist: float) -> list[tuple[float, float]]:
    """Move every edge of a polygon inward by ``dist`` (mitre joins).

    Empty when the polygon does not survive the shrink, as the GEOS
    parallel offset of the reference splits it: the offset ring flips
    orientation, does not lose area, or intersects itself."""
    p = np.asarray(poly, dtype=np.float64)
    orig_area = polygon_area(p)
    out = offset_ring_numpy(p, dist)
    if len(out) < 3:
        return []
    new_area = polygon_area(out)
    if new_area * orig_area <= 0 or abs(new_area) >= abs(orig_area):
        return []
    if not _ring_is_simple(out):
        return []
    return [(float(x), float(y)) for x, y in out]


def shrink_polygon(poly, dist: float) -> list[tuple[float, float]]:
    if native.available():
        out = native.polygon_offset(np.asarray(poly, dtype=np.float64), dist)
        return [(float(x), float(y)) for x, y in out]
    return shrink_polygon_numpy(poly, dist)


def _clip_convex(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman clip of polygon ``subject`` by convex ``clip``."""
    clip = np.asarray(clip, dtype=np.float64)
    if polygon_area(clip) < 0:
        clip = clip[::-1]
    output = list(np.asarray(subject, dtype=np.float64))
    n = len(clip)
    for i in range(n):
        if not output:
            return np.zeros((0, 2))
        a, b = clip[i], clip[(i + 1) % n]
        ex, ey = b[0] - a[0], b[1] - a[1]

        def inside(p):
            return ex * (p[1] - a[1]) - ey * (p[0] - a[0]) >= -_EPS

        def intersect(p, q):
            dx, dy = q[0] - p[0], q[1] - p[1]
            denom = ex * dy - ey * dx
            if abs(denom) < 1e-15:
                return q
            t = (ex * (a[1] - p[1]) - ey * (a[0] - p[0])) / denom
            return np.array([p[0] + t * dx, p[1] + t * dy])

        new_output = []
        m = len(output)
        for j in range(m):
            cur, nxt = output[j], output[(j + 1) % m]
            cur_in, nxt_in = inside(cur), inside(nxt)
            if cur_in:
                new_output.append(cur)
                if not nxt_in:
                    new_output.append(intersect(cur, nxt))
            elif nxt_in:
                new_output.append(intersect(cur, nxt))
        output = new_output
    return np.array(output) if output else np.zeros((0, 2))


def convex_intersection_area_numpy(a: np.ndarray, b: np.ndarray) -> float:
    """Area of the intersection of two convex polygons."""
    a = np.asarray(a, dtype=np.float64)
    if polygon_area(a) < 0:
        a = a[::-1]
    inter = _clip_convex(a, np.asarray(b, dtype=np.float64))
    if len(inter) < 3:
        return 0.0
    return abs(polygon_area(inter))


def convex_intersection_area(a: np.ndarray, b: np.ndarray) -> float:
    if native.available():
        return native.convex_clip_area(a, b)
    return convex_intersection_area_numpy(a, b)
