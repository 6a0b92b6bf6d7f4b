"""Polygon primitives the serving postprocess needs: hulls, min-area
rectangles and mitre offsets (counterpart of the matching functions of
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
