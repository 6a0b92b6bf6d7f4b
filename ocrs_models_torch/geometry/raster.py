"""Detection masks: polygon fill with Pillow's exact rule, and the mask of
a page's word polygons shrunk by ``SHRINK_DISTANCE`` (counterpart of
``ocrs_models_tpu/geometry/raster.py``).

The reference draws its training masks with ``PIL.ImageDraw.polygon``, so
the fill reproduces Pillow's rule bit for bit:

- vertices are truncated to ``int`` (a C cast toward zero) first;
- horizontal edges are drawn as inclusive rows of pixels;
- other edges give even-odd crossings at integer scanlines ``y`` over
  ``[ymin, ymax]`` in float32 arithmetic, ``(y - y0) * dx + x0`` with two
  roundings; an edge ending on this row repeats its crossing (but on the
  last row);
- span ends round half away from zero, the left as ``floor(x + 0.5)``, the
  right as ``ceil(x - 0.5)``, and a span whose left end passes its right
  draws nothing;
- where two edges of the same slope sign meet at an integer crossing on a
  shared end row, the span widens toward the next row's crossings
  (Pillow's "connect discontiguous corners").

:func:`fill_polygon` runs the C++ core when it is available and
:func:`fill_polygon_numpy` otherwise.
"""

from __future__ import annotations

import math

import numpy as np

from . import native
from .polygon import shrink_polygon

_F32 = np.float32


def _round_up(f: float) -> int:
    return int(math.floor(f + 0.5)) if f >= 0 else -int(math.floor(abs(f) + 0.5))


def _round_down(f: float) -> int:
    return int(math.ceil(f - 0.5)) if f >= 0 else -int(math.ceil(abs(f) - 0.5))


class _Edge:
    __slots__ = ("x0", "y0", "ymin", "ymax", "dx")

    def __init__(self, x0: int, y0: int, x1: int, y1: int):
        self.ymin, self.ymax = (y0, y1) if y0 <= y1 else (y1, y0)
        self.dx = _F32(x1 - x0) / _F32(y1 - y0)
        self.x0 = x0
        self.y0 = y0

    def cross(self, y: int):
        return _F32(_F32(y - self.y0) * self.dx + _F32(self.x0))


def _corner(edges: list[_Edge], i: int, cur: _Edge, y: int, gymax: int, x: np.float32):
    """Pillow's "connect discontiguous corners": ``(k, value)`` to widen
    crossing ``k`` to, or None."""
    for k in range(i):
        other = edges[k]
        if (cur.dx > 0 and other.dx <= 0) or (cur.dx < 0 and other.dx >= 0):
            continue
        if not (y in (cur.ymin, cur.ymax) and y in (other.ymin, other.ymax)):
            continue
        if x != other.cross(y):
            continue
        offset = -1 if y == gymax else 1
        a, b = cur.cross(y + offset), other.cross(y + offset)
        if (y == cur.ymax) == (cur.dx > 0):
            v = max(a, b) + _F32(1)
            widens = v < x
        else:
            v = min(a, b) - _F32(1)
            widens = v > x
        return (k, v) if widens else None
    return None


def fill_polygon_numpy(width: int, height: int, poly, out: np.ndarray) -> np.ndarray:
    """Pillow's ``ImageDraw.polygon(fill=1)`` of ``poly`` into the uint8
    ``[height, width]`` mask ``out``."""

    def hline(x0: int, y: int, x1: int) -> None:
        if y < 0 or y >= height or x0 > x1 or x1 < 0 or x0 >= width:
            return
        out[y, max(x0, 0) : min(x1, width - 1) + 1] = 1

    pts = [(int(x), int(y)) for x, y in np.asarray(poly, dtype=np.float64)]
    n = len(pts)
    edges: list[_Edge] = []
    gymin, gymax = height - 1, 0
    for i in range(n):
        x0, y0 = pts[i]
        x1, y1 = pts[(i + 1) % n]
        gymin = min(gymin, y0, y1)
        gymax = max(gymax, y0, y1)
        if y0 == y1:
            hline(min(x0, x1), y0, max(x0, x1))
            continue
        edges.append(_Edge(x0, y0, x1, y1))
    if not edges:
        return out
    gymin = max(gymin, 0)
    gymax = min(gymax, height)

    for y in range(gymin, gymax + 1):
        xx: dict[int, np.float32] = {}
        j = 0
        for i, cur in enumerate(edges):
            if not (cur.ymin <= y <= cur.ymax):
                continue
            xx[j] = cur.cross(y)
            j += 1
            if y == cur.ymax and y < gymax:  # the edge ends here: keep parity
                xx[j] = xx[j - 1]
                j += 1
            elif cur.dx != 0 and j % 2 == 0 and float(xx[j - 1]).is_integer():
                widen = _corner(edges, i, cur, y, gymax, xx[j - 1])
                if widen is not None:
                    xx[widen[0]] = widen[1]
        vals = sorted(float(xx[s]) for s in range(j))
        for s in range(0, j - 1, 2):
            hline(_round_up(vals[s]), y, _round_down(vals[s + 1]))
    return out


def fill_polygon(width: int, height: int, poly, out: np.ndarray | None = None) -> np.ndarray:
    """Fill ``poly`` into a uint8 ``[height, width]`` mask (``out``, or a
    new zero mask) with Pillow's rule; returns the mask."""
    if out is None:
        out = np.zeros((height, width), dtype=np.uint8)
    p = np.asarray(poly, dtype=np.float64)
    if len(p) < 2:
        return out
    if native.available() and out.flags.c_contiguous:
        native.fill_polygon(p, height, width, out)
        return out
    return fill_polygon_numpy(width, height, p, out)


def generate_mask(width: int, height: int, polys, shrink_dist: float = 3.0) -> np.ndarray:
    """Binary text mask of word polygons, each shrunk by ``shrink_dist``
    along every edge (a polygon that does not survive is left out): float32
    ``[height, width]`` in {0, 1}."""
    mask = np.zeros((height, width), dtype=np.uint8)
    for poly in polys:
        if shrink_dist != 0.0:
            poly = shrink_polygon(poly, shrink_dist)
        if len(poly) == 0:
            continue
        fill_polygon(width, height, poly, out=mask)
    return mask.astype(np.float32)
