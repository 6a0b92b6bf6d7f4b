"""Debug rendering without PIL (the port's copy of
``ocrs_models_tpu/utils/render.py``): greyscale pages, word quads and
labelled word boxes as numpy arrays, written as 8-bit PNGs through ``zlib``
and ``struct``, and read back by :func:`read_png`.

Drawing follows Pillow's rules:

- ``ImageDraw.rectangle(box, outline=color, width=2)``: corners truncated
  to integers; two horizontal rows at each edge, inclusive of both ends;
  the sides' columns drawn between them, Bresenham-style, excluding the
  end point; everything clipped to the image.
- ``ImageDraw.line((start, end), fill=color, width=2)``: end points
  truncated to integers; the segment becomes the quadrilateral whose
  corners Pillow's ``ImagingDrawWideLine`` computes, filled with Pillow's
  polygon rule (``geometry.raster.fill_polygon``); a zero-length segment
  is one point.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Optional

import numpy as np

from ..geometry.raster import fill_polygon
from .image import untransform_image

# PIL's ImageColor values of the colour names the JAX function uses.
COLORS = {
    "black": (0, 0, 0),
    "blue": (0, 0, 255),
    "green": (0, 128, 0),
    "red": (255, 0, 0),
}


def write_png(path: str, img: np.ndarray) -> None:
    """Write an ``[H, W, 3]`` (RGB) or ``[H, W]`` (greyscale) uint8 image as
    an 8-bit PNG (filter 0 on every row, one IDAT chunk)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else 3
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * channels)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0 if channels == 1 else 2,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read a PNG of any colour type and bit depth, interlaced or not, as
    Pillow holds it: ``[H, W]`` for greyscale (uint8 scaled to 0-255, or
    uint16 at 16 bits), ``[H, W, C]`` uint8 for RGB (3), palette (3: the
    palette's colours), LA (2) and RGBA (4). Anything else raises
    ``ValueError``. The reader is ``data.imageio.decode_png``."""
    from ..data.imageio import decode_png

    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def to_grey(img: np.ndarray) -> np.ndarray:
    """``[H, W, 1]`` or ``[H, W]`` float image in [-0.5, 0.5], or uint8 ->
    ``[H, W]`` uint8 (``to_pil_grey``'s pixels)."""
    arr = np.asarray(img)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr if arr.dtype == np.uint8 else untransform_image(arr)


def draw_line(img: np.ndarray, start, end, color, width: int = 2) -> None:
    """Pillow's ``ImageDraw.line((start, end), fill=color, width=width)``
    on an ``[H, W, 3]`` uint8 image, for ``width > 1``."""
    h, w, _ = img.shape
    x0, y0 = int(start[0]), int(start[1])
    x1, y1 = int(end[0]), int(end[1])
    dx, dy = x1 - x0, y1 - y0
    if dx == 0 and dy == 0:
        if 0 <= x0 < w and 0 <= y0 < h:
            img[y0, x0] = color
        return
    big = math.hypot(dx, dy)
    small = (width - 1) / 2.0
    ratio_max = _round_up(small) / big
    ratio_min = _round_down(small) / big
    dxmin, dxmax = _round_down(ratio_min * dy), _round_down(ratio_max * dy)
    dymin, dymax = _round_down(ratio_min * dx), _round_down(ratio_max * dx)
    corners = np.array([(x0 - dxmin, y0 + dymax), (x1 - dxmin, y1 + dymax),
                        (x1 + dxmax, y1 - dymin), (x0 + dxmax, y0 - dymin)])
    # Fill within the corners' box, clipped to the image and widened by the
    # edges' run per row (how far Pillow's corner rule may reach past a
    # vertex): integer shifts leave the fill rule's arithmetic as it is.
    reach = abs(dx) + 2
    ox, oy = max(int(corners[:, 0].min()) - reach, 0), max(int(corners[:, 1].min()) - 1, 0)
    bw = min(int(corners[:, 0].max()) + reach + 1, w) - ox
    bh = min(int(corners[:, 1].max()) + 2, h) - oy
    if bw <= 0 or bh <= 0:
        return
    mask = fill_polygon(bw, bh, corners - (ox, oy))
    img[oy : oy + bh, ox : ox + bw][mask.astype(bool)] = color


def _round_up(f: float) -> int:  # Pillow's ROUND_UP: half away from zero
    return int(math.floor(f + 0.5)) if f >= 0 else -int(math.floor(abs(f) + 0.5))


def _round_down(f: float) -> int:  # Pillow's ROUND_DOWN: half toward zero
    return int(math.ceil(f - 0.5)) if f >= 0 else -int(math.ceil(abs(f) - 0.5))


def draw_quads(img: np.ndarray, quads: np.ndarray) -> np.ndarray:
    """RGB copy of the greyscale ``img`` with each quad's outline drawn in
    red, width 2 (``draw_quads``'s pixels)."""
    grey = to_grey(img)
    out = np.repeat(grey[..., None], 3, axis=-1)
    for quad in np.asarray(quads).reshape(-1, 4, 2):
        verts = [(float(x), float(y)) for x, y in quad]
        for i, start in enumerate(verts):
            draw_line(out, start, verts[(i + 1) % len(verts)], COLORS["red"], width=2)
    return out


def _hline(img: np.ndarray, x0: int, y: int, x1: int, color) -> None:
    h, w, _ = img.shape
    if not 0 <= y < h:
        return
    x0, x1 = min(x0, x1), max(x0, x1)
    if x0 >= w or x1 < 0:
        return
    img[y, max(x0, 0) : min(x1, w - 1) + 1] = color


def _vline(img: np.ndarray, x: int, y0: int, y1: int, color) -> None:
    """Pillow's vertical line: ``|y1 - y0|`` points from ``y0`` towards
    ``y1``, the end point excluded."""
    h, w, _ = img.shape
    step = 1 if y1 >= y0 else -1
    for y in range(y0, y1, step):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color


def draw_rectangle(img: np.ndarray, box, color, width: int = 2) -> None:
    """Pillow's ``ImageDraw.rectangle(box, outline=color, width=width)``."""
    x0, y0, x1, y1 = box
    if x1 < x0:
        raise ValueError("x1 must be greater than or equal to x0")
    if y1 < y0:
        raise ValueError("y1 must be greater than or equal to y0")
    x0, y0, x1, y1 = (int(c) for c in (x0, y0, x1, y1))
    for i in range(width):
        _hline(img, x0, y0 + i, x1, color)
        _hline(img, x0, y1 - i, x1, color)
        _vline(img, x1 - i, y0 + width, y1 - width + 1, color)
        _vline(img, x0 + i, y0 + width, y1 - width + 1, color)


def draw_word_boxes(
    img_path: str,
    width: int,
    height: int,
    word_boxes: np.ndarray,
    labels: Optional[np.ndarray] = None,
    probs: Optional[np.ndarray] = None,
    threshold: float = 0.5,
    normalized_coords: bool = False,
) -> None:
    """Render word boxes on white, coloured by (line_start, line_end) labels
    (green both, blue start, red end, black neither) or by probability (red
    above ``threshold``, else a grey that darkens with it), and write the
    PNG to ``img_path``. Zero-area padding boxes are skipped."""
    word_boxes = np.asarray(word_boxes)
    img = np.full((height, width, 3), 255, np.uint8)

    def sx(c):
        return (c + 0.5) * width if normalized_coords else c

    def sy(c):
        return (c + 0.5) * height if normalized_coords else c

    for i in range(len(word_boxes)):
        left, top, right, bottom = word_boxes[i].tolist()
        box = (sx(left), sy(top), sx(right), sy(bottom))
        color = COLORS["black"]
        if labels is not None:
            ls, le = bool(labels[i][0]), bool(labels[i][1])
            color = COLORS[{(True, True): "green", (True, False): "blue",
                            (False, True): "red", (False, False): "black"}[(ls, le)]]
        elif probs is not None:
            p = float(probs[i])
            if p > threshold:
                color = (255, 0, 0)
            else:
                v = 255 - round(p * 235)
                color = (v, v, v)
        if box[2] <= box[0] and box[3] <= box[1]:
            continue  # zero-area padding box
        draw_rectangle(img, box, color, width=2)
    write_png(img_path, img)
