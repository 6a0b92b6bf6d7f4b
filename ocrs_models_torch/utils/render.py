"""Debug rendering of word boxes, without PIL (the port's copy of
``draw_word_boxes`` in ``ocrs_models_tpu/utils/render.py``).

The image is drawn in numpy with Pillow's rules for
``ImageDraw.rectangle(box, outline=color, width=2)`` (corners truncated to
integers; two horizontal rows at each edge, inclusive of both ends; the
sides' columns drawn between them, Bresenham-style, excluding the end
point; everything clipped to the image) and written as an 8-bit RGB PNG
through ``zlib`` and ``struct``. The rest of the JAX module (``draw_quads``,
``to_pil_grey``) is ROADMAP.md, Queue 1 item 9.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

# PIL's ImageColor values of the colour names the JAX function uses.
COLORS = {
    "black": (0, 0, 0),
    "blue": (0, 0, 255),
    "green": (0, 128, 0),
    "red": (255, 0, 0),
}


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an ``[H, W, 3]`` uint8 image as an 8-bit RGB PNG (filter 0 on
    every row, one IDAT chunk)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


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
