"""Text lines drawn from a glyph atlas, without PIL.

The JAX package draws its synthetic text lines with Pillow's default
FreeType font (``ImageDraw.text``). ``glyphs_aileron38.npz`` holds what
that drawing uses, rendered once with Pillow: for each of the 96 alphabet
characters its anti-aliased coverage bitmap (uint8), the bitmap's offset
from the pen at the "la" anchor, its advance (an integer number of pixels
at this size) and the right edge of its ``textbbox``, plus the font, size
and Pillow version it came from. ``tests/test_torch_synthetic.py`` renders
the atlas again with Pillow and checks it against this file
(``python tests/test_torch_synthetic.py --write-atlas`` writes it).

:func:`render_line` reproduces the JAX dataset's drawing
(``ocrs_models_tpu/data/synthetic.py:58-66``). The font has no pair
kerning and integer advances, so each glyph lands at the sum of the
advances before it. Where glyphs overlap, their coverages combine as
FreeType's bitmaps do in Pillow, ``c + (g * (255 - c)) / 255`` rounded;
the text is then blended over the background with Pillow's rounded
``(bg * (255 - c) + fill * c) / 255``.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

ATLAS_PATH = Path(__file__).resolve().parent / "glyphs_aileron38.npz"
BACKGROUND = 16
INK = 230


class GlyphAtlas:
    """The glyphs of one font at one size, read from an ``.npz`` with numpy."""

    def __init__(self, path: Path = ATLAS_PATH):
        with np.load(path, allow_pickle=False) as f:
            chars = [str(c) for c in f["chars"]]
            self.font = str(f["font"])
            self.font_size = int(f["font_size"])
            self.pillow = str(f["pillow"])
            advance, right = f["advance"], f["right"]
            offset, shape, start, pixels = f["offset"], f["shape"], f["start"], f["pixels"]
        self.index = {c: i for i, c in enumerate(chars)}
        self.advance = advance.astype(np.int64)
        self.right = right.astype(np.int64)
        self.offset = offset.astype(np.int64)
        self.bitmaps = [
            pixels[start[i] : start[i + 1]].reshape(shape[i]).astype(np.int32)
            for i in range(len(chars))
        ]
        self.margin = int(max(np.abs(self.offset).max(), shape.max())) + 1


@lru_cache(maxsize=1)
def atlas() -> GlyphAtlas:
    return GlyphAtlas()


def _div255(a: np.ndarray) -> np.ndarray:
    t = a + 128
    return ((t >> 8) + t) >> 8


def render_line(text: str, height: int = 64) -> np.ndarray:
    """A ``[height, W]`` uint8 line image of ``text``: a canvas of
    ``int(height * 0.6 * (len(text) + 2))`` columns filled with 16, the
    text drawn at ``(height // 4, height // 8)`` with ink 230, cropped to
    ``min(canvas width, textbbox right + height // 4)`` columns (at least
    10)."""
    glyphs = atlas()
    if int(height * 0.6) != glyphs.font_size:
        raise ValueError(
            f"the glyph atlas holds size {glyphs.font_size}; height {height} needs "
            f"size {int(height * 0.6)}")
    missing = sorted({c for c in text if c not in glyphs.index})
    if missing:
        raise ValueError(f"characters not in the glyph atlas: {missing}")
    width = int(height * 0.6 * (len(text) + 2))
    m = glyphs.margin  # glyphs past the canvas edge are clipped, as Pillow clips them
    cov = np.zeros((height + 2 * m, width + 2 * m), np.int32)
    x0, y0 = height // 4, height // 8
    pen = right = 0
    for ch in text:
        i = glyphs.index[ch]
        bm = glyphs.bitmaps[i]
        gx, gy = m + x0 + pen + glyphs.offset[i, 0], m + y0 + glyphs.offset[i, 1]
        region = cov[gy : gy + bm.shape[0], gx : gx + bm.shape[1]]
        region += _div255(bm * (255 - region))
        right = max(right, pen + glyphs.right[i])
        pen += glyphs.advance[i]
    cov = cov[m : m + height, m : m + width]
    line = _div255(BACKGROUND * (255 - cov) + INK * cov).astype(np.uint8)
    w = max(min(width, x0 + right + height // 4), 10)
    if w > width:  # Pillow's crop pads past the image with zeros
        line = np.pad(line, ((0, 0), (0, w - width)))
    return np.ascontiguousarray(line[:, :w])
