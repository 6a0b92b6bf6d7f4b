"""A small PNG writer (zlib + numpy) for the decoder tests: the files Pillow
does not write.

Pillow writes 8-bit PNGs, 16-bit greyscale and never an interlaced one;
this writes every bit depth a colour type allows (1, 2, 4, 8 and 16 for
greyscale, 1 to 8 for palette, 8 and 16 for RGB, LA and RGBA), Adam7
interlacing, and each row with a filter chosen from its index (None, Sub,
Up, Average and Paeth in turn), so that every filter meets every layout.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # greyscale, RGB, palette, LA, RGBA
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
"""Each pass's first column and row and its column and row steps."""


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _row_bytes(samples: np.ndarray, depth: int) -> np.ndarray:
    """``[h, w * channels]`` samples as ``[h, stride]`` bytes: big-endian
    at 16 bits, packed from each byte's high bits below 8."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    padded = np.pad(samples.astype(np.int64), ((0, 0), (0, -n % per))).reshape(h, -1, per)
    packed = np.zeros(padded.shape[:2], np.int64)
    for i in range(per):
        packed |= padded[..., i] << (8 - depth * (i + 1))
    return packed.astype(np.uint8)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered(rows: np.ndarray, bpp: int, first_filter: int) -> bytes:
    """Each row of ``rows`` behind its filter byte, filtered with filter
    ``(first_filter + row) % 5``."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        kind = (first_filter + y) % 5
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]]) if bpp < row.size else \
            np.zeros(row.size, np.int64)
        up_left = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]]) if bpp < row.size else \
            np.zeros(row.size, np.int64)
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) >> 1
        else:
            pred = np.asarray([_paeth(int(a), int(b), int(c))
                               for a, b, c in zip(left, prev, up_left)], np.int64)
        out.append(kind)
        out += ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def write_png(samples, depth: int, color: int, interlace: bool = False, palette=None,
              first_filter: int = 0) -> bytes:
    """PNG bytes of ``samples`` (``[H, W]`` for greyscale and palette
    indices, ``[H, W, C]`` otherwise; values below ``2 ** depth``) at bit
    depth ``depth`` in colour type ``color``, Adam7-interlaced when
    ``interlace``; ``palette``: ``[K, 3]`` uint8 for colour type 3."""
    samples = np.asarray(samples)
    h, w = samples.shape[:2]
    ch = CHANNELS[color]
    flat = samples.reshape(h, w * ch)
    bpp = max(1, ch * depth // 8)
    if interlace:
        data = b""
        for i, (x0, y0, dx, dy) in enumerate(ADAM7):
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                sub_flat = sub.reshape(sub.shape[0], sub.shape[1] * ch)
                data += _filtered(_row_bytes(sub_flat, depth), bpp, first_filter + i)
    else:
        data = _filtered(_row_bytes(flat, depth), bpp, first_filter)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                                             0, int(interlace)))
    if color == 3:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return out + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b"")
