"""Host image decoding of the dataset readers, without PIL: the pages of
HierText (JPEG) and DDI-100 (PNG) and the recognition crop cache (PNG).

:func:`read_grey` equals ``np.asarray(Image.open(path).convert("L"))`` of
Pillow on libjpeg-turbo, which the JAX package's readers call. The JPEG
decoder and the PNG row unfiltering are the C++ core
``_native/imagecodec.cpp``, compiled with ``g++`` into ``build/native/``
at first use (and again when the source is newer) and called through
ctypes, which releases the GIL, so the loader's threads decode in
parallel. There is no numpy fallback: without ``g++`` :func:`read_grey`
raises.

The format comes from the file's bytes, not its name (DDI-100 pages may
be JPEGs named ``.png``). JPEGs of 1, 3 (YCbCr or RGB) and 4 components
(CMYK or YCCK, as Pillow inverts and converts them) and PNGs of every
colour type and bit depth, interlaced or not, are read. What the decoder
refuses (arithmetic coding, lossless and hierarchical JPEGs, 12-bit
samples, truncated files) raises ``ValueError`` naming the file.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

from ..utils.native import load_library

_SRC = Path(__file__).resolve().parent / "_native" / "imagecodec.cpp"

JPEG_MAGIC = b"\xff\xd8"
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # greyscale, RGB, palette, LA, RGBA


def _bind(lib: ctypes.CDLL) -> None:
    u8pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
    ip = ctypes.POINTER(ctypes.c_int)
    lib.codec_jpeg_grey.argtypes = [ctypes.c_char_p, ctypes.c_size_t, u8pp, ip, ip,
                                    ctypes.c_char_p, ctypes.c_int]
    lib.codec_jpeg_grey.restype = ctypes.c_int
    lib.codec_free.argtypes = [ctypes.c_void_p]
    lib.codec_free.restype = None
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.codec_png_unfilter.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p]
    lib.codec_png_unfilter.restype = ctypes.c_int


def get_lib() -> ctypes.CDLL:
    """Load (building if needed) the codec library; raises ``RuntimeError``
    when it cannot be built."""
    return load_library(_SRC, "imagecodec", _bind)


def _codec(path) -> ctypes.CDLL:
    try:
        return get_lib()
    except (RuntimeError, OSError) as e:
        raise RuntimeError(f"{path}: cannot decode: the image codec is not available ({e})") from e


def decode_jpeg_grey(data: bytes, path="<bytes>") -> np.ndarray:
    """A JPEG's pixels as Pillow's ``convert("L")`` gives them: ``[H, W]``
    uint8."""
    lib = _codec(path)
    out = ctypes.POINTER(ctypes.c_uint8)()
    w, h = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    if lib.codec_jpeg_grey(data, len(data), ctypes.byref(out), ctypes.byref(w), ctypes.byref(h),
                           err, len(err)):
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    try:
        return np.ctypeslib.as_array(out, (h.value, w.value)).copy()
    finally:
        lib.codec_free(out)


def png_unfilter(raw: np.ndarray, h: int, stride: int, bpp: int, path="<bytes>") -> np.ndarray:
    """PNG rows ``raw`` (``h`` rows of a filter byte and ``stride`` bytes)
    unfiltered: ``[h, stride]`` uint8."""
    lib = _codec(path)
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: PNG image data holds {raw.size} bytes, expected "
                         f"{h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    bad = lib.codec_png_unfilter(raw, h, stride, bpp, out)
    if bad >= 0:
        raise ValueError(f"{path}: unknown PNG row filter {raw[bad * (stride + 1)]} in row {bad}")
    return out


# Bit depths each colour type allows (the PNG specification's table).
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
"""Adam7: each pass's first column and row and its column and row steps."""


def _samples(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """Unfiltered rows ``[h, stride]`` as samples ``[h, width * channels]``:
    uint16 at 16 bits (big-endian in the file), else uint8 (packed depths
    from each byte's high bits)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16)
    if depth == 8:
        return rows
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return ((rows[..., None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :width]


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """A PNG's samples as Pillow holds them, at every colour type and bit
    depth, interlaced (Adam7) or not: ``[H, W]`` for greyscale (uint8
    scaled to 0-255 below 8 bits, uint16 at 16: Pillow's ``I;16``),
    ``[H, W, C]`` uint8 for RGB (3), palette (3: the palette's colours), LA
    (2) and RGBA (4), of which Pillow keeps the high byte at 16 bits.
    Palette indices past the ``PLTE`` chunk's entries read as black, as in
    Pillow. Anything else raises ``ValueError``."""
    if not data.startswith(PNG_MAGIC):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat, palette = 8, None, [], None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body[: len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in _DEPTHS or depth not in _DEPTHS[color] or interlace not in (0, 1):
        raise ValueError(
            f"{path}: bit depth {depth}, colour type {color}, interlace {interlace}: not a "
            "PNG layout (greyscale at 1, 2, 4, 8 or 16 bits, palette at 1 to 8, RGB, LA and "
            "RGBA at 8 or 16; interlace 0 or 1)")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    ch = _CHANNELS[color]
    bpp = max(1, ch * depth // 8)  # the filters' byte distance
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from e
    # (first column, first row, column step, row step) of each pass; a
    # pass with no pixel has no bytes, not even filter bytes.
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = [(-(-(w - x0) // dx), -(-(h - y0) // dy)) for x0, y0, dx, dy in passes]
    strides = [(pw * ch * depth + 7) // 8 for pw, _ in sizes]
    img = np.zeros((h, w * ch), np.uint16 if depth == 16 else np.uint8)
    start = 0
    for (x0, y0, dx, dy), (pw, ph), stride in zip(passes, sizes, strides):
        if not (pw and ph):
            continue
        n = ph * (stride + 1)
        rows = png_unfilter(raw[start : start + n], ph, stride, bpp, path)  # checks the size
        start += n
        sub = _samples(rows, pw * ch, depth).reshape(ph, pw, ch)
        img.reshape(h, w, ch)[y0::dy, x0::dx] = sub
    if raw.size != start:
        raise ValueError(f"{path}: PNG image data holds {raw.size} bytes, expected {start}")
    if depth < 8 and color == 0:  # greyscale scaled to 0-255
        img = img * np.uint8(255 // ((1 << depth) - 1))
    if color == 0:
        return img
    if depth == 16:  # Pillow keeps the high byte ("RGB;16B", "LA;16B", "RGBA;16B")
        img = (img >> 8).astype(np.uint8)
    if color == 3:
        colours = np.zeros((256, 3), np.uint8)
        colours[: len(palette)] = palette[:256]
        return colours[img]
    return img.reshape(h, w, ch)


def rgb_to_grey(rgb: np.ndarray) -> np.ndarray:
    """Pillow's ``rgb2l``: ITU-R 601-2 luma in 16-bit fixed point of an
    ``[..., 3]`` array of 0-255 values, as uint8."""
    rgb = np.asarray(rgb).astype(np.int64)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def png_to_grey(arr: np.ndarray) -> np.ndarray:
    """Pillow's conversion to "L" of decoded PNG channels: grey as it is,
    16-bit grey (``I;16``) clipped to 255 (``I16_L``: every value above
    255 reads 255), LA's L (``la2l``; Pillow opens 16-bit LA as RGBA of
    L, L, L, A, whose ``rgb2l`` is L again), RGB and RGBA through ``rgb2l``
    (``rgba2l`` ignores alpha)."""
    if arr.dtype == np.uint16:
        return np.minimum(arr, 255).astype(np.uint8)
    if arr.ndim == 2:
        return arr
    if arr.shape[-1] == 2:
        return np.ascontiguousarray(arr[..., 0])
    return rgb_to_grey(arr[..., :3])


def read_grey(path) -> np.ndarray:
    """The image at ``path`` (JPEG or PNG, told apart by its bytes) as
    ``np.asarray(Image.open(path).convert("L"))``: ``[H, W]`` uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(JPEG_MAGIC):
        return decode_jpeg_grey(data, path)
    if data.startswith(PNG_MAGIC):
        return png_to_grey(decode_png(data, path))
    raise ValueError(f"{path}: not a JPEG or PNG file (starts with {data[:8]!r})")
