"""A small baseline JPEG writer (numpy) for the decoder tests: the frame
layouts Pillow does not write.

Pillow writes 4:4:4, 4:2:2 and 4:2:0 YCbCr, greyscale, progressive,
restart intervals and 4:4:4 CMYK (Adobe transform 0); this writes any
sampling factors of 1 or 2 (4:4:0 included) for 1, 3 or 4 components, one
interleaved scan or one scan per component, SOF0 or SOF1, 16-bit
quantization tables, and the colour-space signals (JFIF, Adobe APP14
transform 0, 1 or 2, component ids): with 4 components transform 0 is
CMYK and any other YCCK. Its Huffman tables give every DC symbol a
4-bit code and every AC symbol an 8-bit one: valid, not small.
"""

from __future__ import annotations

import struct

import numpy as np

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_DC_SYMBOLS = list(range(12))
_AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    c = np.where(k == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    return c[:, None] * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


class _Bits:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, nbits: int) -> None:
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _category(v: int) -> tuple[int, int]:
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def write_jpeg(planes, sampling, quality_table=None, interleaved=True, sof=0xC0,
               restart_interval=0, marker="jfif", ids=None, qt16=False) -> bytes:
    """JPEG bytes of ``planes`` (one ``[H, W]`` uint8 array a component,
    all the image's size), each component ``i`` subsampled to its
    ``sampling[i] = (h, v)`` factors by averaging. ``marker`` is "jfif",
    "adobe0" (Adobe APP14, transform 0: RGB, or CMYK with 4 components),
    "adobe1", "adobe2" (YCCK with 4 components) or None; ``ids`` the
    component ids (default 1, 2, 3, ...)."""
    planes = [np.asarray(p, np.float64) for p in planes]
    height, width = planes[0].shape
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    ids = ids or list(range(1, len(planes) + 1))
    qt = np.asarray(quality_table if quality_table is not None else np.full(64, 4), np.int64)
    dct = _dct_matrix()

    blocks = []  # per component: [bh, bw, 64] quantized, natural order
    for plane, (h, v) in zip(planes, sampling):
        fy, fx = vmax // v, hmax // h
        ch, cw = -(-height * v // vmax), -(-width * h // hmax)
        pad = np.pad(plane, ((0, ch * fy - height), (0, cw * fx - width)), mode="edge")
        comp = pad.reshape(ch, fy, cw, fx).mean(axis=(1, 3))
        bh, bw = mcuy * v, mcux * h
        comp = np.pad(comp, ((0, bh * 8 - ch), (0, bw * 8 - cw)), mode="edge") - 128.0
        tiles = comp.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = dct @ tiles @ dct.T
        blocks.append(np.round(coef.reshape(bh, bw, 64) / qt).astype(np.int64))

    out = bytearray(b"\xff\xd8")
    if marker == "jfif":
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    elif marker in ("adobe0", "adobe1", "adobe2"):
        out += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([int(marker[-1])]))
    zz = qt[_ZIGZAG]
    out += _segment(0xDB, (b"\x10" + zz.astype(">u2").tobytes()) if qt16
                    else (b"\x00" + zz.astype(np.uint8).tobytes()))
    frame = struct.pack(">BHHB", 8, height, width, len(planes))
    for cid, (h, v) in zip(ids, sampling):
        frame += bytes([cid, (h << 4) | v, 0])
    out += _segment(sof, frame)
    out += _segment(0xC4, b"\x00" + bytes([0, 0, 0, 12] + [0] * 12) + bytes(_DC_SYMBOLS))
    out += _segment(0xC4, b"\x10" + bytes([0] * 7 + [len(_AC_SYMBOLS)] + [0] * 8)
                    + bytes(_AC_SYMBOLS))
    if restart_interval:
        out += _segment(0xDD, struct.pack(">H", restart_interval))
    dc_code = {s: (i, 4) for i, s in enumerate(_DC_SYMBOLS)}
    ac_code = {s: (i, 8) for i, s in enumerate(_AC_SYMBOLS)}

    def encode_block(bits, blk, pred):
        zzb = blk[_ZIGZAG]
        s, val = _category(int(zzb[0]) - pred)
        bits.put(*dc_code[s])
        if s:
            bits.put(val, s)
        run = 0
        for k in range(1, 64):
            c = int(zzb[k])
            if c == 0:
                run += 1
                continue
            while run > 15:
                bits.put(*ac_code[0xF0])
                run -= 16
            s, val = _category(c)
            bits.put(*ac_code[(run << 4) | s])
            bits.put(val, s)
            run = 0
        if run:
            bits.put(*ac_code[0x00])
        return int(zzb[0])

    scans = [list(range(len(planes)))] if interleaved else [[i] for i in range(len(planes))]
    for members in scans:
        sos = bytes([len(members)]) + b"".join(bytes([ids[i], 0x00]) for i in members)
        out += _segment(0xDA, sos + b"\x00\x3f\x00")
        bits = _Bits()
        preds = {i: 0 for i in members}
        if len(members) == 1:
            (i,) = members
            h, v = sampling[i]
            units = [[(i, by, bx)] for by in range(-(-(-(-height * v // vmax)) // 8))
                     for bx in range(-(-(-(-width * h // hmax)) // 8))]
        else:
            units = [[(i, my * sampling[i][1] + y, mx * sampling[i][0] + x)
                      for i in members for y in range(sampling[i][1]) for x in range(sampling[i][0])]
                     for my in range(mcuy) for mx in range(mcux)]
        for m, unit in enumerate(units):
            if restart_interval and m and m % restart_interval == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + (m // restart_interval - 1) % 8])
                preds = {i: 0 for i in members}
            for i, by, bx in unit:
                preds[i] = encode_block(bits, blocks[i][by, bx], preds[i])
        bits.flush()
        out += bits.out
    out += b"\xff\xd9"
    return bytes(out)
