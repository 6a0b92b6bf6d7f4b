"""Write the toy dataset roots the real-data tests and the smoke run read:
``tests/data/torch_hiertext_toy/`` (HierText's layout: ``gt/{train,
validation}.jsonl.gz`` and JPEG pages) and ``tests/data/torch_ddi_toy/``
(DDI-100's: ``gen_imgs/`` pages and ``gen_boxes/`` pickles), plus
``tests/data/torch_decode_page.jpg`` (a 2-megapixel page, the size of a
HierText page, for timing the decoder) and
``tests/data/torch_toy_digests.json``, the SHA-256 of each page's
greyscale pixels as Pillow decodes them (``convert("L")``).

    python tests/torch_fixtures/make_toy_roots.py

It needs Pillow to encode, so it runs where Pillow is installed; the
pages' text is drawn by the port's glyph renderer. Output is fixed by the
seed. The HierText pages cover the JPEG layouts Pillow writes: 4:2:0,
4:2:2 and 4:4:4 YCbCr, greyscale, progressive, optimized Huffman tables,
restart intervals and sizes off the MCU grid. Some of their lines fail
each of the line filters (illegible, vertical, too small, words covering
too little of the line, narrower than tall), one is handwritten, one
runs past the page's edge, one is a slanted quad. The DDI pages are
Pillow PNGs in RGB, greyscale, palette, LA and RGBA (adaptive row
filters), and one JPEG under a ``.png`` name.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import pickle
import shutil
import sys
from pathlib import Path

import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from ocrs_models_torch.data.glyphs import render_line  # noqa: E402
from ocrs_models_torch.data.resize import resize  # noqa: E402
from tests.torch_fixtures.jpeg_writer import write_jpeg  # noqa: E402
from tests.torch_fixtures.png_writer import write_png  # noqa: E402

DATA = ROOT / "tests" / "data"
HIERTEXT = DATA / "torch_hiertext_toy"
DDI = DATA / "torch_ddi_toy"
DIGESTS = DATA / "torch_toy_digests.json"
DECODE_PAGE = DATA / "torch_decode_page.jpg"  # a HierText-sized page (2 MP) for decode timing
FORMATS = DATA / "torch_decode_formats"

WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog", "OCR", "2024",
         "Page", "text", "line", "model", "train", "H100", "data", "read", "JPEG", "word"]

# (name, size (w, h), Pillow save options, colour) of each HierText page.
HIERTEXT_PAGES = {
    "train": [
        ("t0", (411, 457), {"quality": 90, "subsampling": 2}, True),
        ("t1", (389, 443), {"quality": 85, "subsampling": 1}, True),
        ("t2", (360, 450), {"quality": 92, "subsampling": 0}, True),
        ("t3", (401, 449), {"quality": 88}, False),
        ("t4", (377, 463), {"quality": 90, "subsampling": 2, "progressive": True}, True),
        ("t5", (353, 445), {"quality": 87, "subsampling": 2, "restart_marker_blocks": 3,
                            "optimize": True}, True),
    ],
    "validation": [
        ("v0", (365, 455), {"quality": 90, "progressive": True}, False),
        ("v1", (383, 437), {"quality": 86, "subsampling": 1, "restart_marker_rows": 1}, True),
    ],
}


def _word_image(text: str, height: int) -> np.ndarray:
    """Dark ``text`` on white at ``height`` px, trimmed to its ink."""
    line = 255 - render_line(text, 64).astype(np.float32)  # ink 25 on 239
    ink = np.where((line < 200).any(axis=0))[0]
    line = line[:, max(ink[0] - 2, 0): ink[-1] + 3]
    width = max(int(round(line.shape[1] * height / 64)), 2)
    small = resize((line / 255.0 - 0.5)[..., None], (height, width))[..., 0]
    return np.clip((small + 0.5) * 255.0, 0, 255)


def _quad(x0, y0, x1, y1):
    return [[int(x0), int(y0)], [int(x1), int(y0)], [int(x1), int(y1)], [int(x0), int(y1)]]


def _entry(vertices, text, legible=True, handwritten=False, vertical=False, words=None):
    out = {"vertices": vertices, "text": text, "legible": legible, "handwritten": handwritten,
           "vertical": vertical}
    if words is not None:
        out["words"] = words
    return out


def _draw_line(page, rng, x, y, height, n_words):
    """Draw ``n_words`` words at ``(x, y)``; returns the line's words and its
    text, each word ``(quad, text)``, and the right edge drawn."""
    words = []
    for _ in range(n_words):
        text = str(rng.choice(WORDS))
        img = _word_image(text, height)
        h, w = img.shape
        ph, pw = page.shape
        if x >= pw - 2:
            break
        span = min(w, pw - x)
        page[y:y + h, x:x + span] = np.minimum(page[y:y + h, x:x + span], img[:, :span])
        words.append((_quad(x, y + 1, x + w - 1, y + h - 2), text))
        x += w + max(height // 3, 3)
    return words, x


def _hiertext_page(name, size, rng, noise=3.0):
    w, h = size
    yy, xx = np.mgrid[0:h, 0:w]
    page = 228 + 12 * np.sin(xx / 37.0) * np.cos(yy / 53.0) + rng.normal(0, noise, (h, w))
    lines, y = [], 12
    heights = [18, 22, 16, 24, 17, 20, 23]
    kinds = ["ok", "ok", "illegible", "ok", "vertical", "ok", "ratio", "ok", "handwritten",
             "edge", "small", "narrow", "slant"]
    for i, kind in enumerate(kinds):
        height = 8 if kind == "small" else heights[i % len(heights)]
        if y + height + 6 >= h:
            break
        x = int(rng.integers(6, 30))
        if kind == "edge":
            x = w - 120
        n_words = 1 if kind == "narrow" else int(rng.integers(2, 5))
        if kind == "narrow":
            text = str(rng.choice(["I", "l", "1"]))
            img = _word_image(text, height + 14)
            page[y:y + img.shape[0], x:x + img.shape[1]] = np.minimum(
                page[y:y + img.shape[0], x:x + img.shape[1]], img)
            words = [(_quad(x, y, x + img.shape[1] - 1, y + img.shape[0] - 1), text)]
            right = x + img.shape[1]
            height += 14
        else:
            words, right = _draw_line(page, rng, x, y, height, n_words)
        text = " ".join(t for _, t in words)
        x0, y0, x1, y1 = x - 1, y, right - max(height // 3, 3) + 1, y + height - 1
        if kind == "edge":
            x1 = w + 15  # the line's box runs past the page
        if kind == "ratio":
            x1, y1 = x1 + 120, y1 + 24  # words cover well under 0.8 of it
        vertices = _quad(x0, y0, x1, y1)
        if kind == "slant":
            vertices = [[x0, y0 + 3], [x1, y0], [x1, y1 - 3], [x0, y1]]
        line = _entry(vertices, text, legible=kind != "illegible",
                      handwritten=kind == "handwritten", vertical=kind == "vertical",
                      words=[_entry(q, t, legible=kind != "illegible") for q, t in words])
        lines.append(line)
        y += height + (26 if kind == "ratio" else 7)
    # Two paragraphs, as HierText groups lines.
    half = len(lines) // 2
    paragraphs = [{"vertices": _quad(0, 0, w - 1, h - 1), "legible": True, "lines": part}
                  for part in (lines[:half], lines[half:])]
    ann = {"image_id": name, "image_width": w, "image_height": h, "paragraphs": paragraphs}
    return np.clip(page, 0, 255).astype(np.uint8), ann


def _tint(grey, rng, noise=2.0):
    """An RGB page from a grey one: a paper tint and slightly coloured ink."""
    g = grey.astype(np.float32)
    rgb = np.stack([g * 1.0, g * 0.97 + 4, g * 0.9 + 10], axis=-1)
    rgb += rng.normal(0, noise, rgb.shape)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _grey_digest(path: Path) -> dict:
    with Image.open(path) as img:
        arr = np.asarray(img.convert("L"))
    return {"sha256": hashlib.sha256(arr.tobytes()).hexdigest(), "shape": list(arr.shape)}


def write_hiertext(rng) -> None:
    shutil.rmtree(HIERTEXT, ignore_errors=True)
    (HIERTEXT / "gt").mkdir(parents=True)
    for split, pages in HIERTEXT_PAGES.items():
        (HIERTEXT / split).mkdir()
        annotations = []
        for name, size, options, colour in pages:
            grey, ann = _hiertext_page(name, size, rng)
            img = Image.fromarray(_tint(grey, rng)) if colour else Image.fromarray(grey, "L")
            img.save(HIERTEXT / split / f"{name}.jpg", "JPEG", **options)
            annotations.append(ann)
        # HierText's ground truth: plain JSON in a .jsonl.gz file. mtime 0
        # keeps the gzip bytes fixed.
        raw = json.dumps({"info": {"date": "toy"}, "annotations": annotations}).encode()
        with open(HIERTEXT / "gt" / f"{split}.jsonl.gz", "wb") as f:
            with gzip.GzipFile(fileobj=f, mode="wb", mtime=0) as gz:
                gz.write(raw)


def write_ddi(rng) -> None:
    shutil.rmtree(DDI, ignore_errors=True)
    (DDI / "gen_imgs").mkdir(parents=True)
    (DDI / "gen_boxes").mkdir()
    modes = ["RGB", "L", "RGB", "P", "RGB", "LA", "L", "RGBA", "RGB", "L", "JPEG"]
    for i, mode in enumerate(modes):
        # Noise-free, so that the PNGs stay small.
        grey, ann = _hiertext_page(f"{i:03d}", (int(rng.integers(300, 360)),
                                                int(rng.integers(400, 440))), rng, noise=0.0)
        path = DDI / "gen_imgs" / f"{i:03d}.png"
        if mode == "JPEG":  # a JPEG under a .png name
            Image.fromarray(_tint(grey, rng)).save(path, "JPEG", quality=88)
        elif mode == "RGB":
            Image.fromarray(_tint(grey, rng, 0.0)).save(path)
        elif mode == "P":
            Image.fromarray(_tint(grey, rng, 0.0)).quantize(64).save(path)
        elif mode in ("LA", "RGBA"):
            base = grey if mode == "LA" else _tint(grey, rng, 0.0)
            alpha = np.full(grey.shape, 255, np.uint8)
            alpha[:, :20] = 128
            arr = np.dstack([base, alpha])
            Image.fromarray(arr, mode).save(path)
        else:
            Image.fromarray(grey, "L").save(path)
        words = []
        for para in ann["paragraphs"]:
            for line in para["lines"]:
                for word in line["words"]:
                    xy = np.array(word["vertices"], np.int64)
                    words.append({"box": xy[:, ::-1].copy(), "text": word["text"]})  # (y, x)
        with open(DDI / "gen_boxes" / f"{i:03d}.pickle", "wb") as f:
            pickle.dump(words, f)


def _scan(rng, w: int, h: int, scale: int, channels: int) -> np.ndarray:
    """A small page-like image: a smooth tint and noise, a few dark
    strokes, values in ``[0, scale)``, ``[h, w, channels]``."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.85 + 0.1 * np.sin(xx / 7.0 + yy / 11.0)
    base[(yy % 9 < 2) & (xx % 13 > 3)] = 0.15  # strokes
    chans = [base * (0.9 + 0.1 * c) + rng.normal(0, 0.03, (h, w)) for c in range(channels)]
    return np.clip(np.stack(chans, -1) * scale, 0, scale - 1).astype(np.int64)


def write_decode_formats() -> list[Path]:
    """The JPEG and PNG layouts the datasets may hold beyond the toy roots'
    (Pillow reads them all): CMYK from Pillow and YCCK / CMYK in layouts it
    does not write, 16-bit PNGs, Adam7 PNGs at every colour type and
    depth. Returns the files written."""
    rng = np.random.default_rng(20261018)
    shutil.rmtree(FORMATS, ignore_errors=True)
    FORMATS.mkdir(parents=True)
    files = {}
    cmyk = _scan(rng, 45, 37, 256, 4).astype(np.uint8)
    for name, options in (("cmyk_pillow.jpg", {"quality": 90}),
                          ("cmyk_pillow_progressive.jpg", {"quality": 80, "progressive": True})):
        buf = FORMATS / name
        Image.fromarray(cmyk, "CMYK").save(buf, "JPEG", **options)
    planes = [cmyk[..., c] for c in range(4)]
    for name, sampling, options in (
        ("cmyk_no_marker_444.jpg", [(1, 1)] * 4, {"marker": None}),
        ("ycck_adobe2_420.jpg", [(2, 2), (1, 1), (1, 1), (2, 2)], {"marker": "adobe2"}),
        ("ycck_adobe2_422_scans.jpg", [(2, 1), (1, 1), (1, 1), (2, 1)],
         {"marker": "adobe2", "interleaved": False, "restart_interval": 2}),
        ("ycck_adobe1_440.jpg", [(1, 2), (1, 1), (1, 1), (1, 1)], {"marker": "adobe1"}),
    ):
        files[name] = write_jpeg(planes, sampling, **options)
    depths = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
    kinds = {0: "grey", 2: "rgb", 3: "palette", 4: "la", 6: "rgba"}
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
    for color, ds in depths.items():
        for depth in ds:
            # 16-bit greyscale spans 0-599: Pillow's convert("L") clips it.
            scale = 600 if (color, depth) == (0, 16) else 2 ** depth
            samples = _scan(rng, 29 + depth, 23, scale, channels[color])
            if channels[color] == 1:
                samples = samples[..., 0]
            palette = rng.integers(0, 256, (2 ** depth, 3)) if color == 3 else None
            for interlace in (False, True) if depth == 16 and color != 0 else (True,):
                name = f"{'adam7_' if interlace else ''}{kinds[color]}{depth}.png"
                files[name] = write_png(samples, depth, color, interlace=interlace,
                                        palette=palette, first_filter=depth + color)
    grey16 = _scan(rng, 31, 19, 600, 1)[..., 0]
    files["grey16.png"] = write_png(grey16, 16, 0)
    for name, data in files.items():
        (FORMATS / name).write_bytes(data)
    return sorted(FORMATS.iterdir())


def main() -> None:
    rng = np.random.default_rng(20241017)
    write_hiertext(rng)
    write_ddi(rng)
    grey, _ = _hiertext_page("page", (1648, 1236), rng)
    Image.fromarray(_tint(grey, rng)).save(DECODE_PAGE, "JPEG", quality=90, subsampling=2)
    digests = {}
    formats = write_decode_formats()
    for path in sorted(list(HIERTEXT.rglob("*.jpg")) + list((DDI / "gen_imgs").iterdir())
                       + [DECODE_PAGE] + formats):
        digests[str(path.relative_to(DATA))] = _grey_digest(path)
    DIGESTS.write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in DATA.rglob("*") if p.is_file()
                and ("torch_" in str(p)))
    n_lines = [len([ln for p in json.loads(gzip.open(HIERTEXT / "gt" / f"{sp}.jsonl.gz").read())
                    ["annotations"][0]["paragraphs"] for ln in p["lines"]]) for sp in HIERTEXT_PAGES]
    print(f"wrote {len(digests)} pages, {total} bytes; lines on the first pages {n_lines}")


if __name__ == "__main__":
    main()
