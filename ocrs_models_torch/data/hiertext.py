"""HierText detection pages and recognition line crops (the port's copy of
``ocrs_models_tpu/data/hiertext.py``).

The gzipped ground truth becomes JSONL once (one line per page, or one per
usable text line after the quality filters: legible, horizontal, at least
10 px each way, word boxes covering at least 0.8 of the line's box, aspect
at least 1), byte for byte as the JAX package writes it, with the same
modification-time check and the same write-then-rename (under a
per-process temporary name, so that the ranks of a ``torchrun`` job may
convert at once). Line crops go
through the same on-disk PNG cache, ``{split}-lines-cache/{image_id}/
{x0}_{y0}_{x1}_{y1}.png``, written under a per-process temporary name and
renamed, so concurrent workers and both packages share one cache: each
reads the PNGs the other wrote.

Pages and crops are read by :func:`imageio.read_grey` (the JPEG decoder
and PNG reader of this package, equal to Pillow's ``convert("L")``), crops
written by ``utils.render.write_png``. Images are ``[H, W, 1]`` float32 in
[-0.5, 0.5], masks come from ``geometry.generate_mask``.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Optional

import numpy as np

from ..config import DEFAULT_ALPHABET, SHRINK_DISTANCE
from ..geometry import generate_mask
from ..utils.render import write_png
from ..utils.text import encode_text
from .imageio import read_grey
from .resize import resize


def _read_grey(path: str) -> np.ndarray:
    """Read an image as ``[H, W, 1]`` float32 in [-0.5, 0.5]."""
    return (read_grey(path).astype(np.float32) / 255.0 - 0.5)[..., None]


def _up_to_date(lines_file: str, annotations_file: str) -> bool:
    return os.path.exists(lines_file) and os.path.getmtime(lines_file) >= os.path.getmtime(
        annotations_file)


def convert_annotations_to_jsonl(annotations_file: str, lines_file: str) -> None:
    """One-time gzipped JSON -> JSONL conversion (one line per page); the
    ground-truth file is plain JSON despite its ``.jsonl.gz`` suffix."""
    if _up_to_date(lines_file, annotations_file):
        return
    print("Converting annotations from JSON to JSONL format...")
    with gzip.open(annotations_file) as in_fp:
        annotations = json.load(in_fp)["annotations"]
    tmp = lines_file + f".tmp{os.getpid()}"
    with open(tmp, "w") as out_fp:
        for ann in annotations:
            out_fp.write(json.dumps(ann) + "\n")
    os.rename(tmp, lines_file)


# Text-line quality filters.
MIN_WIDTH = 10
MIN_HEIGHT = 10
MIN_WORD_TO_LINE_AREA_RATIO = 0.8
MIN_ASPECT_RATIO = 1.0


def _bbox_size(vertices) -> tuple[float, float]:
    xs = [v[0] for v in vertices]
    ys = [v[1] for v in vertices]
    return max(xs) - min(xs), max(ys) - min(ys)


def generate_line_annotations(annotations_file: str, lines_file: str) -> None:
    """One-time ground truth -> per-text-line JSONL with the quality
    filters, then the kept and dropped counts printed."""
    if _up_to_date(lines_file, annotations_file):
        return
    stats = {
        "total": 0,
        "usable": 0,
        "legible": 0,
        "horizontal": 0,
        "size_ok": 0,
        "handwritten": 0,
        "area_ratio_ok": 0,
        "aspect_ok": 0,
    }
    print(f"Extracting text line annotations from {annotations_file}")
    with gzip.open(annotations_file) as in_fp:
        annotations = json.load(in_fp)["annotations"]

    tmp = lines_file + f".tmp{os.getpid()}"
    with open(tmp, "w") as out_fp:
        for ann in annotations:
            for para in ann["paragraphs"]:
                for line in para["lines"]:
                    vertices = line["vertices"]
                    width, height = _bbox_size(vertices)
                    aspect_ok = height > 0 and width / height >= MIN_ASPECT_RATIO
                    words_w, words_h = _bbox_size(
                        [v for w in line["words"] for v in w["vertices"]]
                    ) if line["words"] else (0.0, 0.0)
                    area_ratio_ok = (
                        width * height > 0
                        and (words_w * words_h) / (width * height) >= MIN_WORD_TO_LINE_AREA_RATIO
                    )
                    legible = line["legible"]
                    horizontal = not line["vertical"]
                    size_ok = width >= MIN_WIDTH and height >= MIN_HEIGHT

                    stats["total"] += 1
                    stats["legible"] += legible
                    stats["horizontal"] += horizontal
                    stats["size_ok"] += size_ok
                    stats["area_ratio_ok"] += area_ratio_ok
                    stats["aspect_ok"] += aspect_ok
                    stats["handwritten"] += line["handwritten"]

                    if not (legible and size_ok and horizontal and area_ratio_ok and aspect_ok):
                        continue
                    stats["usable"] += 1
                    out_fp.write(json.dumps({"image_id": ann["image_id"], "vertices": vertices,
                                             "text": line["text"]}) + "\n")
    os.rename(tmp, lines_file)
    total = max(stats["total"], 1)
    for k, v in stats.items():
        print(f"{k}: {v} ({round(v / total * 100, 1)}%)")


def _split_paths(root_dir: str, train: bool) -> tuple[str, str, str]:
    """``(split, image directory, annotations file)``; raises
    ``FileNotFoundError`` naming what is missing."""
    split = "train" if train else "validation"
    img_dir = f"{root_dir}/{split}"
    annotations_file = f"{root_dir}/gt/{split}.jsonl.gz"
    if not os.path.exists(img_dir):
        raise FileNotFoundError(f'Image directory "{img_dir}" not found')
    if not os.path.exists(annotations_file):
        raise FileNotFoundError(f'Label data file "{annotations_file}" not found')
    return split, img_dir, annotations_file


def _apply(transform, idx, *arrays):
    if getattr(transform, "accepts_index", False):
        return transform(*arrays, idx=idx)
    return transform(*arrays)


class HierTextDetection:
    """Full-page detection samples: ``{"image", "mask", "path"}``."""

    def __init__(
        self,
        root_dir: str,
        train: bool = True,
        transform=None,
        max_images: Optional[int] = None,
        shrink_dist: float = SHRINK_DISTANCE,
    ):
        _, self._img_dir, annotations_file = _split_paths(root_dir, train)
        lines_file = annotations_file.replace(".jsonl.gz", ".jsonl")
        convert_annotations_to_jsonl(annotations_file, lines_file)
        with open(lines_file) as fp:
            self._annotations = fp.readlines()
        if max_images:
            self._annotations = self._annotations[:max_images]
        self.transform = transform
        self.shrink_dist = shrink_dist

    def __len__(self):
        return len(self._annotations)

    def __getitem__(self, idx: int) -> dict:
        ann = json.loads(self._annotations[idx])
        img_path = f"{self._img_dir}/{ann['image_id']}.jpg"
        word_polys = [
            [tuple(c) for c in word["vertices"]]
            for para in ann["paragraphs"]
            for line in para["lines"]
            for word in line["words"]
        ]
        image = _read_grey(img_path)
        h, w = image.shape[:2]
        mask = generate_mask(w, h, word_polys, shrink_dist=self.shrink_dist)[..., None]
        if self.transform:
            image, mask = _apply(self.transform, idx, image, mask)
        return {"image": image, "mask": mask, "path": img_path}


class HierTextRecognition:
    """Text-line recognition samples: ``{"image", "text", "image_id"}``."""

    def __init__(
        self,
        root_dir: str,
        train: bool = True,
        transform=None,
        max_images: Optional[int] = None,
        alphabet: str = DEFAULT_ALPHABET,
        output_height: int = 64,
        max_width: int = 800,
    ):
        split, self._img_dir, annotations_file = _split_paths(root_dir, train)
        self._cache_dir = f"{root_dir}/{split}-lines-cache"
        lines_file = annotations_file.replace(".jsonl.gz", "-lines.jsonl")
        generate_line_annotations(annotations_file, lines_file)
        with open(lines_file) as fp:
            self._text_lines = fp.readlines()
        if max_images:
            self._text_lines = self._text_lines[:max_images]
        self.alphabet = alphabet
        self.transform = transform
        self.output_height = output_height
        self.max_width = max_width

    def __len__(self):
        return len(self._text_lines)

    def _get_line_image(self, image_id, min_x, max_x, min_y, max_y) -> np.ndarray:
        """A line crop through the on-disk PNG cache. The crop is PIL's
        ``crop`` of the coordinates clamped to the page (rounded to
        integers, right and bottom exclusive)."""
        cache_path = f"{self._cache_dir}/{image_id}/{min_x}_{min_y}_{max_x}_{max_y}.png"
        if not os.path.exists(cache_path):
            grey = read_grey(f"{self._img_dir}/{image_id}.jpg")
            ih, iw = grey.shape
            x0, x1, y0, y1 = (int(round(min(max(c, 0), lim - 1)))
                              for c, lim in ((min_x, iw), (max_x, iw), (min_y, ih), (max_y, ih)))
            os.makedirs(os.path.dirname(cache_path), exist_ok=True)
            tmp_path = cache_path + f".tmp{os.getpid()}"
            write_png(tmp_path, grey[y0:y1, x0:x1])
            os.rename(tmp_path, cache_path)
        return _read_grey(cache_path)

    def __getitem__(self, idx: int) -> dict:
        text_line = json.loads(self._text_lines[idx])
        img_id = text_line["image_id"]
        line_poly = [(c[0], c[1]) for c in text_line["vertices"]]
        min_x = max(0, min(x for x, _ in line_poly))
        max_x = max(min_x, max(x for x, _ in line_poly))
        min_y = max(0, min(y for _, y in line_poly))
        max_y = max(min_y, max(y for _, y in line_poly))

        image = self._get_line_image(img_id, min_x, max_x, min_y, max_y)
        h, w = image.shape[:2]

        # Pixels outside the line polygon become black (-0.5).
        shifted = [(x - min_x, y - min_y) for x, y in line_poly]
        mask = generate_mask(w, h, [shifted], shrink_dist=0.0)[..., None]
        image = image * mask + (-0.5) * (1.0 - mask)

        if self.transform:
            image = _apply(self.transform, idx, image)
            image = np.clip(image, -0.5, 0.5)
            h, w = image.shape[:2]

        # Aspect-preserving resize to the model height, the width clamped to
        # [10, 800].
        aspect = w / max(h, 1)
        out_w = min(self.max_width, max(10, int(self.output_height * aspect)))
        image = resize(image, (self.output_height, out_w))
        return {
            "image_id": img_id,
            "image": image.astype(np.float32),
            "text": encode_text(text_line["text"], self.alphabet),
        }
