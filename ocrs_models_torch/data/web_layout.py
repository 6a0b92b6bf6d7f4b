"""WebLayout dataset: layout-scraper JSON -> word boxes + line labels (the
port's copy of ``ocrs_models_tpu/data/web_layout.py``, numpy and json only).

An 80/20 split of the directory's files in ``os.listdir`` order,
line-start/line-end labels from the vertical overlap of adjacent words of a
paragraph, optional coordinate normalization to [-0.5, 0.5], random jitter
(one ``uniform`` draw for x, then one for y, from the dataset's generator)
and padding or truncation to a fixed word count.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np


def _intervals_overlap(a: float, b: float, c: float, d: float) -> bool:
    return b > c if a <= c else d > a


def extract_word_boxes(
    content: dict,
    normalize_coords: bool = True,
    jitter_x: float = 0.0,
    jitter_y: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Scraper-schema page dict -> (boxes [W,4], labels [W,2]) float32.

    Labels derive from the vertical-overlap heuristic between adjacent
    words of a paragraph (reference web_layout.py:140-172). Shared by the
    ``WebLayout`` loader and the first-party document synthesizer
    (data/layout_synth.py), so generated and scraped ground truth are
    labeled identically.
    """
    vw = int(content["resolution"]["width"])
    vh = int(content["resolution"]["height"])

    def transform(coords):
        left, top, right, bottom = (float(c) for c in coords)
        left += jitter_x
        right += jitter_x
        top += jitter_y
        bottom += jitter_y
        assert min(left, top, right, bottom) >= 0
        if normalize_coords:
            left, right = left / vw - 0.5, right / vw - 0.5
            top, bottom = top / vh - 0.5, bottom / vh - 0.5
        return [left, top, right, bottom]

    words: list[list[float]] = []
    labels: list[list[float]] = []
    for para in content["paragraphs"]:
        para_words = para["words"]
        for i, word in enumerate(para_words):
            left, top, right, bottom = transform(word["coords"])
            words.append([left, top, right, bottom])

            line_start = i == 0
            if not line_start:
                _, ptop, _, pbottom = transform(para_words[i - 1]["coords"])
                line_start = not _intervals_overlap(ptop, pbottom, top, bottom)
            line_end = i == len(para_words) - 1
            if not line_end:
                _, ntop, _, nbottom = transform(para_words[i + 1]["coords"])
                line_end = not _intervals_overlap(top, bottom, ntop, nbottom)
            labels.append([float(line_start), float(line_end)])

    boxes = np.asarray(words, dtype=np.float32).reshape(-1, 4)
    labs = np.asarray(labels, dtype=np.float32).reshape(-1, 2)
    return boxes, labs


class WebLayout:
    def __init__(
        self,
        root_dir: str,
        randomize: bool = False,
        padded_size: Optional[int] = None,
        train: bool = True,
        max_images: Optional[int] = None,
        filter: Optional[Callable[[str], bool]] = None,
        normalize_coords: bool = True,
        max_jitter: int = 25,
        seed: int = 0,
    ):
        self.root_dir = root_dir
        self.randomize = randomize
        self.padded_size = padded_size
        self.normalize_coords = normalize_coords
        self.max_jitter = max_jitter
        self._rng = np.random.default_rng(seed)

        files = [
            f
            for f in os.listdir(root_dir)
            if os.path.isfile(os.path.join(root_dir, f)) and f.endswith(".json")
        ]
        split = round(len(files) * 4 / 5)
        self._files = files[:split] if train else files[split:]
        if max_images is not None:
            self._files = self._files[:max_images]
        if filter:
            self._files = [f for f in self._files if filter(f)]

    def __len__(self):
        return len(self._files)

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        """Returns ``(boxes [W,4] float32, labels [W,2] float32)``."""
        path = os.path.join(self.root_dir, self._files[idx])
        jitter_x = jitter_y = 0.0
        if self.randomize:
            jitter_x = float(self._rng.uniform(0, self.max_jitter))
            jitter_y = float(self._rng.uniform(0, self.max_jitter))

        with open(path) as f:
            content = json.load(f)
        boxes, labs = extract_word_boxes(
            content, self.normalize_coords, jitter_x, jitter_y
        )
        if self.padded_size:
            out_b = np.zeros((self.padded_size, 4), np.float32)
            out_l = np.zeros((self.padded_size, 2), np.float32)
            k = min(len(boxes), self.padded_size)
            out_b[:k] = boxes[:k]
            out_l[:k] = labs[:k]
            return out_b, out_l
        return boxes, labs
