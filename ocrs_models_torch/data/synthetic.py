"""Synthetic datasets (the port's copies of ``SyntheticRecognition`` and
``SyntheticLayout`` in ``ocrs_models_tpu/data/synthetic.py``), drawn
without PIL.

Sample ``idx`` draws its text from ``default_rng(seed * 100_003 + idx)``
out of the JAX dataset's pool (digits, letters, the space and four more
spaces), strips it (an empty text becomes ``"a"``) and renders it with
:func:`~ocrs_models_torch.data.glyphs.render_line`, the glyph-atlas copy
of the JAX dataset's Pillow drawing.
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_ALPHABET
from ..utils.text import encode_text
from .glyphs import render_line
from .resize import resize


class SyntheticRecognition:
    """Random rendered text lines -> ``{"image": [64, W, 1] float32 in
    [-0.5, 0.5], "text": [L] int32}``."""

    def __init__(
        self,
        size: int = 256,
        alphabet: str = DEFAULT_ALPHABET,
        output_height: int = 64,
        max_chars: int = 18,
        seed: int = 0,
        transform=None,
    ):
        self.size = size
        self.alphabet = alphabet
        self.output_height = output_height
        self.max_chars = max_chars
        self.seed = seed
        self.transform = transform

    def __len__(self):
        return self.size

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 100_003 + idx)
        n_chars = int(rng.integers(1, self.max_chars + 1))
        # Biased towards letters and digits, as real lines are.
        pool = self.alphabet[:11] + self.alphabet[44:] + " " * 4
        text = "".join(pool[i] for i in rng.integers(0, len(pool), n_chars)).strip()
        if not text:
            text = "a"

        h = self.output_height
        arr = render_line(text, h).astype(np.float32) / 255.0 - 0.5
        arr = arr[..., None]
        if self.transform is not None:
            if getattr(self.transform, "accepts_index", False):
                arr = self.transform(arr, idx=idx)
            else:
                arr = self.transform(arr)
            arr = np.clip(arr, -0.5, 0.5)
            # Back to the line height after a size-changing augmentation.
            if arr.shape[0] != h:
                aspect = arr.shape[1] / arr.shape[0]
                new_w = min(800, max(10, int(h * aspect)))
                arr = resize(arr, (h, new_w))
        return {"image": arr.astype(np.float32), "text": encode_text(text, self.alphabet)}


class SyntheticLayout:
    """Random word-box layouts ``(boxes [n_words, 4], labels [n_words, 2])``,
    zero-padded, with line-start/line-end labels from the vertical overlap
    of neighbouring words. Sample ``idx`` draws from
    ``default_rng(seed * 100_003 + idx)``, as the JAX dataset does."""

    def __init__(self, size: int = 128, n_words: int = 500, seed: int = 0):
        self.size = size
        self.n_words = n_words
        self.seed = seed

    def __len__(self):
        return self.size

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed * 100_003 + idx)
        boxes = []
        y = float(rng.uniform(10, 60))
        while y < 900 and len(boxes) < self.n_words:
            line_h = float(rng.uniform(12, 24))
            x = float(rng.uniform(10, 60))
            for _ in range(int(rng.integers(1, 12))):
                word_w = float(rng.uniform(20, 90))
                if x + word_w > 980:
                    break
                boxes.append([x, y, x + word_w, y + line_h])
                x += word_w + float(rng.uniform(4, 14))
            y += line_h + float(rng.uniform(4, 20))

        def overlap(a, b) -> bool:
            return a[1] < b[3] and b[1] < a[3]

        labels = [
            [float(i == 0 or not overlap(boxes[i - 1], boxes[i])),
             float(i == len(boxes) - 1 or not overlap(boxes[i], boxes[i + 1]))]
            for i in range(len(boxes))
        ]
        out_boxes = np.zeros((self.n_words, 4), dtype=np.float32)
        out_labels = np.zeros((self.n_words, 2), dtype=np.float32)
        k = min(len(boxes), self.n_words)
        out_boxes[:k] = np.asarray(boxes, dtype=np.float32)[:k]
        out_labels[:k] = np.asarray(labels, dtype=np.float32)[:k]
        return out_boxes, out_labels
