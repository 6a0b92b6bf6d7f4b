"""Synthetic text-line dataset (the port's copy of ``SyntheticRecognition``
in ``ocrs_models_tpu/data/synthetic.py``), drawn without PIL.

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
