"""Recognition augmentation (the port's copy of ``RecognitionAugment`` in
``ocrs_models_tpu/data/augment.py``), in numpy.

With p=0.5 one of: brightness/contrast jitter (0.1/0.1), a rotation of up
to +-5 degrees with expansion and bilinear resampling filled with black
(-0.5), or 5 px of black padding, on ``[H, W, 1]`` float images in
[-0.5, 0.5]. The JAX package rotates with PIL's ``Image.rotate(angle,
BILINEAR, expand=True, fillcolor=-0.5)`` on mode "F";
:func:`_rotate_expand` computes the same output size, matrix and samples.
"""

from __future__ import annotations

import math
import threading

import numpy as np

FILL = -0.5  # black for normalized images


def _color_jitter(rng: np.random.Generator, imgs: list[np.ndarray]) -> list[np.ndarray]:
    # Brightness/contrast in the [0, 1] domain, like torchvision on floats.
    b = rng.uniform(0.9, 1.1)
    c = rng.uniform(0.9, 1.1)
    out = []
    for i, img in enumerate(imgs):
        if i > 0:
            out.append(img)  # photometric noise never touches masks
            continue
        x = img + 0.5
        x = x * b
        mean = x.mean()
        x = (x - mean) * c + mean
        out.append(np.clip(x, 0.0, 1.0) - 0.5)
    return out


def rotate_expand(img: np.ndarray, angle: float, fill: float = FILL) -> np.ndarray:
    """PIL's ``Image.rotate(angle, BILINEAR, expand=True, fillcolor=fill)``
    of an ``[H, W]`` float32 image, counter-clockwise in degrees.

    As PIL does: the inverse matrix with entries rounded to 15 digits, the
    output size from the rotated corners, each output pixel sampled at its
    centre in double precision; a sample outside ``[0, W) x [0, H)`` keeps
    the fill; inside, it moves by -0.5 and interpolates its 2x2 taps,
    clamped at the edges (the second row only where it exists). A row's
    lerp is ``a + float32(b - a) * dx`` in double (C's arithmetic on two
    float pixels), the vertical lerp in double, the result stored as
    float32.
    """
    src = np.asarray(img, np.float32)
    if angle % 360.0 == 0:  # PIL returns a copy
        return src.copy()
    h, w = src.shape
    a = -math.radians(angle % 360.0)
    m = [round(math.cos(a), 15), round(math.sin(a), 15), 0.0,
         round(-math.sin(a), 15), round(math.cos(a), 15), 0.0]

    def transform(x: float, y: float) -> tuple[float, float]:
        return m[0] * x + m[1] * y + m[2], m[3] * x + m[4] * y + m[5]

    m[2], m[5] = transform(-w / 2, -h / 2)
    m[2] += w / 2
    m[5] += h / 2
    corners = [transform(x, y) for x, y in ((0, 0), (w, 0), (w, h), (0, h))]
    nw = math.ceil(max(p[0] for p in corners)) - math.floor(min(p[0] for p in corners))
    nh = math.ceil(max(p[1] for p in corners)) - math.floor(min(p[1] for p in corners))
    m[2], m[5] = transform(-(nw - w) / 2.0, -(nh - h) / 2.0)

    xo = np.arange(nw, dtype=np.float64)[None, :] + 0.5
    yo = np.arange(nh, dtype=np.float64)[:, None] + 0.5
    xin = m[0] * xo + m[1] * yo + m[2]
    yin = m[3] * xo + m[4] * yo + m[5]
    inside = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    xs, ys = xin - 0.5, yin - 0.5
    fx, fy = np.floor(xs), np.floor(ys)
    dx, dy = xs - fx, ys - fy
    x0, y0 = fx.astype(np.int64), fy.astype(np.int64)
    xa, xb = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)

    def row(r: np.ndarray) -> np.ndarray:
        left, right = src[r, xa], src[r, xb]
        return left.astype(np.float64) + (right - left).astype(np.float64) * dx

    v1 = row(np.clip(y0, 0, h - 1))
    v2 = np.where((y0 + 1 >= 0) & (y0 + 1 < h), row(np.clip(y0 + 1, 0, h - 1)), v1)
    return np.where(inside, v1 + (v2 - v1) * dy, fill).astype(np.float32)


def _rotate_expand(rng: np.random.Generator, imgs, max_deg=5.0):
    angle = rng.uniform(-max_deg, max_deg)
    return [rotate_expand(img[..., 0], angle)[..., None] for img in imgs]


def _pad(imgs, px=5):
    return [np.pad(img, ((px, px), (px, px), (0, 0)), constant_values=FILL) for img in imgs]


class _PerCallRng:
    """Deterministic, thread-safe randomness for augmentations.

    The loader fetches samples from a thread pool, so one shared
    ``Generator`` would make the augmentation depend on thread scheduling
    (and Generators are not thread-safe). Each call derives a fresh
    Generator from ``(seed, index)`` when the dataset passes its sample
    index, or from ``(seed, call counter)`` otherwise (thread-safe, though
    only index-keyed calls are reproducible under concurrency).
    """

    def __init__(self, seed: int):
        self.seed = seed
        self._counter = 0
        self._lock = threading.Lock()

    def get(self, idx=None) -> np.random.Generator:
        if idx is None:
            with self._lock:
                idx = 1_000_000_007 + self._counter
                self._counter += 1
        return np.random.default_rng((self.seed, int(idx)))


class RecognitionAugment:
    """Randomized line-crop augmentation."""

    accepts_index = True  # datasets pass idx= for reproducible augmentation

    def __init__(self, seed: int = 0):
        self._rng_source = _PerCallRng(seed)

    def __call__(self, img: np.ndarray, idx=None) -> np.ndarray:
        rng = self._rng_source.get(idx)
        if rng.uniform() >= 0.5:
            return img
        choice = rng.integers(0, 3)
        if choice == 0:
            return _color_jitter(rng, [img])[0]
        if choice == 1:
            return _rotate_expand(rng, [img])[0]
        return _pad([img])[0]
