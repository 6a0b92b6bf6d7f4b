"""Recognition and detection augmentation (the port's copy of
``ocrs_models_tpu/data/augment.py``), in numpy, on ``[H, W, 1]`` float
images in [-0.5, 0.5].

- Recognition: with p=0.5 one of brightness/contrast jitter (0.1/0.1), a
  rotation of up to +-5 degrees with expansion and bilinear resampling
  filled with black (-0.5), or 5 px of black padding.
- Detection, image and mask together: with p=0.5 one of brightness/contrast
  jitter (the image only), a random affine map (+-5 degrees, scale
  0.8-1.2, shear +-5 degrees), a random perspective map (distortion 0.1)
  or a random 600 px crop (padded where the page is smaller); then both
  resize (bilinear) to the training size. The image resamples bilinearly
  with fill -0.5, the mask by nearest neighbour with fill 0.

The JAX package warps with PIL (``Image.rotate`` and ``Image.transform``
on mode "F"); :func:`rotate_expand`, :func:`transform_affine` and
:func:`transform_perspective` compute PIL's sizes, maps and samples.
"""

from __future__ import annotations

import math
import threading

import numpy as np

from .resize import resize, scale_nearest

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
    return _bilinear(src, m[0] * xo + m[1] * yo + m[2], m[3] * xo + m[4] * yo + m[5], fill)


def _bilinear(src: np.ndarray, xin: np.ndarray, yin: np.ndarray, fill: float) -> np.ndarray:
    """PIL's bilinear filter of mode "F" at the input positions ``(xin,
    yin)``: a position outside ``[0, W) x [0, H)`` keeps ``fill``; inside,
    it moves by -0.5 and interpolates its 2x2 taps, clamped at the edges
    (the second row only where it exists). A row's lerp is ``a +
    float32(b - a) * dx`` in double (C's arithmetic on two float pixels),
    the vertical lerp in double, the result stored as float32."""
    h, w = src.shape
    inside = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    xs, ys = xin - 0.5, yin - 0.5
    fx, fy = np.floor(xs), np.floor(ys)
    dx, dy = xs - fx, ys - fy
    x0 = np.clip(fx, -1, w).astype(np.int64)
    y0 = np.clip(fy, -1, h).astype(np.int64)
    xa, xb = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)

    def row(r: np.ndarray) -> np.ndarray:
        left, right = src[r, xa], src[r, xb]
        return left.astype(np.float64) + (right - left).astype(np.float64) * dx

    v1 = row(np.clip(y0, 0, h - 1))
    v2 = np.where((y0 + 1 >= 0) & (y0 + 1 < h), row(np.clip(y0 + 1, 0, h - 1)), v1)
    return np.where(inside, v1 + (v2 - v1) * dy, fill).astype(np.float32)


def _nearest(src: np.ndarray, xin: np.ndarray, yin: np.ndarray, fill: float) -> np.ndarray:
    """PIL's nearest filter of mode "F": the pixel ``(int(xin),
    int(yin))`` (-1 for a negative position), ``fill`` outside."""
    h, w = src.shape
    x = np.where(xin < 0.0, -1, np.clip(xin, -1, w)).astype(np.int64)
    y = np.where(yin < 0.0, -1, np.clip(yin, -1, h)).astype(np.int64)
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    return np.where(inside, src[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)], fill).astype(
        np.float32)


def _fix16(v: float) -> int:
    """Pillow's 16.16 fixed point: ``floor(v * 65536 + 0.5)`` (a C cast
    toward zero for non-negative values)."""
    v = v * 65536.0 + 0.5
    return math.floor(v) if v < 0.0 else int(v)


def transform_affine(img: np.ndarray, size: tuple[int, int], coeffs, nearest: bool,
                     fill: float) -> np.ndarray:
    """PIL's ``Image.transform(size, AFFINE, coeffs, resample, fillcolor=
    fill)`` of an ``[H, W]`` float32 image; ``size = (width, height)``.
    Output pixel ``(x, y)`` samples the input at ``(a x' + b y' + c, d x' +
    e y' + f)`` with ``x' = x + 0.5``. Bilinear runs in double precision;
    nearest runs, as Pillow does, in 16.16 fixed point, each row adding
    ``a`` and ``d`` to its start column by column."""
    src = np.asarray(img, np.float32)
    out_w, out_h = size
    a, b, c, d, e, f = (float(v) for v in coeffs[:6])
    if not nearest:
        xo = np.arange(out_w, dtype=np.float64)[None, :] + 0.5
        yo = np.arange(out_h, dtype=np.float64)[:, None] + 0.5
        return _bilinear(src, a * xo + b * yo + c, d * xo + e * yo + f, fill)
    if b == 0 and d == 0:  # Pillow's scaling path
        return scale_nearest(src, (out_w, out_h), a, c, e, f, fill)
    h, w = src.shape
    if not all(abs(a * x + b * y + c) < 32768.0 and abs(d * x + e * y + f) < 32768.0
               for x, y in ((0, 0), (out_w, out_h), (0, out_h), (out_w, 0))):
        raise NotImplementedError("affine transform past Pillow's 16.16 fixed-point range")
    a0, a1, a3, a4 = _fix16(a), _fix16(b), _fix16(d), _fix16(e)
    a2 = _fix16(c + a * 0.5 + b * 0.5)
    a5 = _fix16(f + d * 0.5 + e * 0.5)
    cols = np.arange(out_w, dtype=np.int64)[None, :]
    rows = np.arange(out_h, dtype=np.int64)[:, None]
    x = (a2 + rows * a1 + cols * a0) >> 16
    y = (a5 + rows * a4 + cols * a3) >> 16
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    return np.where(inside, src[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)], fill).astype(
        np.float32)


def transform_perspective(img: np.ndarray, size: tuple[int, int], coeffs, nearest: bool,
                          fill: float) -> np.ndarray:
    """PIL's ``Image.transform(size, PERSPECTIVE, coeffs, resample,
    fillcolor=fill)`` of an ``[H, W]`` float32 image: output pixel ``(x,
    y)`` samples the input at ``((a x' + b y' + c) / (g x' + h y' + 1), (d
    x' + e y' + f) / (g x' + h y' + 1))`` with ``x' = x + 0.5``, in
    double precision."""
    src = np.asarray(img, np.float32)
    out_w, out_h = size
    a, b, c, d, e, f, g, h = (float(v) for v in coeffs[:8])
    xo = np.arange(out_w, dtype=np.float64)[None, :] + 0.5
    yo = np.arange(out_h, dtype=np.float64)[:, None] + 0.5
    den = g * xo + h * yo + 1
    xin = (a * xo + b * yo + c) / den
    yin = (d * xo + e * yo + f) / den
    return (_nearest if nearest else _bilinear)(src, xin, yin, fill)


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


def _affine(rng: np.random.Generator, imgs):
    h, w = imgs[0].shape[:2]
    angle = np.deg2rad(rng.uniform(-5, 5))
    scale = rng.uniform(0.8, 1.2)
    shear = np.deg2rad(rng.uniform(-5, 5))
    cx, cy = w / 2, h / 2
    # Output -> input map about the centre: the inverse of R(angle) @
    # Shear @ S(scale).
    cos_a, sin_a = np.cos(angle), np.sin(angle)
    fwd = np.array([[cos_a, -sin_a], [sin_a, cos_a]]) @ np.array(
        [[1.0, np.tan(shear)], [0.0, 1.0]]) * scale
    inv = np.linalg.inv(fwd)
    coeffs = (inv[0, 0], inv[0, 1], cx - inv[0, 0] * cx - inv[0, 1] * cy,
              inv[1, 0], inv[1, 1], cy - inv[1, 0] * cx - inv[1, 1] * cy)
    return [transform_affine(img[..., 0], (w, h), coeffs, nearest=i > 0,
                             fill=FILL if i == 0 else 0.0)[..., None]
            for i, img in enumerate(imgs)]


def _perspective(rng: np.random.Generator, imgs, distortion=0.1):
    h, w = imgs[0].shape[:2]
    dx, dy = distortion * w / 2, distortion * h / 2
    src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
    dst = src + rng.uniform(-1, 1, size=(4, 2)) * [dx, dy]
    # PIL's 8 perspective coefficients mapping output -> input.
    mat, vec = [], []
    for (xs, ys), (xd, yd) in zip(src, dst):
        mat.append([xd, yd, 1, 0, 0, 0, -xs * xd, -xs * yd])
        mat.append([0, 0, 0, xd, yd, 1, -ys * xd, -ys * yd])
        vec += [xs, ys]
    coeffs = np.linalg.solve(np.array(mat, dtype=np.float64), np.array(vec))
    return [transform_perspective(img[..., 0], (w, h), coeffs, nearest=i > 0,
                                  fill=FILL if i == 0 else 0.0)[..., None]
            for i, img in enumerate(imgs)]


def _random_crop(rng: np.random.Generator, imgs, size=600):
    h, w = imgs[0].shape[:2]
    pad_h, pad_w = max(0, size - h), max(0, size - w)
    if pad_h or pad_w:
        pads = ((pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2), (0, 0))
        imgs = [np.pad(img, pads, constant_values=FILL if i == 0 else 0.0)
                for i, img in enumerate(imgs)]
        h, w = imgs[0].shape[:2]
    y0 = int(rng.integers(0, h - size + 1))
    x0 = int(rng.integers(0, w - size + 1))
    return [img[y0 : y0 + size, x0 : x0 + size] for img in imgs]


class DetectionAugment:
    """Joint image and mask augmentation, then the resize to ``mask_size``
    ``(height, width)``."""

    accepts_index = True  # datasets pass idx= for reproducible augmentation

    def __init__(self, mask_size: tuple[int, int], augment: bool = True, seed: int = 0):
        self.mask_size = mask_size
        self.augment = augment
        self._rng_source = _PerCallRng(seed)

    def __call__(self, img: np.ndarray, mask: np.ndarray, idx=None
                 ) -> tuple[np.ndarray, np.ndarray]:
        imgs = [img, mask]
        rng = self._rng_source.get(idx)
        if self.augment and rng.uniform() < 0.5:
            choice = rng.integers(0, 4)
            if choice == 0:
                imgs = _color_jitter(rng, imgs)
            elif choice == 1:
                imgs = _affine(rng, imgs)
            elif choice == 2:
                imgs = _perspective(rng, imgs)
            else:
                imgs = _random_crop(rng, imgs)
        return resize(imgs[0], self.mask_size), resize(imgs[1], self.mask_size)
