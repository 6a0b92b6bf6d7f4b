"""Image resize in numpy that reproduces PIL's ``Image.BILINEAR`` on mode "F".

PIL's bilinear resample is a triangle filter whose support widens with
the downscale factor, so it antialiases when shrinking. It runs as two
separable passes, horizontal then vertical; each output value is a
sequential float64 sum over at most ``2 * ceil(support) + 1`` input taps,
stored as float32. This module computes the same taps and weights as PIL's
``precompute_coeffs`` (``Resample.c``) and accumulates them in the same
order, so the result matches PIL to float32 rounding without needing PIL.
"""

from __future__ import annotations

import math

import numpy as np


def _taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """``(index, weight)``, each ``[out_size, ksize]``: the input positions
    each output reads and their normalised float64 weights (0 past the
    filter's extent)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the bilinear (triangle) filter's support is 1
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero; negatives clamp to 0 anyway.
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64)
    k = np.arange(ksize)[None, :]
    x = xmin[:, None] + k
    w = np.maximum(1.0 - np.abs((x - center[:, None] + 0.5) / filterscale), 0.0)
    w = np.where(k < (xmax - xmin)[:, None], w, 0.0)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    return np.minimum(x, in_size - 1), w


def _resample_rows(img: np.ndarray, out_size: int) -> np.ndarray:
    """Resample axis 0 of a 2-D image; returns float32. Gathering whole
    rows keeps every read contiguous, so the horizontal pass runs on the
    transposed image."""
    idx, w = _taps(img.shape[0], out_size)
    src = np.ascontiguousarray(img, dtype=np.float64)
    acc = np.zeros((out_size, img.shape[1]), np.float64)
    for k in range(idx.shape[1]):
        acc += src[idx[:, k], :] * w[:, k, None]
    return acc.astype(np.float32)


def resize(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Resize an ``[H, W, 1]`` float image to ``size = (height, width)``."""
    h, w = size
    if img.shape[:2] == (h, w):  # identity: no resample
        return np.ascontiguousarray(img, dtype=np.float32)
    out = np.asarray(img, dtype=np.float32)[..., 0]
    if out.shape[1] != w:  # horizontal pass first, as PIL does
        out = _resample_rows(out.T, w).T
    if out.shape[0] != h:
        out = _resample_rows(out, h)
    return np.ascontiguousarray(out)[..., None]
