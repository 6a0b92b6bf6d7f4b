"""Batched preprocessing on the device (counterpart of
``ocrs_models_tpu/data/device_pipeline.py``): resize to model resolution,
normalisation and photometric augmentation of ``[N, C, H, W]`` batches,
after the host has decoded and cropped each sample.

Each function moves its input to ``device`` (default: the card) and
returns a float32 tensor there.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import as_device_tensor


@functools.lru_cache(maxsize=32)
def _resize_weights(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """``[in_size, out_size]`` weights of ``jax.image.resize``'s bilinear
    (triangle) kernel with its antialias, computed in float32 as JAX
    computes them: the kernel widens by the scale when it downscales, each
    output's weights are normalised, and samples outside the input get
    none."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    # Sample positions in float32 with XLA's fused multiply-add: one
    # rounding (float64 holds the float32 product exactly). Apart, the two
    # roundings move a weight by up to 8e-6 at 700 pixels.
    centres = (np.arange(out_size, dtype=f32) + f32(0.5)).astype(np.float64)
    sample = (centres * float(f32(inv_scale)) - 0.5).astype(f32)
    dist = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
    weights = np.maximum(f32(0), f32(1) - dist / f32(max(inv_scale, 1.0)))
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000 * np.finfo(f32).eps,
                       weights / np.where(total != 0, total, 1), 0)
    weights = np.where(((sample >= -0.5) & (sample <= in_size - 0.5))[None, :], weights, 0)
    return torch.from_numpy(weights.astype(f32)).to(device, torch.float64)


def batch_resize(images, out_h: int, out_w: int, device="cuda") -> torch.Tensor:
    """Bilinear resize of ``[N, C, H, W]`` to ``[N, C, out_h, out_w]``,
    antialiased when it downscales, as ``jax.image.resize(..., "bilinear")``
    is: one weight matrix a resized axis, contracted in float64 so that the
    card and the CPU agree to float32 rounding. (``F.interpolate(...,
    antialias=True)`` follows JAX within 1e-6 on the CPU, but its CUDA
    kernel differs from its CPU kernel by up to 2e-5.)"""
    x = as_device_tensor(images, device).double()
    h, w = x.shape[-2:]
    if w != out_w:
        x = x @ _resize_weights(w, out_w, x.device)
    if h != out_h:
        x = _resize_weights(h, out_h, x.device).T @ x
    return x.float()


def normalize_uint8(images, device="cuda") -> torch.Tensor:
    """uint8 batch -> float32 in [-0.5, 0.5] (the models' pixel convention)."""
    return as_device_tensor(images, device).float() / 255.0 - 0.5


def _photometric(images: torch.Tensor, apply: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """Brightness ``b`` and contrast ``c`` (each ``[N, 1, 1, 1]``) on the
    samples where ``apply`` holds; the others pass through."""
    x = (images + 0.5) * b
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    out = ((x - mean) * c + mean).clamp(0.0, 1.0) - 0.5
    return torch.where(apply, out, images)


def photometric_augment(images, generator: torch.Generator, strength: float = 0.1,
                        device="cuda") -> torch.Tensor:
    """Per-sample brightness/contrast jitter, each applied with p=0.5. The
    draws come from ``generator`` on its own device, so one seed gives the
    same jitter on the card and on the CPU."""
    x = as_device_tensor(images, device)

    def draw() -> torch.Tensor:
        u = torch.rand((x.shape[0], 1, 1, 1), generator=generator, device=generator.device)
        return u.to(x.device)

    apply = draw() < 0.5
    b = 1 - strength + 2 * strength * draw()
    c = 1 - strength + 2 * strength * draw()
    return _photometric(x, apply, b, c)


def prepare_line_crops(crops_uint8, out_h: int, max_w: int, min_w: int = 10,
                       device="cuda") -> torch.Tensor:
    """Recognition preprocessing of uint8 line crops ``[N, C, H, W]``
    (padded to one width on the host): normalised, then resized to height
    ``out_h`` at the batch's aspect ratio, its width clamped to
    ``[min_w, max_w]``."""
    x = normalize_uint8(crops_uint8, device)
    h, w = x.shape[-2:]
    aspect_w = max(min_w, min(max_w, int(round(out_h * w / h))))  # half to even
    return batch_resize(x, out_h, aspect_w, device)
