"""Pixel convention of the models (the port's copy of
``ocrs_models_tpu/utils/image.py``): float images in [-0.5, 0.5], where
-0.5 is black."""

from __future__ import annotations

import numpy as np


def transform_image(img: np.ndarray) -> np.ndarray:
    """uint8 image -> float32 in [-0.5, 0.5]."""
    return img.astype(np.float32) / 255.0 - 0.5


def untransform_image(img: np.ndarray) -> np.ndarray:
    """float image in [-0.5, 0.5] -> uint8 in [0, 255]."""
    return np.clip((np.asarray(img) + 0.5) * 255.0, 0, 255).astype(np.uint8)
