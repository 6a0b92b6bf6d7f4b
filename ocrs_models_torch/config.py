"""Constants of the serving path (counterpart of ``ocrs_models_tpu/config.py``)."""

from __future__ import annotations

DEFAULT_ALPHABET = (
    " 0123456789!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
    + "€"  # Euro sign
    + "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
)
"""Recognition alphabet (96 chars; class 0 is the CTC blank), the one the
published ocrs checkpoints use."""

SHRINK_DISTANCE = 3.0
"""Pixels by which text polygons were shrunk for the detection masks; word
quads are expanded by the same distance at inference."""

DET_SIZE = (800, 600)
"""Detection input (height, width): the U-Net's training mask size."""


def round_up(val: int, unit: int) -> int:
    return ((val + unit - 1) // unit) * unit
