"""Constants and configuration of the serving path and the recognition
trainer (counterpart of ``ocrs_models_tpu/config.py``)."""

from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass(frozen=True)
class RecognitionModelConfig:
    """CRNN text recognizer: 2-layer biGRU, the model emits ``W//4 + 1``
    steps but CTC input lengths use ``W // downsample``."""

    alphabet: str = DEFAULT_ALPHABET
    gru_hidden: int = 256
    gru_layers: int = 2
    image_height: int = 64
    downsample: int = 4

    @property
    def n_classes(self) -> int:
        return len(self.alphabet) + 1


@dataclasses.dataclass(frozen=True)
class RecognitionTrainConfig:
    batch_size: int = 20
    learning_rate: float = 1e-3
    plateau_factor: float = 0.1
    plateau_patience: int = 3
    grad_clip_norm: float = 4.0
    seed: int = 1234
    output_height: int = 64
    min_width: int = 10
    max_width: int = 800
    # Collation rounds widths up to multiples of this, which bounds the
    # number of distinct shapes the kernels and cuDNN see.
    width_step: int = 256
    checkpoint_name: str = "text-rec-checkpoint"


def round_up(val: int, unit: int) -> int:
    return ((val + unit - 1) // unit) * unit
