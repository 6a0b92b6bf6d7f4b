"""Constants and configuration of the serving path, the recognition trainer
and the layout trainer (counterpart of ``ocrs_models_tpu/config.py``)."""

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


@dataclasses.dataclass(frozen=True)
class LayoutModelConfig:
    """Transformer word-layout model: 6 post-LN layers over sinusoidal
    encodings of the word boxes' coordinates."""

    n_features: int = 4
    d_model: int = 256
    n_layers: int = 6
    n_heads: int = 4
    d_feedforward: int = 1024
    n_classes: int = 2
    pos_embedding: str = "sin"  # "sin" | "mlp"


@dataclasses.dataclass(frozen=True)
class LayoutTrainConfig:
    batch_size: int = 64
    learning_rate: float = 3e-4
    warmup_epochs: int = 50
    n_words: int = 500
    pos_weight: float = 10.0
    max_jitter: int = 10
    seed: int = 1234
    checkpoint_name: str = "text-layout-checkpoint"


def round_up(val: int, unit: int) -> int:
    return ((val + unit - 1) // unit) * unit
