"""Constants and configuration of the serving path and the three trainers
(counterpart of ``ocrs_models_tpu/config.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

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
class DetectionModelConfig:
    """U-Net text detector: depthwise-separable blocks at these widths."""

    depth_scale: Sequence[int] = (8, 16, 32, 32, 64, 128, 256)
    in_channels: int = 1
    n_masks: int = 1  # output masks: the model emits one


@dataclasses.dataclass(frozen=True)
class DetectionTrainConfig:
    mask_height: int = 800
    mask_width: int = 600  # 0.75 of the height
    batch_size: int = 4
    learning_rate: float = 1e-3
    seed: int = 1234
    early_stop_epochs: int = 3
    shrink_distance: float = SHRINK_DISTANCE
    checkpoint_name: str = "text-detection-checkpoint"

    @property
    def mask_size(self) -> tuple[int, int]:
        return (self.mask_height, self.mask_width)


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


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Data-parallel mesh: the axis name of
    :func:`ocrs_models_torch.parallel.create_mesh` and its device count."""

    data_axis: str = "data"
    num_devices: Optional[int] = None  # None => every visible device


@dataclasses.dataclass(frozen=True)
class Config:
    """The model, mesh and trainer configurations in one tree."""

    detection: DetectionModelConfig = dataclasses.field(default_factory=DetectionModelConfig)
    recognition: RecognitionModelConfig = dataclasses.field(
        default_factory=RecognitionModelConfig
    )
    layout: LayoutModelConfig = dataclasses.field(default_factory=LayoutModelConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    detection_train: DetectionTrainConfig = dataclasses.field(
        default_factory=DetectionTrainConfig
    )
    recognition_train: RecognitionTrainConfig = dataclasses.field(
        default_factory=RecognitionTrainConfig
    )
    layout_train: LayoutTrainConfig = dataclasses.field(default_factory=LayoutTrainConfig)


def round_up(val: int, unit: int) -> int:
    return ((val + unit - 1) // unit) * unit
