"""The layout model's loss (the port's counterpart of
``weighted_bce_with_logits`` in ``ocrs_models_tpu/ops/losses.py``).

The detection model's balanced BCE, in the same JAX file, comes with
detection training (ROADMAP.md, Queue 1 item 5).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def weighted_bce_with_logits(
    logits: torch.Tensor,
    targets: torch.Tensor,
    pos_weight: float,
    sample_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``BCEWithLogitsLoss(pos_weight=w)``: the positive term scaled by
    ``pos_weight``, the mean over all elements, in float32 through
    log-sigmoids. ``sample_weight`` (``[N]``, 0 or 1) takes batch-padding
    rows out of the mean."""
    logits = logits.float()
    targets = targets.float()
    loss = -(pos_weight * targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))
    if sample_weight is None:
        return loss.mean()
    sample_weight = sample_weight.float()
    w = sample_weight.reshape((-1,) + (1,) * (loss.dim() - 1))
    per_sample = math.prod(loss.shape[1:])
    denom = torch.clamp(sample_weight.sum() * per_sample, min=1.0)
    return torch.sum(loss * w) / denom
