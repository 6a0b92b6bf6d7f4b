"""Losses of the detector and the layout model (the port's counterpart of
``ocrs_models_tpu/ops/losses.py``).

``balanced_cross_entropy_loss`` is the reference's class-balanced BCE:
the ``k = min(#pos, #neg)`` largest pixel losses of each class. The
reference takes ``topk`` with a data-dependent ``k`` and ``.item()`` host
syncs; here, as in the JAX package, the sum of the ``k`` largest entries
comes from a fixed 32-step bisection for the k-th value on detached
values, a few masked reductions on the device with no host sync.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def balanced_cross_entropy_loss(
    pred: torch.Tensor, target: torch.Tensor, sample_weight: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Balanced BCE between probability maps.

    :param pred: ``[N, ...]`` probabilities (sigmoid outputs).
    :param target: targets of the same shape, about binary (augmentation
        can push them slightly outside [0, 1]; they are clipped to it for
        the pixel loss).
    :param sample_weight: optional ``[N]`` weights; rows of weight 0
        (batch padding) give no pixels to either class's pool.
    :return: a 0-d float32 tensor, ``(top-k sum of positives + top-k sum
        of negatives) / max(2k, 1)``.
    """
    pred = pred.float()
    target = target.float()
    pos_mask = target > 0.5
    neg_mask = target < 0.5
    if sample_weight is not None:
        valid = (sample_weight > 0).reshape((-1,) + (1,) * (target.dim() - 1))
        pos_mask = pos_mask & valid
        neg_mask = neg_mask & valid
    target_c = target.clamp(0.0, 1.0)
    eps = 1e-12
    pixel_loss = -(target_c * torch.log(pred.clamp(min=eps))
                   + (1.0 - target_c) * torch.log((1.0 - pred).clamp(min=eps)))
    zero = pixel_loss.new_zeros(())
    pos_loss = torch.where(pos_mask, pixel_loss, zero).reshape(-1)
    neg_loss = torch.where(neg_mask, pixel_loss, zero).reshape(-1)
    k = torch.minimum(pos_mask.sum(), neg_mask.sum())
    total = _top_k_sum(pos_loss, k) + _top_k_sum(neg_loss, k)
    return total / torch.clamp(2 * k, min=1).float()


def _top_k_sum(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Sum of the ``k`` largest entries of the non-negative 1-D ``x``, ``k``
    a 0-d tensor.

    A 32-step bisection on the detached values finds the threshold ``tau``
    with ``count(x > tau) <= k``; the entries above it sum directly, and
    the ``k - count`` slots left go to the largest value below it, shared
    EQUALLY among its ties through the live ``x``: each tied entry gets
    gradient ``residual / n_ties``. (``torch.topk``'s backward gives 1 to
    an arbitrary ``residual`` of the ties instead.)"""
    kf = k.to(x.dtype)
    xs = x.detach()
    lo = xs.new_zeros(())
    hi = xs.max() + 1e-3
    for _ in range(32):
        mid = 0.5 * (lo + hi)
        too_many = (xs > mid).sum() > k
        lo = torch.where(too_many, mid, lo)
        hi = torch.where(too_many, hi, mid)
    selected = xs > hi
    n_sel = selected.sum().to(x.dtype)
    residual = torch.clamp(kf - n_sel, min=0.0)
    tie_val = torch.where(selected, xs.new_full((), -math.inf), xs).max()
    ties = ~selected & (xs == tie_val)
    n_ties = torch.clamp(ties.sum().to(x.dtype), min=1.0)
    zero = x.new_zeros(())
    tie_sum = torch.where(ties, x, zero).sum()
    return torch.where(selected, x, zero).sum() + (residual / n_ties) * tie_sum


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
