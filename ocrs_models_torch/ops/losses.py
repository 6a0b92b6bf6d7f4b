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

from ..parallel.mesh import all_reduce


def balanced_cross_entropy_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    sample_weight: Optional[torch.Tensor] = None,
    group=None,
) -> torch.Tensor:
    """Balanced BCE between probability maps.

    :param pred: ``[N, ...]`` probabilities (sigmoid outputs).
    :param target: targets of the same shape, about binary (augmentation
        can push them slightly outside [0, 1]; they are clipped to it for
        the pixel loss).
    :param sample_weight: optional ``[N]`` weights; rows of weight 0
        (batch padding) give no pixels to either class's pool.
    :param group: a process group whose ranks each hold a slice of the
        batch: the loss is then the one of the whole batch, ``k``, the
        bisection's counts and the tie rule taken over every rank's pixels
        (so every rank picks the same threshold), and the return value is
        this rank's share of it: the sum over ranks is the loss, and each
        rank's gradient is its slice's.
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
    pools = torch.stack([torch.where(pos_mask, pixel_loss, zero).reshape(-1),
                         torch.where(neg_mask, pixel_loss, zero).reshape(-1)])
    counts = all_reduce(torch.stack([pos_mask.sum(), neg_mask.sum()]), group)
    k = torch.minimum(counts[0], counts[1])
    return _top_k_sums(pools, k, group).sum() / torch.clamp(2 * k, min=1).float()


def _top_k_sums(x: torch.Tensor, k: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of the ``k`` largest entries of each row of the non-negative
    ``x [P, M]`` (one row per pool), ``k`` a 0-d tensor; ``[P]``.

    A 32-step bisection on the detached values finds each row's threshold
    ``tau`` with ``count(x > tau) <= k``; the entries above it sum directly,
    and the ``k - count`` slots left go to the largest value below it,
    shared EQUALLY among its ties through the live ``x``: each tied entry
    gets gradient ``residual / n_ties``. (``torch.topk``'s backward gives 1
    to an arbitrary ``residual`` of the ties instead.) With ``group`` the
    rows are slices of longer rows spread over the ranks: the maximum,
    every count and the tie value are reduced across them (one all-reduce
    a bisection step for all rows), and the sums are this rank's."""
    kf = k.to(x.dtype)
    xs = x.detach()
    lo = xs.new_zeros(xs.shape[0])
    hi = all_reduce(xs.max(dim=1).values, group, "max") + 1e-3
    for _ in range(32):
        mid = 0.5 * (lo + hi)
        too_many = all_reduce((xs > mid[:, None]).sum(dim=1), group) > k
        lo = torch.where(too_many, mid, lo)
        hi = torch.where(too_many, hi, mid)
    selected = xs > hi[:, None]
    n_sel = all_reduce(selected.sum(dim=1), group).to(x.dtype)
    residual = torch.clamp(kf - n_sel, min=0.0)
    below = torch.where(selected, xs.new_full((), -math.inf), xs).max(dim=1).values
    tie_val = all_reduce(below, group, "max")
    ties = ~selected & (xs == tie_val[:, None])
    n_ties = torch.clamp(all_reduce(ties.sum(dim=1), group).to(x.dtype), min=1.0)
    zero = x.new_zeros(())
    tie_sum = torch.where(ties, x, zero).sum(dim=1)
    return torch.where(selected, x, zero).sum(dim=1) + (residual / n_ties) * tie_sum


def weighted_bce_with_logits(
    logits: torch.Tensor,
    targets: torch.Tensor,
    pos_weight: float,
    sample_weight: Optional[torch.Tensor] = None,
    group=None,
) -> torch.Tensor:
    """``BCEWithLogitsLoss(pos_weight=w)``: the positive term scaled by
    ``pos_weight``, the mean over all elements, in float32 through
    log-sigmoids. ``sample_weight`` (``[N]``, 0 or 1) takes batch-padding
    rows out of the mean. With ``group`` (ranks each holding a slice of
    the batch) the mean is over every rank's elements, and the return value
    is this rank's share of it: ``sum(loss * w) / (sum over ranks of
    sum(w) * elements per row)``."""
    logits = logits.float()
    targets = targets.float()
    loss = -(pos_weight * targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))
    if sample_weight is None and group is None:
        return loss.mean()
    if sample_weight is None:
        sample_weight = loss.new_ones(loss.shape[0])
    sample_weight = sample_weight.float()
    w = sample_weight.reshape((-1,) + (1,) * (loss.dim() - 1))
    per_sample = math.prod(loss.shape[1:])
    denom = torch.clamp(all_reduce(sample_weight.sum(), group) * per_sample, min=1.0)
    return torch.sum(loss * w) / denom
