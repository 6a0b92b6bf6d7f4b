"""Train state: the model, its optimizer and the step count.

Counterpart of ``ocrs_models_tpu/training/state.py``. The optimizer is
``clip_by_global_norm`` (optional) followed by Adam(0.9, 0.999, eps 1e-8);
the learning rate is not part of it but passed to each step, so host-driven
schedules change it freely. The clip follows optax's ``clip_by_global_norm``
exactly (``g * max / ||g||`` when ``||g|| >= max``), not
``torch.nn.utils.clip_grad_norm_`` (which adds 1e-6 to the norm).
``torch.optim.Adam`` is algebraically optax's ``scale_by_adam`` followed by
``-lr``. Batch-norm running statistics live in the model's buffers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import torch
from torch import nn


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over all elements of all tensors (optax's
    ``global_norm``), a 0-d tensor on their device."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class Optimizer:
    """Optional global-norm clip, then Adam; the step size comes with each
    :meth:`step`."""

    def __init__(self, params: Iterable[nn.Parameter], grad_clip_norm: Optional[float] = None):
        self.params = list(params)
        self.grad_clip_norm = grad_clip_norm
        self.adam = torch.optim.Adam(self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, lr: float, norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Clip the gradients in ``.grad`` (a missing one counts as 0),
        take one Adam step of size ``lr`` and return the global norm of
        the gradients before clipping. ``norm``: that norm where this
        process holds only part of the gradients (tensor parallelism),
        else the norm of ``.grad``."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if norm is None:
            norm = global_norm(grads)
        if self.grad_clip_norm is not None:
            keep = norm < self.grad_clip_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.grad_clip_norm))
        for group in self.adam.param_groups:
            group["lr"] = float(lr)
        self.adam.step()
        return norm


def make_optimizer(params: Iterable[nn.Parameter], grad_clip_norm: Optional[float] = None) -> Optimizer:
    """Adam direction (torch-default betas and eps) with optional
    global-norm clipping; the step size is given at each step."""
    return Optimizer(params, grad_clip_norm)


@dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    step: int = 0


def create_train_state(model: nn.Module, grad_clip_norm: Optional[float] = None) -> TrainState:
    """A train state for ``model`` (already initialised and on its device)."""
    return TrainState(model=model, optimizer=make_optimizer(model.parameters(), grad_clip_norm))
