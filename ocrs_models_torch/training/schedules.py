"""Host-driven learning-rate schedules (the port's copy of
``ocrs_models_tpu/training/schedules.py``).

The learning rate enters each train step as a number, so these run on the
host between steps, reproducing the reference's torch schedulers:
``ReduceLROnPlateau(factor=0.1, patience=3)`` for recognition and a
50-epoch linear warmup for layout.
"""

from __future__ import annotations


class ReduceLROnPlateau:
    """torch-semantics plateau scheduler (mode='min', rel threshold 1e-4)."""

    def __init__(
        self,
        initial_lr: float,
        factor: float = 0.1,
        patience: int = 3,
        threshold: float = 1e-4,
        min_lr: float = 0.0,
    ):
        self.lr = initial_lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad_epochs = 0
        return self.lr


class LinearWarmup:
    """lr * min((epoch + 1) / (warmup + 1), 1)."""

    def __init__(self, initial_lr: float, warmup_epochs: int = 50):
        self.initial_lr = initial_lr
        self.warmup_epochs = warmup_epochs

    def at_epoch(self, epoch: int) -> float:
        if self.warmup_epochs <= 0:
            return self.initial_lr
        return self.initial_lr * min((epoch + 1) / (self.warmup_epochs + 1), 1.0)
