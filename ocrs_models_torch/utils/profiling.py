"""Throughput counter (the port's copy of ``Throughput`` in
``ocrs_models_tpu/utils/profiling.py``). The port's tracer is
:mod:`ocrs_models_torch.profile_kernels`."""

from __future__ import annotations

import time
from typing import Optional


class Throughput:
    """Running items/sec/chip counter with warm-up exclusion.

    The first ``warmup`` updates (kernel builds, cuDNN's algorithm timing)
    are excluded from the cumulative rate. The caller updates after work
    whose result it has read, so the host clock spans the device's work.
    """

    def __init__(self, warmup: int = 1, n_chips: int = 1):
        self.warmup = warmup
        self.n_chips = n_chips
        self.updates = 0
        self.items = 0
        self._started: Optional[float] = None
        self.last_rate = 0.0

    def update(self, n_items: int) -> None:
        now = time.perf_counter()
        self.updates += 1
        if self.updates <= self.warmup:
            self._started = now
            return
        self.items += n_items
        elapsed = now - self._started
        if elapsed > 0:
            self.last_rate = self.items / elapsed / self.n_chips
