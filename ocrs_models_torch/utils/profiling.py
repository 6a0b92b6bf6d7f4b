"""Profiling and throughput instrumentation (counterpart of
``ocrs_models_tpu/utils/profiling.py``): a ``torch.profiler`` trace for
TensorBoard and a ``Throughput`` counter of items/sec/chip with warm-up
exclusion. The port's per-kernel breakdown is
:mod:`ocrs_models_torch.profile_kernels`."""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Trace the host and, where there is one, the CUDA device into
    ``logdir`` (a ``*.pt.trace.json`` that TensorBoard's profiler plugin and
    Perfetto read), written when the block ends. No-op when ``logdir`` is
    falsy."""
    if not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir)),
    ):
        yield


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

    def items_per_sec_per_chip(self) -> float:
        return self.last_rate

    def summary(self) -> str:
        return f"{self.last_rate:.0f} items/sec/chip"
