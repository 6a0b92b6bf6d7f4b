"""What the three trainers share to train on several devices.

``--num-devices N`` in one process spawns N ranks (:func:`spawn_trainer`),
each of which runs the trainer's ``main`` in a process group; under
``torchrun`` every process joins the job itself. Within the group:
:class:`Ranks` holds this rank's place, sums the host-side counts behind
the metrics across the ranks, and lets rank 0 alone print and write.
"""

from __future__ import annotations

import importlib
import os
import sys
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..parallel import create_mesh, initialize_multihost, spawn
from ..parallel.distributed import check_world
from ..utils.metrics import get_metric_means


def _run_rank(rank: int, world: int, device: torch.device, module: str, argv: list) -> None:
    importlib.import_module(f"ocrs_models_torch.training.{module}").main(argv, device=device)


def spawn_trainer(module: str, argv: Optional[Sequence[str]], device, num_devices: int,
                  build_kernels: bool = False) -> None:
    """Run ``training.<module>.main(argv)`` on ``num_devices`` ranks of one
    host, one process each (on CUDA, rank ``r`` on ``cuda:r``; more ranks
    than visible cards raise). ``build_kernels`` compiles the CUDA kernels
    here first, so that the ranks find them built."""
    dev = torch.device(device)
    check_world(num_devices, dev)
    if dev.type == "cuda" and build_kernels:
        from ..ops import _build

        _build.build()
    argv = list(sys.argv[1:] if argv is None else argv)
    spawn(_run_rank, num_devices, dev, args=(module, argv))


def should_spawn(num_devices: Optional[int]) -> bool:
    """Whether ``--num-devices`` asks this process to spawn the ranks: more
    than one device, and no process group to join (``torchrun`` sets
    ``RANK``; a spawned rank has its group already)."""
    return (num_devices or 1) > 1 and not dist.is_initialized() and "RANK" not in os.environ


def check_batch(batch_size: int, world: int) -> None:
    """Each of ``world`` ranks takes ``batch_size // world`` rows a step."""
    if batch_size % world:
        raise ValueError(f"--batch-size {batch_size} is not a multiple of the {world} ranks")


class Ranks:
    """This process's place in a data-parallel run: ``rank`` of ``world``
    and the ``mesh`` over them (None for a single rank)."""

    def __init__(self, device: torch.device, rank: int = 0, world: int = 1, mesh=None):
        self.device, self.rank, self.world, self.mesh = device, rank, world, mesh

    @classmethod
    def join(cls, device, build_kernels: bool = False) -> "Ranks":
        """Join the process group of a spawned or ``torchrun`` job (a single
        rank without one) and resolve ``device`` (``"cuda"``: this rank's
        card); with ``build_kernels`` on CUDA, rank 0 compiles the kernels
        while the others wait."""
        rank, world = initialize_multihost(device=device)
        device = resolve_device(device)
        ranks = cls(device, rank, world, create_mesh(devices=[device]) if world > 1 else None)
        if build_kernels and device.type == "cuda" and world > 1:
            from ..ops import _build

            if ranks.writer:
                _build.build()
            ranks.barrier()
        return ranks

    @property
    def writer(self) -> bool:
        """Whether this rank prints and writes files (rank 0)."""
        return self.rank == 0

    def print(self, *args, **kwargs) -> None:
        if self.writer:
            print(*args, **kwargs)

    def barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier(self.mesh.group)

    def sum(self, values: Sequence[float]) -> list[float]:
        """``values`` summed across the ranks (float64)."""
        if self.mesh is None:
            return [float(v) for v in values]
        t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, group=self.mesh.group)
        return t.tolist()

    def means(self, dicts: list[dict]) -> dict:
        """``get_metric_means`` over every rank's ``dicts`` (a missing key
        counts 0; the keys are those of any rank)."""
        if self.mesh is None:
            return get_metric_means(dicts)
        keys = [None] * self.world
        dist.all_gather_object(keys, sorted({k for d in dicts for k in d}), group=self.mesh.group)
        keys = sorted({k for ks in keys for k in ks})
        sums = self.sum([len(dicts)] + [sum(d.get(k, 0.0) for d in dicts) for k in keys])
        return {k: v / sums[0] for k, v in zip(keys, sums[1:])} if sums[0] else {}
