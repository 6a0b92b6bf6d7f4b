"""Process-group setup: joining a ``torchrun`` job and spawning one process
per device (the port's counterpart of
``ocrs_models_tpu/parallel/distributed.py``).

The JAX package drives every chip of a host from one process and joins
hosts through ``jax.distributed``. The port runs one process per device:
NCCL between CUDA devices, ``gloo`` on the CPU. A trainer's
``--num-devices N`` spawns N ranks on one host (:func:`spawn`); under
``torchrun`` every process joins the job from its environment
(:func:`initialize_multihost`).

Typical trainer prologue::

    rank, world = initialize_multihost(device="cuda")  # (0, 1) alone
    loader = DataLoader(..., process_index=rank, process_count=world)
    mesh = create_mesh()                               # spans the group
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import pickle
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.distributed as dist

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)
"""How long a collective (and joining the group) waits for the other ranks
before it raises: a rank that never arrives fails the run instead of
hanging it."""


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def initialize_multihost(init_method: Optional[str] = None, world_size: Optional[int] = None,
                         rank: Optional[int] = None,
                         device: str | torch.device = "cuda") -> tuple[int, int]:
    """Join the process group of a multi-process run; returns ``(rank,
    world_size)``.

    - An initialised process group is kept as it is.
    - Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` in
      the environment) the process joins through ``env://``.
    - With ``init_method`` (``file://...`` or ``tcp://host:port``), it
      joins as ``rank`` of ``world_size``.
    - Otherwise nothing happens: ``(0, 1)``.

    On a CUDA ``device`` the backend is NCCL and the process's current
    device becomes ``cuda:LOCAL_RANK`` (``rank`` without ``torchrun``);
    on the CPU it is ``gloo``."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    dev = torch.device(device)
    if init_method is None and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init_method = "env://"
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    elif init_method is not None:
        if rank is None or world_size is None:
            raise ValueError("initialize_multihost: init_method needs rank and world_size")
        local_rank = rank
    else:
        return 0, 1
    if dev.type == "cuda":
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"initialize_multihost: local rank {local_rank} but "
                               f"{torch.cuda.device_count()} CUDA devices are visible")
        torch.cuda.set_device(local_rank)
    dist.init_process_group(_backend(dev), init_method=init_method, world_size=world_size,
                            rank=rank, timeout=COLLECTIVE_TIMEOUT)
    return dist.get_rank(), dist.get_world_size()


def check_world(world: int, device: torch.device) -> None:
    """Raise unless ``world`` ranks fit on ``device``'s kind: at least one,
    and on CUDA no more than the visible cards (one rank per card)."""
    if world < 1:
        raise ValueError(f"need at least one rank, got {world}")
    if device.type == "cuda" and world > torch.cuda.device_count():
        raise RuntimeError(f"{world} ranks but {torch.cuda.device_count()} CUDA devices are "
                           "visible; one rank per card")


def _run_rank(fn, rank: int, world: int, init_method: str, device: str, backend: str,
              args: tuple, result_path: str) -> None:
    """One spawned rank: join the group, run ``fn(rank, world, device,
    *args)``, write its result. An exception ends the process with a
    non-zero code (and its traceback on stderr), which fails the spawn."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)  # ranks share the host's cores
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=COLLECTIVE_TIMEOUT)
    try:
        result = fn(rank, world, dev, *args)
        with open(result_path, "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, device: str | torch.device = "cuda", args: tuple = (),
          share_device: bool = False, timeout: Optional[float] = None,
          store_dir: Optional[str] = None) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``world`` new processes
    (the ``spawn`` start method) joined by a process group; returns each
    rank's result, in rank order (``fn`` and its results must pickle).

    On CUDA, rank ``r`` drives ``cuda:r`` over NCCL, and a ``world`` above
    the visible device count raises: a card is never shared unless asked.
    ``share_device=True`` puts every rank on ``device`` itself over
    ``gloo``, whose collectives copy CUDA tensors through the host (NCCL
    refuses two ranks on one card); for checking the collective paths on
    one card. On the CPU every rank runs on the CPU over ``gloo``.

    The group meets in a ``FileStore`` under ``store_dir`` (default: a new
    temporary directory). When a rank fails, the others are terminated and
    this raises; so does a run past ``timeout`` seconds (None: no limit;
    a collective that waits :data:`COLLECTIVE_TIMEOUT` raises in its rank
    anyway)."""
    dev = torch.device(device)
    if world < 1:
        raise ValueError(f"spawn: need at least one rank, got {world}")
    if dev.type == "cuda" and not share_device:
        check_world(world, dev)
        devices = [f"cuda:{r}" for r in range(world)]
        backend = "nccl"
    elif dev.type in ("cuda", "cpu"):
        devices = [str(dev)] * world
        backend = "gloo"
    else:
        raise RuntimeError(f"spawn: unsupported device {dev}")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ocrs_spawn_", dir=store_dir) as tmp:
        init_method = f"file://{Path(tmp) / 'store'}"
        results = [str(Path(tmp) / f"rank{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_run_rank, args=(fn, r, world, init_method, devices[r],
                                                     backend, args, results[r]))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while True:
                failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
                if failed:
                    raise RuntimeError(f"spawn: rank {failed[0][0]} exited with code "
                                       f"{failed[0][1]}")
                running = [p.sentinel for p in procs if p.exitcode is None]
                if not running:
                    break
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"spawn: the {world} ranks ran past {timeout} s")
                multiprocessing.connection.wait(running, timeout=0.5)
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.exitcode is None:
                    p.kill()
                    p.join()
        out = []
        for path in results:
            with open(path, "rb") as f:
                out.append(pickle.load(f))
        return out
