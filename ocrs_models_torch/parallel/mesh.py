"""Meshes, batch sharding and collectives (the port's counterpart of
``ocrs_models_tpu/parallel/mesh.py``): the data-parallel mesh, and the
data x model mesh of the layout model's tensor parallelism
(:class:`Mesh2D`, :func:`layout_tp_spec`; the sharding itself is
``parallel/tp.py``).

The JAX package lays one mesh over every chip and lets GSPMD (or
``shard_map``) insert the collectives. Here a :class:`Mesh` is either

- one process per device, joined by a ``torch.distributed`` process group
  (NCCL on CUDA, ``gloo`` on the CPU): ``size`` is the group's world size,
  ``devices`` holds this process's one device and the collectives below
  run over ``group``; what a training step uses; or
- several devices driven from one process (``group`` None): serving keeps
  one model replica per device (``OcrPipeline(mesh=...)``).

The collectives take a process group; ``None`` (one process) makes each of
them the identity, so a step written with them runs unchanged in one
process. Sums are what the steps reduce: every rank's loss term is its
share of the global loss, so the parameter gradients add up across ranks
(``psum``), as in the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..config import MeshConfig


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh: ``size`` shards of every batch along ``axis``.

    ``devices`` are the devices this process drives (one per process in a
    process group); ``group`` is the process group, None in one process."""

    devices: tuple[torch.device, ...]
    size: int
    group: Optional[object] = None
    axis: str = "data"

    @property
    def rank(self) -> int:
        """This process's rank in ``group`` (0 without one)."""
        return 0 if self.group is None else dist.get_rank(self.group)


def _rank_device() -> torch.device:
    """The device of this rank of the default process group: the current
    CUDA device under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def create_mesh(num_devices: Optional[int] = None,
                devices: Optional[Sequence] = None, axis: str = MeshConfig.data_axis) -> Mesh:
    """A 1-D data mesh.

    In a process of an initialised process group the mesh spans the group:
    ``size`` is its world size (``num_devices``, if given, must equal it)
    and ``devices`` this process's device (default: the current CUDA device
    under NCCL, else the CPU). Otherwise it spans ``devices`` (default:
    every visible CUDA device; raises without one) in this process, cut to
    the first ``num_devices``."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if num_devices not in (None, world):
            raise ValueError(f"create_mesh: num_devices={num_devices} in a process group of "
                             f"{world} ranks")
        devs = (_rank_device(),) if devices is None else tuple(torch.device(d) for d in devices)
        if len(devs) != 1:
            raise ValueError(f"create_mesh: a rank of a process group drives one device, "
                             f"got {devs}")
        return Mesh(devs, world, dist.group.WORLD, axis)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("create_mesh: no CUDA device is visible; pass devices=[...] "
                               "(e.g. ['cpu', 'cpu']) for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = tuple(torch.device(d) for d in devices)
    if num_devices is not None:
        if not 1 <= num_devices <= len(devs):
            raise ValueError(f"create_mesh: num_devices={num_devices} but {len(devs)} devices")
        devs = devs[:num_devices]
    return Mesh(devs, len(devs), None, axis)


def shard_batch(batch: dict, mesh: Mesh) -> list[dict]:
    """The shards of the global ``batch`` that this process holds, one per
    device of ``mesh.devices``, each moved to its device: the contiguous
    split of ``shard_batch`` in the JAX package, shard ``r`` taking rows
    ``[r * n / size, (r + 1) * n / size)`` (in a process group, this
    process's shard is its rank's). Only the numpy arrays and tensors of
    ``batch`` are sharded (their leading dimensions must all be ``n``,
    divisible by ``mesh.size``); other entries are left out."""
    if isinstance(mesh, Mesh2D):  # the shards of the data axis; model ranks share theirs
        mesh = Mesh(mesh.devices, mesh.dp, mesh.data_group)
    arrays = {k: v for k, v in batch.items() if isinstance(v, (np.ndarray, torch.Tensor))}
    sizes = {v.shape[0] for v in arrays.values()}
    if len(sizes) != 1:
        raise ValueError(f"shard_batch: leading dimensions differ: {sizes}")
    n = sizes.pop()
    if n % mesh.size:
        raise ValueError(f"shard_batch: batch of {n} does not divide a mesh of {mesh.size}")
    per = n // mesh.size
    first = mesh.rank * len(mesh.devices)
    shards = []
    for i, dev in enumerate(mesh.devices):
        lo = (first + i) * per
        shard = {}
        for k, v in arrays.items():
            t = torch.from_numpy(np.ascontiguousarray(v[lo:lo + per])) if isinstance(
                v, np.ndarray) else v[lo:lo + per]
            shard[k] = t.to(dev).contiguous()
        shards.append(shard)
    return shards


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A data x model mesh over a process group, one device per process:
    ``dp`` data shards of every batch, each held by ``mp`` ranks that split
    the model (tensor parallelism). Rank ``r`` sits at ``(r // mp, r %
    mp)``, as ``create_mesh_2d`` lays the JAX package's devices out.
    ``data_group`` joins the ranks of one model index (gradients and loss
    sums), ``model_group`` the ranks of one data index (the model's
    collectives); a group of one rank is None. ``group`` is the whole
    process group (None in one process)."""

    devices: tuple[torch.device, ...]
    dp: int
    mp: int
    group: Optional[object] = None
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    axes: tuple[str, str] = ("data", "model")

    @property
    def size(self) -> int:
        return self.dp * self.mp

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def data_rank(self) -> int:
        """This rank's data shard (its row of the mesh)."""
        return self.rank // self.mp

    @property
    def model_rank(self) -> int:
        """This rank's part of the model (its column of the mesh)."""
        return self.rank % self.mp


def create_mesh_2d(dp: int, mp: int, devices: Optional[Sequence] = None,
                   axes: tuple[str, str] = ("data", "model")) -> Mesh2D:
    """A ``dp`` x ``mp`` mesh over the initialised process group, whose
    world size must be ``dp * mp`` (or over this process alone when both
    are 1 and no group is initialised). Every rank builds every subgroup
    with ``torch.distributed.new_group`` in the same order (each data
    group, then each model group), as the call requires; ``devices``
    defaults to this rank's device."""
    if dp < 1 or mp < 1:
        raise ValueError(f"create_mesh_2d: dp={dp} and mp={mp} must be >= 1")
    grouped = dist.is_available() and dist.is_initialized()
    if not grouped:
        if dp * mp != 1:
            raise ValueError(f"create_mesh_2d({dp}, {mp}) needs a process group of {dp * mp} "
                             "ranks (parallel.spawn or torchrun)")
        if devices is None:
            raise ValueError("create_mesh_2d: pass devices=[...] outside a process group")
        return Mesh2D(tuple(torch.device(d) for d in devices), 1, 1, axes=axes)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != dp * mp:
        raise ValueError(f"create_mesh_2d: {dp} x {mp} mesh in a process group of {world} ranks")
    devs = (_rank_device(),) if devices is None else tuple(torch.device(d) for d in devices)
    data_group = model_group = None
    if dp > 1:
        for j in range(mp):
            g = dist.new_group([i * mp + j for i in range(dp)])
            if rank % mp == j:
                data_group = g
    if mp > 1:
        for i in range(dp):
            g = dist.new_group([i * mp + j for j in range(mp)])
            if rank // mp == i:
                model_group = g
    return Mesh2D(devs, dp, mp, dist.group.WORLD, data_group, model_group, axes)


def layout_tp_spec(name: str) -> str:
    """How tensor parallelism splits the layout model's parameter ``name``
    (a ``state_dict`` key): ``"column"`` (the output rows of the QKV
    projection and ``linear1``, weight and bias: each model rank holds its
    heads of q, k and v and its slice of the feed-forward units), ``"row"``
    (the input columns of ``out_proj.weight`` and ``linear2.weight``,
    whose partial products are summed across the model group), or
    ``"replicated"`` (everything else, the row-parallel biases included:
    they are added once, after the sum). The counterpart of
    ``layout_tp_spec`` in the JAX package, which splits QKV's columns into
    contiguous halves where this splits by heads."""
    parts = name.split(".")
    if parts[-1] in ("in_proj_weight", "in_proj_bias") or parts[-2:-1] == ["linear1"]:
        return "column"
    if parts[-2:] in (["out_proj", "weight"], ["linear2", "weight"]):
        return "row"
    return "replicated"


def replicate_tree(module: nn.Module, mesh: Mesh) -> list[nn.Module]:
    """The model on every device of the mesh: in a process group, rank 0's
    parameters and buffers broadcast into every rank's ``module`` in place
    (after initialisation and after a resume, so that every replica starts
    equal); in one process, ``module`` on ``mesh.devices[0]`` and a copy of
    it on each other device. Returns this process's replicas in the order
    of ``mesh.devices``."""
    if mesh.group is not None:
        with torch.no_grad():
            for t in (*module.parameters(), *module.buffers()):
                dist.broadcast(t, src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
        return [module]
    first = module.to(mesh.devices[0])
    return [first] + [copy.deepcopy(first).to(d) for d in mesh.devices[1:]]


# ------------------------------------------------------------- collectives

def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced in place across ``group`` (``op`` "sum" or "max");
    the identity for ``group`` None. Returns ``t``."""
    if group is not None:
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                        group=group)
    return t


def psum(tensors: Sequence[torch.Tensor], group) -> list[torch.Tensor]:
    """Each tensor summed across ``group`` in ONE all-reduce of a flat
    bucket (all tensors of one dtype and device); returns new tensors of
    the inputs' shapes, views of the bucket. ``group`` None returns the
    inputs unchanged."""
    if group is None:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def pmean(tensors: Sequence[torch.Tensor], group) -> list[torch.Tensor]:
    """:func:`psum` divided by the group's world size."""
    if group is None:
        return list(tensors)
    world = dist.get_world_size(group)
    return [t / world for t in psum(tensors, group)]


class _PsumDifferentiable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def psum_differentiable(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed across ``group``, under autograd: the backward sums the
    cotangents across the group too, so each rank's input gets the
    gradient of the sum of every rank's loss terms. The identity for
    ``group`` None."""
    if group is None:
        return x
    return _PsumDifferentiable.apply(x, group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's input to a column-parallel product: the identity;
    backward, the gradient summed over ``group``. The identity for
    ``group`` None."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's output of a row-parallel product: ``x`` summed over
    ``group``; backward, the identity. The identity for ``group`` None."""
    return x if group is None else _ReduceFromModel.apply(x, group)
