"""Tensor parallelism of the layout transformer over a data x model mesh
(the port's counterpart of the JAX package's ``layout_tp_state_shardings``
and ``shard_tree``, ``ocrs_models_tpu/parallel/mesh.py``).

Megatron's split of each encoder layer across the ``mp`` ranks of a model
group (``parallel.mesh.layout_tp_spec``):

- column-parallel QKV projection, split by heads: each rank holds
  ``n_heads / mp`` heads of q, k and v, so attention runs on the rank's
  own heads with no collective;
- row-parallel ``out_proj``: each rank's context slice times its columns
  of the weight gives a partial product; the sum over the model group is
  the product, and the bias is added once, after it;
- column-parallel ``linear1`` (its slice of the ``d_ff`` units, bias
  included), row-parallel ``linear2`` the same way.

``models.layout.EncoderLayer`` runs its part given the model group: two
autograd functions (``parallel.mesh``) carry the collectives. Before each
column-parallel product the input passes through ``copy_to_model``
(identity forward, gradient summed over the model group backward), after
each row-parallel product through ``reduce_from_model`` (sum forward,
identity backward). Everything else (embedding, LayerNorms, the row-parallel
biases, ``classify``) is replicated in the model group and gets the full
gradient on every rank.

Dropout: each rank draws the full-size mask from the step's generator and
keeps its own slice where the activation is split, so ranks of one model
group, given generators seeded alike, drop the same replicated units, and
the sharded step drops what the unsharded step drops from that generator.

Adam's moments are per parameter, so they are sharded with their
parameters; :func:`tp_grad_norms` counts each shard once and each
replicated parameter once. :func:`gather_layout_state` puts the full
``state_dict`` back together for checkpoints and export.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from .mesh import Mesh2D, layout_tp_spec


def _split(name: str, full: torch.Tensor, rank: int, mp: int) -> torch.Tensor:
    """This rank's shard of the full parameter ``name``."""
    spec = layout_tp_spec(name)
    if spec == "replicated":
        return full
    if spec == "row":
        cols = full.shape[1] // mp
        return full[:, rank * cols:(rank + 1) * cols]
    if name.endswith(("in_proj_weight", "in_proj_bias")):  # q, k, v blocks, by heads
        d = full.shape[0] // 3
        rows = d // mp
        return torch.cat([full[p * d + rank * rows:p * d + (rank + 1) * rows]
                          for p in range(3)])
    rows = full.shape[0] // mp
    return full[rank * rows:(rank + 1) * rows]


def _join(name: str, shards: list[torch.Tensor]) -> torch.Tensor:
    """The full parameter ``name`` from its shards, in model-rank order."""
    spec = layout_tp_spec(name)
    if spec == "row":
        return torch.cat(shards, dim=1)
    if name.endswith(("in_proj_weight", "in_proj_bias")):
        return torch.cat([torch.cat([s.chunk(3)[p] for s in shards]) for p in range(3)])
    return torch.cat(shards)


def _layers(model: nn.Module):
    return list(model.encode.layers)


def shard_layout_model(model: nn.Module, mesh: Mesh2D) -> nn.Module:
    """Split ``model`` (a ``LayoutModel`` holding the full weights, equal
    on every rank: ``replicate_tree`` first) across ``mesh``'s model group
    in place: each column- and row-parallel parameter is replaced by this
    rank's shard, and each encoder layer is given the model group, so it
    runs its part (``models.layout.EncoderLayer``). Build the train
    state after this. Returns ``model``."""
    mp = mesh.mp
    for layer in _layers(model):
        if layer.n_heads % mp or layer.linear1.out_features % mp:
            raise ValueError(f"tensor parallelism over {mp} ranks needs n_heads "
                             f"({layer.n_heads}) and d_ff ({layer.linear1.out_features}) "
                             f"divisible by {mp}")
    if mp == 1:
        return model
    rank = mesh.model_rank
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            if layout_tp_spec(name) == "replicated":
                continue
            owner = model.get_submodule(name.rsplit(".", 1)[0])
            attr = name.rsplit(".", 1)[1]
            setattr(owner, attr, nn.Parameter(_split(name, p.data, rank, mp).clone()))
    for layer in _layers(model):
        layer.tp_group, layer.tp_rank, layer.tp_size = mesh.model_group, rank, mp
    return model


def is_sharded(model: nn.Module) -> bool:
    return any(layer.tp_size > 1 for layer in _layers(model))


def tp_grad_norms(model: nn.Module, names: dict, group) -> tuple[torch.Tensor, dict]:
    """The global gradient norm and each module's (``names``: parameter ->
    module), with every sharded parameter's squares summed over the model
    ``group`` and every replicated parameter counted once: the norms of the
    unsharded model's gradients."""
    split = ({n for n, _ in model.named_parameters() if layout_tp_spec(n) != "replicated"}
             if is_sharded(model) else set())
    sq = {}
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        sq[name] = torch.sum(g.float() * g.float())
    keys = sorted(split)
    if keys and group is not None:
        flat = torch.stack([sq[k] for k in keys])
        dist.all_reduce(flat, group=group)
        for k, v in zip(keys, flat):
            sq[k] = v
    modules: dict[str, torch.Tensor] = {}
    for name, v in sq.items():
        modules[names[name]] = modules.get(names[name], 0.0) + v
    total = sum(modules.values())
    return torch.sqrt(total), {k: torch.sqrt(v) for k, v in modules.items()}


def gather_layout_state(model: nn.Module, mesh: Mesh2D, tensors: Optional[dict] = None) -> dict:
    """The full ``state_dict`` of a sharded layout model (every rank of a
    model group gets it; keys and shapes those of the unsharded model), on
    the CPU, for checkpoints and export. ``tensors``: tensors keyed and
    sharded like the parameters (their gradients, say) to gather instead."""
    out = {}
    for name, t in (model.state_dict() if tensors is None else tensors).items():
        t = t.detach()
        if mesh.mp > 1 and is_sharded(model) and layout_tp_spec(name) != "replicated":
            shards = [torch.empty_like(t) for _ in range(mesh.mp)]
            dist.all_gather(shards, t.contiguous(), group=mesh.model_group)
            t = _join(name, shards)
        out[name] = t.cpu().clone()
    return out
