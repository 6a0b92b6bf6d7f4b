"""Transformer text-layout model.

Counterpart of ``ocrs_models_tpu/models/layout.py`` (``LayoutModel``):
word boxes ``[N, W, 4]`` in, per-word (line_start, line_end) logits or
probabilities ``[N, W, 2]`` out. A 6-layer post-LN transformer encoder
(d_model 256, 4 heads, FF 1024, ReLU) over sinusoidal encodings of the
rounded coordinates, or over a 2-layer MLP embedding (``pos_embedding="mlp"``).

As in the JAX package, attention runs over the words of each page
(batch-first), which the reference's seq-first encoder does not, and there
is no padding mask: zero boxes that pad a page to its word count attend and
are attended like any other word.

The state-dict keys are the reference's (``encode.layers.{i}.self_attn.
in_proj_weight``, ``...self_attn.out_proj``, ``linear1``, ``linear2``,
``norm1``, ``norm2``, ``classify``, ``embed.0`` / ``embed.2``), so the JAX
package's ``export_layout_state_dict`` and the reference's checkpoints load
with ``strict=True``.

The encoder is written as explicit products (not ``nn.TransformerEncoderLayer``,
whose inference fast path fuses them) so that ``dtype=torch.bfloat16`` keeps
the JAX package's rounding points: the residual stream, both LayerNorms
(eps 1e-5), the softmax, the sinusoids and ``classify`` are float32; the
QKV, ``out_proj``, ``linear1`` and ``linear2`` products take bf16 operands
and round their product, then their bias sum, to bf16 (flax's ``Dense``);
the attention scores are bf16 products summed in float32 and divided by
sqrt(dh) in float32; the softmax is rounded to bf16 for the context product.
Parameters stay float32 in both dtypes.

Dropout draws from an explicit ``torch.Generator`` passed to ``forward``.
Every layer drops at 0.1 whatever ``LayoutModel.dropout`` says: the JAX
model never hands its field to its layers (``layout.py:124-130``), and the
port follows that code.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import copy_to_model, reduce_from_model
from .init import flax_init_

DTYPES = (torch.float32, torch.bfloat16)


def sinusoidal_bbox_encoding(boxes: torch.Tensor, size: int) -> torch.Tensor:
    """Interleave sin and cos of each rounded coordinate (half to even).

    :param boxes: ``[N, W, D]`` coordinates.
    :param size: encoding dims per coordinate (even).
    :return: ``[N, W, D * size]`` float32.
    """
    depth = size // 2
    coords = torch.round(boxes).float()[..., None]  # [N, W, D, 1]
    exponents = torch.arange(depth, dtype=torch.float32, device=boxes.device) / depth
    rates = 1.0 / torch.pow(10_000.0, exponents)
    angles = coords * rates  # [N, W, D, depth]
    enc = torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
    n, w, d, s = enc.shape
    return enc.reshape(n, w, d * s)


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: operands cast to ``dtype``, the product
    rounded to ``dtype``, then the bias added in ``dtype``."""
    return torch.matmul(x.to(dtype), layer.weight.to(dtype).t()) + layer.bias.to(dtype)


class Dropout(nn.Module):
    """flax ``Dropout``: keep with probability ``1 - p`` and divide the kept
    values by it, drawing from the generator given to ``forward``. Active
    in training mode only."""

    def __init__(self, p: float = 0.1):
        super().__init__()
        self.p = p

    def extra_repr(self) -> str:
        return f"p={self.p}"

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                part: tuple[int, int] = (0, 1)) -> torch.Tensor:
        """``part`` ``(i, parts)``: ``x`` is slice ``i`` of ``parts`` equal
        slices of an activation along its last axis; the mask is drawn for
        the whole activation and sliced alike."""
        if not self.training or self.p == 0.0:
            return x
        keep_prob = 1.0 - self.p
        i, parts = part
        width = x.shape[-1]
        keep = torch.rand((*x.shape[:-1], width * parts), generator=generator,
                          device=x.device) < keep_prob
        keep = keep[..., i * width:(i + 1) * width]
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class SelfAttention(nn.Module):
    """The QKV and output projections under the keys of torch's
    ``nn.MultiheadAttention`` (``in_proj_weight`` ``[3d, d]``: q, k, v rows)."""

    def __init__(self, d_model: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)


class EncoderLayer(nn.Module):
    """Post-LN encoder layer: self-attention -> add & norm -> FF (ReLU) ->
    add & norm, with dropout after ``out_proj``, after the ReLU and after
    ``linear2``.

    Under tensor parallelism (``parallel.tp.shard_layout_model``) the layer
    holds ``n_heads / tp_size`` heads of q, k and v and ``d_ff / tp_size``
    FF units, and ``tp_group`` (its model group) sums the partial products
    of ``out_proj`` and ``linear2`` before their biases; the defaults (no
    group, one part) are the whole layer."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_heads = n_heads
        self.dtype = dtype
        self.self_attn = SelfAttention(d_model)
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = Dropout(dropout)  # applied three times, each a fresh draw
        self.tp_group, self.tp_rank, self.tp_size = None, 0, 1

    def _row_dense(self, x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
        """``dense`` of a row-parallel layer: the partial products summed
        over the model group, then the bias."""
        product = torch.matmul(x.to(self.dtype), layer.weight.to(self.dtype).t())
        return reduce_from_model(product, self.tp_group) + layer.bias.to(self.dtype)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """:param x: ``[N, W, d]`` float32 (the residual stream)."""
        n, w, d = x.shape
        dt, group = self.dtype, self.tp_group
        h, dh = self.n_heads // self.tp_size, d // self.n_heads
        attn = self.self_attn
        xin = copy_to_model(x, group).to(dt)
        qkv = torch.matmul(xin, attn.in_proj_weight.to(dt).t()) + attn.in_proj_bias.to(dt)
        q, k, v = (t.reshape(n, w, h, dh).transpose(1, 2) for t in qkv.split(h * dh, dim=-1))
        # bf16 products are exact in float32, so the f32 product is the
        # f32-accumulated bf16 product.
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(dh)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.matmul(probs.to(dt), v).transpose(1, 2).reshape(n, w, h * dh)
        ctx = self.dropout(self._row_dense(ctx, attn.out_proj), generator)
        x = F.layer_norm(x + ctx.float(), (d,), self.norm1.weight, self.norm1.bias, 1e-5)
        ff = F.relu(dense(copy_to_model(x, group), self.linear1, dt))
        ff = self.dropout(ff, generator, (self.tp_rank, self.tp_size))
        ff = self.dropout(self._row_dense(ff, self.linear2), generator)
        return F.layer_norm(x + ff.float(), (d,), self.norm2.weight, self.norm2.bias, 1e-5)


class Encoder(nn.Module):
    def __init__(self, layers: list[EncoderLayer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class LayoutModel(nn.Module):
    """Word-box sequence -> per-word (line_start, line_end) predictions."""

    def __init__(
        self,
        n_classes: int = 2,
        d_model: int = 256,
        n_layers: int = 6,
        n_heads: int = 4,
        d_ff: int = 1024,
        pos_embedding: str = "sin",
        return_probs: bool = False,
        dropout: float = 0.1,
        dtype: torch.dtype = torch.float32,
        n_features: int = 4,
    ):
        super().__init__()
        if dtype not in DTYPES:
            raise ValueError(f"LayoutModel: dtype must be float32 or bfloat16, got {dtype}")
        if pos_embedding not in ("sin", "mlp"):
            raise ValueError(f"Unknown pos_embedding {pos_embedding!r}")
        self.d_model = d_model
        self.pos_embedding = pos_embedding
        self.return_probs = return_probs
        self.dropout = dropout  # kept for the JAX signature; the layers drop at 0.1
        self.dtype = dtype
        if pos_embedding == "mlp":
            self.embed = nn.Sequential(
                nn.Linear(n_features, 64), nn.ReLU(), nn.Linear(64, d_model), nn.ReLU()
            )
        self.encode = Encoder(
            [EncoderLayer(d_model, n_heads, d_ff, dtype=dtype) for _ in range(n_layers)]
        )
        self.classify = nn.Linear(d_model, n_classes)
        flax_init_(self)

    def forward(self, boxes: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """:param boxes: ``[N, W, 4]`` float word boxes (left, top, right,
        bottom). :param generator: dropout's random stream (training mode).
        :return: ``[N, W, n_classes]`` float32 logits, or probabilities
        with ``return_probs``."""
        if self.pos_embedding == "sin":
            x = sinusoidal_bbox_encoding(boxes, self.d_model // boxes.shape[-1])
        else:
            x = F.relu(dense(boxes, self.embed[0], self.dtype))
            x = F.relu(dense(x, self.embed[2], self.dtype))
        x = x.float()
        for layer in self.encode.layers:
            x = layer(x, generator)
        x = dense(x, self.classify, torch.float32)
        return torch.sigmoid(x) if self.return_probs else x
