"""U-Net text detection model, NCHW throughout.

Counterpart of ``ocrs_models_tpu/models/detection.py`` (``DetectionModel``):
greyscale page ``[N, 1, H, W]`` in [-0.5, 0.5] in, per-pixel text
probability ``[N, 1, H, W]`` out. Every block is a depthwise-separable
conv (depthwise 3x3, pointwise 1x1, batch norm, ReLU) with channels
(8, 16, 32, 32, 64, 128, 256); pooling floors odd sizes; each up step is a
stride-2 transpose conv trimmed to its skip's size, then a concat. Module
names give the reference's state-dict keys (``in_conv.seq.0.seq.0.weight``,
``down.{i}.seq.0...``, ``up.{i}.up``, ``up.{i}.contract``,
``out_conv.0``), so reference checkpoints load with ``strict=True``.

``DetectionModel(dtype=torch.bfloat16)`` is the JAX package's bf16 path:
the page is cast to bf16 on entry, the convolutions run in bf16 (cuDNN's
rounding points, which may differ from XLA's by one bf16 rounding), batch
norm is :func:`batch_norm_lite`, and ``out_conv`` and the sigmoid run in
float32. Parameters and batch-norm statistics stay float32. The blocks
take the dtype of what comes in.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import DTYPES
from ..parallel.mesh import psum_differentiable
from .init import flax_init_

DEPTH_SCALE = (8, 16, 32, 32, 64, 128, 256)


def batch_norm_lite(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """``BatchNormLite`` (``ocrs_models_tpu/models/detection.py``) on a
    bf16 ``x [N, C, H, W]`` with ``bn``'s parameters and buffers: float32
    statistics of the bf16 activations (``E[x^2] - E[x]^2``), in training
    the running statistics updated with ``bn.momentum`` and the unbiased
    variance as ``nn.BatchNorm2d`` does, the scale and shift folded in
    float32 and applied as ``x * inv + shift`` in ``x``'s dtype."""
    if bn.training:
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = (xf * xf).mean(dim=(0, 2, 3)) - mean * mean
        count = x.numel() // x.shape[1]
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.mul_(1 - m).add_(m * mean)
            bn.running_var.mul_(1 - m).add_(m * var * (count / max(count - 1, 1)))
            bn.num_batches_tracked += 1
    else:
        mean, var = bn.running_mean, bn.running_var
    inv = torch.rsqrt(var + bn.eps) * bn.weight
    shift = bn.bias - mean * inv
    return x * inv.to(x.dtype)[None, :, None, None] + shift.to(x.dtype)[None, :, None, None]


def batch_norm_global(bn: nn.BatchNorm2d, x: torch.Tensor, group) -> torch.Tensor:
    """``BatchNormLite`` in training over a batch whose slices ``x [n, C,
    H, W]`` lie on the ranks of ``group``, in either dtype: the per-channel
    float32 ``[sum x, sum x^2, count]`` of every rank added by
    :func:`psum_differentiable` (whose backward carries ``sum dy`` and
    ``sum dy * x`` across the ranks), the global mean and the one-pass
    variance ``E[x^2] - E[x]^2``, the running statistics updated as
    :func:`batch_norm_lite` does with the global count, and ``x * inv +
    shift`` in ``x``'s dtype. Every rank normalises with the statistics of
    the whole batch, as GSPMD does over a sharded batch."""
    xf = x.float()
    local = torch.stack([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                         xf.new_full((x.shape[1],), float(x.numel() // x.shape[1]))])
    sums = psum_differentiable(local, group)
    count = sums[2].detach()
    mean = sums[0] / count
    var = sums[1] / count - mean * mean
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(m * mean)
        bn.running_var.mul_(1 - m).add_(m * var * (count / torch.clamp(count - 1, min=1)))
        bn.num_batches_tracked += 1
    inv = torch.rsqrt(var + bn.eps) * bn.weight
    shift = bn.bias - mean * inv
    return x * inv.to(x.dtype)[None, :, None, None] + shift.to(x.dtype)[None, :, None, None]


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """:func:`batch_norm_lite` on a bf16 ``x``, ``bn`` itself on any other;
    in training over a process-group ``mesh`` (``parallel.Mesh``),
    :func:`batch_norm_global`."""
    if mesh is not None and mesh.group is not None and bn.training:
        return batch_norm_global(bn, x, mesh.group)
    return batch_norm_lite(bn, x) if x.dtype == torch.bfloat16 else bn(x)


class DepthwiseConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.seq = nn.Sequential(
            nn.Conv2d(cin, cin, 3, padding=1, groups=cin, bias=False),
            nn.Conv2d(cin, cout, 1, bias=False),
            nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1),
            nn.ReLU(),
        )

    def forward(self, x, mesh=None):
        dw, pw, bn, _ = self.seq
        x = F.conv2d(x, dw.weight.to(x.dtype), padding=1, groups=dw.groups)
        return F.relu(batch_norm(bn, F.conv2d(x, pw.weight.to(x.dtype)), mesh))


class DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.seq = nn.Sequential(DepthwiseConv(cin, cout), DepthwiseConv(cout, cout))

    def forward(self, x, mesh=None):
        return self.seq[1](self.seq[0](x, mesh), mesh)


class Down(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.seq = nn.Sequential(DoubleConv(cin, cout), nn.MaxPool2d(2))

    def forward(self, x, mesh=None):
        return self.seq[1](self.seq[0](x, mesh))


class Up(nn.Module):
    """Transpose conv (3x3, stride 2, no padding) -> trim to the skip's
    size -> concat with the skip -> DoubleConv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=0)
        self.contract = DoubleConv(2 * cout, cout)

    def forward(self, x_up, x_skip, mesh=None):
        dt = x_up.dtype
        up = F.conv_transpose2d(x_up, self.up.weight.to(dt), self.up.bias.to(dt), stride=2)
        up = up[:, :, : x_skip.shape[2], : x_skip.shape[3]]
        return self.contract(torch.cat([up, x_skip], dim=1), mesh)


class DetectionModel(nn.Module):
    def __init__(self, depth_scale: Sequence[int] = DEPTH_SCALE, in_channels: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in DTYPES:
            raise ValueError(f"DetectionModel: dtype must be float32 or bfloat16, got {dtype}")
        self.dtype = dtype
        ds = tuple(depth_scale)
        self.in_conv = DoubleConv(in_channels, ds[0])
        self.down = nn.ModuleList(Down(ds[i], ds[i + 1]) for i in range(len(ds) - 1))
        self.up = nn.ModuleList(Up(ds[i + 1], ds[i]) for i in range(len(ds) - 1))
        self.out_conv = nn.Sequential(nn.Conv2d(ds[0], 1, 1), nn.Sigmoid())
        flax_init_(self)

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        """:param x: ``[N, 1, H, W]``. :param mesh: in training, a
        process-group ``parallel.Mesh`` whose ranks each hold a slice of the
        batch: batch norm then takes the statistics of the whole batch
        (:func:`batch_norm_global`). :return: ``[N, 1, H, W]`` float32
        probabilities."""
        if self.dtype == torch.bfloat16:
            x = x.to(self.dtype)
        x = self.in_conv(x, mesh)
        skips = [x]
        for down in self.down:
            x = down(x, mesh)
            skips.append(x)
        out = skips[-1]
        for i in reversed(range(len(self.up))):
            out = self.up[i](out, skips[i], mesh)
        return self.out_conv(out.to(self.out_conv[0].weight.dtype))  # float32 in bf16
