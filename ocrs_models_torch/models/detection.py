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
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

DEPTH_SCALE = (8, 16, 32, 32, 64, 128, 256)


class DepthwiseConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.seq = nn.Sequential(
            nn.Conv2d(cin, cin, 3, padding=1, groups=cin, bias=False),
            nn.Conv2d(cin, cout, 1, bias=False),
            nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1),
            nn.ReLU(),
        )

    def forward(self, x):
        return self.seq(x)


class DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.seq = nn.Sequential(DepthwiseConv(cin, cout), DepthwiseConv(cout, cout))

    def forward(self, x):
        return self.seq(x)


class Down(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.seq = nn.Sequential(DoubleConv(cin, cout), nn.MaxPool2d(2))

    def forward(self, x):
        return self.seq(x)


class Up(nn.Module):
    """Transpose conv (3x3, stride 2, no padding) -> trim to the skip's
    size -> concat with the skip -> DoubleConv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=0)
        self.contract = DoubleConv(2 * cout, cout)

    def forward(self, x_up, x_skip):
        up = self.up(x_up)[:, :, : x_skip.shape[2], : x_skip.shape[3]]
        return self.contract(torch.cat([up, x_skip], dim=1))


class DetectionModel(nn.Module):
    def __init__(self, depth_scale: Sequence[int] = DEPTH_SCALE, in_channels: int = 1):
        super().__init__()
        ds = tuple(depth_scale)
        self.in_conv = DoubleConv(in_channels, ds[0])
        self.down = nn.ModuleList(Down(ds[i], ds[i + 1]) for i in range(len(ds) - 1))
        self.up = nn.ModuleList(Up(ds[i + 1], ds[i]) for i in range(len(ds) - 1))
        self.out_conv = nn.Sequential(nn.Conv2d(ds[0], 1, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """:param x: ``[N, 1, H, W]``. :return: ``[N, 1, H, W]`` probabilities."""
        x = self.in_conv(x)
        skips = [x]
        for down in self.down:
            x = down(x)
            skips.append(x)
        out = skips[-1]
        for i in reversed(range(len(self.up))):
            out = self.up[i](out, skips[i])
        return self.out_conv(out)
