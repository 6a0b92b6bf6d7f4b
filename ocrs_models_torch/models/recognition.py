"""CRNN text recognition model, NCHW inside.

Counterpart of ``ocrs_models_tpu/models/recognition.py``
(``RecognitionModel``): a 64-high greyscale line ``[N, 1, 64, W]`` in,
per-step log-probabilities ``[N, W//4 + 1, n_classes]`` out (batch-major,
the JAX package's layout; class 0 is the CTC blank). The conv stack
downsamples width by 4 and height to 1 (the final 2x2, pad-1 conv adds a
column), then a 2-layer biGRU and a linear + log-softmax head.

Stage 1 runs through :func:`ocrs_models_torch.ops.stage1` and the
recurrence through :class:`ocrs_models_torch.ops.BiGRU`, the two
hand-written kernels on a CUDA device. ``self.conv`` keeps the
reference's ``nn.Sequential`` indices, so its state-dict keys (``conv.0``,
``conv.3``, ``conv.4``, ... ``conv.20``, ``gru.*``, ``output.0``) load
unchanged; ``forward`` walks it by index and pools before the ReLU in
stages 2-4 (equal, since max-pool commutes with the monotone ReLU, and the
ReLU then touches 4x fewer values).

``dtype=torch.bfloat16`` is the JAX package's bf16 path: the image is cast
to bf16 on entry, stage 1 runs its bf16 kernel, convolutions 2-5 and the
output layer run in bf16 (cuDNN's and cuBLAS's rounding points, which may
differ from XLA's by one bf16 rounding), batch norm is
:func:`~ocrs_models_torch.models.detection.batch_norm_lite`, and the
log-softmax is float32. ``gru_dtype`` is the biGRU's compute dtype (None
follows ``dtype``). Parameters and batch-norm statistics stay float32, and
the state-dict keys are the same in both dtypes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import DTYPES, BiGRU, stage1
from .detection import batch_norm
from .init import flax_init_


class RecognitionModel(nn.Module):
    def __init__(self, n_classes: int, gru_hidden: int = 256, gru_layers: int = 2,
                 dtype: torch.dtype = torch.float32, gru_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if dtype not in DTYPES:
            raise ValueError(f"RecognitionModel: dtype must be float32 or bfloat16, got {dtype}")
        self.dtype = dtype
        self.conv = nn.Sequential(
            nn.Conv2d(1, 32, 3, padding=1),                   # 0
            nn.ReLU(),                                        # 1
            nn.MaxPool2d(2),                                  # 2
            nn.Conv2d(32, 64, 3, padding=1, bias=False),      # 3
            nn.BatchNorm2d(64),                               # 4
            nn.ReLU(),                                        # 5
            nn.MaxPool2d(2),                                  # 6
            nn.Conv2d(64, 128, 3, padding=1),                 # 7
            nn.ReLU(),                                        # 8
            nn.Conv2d(128, 128, 3, padding=1, bias=False),    # 9
            nn.BatchNorm2d(128),                              # 10
            nn.ReLU(),                                        # 11
            nn.MaxPool2d((2, 1)),                             # 12
            nn.Conv2d(128, 128, 3, padding=1),                # 13
            nn.ReLU(),                                        # 14
            nn.Conv2d(128, 128, 3, padding=1, bias=False),    # 15
            nn.BatchNorm2d(128),                              # 16
            nn.ReLU(),                                        # 17
            nn.MaxPool2d((2, 1)),                             # 18
            nn.Conv2d(128, 128, 2, padding=1, bias=False),    # 19
            nn.BatchNorm2d(128),                              # 20
            nn.AvgPool2d((4, 1)),                             # 21
        )
        self.gru = BiGRU(128, gru_hidden, gru_layers,
                         compute_dtype=dtype if gru_dtype is None else gru_dtype)
        self.output = nn.Sequential(nn.Linear(2 * gru_hidden, n_classes))
        flax_init_(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """:param x: ``[N, 1, 64, W]`` float32 in [-0.5, 0.5].
        :return: ``[N, W//4 + 1, n_classes]`` float32 log-probabilities."""
        c = self.conv

        def conv(i, x):  # weights in x's dtype (a no-op in float32)
            m = c[i]
            bias = None if m.bias is None else m.bias.to(x.dtype)
            return F.conv2d(x, m.weight.to(x.dtype), bias, padding=m.padding)

        def bn(i, x):
            return batch_norm(c[i], x)

        if self.dtype == torch.bfloat16:
            x = x.to(self.dtype)
        # Stage 1: 64 x W -> 32 x W/2 (fused kernel on CUDA).
        x = stage1(x.contiguous(), c[0].weight, c[0].bias)
        # Stage 2: -> 16 x W/4; pool before ReLU.
        x = F.relu(F.max_pool2d(bn(4, conv(3, x)), 2))
        # Stage 3: -> 8 x W/4
        x = F.relu(conv(7, x))
        x = F.relu(F.max_pool2d(bn(10, conv(9, x)), (2, 1)))
        # Stage 4: -> 4 x W/4
        x = F.relu(conv(13, x))
        x = F.relu(F.max_pool2d(bn(16, conv(15, x)), (2, 1)))
        # Stage 5: 2x2 conv, pad 1 -> 5 x (W/4 + 1); average over height 4.
        x = F.avg_pool2d(bn(20, conv(19, x)), (4, 1))  # [N, 128, 1, T]
        n, ch, h, t = x.shape
        x = x.permute(0, 3, 1, 2).reshape(n, t, ch * h)  # channel-major features
        dt = x.dtype
        x = self.gru(x).to(dt)
        out = self.output[0]
        x = F.linear(x, out.weight.to(dt), out.bias.to(dt))
        return F.log_softmax(x.float(), dim=-1)
