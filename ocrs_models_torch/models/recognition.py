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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import BiGRU, stage1


class RecognitionModel(nn.Module):
    def __init__(self, n_classes: int, gru_hidden: int = 256, gru_layers: int = 2):
        super().__init__()
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
        self.gru = BiGRU(128, gru_hidden, gru_layers)
        self.output = nn.Sequential(nn.Linear(2 * gru_hidden, n_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """:param x: ``[N, 1, 64, W]`` float32 in [-0.5, 0.5].
        :return: ``[N, W//4 + 1, n_classes]`` float32 log-probabilities."""
        c = self.conv
        # Stage 1: 64 x W -> 32 x W/2 (fused kernel on CUDA).
        x = stage1(x.contiguous(), c[0].weight, c[0].bias)
        # Stage 2: -> 16 x W/4; pool before ReLU.
        x = F.relu(F.max_pool2d(c[4](c[3](x)), 2))
        # Stage 3: -> 8 x W/4
        x = F.relu(c[7](x))
        x = F.relu(F.max_pool2d(c[10](c[9](x)), (2, 1)))
        # Stage 4: -> 4 x W/4
        x = F.relu(c[13](x))
        x = F.relu(F.max_pool2d(c[16](c[15](x)), (2, 1)))
        # Stage 5: 2x2 conv, pad 1 -> 5 x (W/4 + 1); average over height 4.
        x = F.avg_pool2d(c[20](c[19](x)), (4, 1))  # [N, 128, 1, T]
        n, ch, h, t = x.shape
        x = x.permute(0, 3, 1, 2).reshape(n, t, ch * h)  # channel-major features
        x = self.gru(x)
        return F.log_softmax(self.output(x).float(), dim=-1)
