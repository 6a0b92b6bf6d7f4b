"""Flax's default initialisers for the port's models.

flax's ``Conv``, ``ConvTranspose`` and ``Dense`` draw their kernels from
``lecun_normal``, a normal truncated at two standard deviations and
scaled so that the variance is ``1 / fan_in``, and start their biases at
zero. ``fan_in`` is the size of a kernel's input slice: ``in_channels /
groups * kh * kw`` for a convolution, the out channels times ``kh * kw``
for a transpose convolution whose kernel is transposed, as the detector's
is, and ``in_features`` for a dense layer. In each PyTorch weight that is
``weight[0].numel()``. Other parameters (the biGRU's, the layout model's
``in_proj``, the norms') keep the initialisers their modules give them,
which are flax's already.
"""

from __future__ import annotations

import math

from torch import nn

# The standard deviation of a unit normal truncated to [-2, 2].
TRUNCATED_STD = 0.87962566103423978


def flax_init_(model: nn.Module) -> nn.Module:
    """Re-initialise every ``Conv2d``, ``ConvTranspose2d`` and ``Linear``
    of ``model`` in place from the global torch generator; returns it."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            std = math.sqrt(1.0 / m.weight[0].numel()) / TRUNCATED_STD
            nn.init.trunc_normal_(m.weight, std=std, a=-2.0 * std, b=2.0 * std)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return model
