"""Recognition stage 1: conv 3x3 (1 -> 32, pad 1) + bias, ReLU, 2x2 max-pool.

Counterpart of the forward of ``stage1_fused``
(``ocrs_models_tpu/ops/pallas/stage1_kernel.py``). On a CUDA tensor
:func:`stage1` launches the hand-written kernel ``csrc/stage1_fwd.cu``; on
a CPU tensor it runs :func:`stage1_reference`, the same function in plain
PyTorch ops. Layout is NCHW in and out.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

CHANNELS = 32


def stage1_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version: ``max_pool2d(relu(conv2d(x, weight, bias, padding=1)), 2)``."""
    return F.max_pool2d(F.relu(F.conv2d(x, weight, bias, padding=1)), 2)


def _lib() -> ctypes.CDLL:
    lib = _build.load("stage1_fwd")
    fn = lib.ocrs_stage1_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [i, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def stage1(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Fused conv(1->32, 3x3, pad 1) + bias + ReLU + 2x2/2 max-pool.

    :param x: ``[N, 1, H, W]`` float32.
    :param weight: ``[32, 1, 3, 3]`` float32 (torch Conv2d layout).
    :param bias: ``[32]`` float32.
    :return: ``[N, 32, H // 2, W // 2]`` float32, NCHW.
    """
    if x.device.type == "cpu":
        return stage1_reference(x, weight, bias)
    if not x.is_cuda:
        raise RuntimeError(f"stage1: unsupported device {x.device}")
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"stage1: {name} must be float32 on {x.device}")
    if torch.is_grad_enabled() and (weight.requires_grad or bias.requires_grad):
        raise NotImplementedError("stage1: the backward kernel is not ported yet (ROADMAP.md)")
    if x.dim() != 4 or x.shape[1] != 1 or not x.is_contiguous():
        raise ValueError(f"stage1: x must be contiguous [N, 1, H, W], got {tuple(x.shape)}")
    if weight.shape != (CHANNELS, 1, 3, 3) or bias.shape != (CHANNELS,):
        raise ValueError("stage1: weight must be [32, 1, 3, 3] and bias [32]")
    n, _, h, w = x.shape
    y = torch.empty((n, CHANNELS, h // 2, w // 2), device=x.device, dtype=torch.float32)
    w10 = torch.cat([weight.reshape(CHANNELS, 9), bias.reshape(CHANNELS, 1)], 1).contiguous()
    lib = _lib()
    rc = lib.ocrs_stage1_fwd(
        x.device.index, _build.ptr(x), _build.ptr(w10), _build.ptr(y), n, h, w,
        _build.stream_ptr(x.device),
    )
    _build.check(lib, rc, "stage1_fwd")
    stage1.launches += 1
    return y


stage1.launches = 0
