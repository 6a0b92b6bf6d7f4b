"""Recognition stage 1: conv 3x3 (1 -> 32, pad 1) + bias, ReLU, 2x2 max-pool.

Counterpart of ``stage1_fused`` (``ocrs_models_tpu/ops/pallas/stage1_kernel.py``)
and its custom VJP. :func:`stage1` is differentiable through
:class:`Stage1Function`: the forward runs :func:`stage1_fwd`
(``csrc/stage1_fwd.cu``), the backward :func:`stage1_bwd`
(``csrc/stage1_bwd.cu``), which gives the weight and bias gradients only;
the image gradient, which training never asks for, comes from autograd of
:func:`stage1_reference`, as the JAX package takes it from its XLA
reference. On CPU tensors both wrappers run their plain versions. Layout is
NCHW in and out.

The dtype of ``x`` is the compute dtype, as ``stage1_fused(..., dt)``'s:
float32, or bfloat16 with the Pallas kernel's rounding points (``x``, the
taps and the bias rounded to bf16, products summed in f32, ReLU and max in
f32, the pooled output rounded once to bf16; the backward rounds nothing
more, and its ``dW``, ``db`` are f32). Weights stay float32 either way.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

CHANNELS = 32


def stage1_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version: ``max_pool2d(relu(conv2d(x, weight, bias, padding=1)), 2)``;
    for a bf16 ``x``, in f32 from the bf16-rounded weight and bias, the
    result rounded to bf16."""
    if x.dtype == torch.bfloat16:
        y = stage1_reference(x.float(), _build.rounded(weight, x.dtype),
                             _build.rounded(bias, x.dtype))
        return y.to(torch.bfloat16)
    return F.max_pool2d(F.relu(F.conv2d(x, weight, bias, padding=1)), 2)


def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load("stage1_fwd")
    if lib.ocrs_stage1_fwd.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        for sfx in _build.SUFFIX.values():
            fn = getattr(lib, f"ocrs_stage1_fwd{sfx}")
            fn.argtypes = [i, p, p, p, p, i, i, i, p]
            fn.restype = ctypes.c_int
    return lib


def _check(name: str, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dtype not in _build.DTYPES:
        raise ValueError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    for key, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous float32 on {x.device}")
    if x.dim() != 4 or x.shape[1] != 1 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous [N, 1, H, W], got {tuple(x.shape)}")
    if weight.shape != (CHANNELS, 1, 3, 3) or bias.shape != (CHANNELS,):
        raise ValueError(f"{name}: weight must be [32, 1, 3, 3] and bias [32]")


def stage1_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Forward kernel: conv(1->32, 3x3, pad 1) + bias + ReLU + 2x2/2 max-pool.

    :param x: ``[N, 1, H, W]`` float32 or bfloat16 (the compute dtype).
    :param weight: ``[32, 1, 3, 3]`` float32 (torch Conv2d layout).
    :param bias: ``[32]`` float32.
    :return: ``[N, 32, H // 2, W // 2]`` in ``x``'s dtype, NCHW.
    """
    if x.device.type == "cpu":
        return stage1_reference(x, weight, bias)
    if not x.is_cuda:
        raise RuntimeError(f"stage1_fwd: unsupported device {x.device}")
    _check("stage1_fwd", x, weight, bias)
    n, _, h, w = x.shape
    y = torch.empty((n, CHANNELS, h // 2, w // 2), device=x.device, dtype=x.dtype)
    lib = _fwd_lib()
    p = _build.ptr
    rc = getattr(lib, f"ocrs_stage1_fwd{_build.SUFFIX[x.dtype]}")(
        x.device.index, p(x), p(weight), p(bias), p(y), n, h, w, _build.stream_ptr(x.device),
    )
    _build.check(lib, rc, "stage1_fwd")
    stage1_fwd.launches += 1
    return y


stage1_fwd.launches = 0


def stage1_bwd_reference(x, weight, bias, dy):
    """Plain version of the backward: ``(dweight [32, 1, 3, 3], dbias [32])``
    float32 by autograd of :func:`stage1_reference` (max-pool routes ``dy``
    to the first maximum of each window, ReLU passes it where the
    pre-activation is > 0). For a bf16 ``x`` (and ``dy``), by autograd of
    the f32 forward on the bf16-rounded weight and bias: the products
    ``dy * patch`` are then exact, as the Pallas kernel's bf16 dot takes
    them, and the sums f32."""
    if x.dtype == torch.bfloat16:
        return stage1_bwd_reference(x.float(), _build.rounded(weight, x.dtype),
                                    _build.rounded(bias, x.dtype), dy.float())
    with torch.enable_grad():
        w = weight.detach().requires_grad_(True)
        b = bias.detach().requires_grad_(True)
        dw, db = torch.autograd.grad(stage1_reference(x.detach(), w, b), (w, b), dy)
    return dw, db


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("stage1_bwd")
    if lib.ocrs_stage1_bwd.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        for sfx in _build.SUFFIX.values():
            fn = getattr(lib, f"ocrs_stage1_bwd{sfx}")
            fn.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, p]
            fn.restype = ctypes.c_int
            blocks = getattr(lib, f"ocrs_stage1_bwd{sfx}_blocks")
            blocks.argtypes = [i, i, i, i]
            blocks.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def stage1_bwd_grid(device: torch.device, n: int, h: int, w: int,
                    dtype: torch.dtype = torch.float32) -> int:
    """Blocks of :func:`stage1_bwd`'s first pass for ``x [n, 1, h, w]`` of
    ``dtype`` on ``device``: the card's SM count times the blocks an SM
    holds, at most one per (image, 32-column tile, pooled row). Asked of
    the card once per (device, shape, dtype) and remembered."""
    blocks = getattr(_bwd_lib(), f"ocrs_stage1_bwd{_build.SUFFIX[dtype]}_blocks")
    n_part = blocks(device.index, n, h, w)
    if n_part < 0:
        raise RuntimeError(f"stage1_bwd: cannot size the grid on {device}")
    return n_part


def stage1_bwd(x, weight, bias, dy):
    """Backward kernel: weight and bias gradients of :func:`stage1_fwd`
    for the output cotangent ``dy [N, 32, H // 2, W // 2]`` in ``x``'s
    dtype; same contract as :func:`stage1_bwd_reference`. Deterministic: one partial sum per
    block of a grid sized from the card (:func:`stage1_bwd_grid`), in
    scratch of this call's own, and a second pass that adds them in a fixed
    order."""
    if x.device.type == "cpu":
        return stage1_bwd_reference(x, weight, bias, dy)
    if not x.is_cuda:
        raise RuntimeError(f"stage1_bwd: unsupported device {x.device}")
    _check("stage1_bwd", x, weight, bias)
    n, _, h, w = x.shape
    if dy.shape != (n, CHANNELS, h // 2, w // 2) or dy.dtype != x.dtype \
            or dy.device != x.device or not dy.is_contiguous():
        raise ValueError(
            f"stage1_bwd: dy must be contiguous {x.dtype} [{n}, 32, {h // 2}, {w // 2}]")
    lib = _bwd_lib()
    n_part = stage1_bwd_grid(x.device, n, h, w, x.dtype)
    partial = torch.empty((max(n_part, 1), CHANNELS * 10), device=x.device, dtype=torch.float32)
    dw = torch.empty((CHANNELS, 1, 3, 3), device=x.device, dtype=torch.float32)
    db = torch.empty((CHANNELS,), device=x.device, dtype=torch.float32)
    p = _build.ptr
    rc = getattr(lib, f"ocrs_stage1_bwd{_build.SUFFIX[x.dtype]}")(
        x.device.index, p(x), p(weight), p(bias), p(dy), p(partial), p(dw), p(db), n, h, w,
        n_part, _build.stream_ptr(x.device),
    )
    _build.check(lib, rc, "stage1_bwd")
    stage1_bwd.launches += 1
    return dw, db


stage1_bwd.launches = 0


class Stage1Function(torch.autograd.Function):
    """Differentiable stage 1: forward :func:`stage1_fwd`, backward
    :func:`stage1_bwd`, saving ``x``, ``weight`` and ``bias`` (the JAX
    VJP's residuals)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight, bias)
        return stage1_fwd(x, weight, bias)

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = stage1_bwd(x, weight, bias, dy)
        if ctx.needs_input_grad[0]:
            with torch.enable_grad():
                xx = x.detach().requires_grad_(True)
                (dx,) = torch.autograd.grad(
                    stage1_reference(xx, weight.detach(), bias.detach()), xx, dy
                )
        return dx, dw, db


def stage1(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Stage 1, differentiable in all three inputs; same contract as
    :func:`stage1_fwd`. Without a gradient to track it is one
    :func:`stage1_fwd` call."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        return Stage1Function.apply(x, weight, bias)
    return stage1_fwd(x, weight, bias)
