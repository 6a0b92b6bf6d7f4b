"""Bidirectional multi-layer GRU with a hand-written CUDA recurrence.

Counterpart of ``ocrs_models_tpu/ops/gru.py`` and of the forward of its
Pallas kernel ``gru_recurrence4``. The input projections ``x @ W_ih +
b_ih`` for all steps are one large matmul per direction, outside the
recurrence; only ``h @ W_hh`` and the gate math run step by step, in
:func:`gru_recurrence`: the kernel ``csrc/gru_fwd.cu`` on a CUDA tensor,
:func:`gru_recurrence_reference` (a Python loop of torch ops) on a CPU
tensor. Gate order and parameter names follow torch's ``nn.GRU`` (r, z, n;
``n = tanh(xn + r * (W_hn h + b_hn))``), so its state dict loads into
:class:`BiGRU` and back.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch import nn

from . import _build


def gru_recurrence_reference(px_f, px_b, w_hh, b_hh):
    """Plain version of the recurrence of one bidirectional layer.

    :param px_f, px_b: ``[T, N, 3H]`` input projections per direction, both
        in natural time order (the backward direction reads step ``T-1-i``).
    :param w_hh: ``[2, H, 3H]`` recurrent weights laid out for ``h @ W``.
    :param b_hh: ``[2, 3H]``.
    :return: ``(ys_f, ys_b)``, each ``[T, N, H]`` in natural time order.
    """
    t_len, n, h3 = px_f.shape
    hid = h3 // 3
    ys_f = px_f.new_empty((t_len, n, hid))
    ys_b = px_f.new_empty((t_len, n, hid))
    h = px_f.new_zeros((2, n, hid))
    for i in range(t_len):
        tb = t_len - 1 - i
        ph = torch.baddbmm(b_hh[:, None, :], h, w_hh)  # [2, N, 3H]
        px_t = torch.stack([px_f[i], px_b[tb]])
        xr, xz, xn = px_t.split(hid, dim=-1)
        hr, hz, hn = ph.split(hid, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        c = torch.tanh(xn + r * hn)
        h = (1.0 - z) * c + z * h
        ys_f[i] = h[0]
        ys_b[tb] = h[1]
    return ys_f, ys_b


def _lib() -> ctypes.CDLL:
    lib = _build.load("gru_fwd")
    fn = lib.ocrs_gru_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def gru_recurrence(px_f, px_b, w_hh, b_hh):
    """Recurrence of one bidirectional layer; same contract as
    :func:`gru_recurrence_reference`. A CUDA tensor goes through the
    kernel (one ctypes call, T step launches); a CPU tensor through the
    plain version."""
    if px_f.device.type == "cpu":
        return gru_recurrence_reference(px_f, px_b, w_hh, b_hh)
    if not px_f.is_cuda:
        raise RuntimeError(f"gru_recurrence: unsupported device {px_f.device}")
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (px_f, px_b, w_hh, b_hh)
    ):
        raise NotImplementedError("gru_recurrence: the backward kernel is not ported yet (ROADMAP.md)")
    t_len, n, h3 = px_f.shape
    hid = h3 // 3
    expect = {
        "px_f": (t_len, n, h3), "px_b": (t_len, n, h3),
        "w_hh": (2, hid, h3), "b_hh": (2, h3),
    }
    for name, t in zip(expect, (px_f, px_b, w_hh, b_hh)):
        if t.device != px_f.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"gru_recurrence: {name} must be contiguous float32 on {px_f.device}")
        if tuple(t.shape) != expect[name]:
            raise ValueError(f"gru_recurrence: {name} shape {tuple(t.shape)} != {expect[name]}")
    if hid % 8:
        raise ValueError(f"gru_recurrence: the kernel needs H % 8 == 0, got H={hid}")
    ys_f = torch.empty((t_len, n, hid), device=px_f.device, dtype=torch.float32)
    ys_b = torch.empty_like(ys_f)
    h_buf = torch.empty((2, 2, n, hid), device=px_f.device, dtype=torch.float32)
    lib = _lib()
    p = _build.ptr
    rc = lib.ocrs_gru_fwd(
        px_f.device.index, p(px_f), p(px_b), p(w_hh), p(b_hh), p(ys_f), p(ys_b), p(h_buf),
        t_len, n, hid, _build.stream_ptr(px_f.device),
    )
    _build.check(lib, rc, "gru_fwd")
    gru_recurrence.launches += 1
    return ys_f, ys_b


gru_recurrence.launches = 0


class BiGRU(nn.Module):
    """Stack of bidirectional GRU layers with ``nn.GRU(input_size, hidden,
    num_layers=layers, bidirectional=True, batch_first=True)`` semantics and
    parameter names. Input ``[N, T, F]``, output ``[N, T, 2 * hidden]``."""

    def __init__(self, input_size: int, hidden: int, layers: int = 2):
        super().__init__()
        self.hidden = hidden
        self.layers = layers
        k = 1.0 / math.sqrt(hidden)
        for layer in range(layers):
            fin = input_size if layer == 0 else 2 * hidden
            for sfx in ("", "_reverse"):
                for name, shape in (
                    (f"weight_ih_l{layer}{sfx}", (3 * hidden, fin)),
                    (f"weight_hh_l{layer}{sfx}", (3 * hidden, hidden)),
                    (f"bias_ih_l{layer}{sfx}", (3 * hidden,)),
                    (f"bias_hh_l{layer}{sfx}", (3 * hidden,)),
                ):
                    self.register_parameter(
                        name, nn.Parameter(torch.empty(shape).uniform_(-k, k))
                    )

    def _p(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        x = xs.transpose(0, 1)  # time-major [T, N, F] between layers
        for layer in range(self.layers):
            f, b = f"l{layer}", f"l{layer}_reverse"
            # Hoisted input projections: one [T*N, F] x [F, 3H] matmul each.
            px_f = torch.nn.functional.linear(x, self._p(f"weight_ih_{f}"), self._p(f"bias_ih_{f}"))
            px_b = torch.nn.functional.linear(x, self._p(f"weight_ih_{b}"), self._p(f"bias_ih_{b}"))
            w_hh = torch.stack([self._p(f"weight_hh_{f}").t(), self._p(f"weight_hh_{b}").t()])
            b_hh = torch.stack([self._p(f"bias_hh_{f}"), self._p(f"bias_hh_{b}")])
            ys_f, ys_b = gru_recurrence(
                px_f.contiguous(), px_b.contiguous(), w_hh.contiguous(), b_hh
            )
            x = torch.cat([ys_f, ys_b], dim=-1)
        return x.transpose(0, 1)
