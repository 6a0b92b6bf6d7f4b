"""Bidirectional multi-layer GRU with a hand-written CUDA recurrence.

Counterpart of ``ocrs_models_tpu/ops/gru.py`` and of its Pallas kernel
``gru_recurrence4`` with its custom VJP. The input projections ``x @ W_ih
+ b_ih`` for all steps are one large matmul per direction, outside the
recurrence; only ``h @ W_hh`` and the gate math run step by step, in
:func:`gru_recurrence`, differentiable through
:class:`GRURecurrenceFunction`: the forward runs :func:`gru_fwd`
(``csrc/gru_fwd.cu``), the backward :func:`gru_bwd` (``csrc/gru_bwd.cu``).
Both kernels keep their slice of ``W_hh`` in registers for all steps and
loop over time inside one launch; the blocks that share a batch tile form
a thread block cluster and exchange the state through each other's shared
memory. On CPU tensors both wrappers run their plain versions
(:func:`gru_recurrence_reference`, a Python loop of torch ops, and
autograd of it). The backward kernel's three phases have plain versions
of their own (:func:`gru_bwd_coefficients_reference`,
:func:`gru_bwd_chain_reference`, :func:`gru_bwd_dw_reference`), composed
by :func:`gru_bwd_phases_reference`. Gate order and parameter names follow torch's
``nn.GRU`` (r, z, n; ``n = tanh(xn + r * (W_hn h + b_hn))``), so its
state dict loads into :class:`BiGRU` and back.
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


def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load("gru_fwd")
    fn = lib.ocrs_gru_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.ocrs_gru_fwd_max_clusters.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.ocrs_gru_fwd_max_clusters.restype = ctypes.c_int
    return lib


MAX_HIDDEN = 256
"""Widest hidden size the kernels take: a cluster of ``H / 32`` blocks,
at most 8."""


def _check(name: str, tensors: dict, t_len: int, n: int, hid: int) -> None:
    h3 = 3 * hid
    shapes = {
        "px_f": (t_len, n, h3), "px_b": (t_len, n, h3), "ys_f": (t_len, n, hid),
        "ys_b": (t_len, n, hid), "dy_f": (t_len, n, hid), "dy_b": (t_len, n, hid),
        "w_hh": (2, hid, h3), "b_hh": (2, h3),
    }
    dev = tensors["px_f"].device
    for key, t in tensors.items():
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous float32 on {dev}")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} shape {tuple(t.shape)} != {shapes[key]}")
    if hid % 8 or hid > MAX_HIDDEN:
        raise ValueError(f"{name}: the kernel needs H % 8 == 0 and H <= {MAX_HIDDEN}, got H={hid}")


def gru_fwd(px_f, px_b, w_hh, b_hh):
    """Forward kernel of one bidirectional layer's recurrence; same
    contract as :func:`gru_recurrence_reference`. A CUDA tensor goes
    through ``gru_fwd.cu`` (one ctypes call, one launch for all T steps); a
    CPU tensor through the plain version."""
    if px_f.device.type == "cpu":
        return gru_recurrence_reference(px_f, px_b, w_hh, b_hh)
    if not px_f.is_cuda:
        raise RuntimeError(f"gru_fwd: unsupported device {px_f.device}")
    t_len, n, h3 = px_f.shape
    hid = h3 // 3
    _check("gru_fwd", {"px_f": px_f, "px_b": px_b, "w_hh": w_hh, "b_hh": b_hh}, t_len, n, hid)
    ys_f = torch.empty((t_len, n, hid), device=px_f.device, dtype=torch.float32)
    ys_b = torch.empty_like(ys_f)
    lib = _fwd_lib()
    p = _build.ptr
    rc = lib.ocrs_gru_fwd(
        px_f.device.index, p(px_f), p(px_b), p(w_hh), p(b_hh), p(ys_f), p(ys_b),
        t_len, n, hid, _build.stream_ptr(px_f.device),
    )
    _build.check(lib, rc, "gru_fwd")
    gru_fwd.launches += 1
    return ys_f, ys_b


gru_fwd.launches = 0


def gru_bwd_reference(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh):
    """Plain version of the backward: autograd of
    :func:`gru_recurrence_reference` (which recomputes the forward, so
    ``ys_f`` and ``ys_b`` are not read).

    :return: ``(dpx_f, dpx_b [T, N, 3H], dw_hh [2, H, 3H], db_hh [2, 3H])``.
    """
    del ys_f, ys_b
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (px_f, px_b, w_hh, b_hh)]
        outs = gru_recurrence_reference(*ins)
        return torch.autograd.grad(outs, ins, (dy_f, dy_b))


def _h_prev(ys_f, ys_b):
    """``h_{t-1}`` in scan order for both directions, ``[2, T, N, H]``:
    ``ys_f[t-1]`` and ``ys_b[t+1]``, zero at each direction's first step."""
    zero = ys_f.new_zeros((1, *ys_f.shape[1:]))
    return torch.stack([torch.cat([zero, ys_f[:-1]]), torch.cat([ys_b[1:], zero])])


def gru_bwd_coefficients_reference(px_f, px_b, ys_f, ys_b, w_hh, b_hh):
    """Plain version of the backward kernel's first phase: recompute the
    gates of every step at once (``ph = h_prev @ W_hh + b_hh`` over all
    ``T * N`` rows) and return what the chain needs per element,
    ``coef [2, T, N, 5, H]``: ``z``, ``(1-z)(1-c^2)``, ``(h_prev-c) z (1-z)``,
    ``r``, ``hn r (1-r)``."""
    hid = ys_f.shape[-1]
    h_prev = _h_prev(ys_f, ys_b)
    ph = torch.einsum("dtnk,dkj->dtnj", h_prev, w_hh) + b_hh[:, None, None, :]
    xr, xz, xn = torch.stack([px_f, px_b]).split(hid, dim=-1)
    hr, hz, hn = ph.split(hid, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    c = torch.tanh(xn + r * hn)
    return torch.stack(
        [z, (1.0 - z) * (1.0 - c * c), (h_prev - c) * z * (1.0 - z), r, hn * r * (1.0 - r)],
        dim=3,
    )


def gru_bwd_chain_reference(coef, dy_f, dy_b, w_hh):
    """Plain version of the backward kernel's second phase, the chain of
    ``T`` dependent steps: ``dht = dh + dy[t]``, the gate gradients from
    the coefficients, ``dh <- dht z + dph @ W_hh^T``. Returns
    ``(dpx_f, dpx_b)``, each ``[T, N, 3H]``."""
    t_len, n, hid = dy_f.shape
    dpx_f = dy_f.new_empty((t_len, n, 3 * hid))
    dpx_b = dy_f.new_empty((t_len, n, 3 * hid))
    dh = dy_f.new_zeros((2, n, hid))
    w_t = w_hh.transpose(1, 2)
    for step in range(t_len):
        tf, tb = t_len - 1 - step, step
        cz, ca, cb, cr, cc = torch.stack([coef[0, tf], coef[1, tb]]).unbind(dim=2)
        dht = dh + torch.stack([dy_f[tf], dy_b[tb]])
        da_c = dht * ca
        da_z = dht * cb
        dhn = da_c * cr
        da_r = da_c * cc
        dpx = torch.cat([da_r, da_z, da_c], dim=-1)
        dpx_f[tf] = dpx[0]
        dpx_b[tb] = dpx[1]
        dh = dht * cz + torch.bmm(torch.cat([da_r, da_z, dhn], dim=-1), w_t)
    return dpx_f, dpx_b


def gru_bwd_dw_reference(ys_f, ys_b, dpx_f, dpx_b, coef):
    """Plain version of the backward kernel's third phase: ``dW_hh =
    h_prev^T dph`` and ``db_hh = sum dph`` over all ``T * N`` rows, where
    ``dph`` is ``dpx`` with its n columns multiplied by ``r``. Returns
    ``(dw_hh [2, H, 3H], db_hh [2, 3H])``."""
    hid = ys_f.shape[-1]
    dpx = torch.stack([dpx_f, dpx_b])
    dph = torch.cat([dpx[..., : 2 * hid], dpx[..., 2 * hid :] * coef[:, :, :, 3]], dim=-1)
    dw = torch.einsum("dtnk,dtnj->dkj", _h_prev(ys_f, ys_b), dph)
    return dw, dph.sum(dim=(1, 2))


def gru_bwd_phases_reference(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh):
    """The backward as the kernel computes it, phase by phase, in plain
    torch ops; same contract as :func:`gru_bwd_reference` (and it reads
    the saved ``ys_f``, ``ys_b``, as the kernel does)."""
    coef = gru_bwd_coefficients_reference(px_f, px_b, ys_f, ys_b, w_hh, b_hh)
    dpx_f, dpx_b = gru_bwd_chain_reference(coef, dy_f, dy_b, w_hh)
    dw, db = gru_bwd_dw_reference(ys_f, ys_b, dpx_f, dpx_b, coef)
    return dpx_f, dpx_b, dw, db


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("gru_bwd")
    fn = lib.ocrs_gru_bwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [i] + [p] * 15 + [i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.ocrs_gru_bwd_max_clusters.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.ocrs_gru_bwd_max_clusters.restype = ctypes.c_int
    return lib


def max_active_clusters(n: int, hid: int, device: int = 0) -> dict:
    """For batch ``n`` and hidden size ``hid``: the batch rows per block
    that :func:`gru_fwd` and :func:`gru_bwd` pick, the clusters each then
    launches, and how many of them the card can hold at once
    (``cudaOccupancyMaxActiveClusters``)."""
    out = {"cluster_size": -(-hid // 32)}
    for name, lib, fn in (("gru_fwd", _fwd_lib(), "ocrs_gru_fwd_max_clusters"),
                          ("gru_bwd", _bwd_lib(), "ocrs_gru_bwd_max_clusters")):
        rows = ctypes.c_int(0)
        got = getattr(lib, fn)(device, n, hid, ctypes.byref(rows))
        if got < 0:
            _build.check(lib, -got, fn)
        out[name] = {"rows_per_block": rows.value, "launched": 2 * -(-n // rows.value),
                     "max_active": got}
    return out


DW_SPLITS = 8
"""Most ranges of rows in the dW reduction; each range needs a partial
``[2, H, 3H]``."""


def gru_bwd(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh):
    """Backward kernel of one bidirectional layer's recurrence; same
    contract as :func:`gru_bwd_reference`. A CUDA tensor goes through
    ``gru_bwd.cu`` (one ctypes call, four launches whatever ``T`` is: the
    coefficients, the chain, the weight-gradient partials, their sum); a
    CPU tensor through the plain version."""
    if px_f.device.type == "cpu":
        return gru_bwd_reference(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh)
    if not px_f.is_cuda:
        raise RuntimeError(f"gru_bwd: unsupported device {px_f.device}")
    t_len, n, h3 = px_f.shape
    hid = h3 // 3
    _check("gru_bwd", {
        "px_f": px_f, "px_b": px_b, "ys_f": ys_f, "ys_b": ys_b, "dy_f": dy_f, "dy_b": dy_b,
        "w_hh": w_hh, "b_hh": b_hh,
    }, t_len, n, hid)
    dev = px_f.device
    splits = max(1, min(DW_SPLITS, t_len * n // 512))
    dpx_f = torch.empty_like(px_f)
    dpx_b = torch.empty_like(px_b)
    coef = torch.empty((2, t_len * n, 5, hid), device=dev, dtype=torch.float32)
    dwp = torch.empty((splits, 2, hid, h3), device=dev, dtype=torch.float32)
    dbp = torch.empty((splits, 2, h3), device=dev, dtype=torch.float32)
    dw = torch.empty_like(w_hh)
    db = torch.empty_like(b_hh)
    lib = _bwd_lib()
    p = _build.ptr
    rc = lib.ocrs_gru_bwd(
        dev.index, p(px_f), p(px_b), p(ys_f), p(ys_b), p(dy_f), p(dy_b), p(w_hh), p(b_hh),
        p(dpx_f), p(dpx_b), p(coef), p(dwp), p(dbp), p(dw), p(db),
        splits, t_len, n, hid, _build.stream_ptr(dev),
    )
    _build.check(lib, rc, "gru_bwd")
    gru_bwd.launches += 1
    return dpx_f, dpx_b, dw, db


gru_bwd.launches = 0


class GRURecurrenceFunction(torch.autograd.Function):
    """Differentiable recurrence: forward :func:`gru_fwd`, backward
    :func:`gru_bwd`, saving ``px_f, px_b, ys_f, ys_b, w_hh, b_hh`` (the
    JAX VJP's residuals)."""

    @staticmethod
    def forward(ctx, px_f, px_b, w_hh, b_hh):
        ys_f, ys_b = gru_fwd(px_f, px_b, w_hh, b_hh)
        ctx.save_for_backward(px_f, px_b, ys_f, ys_b, w_hh, b_hh)
        return ys_f, ys_b

    @staticmethod
    def backward(ctx, dy_f, dy_b):
        px_f, px_b, ys_f, ys_b, w_hh, b_hh = ctx.saved_tensors
        dy_f = torch.zeros_like(ys_f) if dy_f is None else dy_f.contiguous()
        dy_b = torch.zeros_like(ys_b) if dy_b is None else dy_b.contiguous()
        return gru_bwd(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w_hh, b_hh)


def gru_recurrence(px_f, px_b, w_hh, b_hh):
    """Recurrence of one bidirectional layer, differentiable in all four
    inputs; same contract as :func:`gru_recurrence_reference`. Without a
    gradient to track it is one :func:`gru_fwd` call."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (px_f, px_b, w_hh, b_hh)):
        return GRURecurrenceFunction.apply(px_f, px_b, w_hh, b_hh)
    return gru_fwd(px_f, px_b, w_hh, b_hh)


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
