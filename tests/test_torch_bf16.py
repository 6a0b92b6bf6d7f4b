"""The port's bfloat16 path against the JAX package's, on the CPU.

The JAX side runs as its own tests run it here: ``stage1_fused(..., True,
jnp.bfloat16)`` and ``gru_recurrence4(..., jnp.bfloat16, True)`` in
interpret mode, ``RecognitionModel(dtype=jnp.bfloat16,
conv_backend="fused", gru_backend="pallas4")``. The port's kernel wrappers
run their plain versions (CPU tensors), which hold the Pallas kernels'
rounding points. Inputs and weights are made with numpy from a seed and
handed to both; weights go through ``weights.py``.

Tolerances, and why:

- stage 1 forward: at least 99% of the outputs equal, the rest within one
  bf16 ulp (both sum the same exact bf16 products in f32, in another
  order, then round once to bf16).
- stage 1 ``dW``/``db``: 1e-3 of max |dW| (exact products, f32 sums in
  another order).
- biGRU ``ys`` (T <= 12, H = 32): 1e-2; ``dpx`` 2e-2 (the rounding points
  are the same; an f32 sum that lands on the other side of a bf16 rounding
  moves an output by one bf16 ulp, and the recurrence carries it on).
  ``dW``/``db``: 1e-4 of their max, tighter than the 1e-2 first set: they
  are f32 sums of exact products on both sides, and a rounding point
  missed in the backward (``bf16(dph)`` in ``dh`` or ``dW``, ``bf16(W_hh)``
  in the recomputed gates) moves them by 6e-4 to 5e-3 of their max.
- the model's log-probs: 1e-2 (read 4.0e-3); detection probabilities:
  8e-3 (read 3.3e-3). Outside the kernels cuDNN's and XLA's bf16 rounding
  points differ: XLA's CPU convs round the product before adding the
  bias, detection's depthwise conv is nine bf16 multiply-adds in JAX and
  one f32-accumulated conv here. Those limits alone cannot tell bf16 from
  float32 compute: the float32 port differs from JAX's bf16 model by as
  much (3.5e-3 and 2.1e-3). So each model test also holds the port's bf16
  effect (its bf16 output less its float32 output) against JAX's (the
  same on the JAX side): of the same size (the ratio of their RMS within
  [0.5, 1.5]; read 0.96-1.03 for recognition, 0.72-0.75 for detection,
  which rounds less in its depthwise conv) and pointing the same way
  (their correlation at least 0.4 for recognition, read 0.56-0.70, and
  0.2 for detection, read 0.33-0.47; chance gives about 0.02). A model
  that ignored its dtype has no effect at all and fails.
- one bf16 training step's loss: 1e-2 relative.
- the trainer's epoch-0 loss against the JAX trainer's ``--bf16``: 1e-2
  relative. On the CPU the JAX CLI takes its XLA conv and scan GRU (its
  "auto" backends off the TPU), whose bf16 rounding points differ from
  the Pallas kernels' that the port holds.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrs_models_tpu.data import SyntheticDetection
from ocrs_models_tpu.models import DetectionModel as JaxDetection
from ocrs_models_tpu.models import RecognitionModel as JaxRecognition
from ocrs_models_tpu.ops.pallas.gru_kernel4 import gru_recurrence4
from ocrs_models_tpu.ops.pallas.stage1_kernel import stage1_fused
from ocrs_models_tpu.training.steps import make_recognition_steps as jax_make_steps
from ocrs_models_tpu.training import train_rec as jax_train_rec
from ocrs_models_torch.data.resize import resize
from ocrs_models_torch.models import DetectionModel, RecognitionModel
from ocrs_models_torch.ops import (
    BiGRU,
    gru_bwd_chain_bf16_reference,
    gru_bwd_chain_reference,
    gru_bwd_coefficients_reference,
    gru_bwd_dw_bf16_reference,
    gru_bwd_dw_reference,
    gru_bwd_phases_reference,
    gru_bwd_reference,
    gru_recurrence,
    gru_recurrence_reference,
    stage1,
    stage1_bwd_reference,
    stage1_reference,
)
from ocrs_models_torch.pipeline import OcrPipeline
from ocrs_models_torch.training import train_rec
from ocrs_models_torch.training.state import create_train_state
from ocrs_models_torch.training.steps import make_recognition_steps
from ocrs_models_torch.weights import (
    detection_state_dict_from_jax,
    recognition_state_dict_from_jax,
)
from test_torch_train_steps import CLIP, LR, _batches, _jax_state
from torch_port_common import nhwc_to_nchw, patch_bf16_dots_in_f32, random_variables

BF16 = torch.bfloat16


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _jnp32(a) -> np.ndarray:
    return np.array(jnp.asarray(a, jnp.float32))


@pytest.fixture
def bf16_dots_in_f32(monkeypatch):
    """``patch_bf16_dots_in_f32``: this CPU's XLA runtime has no bf16 x
    bf16 -> f32 dot, which the JAX package's bf16 detection and its
    ``pallas4`` biGRU input projections ask for; the einsums take their
    bf16 operands as float32 for the test's duration (the same function)."""
    patch_bf16_dots_in_f32(monkeypatch)


def _assert_bf16_effect_matches(port_bf16, port_f32, jax_bf16, jax_f32, min_corr):
    """The port's bf16 effect (``port_bf16 - port_f32``) against JAX's: the
    ratio of their RMS within [0.5, 1.5], their correlation at least
    ``min_corr`` (see the module docstring)."""
    d_port = (port_bf16 - port_f32).ravel().astype(np.float64)
    d_jax = (jax_bf16 - jax_f32).ravel().astype(np.float64)
    ratio = np.linalg.norm(d_port) / np.linalg.norm(d_jax)
    assert 0.5 <= ratio <= 1.5, ratio
    corr = d_port @ d_jax / (np.linalg.norm(d_port) * np.linalg.norm(d_jax))
    assert corr >= min_corr, corr


def _within_one_ulp(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Where ``got`` and ``want`` (bf16 values) differ by at most one bf16
    ulp of the larger magnitude (8 significant bits)."""
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return np.abs(got - want) <= ulp


# ------------------------------------------------------------------ stage 1

def _stage1_case(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (n, h, w, 1)).astype(np.float32)
    k = rng.normal(0, 0.3, (3, 3, 1, 32)).astype(np.float32)
    b = rng.normal(0, 0.1, (32,)).astype(np.float32)
    return x, k, b


def _torch_weight(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("shape", [(2, 16, 16), (3, 32, 12)])
def test_stage1_forward_matches_pallas_bf16(shape):
    x, k, b = _stage1_case(*shape)
    want = _jnp32(stage1_fused(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), True, jnp.bfloat16))
    y = stage1(nhwc_to_nchw(x).to(BF16), _torch_weight(k), torch.from_numpy(b))
    assert y.dtype == BF16 and y.shape == (shape[0], 32, shape[1] // 2, shape[2] // 2)
    got = _np(y).transpose(0, 2, 3, 1)
    assert (got == want).mean() >= 0.99
    assert _within_one_ulp(got, want).all()


def test_stage1_forward_rounds_the_bias_and_the_output_once():
    # The plain version is the f32 forward on bf16-rounded x, taps and bias,
    # rounded once at the end.
    x, k, b = _stage1_case(2, 16, 16, seed=4)
    xt, wt, bt = nhwc_to_nchw(x), _torch_weight(k), torch.from_numpy(b)
    got = stage1_reference(xt.to(BF16), wt, bt)
    want = stage1_reference(xt.to(BF16).float(), wt.to(BF16).float(), bt.to(BF16).float())
    assert torch.equal(got, want.to(BF16))
    assert not torch.equal(got, stage1_reference(xt.to(BF16).float(), wt, bt).to(BF16))


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tied-windows"])
@pytest.mark.parametrize("shape", [(2, 16, 16), (3, 32, 12)])
def test_stage1_gradients_match_pallas_bf16(shape, ties):
    x, k, b = _stage1_case(*shape, seed=2)
    if ties:  # four equal pre-activations (the bias) in each window right of the middle
        x[:, :, shape[2] // 2 :, :] = 0.0
    dy = np.random.default_rng(3).normal(size=(shape[0], shape[1] // 2, shape[2] // 2, 32))
    dy_bf = jnp.asarray(dy, jnp.bfloat16)
    _, vjp = jax.vjp(lambda kk, bb: stage1_fused(jnp.asarray(x), kk, bb, True, jnp.bfloat16),
                     jnp.asarray(k), jnp.asarray(b))
    dk, db = map(np.asarray, vjp(dy_bf))
    xt = nhwc_to_nchw(x).to(BF16)
    dyt = nhwc_to_nchw(_jnp32(dy_bf)).to(BF16)
    dw_plain, db_plain = stage1_bwd_reference(xt, _torch_weight(k), torch.from_numpy(b), dyt)
    wt = _torch_weight(k).requires_grad_(True)
    bt = torch.from_numpy(b.copy()).requires_grad_(True)
    stage1(xt, wt, bt).backward(dyt)
    scale = np.abs(dk).max()
    for got_w, got_b in ((dw_plain, db_plain), (wt.grad, bt.grad)):
        assert got_w.dtype == got_b.dtype == torch.float32
        np.testing.assert_allclose(_np(got_w).transpose(2, 3, 1, 0), dk, rtol=0, atol=1e-3 * scale)
        np.testing.assert_allclose(_np(got_b), db, rtol=0, atol=1e-3 * scale)


# -------------------------------------------------------------------- biGRU

def _gru_case(t, n=5, h=32, seed=0):
    rng = np.random.default_rng(seed)
    px_f = rng.normal(size=(t, n, 3 * h)).astype(np.float32)
    px_b = rng.normal(size=(t, n, 3 * h)).astype(np.float32)
    w = (rng.normal(size=(2, h, 3 * h)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(2, 3 * h)) * 0.1).astype(np.float32)
    dy = [rng.normal(size=(t, n, h)).astype(np.float32) for _ in range(2)]
    return px_f, px_b, w, b, dy


def _jax_gru_bf16(px_f, px_b, w, b, dy):
    pxs = [jnp.asarray(p, jnp.bfloat16) for p in (px_f, px_b)]
    ys, vjp = jax.vjp(lambda pf, pb, ww, bb: gru_recurrence4(pf, pb, ww, bb, jnp.bfloat16, True),
                      *pxs, jnp.asarray(w), jnp.asarray(b))
    grads = vjp(tuple(jnp.asarray(d, jnp.bfloat16) for d in dy))
    return [_jnp32(y) for y in ys], [_jnp32(g) for g in grads]


@pytest.mark.parametrize("t", [1, 5, 12])
def test_gru_matches_pallas_bf16(t):
    px_f, px_b, w, b, dy = _gru_case(t, seed=t)
    (want_f, want_b), (dpf, dpb, dw, db) = _jax_gru_bf16(px_f, px_b, w, b, dy)
    # Both sides from the same bf16 inputs.
    pf, pb = (torch.from_numpy(_jnp32(jnp.asarray(p, jnp.bfloat16))).to(BF16) for p in (px_f, px_b))
    dyt = [torch.from_numpy(_jnp32(jnp.asarray(d, jnp.bfloat16))).to(BF16) for d in dy]
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    ys_f, ys_b = gru_recurrence(pf, pb, wt, bt)
    assert ys_f.dtype == ys_b.dtype == BF16
    np.testing.assert_allclose(_np(ys_f), want_f, rtol=0, atol=1e-2)
    np.testing.assert_allclose(_np(ys_b), want_b, rtol=0, atol=1e-2)
    got = gru_bwd_reference(pf, pb, ys_f, ys_b, *dyt, wt, bt)
    assert got[0].dtype == got[1].dtype == BF16 and got[2].dtype == got[3].dtype == torch.float32
    np.testing.assert_allclose(_np(got[0]), dpf, rtol=0, atol=2e-2)
    np.testing.assert_allclose(_np(got[1]), dpb, rtol=0, atol=2e-2)
    np.testing.assert_allclose(_np(got[2]), dw, rtol=0, atol=1e-4 * np.abs(dw).max())
    np.testing.assert_allclose(_np(got[3]), db, rtol=0, atol=1e-4 * np.abs(db).max())


def _bf16_chain_case(t, seed):
    """The bf16 operands of ``_gru_case`` on both sides, the port's ``ys``,
    the plain chain's ``(dpx_f, dpx_b, dph)`` and the Pallas VJP's grads."""
    px_f, px_b, w, b, dy = _gru_case(t, seed=seed)
    _, jax_grads = _jax_gru_bf16(px_f, px_b, w, b, dy)
    pf, pb = (torch.from_numpy(_jnp32(jnp.asarray(p, jnp.bfloat16))).to(BF16) for p in (px_f, px_b))
    dyt = [torch.from_numpy(_jnp32(jnp.asarray(d, jnp.bfloat16))).to(BF16) for d in dy]
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    ys = gru_recurrence_reference(pf, pb, wt, bt)
    coef = gru_bwd_coefficients_reference(pf, pb, *ys, wt, bt)
    return (pf, pb, dyt, wt, bt, ys, coef), gru_bwd_chain_reference(coef, *dyt, wt), jax_grads


@pytest.mark.parametrize("t", [1, 5, 12])
def test_gru_bf16_dpx_holds_the_rounded_dph(t):
    # The identities the bf16 backward kernel's phase split rests on: dpx's
    # r and z columns are bf16(dph)'s bit for bit, so the chain hands `dw`
    # only bf16(dhn); and db sums the unrounded dph.
    (_, _, dyt, wt, _, _, coef), (dpx_f, dpx_b, dph), _ = _bf16_chain_case(t, 30 + t)
    h2 = 2 * dyt[0].shape[-1]
    assert torch.equal(torch.stack([dpx_f, dpx_b])[..., :h2], dph[..., :h2].to(BF16))
    s_f, s_b, dhn, db = gru_bwd_chain_bf16_reference(coef, *dyt, wt)
    assert torch.equal(s_f, dpx_f) and torch.equal(s_b, dpx_b)
    assert dhn.dtype == BF16 and torch.equal(dhn, dph[..., h2:].to(BF16))
    assert db.dtype == torch.float32 and torch.equal(db, dph.sum(dim=(1, 2)))


@pytest.mark.parametrize("t", [1, 5, 12])
def test_gru_bf16_dw_is_the_same_from_rounded_dph(t):
    # gru_bwd_dw_reference rounds dph for bf16 ys, so the f32 dph and
    # bf16(dph) give the same dW, and so does dW from [dpx's r, z columns,
    # bf16(dhn)], what the bf16 chain hands on.
    (_, _, dyt, wt, _, ys, coef), (dpx_f, dpx_b, dph), _ = _bf16_chain_case(t, 40 + t)
    dw, _ = gru_bwd_dw_reference(*ys, dph)
    dw_rounded, _ = gru_bwd_dw_reference(*ys, dph.to(BF16).float())
    _, _, dhn, _ = gru_bwd_chain_bf16_reference(coef, *dyt, wt)
    assert torch.equal(dw, dw_rounded)
    torch.testing.assert_close(gru_bwd_dw_bf16_reference(*ys, dpx_f, dpx_b, dhn), dw,
                               rtol=0, atol=1e-6 * dw.abs().max().item())


@pytest.mark.parametrize("t", [5, 12])
def test_gru_bf16_db_from_rounded_dph_misses_pallas(t):
    # db summed after rounding dph to bf16 is not the Pallas VJP's db: it
    # misses the 1e-4-of-max bound of test_gru_matches_pallas_bf16, and by
    # several times the unrounded sum's own distance (which comes from ys
    # roundings that flip), so a kernel that summed db from bf16(dph) would
    # fail the tests.
    _, (_, _, dph), (_, _, _, db) = _bf16_chain_case(t, 50 + t)
    tol = 1e-4 * np.abs(db).max()
    unrounded = np.abs(_np(dph.sum(dim=(1, 2))) - db).max()
    rounded = np.abs(_np(dph.to(BF16).float().sum(dim=(1, 2))) - db).max()
    assert rounded > tol and rounded > 4 * unrounded


@pytest.mark.parametrize("t", [1, 5, 12])
def test_gru_bf16_chain_split_matches_pallas(t):
    # The bf16 phase split (the chain's bf16(dhn) and db, then dW from dpx
    # and dhn) against the Pallas VJP, at the tolerances of
    # test_gru_matches_pallas_bf16.
    (_, _, dyt, wt, _, ys, coef), _, (dpf, dpb, dw, db) = _bf16_chain_case(t, 60 + t)
    dpx_f, dpx_b, dhn, db_got = gru_bwd_chain_bf16_reference(coef, *dyt, wt)
    dw_got = gru_bwd_dw_bf16_reference(*ys, dpx_f, dpx_b, dhn)
    np.testing.assert_allclose(_np(dpx_f), dpf, rtol=0, atol=2e-2)
    np.testing.assert_allclose(_np(dpx_b), dpb, rtol=0, atol=2e-2)
    np.testing.assert_allclose(_np(dw_got), dw, rtol=0, atol=1e-4 * np.abs(dw).max())
    np.testing.assert_allclose(_np(db_got), db, rtol=0, atol=1e-4 * np.abs(db).max())


def test_gru_recurrence_function_routes_bf16_gradients():
    # Autograd through GRURecurrenceFunction reaches the bf16 backward.
    px_f, px_b, w, b, dy = _gru_case(4, seed=9)
    ins = [torch.from_numpy(p).to(BF16).requires_grad_(True) for p in (px_f, px_b)]
    wt, bt = torch.from_numpy(w).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    ys = gru_recurrence(*ins, wt, bt)
    dyt = [torch.from_numpy(d).to(BF16) for d in dy]
    torch.autograd.backward(ys, dyt)
    want = gru_bwd_phases_reference(*[p.detach() for p in ins], *[y.detach() for y in ys],
                                    *dyt, wt.detach(), bt.detach())
    for got, w_ in zip((ins[0].grad, ins[1].grad, wt.grad, bt.grad), want):
        assert got.dtype == w_.dtype
        assert torch.equal(got, w_)


def test_gru_bf16_rounding_points():
    # The plain version step by step: the product reads bf16(h) and
    # bf16(W_hh), the gate update the f32 state, ys is the state rounded.
    px_f, px_b, w, b, _ = _gru_case(12, seed=5)
    args = [torch.from_numpy(p).to(BF16) for p in (px_f, px_b)] + [torch.from_numpy(w),
                                                                   torch.from_numpy(b)]
    ys_f, _ = gru_recurrence_reference(*args)
    h = torch.zeros(5, 32)
    wr = torch.from_numpy(w[0]).to(BF16).float()
    for i in range(12):
        ph = h.to(BF16).float() @ wr + torch.from_numpy(b[0])
        x = args[0][i].float()
        r = torch.sigmoid(x[:, :32] + ph[:, :32])
        z = torch.sigmoid(x[:, 32:64] + ph[:, 32:64])
        c = torch.tanh(x[:, 64:] + r * ph[:, 64:])
        h = (1 - z) * c + z * h
        torch.testing.assert_close(ys_f[i], h.to(BF16), rtol=0, atol=0)


def test_bigru_bf16_matches_jax_pallas4(bf16_dots_in_f32):
    from ocrs_models_tpu.ops.gru import BiGRU as JaxBiGRU
    from ocrs_models_torch.weights import bigru_state_dict_from_jax

    rng = np.random.default_rng(0)
    xs = rng.normal(size=(3, 9, 12)).astype(np.float32)
    mod = JaxBiGRU(32, 2, compute_dtype=jnp.bfloat16, backend="pallas4")
    params = jax.tree_util.tree_map(np.asarray, mod.init(jax.random.key(0), jnp.asarray(xs))["params"])
    want = _jnp32(mod.apply({"params": params}, jnp.asarray(xs)))
    port = BiGRU(12, 32, 2, compute_dtype=BF16)
    port.load_state_dict(bigru_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(xs))
    assert got.dtype == BF16
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=2e-2)


# ------------------------------------------------------------------ models

def _jax_rec_bf16(hidden=32):
    return JaxRecognition(n_classes=97, gru_hidden=hidden, dtype=jnp.bfloat16,
                          conv_backend="fused", gru_backend="pallas4")


@pytest.mark.parametrize("gru_dtype", [None, torch.float32], ids=["gru-bf16", "gru-f32"])
def test_recognition_bf16_matches_jax(gru_dtype, bf16_dots_in_f32):
    kw = dict(n_classes=97, gru_hidden=32, conv_backend="fused", gru_backend="pallas4")
    jax_model = JaxRecognition(dtype=jnp.bfloat16,
                               gru_dtype=None if gru_dtype is None else jnp.float32, **kw)
    variables = random_variables(jax_model, (1, 64, 32, 1), seed=0)
    x = np.random.default_rng(0).uniform(-0.5, 0.5, (2, 64, 32, 1)).astype(np.float32)
    want = np.asarray(jax_model.apply(variables, jnp.asarray(x), train=False))
    want_f32 = np.asarray(JaxRecognition(**kw).apply(variables, jnp.asarray(x), train=False))
    port = RecognitionModel(n_classes=97, gru_hidden=32, dtype=BF16, gru_dtype=gru_dtype).eval()
    port_f32 = RecognitionModel(n_classes=97, gru_hidden=32).eval()
    for m in (port, port_f32):
        m.load_state_dict(recognition_state_dict_from_jax(variables), strict=True)
    assert port.gru.compute_dtype == (BF16 if gru_dtype is None else torch.float32)
    with torch.no_grad():
        got, got_f32 = port(nhwc_to_nchw(x)), port_f32(nhwc_to_nchw(x)).numpy()
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 9, 97)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2)
    _assert_bf16_effect_matches(got.numpy(), got_f32, want, want_f32, min_corr=0.4)


def test_recognition_bf16_keeps_float32_parameters_and_keys():
    f32, bf = RecognitionModel(97, gru_hidden=16), RecognitionModel(97, gru_hidden=16, dtype=BF16)
    assert f32.state_dict().keys() == bf.state_dict().keys()
    assert all(v.dtype in (torch.float32, torch.int64) for v in bf.state_dict().values())
    with pytest.raises(ValueError, match="bfloat16"):
        RecognitionModel(97, dtype=torch.float16)


def test_detection_bf16_matches_jax(bf16_dots_in_f32):
    variables = random_variables(JaxDetection(), (1, 64, 64, 1), seed=2)
    x = np.random.default_rng(2).uniform(-0.5, 0.5, (2, 64, 64, 1)).astype(np.float32)
    want, want_f32 = (np.asarray(JaxDetection(dtype=dt).apply(variables, jnp.asarray(x),
                                                              train=False))
                      for dt in (jnp.bfloat16, jnp.float32))
    got = {}
    for dt in (BF16, torch.float32):
        port = DetectionModel(dtype=dt).eval()
        port.load_state_dict(detection_state_dict_from_jax(variables), strict=True)
        with torch.no_grad():
            got[dt] = port(nhwc_to_nchw(x))
        assert got[dt].dtype == torch.float32
    got_bf16, got_f32 = (got[dt].numpy().transpose(0, 2, 3, 1) for dt in (BF16, torch.float32))
    np.testing.assert_allclose(got_bf16, want, rtol=0, atol=8e-3)
    _assert_bf16_effect_matches(got_bf16, got_f32, want, want_f32, min_corr=0.2)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_norm_lite_matches_jax(train):
    # One batch norm on the same bf16 activations: the output within one
    # bf16 ulp (the same f32 fold, applied in bf16), and in training the
    # running statistics (f32 statistics of the bf16 values, torch's
    # momentum, the unbiased variance) within f32 rounding.
    from ocrs_models_tpu.models.detection import BatchNormLite
    from ocrs_models_torch.models.detection import batch_norm_lite

    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.normal(0.3, 2.0, (3, 5, 7, 16)), jnp.bfloat16)
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
                   "bias": rng.normal(0, 0.1, 16).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(0, 0.1, 16).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, 16).astype(np.float32)},
    }
    mod = BatchNormLite(momentum=0.9, epsilon=1e-5, axis=-1)
    want, new = mod.apply(variables, x, use_running_average=not train, mutable=["batch_stats"])
    bn = torch.nn.BatchNorm2d(16, eps=1e-5, momentum=0.1).train(train)
    with torch.no_grad():
        for name, value in (("weight", "scale"), ("bias", "bias")):
            getattr(bn, name).copy_(torch.from_numpy(variables["params"][value]))
        bn.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
        got = batch_norm_lite(bn, torch.from_numpy(_jnp32(x)).to(BF16).permute(0, 3, 1, 2))
    assert got.dtype == BF16
    got = _np(got).transpose(0, 2, 3, 1)
    assert _within_one_ulp(got, _jnp32(want)).all()
    for key, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
        want_stat = np.asarray(new["batch_stats"][key])
        np.testing.assert_allclose(buf.numpy(), want_stat, rtol=1e-5, atol=1e-6, err_msg=key)
    assert int(bn.num_batches_tracked) == int(train)


# ------------------------------------------------------------ training step

def test_train_step_bf16_matches_jax(bf16_dots_in_f32):
    jax_batch, port_batch = _batches()
    jax_model = _jax_rec_bf16(hidden=16)
    variables = random_variables(jax_model, (1, 64, 64, 1), 0)
    port = RecognitionModel(n_classes=97, gru_hidden=16, dtype=BF16)
    port.load_state_dict(recognition_state_dict_from_jax(variables), strict=True)
    jax_train, _ = jax_make_steps(jax_model)
    jax_state, jm = jax_train(_jax_state(variables), jax_batch, jnp.float32(LR))
    state = create_train_state(port, grad_clip_norm=CLIP)
    train, _ = make_recognition_steps(port)
    state, pm = train(state, port_batch, LR)
    np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=1e-2)
    np.testing.assert_allclose(pm["grad_norm"].item(), float(jm["grad_norm"]), rtol=5e-2)
    assert pm["loss"].dtype == pm["grad_norm"].dtype == torch.float32
    for k, v in jm["grad_norms"].items():
        np.testing.assert_allclose(pm["grad_norms"][k].item(), float(v), rtol=1e-1, err_msg=k)
    # Parameters, gradients and Adam's state stay float32.
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert all(p.grad.dtype == torch.float32 for p in port.parameters())
    assert all(v.dtype == torch.float32 for s in state.optimizer.adam.state.values()
               for k, v in s.items() if k != "step")


# ----------------------------------------------------------------- serving

def test_pipeline_bf16_runs_end_to_end_beside_f32():
    # The masks are not all equal: with random weights a seventh of the
    # pixels have probabilities within 2e-2 of the 0.5 threshold, and the
    # bf16 detection differs from the f32 one by up to ~4e-3, so a few of
    # them (12 of 24,576 here) fall on the other side. Each pixel whose
    # mask differs must be one of those, and they must stay few.
    det_size = (128, 96)
    det_vars = random_variables(JaxDetection(), (1, 64, 64, 1), seed=2)
    rec_vars = random_variables(JaxRecognition(n_classes=97), (1, 64, 32, 1), seed=3)
    f32, bf = (OcrPipeline.from_jax_variables(det_vars, rec_vars, det_size=det_size,
                                              device="cpu", compute_dtype=dt)
               for dt in (torch.float32, BF16))
    assert bf.rec_model.dtype == bf.det_model.dtype == BF16
    images = [SyntheticDetection(size=1, page_size=(256, 192), seed=s)[0]["image"] for s in (0, 1)]
    x = np.stack([resize(img, det_size) for img in images])
    with torch.no_grad():
        p_f32 = f32.det_model(torch.from_numpy(x[..., 0])[:, None])[:, 0].numpy()
    differ = np.unpackbits(bf._det_masks(x) ^ f32._det_masks(x), axis=-1)[..., : det_size[1]] > 0
    assert differ.mean() <= 1e-3
    assert (np.abs(p_f32[differ] - 0.5) <= 2e-2).all()
    pages = bf.run_batch(images, det_batch=2, rec_batch=4)
    assert len(pages) == 2 and sum(len(p) for p in pages) > 0
    for line in (ln for page in pages for ln in page):
        assert isinstance(line.text, str) and np.isfinite(line.box).all()
        assert all(ch in bf.alphabet for ch in line.text)


def test_pipeline_refuses_other_dtypes():
    with pytest.raises(ValueError, match="bfloat16"):
        OcrPipeline(device="cpu", compute_dtype=torch.float16)


# ----------------------------------------------------------------- trainer

SMALL = ["--max-images", "8", "--batch-size", "8", "--max-epochs", "1", "--no-augment"]


@pytest.fixture(scope="module")
def jax_init_bf16(tmp_path_factory):
    """The JAX trainer's initial weights (the same for --bf16 and
    --no-bf16: the dtype does not enter the parameters)."""
    run_dir = tmp_path_factory.mktemp("jax_init_bf16")
    cwd = os.getcwd()
    os.chdir(run_dir)
    try:
        jax_train_rec.main(["synthetic", "-", "--export", "init.pt", "--no-bf16"])
    finally:
        os.chdir(cwd)
    return run_dir / "init.pt"


def _epoch_record(run_dir):
    lines = (run_dir / "text-recognition-metrics.jsonl").read_text().splitlines()
    (rec,) = [r for r in map(json.loads, lines) if "epoch" in r]
    return rec


def test_trainer_bf16_default_matches_jax_bf16(jax_init_bf16, tmp_path, monkeypatch, capsys):
    # Neither side names --bf16: it is both trainers' default.
    args = ["synthetic", "-", *SMALL]
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jax_train_rec.main(args)
    monkeypatch.chdir(tmp_path / "port")
    state = train_rec.main([*args, "--checkpoint", str(jax_init_bf16)], device="cpu")
    capsys.readouterr()
    assert state.model.dtype == BF16 and state.model.gru.compute_dtype == BF16
    want, got = _epoch_record(tmp_path / "jax"), _epoch_record(tmp_path / "port")
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-2)
    assert np.isfinite(got["val_loss"])
    ckpt = torch.load(tmp_path / "port" / "text-rec-checkpoint.pt", weights_only=True)
    assert all(v.dtype in (torch.float32, torch.int64) for v in ckpt["model_state"].values())


@pytest.mark.parametrize("flag,dtype", [("--bf16", BF16), ("--no-bf16", torch.float32)])
def test_trainer_bf16_flag_picks_the_model_dtype(tmp_path, monkeypatch, flag, dtype):
    monkeypatch.chdir(tmp_path)
    state = train_rec.main(["synthetic", "-", *SMALL, flag], device="cpu")
    assert state.model.dtype == dtype and state.step == 1
    rec = _epoch_record(tmp_path)
    assert np.isfinite(rec["train_loss"]) and np.isfinite(rec["val_loss"])
