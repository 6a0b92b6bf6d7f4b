"""Port's recognition stage 1 (conv 1->32 + bias, ReLU, 2x2 max-pool) vs the
JAX package's ``stage1_fused`` (Pallas, interpret mode on CPU) and its XLA
reference, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrs_models_tpu.ops.pallas.stage1_kernel import _reference_stage1, stage1_fused
from ocrs_models_torch.ops import stage1, stage1_bwd_reference
from torch_port_common import nhwc_to_nchw


def _case(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (n, h, w, 1)).astype(np.float32)
    k = rng.normal(0, 0.3, (3, 3, 1, 32)).astype(np.float32)
    b = rng.normal(0, 0.1, (32,)).astype(np.float32)
    return x, k, b


def _port(x, k, b):
    weight = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    return stage1(nhwc_to_nchw(x), weight, torch.from_numpy(b)).numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 16, 8), (3, 32, 12)])
def test_matches_pallas_and_reference(shape):
    x, k, b = _case(*shape)
    y = _port(x, k, b)
    y_pallas = np.asarray(stage1_fused(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), True, jnp.float32))
    y_ref = np.asarray(_reference_stage1(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), jnp.float32))
    np.testing.assert_allclose(y, y_pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 64, 13), (1, 15, 10)])
def test_odd_sizes_floor_like_reference(shape):
    # The Pallas kernel takes H % 16 == 0 and even W only; the port's stage
    # 1 floors odd sizes like the JAX package's XLA path.
    x, k, b = _case(*shape, seed=1)
    y_ref = np.asarray(_reference_stage1(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), jnp.float32))
    np.testing.assert_allclose(_port(x, k, b), y_ref, rtol=0, atol=1e-5)


def _grads_jax(x, k, b, dy):
    _, vjp = jax.vjp(lambda xx, kk, bb: stage1_fused(xx, kk, bb, True, jnp.float32),
                     jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    dx, dk, db = vjp(jnp.asarray(dy))
    return np.asarray(dx), np.asarray(dk), np.asarray(db)


def _grads_port(x, k, b, dy):
    xt = nhwc_to_nchw(x).requires_grad_(True)
    wt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))).requires_grad_(True)
    bt = torch.from_numpy(b.copy()).requires_grad_(True)
    stage1(xt, wt, bt).backward(nhwc_to_nchw(dy))
    return (xt.grad.numpy().transpose(0, 2, 3, 1), wt.grad.numpy().transpose(2, 3, 1, 0),
            bt.grad.numpy())


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tied-windows"])
@pytest.mark.parametrize("shape", [(2, 16, 16), (3, 32, 12)])
def test_gradients_match_pallas_vjp(shape, ties):
    # dW and db against the Pallas backward (interpret mode), dx against
    # the JAX package's XLA reference VJP. "tied-windows" zeroes the image
    # right of a column, so every pool window there holds four equal
    # pre-activations (the bias): the first one in window order takes dy,
    # and only where the bias is > 0. Tolerance atol 1e-5 (float32 sums
    # of at most 3*32*12 products).
    x, k, b = _case(*shape, seed=2)
    if ties:
        x[:, :, shape[2] // 2 :, :] = 0.0
        b[::2] = np.abs(b[::2]) + 0.1
        b[1::2] = -np.abs(b[1::2]) - 0.1
    dy = np.random.default_rng(3).normal(size=(shape[0], shape[1] // 2, shape[2] // 2, 32))
    dy = dy.astype(np.float32)
    got = _grads_port(x, k, b, dy)
    want = _grads_jax(x, k, b, dy)
    for name, g, w in zip(("dx", "dkernel", "dbias"), got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("shape", [(2, 64, 132), (1, 16, 260)])
def test_bwd_reference_matches_pallas_vjp_at_widths_off_every_tile(shape):
    # stage1_bwd_reference, the plain version the CUDA backward is held to,
    # against the Pallas backward (interpret mode) at pooled widths (66,
    # 130) that are no multiple of the kernel's 32-column tile. float32;
    # the sums run over up to 2 * 32 * 66 windows, in another order:
    # 1e-4 of the largest |dW|.
    x, k, b = _case(*shape, seed=4)
    dy = np.random.default_rng(5).normal(size=(shape[0], shape[1] // 2, shape[2] // 2, 32))
    dy = dy.astype(np.float32)
    weight = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    dw, db = stage1_bwd_reference(nhwc_to_nchw(x), weight, torch.from_numpy(b), nhwc_to_nchw(dy))
    _, want_dk, want_db = _grads_jax(x, k, b, dy)
    assert dw.shape == (32, 1, 3, 3) and db.shape == (32,)
    atol = 1e-4 * np.abs(want_dk).max()
    np.testing.assert_allclose(dw.numpy().transpose(2, 3, 1, 0), want_dk, rtol=0, atol=atol)
    np.testing.assert_allclose(db.numpy(), want_db, rtol=0, atol=atol)
