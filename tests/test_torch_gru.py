"""Port's biGRU recurrence and ``BiGRU`` module vs the JAX package's
``gru_recurrence4`` (Pallas, interpret mode on CPU), its ``BiGRU`` on both
backends, and torch's own ``nn.GRU``, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrs_models_tpu.ops.gru import BiGRU as JaxBiGRU
from ocrs_models_tpu.ops.pallas.gru_kernel4 import gru_recurrence4
from ocrs_models_torch.ops import (
    BiGRU,
    gru_bwd_phases_reference,
    gru_bwd_reference,
    gru_recurrence,
    gru_recurrence_reference,
)
from ocrs_models_torch.weights import bigru_state_dict_from_jax


def _case(t, n=8, h=16, seed=0):
    rng = np.random.default_rng(seed)
    px_f = rng.normal(size=(t, n, 3 * h)).astype(np.float32)
    px_b = rng.normal(size=(t, n, 3 * h)).astype(np.float32)
    w = (rng.normal(size=(2, h, 3 * h)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(2, 3 * h)) * 0.1).astype(np.float32)
    return px_f, px_b, w, b


@pytest.mark.parametrize("t", [1, 7, 33])
def test_recurrence_matches_pallas(t):
    args = _case(t)
    want_f, want_b = gru_recurrence4(*map(jnp.asarray, args), jnp.float32, True)
    got_f, got_b = gru_recurrence(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=0, atol=1e-5)


def _jax_bigru(backend, hidden=16, layers=2, feat=12, n=3, t=9, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, t, feat)).astype(np.float32)
    mod = JaxBiGRU(hidden, layers, compute_dtype=jnp.float32, backend=backend)
    params = mod.init(jax.random.key(seed), jnp.asarray(xs))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return mod, params, xs


def _port_bigru(params, feat=12, hidden=16, layers=2):
    m = BiGRU(feat, hidden, layers)
    m.load_state_dict(bigru_state_dict_from_jax(params), strict=True)
    return m


@pytest.mark.parametrize("backend", ["scan", "pallas4"])
def test_bigru_matches_jax(backend):
    mod, params, xs = _jax_bigru(backend)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(xs)))
    with torch.no_grad():
        got = _port_bigru(params)(torch.from_numpy(xs)).numpy()
    assert got.shape == want.shape == (3, 9, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_bigru_matches_nn_gru():
    _, params, xs = _jax_bigru("scan", seed=1)
    port = _port_bigru(params)
    ref = torch.nn.GRU(12, 16, num_layers=2, bidirectional=True, batch_first=True)
    ref.load_state_dict(port.state_dict(), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(xs))
        want, _ = ref(torch.from_numpy(xs))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("t", [1, 7, 33])
def test_recurrence_gradients_match_pallas_vjp(t):
    # The port's backward on CPU (autograd of the plain recurrence, the
    # twin of gru_bwd.cu) against gru_recurrence4's Pallas backward in
    # interpret mode. Tolerance atol 1e-5: float32, cotangents of order 1
    # summed over up to 33 steps.
    args = _case(t, seed=4)
    rng = np.random.default_rng(5)
    dys = [rng.normal(size=(t, 8, 16)).astype(np.float32) for _ in range(2)]
    _, vjp = jax.vjp(lambda *a: gru_recurrence4(*a, jnp.float32, True), *map(jnp.asarray, args))
    want = vjp(tuple(map(jnp.asarray, dys)))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in args]
    outs = gru_recurrence(*ins)
    torch.autograd.backward(outs, [torch.from_numpy(d) for d in dys])
    for name, a, w in zip(("dpx_f", "dpx_b", "dw_hh", "db_hh"), ins, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("t", [1, 7, 33])
def test_backward_phases_match_autograd_and_pallas_vjp(t):
    # The backward as gru_bwd.cu computes it (coefficients over all rows,
    # then the chain, then the dW reduction), composed from the phases'
    # plain versions, against autograd of the plain recurrence and against
    # gru_recurrence4's Pallas backward in interpret mode. Tolerance atol
    # 1e-5: float32, cotangents of order 1 carried over up to 33 steps and
    # summed over up to 33 * 8 rows in another order.
    args = _case(t, seed=6)
    rng = np.random.default_rng(7)
    dys = [rng.normal(size=(t, 8, 16)).astype(np.float32) for _ in range(2)]
    _, vjp = jax.vjp(lambda *a: gru_recurrence4(*a, jnp.float32, True), *map(jnp.asarray, args))
    want_jax = vjp(tuple(map(jnp.asarray, dys)))
    px_f, px_b, w, b = map(torch.from_numpy, args)
    dy_f, dy_b = map(torch.from_numpy, dys)
    ys_f, ys_b = gru_recurrence_reference(px_f, px_b, w, b)
    got = gru_bwd_phases_reference(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w, b)
    want = gru_bwd_reference(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w, b)
    for name, g, a, j in zip(("dpx_f", "dpx_b", "dw_hh", "db_hh"), got, want, want_jax):
        assert g.shape == a.shape, name
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("t,n,h", [(2, 3, 8), (5, 17, 48)])
def test_backward_phases_match_autograd_at_ragged_shapes(t, n, h):
    # The shapes the kernel masks (N not a multiple of 16, H not of 32),
    # in float64 so that only the algebra is compared: atol 1e-12.
    rng = np.random.default_rng(t + n + h)
    px_f, px_b = (torch.from_numpy(rng.normal(size=(t, n, 3 * h))) for _ in range(2))
    w = torch.from_numpy(rng.normal(size=(2, h, 3 * h)) * 0.3)
    b = torch.from_numpy(rng.normal(size=(2, 3 * h)) * 0.1)
    dy_f, dy_b = (torch.from_numpy(rng.normal(size=(t, n, h))) for _ in range(2))
    ys_f, ys_b = gru_recurrence_reference(px_f, px_b, w, b)
    got = gru_bwd_phases_reference(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w, b)
    want = gru_bwd_reference(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w, b)
    for name, g, a in zip(("dpx_f", "dpx_b", "dw_hh", "db_hh"), got, want):
        torch.testing.assert_close(g, a, rtol=0, atol=1e-12, msg=name)
