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
from ocrs_models_torch.ops import BiGRU, gru_recurrence
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
