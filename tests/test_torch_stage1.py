"""Port's recognition stage 1 (conv 1->32 + bias, ReLU, 2x2 max-pool) vs the
JAX package's ``stage1_fused`` (Pallas, interpret mode on CPU) and its XLA
reference, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrs_models_tpu.ops.pallas.stage1_kernel import _reference_stage1, stage1_fused
from ocrs_models_torch.ops import stage1
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
