"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Inputs and weights are made with numpy from a seed and handed to both the
JAX package and the PyTorch port, so the two run on the same numbers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch


def random_variables(model, sample_shape, seed: int):
    """A ``{"params", "batch_stats"}`` tree for a flax ``model`` with the
    structure of ``model.init`` but values drawn with numpy from ``seed``
    (including non-trivial batch-norm statistics). ``jax.eval_shape``
    avoids compiling the init."""
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.key(0), jnp.zeros(sample_shape), train=False)
    )
    rng = np.random.default_rng(seed)

    def fill(path, sd):
        name = str(path[-1].key)
        shape = sd.shape
        if name.startswith(("w_", "b_")):  # GRU: U(-1/sqrt(H), 1/sqrt(H))
            k = 1.0 / np.sqrt(shape[-1] // 3)
            v = rng.uniform(-k, k, shape)
        elif name in ("kernel", "dw_kernel", "pw_kernel"):
            v = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            v = 0.05 * rng.normal(size=shape)
        return np.asarray(v, np.float32)

    return {
        k: jax.tree_util.tree_map_with_path(fill, v)
        for k, v in shapes.items()
        if k in ("params", "batch_stats")
    }


def nhwc_to_nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))
