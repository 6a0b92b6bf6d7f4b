"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Inputs and weights are made with numpy from a seed and handed to both the
JAX package and the PyTorch port, so the two run on the same numbers.
"""

from __future__ import annotations

import types

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import torch

import ocrs_models_tpu.models.layout as jax_layout


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


def layout_variables(model, seed: int):
    """``random_variables`` for a flax ``LayoutModel``, with each layer's
    ``qkv_kernel`` drawn at the scale of a dense kernel (N(0, 1/d)), so
    that attention is far from uniform."""
    variables = random_variables(model, (1, 8, 4), seed)
    rng = np.random.default_rng(seed + 1000)
    for name, lp in variables["params"].items():
        if name.startswith("layer_"):
            shape = lp["qkv_kernel"].shape
            lp["qkv_kernel"] = rng.normal(0.0, 1.0 / np.sqrt(shape[0]), shape).astype(np.float32)
    return variables


def patch_jax_dropout(monkeypatch):
    """Dropout at rate 0 in ``ocrs_models_tpu.models.layout`` for the
    test's duration, through that module's ``nn`` name: flax's ``Dropout``
    and the JAX package stay as they are. Dropout's random stream cannot be
    matched across the two packages, so the training parity tests take it
    out on both sides."""
    dropout = flax_nn.Dropout

    def no_dropout(rate, deterministic=None, **kwargs):
        return dropout(0.0, deterministic=True, **kwargs)

    patched = types.SimpleNamespace(**{k: getattr(flax_nn, k) for k in dir(flax_nn)
                                       if not k.startswith("__")})
    patched.Dropout = no_dropout
    monkeypatch.setattr(jax_layout, "nn", patched)


def no_port_dropout(model: torch.nn.Module) -> torch.nn.Module:
    """Dropout at p=0 in the port's layout model (its ``Dropout`` modules)."""
    from ocrs_models_torch.models.layout import Dropout

    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model
