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


def patch_bf16_dots_in_f32(monkeypatch):
    """This CPU's XLA runtime has no bf16 x bf16 -> f32 dot (``DotThunk``),
    which the JAX package's bf16 detection (the pointwise convs) asks for
    through ``jnp.einsum(..., preferred_element_type=jnp.float32)``. For the
    test's duration such an einsum takes its bf16 operands as float32: the
    same function, since a product of two bf16 values is exact in f32 and
    the sum is f32 either way. The JAX package itself is not changed."""
    einsum = jnp.einsum

    def einsum_f32(subscripts, *operands, preferred_element_type=None, **kwargs):
        if preferred_element_type == jnp.float32:
            operands = [o.astype(jnp.float32) if getattr(o, "dtype", None) == jnp.bfloat16 else o
                        for o in operands]
        return einsum(subscripts, *operands, preferred_element_type=preferred_element_type,
                      **kwargs)

    monkeypatch.setattr(jnp, "einsum", einsum_f32)


def use_geometry_backend(name: str, monkeypatch) -> None:
    """Both packages' host geometry on one backend for the test's duration:
    ``"numpy"`` (their numpy versions) or ``"native"`` (their C++ cores;
    skips where no C++ toolchain builds them). The JAX package compiles its
    library in place, so a process that loaded it while another process was
    writing it has fallen back to numpy; the native case loads it again,
    once the file is whole."""
    import time

    import pytest

    from ocrs_models_tpu.geometry import native as jax_native
    from ocrs_models_torch.geometry import native

    if name == "numpy":
        monkeypatch.setattr(jax_native, "_lib", None)
        for mod in (jax_native, native):
            monkeypatch.setattr(mod, "_load_failed", True)
        return
    if native.get_lib() is None:
        pytest.skip("no C++ toolchain: the port's geometry core cannot be built here")
    monkeypatch.delenv("OCRS_TPU_NO_NATIVE", raising=False)
    deadline = time.monotonic() + 120
    while True:
        monkeypatch.setattr(jax_native, "_load_failed", False)
        if jax_native.get_lib() is not None:
            return
        if time.monotonic() > deadline:
            pytest.skip("the JAX package's geometry core did not load")
        time.sleep(0.5)


def assert_export_equals_jax(path, model: str, sd) -> None:
    """A port trainer's ``--export`` file (``.onnx`` or ``.npz``) equals
    what the JAX package writes from the reference state dict ``sd``: the
    GraphProto byte for byte (JAX's builder at its defaults, detection at
    800x600) and passing the port's checker, or the archive's keys in order
    with bit-equal arrays (JAX's ``import_*_state_dict`` flattened as its
    ``export_weights`` flattens)."""
    from pathlib import Path

    from ocrs_models_tpu.export import onnx_graph as jax_graph
    from ocrs_models_tpu.export import torch_import
    from ocrs_models_tpu.training.export_utils import _flatten as jax_flatten
    from ocrs_models_torch.export.onnx_check import check_bytes
    from ocrs_models_torch.export.onnx_proto import _parse_fields

    path = Path(path)
    sd = {k: v.numpy() for k, v in sd.items()}
    if path.suffix == ".onnx":
        data = path.read_bytes()
        check_bytes(data)
        want = getattr(jax_graph, f"build_{model}_onnx")(sd)
        graph = {f: v for f, _, v in _parse_fields(data)}[7]
        assert graph == {f: v for f, _, v in _parse_fields(want)}[7]
        return
    variables = getattr(torch_import, f"import_{model}_state_dict")(sd)
    want = jax_flatten(variables["params"], "params/")
    if variables.get("batch_stats"):
        want.update(jax_flatten(variables["batch_stats"], "batch_stats/"))
    got = np.load(path)
    assert got.files == list(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and got[key].tobytes() == value.tobytes(), key
