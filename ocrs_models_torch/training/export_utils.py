"""Weight export for the trainer CLIs and the ``convert`` CLI (the port's
counterpart of ``ocrs_models_tpu/training/export_utils.py``).

``--export`` writes, by extension:

- ``.npz``: the JAX package's variable tree, flattened to
  ``params/<path>`` and ``batch_stats/<path>`` keys in ``jax.tree_util``'s
  order (dict keys sorted at every level), ``batch_stats`` left out when
  empty (the layout model): the same archive the JAX package writes for
  the same weights.
- ``.pt``: a reference-format checkpoint ``{epoch, model_state,
  optimizer_state: {}}``; the port's state dicts already use the
  reference's keys and layouts.
- ``.onnx``: first-party ONNX emission (no ``onnx`` package) with the
  reference's input/output names, dynamic axes and opset 16
  (:mod:`ocrs_models_torch.export.onnx_graph`), gated on the independent
  spec checker before anything is written.

The graph's sizes (the biGRU's hidden size; the layout model's width,
heads, layers, position embedding and ``return_probs``) are read from the
model; ``model_kwargs`` override them and pass on to the graph builder, as
in the JAX package. The detection graph is built at 800x600 unless
``height`` and ``width`` are given. Export runs on the host: the state dict
is copied to the CPU and turned into numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import weights
from .state import TrainState

MODELS = ("detection", "recognition", "layout")


def _flatten(tree: dict, prefix: str) -> dict[str, np.ndarray]:
    """``{prefix + "a/b/c": leaf}`` with dict keys sorted at every level,
    the order of ``jax.tree_util.tree_flatten_with_path``."""
    out = {}
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def read_npz(path: str) -> dict:
    """An exported ``.npz`` back as the nested variable tree
    (``{"params": ..., "batch_stats": ...}``)."""
    tree: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            *parents, leaf = key.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = flat[key]
    return tree


def jax_variables(model: str, module: torch.nn.Module, sd: dict) -> dict:
    """The JAX package's variable tree for ``module``'s state dict ``sd``."""
    if model == "detection":
        return weights.jax_variables_from_detection_state_dict(sd, len(module.down))
    if model == "recognition":
        return weights.jax_variables_from_recognition_state_dict(sd, module.gru.layers)
    return weights.jax_variables_from_layout_state_dict(
        sd, len(module.encode.layers), module.pos_embedding)


def builder_kwargs(model: str, module: torch.nn.Module) -> dict:
    """The graph builder's sizes as ``module`` has them."""
    if model == "recognition":
        return {"hidden": module.gru.hidden}
    if model == "layout":
        return {
            "d_model": module.d_model,
            "n_heads": module.encode.layers[0].n_heads,
            "n_layers": len(module.encode.layers),
            "pos_embedding": module.pos_embedding,
            "return_probs": module.return_probs,
        }
    return {}


def onnx_bytes(model: str, sd: dict, **model_kwargs) -> bytes:
    """The spec-checked ONNX ``ModelProto`` of the numpy state dict ``sd``."""
    from ..export import onnx_graph
    from ..export.onnx_check import check_bytes

    builder = {
        "detection": onnx_graph.build_detection_onnx,
        "recognition": onnx_graph.build_recognition_onnx,
        "layout": onnx_graph.build_layout_onnx,
    }[model]
    data = builder(sd, **model_kwargs)
    # Gate every emitted file on the independent spec checker
    # (export/onnx_check.py) so a convention bug can never ship.
    check_bytes(data)
    return data


def export_weights(state: TrainState, path: str, model: str = "recognition", epoch: int = 0,
                   **model_kwargs) -> None:
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r} (use one of {MODELS})")
    if not path.endswith((".npz", ".pt", ".onnx")):
        raise ValueError(f"Unknown export format for {path} (use .npz, .pt or .onnx)")
    sd = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    if path.endswith(".pt"):
        torch.save({"epoch": epoch, "model_state": sd, "optimizer_state": {}}, path)
        print(f"Exported reference-format checkpoint to {path}")
        return

    if path.endswith(".npz"):
        variables = jax_variables(model, state.model, sd)
        flat = _flatten(variables["params"], "params/")
        if variables.get("batch_stats"):
            flat.update(_flatten(variables["batch_stats"], "batch_stats/"))
        np.savez(path, **flat)
        print(f"Exported {len(flat)} arrays to {path}")
        return

    data = onnx_bytes(model, {k: v.numpy() for k, v in sd.items()},
                      **{**builder_kwargs(model, state.model), **model_kwargs})
    with open(path, "wb") as f:
        f.write(data)
    print(f"Exported ONNX model to {path} (first-party emission, opset 16, spec-checked)")
