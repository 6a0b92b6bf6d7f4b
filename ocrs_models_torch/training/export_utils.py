"""Weight export for the trainer CLI (the port's counterpart of
``ocrs_models_tpu/training/export_utils.py``).

``.pt`` writes a reference-format checkpoint ``{epoch, model_state,
optimizer_state: {}}``: the port's state dicts already use the reference's
keys and layouts. ``.npz`` and ``.onnx`` are not ported yet (ROADMAP.md,
Queue 1 item 8).
"""

from __future__ import annotations

import torch

from .state import TrainState

MODELS = ("detection", "recognition", "layout")


def export_weights(state: TrainState, path: str, model: str = "recognition", epoch: int = 0) -> None:
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r} (use one of {MODELS})")
    if path.endswith(".pt"):
        sd = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
        torch.save({"epoch": epoch, "model_state": sd, "optimizer_state": {}}, path)
        print(f"Exported reference-format checkpoint to {path}")
        return
    if path.endswith((".npz", ".onnx")):
        raise NotImplementedError(
            f"export to {path}: .npz and .onnx export are not ported yet "
            "(ROADMAP.md, Queue 1 item 8, export); use .pt")
    raise ValueError(f"Unknown export format for {path} (use .npz, .pt or .onnx)")
