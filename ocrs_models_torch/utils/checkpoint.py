"""Training checkpoints as reference-format ``.pt`` files.

The JAX package writes Orbax directories; the port writes what the
reference's torch trainers write, ``{"epoch", "model_state",
"optimizer_state"}``, plus ``"step"``: the model's state dict (weights and
batch-norm buffers), Adam's state dict (moments and step counts) and the
train state's step. ``epoch`` is the next epoch to run, so a resumed run
repeats no epoch. A file whose ``optimizer_state`` is ``{}`` (what
``--export x.pt`` writes, in both packages) loads as its weights, its
epoch and a fresh Adam, so a model trained by the JAX package continues
here.
"""

from __future__ import annotations

import os

import torch

from ..training.state import TrainState


def save_checkpoint(path: str, state: TrainState, epoch: int) -> str:
    """Write ``state`` to ``path`` atomically (a temporary file in the same
    directory, then ``os.replace``)."""
    payload = {
        "epoch": int(epoch),
        "model_state": state.model.state_dict(),
        "optimizer_state": state.optimizer.adam.state_dict(),
        "step": int(state.step),
    }
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load_checkpoint(path: str, state: TrainState) -> tuple[TrainState, int]:
    """Restore ``state`` in place from ``path``; returns ``(state, epoch)``."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(ckpt["model_state"], strict=True)
    if ckpt.get("optimizer_state"):
        state.optimizer.adam.load_state_dict(ckpt["optimizer_state"])
    state.step = int(ckpt.get("step", 0))
    return state, int(ckpt.get("epoch", 0))
