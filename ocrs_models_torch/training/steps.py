"""Train and eval steps for the CRNN recognizer, the U-Net detector and the
layout transformer.

Counterpart of ``make_recognition_steps``, ``make_detection_steps`` and
``make_layout_steps`` in ``ocrs_models_tpu/training/steps.py``, with their
contract. The learning
rate is an argument of each step; recognition batches may carry padding
rows that ``sample_weight`` zeroes out of the loss (they still enter the
batch-norm batch statistics, as in the JAX package); the loss is
``sum(nll / max(len, 1) * w) / max(sum(w), 1)`` with CTC input lengths
``image_width // downsample``, one less than the model's ``W//4 + 1``
output steps, as the reference trainer does.

The recognition step runs eagerly on the model's device in the model's dtype: float32
convolutions and matmuls kept out of TF32 (the JAX package's
``dtype=float32`` path), or a ``RecognitionModel(dtype=torch.bfloat16)``
(its bf16 path); the log-probs, the CTC loss, the parameters, their
gradients and Adam's state are float32 in both. cuDNN times its algorithms
once per shape (its heuristic picks slow FFT algorithms for the float32
convolutions). Stage 1, the biGRU recurrence and the CTC recursions run
through the port's CUDA kernels, forward and backward, on a CUDA device.
The detection and layout steps run cuDNN convolutions, plain PyTorch
products and the balanced BCE on the device (the JAX detector and layout
model reach no Pallas kernel) in the model's dtype, with TF32 off for
float32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from ..ops.ctc import ctc_loss_forward
from ..ops.losses import balanced_cross_entropy_loss, weighted_bce_with_logits
from .state import TrainState, global_norm


@contextlib.contextmanager
def numerics():
    """Float32 convolutions and matmuls without TF32; cuDNN benchmarks its
    algorithms once per shape."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(
            enabled=True, benchmark=True, deterministic=False, allow_tf32=False
        ):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


def module_names(model: nn.Module) -> dict[str, str]:
    """Each parameter's top-level module under the JAX package's names:
    ``conv.0.weight`` -> ``conv0``, ``conv.4.bias`` -> ``bn4``, ``gru.*``
    -> ``gru``, ``output.0.*`` -> ``output``."""
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "conv":
            kind = "bn" if isinstance(model.conv[int(parts[1])], nn.BatchNorm2d) else "conv"
            out[name] = f"{kind}{parts[1]}"
        else:
            out[name] = parts[0]
    return out


def _to_device(batch: dict, dev: torch.device) -> dict:
    out = {}
    for key in ("image", "text", "text_len", "image_width", "sample_weight"):
        v = batch[key]
        v = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
        out[key] = v.to(dev).contiguous()
    out["image"] = out["image"].float()
    out["sample_weight"] = out["sample_weight"].float()
    return out


def make_recognition_steps(
    model: nn.Module,
    downsample: int = 4,
    mesh=None,
    force_shard_map: bool = False,
    grad_accum: int = 1,
):
    """Build ``(train_step, eval_step)`` for the CRNN recognizer.

    Batch fields (numpy arrays or tensors): ``image`` ``[N, 1, 64, W]``
    float, NCHW (the JAX package takes NHWC ``[N, 64, W, 1]``); ``text``
    ``[N, L]`` int (blank-padded); ``text_len`` ``[N]`` int;
    ``image_width`` ``[N]`` int; ``sample_weight`` ``[N]`` float.

    ``train_step(state, batch, lr) -> (state, metrics)`` updates
    ``state`` in place; metrics are 0-d tensors ``loss`` and ``grad_norm``
    (after the division by the weight sum, before clipping), a dict
    ``grad_norms`` keyed by the JAX module names (``conv0``, ``conv3``,
    ``bn4``, ..., ``gru``, ``output``), and ``preds`` ``[N, T]`` int32.
    ``eval_step(state, batch) -> {"loss", "preds"}`` uses the running
    batch-norm statistics.

    ``grad_accum=k`` splits the batch into ``k`` microbatches with the JAX
    package's STRIDED split (microbatch ``i`` takes samples ``i, i+k,
    ...``), runs them in sequence (batch norm sees each microbatch; its
    running statistics update k times), sums the loss terms and gradients,
    and makes one update; ``preds`` come back in the batch's order.

    ``mesh`` and ``force_shard_map`` (the JAX package's multi-device step)
    are not ported: multi-GPU data parallelism is in ROADMAP.md, Queue 1.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if mesh is not None or force_shard_map:
        raise NotImplementedError(
            "make_recognition_steps: the multi-device step (mesh, shard_map) is not ported; "
            "multi-GPU data parallelism is ROADMAP.md, Queue 1"
        )
    names = module_names(model)

    def device() -> torch.device:
        return next(model.parameters()).device

    def local_parts(batch: dict):
        log_probs = model(batch["image"])
        input_lengths = batch["image_width"] // downsample
        nll = ctc_loss_forward(log_probs, batch["text"], input_lengths, batch["text_len"])
        w = batch["sample_weight"]
        per_sample = nll / batch["text_len"].clamp(min=1)
        return torch.sum(per_sample * w), torch.sum(w), log_probs

    def train_step(state: TrainState, batch: dict, lr: float):
        batch = _to_device(batch, device())
        n = batch["image"].shape[0]
        if n % grad_accum:
            raise ValueError(f"batch size {n} not divisible by grad_accum={grad_accum}")
        model.train()
        state.optimizer.zero_grad()
        num = den = 0.0
        preds = []
        with numerics():
            for i in range(grad_accum):
                mb = {k: v[i::grad_accum] for k, v in batch.items()} if grad_accum > 1 else batch
                mb_num, mb_den, log_probs = local_parts(mb)
                mb_num.backward()
                num = num + mb_num.detach()
                den = den + mb_den
                preds.append(log_probs.detach().argmax(dim=-1).to(torch.int32))
            den = torch.clamp(den, min=1.0)
            grads: dict[str, list] = {}
            for name, p in model.named_parameters():
                if p.grad is not None:
                    p.grad.div_(den)
                    grads.setdefault(names[name], []).append(p.grad)
            grad_norms = {k: global_norm(v) for k, v in grads.items()}
            grad_norm = state.optimizer.step(lr)
        state.step += 1
        if grad_accum > 1:
            merged = preds[0].new_empty((n,) + preds[0].shape[1:])
            for i, p in enumerate(preds):
                merged[i::grad_accum] = p
            preds = merged
        else:
            preds = preds[0]
        metrics = {"loss": num / den, "grad_norm": grad_norm, "grad_norms": grad_norms,
                   "preds": preds}
        return state, metrics

    def eval_step(state: TrainState, batch: dict):
        del state
        batch = _to_device(batch, device())
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad(), numerics():
                num, den, log_probs = local_parts(batch)
        finally:
            model.train(was_training)
        return {"loss": num / torch.clamp(den, min=1.0),
                "preds": log_probs.argmax(dim=-1).to(torch.int32)}

    return train_step, eval_step


# ------------------------------- detection -------------------------------


def detection_module_names(model: nn.Module) -> dict[str, str]:
    """Each parameter's top-level module under the JAX package's names:
    ``down.{i}.*`` -> ``down_{i}``, ``up.{i}.*`` -> ``up_{i}``, ``in_conv.*``
    and ``out_conv.*`` as they are."""
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        out[name] = f"{parts[0]}_{parts[1]}" if parts[0] in ("down", "up") else parts[0]
    return out


def _tensors_to_device(batch: dict, keys: tuple[str, ...], dev: torch.device) -> dict:
    out = {}
    for key in keys:
        if key in batch:
            v = batch[key]
            v = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
            out[key] = v.to(dev).float().contiguous()
    return out


def make_detection_steps(model: nn.Module, grad_accum: int = 1):
    """Build ``(train_step, eval_step)`` for the U-Net detector.

    Batch fields (numpy arrays or tensors): ``image`` and ``mask`` ``[N, 1,
    H, W]`` float, NCHW (the JAX package takes NHWC), optional
    ``sample_weight`` ``[N]``: rows of weight 0 (batch padding) give no
    pixels to the balanced BCE's pools (they still enter the batch-norm
    statistics, as in the JAX package).

    ``train_step(state, batch, lr) -> (state, metrics)`` updates ``state``
    in place; metrics are 0-d tensors ``loss`` and ``grad_norm``, a dict
    ``grad_norms`` keyed by the JAX module names (``in_conv``, ``down_0``
    ... ``up_5``, ``out_conv``) and ``pred`` ``[N, 1, H, W]`` float32
    probabilities, all on the device. There is no gradient clip.
    ``eval_step(state, batch) -> {"loss", "pred"}`` uses the running
    batch-norm statistics.

    ``grad_accum=k`` splits the batch into ``k`` microbatches with the JAX
    package's strided split (microbatch ``i`` takes samples ``i, i+k,
    ...``), runs them in sequence (batch norm sees each microbatch and its
    running statistics update k times), weights each microbatch's loss and
    gradient by its valid count and makes one update. The balanced BCE's
    pools are each microbatch's own.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    names = detection_module_names(model)
    keys = ("image", "mask", "sample_weight")

    def device() -> torch.device:
        return next(model.parameters()).device

    def loss_fn(batch: dict):
        pred = model(batch["image"])
        return balanced_cross_entropy_loss(pred, batch["mask"], batch.get("sample_weight")), pred

    def train_step(state: TrainState, batch: dict, lr: float):
        batch = _tensors_to_device(batch, keys, device())
        n = batch["image"].shape[0]
        if n % grad_accum:
            raise ValueError(f"batch size {n} not divisible by grad_accum={grad_accum}")
        model.train()
        state.optimizer.zero_grad()
        with numerics():
            if grad_accum == 1:
                loss, pred = loss_fn(batch)
                loss.backward()
                loss, pred = loss.detach(), pred.detach()
            else:
                loss = den = 0.0
                pred = torch.empty_like(batch["mask"])
                for i in range(grad_accum):
                    mb = {k: v[i::grad_accum] for k, v in batch.items()}
                    mb_den = (mb["sample_weight"].sum() if "sample_weight" in mb
                              else torch.tensor(float(n // grad_accum), device=pred.device))
                    mb_loss, mb_pred = loss_fn(mb)
                    (mb_loss * mb_den).backward()
                    loss = loss + mb_loss.detach() * mb_den
                    den = den + mb_den
                    pred[i::grad_accum] = mb_pred.detach()
                den = torch.clamp(den, min=1.0)
                loss = loss / den
            grads: dict[str, list] = {}
            for name, p in model.named_parameters():
                if p.grad is not None:
                    if grad_accum > 1:
                        p.grad.div_(den)
                    grads.setdefault(names[name], []).append(p.grad)
            grad_norms = {k: global_norm(v) for k, v in grads.items()}
            grad_norm = state.optimizer.step(lr)
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm, "grad_norms": grad_norms,
                       "pred": pred}

    def eval_step(state: TrainState, batch: dict):
        del state
        batch = _tensors_to_device(batch, keys, device())
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad(), numerics():
                loss, pred = loss_fn(batch)
        finally:
            model.train(was_training)
        return {"loss": loss, "pred": pred}

    return train_step, eval_step


# --------------------------------- layout --------------------------------


def layout_module_names(model: nn.Module) -> dict[str, str]:
    """Each parameter's top-level module under the JAX package's names:
    ``encode.layers.{i}.*`` -> ``layer_{i}``, ``embed.0.*`` / ``embed.2.*``
    -> ``embed0`` / ``embed1``, ``classify.*`` -> ``classify``."""
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "encode":
            out[name] = f"layer_{parts[2]}"
        elif parts[0] == "embed":
            out[name] = f"embed{int(parts[1]) // 2}"
        else:
            out[name] = parts[0]
    return out


def make_layout_steps(model: nn.Module, pos_weight: float = 10.0, grad_accum: int = 1):
    """Build ``(train_step, eval_step)`` for the layout transformer.

    Batch fields (numpy arrays or tensors): ``boxes`` ``[N, W, 4]``,
    ``labels`` ``[N, W, 2]``, optional ``sample_weight`` ``[N]``. Padded
    words carry zero boxes and labels and take part in the loss, as in the
    reference; rows of weight 0 (batch padding) do not.

    ``train_step(state, batch, lr, generator=None) -> (state, metrics)``
    updates ``state`` in place; dropout draws from ``generator`` (on the
    model's device). Metrics are 0-d tensors ``loss`` and ``grad_norm``, a
    dict ``grad_norms`` keyed by the JAX module names (``layer_0`` ...,
    ``classify``) and ``probs`` ``[N, W, 2]``. There is no gradient clip.
    ``eval_step(state, batch) -> {"loss", "probs"}`` runs without dropout.

    ``grad_accum=k`` splits the batch into ``k`` microbatches with the JAX
    package's strided split (microbatch ``i`` takes samples ``i, i+k,
    ...``), weights each microbatch's loss and gradient by its valid count,
    draws each microbatch's dropout in turn from ``generator`` and makes one
    update; the loss is an element mean and the encoder keeps no batch
    statistics, so without dropout this is the full batch's step.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    names = layout_module_names(model)

    def device() -> torch.device:
        return next(model.parameters()).device

    def loss_fn(batch: dict, generator=None):
        logits = model(batch["boxes"], generator)
        loss = weighted_bce_with_logits(logits, batch["labels"], pos_weight,
                                        batch.get("sample_weight"))
        return loss, logits

    def train_step(state: TrainState, batch: dict, lr: float,
                   generator: torch.Generator | None = None):
        batch = _tensors_to_device(batch, ("boxes", "labels", "sample_weight"), device())
        n = batch["boxes"].shape[0]
        if n % grad_accum:
            raise ValueError(f"batch size {n} not divisible by grad_accum={grad_accum}")
        model.train()
        state.optimizer.zero_grad()
        with numerics():
            if grad_accum == 1:
                loss, logits = loss_fn(batch, generator)
                loss.backward()
                loss = loss.detach()
                probs = torch.sigmoid(logits.detach())
            else:
                loss = den = 0.0
                probs = torch.empty(batch["labels"].shape, device=batch["labels"].device)
                for i in range(grad_accum):
                    mb = {k: v[i::grad_accum] for k, v in batch.items()}
                    mb_den = (mb["sample_weight"].sum() if "sample_weight" in mb
                              else torch.tensor(float(n // grad_accum), device=probs.device))
                    mb_loss, logits = loss_fn(mb, generator)
                    (mb_loss * mb_den).backward()
                    loss = loss + mb_loss.detach() * mb_den
                    den = den + mb_den
                    probs[i::grad_accum] = torch.sigmoid(logits.detach())
                den = torch.clamp(den, min=1.0)
                loss = loss / den
            grads: dict[str, list] = {}
            for name, p in model.named_parameters():
                if p.grad is not None:
                    if grad_accum > 1:
                        p.grad.div_(den)
                    grads.setdefault(names[name], []).append(p.grad)
            grad_norms = {k: global_norm(v) for k, v in grads.items()}
            grad_norm = state.optimizer.step(lr)
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm, "grad_norms": grad_norms,
                       "probs": probs}

    def eval_step(state: TrainState, batch: dict):
        del state
        batch = _tensors_to_device(batch, ("boxes", "labels", "sample_weight"), device())
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad(), numerics():
                loss, logits = loss_fn(batch)
        finally:
            model.train(was_training)
        return {"loss": loss, "probs": torch.sigmoid(logits)}

    return train_step, eval_step
