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
from ..parallel.mesh import Mesh2D, all_reduce, pmean, psum
from ..parallel.tp import is_sharded, tp_grad_norms
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


def _training_group(mesh):
    """The process group of a training ``mesh``: one process per device
    (a mesh of several devices in one process serves, it does not train)."""
    if mesh.group is None and mesh.size > 1:
        raise ValueError(f"training on a mesh of {mesh.size} devices needs one process per "
                         "device (parallel.spawn or torchrun); this mesh has no process group")
    return mesh.group


def _psum_with_grads(model: nn.Module, scalars: list, group) -> list:
    """Sum ``scalars`` (0-d float32 tensors) and every parameter's gradient
    across ``group`` in ONE all-reduce; the summed gradients replace
    ``.grad`` (a missing one counts as 0). Returns the summed scalars."""
    params = list(model.parameters())
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    out = psum([t.reshape(1) for t in scalars] + grads, group)
    for p, g in zip(params, out[len(scalars):]):
        p.grad = g
    return [t[0] for t in out[:len(scalars)]]


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

    With a ``mesh`` (``parallel.Mesh``) of size > 1, or ``mesh`` and
    ``force_shard_map=True``, this is the JAX package's ``shard_map`` step:
    each rank runs its own rows (its ``grad_accum`` microbatches too) with
    batch norm over its own rows, then ONE all-reduce sums ``[num, den,
    gradients]`` across the ranks before the division by ``den``, the
    norms, the clip and Adam, and one more averages the batch-norm running
    statistics; ``eval_step`` sums ``num`` and ``den``; ``preds`` stay the
    rank's own. On a mesh without a process group (one process) the
    collectives are the identity, and the step is the plain one bit for
    bit.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    use_collectives = mesh is not None and (mesh.size > 1 or force_shard_map)
    group = _training_group(mesh) if use_collectives else None
    names = module_names(model)
    bn_stats = [t for m in model.modules() if isinstance(m, nn.BatchNorm2d)
                for t in (m.running_mean, m.running_var)]

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
            if use_collectives:
                num, den = _psum_with_grads(model, [num, den], group)
                for t, mean in zip(bn_stats, pmean(bn_stats, group)):
                    t.copy_(mean)
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
                if use_collectives:
                    num, den = psum([num, den], group)
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


def _weighted_train_step(model: nn.Module, names: dict, state: TrainState, batch: dict,
                         lr: float, loss_fn, out_fn, n: int, grad_accum: int, group,
                         norms=None):
    """One update of the detection or layout step: ``loss_fn(mb) -> (loss,
    output)`` over ``grad_accum`` strided microbatches, each microbatch's
    loss and gradient weighted by its valid count (the sum of its
    ``sample_weight``, else its row count) and the sums divided by theirs;
    with a process ``group``, ``loss_fn`` returns this rank's share of the
    loss over every rank's rows, the valid counts are summed across the
    ranks and so are the loss and the gradients (one all-reduce).
    ``norms(model) -> (grad_norm, grad_norms)`` replaces the norms of this
    process's gradients (tensor parallelism). Returns ``(loss,
    output_fn(output) in the batch's order, grad_norm, grad_norms)``."""
    model.train()
    state.optimizer.zero_grad()
    with numerics():
        if grad_accum == 1:
            loss, out = loss_fn(batch)
            loss.backward()
            loss, out = loss.detach(), out_fn(out.detach())
        else:
            if "sample_weight" in batch:
                w = batch["sample_weight"]
                dens = torch.stack([w[i::grad_accum].sum() for i in range(grad_accum)])
            else:
                dens = torch.full((grad_accum,), float(n // grad_accum),
                                  device=next(model.parameters()).device)
            dens = all_reduce(dens, group)
            loss = 0.0
            out = None
            for i in range(grad_accum):
                mb = {k: v[i::grad_accum] for k, v in batch.items()}
                mb_loss, mb_out = loss_fn(mb)
                (mb_loss * dens[i]).backward()
                loss = loss + mb_loss.detach() * dens[i]
                mb_out = out_fn(mb_out.detach())
                if out is None:
                    out = mb_out.new_empty((n,) + mb_out.shape[1:], dtype=torch.float32)
                out[i::grad_accum] = mb_out
        if group is not None:
            (loss,) = _psum_with_grads(model, [loss], group)
        if grad_accum > 1:
            den = torch.clamp(dens.sum(), min=1.0)
            loss = loss / den
        grads: dict[str, list] = {}
        for name, p in model.named_parameters():
            if p.grad is not None:
                if grad_accum > 1:
                    p.grad.div_(den)
                grads.setdefault(names[name], []).append(p.grad)
        if norms is None:
            grad_norms = {k: global_norm(v) for k, v in grads.items()}
            grad_norm = state.optimizer.step(lr)
        else:
            grad_norm, grad_norms = norms(model)
            state.optimizer.step(lr, grad_norm)
    state.step += 1
    return loss, out, grad_norm, grad_norms


def _eval(model: nn.Module, loss_fn, group):
    """``loss_fn()`` in eval mode without gradients, the mode restored
    after; with a process ``group`` the loss shares summed across it."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), numerics():
            loss, out = loss_fn()
            if group is not None:
                (loss,) = psum([loss], group)
    finally:
        model.train(was_training)
    return loss, out


def make_detection_steps(model: nn.Module, grad_accum: int = 1, mesh=None):
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

    ``mesh``: a ``parallel.Mesh`` whose process group's ranks each pass
    their slice of the batch; the step is then the JAX step's over the
    whole sharded batch (GSPMD): batch norm with the whole batch's
    statistics, the balanced BCE over every rank's pixels, the gradients
    summed, and a rank's microbatch ``i`` with the others' microbatches
    ``i`` is the JAX step's microbatch ``i``. ``pred`` stays the rank's
    own. A mesh without a process group (one process) is the plain step.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    group = _training_group(mesh) if mesh is not None else None
    names = detection_module_names(model)
    keys = ("image", "mask", "sample_weight")

    def device() -> torch.device:
        return next(model.parameters()).device

    def loss_fn(batch: dict):
        pred = model(batch["image"], mesh)
        loss = balanced_cross_entropy_loss(pred, batch["mask"], batch.get("sample_weight"), group)
        return loss, pred

    def train_step(state: TrainState, batch: dict, lr: float):
        batch = _tensors_to_device(batch, keys, device())
        n = batch["image"].shape[0]
        if n % grad_accum:
            raise ValueError(f"batch size {n} not divisible by grad_accum={grad_accum}")
        loss, pred, grad_norm, grad_norms = _weighted_train_step(
            model, names, state, batch, lr, loss_fn, lambda p: p, n, grad_accum, group)
        return state, {"loss": loss, "grad_norm": grad_norm, "grad_norms": grad_norms,
                       "pred": pred}

    def eval_step(state: TrainState, batch: dict):
        del state
        batch = _tensors_to_device(batch, keys, device())
        loss, pred = _eval(model, lambda: loss_fn(batch), group)
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


def make_layout_steps(model: nn.Module, pos_weight: float = 10.0, grad_accum: int = 1,
                      mesh=None):
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

    ``mesh``: a ``parallel.Mesh`` whose process group's ranks each pass
    their slice of the batch; the step is then the JAX step's over the
    whole sharded batch: the weighted BCE's sum and count over every rank's
    rows and the gradients summed. Each rank draws its dropout from its own
    ``generator`` (seed it per rank: one seed on every rank would repeat
    one mask). A mesh without a process group (one process) is the plain
    step.

    A ``parallel.Mesh2D`` (data x model) runs the tensor-parallel step of
    the JAX package's ``layout_tp_state_shardings``: ``model`` split by
    ``parallel.tp.shard_layout_model`` over the mesh (before its train
    state is built), each data shard's rows passed to the ``mp`` ranks
    that hold it, the loss sums and gradients summed over the data group,
    the norms (and a clip by the global norm) those of the unsharded
    gradients. Seed ``generator`` per
    data shard, alike in a model group (its ranks must drop the same
    replicated units).
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    names = layout_module_names(model)
    norms = None
    if isinstance(mesh, Mesh2D):
        if mesh.mp > 1 and not is_sharded(model):
            raise ValueError("a data x model mesh needs the model split by "
                             "parallel.tp.shard_layout_model first")
        group = mesh.data_group
        norms = lambda m: tp_grad_norms(m, names, mesh.model_group)  # noqa: E731
    else:
        group = _training_group(mesh) if mesh is not None else None
    keys = ("boxes", "labels", "sample_weight")

    def device() -> torch.device:
        return next(model.parameters()).device

    def loss_fn(batch: dict, generator=None):
        logits = model(batch["boxes"], generator)
        loss = weighted_bce_with_logits(logits, batch["labels"], pos_weight,
                                        batch.get("sample_weight"), group)
        return loss, logits

    def train_step(state: TrainState, batch: dict, lr: float,
                   generator: torch.Generator | None = None):
        batch = _tensors_to_device(batch, keys, device())
        n = batch["boxes"].shape[0]
        if n % grad_accum:
            raise ValueError(f"batch size {n} not divisible by grad_accum={grad_accum}")
        loss, probs, grad_norm, grad_norms = _weighted_train_step(
            model, names, state, batch, lr, lambda mb: loss_fn(mb, generator), torch.sigmoid,
            n, grad_accum, group, norms)
        return state, {"loss": loss, "grad_norm": grad_norm, "grad_norms": grad_norms,
                       "probs": probs}

    def eval_step(state: TrainState, batch: dict):
        del state
        batch = _tensors_to_device(batch, keys, device())
        loss, logits = _eval(model, lambda: loss_fn(batch), group)
        return {"loss": loss, "probs": torch.sigmoid(logits)}

    return train_step, eval_step
