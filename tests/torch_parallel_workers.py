"""Rank functions of the port's data-parallel tests (tests/test_torch_parallel_*.py),
run by ``ocrs_models_torch.parallel.spawn`` in processes of their own.

They import the port and nothing of JAX: the tests hand them numpy weights
and batches and compare what they return with the JAX package's results
in the test's own process.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ocrs_models_torch.models import DetectionModel, LayoutModel, RecognitionModel
from ocrs_models_torch.models.layout import Dropout
from ocrs_models_torch.ops.losses import balanced_cross_entropy_loss
from ocrs_models_torch.parallel import create_mesh, shard_batch
from ocrs_models_torch.training.state import create_train_state
from ocrs_models_torch.training.steps import (
    make_detection_steps,
    make_layout_steps,
    make_recognition_steps,
)

MODELS = {"recognition": RecognitionModel, "detection": DetectionModel, "layout": LayoutModel}
STEPS = {"recognition": make_recognition_steps, "detection": make_detection_steps,
         "layout": make_layout_steps}


def _numpy(metrics: dict) -> dict:
    out = {}
    for k, v in metrics.items():
        if isinstance(v, dict):
            out[k] = {kk: float(vv) for kk, vv in v.items()}
        elif v.dim() == 0:
            out[k] = float(v)
        else:
            out[k] = v.float().cpu().numpy()
    return out


def state_dict_numpy(model: torch.nn.Module) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


def digest(model: torch.nn.Module) -> str:
    """A hash of every parameter's and buffer's bytes."""
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _train(kind, model_kwargs, state_dict, batch, steps, lr, step_kwargs, clip, device, mesh):
    model = MODELS[kind](**model_kwargs)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()}, strict=True)
    model.to(device)
    for m in model.modules():  # dropout's stream cannot match JAX's: off
        if isinstance(m, Dropout):
            m.p = 0.0
    state = create_train_state(model, grad_clip_norm=clip)
    train, eval_step = STEPS[kind](model, mesh=mesh, **step_kwargs)
    out = {"metrics": []}
    for i in range(steps):
        state, m = train(state, batch, lr)
        out["metrics"].append(_numpy(m))
        if i == 0:
            out["first"] = state_dict_numpy(model)
    out["last"] = state_dict_numpy(model)
    out["digest"] = digest(model)
    return out, state, eval_step


def run_steps(rank, world, device, kind: str, model_kwargs: dict, state_dict: dict,
              batch: dict, steps: int, lr: float, step_kwargs: dict, clip=None,
              evaluate: bool = False) -> dict:
    """``steps`` train steps of ``kind`` on this rank's contiguous shard of
    the global ``batch`` (``shard_batch``), from ``state_dict``; returns
    each step's metrics, the state dict after the first and the last step,
    a digest of the last, and with ``evaluate`` the eval step's output."""
    mesh = create_mesh(devices=[device])
    local = shard_batch(batch, mesh)[0]
    out, state, eval_step = _train(kind, model_kwargs, state_dict, local, steps, lr,
                                   step_kwargs, clip, device, mesh)
    out["rank"] = rank
    if evaluate:
        out["eval"] = _numpy(eval_step(state, local))
    return out


def plain_and_collective(rank, world, device, kind: str, model_kwargs: dict, state_dict: dict,
                         batch: dict, steps: int, lr: float, step_kwargs: dict,
                         clip=None) -> tuple[dict, dict]:
    """In one rank: ``steps`` plain steps (no mesh) and ``steps`` steps over
    the process group's mesh with ``step_kwargs``, from the same weights
    on the same tensors (float sums on the CPU can depend on where the
    operands lie in memory, so both runs see the same ones)."""
    mesh = create_mesh(devices=[device])
    local = shard_batch(batch, mesh)[0]
    plain = _train(kind, model_kwargs, state_dict, local, steps, lr, {}, clip, device, None)[0]
    mesh_run = _train(kind, model_kwargs, state_dict, local, steps, lr, step_kwargs, clip,
                      device, mesh)[0]
    return plain, mesh_run


def balanced_bce_rank(rank, world, device, pred: np.ndarray, target: np.ndarray,
                      weight) -> dict:
    """This rank's contiguous slice of the batch through the balanced BCE
    over the process group: its share of the loss and its slice's
    gradient."""
    mesh = create_mesh(devices=[device])
    n = pred.shape[0] // world
    lo = rank * n
    p = torch.from_numpy(pred[lo:lo + n].copy()).requires_grad_()
    w = None if weight is None else torch.from_numpy(weight[lo:lo + n].copy())
    share = balanced_cross_entropy_loss(p, torch.from_numpy(target[lo:lo + n].copy()), w,
                                        mesh.group)
    share.backward()
    return {"share": float(share), "grad": p.grad.numpy()}


def run_trainer(rank, world, device, module: str, argv: list, dropout: bool = True) -> dict:
    """A trainer's ``main(argv)`` joining this rank's process group, as it
    does under ``torchrun``; returns the digest of its final model, its
    step and, from rank 0, its state dict. ``dropout=False`` takes the
    layout model's dropout out (so that runs on different numbers of ranks
    can be compared)."""
    import importlib

    if not dropout:
        Dropout.forward = lambda self, x, generator=None, part=(0, 1): x
    trainer = importlib.import_module(f"ocrs_models_torch.training.{module}")
    state = trainer.main(argv, device=device)
    return {"digest": digest(state.model), "step": state.step,
            "state": state_dict_numpy(state.model) if rank == 0 else None}


def world1_recognition_rank(rank, world, device) -> dict:
    """The recognizer's collective step (``force_shard_map=True``) on the
    process group of this one rank (NCCL on a card) against its plain
    step, two steps each from the same weights on the same batch, under
    deterministic algorithms (cuDNN's default choices are not bit-stable
    from run to run): whether losses and state dicts are bit-equal."""
    import copy
    import os

    import torch.distributed as dist

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    mesh = create_mesh()
    rng = np.random.default_rng(0)
    n, w = 32, 128
    text = np.zeros((n, 32), np.int64)
    text[:, :12] = rng.integers(1, 97, (n, 12))
    batch = {"image": rng.uniform(-0.5, 0.5, (n, 1, 64, w)).astype(np.float32), "text": text,
             "text_len": np.full((n,), 12, np.int64), "image_width": np.full((n,), w, np.int64),
             "sample_weight": np.ones((n,), np.float32)}
    torch.manual_seed(0)
    models = [RecognitionModel(n_classes=97).to(device)]
    models.append(copy.deepcopy(models[0]))
    torch.use_deterministic_algorithms(True, warn_only=True)
    losses = []
    for model, kw in zip(models, ({}, {"mesh": mesh, "force_shard_map": True})):
        state = create_train_state(model, grad_clip_norm=4.0)
        train, _ = make_recognition_steps(model, **kw)
        losses.append([train(state, batch, 1e-3)[1]["loss"].item() for _ in range(2)])
    sds = [m.state_dict() for m in models]
    return {"backend": dist.get_backend(), "mesh_size": mesh.size, "losses": losses,
            "equal": losses[0] == losses[1] and all(torch.equal(sds[0][k], sds[1][k])
                                                    for k in sds[0])}


def run_layout_tp(rank, world, device, dp: int, mp: int, model_kwargs: dict, state_dict: dict,
                  batch: dict, steps: int, lr: float, dropout_seed=None,
                  grad_clip_norm=None) -> dict:
    """``steps`` tensor-parallel layout steps on a ``dp`` x ``mp`` mesh from
    ``state_dict``: this rank's data shard of the global ``batch``, the
    model split over its model group, Adam after a clip to
    ``grad_clip_norm`` if given. Dropout off unless ``dropout_seed``
    (then each data shard draws from ``dropout_seed + data rank``, alike
    in its model group). Returns each step's metrics, the gathered full
    state before the first step (the shard -> gather round trip), after
    the first and after the last, and the shards' shapes."""
    from ocrs_models_torch.parallel import (
        create_mesh_2d,
        gather_layout_state,
        replicate_tree,
        shard_layout_model,
    )

    mesh = create_mesh_2d(dp, mp, devices=[device])
    model = LayoutModel(**model_kwargs)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()}, strict=True)
    model.to(device)
    if dropout_seed is None:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    replicate_tree(model, mesh)
    shard_layout_model(model, mesh)
    out = {"rank": rank, "data_rank": mesh.data_rank, "model_rank": mesh.model_rank,
           "shapes": {k: tuple(v.shape) for k, v in model.state_dict().items()},
           "round_trip": {k: v.numpy() for k, v in gather_layout_state(model, mesh).items()},
           "metrics": []}
    state = create_train_state(model, grad_clip_norm)
    train, _ = make_layout_steps(model, mesh=mesh)
    local = shard_batch(batch, mesh)[0]
    gen = None
    if dropout_seed is not None:
        gen = torch.Generator(device).manual_seed(dropout_seed + mesh.data_rank)
    for i in range(steps):
        state, m = train(state, local, lr, gen)
        out["metrics"].append(_numpy(m))
        if i == 0:
            out["first"] = {k: v.numpy() for k, v in gather_layout_state(model, mesh).items()}
    out["last"] = {k: v.numpy() for k, v in gather_layout_state(model, mesh).items()}
    return out
