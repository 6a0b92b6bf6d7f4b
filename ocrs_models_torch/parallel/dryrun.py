"""One data-parallel step of each of the three models on N ranks, then
``OcrPipeline.run_batch`` over a serving mesh: the port's counterpart of
``__graft_entry__.dryrun_multichip``.

    python -m ocrs_models_torch.parallel.dryrun --world 2 --device cpu
    python -m ocrs_models_torch.parallel.dryrun --world 8            # 8 GPUs

Each rank takes its contiguous shard of each global batch (``shard_batch``):
the recognizer's collective step with ``grad_accum=2`` (each rank's two
microbatches, then one all-reduce), the detector's and the layout model's
global steps. Every loss must be finite and every rank's models
bit-identical after the step. With an even ``world``, the layout step
runs again tensor parallel on a ``world/2`` x 2 data x model mesh
(``layout_tp``): its loss must lie within 1e-3 of the data-parallel
step's (both without dropout), as in the JAX dry run. Then the trained detector and recognizer
serve two pages over a mesh of ``world`` devices in one process (``world``
CPU devices with ``--device cpu``), and the pages must equal those of one
device. Prints one JSON line and exits non-zero on any failure.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

import numpy as np
import torch

SEED = 0


def _digest(model: torch.nn.Module) -> str:
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _rank(rank: int, world: int, device: torch.device) -> dict:
    from ..config import DEFAULT_ALPHABET
    from ..data import (
        SyntheticDetection,
        SyntheticLayout,
        SyntheticRecognition,
        collate_detection,
        collate_layout,
        collate_recognition,
    )
    from ..models import DetectionModel, LayoutModel, RecognitionModel
    from ..training.state import create_train_state
    from ..training.steps import make_detection_steps, make_layout_steps, make_recognition_steps
    from .mesh import create_mesh, replicate_tree, shard_batch

    mesh = create_mesh(devices=[device])
    out = {"rank": rank}

    def run(name, model, make_steps, batch, lr, clip=None, **kwargs):
        replicate_tree(model, mesh)
        state = create_train_state(model, grad_clip_norm=clip)
        train, _ = make_steps(model, mesh=mesh, **kwargs)
        _, metrics = train(state, shard_batch(batch, mesh)[0], lr)
        out[f"{name}_loss"] = float(metrics["loss"])
        out[f"{name}_digest"] = _digest(model)

    torch.manual_seed(SEED + rank)  # replicate_tree makes rank 0's weights everyone's
    rec = RecognitionModel(n_classes=len(DEFAULT_ALPHABET) + 1).to(device)
    ds = SyntheticRecognition(size=2 * world, max_chars=4)
    run("rec", rec, make_recognition_steps,
        collate_recognition([ds[i] for i in range(2 * world)], width_step=64,
                            batch_multiple=world),
        1e-3, clip=4.0, grad_accum=2)

    det = DetectionModel().to(device)
    dds = SyntheticDetection(size=world, page_size=(128, 128))
    run("det", det, make_detection_steps,
        collate_detection([dds[i] for i in range(world)], batch_multiple=world), 1e-3)

    lay = LayoutModel().to(device)
    replicate_tree(lay, mesh)
    lay_init = {k: v.clone() for k, v in lay.state_dict().items()}
    lds = SyntheticLayout(size=world, n_words=32)
    lbatch = collate_layout([lds[i] for i in range(world)], batch_multiple=world)
    run("layout", lay, make_layout_steps, lbatch, 3e-4)

    if world % 2 == 0:  # the layout step again, tensor parallel on a (world/2) x 2 mesh
        out["layout_tp"] = _layout_tp(device, mesh, lay_init, lbatch, world)

    if rank == 0:
        out["det_state"] = {k: v.cpu() for k, v in det.state_dict().items()}
        out["rec_state"] = {k: v.cpu() for k, v in rec.state_dict().items()}
        out["pages"] = [np.asarray(dds[i]["image"]) for i in range(min(2, world))]
    return out


def _layout_tp(device, mesh, init: dict, batch: dict, world: int) -> dict:
    """One layout step on the data mesh and one on a ``world/2 x 2`` data x
    model mesh (``parallel/tp.py``), from the same weights, dropout off in
    both (the two meshes split the rows differently, so their masks could
    not match); their losses, the TP step's gathered state's shapes."""
    from ..models import LayoutModel
    from ..models.layout import Dropout
    from ..training.state import create_train_state
    from ..training.steps import make_layout_steps
    from .mesh import create_mesh_2d, shard_batch
    from .tp import gather_layout_state, shard_layout_model

    def fresh() -> LayoutModel:
        model = LayoutModel().to(device)
        model.load_state_dict(init)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        return model

    losses = {}
    mesh2 = create_mesh_2d(world // 2, 2, devices=[device])
    for name, m, model in (("dp", mesh, fresh()),
                           ("tp", mesh2, shard_layout_model(fresh(), mesh2))):
        state = create_train_state(model)
        train, _ = make_layout_steps(model, mesh=m)
        _, metrics = train(state, shard_batch(batch, m)[0], 3e-4)
        losses[name] = float(metrics["loss"])
    shapes = {k: tuple(v.shape) for k, v in gather_layout_state(model, mesh2).items()}
    return {"dp_loss": losses["dp"], "tp_loss": losses["tp"], "mesh": [world // 2, 2],
            "gathered_shapes_equal": shapes == {k: tuple(v.shape) for k, v in init.items()}}


def _texts(pages) -> list[list[str]]:
    return [[line.text for line in page] for page in pages]


def dryrun(world: int, device: str = "cuda") -> dict:
    """The dry run; returns its summary, raises on any failure."""
    from ..pipeline import OcrPipeline
    from .distributed import spawn
    from .mesh import create_mesh

    dev = torch.device(device)
    ranks = spawn(_rank, world, dev, timeout=1800)
    summary = {"world": world, "device": str(dev)}
    for name in ("rec", "det", "layout"):
        losses = [r[f"{name}_loss"] for r in ranks]
        if not np.isfinite(losses).all():
            raise AssertionError(f"{name}: non-finite loss on some rank: {losses}")
        if len({r[f"{name}_digest"] for r in ranks}) != 1:
            raise AssertionError(f"{name}: the ranks' models differ after one step")
        summary[f"{name}_loss"] = losses[0]
    if world % 2 == 0:
        tp = ranks[0]["layout_tp"]
        if not np.isfinite(tp["tp_loss"]) or not tp["gathered_shapes_equal"]:
            raise AssertionError(f"layout_tp: {tp}")
        # The JAX dry run's check: within 1e-3 of the data-parallel step's loss.
        if abs(tp["tp_loss"] - tp["dp_loss"]) >= 1e-3 * max(abs(tp["dp_loss"]), 1.0):
            raise AssertionError(f"tensor-parallel layout loss {tp['tp_loss']} diverges from "
                                 f"the data-parallel step's {tp['dp_loss']}")
        summary["layout_tp"] = tp

    first = ranks[0]
    mesh = create_mesh(devices=[dev] * world) if dev.type == "cpu" else create_mesh(world)
    kwargs = {"det_size": (64, 64)}
    meshed = OcrPipeline(first["det_state"], first["rec_state"], mesh=mesh, **kwargs)
    single = OcrPipeline(first["det_state"], first["rec_state"], device=mesh.devices[0],
                         **kwargs)
    args = (first["pages"], world, world)  # det_batch and rec_batch divide the mesh
    served, want = meshed.run_batch(*args), single.run_batch(*args)
    if _texts(served) != _texts(want):
        raise AssertionError(f"mesh serving {_texts(served)} != one device {_texts(want)}")
    summary["served_lines"] = sum(len(p) for p in served)
    return summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--world", type=int, default=2, help="ranks (processes)")
    parser.add_argument("--device", default="cuda", help="cuda (one rank a card) or cpu")
    args = parser.parse_args(argv)
    print(json.dumps(dryrun(args.world, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
