"""Text detection trainer CLI (the port's counterpart of
``ocrs_models_tpu/training/train_detection.py``).

HierText, DDI-100 or synthetic pages at 800x600, the balanced BCE, Adam (1e-3, no clip),
box-match metrics of the word quads every validation epoch, a checkpoint
when the train loss improves, an early stop after 3 epochs without
improvement, optional debug images. The detector runs cuDNN convolutions
and plain PyTorch ops on the GPU: the JAX detector reaches no Pallas
kernel.

Usage:
    python -m ocrs_models_torch.training.train_detection synthetic - --max-epochs 2
    python -m ocrs_models_torch.training.train_detection hiertext /data/hiertext --max-epochs 2
    python -m ocrs_models_torch.training.train_detection ddi /data/ddi100 --max-epochs 2

Where the port differs from the JAX trainer:

- ``--bf16`` (the default, as in the JAX trainer) trains
  ``DetectionModel(dtype=torch.bfloat16)``; ``--no-bf16`` trains in
  float32. Parameters, Adam's state and checkpoints are float32 either way.
- ``hiertext`` and ``ddi`` read their pages with the port's own JPEG
  decoder and PNG reader (``data/imageio.py``, no PIL).
- ``--num-devices N`` (N > 1) trains on N GPUs of one host, one process
  each (NCCL; ``gloo`` when ``main`` is given ``device="cpu"``), as the JAX
  trainer does over a sharded batch: each rank's rows ``rank::N`` of the
  epoch's order in batches of ``--batch-size // N``, batch norm with the
  statistics of every rank's pages, the balanced BCE over every rank's
  pixels, the gradients and the validation's box-match sums all-reduced;
  rank 0 prints and writes. ``torchrun --nproc-per-node N -m
  ocrs_models_torch.training.train_detection ...`` does the same.
- Checkpoints are reference-format ``.pt`` files,
  ``text-detection-checkpoint.pt`` in the working directory, whose
  ``epoch`` is the next epoch to run; ``--checkpoint`` also takes the JAX
  trainer's ``--export x.pt``.
- ``--debug-images`` writes its PNGs through ``zlib`` (no PIL).
- ``--export x.onnx`` builds the graph at 800x600 whatever ``--mask-height``
  is, as the JAX trainer does.
- ``main(argv, device="cuda")`` runs on the GPU and raises without one;
  tests pass ``device="cpu"``.
"""

from __future__ import annotations

import time
from argparse import ArgumentParser, BooleanOptionalAction

import numpy as np
import torch

from ..config import DetectionModelConfig, DetectionTrainConfig
from ..data import DataLoader, SyntheticDetection, collate_detection
from ..data.augment import DetectionAugment
from ..data.loader import device_prefetch
from ..geometry import box_match_metrics, extract_cc_quads
from ..models import DetectionModel
from ..parallel import replicate_tree
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.image import untransform_image
from ..utils.logging import MetricsLogger
from ..utils.metrics import format_metrics
from ..utils.render import write_png
from .ranks import Ranks, check_batch, should_spawn, spawn_trainer
from .state import create_train_state
from .steps import make_detection_steps


def binarize_mask(mask: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    return np.where(mask > threshold, 1.0, 0.0)


def _mask_png(mask: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(mask), 0, 1) * 255).astype(np.uint8)


def save_debug_images(basename: str, image, pred_mask, target_mask) -> None:
    """``{basename}_input.png``, ``_pred_mask.png`` and ``_mask.png`` of one
    sample (``[H, W]`` arrays)."""
    write_png(f"{basename}_input.png", untransform_image(image))
    write_png(f"{basename}_pred_mask.png", _mask_png(pred_mask))
    write_png(f"{basename}_mask.png", _mask_png(target_mask))


def _batches(loader, device):
    """``(host batch, device batch)`` pairs, without the samples' paths."""
    batches = ({k: v for k, v in batch.items() if k != "path"} for batch in loader)
    return device_prefetch(batches, device, depth=2)


def run_train_epoch(loader, state, train_step, lr, device, debug_images=False, ranks=None):
    ranks = ranks or Ranks(device)
    total_loss, n_batches = 0.0, 0
    last_metrics = None
    for batch, on_device in _batches(loader, device):
        n_valid = batch["n_valid"]
        start = time.time()
        state, metrics = train_step(state, on_device, lr)
        loss = float(metrics["loss"])
        sec_per_img = (time.time() - start) / max(n_valid, 1)
        total_loss += loss
        n_batches += 1
        last_metrics = metrics
        if debug_images and n_batches == 1 and n_valid and ranks.writer:
            save_debug_images("train-sample", batch["image"][0, 0],
                              metrics["pred"][0, 0].float().cpu().numpy(), batch["mask"][0, 0])
        ranks.print(f"  batch loss {loss:.4f} sec/img {sec_per_img:.3f}", end="\r")
    ranks.print()
    epoch_stats = {}
    if last_metrics is not None:
        epoch_stats = {
            "grad_norm": float(last_metrics["grad_norm"]),
            "grad_norms": {k: float(v) for k, v in last_metrics["grad_norms"].items()},
        }
    return state, total_loss / max(n_batches, 1), epoch_stats


def run_eval_epoch(loader, state, eval_step, device, debug_images=False, ranks=None):
    """The mean loss over ``loader``'s batches and the mean box-match
    metrics over its pages (over several ``ranks``, every rank's pages)."""
    ranks = ranks or Ranks(device)
    total_loss, n_batches = 0.0, 0
    metrics_list = []
    for batch, on_device in _batches(loader, device):
        n_valid = batch["n_valid"]
        out = eval_step(state, on_device)
        total_loss += float(out["loss"])
        n_batches += 1
        preds = out["pred"][:n_valid, 0].float().cpu().numpy()
        targets = batch["mask"][:n_valid, 0]
        for i in range(n_valid):
            pred_quads = extract_cc_quads(binarize_mask(preds[i]))
            target_quads = extract_cc_quads(binarize_mask(targets[i]))
            metrics_list.append(box_match_metrics(pred_quads, target_quads))
        if debug_images and n_valid and ranks.writer:
            save_debug_images("test-sample", batch["image"][0, 0], preds[0], targets[0])
    return total_loss / max(n_batches, 1), ranks.means(metrics_list)


def main(argv=None, device: str | torch.device = "cuda"):
    """Run the trainer; returns the final train state (``None`` after
    ``--export``)."""
    parser = ArgumentParser(description="Train text detection model.")
    parser.add_argument("dataset_type", choices=["ddi", "hiertext", "synthetic"])
    parser.add_argument("data_dir")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--checkpoint", type=str)
    parser.add_argument("--debug-images", action="store_true")
    parser.add_argument("--export", type=str, help="Export weights (.npz, .pt or .onnx)")
    parser.add_argument("--max-epochs", type=int)
    parser.add_argument("--max-images", type=int)
    parser.add_argument("--validate-only", action="store_true")
    parser.add_argument("--augment", default=True, action=BooleanOptionalAction)
    parser.add_argument("--num-devices", type=int, default=None)
    parser.add_argument(
        "--grad-accum", type=int, default=1,
        help="Microbatches per optimizer step (run in sequence, one update; the "
        "800x600 page activations, not params, bound batch size)",
    )
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--bf16", default=True, action=BooleanOptionalAction,
                        help="bfloat16 conv compute")
    parser.add_argument("--mask-height", type=int, default=None,
                        help="Training mask height (width = 0.75 * height)")
    args = parser.parse_args(argv)

    cfg = DetectionTrainConfig()
    if args.mask_height:
        cfg = DetectionTrainConfig(mask_height=args.mask_height,
                                   mask_width=int(args.mask_height * 0.75))
    # Sizes whose feature pyramid collapses before the bottom level (6
    # rounds of 2x pooling) fail here, before any work.
    if min(cfg.mask_height, cfg.mask_width) < 128:
        parser.exit(1, f"--mask-height {cfg.mask_height} gives mask {cfg.mask_size}; both dims "
                       "must be >= 128 to survive the U-Net's 6 pooling levels\n")
    batch_size = args.batch_size or cfg.batch_size
    seed = cfg.seed
    # The datasets first: a missing root raises here, and a spawning parent
    # converts the ground truth once, before its ranks read it.
    transform = DetectionAugment(cfg.mask_size, augment=args.augment, seed=seed)
    val_transform = DetectionAugment(cfg.mask_size, augment=False)
    val_max = max(10, int(args.max_images * 0.1)) if args.max_images else None
    if args.dataset_type in ("hiertext", "ddi"):
        if args.dataset_type == "hiertext":
            from ..data.hiertext import HierTextDetection as DS
        else:
            from ..data.ddi100 import DDI100 as DS
        train_ds = DS(args.data_dir, train=True, transform=transform, max_images=args.max_images)
        val_ds = DS(args.data_dir, train=False, transform=val_transform, max_images=val_max)
    else:
        train_ds = SyntheticDetection(size=args.max_images or 64, page_size=cfg.mask_size,
                                      seed=seed, transform=transform)
        val_ds = SyntheticDetection(size=val_max or 8, page_size=cfg.mask_size, seed=seed + 1,
                                    transform=val_transform)
    if should_spawn(args.num_devices):
        check_batch(batch_size, args.num_devices)
        spawn_trainer("train_detection", argv, device, args.num_devices)
        return None
    ranks = Ranks.join(device)
    dev = ranks.device
    if args.num_devices not in (None, ranks.world):
        raise ValueError(f"--num-devices {args.num_devices} in a job of {ranks.world} ranks")
    check_batch(batch_size, ranks.world)

    def collate(samples):
        # Pads every batch to a multiple of grad_accum (zero-weight rows),
        # so any --batch-size is valid.
        return collate_detection(samples, batch_multiple=args.grad_accum)

    shard = {"process_index": ranks.rank, "process_count": ranks.world}
    train_loader = DataLoader(train_ds, batch_size // ranks.world, collate, shuffle=True,
                              seed=seed, num_threads=2, **shard)
    val_loader = DataLoader(val_ds, batch_size // ranks.world, collate, **shard)
    ranks.print(f"Training dataset: images {len(train_ds)} in {len(train_loader)} batches")
    ranks.print(f"Validation dataset: images {len(val_ds)} in {len(val_loader)} batches")

    mcfg = DetectionModelConfig()
    torch.manual_seed(seed)
    model = DetectionModel(depth_scale=mcfg.depth_scale, in_channels=mcfg.in_channels,
                           dtype=torch.bfloat16 if args.bf16 else torch.float32).to(dev)
    state = create_train_state(model)
    n_params = sum(int(np.prod(p.shape)) for p in model.parameters())
    ranks.print(f"Model param count: {n_params}")

    epoch = 0
    if args.checkpoint:
        state, epoch = load_checkpoint(args.checkpoint, state)
    if ranks.mesh is not None:
        replicate_tree(model, ranks.mesh)

    if args.export:
        from .export_utils import export_weights

        if ranks.writer:
            export_weights(state, args.export, model="detection", epoch=epoch)
        ranks.barrier()
        return None

    train_step, eval_step = make_detection_steps(model, grad_accum=args.grad_accum,
                                                 mesh=ranks.mesh)
    epoch_kw = {"debug_images": args.debug_images, "ranks": ranks}

    if args.validate_only:
        if not args.checkpoint:
            parser.exit(1, "--validate-only requires --checkpoint\n")
        val_loss, val_metrics = run_eval_epoch(val_loader, state, eval_step, dev, **epoch_kw)
        ranks.print(f"Validation loss {val_loss:.4f}")
        ranks.print("Validation metrics:", format_metrics(val_metrics))
        return state

    config = {"batch_size": batch_size, "dataset_size": len(train_ds), "model_params": n_params,
              "seed": seed, "mesh_devices": ranks.world}
    logger = MetricsLogger("text-detection", config=config) if ranks.writer else None
    lr = args.lr or cfg.learning_rate
    min_train_loss = 1.0
    epochs_without_improvement = 0
    while args.max_epochs is None or epoch < args.max_epochs:
        state, train_loss, train_stats = run_train_epoch(
            train_loader, state, train_step, lr, dev, **epoch_kw)
        val_loss, val_metrics = run_eval_epoch(val_loader, state, eval_step, dev, **epoch_kw)
        ranks.print(f"Epoch {epoch} train loss {train_loss:.4f} validation loss {val_loss:.4f}")
        ranks.print(f"Epoch {epoch} validation metrics:", format_metrics(val_metrics))
        if ranks.writer:
            logger.log({"train_loss": train_loss, "val_loss": val_loss,
                        "val_metrics": val_metrics, **train_stats}, step=epoch)
        epoch += 1
        if train_loss < min_train_loss:
            min_train_loss = train_loss
            epochs_without_improvement = 0
            if ranks.writer:
                save_checkpoint(f"{cfg.checkpoint_name}.pt", state, epoch)
        else:
            epochs_without_improvement += 1
        ranks.barrier()
        if epochs_without_improvement > cfg.early_stop_epochs:
            ranks.print(f"Stopping after {epochs_without_improvement} epochs "
                        "without train loss improvement")
            break
    return state


if __name__ == "__main__":
    main()
