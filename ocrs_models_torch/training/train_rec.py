"""Text recognition trainer CLI (the port's counterpart of
``ocrs_models_tpu/training/train_rec.py``).

HierText line crops or the synthetic line dataset, CTC loss with ``W//4``
input lengths, Adam (1e-3) with reduce-on-plateau, global-norm clip 4.0,
per-epoch CER, sample-prediction previews, a checkpoint and a JSONL
metrics record every epoch, and the NaN-loss guard, on one GPU: each
train step runs the
port's six CUDA kernels (stage 1 forward and backward, the biGRU
recurrence forward and backward for each of the two layers, the CTC alpha
and beta recursions), each validation batch the three forward ones.

Usage:
    python -m ocrs_models_torch.training.train_rec synthetic - --max-epochs 2
    python -m ocrs_models_torch.training.train_rec hiertext /data/hiertext --max-epochs 2

Where the port differs from the JAX trainer:

- ``--bf16`` (the default, as in the JAX trainer) trains
  ``RecognitionModel(dtype=torch.bfloat16)``, whose biGRU computes in bf16
  too, as the JAX trainer's does; ``--no-bf16`` trains in float32.
  Parameters, Adam's state and checkpoints are float32 either way.
- ``hiertext`` reads the pages with the port's own JPEG decoder
  (``data/imageio.py``, no PIL) and caches the line crops as the JAX
  trainer does (``{split}-lines-cache/`` under the dataset's root, shared
  with the JAX package).
- ``--num-devices N`` (N > 1) trains on N GPUs of one host, one process
  each (NCCL; ``gloo`` when ``main`` is given ``device="cpu"``), with the
  JAX trainer's ``shard_map`` step: each rank's rows ``rank::N`` of the
  epoch's order in batches of ``--batch-size // N`` (the ranks' rows of
  step ``j`` are the JAX trainer's global batch ``j``), the sums of the
  loss and the gradients all-reduced; rank 0 prints, writes the
  checkpoint, the metrics and ``--export``. ``torchrun --nproc-per-node N
  -m ocrs_models_torch.training.train_rec ...`` does the same, one rank a
  process it starts.
- Checkpoints are reference-format ``.pt`` files,
  ``text-rec-checkpoint.pt`` in the working directory; ``--checkpoint``
  also takes the JAX trainer's ``--export x.pt``.
- ``main(argv, device="cuda")`` runs on the GPU and raises without one;
  tests pass ``device="cpu"``.
"""

from __future__ import annotations

import math
from argparse import ArgumentParser, BooleanOptionalAction

import numpy as np
import torch

from ..config import DEFAULT_ALPHABET, RecognitionModelConfig, RecognitionTrainConfig
from ..data import DataLoader, SyntheticRecognition, collate_recognition
from ..data.augment import RecognitionAugment
from ..data.loader import device_prefetch
from ..models import RecognitionModel
from ..parallel import replicate_tree
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.logging import MetricsLogger
from ..utils.metrics import RecognitionAccuracyStats
from ..utils.profiling import Throughput
from ..utils.text import ctc_greedy_decode_text, decode_text
from .ranks import Ranks, check_batch, should_spawn, spawn_trainer
from .schedules import ReduceLROnPlateau
from .state import create_train_state
from .steps import make_recognition_steps


def preview_predictions(batch, preds, alphabet: str, tag: str, limit: int = 10):
    input_lengths = batch["image_width"] // 4
    for i in range(min(limit, len(preds))):
        if batch["sample_weight"][i] == 0:
            continue
        target = decode_text(batch["text"][i][: batch["text_len"][i]], alphabet)
        pred = ctc_greedy_decode_text(preds[i][: input_lengths[i]], alphabet)
        print(f'Sample {tag} prediction "{pred}" target "{target}"')


def run_epoch(loader, state, step_fn, alphabet, device, lr=None, train=True, ranks=None):
    """One pass over ``loader``; returns ``(state, mean loss, stats)`` when
    training, else ``(mean loss, stats)``. Over several ``ranks`` the
    character counts and the crops behind the throughput are summed across
    them, and rank 0 alone prints."""
    ranks = ranks or Ranks(device)
    stats = RecognitionAccuracyStats(alphabet)
    throughput = Throughput(warmup=1, n_chips=ranks.world)
    total_loss = 0.0
    total_grad_norm = 0.0
    n_batches = 0
    for batch_idx, (batch, on_device) in enumerate(device_prefetch(iter(loader), device, depth=2)):
        if train:
            state, metrics = step_fn(state, on_device, lr)
        else:
            metrics = step_fn(state, on_device)
        loss = float(metrics["loss"])
        if math.isnan(loss):
            raise RuntimeError(
                "Training produced invalid loss. Check input and target "
                "lengths are compatible with CTC loss"
            )
        preds = metrics["preds"].cpu().numpy()
        valid = batch["sample_weight"] > 0
        stats.update(
            batch["text"][valid],
            batch["text_len"][valid],
            preds[valid],
            (batch["image_width"] // 4)[valid],
        )
        if batch_idx == 0 and ranks.writer:
            preview_predictions(batch, preds, alphabet, "train" if train else "test")
        total_loss += loss
        if train:
            total_grad_norm += float(metrics["grad_norm"])
        n_batches += 1
        (n_valid,) = ranks.sum([valid.sum()])
        throughput.update(int(n_valid))
    stats.char_errors, stats.total_chars = (int(v) for v in ranks.sum(
        [stats.char_errors, stats.total_chars]))
    mean_loss = total_loss / max(n_batches, 1)
    if train:
        ranks.print(f"Mean grad norm {total_grad_norm / max(n_batches, 1):.3f}")
        if throughput.updates > throughput.warmup:
            ranks.print(f"Throughput {throughput.last_rate:.0f} crops/sec/chip")
        return state, mean_loss, stats
    return mean_loss, stats


def main(argv=None, device: str | torch.device = "cuda"):
    """Run the trainer; returns the final train state (``None`` after
    ``--export``)."""
    parser = ArgumentParser(description="Train text recognition model.")
    parser.add_argument("dataset_type", choices=["hiertext", "synthetic"])
    parser.add_argument("data_dir")
    parser.add_argument(
        "--augment", default=True, action=BooleanOptionalAction,
        help="Enable data augmentations",
    )
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--checkpoint", type=str, help="Checkpoint (.pt) to load")
    parser.add_argument("--export", type=str, help="Export weights (.npz, .pt or .onnx)")
    parser.add_argument("--lr", type=float, help="Initial learning rate")
    parser.add_argument(
        "--plateau-patience",
        type=int,
        default=RecognitionTrainConfig().plateau_patience,
        help="Epochs without val-loss improvement before the LR decays "
        "(raise for tiny datasets where epochs are few steps)",
    )
    parser.add_argument("--max-epochs", type=int)
    parser.add_argument("--max-images", type=int)
    parser.add_argument("--validate-only", action="store_true")
    parser.add_argument("--num-devices", type=int, default=None)
    parser.add_argument(
        "--grad-accum", type=int, default=1,
        help="Microbatches per optimizer step (run in sequence, one update; "
        "about k times less activation memory at the same math)",
    )
    parser.add_argument(
        "--bf16", default=True, action=BooleanOptionalAction,
        help="bfloat16 compute of the convolutions and the biGRU (parameters stay float32)",
    )
    args = parser.parse_args(argv)
    cfg = RecognitionTrainConfig()
    batch_size = args.batch_size or cfg.batch_size
    seed = cfg.seed
    # The datasets first: a missing root raises here, and a spawning parent
    # converts the ground truth once, before its ranks read it.
    augment = RecognitionAugment(seed=seed) if args.augment else None
    val_max = max(10, int(args.max_images * 0.1)) if args.max_images else None
    if args.dataset_type == "hiertext":
        from ..data.hiertext import HierTextRecognition

        train_ds = HierTextRecognition(args.data_dir, train=True, max_images=args.max_images,
                                       transform=augment)
        val_ds = HierTextRecognition(args.data_dir, train=False, max_images=val_max)
    else:
        train_ds = SyntheticRecognition(size=args.max_images or 512, seed=seed,
                                        transform=augment)
        val_ds = SyntheticRecognition(size=val_max or 64, seed=seed + 1)
    if should_spawn(args.num_devices):
        check_batch(batch_size, args.num_devices)
        spawn_trainer("train_rec", argv, device, args.num_devices, build_kernels=True)
        return None
    ranks = Ranks.join(device, build_kernels=True)
    dev = ranks.device
    if args.num_devices not in (None, ranks.world):
        raise ValueError(f"--num-devices {args.num_devices} in a job of {ranks.world} ranks")
    check_batch(batch_size, ranks.world)

    def collate(samples):
        return collate_recognition(samples, width_step=cfg.width_step,
                                   batch_multiple=args.grad_accum, max_width=cfg.max_width)

    shard = {"process_index": ranks.rank, "process_count": ranks.world}
    train_loader = DataLoader(train_ds, batch_size // ranks.world, collate, shuffle=True,
                              seed=seed, num_threads=2, **shard)
    val_loader = DataLoader(val_ds, batch_size // ranks.world, collate, shuffle=True, seed=seed,
                            **shard)

    mcfg = RecognitionModelConfig()
    torch.manual_seed(seed)
    model = RecognitionModel(
        n_classes=mcfg.n_classes, gru_hidden=mcfg.gru_hidden, gru_layers=mcfg.gru_layers,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
    ).to(dev)
    state = create_train_state(model, grad_clip_norm=cfg.grad_clip_norm)
    n_params = sum(int(np.prod(p.shape)) for p in model.parameters())
    ranks.print(f"Model param count {n_params}")

    epoch = 0
    if args.checkpoint:
        state, epoch = load_checkpoint(args.checkpoint, state)
    if ranks.mesh is not None:
        replicate_tree(model, ranks.mesh)

    if args.export:
        from .export_utils import export_weights

        if ranks.writer:
            export_weights(state, args.export, model="recognition", epoch=epoch)
        ranks.barrier()
        return None

    # Collation pads every batch to a multiple of grad_accum (zero-weight
    # rows), so any --batch-size is valid.
    train_step, eval_step = make_recognition_steps(model, mesh=ranks.mesh,
                                                   grad_accum=args.grad_accum)

    def epoch_of(loader, step_fn, **kw):
        return run_epoch(loader, state, step_fn, DEFAULT_ALPHABET, dev, ranks=ranks, **kw)

    if args.validate_only:
        val_loss, val_stats = epoch_of(val_loader, eval_step, train=False)
        ranks.print(f"Validation loss {val_loss} char error rate {val_stats.char_error_rate()}")
        return state

    initial_lr = args.lr or cfg.learning_rate
    scheduler = ReduceLROnPlateau(
        initial_lr, factor=cfg.plateau_factor, patience=args.plateau_patience
    )
    config = {
        "batch_size": batch_size,
        "dataset_size": len(train_ds),
        "model_params": n_params,
        "seed": seed,
        "mesh_devices": ranks.world,
    }
    logger = MetricsLogger("text-recognition", config=config) if ranks.writer else None

    lr = initial_lr
    while args.max_epochs is None or epoch < args.max_epochs:
        state, train_loss, train_stats = epoch_of(train_loader, train_step, lr=lr, train=True)
        ranks.print(
            f"Epoch {epoch} train loss {train_loss} "
            f"char error rate {train_stats.char_error_rate()}"
        )
        val_loss, val_stats = epoch_of(val_loader, eval_step, train=False)
        ranks.print(
            f"Epoch {epoch} validation loss {val_loss} "
            f"char error rate {val_stats.char_error_rate()}"
        )
        lr = scheduler.step(val_loss)
        ranks.print(f"Current learning rate [{lr}]")

        epoch += 1
        if ranks.writer:
            logger.log(
                {
                    "train_loss": train_loss,
                    "train_accuracy": train_stats.stats_dict(),
                    "val_loss": val_loss,
                    "val_accuracy": val_stats.stats_dict(),
                },
                step=epoch - 1,
            )
            save_checkpoint(f"{cfg.checkpoint_name}.pt", state, epoch)
        ranks.barrier()
    return state


if __name__ == "__main__":
    main()
