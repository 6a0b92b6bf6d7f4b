"""Text layout trainer CLI (the port's counterpart of
``ocrs_models_tpu/training/train_layout.py``).

WebLayout JSON pages, ``synthetic`` flat lines or ``synthetic-doc``
structured documents; weighted BCE (``pos_weight`` 10) over every word of
the padded pages; Adam (3e-4) with a 50-epoch linear warmup; line-start and
line-end precision and recall; a JSONL metrics record every epoch and a
checkpoint when the validation loss improves. The layout model runs plain
PyTorch products on the GPU: the JAX layout model reaches no Pallas kernel.

Usage:
    python -m ocrs_models_torch.training.train_layout <data_dir>
    python -m ocrs_models_torch.training.train_layout synthetic-doc --max-epochs 2

Where the port differs from the JAX trainer:

- ``--bf16`` (the default, as in the JAX trainer) trains
  ``LayoutModel(dtype=torch.bfloat16)``; ``--no-bf16`` trains in float32.
  Parameters, Adam's state and checkpoints are float32 either way.
- ``--num-devices N`` (N > 1) trains on N GPUs of one host, one process
  each (NCCL; ``gloo`` when ``main`` is given ``device="cpu"``), as the JAX
  trainer does over a sharded batch: each rank's rows ``rank::N`` of the
  epoch's order in batches of ``--batch-size // N``, the weighted BCE's
  sums and the gradients all-reduced, the precision and recall counts of
  each batch summed; each rank draws dropout from its own generator (seed
  + rank); rank 0 prints and writes. ``torchrun --nproc-per-node N -m
  ocrs_models_torch.training.train_layout ...`` does the same.
- Checkpoints are reference-format ``.pt`` files,
  ``text-layout-checkpoint.pt`` in the working directory, whose ``epoch``
  is the next epoch to run; ``--checkpoint`` also takes the JAX trainer's
  ``--export x.pt``.
- Dropout draws from a ``torch.Generator`` seeded with the trainer's seed,
  so its masks are not the JAX trainer's.
- ``main(argv, device="cuda")`` runs on the GPU and raises without one;
  tests pass ``device="cpu"``.
"""

from __future__ import annotations

from argparse import ArgumentParser, BooleanOptionalAction

import numpy as np
import torch

from ..config import LayoutModelConfig, LayoutTrainConfig
from ..data import DataLoader, SyntheticLayout, collate_layout
from ..data.loader import device_prefetch
from ..models import LayoutModel
from ..parallel import replicate_tree
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.logging import MetricsLogger
from ..utils.metrics import LayoutAccuracyStats, layout_counts
from .ranks import Ranks, check_batch, should_spawn, spawn_trainer
from .schedules import LinearWarmup
from .state import create_train_state
from .steps import make_layout_steps


def run_epoch(loader, state, step_fn, device, lr=None, generator=None, train=True, ranks=None):
    """One pass over ``loader``; returns ``(state, mean loss, stats)`` when
    training, else ``(mean loss, stats)``. Over several ``ranks`` each
    batch's precision and recall counts are summed across them."""
    ranks = ranks or Ranks(device)
    stats = LayoutAccuracyStats()
    total_loss, n_batches = 0.0, 0
    for batch, on_device in device_prefetch(iter(loader), device, depth=2):
        n_valid = batch["n_valid"]
        if train:
            state, metrics = step_fn(state, on_device, lr, generator)
        else:
            metrics = step_fn(state, on_device)
        total_loss += float(metrics["loss"])
        n_batches += 1
        stats.update_counts(ranks.sum(
            layout_counts(metrics["probs"][:n_valid].cpu().numpy(), batch["labels"][:n_valid])))
    mean_loss = total_loss / max(n_batches, 1)
    if train:
        return state, mean_loss, stats
    return mean_loss, stats


def datasets(data_dir: str, max_images, cfg: LayoutTrainConfig):
    """The train and validation datasets of ``data_dir``: ``synthetic``,
    ``synthetic-doc`` or a WebLayout JSON directory."""
    seed = cfg.seed
    if data_dir == "synthetic":
        return (SyntheticLayout(size=max_images or 128, n_words=cfg.n_words, seed=seed),
                SyntheticLayout(size=32, n_words=cfg.n_words, seed=seed + 1))
    if data_dir == "synthetic-doc":
        from ..data.layout_synth import SyntheticDocLayout

        train_ds = SyntheticDocLayout(
            size=max_images or 256, n_words=cfg.n_words, seed=seed, train=True,
            normalize_coords=False, randomize=True, max_jitter=cfg.max_jitter,
        )
        val_ds = SyntheticDocLayout(
            size=max(32, (max_images or 256) // 8), n_words=cfg.n_words, seed=seed,
            train=False, normalize_coords=False,
        )
        return train_ds, val_ds
    from ..data.web_layout import WebLayout

    train_ds = WebLayout(
        data_dir, max_jitter=cfg.max_jitter, normalize_coords=False, randomize=True,
        padded_size=cfg.n_words, train=True, max_images=max_images, seed=seed,
    )
    val_ds = WebLayout(data_dir, normalize_coords=False, randomize=False,
                       padded_size=cfg.n_words, train=False)
    return train_ds, val_ds


def main(argv=None, device: str | torch.device = "cuda"):
    """Run the trainer; returns the final train state (``None`` after
    ``--export``)."""
    parser = ArgumentParser(description="Train text layout model.")
    parser.add_argument(
        "data_dir",
        help="WebLayout JSON dir, 'synthetic' (flat lines), or "
        "'synthetic-doc' (structured-document generator)",
    )
    parser.add_argument("--checkpoint", type=str, help="Checkpoint (.pt) to load")
    parser.add_argument("--export", type=str, help="Export weights (.npz, .pt or .onnx)")
    parser.add_argument("--max-epochs", type=int)
    parser.add_argument("--max-images", type=int)
    parser.add_argument("--validate-only", action="store_true")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--num-devices", type=int, default=None)
    parser.add_argument(
        "--grad-accum", type=int, default=1,
        help="Microbatches per optimizer step (run in sequence, one update)",
    )
    parser.add_argument(
        "--bf16", default=True, action=BooleanOptionalAction,
        help="bfloat16 encoder matmuls (norms/softmax stay fp32)",
    )
    args = parser.parse_args(argv)
    cfg = LayoutTrainConfig()
    batch_size = args.batch_size or cfg.batch_size
    if should_spawn(args.num_devices):
        check_batch(batch_size, args.num_devices)
        spawn_trainer("train_layout", argv, device, args.num_devices)
        return None
    ranks = Ranks.join(device)
    dev = ranks.device
    if args.num_devices not in (None, ranks.world):
        raise ValueError(f"--num-devices {args.num_devices} in a job of {ranks.world} ranks")
    check_batch(batch_size, ranks.world)
    seed = cfg.seed
    train_ds, val_ds = datasets(args.data_dir, args.max_images, cfg)

    def collate(samples):
        # Pads every batch to a multiple of grad_accum (zero-weight rows),
        # so any --batch-size is valid.
        return collate_layout(samples, batch_multiple=args.grad_accum)

    shard = {"process_index": ranks.rank, "process_count": ranks.world}
    train_loader = DataLoader(train_ds, batch_size // ranks.world, collate, shuffle=True,
                              seed=seed, **shard)
    val_loader = DataLoader(val_ds, batch_size // ranks.world, collate, shuffle=True, seed=seed,
                            **shard)

    mcfg = LayoutModelConfig()
    torch.manual_seed(seed)
    model = LayoutModel(
        n_classes=mcfg.n_classes, d_model=mcfg.d_model, n_layers=mcfg.n_layers,
        n_heads=mcfg.n_heads, d_ff=mcfg.d_feedforward, pos_embedding=mcfg.pos_embedding,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
    ).to(dev)
    state = create_train_state(model)
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
            export_weights(state, args.export, model="layout", epoch=epoch)
        ranks.barrier()
        return None

    train_step, eval_step = make_layout_steps(
        model, pos_weight=cfg.pos_weight, grad_accum=args.grad_accum, mesh=ranks.mesh
    )

    if args.validate_only:
        _, val_stats = run_epoch(val_loader, state, eval_step, dev, train=False, ranks=ranks)
        ranks.print(f"Epoch {epoch} val stats: {val_stats.summary()}")
        return state

    config = {"dataset_size": len(train_ds), "model_params": n_params, "seed": seed,
              "mesh_devices": ranks.world}
    logger = MetricsLogger("text-layout", config=config) if ranks.writer else None
    warmup = LinearWarmup(cfg.learning_rate, cfg.warmup_epochs)
    generator = torch.Generator(device=dev).manual_seed(seed + ranks.rank)
    best_val_loss = float("inf")

    while args.max_epochs is None or epoch < args.max_epochs:
        lr = warmup.at_epoch(epoch)
        state, train_loss, train_stats = run_epoch(
            train_loader, state, train_step, dev, lr=lr, generator=generator, train=True,
            ranks=ranks,
        )
        val_loss, val_stats = run_epoch(val_loader, state, eval_step, dev, train=False,
                                        ranks=ranks)

        ranks.print(f"Epoch {epoch} train loss {train_loss} val loss {val_loss}")
        ranks.print(f"Epoch {epoch} train stats: {train_stats.summary()}")
        ranks.print(f"Epoch {epoch} val stats: {val_stats.summary()}")
        ranks.print(f"Epoch {epoch} lr {lr}")
        if ranks.writer:
            logger.log(
                {
                    "lr": lr,
                    "train_loss": train_loss,
                    "train_accuracy": train_stats.stats_dict(),
                    "val_loss": val_loss,
                    "val_accuracy": val_stats.stats_dict(),
                },
                step=epoch,
            )
        epoch += 1
        if val_loss < best_val_loss:
            best_val_loss = val_loss
            if ranks.writer:
                save_checkpoint(f"{cfg.checkpoint_name}.pt", state, epoch)
        ranks.barrier()
    return state


if __name__ == "__main__":
    main()
