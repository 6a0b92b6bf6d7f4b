"""The three trainers on several ranks (``--num-devices N`` and a process
group joined as under ``torchrun``), on the CPU over ``gloo``: one epoch
each, replicas bit-identical across the ranks, only rank 0 writing, a
resume, runs on 2 ranks against the same trainer on 1 rank at the same
global batch, ranks left with unequal shares of the data, and the
refusals. Also the loader's equal step counts.

Bounds of the 2-rank against the 1-rank runs (float32): the layout model
(dropout taken out in both, since each rank draws its own masks) keeps no
batch statistics, so only the order of the sums differs: losses 1e-5
relative, parameters within ``2 * lr * steps``. The detector's batch norm
takes the whole batch's statistics on both, in JAX's one-pass formula on 2
ranks and PyTorch's on 1: the same bounds as ``test_torch_detection_train``
holds the step to (losses 1e-4 relative after the first step, parameters
within ``2 * lr * steps``).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ocrs_models_torch.data import DataLoader, collate_layout
from ocrs_models_torch.data.synthetic import SyntheticLayout
from ocrs_models_torch.parallel import spawn
from ocrs_models_torch.training import train_detection, train_layout, train_rec
from torch_parallel_workers import run_trainer

TIMEOUT = 240
# argv, checkpoint, metrics file, steps an epoch, epochs of the first run
# (the detection trainer writes its checkpoint once the train loss is below
# 1.0, which these 4 pages reach in their second epoch), learning rate.
TRAINERS = {
    "train_rec": (["synthetic", "-", "--max-images", "16", "--batch-size", "8", "--no-bf16",
                   "--no-augment"], "text-rec-checkpoint.pt", "text-recognition-metrics.jsonl",
                  2, 1, 1e-3),
    "train_layout": (["synthetic", "--max-images", "16", "--batch-size", "8", "--no-bf16"],
                     "text-layout-checkpoint.pt", "text-layout-metrics.jsonl", 2, 1, 3e-4),
    "train_detection": (["synthetic", "-", "--max-images", "4", "--batch-size", "4",
                         "--mask-height", "192", "--no-bf16", "--no-augment"],
                        "text-detection-checkpoint.pt", "text-detection-metrics.jsonl",
                        1, 2, 1e-3),
}
MODULES = {"train_rec": train_rec, "train_layout": train_layout,
           "train_detection": train_detection}


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _spawn_trainer(tmp_path, world, module, argv, **kwargs):
    return spawn(run_trainer, world, "cpu", args=(module, argv, *kwargs.values()),
                 timeout=TIMEOUT, store_dir=str(tmp_path))


@pytest.mark.parametrize("module", list(TRAINERS))
def test_trainer_on_two_ranks_then_resumed(tmp_path, monkeypatch, module):
    """``--num-devices 2`` trains one epoch (rank 0 writes the checkpoint
    and one metrics record an epoch, which a second writer would double);
    a resume on two ranks joined as under torchrun runs the next epoch and
    leaves both replicas bit-identical."""
    argv, ckpt, metrics, steps, epochs, _ = TRAINERS[module]
    monkeypatch.chdir(tmp_path)
    assert MODULES[module].main([*argv, "--max-epochs", str(epochs), "--num-devices", "2"],
                                device="cpu") is None
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted([ckpt, metrics])
    records = _records(tmp_path / metrics)
    assert [r.get("epoch") for r in records] == [None, *range(epochs)]
    assert records[0]["mesh_devices"] == 2
    assert all(np.isfinite([r["train_loss"], r["val_loss"]]).all() for r in records[1:])
    ranks = _spawn_trainer(tmp_path, 2, module, [*argv, "--max-epochs", str(epochs + 1),
                                                 "--checkpoint", ckpt])
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert ranks[0]["step"] == ranks[1]["step"] == steps * (epochs + 1)
    records = _records(tmp_path / metrics)
    assert [r.get("epoch") for r in records] == [None, *range(epochs), None, epochs]


@pytest.mark.parametrize("module", ["train_layout", "train_detection"])
def test_two_ranks_equal_one_rank_at_the_same_global_batch(tmp_path, monkeypatch, module):
    argv, _, metrics, steps, _, lr = TRAINERS[module]
    argv = [*argv, "--max-epochs", "1"]
    runs = {}
    for world in (1, 2):
        run_dir = tmp_path / f"world{world}"
        run_dir.mkdir()
        monkeypatch.chdir(run_dir)
        ranks = _spawn_trainer(run_dir, world, module, argv, dropout=False)
        runs[world] = (ranks[0], _records(run_dir / metrics)[1])
    (one, one_rec), (two, two_rec) = runs[1], runs[2]
    assert one["step"] == two["step"] == steps
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(two_rec[key], one_rec[key],
                                   rtol=1e-5 if module == "train_layout" else 1e-4)
    for k, v in one["state"].items():
        if not k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            assert float(np.abs(two["state"][k] - v).max()) <= 2 * lr * steps + 1e-6, k


def test_ranks_with_unequal_shares_finish(tmp_path, monkeypatch):
    """10 pages on 4 ranks at 2 a rank a step: ranks 0 and 1 hold 3 pages,
    2 and 3 hold 2, and every rank runs 2 steps (2 and 3 a padding step),
    so no collective waits for a rank that has stopped."""
    monkeypatch.chdir(tmp_path)
    ranks = _spawn_trainer(tmp_path, 4, "train_layout",
                           ["synthetic", "--max-images", "10", "--batch-size", "8", "--no-bf16",
                            "--max-epochs", "1"])
    assert len({r["digest"] for r in ranks}) == 1
    assert [r["step"] for r in ranks] == [2, 2, 2, 2]


@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_gives_every_process_the_same_step_count(drop_last):
    ds = SyntheticLayout(size=10, n_words=8, seed=0)
    loaders = [DataLoader(ds, 2, collate_layout, shuffle=True, seed=3, drop_last=drop_last,
                          process_index=r, process_count=4) for r in range(4)]
    batches = [list(loader) for loader in loaders]
    steps = 1 if drop_last else 2
    assert [len(loader) for loader in loaders] == [len(b) for b in batches] == [steps] * 4
    assert sum(batch["n_valid"] for b in batches for batch in b) == (8 if drop_last else 10)
    if not drop_last:
        for r in (2, 3):  # their second batch is padding: weight 0, no valid rows
            pad = batches[r][1]
            assert pad["n_valid"] == 0 and not pad["sample_weight"].any()


def test_more_devices_than_cards_raise(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    n = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(RuntimeError, match="one rank per card"):
        spawn(run_trainer, n, "cuda", args=("train_rec", []))
    with pytest.raises(RuntimeError, match="one rank per card"):
        train_rec.main(["synthetic", "-", "--num-devices", str(n), "--batch-size", str(2 * n)])
    assert list(tmp_path.iterdir()) == []


def test_a_failing_rank_fails_the_spawn(tmp_path, monkeypatch):
    # An unreadable checkpoint fails every rank; spawn raises, no hang.
    monkeypatch.chdir(tmp_path)
    (tmp_path / "bad.pt").write_bytes(b"not a checkpoint")
    with pytest.raises(RuntimeError, match="exited with code"):
        train_layout.main(["synthetic", "--max-images", "8", "--batch-size", "8",
                           "--num-devices", "2", "--checkpoint", "bad.pt"], device="cpu")


@pytest.mark.parametrize("how", ["env", "explicit"])
def test_initialize_multihost_joins_a_process_group(tmp_path, how):
    """``torchrun``'s variables (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT) make ``initialize_multihost`` join through ``env://``;
    without them it joins through the ``init_method``, rank and world size
    it is given."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    if how == "env":
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        env.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        call = "initialize_multihost(device='cpu')"
    else:
        call = f"initialize_multihost('file://{tmp_path / 'store'}', 1, 0, device='cpu')"
    code = ("import torch.distributed as dist\n"
            "from ocrs_models_torch.parallel import initialize_multihost, create_mesh\n"
            f"print({call}, create_mesh(devices=['cpu']).size, dist.get_backend())\n"
            "dist.destroy_process_group()\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["(0,", "1)", "1", "gloo"]


def test_dryrun_on_two_cpu_ranks():
    """``python -m ocrs_models_torch.parallel.dryrun --world 2 --device
    cpu``: one step of each model on two ranks (finite losses, equal
    replicas) and serving over a 2-device mesh equal to one device."""
    from ocrs_models_torch.parallel.dryrun import dryrun

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        summary = dryrun(2, "cpu")
    finally:
        torch.set_num_threads(threads)
    assert summary["world"] == 2 and summary["served_lines"] > 0
    assert all(np.isfinite(summary[f"{k}_loss"]) for k in ("rec", "det", "layout"))
    tp = summary["layout_tp"]  # the tensor-parallel leg on a 1 x 2 data x model mesh
    assert tp["mesh"] == [1, 2] and tp["gathered_shapes_equal"]
    assert abs(tp["tp_loss"] - tp["dp_loss"]) < 1e-3 * max(abs(tp["dp_loss"]), 1.0)
