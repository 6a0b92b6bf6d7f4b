"""The port's recognition trainer CLI on the CPU, end to end against the
JAX package's trainer CLI from the same initial weights, and its resume,
NaN guard, refusals and export.

The JAX trainer's ``--export init.pt`` gives the initial weights (the
full-width CRNN, 2,426,913 parameters); both CLIs then train one epoch on
8 synthetic lines (one step of batch 8) and validate on 10, the port's
from ``--checkpoint init.pt``. Tolerances: the epoch-0 train loss (the
loss of the first step, from equal weights on equal batches) rtol 1e-4
(measured 2.5e-7); the train CER equal (the first step's predictions are
equal, as in ``tests/test_torch_train_steps.py``); the validation loss,
after one Adam step, rtol 1e-3 (that file's step-1 grad-norm bound;
measured 2.5e-5) and the validation CER within 0.05 (measured equal).
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from ocrs_models_tpu.training import train_rec as jax_train_rec
from ocrs_models_torch.export.onnx_check import check_bytes
from ocrs_models_torch.training import train_rec

SMALL = ["--max-images", "8", "--batch-size", "8", "--max-epochs", "1", "--no-augment"]
NAN_MESSAGE = ("Training produced invalid loss. Check input and target lengths are "
               "compatible with CTC loss")


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """The JAX trainer's initial weights, exported as a reference-format .pt."""
    run_dir = tmp_path_factory.mktemp("jax_init")
    cwd = os.getcwd()
    os.chdir(run_dir)
    try:
        jax_train_rec.main(["synthetic", "-", "--export", "init.pt", "--no-bf16"])
    finally:
        os.chdir(cwd)
    return run_dir / "init.pt"


def _records(run_dir):
    lines = (run_dir / "text-recognition-metrics.jsonl").read_text().splitlines()
    return [json.loads(line) for line in lines]


def _shape(out: str) -> list[str]:
    """The printed lines with their numbers and quoted texts blanked."""
    lines = [re.sub(r'"[^"]*"', '""', line) for line in out.splitlines()]
    return [re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "#", line) for line in lines]


def test_trainer_matches_jax_from_the_same_weights(jax_init, tmp_path, monkeypatch, capsys):
    args = ["synthetic", "-", *SMALL, "--no-bf16", "--num-devices", "1"]
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jax_train_rec.main(args)
    jax_out = capsys.readouterr().out
    monkeypatch.chdir(tmp_path / "port")
    state = train_rec.main([*args, "--checkpoint", str(jax_init)], device="cpu")
    port_out = capsys.readouterr().out
    assert state.step == 1

    (want,) = [r for r in _records(tmp_path / "jax") if "epoch" in r]
    config, got = _records(tmp_path / "port")
    assert config == {**config, "event": "config", "batch_size": 8, "dataset_size": 8,
                      "model_params": 2426913, "seed": 1234, "mesh_devices": 1}
    assert got.keys() == want.keys() and got["epoch"] == 0
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-4)
    assert got["train_accuracy"] == want["train_accuracy"]
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-3)
    assert abs(got["val_accuracy"]["char_error_rate"]
               - want["val_accuracy"]["char_error_rate"]) <= 0.05
    # The same lines in the same order: param count, previews, grad norm,
    # epoch losses and CERs, learning rate.
    assert _shape(port_out) == _shape(jax_out)
    assert "Model param count 2426913" in port_out
    assert (tmp_path / "port" / "text-rec-checkpoint.pt").exists()


def test_export_of_jax_weights_equals_the_jax_export(jax_init, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert train_rec.main(["synthetic", "-", "--checkpoint", str(jax_init), "--export", "x.pt"],
                          device="cpu") is None
    got, want = torch.load("x.pt", weights_only=True), torch.load(jax_init, weights_only=True)
    assert got["optimizer_state"] == want["optimizer_state"] == {}
    assert got["epoch"] == want["epoch"] == 0
    assert got["model_state"].keys() == want["model_state"].keys()
    for key, value in want["model_state"].items():
        assert got["model_state"][key].dtype == value.dtype, key
        assert torch.equal(got["model_state"][key], value), key


def test_resume_restores_adam_step_and_epoch(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    first = train_rec.main(["synthetic", "-", *SMALL], device="cpu")
    ckpt = torch.load("text-rec-checkpoint.pt", weights_only=True)
    assert ckpt["epoch"] == 1 and ckpt["step"] == 1
    adam = first.optimizer.adam.state_dict()
    for i, s in adam["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(ckpt["optimizer_state"]["state"][i][key], s[key]), (i, key)

    # --max-epochs 2 from the checkpoint runs one more epoch (epoch 1).
    args = ["synthetic", "-", *SMALL[:4], "--max-epochs", "2", "--no-augment",
            "--checkpoint", "text-rec-checkpoint.pt"]
    second = train_rec.main(args, device="cpu")
    assert second.step == 2
    assert [r["epoch"] for r in _records(tmp_path) if "epoch" in r] == [0, 1]
    ckpt = torch.load("text-rec-checkpoint.pt", weights_only=True)
    assert ckpt["epoch"] == 2 and ckpt["step"] == 2
    assert float(ckpt["optimizer_state"]["state"][0]["step"]) == 2


def test_validate_only_prints_a_finite_loss(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    train_rec.main(["synthetic", "-", "--max-images", "8", "--validate-only"], device="cpu")
    (line,) = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Validation")]
    loss = float(line.split()[2])
    assert np.isfinite(loss) and "char error rate" in line
    assert not os.path.exists("text-rec-checkpoint.pt")


def test_nan_loss_raises_the_jax_message(tmp_path, monkeypatch):
    # A NaN learning rate turns the weights to NaN after the first step,
    # so the second step's loss is NaN.
    monkeypatch.chdir(tmp_path)
    args = ["synthetic", "-", "--max-images", "16", "--batch-size", "8", "--max-epochs", "1",
            "--no-augment", "--lr", "nan"]
    with pytest.raises(RuntimeError) as err:
        train_rec.main(args, device="cpu")
    assert str(err.value) == NAN_MESSAGE


@pytest.mark.parametrize("args,error,match", [
    (["--num-devices", "3"], ValueError, "--batch-size 20 is not a multiple of the 3 ranks"),
    (["--export", "w.txt"], ValueError, "use .npz, .pt or .onnx"),
    (["--checkpoint", "missing.pt"], FileNotFoundError, "missing.pt"),
])
def test_refusals(tmp_path, monkeypatch, args, error, match):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(error, match=re.escape(match)):
        train_rec.main(["synthetic", "-", *args], device="cpu")
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("ext", ["npz", "onnx"])
def test_export_writes_npz_and_onnx(tmp_path, monkeypatch, ext):
    """``--export`` writes the file and nothing else; the trainer's fresh
    model (seeded) exported as ``.pt`` too gives the weights to check."""
    monkeypatch.chdir(tmp_path)
    assert train_rec.main(["synthetic", "-", "--export", f"w.{ext}"], device="cpu") is None
    assert train_rec.main(["synthetic", "-", "--export", "w.pt"], device="cpu") is None
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted([f"w.{ext}", "w.pt"])
    sd = torch.load("w.pt", weights_only=True)["model_state"]
    if ext == "onnx":
        model = check_bytes((tmp_path / "w.onnx").read_bytes())
        assert model.graph.inputs == [("line_image", ["batch", 1, 64, "seq"])]
        assert model.graph.outputs == [("chars", ["out_seq", "batch", 97])]
    else:
        flat = np.load("w.npz")
        gru = flat["params/gru/layer_1/w_hh_bwd"]
        assert len(flat.files) == 44 and torch.equal(
            torch.from_numpy(gru.T), sd["gru.weight_hh_l1_reverse"])


def test_hiertext_is_refused(tmp_path):
    # Without its dataset: a missing root is named (the toy-root runs are
    # in test_torch_realdata.py).
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "train")):
        train_rec.main(["hiertext", str(tmp_path)], device="cpu")
    with pytest.raises(SystemExit):  # argparse refuses an unknown dataset type
        train_rec.main(["coco", "-"], device="cpu")


def test_main_without_cuda_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_rec.main(["synthetic", "-", *SMALL])
    assert list(tmp_path.iterdir()) == []
