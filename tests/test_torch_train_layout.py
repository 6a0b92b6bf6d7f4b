"""The port's layout training against the JAX package's, on the CPU: the
train and eval steps, the trainer CLI and the evaluation CLI.

Dropout's random stream cannot be matched across the two packages, so the
parity tests of training take it out on both sides, inside the test only:
``torch_port_common.patch_jax_dropout`` gives the JAX layout module a
``Dropout`` of rate 0 (the JAX package is not changed) and
``no_port_dropout`` sets p=0 on the port's ``Dropout`` modules. Evaluation
(``eval_step``, ``--validate-only``, ``eval_layout``) has no dropout and is
compared as shipped.

Tolerances, and why (float32 unless named; "read" is what this CPU gave):

- the step (d_model 32, 2 layers, 8 pages of 24 words, two of them
  zero-weight padding rows): first step loss 1e-5 relative (read 0), grad
  norm and per-module grad norms 1e-4 (read 2.4e-7; LayerNorm's variance
  in another formula, sums in another order), probabilities 1e-5 (read
  1.8e-7); after three Adam steps loss 1e-4 (read 6e-7), grad norms 1e-3
  (read 5.7e-6), probabilities 1e-4 (read 2.4e-6) and parameters within
  ``2 * lr * steps`` (read 3.7e-4: an entry whose gradient is near 0 may
  step the other way, Adam's first steps being about ``+-lr``).
  ``grad_accum=2`` against one step of the same port: loss 1e-6 relative,
  grad norms 1e-5. bf16 against JAX's bf16 step: loss 1e-3 (read 3.1e-4)
  and grad norms 1e-2 relative (read 8.1e-4).
- the trainer (the full-width model from the JAX trainer's ``--export
  init.pt``): ``Model param count`` and the printed lines equal;
  ``--validate-only`` loss 1e-5 relative (read 4.4e-7) and equal
  statistics on ``synthetic``, ``synthetic-doc`` and a ``write_corpus``
  directory; one training epoch on 8 pages (one step), its train loss and
  the validation loss after the step 1e-5 relative (read 7.8e-7, 3.2e-7).
- ``eval_layout``: the PNG equal to the JAX CLI's PIL image, pixel for
  pixel, in all three ``--colors`` modes and without (layout seed 20, whose
  labels hold line starts and other words; seed 13 predicted none).
"""

import json
import re
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import ocrs_models_tpu.models.layout as jax_layout
from ocrs_models_tpu.data.collate import collate_layout as jax_collate_layout
from ocrs_models_tpu.data.layout_synth import write_corpus as jax_write_corpus
from ocrs_models_tpu.export.torch_export import export_layout_state_dict
from ocrs_models_tpu.training import eval_layout as jax_eval_layout
from ocrs_models_tpu.training import train_layout as jax_train_layout
from ocrs_models_tpu.training.state import TrainState as JaxTrainState
from ocrs_models_tpu.training.state import create_train_state as jax_create_train_state
from ocrs_models_tpu.training.state import make_optimizer as jax_make_optimizer
from ocrs_models_tpu.training.steps import make_layout_steps as jax_make_layout_steps
from ocrs_models_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from ocrs_models_tpu.utils.render import draw_word_boxes as pil_draw_word_boxes
from ocrs_models_torch.data import SyntheticLayout
from ocrs_models_torch.models import LayoutModel
from ocrs_models_torch.models.layout import Dropout
from ocrs_models_torch.training import eval_layout, train_layout
from ocrs_models_torch.training.state import create_train_state
from ocrs_models_torch.training.steps import layout_module_names, make_layout_steps
from ocrs_models_torch.utils.render import draw_word_boxes, write_png
from ocrs_models_torch.weights import layout_state_dict_from_jax
from torch_port_common import (
    assert_export_equals_jax,
    layout_variables,
    no_port_dropout,
    patch_jax_dropout,
)

SMALL = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64)
LR = 1e-3
CLI = ["--no-bf16", "--num-devices", "1"]


def _batch(n: int = 6, batch_multiple: int = 4, seed: int = 3) -> dict:
    samples = [SyntheticLayout(size=n, n_words=24, seed=seed)[i] for i in range(n)]
    batch = jax_collate_layout(samples, batch_multiple=batch_multiple)
    del batch["n_valid"]
    return batch


def _setup(monkeypatch, grad_accum=1, pos_embedding="sin", jax_dtype=jnp.float32,
           torch_dtype=torch.float32):
    patch_jax_dropout(monkeypatch)
    jax_model = jax_layout.LayoutModel(pos_embedding=pos_embedding, dtype=jax_dtype, **SMALL)
    variables = layout_variables(jax_layout.LayoutModel(pos_embedding=pos_embedding, **SMALL), 1)
    tx = jax_make_optimizer(None)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jax_state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                              opt_state=tx.init(params), tx=tx)
    port = LayoutModel(pos_embedding=pos_embedding, dtype=torch_dtype, **SMALL)
    port.load_state_dict(
        layout_state_dict_from_jax(variables, SMALL["n_layers"], pos_embedding), strict=True)
    no_port_dropout(port)
    return (jax_make_layout_steps(jax_model, grad_accum=grad_accum), jax_state,
            make_layout_steps(port, grad_accum=grad_accum), create_train_state(port))


def _run(monkeypatch, steps, grad_accum, **kwargs):
    (jax_train, _), jax_state, (train, _), state = _setup(monkeypatch, grad_accum, **kwargs)
    batch = _batch()
    jax_batch = jax.tree_util.tree_map(jnp.asarray, batch)
    jax_metrics, port_metrics = [], []
    for _ in range(steps):
        jax_state, m = jax_train(jax_state, jax_batch, jnp.float32(LR), jax.random.key(0))
        jax_metrics.append(jax.tree_util.tree_map(np.asarray, m))
        state, m = train(state, batch, LR, torch.Generator().manual_seed(0))
        port_metrics.append(m)
    return jax_state, jax_metrics, state, port_metrics


@pytest.mark.parametrize("steps,grad_accum", [(1, 1), (3, 1), (1, 2), (3, 2)])
def test_layout_train_step_matches_jax(monkeypatch, steps, grad_accum):
    jax_state, jax_metrics, state, port_metrics = _run(monkeypatch, steps, grad_accum)
    for i, (jm, pm) in enumerate(zip(jax_metrics, port_metrics)):
        first = i == 0
        np.testing.assert_allclose(pm["loss"].item(), jm["loss"], rtol=1e-5 if first else 1e-4)
        np.testing.assert_allclose(pm["grad_norm"].item(), jm["grad_norm"],
                                   rtol=1e-4 if first else 1e-3)
        assert pm["grad_norms"].keys() == jm["grad_norms"].keys()
        for k, v in jm["grad_norms"].items():
            np.testing.assert_allclose(pm["grad_norms"][k].item(), v,
                                       rtol=1e-4 if first else 1e-3, err_msg=k)
        assert pm["probs"].shape == jm["probs"].shape == (8, 24, 2)
        np.testing.assert_allclose(pm["probs"].numpy(), jm["probs"], rtol=0,
                                   atol=1e-5 if first else 1e-4)
    assert state.step == steps
    want = layout_state_dict_from_jax({"params": jax_state.params}, SMALL["n_layers"])
    for key, value in want.items():
        diff = float((state.model.state_dict()[key] - value).abs().max())
        assert diff <= 2 * LR * steps + 1e-6, key


def test_grad_accum_equals_one_step(monkeypatch):
    batch = _batch(n=8, batch_multiple=1)
    batch["sample_weight"][5:] = 0.0  # padding rows spread over both microbatches
    out = []
    for grad_accum in (1, 2):
        (_, _), _, (train, _), state = _setup(monkeypatch, grad_accum)
        out.append(train(state, batch, LR)[1])
    one, two = out
    np.testing.assert_allclose(two["loss"].item(), one["loss"].item(), rtol=1e-6)
    np.testing.assert_allclose(two["grad_norm"].item(), one["grad_norm"].item(), rtol=1e-5)
    for k, v in one["grad_norms"].items():
        np.testing.assert_allclose(two["grad_norms"][k].item(), v.item(), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(two["probs"].numpy(), one["probs"].numpy(), rtol=0, atol=1e-6)


def test_layout_train_step_bf16_matches_jax(monkeypatch):
    _, (jm,), state, (pm,) = _run(monkeypatch, 1, 1, jax_dtype=jnp.bfloat16,
                                  torch_dtype=torch.bfloat16)
    np.testing.assert_allclose(pm["loss"].item(), jm["loss"], rtol=1e-3)
    np.testing.assert_allclose(pm["grad_norm"].item(), jm["grad_norm"], rtol=1e-2)
    for k, v in jm["grad_norms"].items():
        np.testing.assert_allclose(pm["grad_norms"][k].item(), v, rtol=1e-2, err_msg=k)
    assert pm["loss"].dtype == torch.float32
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in state.model.parameters())


def test_layout_eval_step_matches_jax(monkeypatch):
    (_, jax_eval), jax_state, (_, port_eval), state = _setup(monkeypatch)
    batch = _batch()
    want = jax_eval(jax_state, jax.tree_util.tree_map(jnp.asarray, batch))
    state.model.train()
    got = port_eval(state, batch)
    assert state.model.training  # the mode is restored
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("pos_embedding", ["sin", "mlp"])
def test_grad_norm_keys_follow_jax_module_names(monkeypatch, pos_embedding):
    (_, _), _, (train, _), state = _setup(monkeypatch, pos_embedding=pos_embedding)
    variables = layout_variables(jax_layout.LayoutModel(pos_embedding=pos_embedding, **SMALL), 1)
    _, metrics = train(state, _batch(), LR)
    assert set(metrics["grad_norms"]) == set(variables["params"])
    assert set(layout_module_names(state.model).values()) == set(variables["params"])


def test_dropout_follows_flax():
    drop = Dropout(0.1).train()
    x = torch.ones(200_000)
    y = drop(x, torch.Generator().manual_seed(0))
    assert abs(float((y == 0).float().mean()) - 0.1) < 0.005
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1.0 / 0.9))
    assert torch.equal(y, drop(x, torch.Generator().manual_seed(0)))
    assert torch.equal(drop.eval()(x), x)
    # The JAX model never hands its dropout field to its layers: each drops
    # at 0.1 whatever the model says.
    model = LayoutModel(dropout=0.5, **SMALL)
    assert {m.p for m in model.modules() if isinstance(m, Dropout)} == {0.1}


def test_train_step_draws_dropout_from_the_generator():
    batch = _batch()
    losses = []
    for seed in (0, 0, 1):
        torch.manual_seed(5)
        model = LayoutModel(**SMALL)
        train, _ = make_layout_steps(model)
        _, metrics = train(create_train_state(model), batch, LR, torch.Generator().manual_seed(seed))
        losses.append(metrics["loss"].item())
    assert losses[0] == losses[1] != losses[2]


# ---------------------------------------------------------------- trainer

@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """The JAX trainer's initial weights, exported as a reference-format .pt."""
    run_dir = tmp_path_factory.mktemp("jax_layout_init")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(run_dir)
        jax_train_layout.main(["synthetic", "--export", "init.pt", "--no-bf16"])
    return run_dir / "init.pt"


def _records(run_dir):
    lines = (run_dir / "text-layout-metrics.jsonl").read_text().splitlines()
    return [json.loads(line) for line in lines]


def _shape(out: str) -> list[str]:
    return [re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "#", line) for line in out.splitlines()]


def _capture_val_loss(monkeypatch, module):
    """Record each ``run_epoch`` result of ``module`` (the trainers print no
    loss under ``--validate-only``)."""
    results = []
    run_epoch = module.run_epoch

    def recording(*args, **kwargs):
        out = run_epoch(*args, **kwargs)
        results.append(out)
        return out

    monkeypatch.setattr(module, "run_epoch", recording)
    return results


@pytest.mark.parametrize("source", ["synthetic", "synthetic-doc", "corpus"])
def test_validate_only_matches_jax(jax_init, tmp_path, monkeypatch, capsys, source):
    data = source
    if source == "corpus":
        jax_write_corpus(str(tmp_path / "corpus"), 10, seed=5)
        data = str(tmp_path / "corpus")
    args = [data, "--validate-only", "--batch-size", "16", *CLI]
    monkeypatch.chdir(tmp_path)
    jax_results = _capture_val_loss(monkeypatch, jax_train_layout)
    jax_train_layout.main(args)
    jax_out = capsys.readouterr().out
    port_results = _capture_val_loss(monkeypatch, train_layout)
    state = train_layout.main([*args, "--checkpoint", str(jax_init)], device="cpu")
    port_out = capsys.readouterr().out
    assert state.step == 0
    (want_loss, want_stats), = jax_results
    (got_loss, got_stats), = port_results
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert got_stats.stats_dict() == want_stats.stats_dict()
    assert port_out == jax_out  # param count and the stats line
    assert "Model param count 4739074" in port_out


def test_trainer_matches_jax_from_the_same_weights(jax_init, tmp_path, monkeypatch, capsys):
    patch_jax_dropout(monkeypatch)
    init = Dropout.__init__
    monkeypatch.setattr(Dropout, "__init__", lambda self, p=0.1: init(self, 0.0))
    args = ["synthetic", "--max-images", "8", "--batch-size", "8", "--max-epochs", "1", *CLI]
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jax_train_layout.main(args)
    jax_out = capsys.readouterr().out
    monkeypatch.chdir(tmp_path / "port")
    state = train_layout.main([*args, "--checkpoint", str(jax_init)], device="cpu")
    port_out = capsys.readouterr().out
    assert state.step == 1
    assert {m.p for m in state.model.modules() if isinstance(m, Dropout)} == {0.0}

    (want,) = [r for r in _records(tmp_path / "jax") if "epoch" in r]
    config, got = _records(tmp_path / "port")
    assert config == {**config, "event": "config", "dataset_size": 8, "model_params": 4739074,
                      "seed": 1234, "mesh_devices": 1}
    assert got.keys() == want.keys() and got["epoch"] == 0
    np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-12)
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)
    assert _shape(port_out) == _shape(jax_out)
    assert (tmp_path / "port" / "text-layout-checkpoint.pt").exists()


def test_resume_restores_adam_step_and_epoch(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ["synthetic", "--max-images", "4", "--batch-size", "16", *CLI]
    first = train_layout.main([*args, "--max-epochs", "2"], device="cpu")
    assert first.step == 2
    records = [r for r in _records(tmp_path) if "epoch" in r]
    best = int(np.argmin([r["val_loss"] for r in records]))
    ckpt = torch.load("text-layout-checkpoint.pt", weights_only=True)
    assert ckpt["epoch"] == best + 1 and ckpt["step"] == best + 1  # the next epoch to run
    assert {float(s["step"]) for s in ckpt["optimizer_state"]["state"].values()} == {best + 1.0}
    second = train_layout.main(
        [*args, "--checkpoint", "text-layout-checkpoint.pt", "--max-epochs", str(best + 2)],
        device="cpu")
    assert second.step == best + 2
    assert float(second.optimizer.adam.state_dict()["state"][0]["step"]) == best + 2
    assert [r["epoch"] for r in _records(tmp_path) if "epoch" in r][-1] == best + 1


def test_export_of_jax_weights_equals_the_jax_export(jax_init, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert train_layout.main(["synthetic", "--checkpoint", str(jax_init), "--export", "x.pt"],
                             device="cpu") is None
    got, want = torch.load("x.pt", weights_only=True), torch.load(jax_init, weights_only=True)
    assert got["optimizer_state"] == want["optimizer_state"] == {}
    assert got["model_state"].keys() == want["model_state"].keys()
    for key, value in want["model_state"].items():
        assert torch.equal(got["model_state"][key], value), key


@pytest.mark.parametrize("ext", ["onnx", "npz"])
def test_export_onnx_and_npz_equal_the_jax_package(jax_init, tmp_path, monkeypatch, ext):
    monkeypatch.chdir(tmp_path)
    assert train_layout.main(["synthetic", "--checkpoint", str(jax_init), "--export", f"x.{ext}"],
                             device="cpu") is None
    assert [p.name for p in tmp_path.iterdir()] == [f"x.{ext}"]
    assert_export_equals_jax(tmp_path / f"x.{ext}", "layout",
                             torch.load(jax_init, weights_only=True)["model_state"])


@pytest.mark.parametrize("flag,dtype", [([], torch.bfloat16), (["--bf16"], torch.bfloat16),
                                        (["--no-bf16"], torch.float32)])
def test_bf16_flag_picks_the_model_dtype(tmp_path, monkeypatch, flag, dtype):
    monkeypatch.chdir(tmp_path)
    state = train_layout.main(["synthetic", "--max-epochs", "0", *flag], device="cpu")
    assert state.model.dtype == dtype
    assert all(p.dtype == torch.float32 for p in state.model.parameters())


def test_trainer_refuses_several_devices(tmp_path, monkeypatch):
    # Several devices train (tests/test_torch_parallel_cli.py), each rank
    # taking --batch-size // N rows a step: a batch the ranks do not divide
    # is refused before any rank starts.
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="--batch-size 64 is not a multiple of the 3 ranks"):
        train_layout.main(["synthetic", "--num-devices", "3"], device="cpu")
    assert list(tmp_path.iterdir()) == []


# -------------------------------------------------------------- eval_layout

@pytest.fixture(scope="module")
def eval_weights(tmp_path_factory):
    """One set of full-width weights as a JAX checkpoint directory and as
    the .pt the port reads, and a page written by ``write_corpus``."""
    root = tmp_path_factory.mktemp("eval_layout")
    model = jax_layout.LayoutModel(return_probs=True)
    variables = layout_variables(jax_layout.LayoutModel(), seed=20)
    state = jax_create_train_state(model, jax.random.key(0), jnp.zeros((1, 8, 4)))
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    jax_save_checkpoint(str(root / "jax_ckpt"), state, 0)
    sd = {k: torch.tensor(v) for k, v in export_layout_state_dict(variables).items()}
    torch.save({"epoch": 0, "model_state": sd, "optimizer_state": {}}, root / "layout.pt")
    jax_write_corpus(str(root / "pages"), 1, seed=9)
    return root


@pytest.mark.parametrize("colors", [None, "labels", "line-start-probs", "line-end-probs"])
def test_eval_layout_png_matches_jax(eval_weights, tmp_path, capsys, colors):
    page = str(eval_weights / "pages" / "page-00000.json")
    flags = [] if colors is None else ["--colors", colors]
    jax_eval_layout.main([page, str(tmp_path / "jax.png"), "--checkpoint",
                          str(eval_weights / "jax_ckpt"), *flags])
    jax_out = capsys.readouterr().out
    eval_layout.main([page, str(tmp_path / "port.png"), "--checkpoint",
                      str(eval_weights / "layout.pt"), *flags], device="cpu")
    assert capsys.readouterr().out == jax_out
    want = np.asarray(Image.open(tmp_path / "jax.png").convert("RGB"))
    got_img = Image.open(tmp_path / "port.png")
    assert got_img.mode == "RGB"
    got = np.asarray(got_img)
    assert got.shape == want.shape and (got != 255).any()
    np.testing.assert_array_equal(got, want)
    if colors == "labels":
        assert len(np.unique(got.reshape(-1, 3), axis=0)) > 2  # several label colours


def test_draw_word_boxes_matches_pil(tmp_path):
    rng = np.random.default_rng(2)
    boxes = rng.uniform(-5, 90, (60, 4))
    boxes[:, 2:] = boxes[:, :2] + rng.choice([0.0, 0.4, 1.5, 3.0, 20.0], (60, 2))
    boxes[:5] = 0.0  # zero-area padding boxes are skipped
    labels = rng.uniform(size=(60, 2)) < 0.5
    probs = rng.uniform(size=60)
    for kwargs in ({}, {"labels": labels}, {"probs": probs},
                   {"normalized_coords": True, "probs": probs}):
        b = boxes / 100 - 0.5 if kwargs.get("normalized_coords") else boxes
        pil_draw_word_boxes(str(tmp_path / "want.png"), 80, 70, b, **kwargs)
        draw_word_boxes(str(tmp_path / "got.png"), 80, 70, b, **kwargs)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "got.png")),
                                      np.asarray(Image.open(tmp_path / "want.png")),
                                      err_msg=str(kwargs.keys()))


def test_png_decodes_with_zlib(tmp_path):
    rgb = np.random.default_rng(0).integers(0, 256, (7, 5, 3), dtype=np.uint8)
    write_png(str(tmp_path / "x.png"), rgb)
    data = (tmp_path / "x.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    width, height = struct.unpack(">II", data[16:24])
    (idat_len,) = struct.unpack(">I", data[33:37])
    assert data[37:41] == b"IDAT"
    raw = np.frombuffer(zlib.decompress(data[41 : 41 + idat_len]), np.uint8)
    np.testing.assert_array_equal(raw.reshape(height, 1 + width * 3)[:, 1:].reshape(7, 5, 3), rgb)
