"""The port's detection training against the JAX package's, on the CPU:
the balanced BCE, the train and eval steps, the trainer CLI and the
inference CLI.

Tolerances, and why (float32 unless named; "read" is what this CPU gave):

- ``balanced_cross_entropy_loss``: value and gradient 1e-6 (read 1.2e-7
  and 0), with tied entries at the k-th value (they share the leftover
  slots equally on both sides), zero-weight rows, targets outside [0, 1]
  and an empty class.
- the step (a narrow U-Net, depth 4-64, 4 pages of 128x96, one of them a
  zero-weight padding row), as ``test_torch_train_steps.py`` holds the
  recognition step: the two forwards agree to ~1e-5, but a max-pool
  window whose two candidates lie closer than that can route its gradient
  to the other one, which moves the gradients above the pools (the port's
  own float64 step reads down_0's gradient norm 3.4e-3 from its float32
  step, and within 1e-5 of JAX's). First step: loss 1e-5 relative (read
  1.2e-7), grad norm 1e-3 (read 4.7e-5), per-module grad norms 1e-2
  (read 3.4e-3), probabilities 5e-5 (read 1.1e-5). After three Adam
  steps (Adam's first steps are about ``+-lr`` an entry, so entries whose
  gradients differ in sign step apart, and the runs drift): loss 1e-4
  (read 1.3e-5), grad norm 2e-2 (read 3.9e-3), per-module grad norms 1e-1
  (read 4.0e-2), probabilities 2e-2 (read 6.2e-3), parameters within ``2
  * lr * steps`` (read 3.3e-3 of 6e-3), batch-norm running statistics
  within 1e-2 of their largest (read 2.4e-3). The balanced BCE picks the
  top k pixel losses, and among the thousands of losses of a 128x96 page
  neighbours lie about 1e-5 apart, near float noise; so the step's masks
  keep as many negative pixels as positives on each page and set the
  others to 0.5, which neither pool takes: ``k`` then takes every pixel
  of both pools in every microbatch, and the tests assert it (the k-th and
  (k+1)-th losses of each pool more than 1e-4 apart, or no (k+1)-th). The
  selection itself, ties included, is held to JAX's by the loss tests.
  ``grad_accum=2`` against the sum of its microbatches' losses: 1e-6
  relative.
- bf16 against JAX's bf16 step (the ``bf16_dots_in_f32`` fixture), the
  band of ``test_torch_bf16.py``'s recognition step, widened: loss 1e-2
  (read 3.2e-3), grad norm 1e-1 (read 4.4e-2), per-module grad norms
  2.5e-1 (read 1.8e-1 for ``down_4``, 6e-3 to 1.2e-1 for the others).
  cuDNN's bf16 convolutions round at other points than JAX's nine bf16
  multiply-adds of the depthwise conv, and bf16 activations tie exactly in
  many max-pool windows, whose gradient JAX splits among the tied
  maxima and torch gives to one of them.
- the trainer (the full-width model from the JAX trainer's ``--export
  init.pt``, 192x144 masks): ``Model param count`` and the printed lines
  equal but for numbers; one epoch of one step on 8 augmented pages, its
  train and validation losses 1e-5 relative (read 8.3e-7 and 4.7e-7). ``--validate-only`` from fixed weights:
  the loss 1e-5 relative and the box-match metrics 1e-12, on pages where
  no probability lies within 1e-4 of 0.5 (asserted: the metrics come from
  the binarised masks).
- ``eval_detection``: ``-input.png``, ``-text-regions.png`` and
  ``-text-words.png`` equal to the JAX CLI's PIL images, pixel for pixel
  (the page's probabilities lie 1e-4 or more from 0.5, asserted),
  ``-text-probs.png`` within one grey level (the probabilities within
  1e-5 truncate to 8 bits).
"""

import functools
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ocrs_models_tpu.data import SyntheticDetection as JaxSyntheticDetection
from ocrs_models_tpu.data.augment import DetectionAugment as JaxDetectionAugment
from ocrs_models_tpu.data.collate import collate_detection as jax_collate_detection
from ocrs_models_tpu.models import DetectionModel as JaxDetection
from ocrs_models_tpu.ops.losses import balanced_cross_entropy_loss as jax_balanced_bce
from ocrs_models_tpu.training import eval_detection as jax_eval_detection
from ocrs_models_tpu.training import train_detection as jax_train_detection
from ocrs_models_tpu.training.state import TrainState as JaxTrainState
from ocrs_models_tpu.training.state import create_train_state as jax_create_train_state
from ocrs_models_tpu.training.state import make_optimizer as jax_make_optimizer
from ocrs_models_tpu.training.steps import make_detection_steps as jax_make_detection_steps
from ocrs_models_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from ocrs_models_torch.models import DetectionModel
from ocrs_models_torch.ops.losses import balanced_cross_entropy_loss
from ocrs_models_torch.training import eval_detection, train_detection
from ocrs_models_torch.training.state import create_train_state
from ocrs_models_torch.training.steps import detection_module_names, make_detection_steps
from ocrs_models_torch.weights import detection_state_dict_from_jax
from torch_port_common import assert_export_equals_jax, patch_bf16_dots_in_f32, random_variables

DEPTH = (4, 8, 16, 32, 40, 48, 64)  # both of the JAX model's layouts, at small widths
SIZE = (128, 96)
LR = 1e-3
CLI = ["--no-bf16", "--mask-height", "192", "--num-devices", "1"]
MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """XLA's CPU threads and torch's contend in one process: the port's
    step runs 50x slower beside the JAX step at torch's default thread
    count. Two threads for the module's duration."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------- loss


def _loss_cases():
    rng = np.random.default_rng(0)
    pred = rng.uniform(0.01, 0.99, (3, 1, 12, 10)).astype(np.float32)
    target = (rng.uniform(size=pred.shape) > 0.7).astype(np.float32)
    yield "plain", pred, target, None
    yield "zero-weight rows", pred, target, np.array([1, 0, 1], np.float32)
    # Quantised predictions: many equal pixel losses, so the k-th value is
    # tied across several pixels in both pools.
    tied = np.round(pred * 4) / 4
    tied = np.clip(tied, 0.25, 0.75).astype(np.float32)
    yield "ties", tied, target, np.array([1, 1, 0], np.float32)
    # Augmented targets stray outside [0, 1].
    yield "targets outside [0, 1]", pred, (target * 1.02 - 0.01).astype(np.float32), None
    yield "no positives", pred, np.zeros_like(target), None


@pytest.mark.parametrize("case", [c[0] for c in _loss_cases()])
def test_balanced_bce_matches_jax(case):
    _, pred, target, weight = next(c for c in _loss_cases() if c[0] == case)
    want, want_grad = jax.value_and_grad(
        lambda p: jax_balanced_bce(p, jnp.asarray(target), None if weight is None
                                   else jnp.asarray(weight)))(jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    got = balanced_cross_entropy_loss(p, torch.from_numpy(target),
                                      None if weight is None else torch.from_numpy(weight))
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), rtol=0, atol=1e-6)
    if case == "ties":
        # The leftover slots are shared: some tied entries get a fraction.
        g = np.abs(p.grad.numpy()[p.grad.numpy() != 0])
        assert len(np.unique(np.round(g * np.abs(np.log(0.25)) * 1e4))) > 1
    if case == "no positives":
        assert got.item() == 0.0 and not p.grad.any()


def test_balanced_bce_counts_k_within_valid_rows():
    pred = torch.full((2, 1, 2, 2), 0.5)
    target = torch.tensor([[[[1.0, 1.0], [1.0, 0.0]]], [[[0.0, 0.0], [0.0, 0.0]]]])
    # Row 0 alone: 3 positives, 1 negative, so k = 1 and the loss is log 2.
    got = balanced_cross_entropy_loss(pred, target, torch.tensor([1.0, 0.0]))
    np.testing.assert_allclose(got.item(), np.log(2.0), rtol=1e-6)
    both = balanced_cross_entropy_loss(pred, target)  # k = min(3, 5) = 3
    np.testing.assert_allclose(both.item(), np.log(2.0), rtol=1e-6)


# ------------------------------------------------------------------- step


def _batch(n: int = 3, batch_multiple: int = 4, seed: int = 1) -> dict:
    """NHWC numpy pages of the JAX dataset at ``SIZE`` (one zero-weight
    padding row with the defaults). On each page all but as many negative
    pixels as it has positives are set to 0.5, which neither pool takes, so
    that ``k`` takes every pixel of both pools (see the module
    docstring)."""
    ds = JaxSyntheticDetection(size=n, page_size=(256, 192), seed=seed,
                               transform=JaxDetectionAugment(SIZE, augment=False))
    batch = jax_collate_detection([ds[i] for i in range(n)], batch_multiple=batch_multiple)
    del batch["n_valid"], batch["path"]
    rng = np.random.default_rng(seed)
    for page in batch["mask"]:
        flat = page.reshape(-1)
        neg = np.flatnonzero(flat < 0.5)
        n_pos = int(np.sum(flat > 0.5))
        assert 0 < n_pos < len(neg)
        flat[rng.permutation(neg)[n_pos:]] = 0.5
    return batch


def _nchw(batch: dict) -> dict:
    out = dict(batch)
    for key in ("image", "mask"):
        out[key] = np.ascontiguousarray(batch[key].transpose(0, 3, 1, 2))
    return out


@functools.lru_cache(maxsize=None)
def _jax_steps(grad_accum, dtype):
    """JAX's jitted steps, built once a configuration (each compiles once)."""
    return jax_make_detection_steps(JaxDetection(depth_scale=DEPTH, dtype=dtype),
                                    grad_accum=grad_accum)


def _setup(grad_accum=1, jax_dtype=jnp.float32, torch_dtype=torch.float32):
    variables = random_variables(JaxDetection(depth_scale=DEPTH), (1, *SIZE, 1), seed=5)
    tx = jax_make_optimizer(None)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jax_state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params), tx=tx,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]))
    port = DetectionModel(depth_scale=DEPTH, dtype=torch_dtype)
    port.load_state_dict(detection_state_dict_from_jax(variables), strict=True)
    return (_jax_steps(grad_accum, jax_dtype), jax_state,
            make_detection_steps(port, grad_accum=grad_accum), create_train_state(port))


def _run(steps, grad_accum, **kwargs):
    (jax_train, _), jax_state, (train, _), state = _setup(grad_accum, **kwargs)
    batch = _batch()
    jax_batch = jax.tree_util.tree_map(jnp.asarray, batch)
    jax_metrics, port_metrics = [], []
    for _ in range(steps):
        jax_state, m = jax_train(jax_state, jax_batch, jnp.float32(LR))
        jax_metrics.append(jax.tree_util.tree_map(np.asarray, m))
        state, m = train(state, _nchw(batch), LR)
        port_metrics.append(m)
    return jax_state, jax_metrics, state, port_metrics


def _top_k_margin(pred: np.ndarray, mask: np.ndarray, weight: np.ndarray) -> float:
    """The least gap, over both pools, between the k-th and (k+1)-th
    largest pixel losses of the balanced BCE: how far float noise is from
    changing which pixels it picks (1 where a pool holds no more than k)."""
    valid = (weight > 0)[:, None, None, None]
    loss = -(mask * np.log(np.maximum(pred, 1e-12))
             + (1 - mask) * np.log(np.maximum(1 - pred, 1e-12))).astype(np.float64)
    pools = [np.sort(loss[(mask > 0.5) & valid])[::-1], np.sort(loss[(mask < 0.5) & valid])[::-1]]
    k = min(len(p) for p in pools)
    return min((p[k - 1] - p[k]) if len(p) > k else 1.0 for p in pools)


@pytest.mark.parametrize("steps,grad_accum", [(1, 1), (3, 1), (1, 2), (3, 2)])
def test_detection_train_step_matches_jax(steps, grad_accum):
    jax_state, jax_metrics, state, port_metrics = _run(steps, grad_accum)
    batch = _batch()
    for i, (jm, pm) in enumerate(zip(jax_metrics, port_metrics)):
        first = i == 0
        assert pm["pred"].shape == (4, 1, *SIZE)
        pred = pm["pred"].numpy()
        mask = _nchw(batch)["mask"]
        if grad_accum == 1:
            assert _top_k_margin(pred, mask, batch["sample_weight"]) > MARGIN
        else:
            for j in range(grad_accum):
                assert _top_k_margin(pred[j::grad_accum], mask[j::grad_accum],
                                     batch["sample_weight"][j::grad_accum]) > MARGIN
        np.testing.assert_allclose(pm["loss"].item(), jm["loss"], rtol=1e-5 if first else 1e-4)
        np.testing.assert_allclose(pm["grad_norm"].item(), jm["grad_norm"],
                                   rtol=1e-3 if first else 2e-2)
        assert pm["grad_norms"].keys() == jm["grad_norms"].keys()
        for k, v in jm["grad_norms"].items():
            np.testing.assert_allclose(pm["grad_norms"][k].item(), v,
                                       rtol=1e-2 if first else 1e-1, err_msg=k)
        np.testing.assert_allclose(pred, jm["pred"].transpose(0, 3, 1, 2), rtol=0,
                                   atol=5e-5 if first else 2e-2)
    assert state.step == steps
    want = detection_state_dict_from_jax({"params": jax_state.params,
                                          "batch_stats": jax_state.batch_stats})
    got = state.model.state_dict()
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        diff = float((got[key] - value).abs().max())
        if key.endswith(("running_mean", "running_var")):
            assert diff <= 1e-2 * float(value.abs().max()), key
        else:
            assert diff <= 2 * LR * steps + 1e-6, key


def test_grad_accum_pools_per_microbatch():
    batch = _nchw(_batch(n=4, batch_multiple=1))
    batch["sample_weight"][3] = 0.0
    (_, _), _, (train, _), state = _setup(2)
    _, metrics = train(state, batch, LR)
    # Two microbatches: rows 0, 2 and rows 1, 3 (3 has weight 0), weighted
    # by their valid counts 2 and 1, each with its own pools.
    parts = []
    for i in range(2):
        mb = {k: v[i::2] for k, v in batch.items()}
        parts.append((metrics["pred"][i::2], mb))
    want = sum(balanced_cross_entropy_loss(p, torch.from_numpy(mb["mask"]),
                                           torch.from_numpy(mb["sample_weight"]))
               * mb["sample_weight"].sum() for p, mb in parts) / 3.0
    np.testing.assert_allclose(metrics["loss"].item(), want.item(), rtol=1e-6)


def test_detection_train_step_bf16_matches_jax(monkeypatch):
    patch_bf16_dots_in_f32(monkeypatch)
    _, (jm,), state, (pm,) = _run(1, 1, jax_dtype=jnp.bfloat16, torch_dtype=torch.bfloat16)
    np.testing.assert_allclose(pm["loss"].item(), jm["loss"], rtol=1e-2)
    np.testing.assert_allclose(pm["grad_norm"].item(), jm["grad_norm"], rtol=1e-1)
    for k, v in jm["grad_norms"].items():
        np.testing.assert_allclose(pm["grad_norms"][k].item(), v, rtol=2.5e-1, err_msg=k)
    assert pm["loss"].dtype == pm["pred"].dtype == torch.float32
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in state.model.parameters())


def test_detection_eval_step_matches_jax():
    (_, jax_eval), jax_state, (_, port_eval), state = _setup()
    batch = _batch()
    want = jax_eval(jax_state, jax.tree_util.tree_map(jnp.asarray, batch))
    state.model.train()
    got = port_eval(state, _nchw(batch))
    assert state.model.training  # the mode is restored
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["pred"].numpy(), np.asarray(want["pred"]).transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-5)


def test_grad_norm_keys_follow_jax_module_names():
    variables = random_variables(JaxDetection(depth_scale=DEPTH), (1, *SIZE, 1), seed=5)
    model = DetectionModel(depth_scale=DEPTH)
    assert set(detection_module_names(model).values()) == set(variables["params"])
    train, _ = make_detection_steps(model)
    _, metrics = train(create_train_state(model), _nchw(_batch()), LR)
    assert set(metrics["grad_norms"]) == set(variables["params"])


def test_step_refuses_an_indivisible_batch():
    model = DetectionModel(depth_scale=DEPTH)
    train, _ = make_detection_steps(model, grad_accum=3)
    with pytest.raises(ValueError, match="grad_accum=3"):
        train(create_train_state(model), _nchw(_batch()), LR)
    with pytest.raises(ValueError, match="grad_accum"):
        make_detection_steps(model, grad_accum=0)


# ---------------------------------------------------------------- trainer


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """The JAX trainer's initial weights, exported as a reference-format .pt."""
    run_dir = tmp_path_factory.mktemp("jax_detection_init")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(run_dir)
        jax_train_detection.main(["synthetic", "-", "--export", "init.pt", *CLI])
    return run_dir / "init.pt"


def _records(run_dir):
    lines = (run_dir / "text-detection-metrics.jsonl").read_text().splitlines()
    return [json.loads(line) for line in lines]


def _shape(out: str) -> list[str]:
    """Printed lines with numbers blanked and the metrics dict's keys in
    order (its key order follows string hashing)."""
    def line_shape(line: str) -> str:
        line = re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "#", line)
        return re.sub(r"\{.*\}", lambda m: str(sorted(m.group(0)[1:-1].split(", "))), line)

    return [line_shape(line) for line in out.replace("\r", "\n").splitlines()]


def test_trainer_matches_jax_from_the_same_weights(jax_init, tmp_path, monkeypatch, capsys):
    args = ["synthetic", "-", "--max-images", "8", "--batch-size", "8", "--max-epochs", "1", *CLI]
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jax_train_detection.main(args)
    jax_out = capsys.readouterr().out
    monkeypatch.chdir(tmp_path / "port")
    state = train_detection.main([*args, "--checkpoint", str(jax_init)], device="cpu")
    port_out = capsys.readouterr().out
    assert state.step == 1 and state.model.dtype == torch.float32

    (want,) = [r for r in _records(tmp_path / "jax") if "epoch" in r]
    config, got = _records(tmp_path / "port")
    assert config == {**config, "event": "config", "batch_size": 8, "dataset_size": 8,
                      "model_params": 622122, "seed": 1234, "mesh_devices": 1}
    assert got.keys() == want.keys() and got["epoch"] == 0
    assert got["val_metrics"].keys() == want["val_metrics"].keys()
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)
    assert got["grad_norms"].keys() == want["grad_norms"].keys()
    assert _shape(port_out) == _shape(jax_out)
    assert "Model param count: 622122" in port_out
    ckpt = torch.load(tmp_path / "port" / "text-detection-checkpoint.pt", weights_only=True)
    assert ckpt["epoch"] == 1 and ckpt["step"] == 1  # the next epoch to run


@pytest.fixture(scope="module")
def fixed_weights(tmp_path_factory):
    """Full-width weights (seed 65) as a JAX checkpoint directory and as the
    .pt the port reads. At this seed every probability on the validation
    pages and on the page of ``eval_detection`` lies 0.025 from 0.5 (the
    model calls every pixel text): seeds whose maps cross 0.5 put some
    pixel within 1e-4 of it on these pages."""
    root = tmp_path_factory.mktemp("detection_weights")
    variables = random_variables(JaxDetection(), (1, 64, 64, 1), seed=65)
    state = jax_create_train_state(JaxDetection(), jax.random.key(0), jnp.zeros((1, 64, 64, 1)))
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             variables["batch_stats"]))
    jax_save_checkpoint(str(root / "jax_ckpt"), state, 0)
    torch.save({"epoch": 0, "model_state": detection_state_dict_from_jax(variables),
                "optimizer_state": {}}, root / "det.pt")
    return root


def _recording_eval(monkeypatch, module, preds: list, nhwc: bool):
    make = module.make_detection_steps

    def make_recording(*args, **kwargs):
        train, evaluate = make(*args, **kwargs)

        def recording(state, batch):
            out = evaluate(state, batch)
            pred = np.asarray(out["pred"])
            preds.append(pred[..., 0] if nhwc else pred[:, 0])
            return out

        return train, recording

    monkeypatch.setattr(module, "make_detection_steps", make_recording)


def _metrics_line(out: str) -> dict:
    (line,) = [ln for ln in out.splitlines() if ln.startswith("Validation metrics:")]
    return eval(line.split(":", 1)[1])  # the printed dict of formatted numbers


def test_validate_only_matches_jax(fixed_weights, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    args = ["synthetic", "-", "--validate-only", *CLI]
    jax_preds, port_preds = [], []
    _recording_eval(monkeypatch, jax_train_detection, jax_preds, nhwc=True)
    jax_train_detection.main([*args, "--checkpoint", str(fixed_weights / "jax_ckpt")])
    jax_out = capsys.readouterr().out
    _recording_eval(monkeypatch, train_detection, port_preds, nhwc=False)
    state = train_detection.main([*args, "--checkpoint", str(fixed_weights / "det.pt")],
                                 device="cpu")
    port_out = capsys.readouterr().out
    assert state.step == 0
    for preds in (jax_preds, port_preds):
        assert np.abs(np.concatenate(preds) - 0.5).min() > MARGIN
    want_loss = float(re.search(r"Validation loss (\S+)", jax_out).group(1))
    got_loss = float(re.search(r"Validation loss (\S+)", port_out).group(1))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5, atol=1e-4)
    assert _metrics_line(port_out) == _metrics_line(jax_out)
    assert _shape(port_out) == _shape(jax_out)


def test_resume_restores_adam_step_and_epoch(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ["synthetic", "-", "--max-images", "4", "--no-augment", *CLI]
    first = train_detection.main([*args, "--max-epochs", "2"], device="cpu")
    assert first.step == 2
    ckpt = torch.load("text-detection-checkpoint.pt", weights_only=True)
    epoch = ckpt["epoch"]  # the epoch after the best train loss below 1.0
    assert epoch >= 1 and ckpt["step"] == epoch
    assert {float(s["step"]) for s in ckpt["optimizer_state"]["state"].values()} == {float(epoch)}
    second = train_detection.main(
        [*args, "--checkpoint", "text-detection-checkpoint.pt", "--max-epochs", str(epoch + 1)],
        device="cpu")
    assert second.step == epoch + 1
    assert float(second.optimizer.adam.state_dict()["state"][0]["step"]) == epoch + 1
    assert [r["epoch"] for r in _records(tmp_path) if "epoch" in r][-1] == epoch


def test_export_of_jax_weights_equals_the_jax_export(jax_init, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert train_detection.main(["synthetic", "-", "--checkpoint", str(jax_init), "--export",
                                 "x.pt"], device="cpu") is None
    got, want = torch.load("x.pt", weights_only=True), torch.load(jax_init, weights_only=True)
    assert got["optimizer_state"] == want["optimizer_state"] == {}
    assert got["model_state"].keys() == want["model_state"].keys()
    for key, value in want["model_state"].items():
        assert torch.equal(got["model_state"][key], value), key


@pytest.mark.parametrize("flag,dtype", [([], torch.bfloat16), (["--bf16"], torch.bfloat16),
                                        (["--no-bf16"], torch.float32)])
def test_bf16_flag_picks_the_model_dtype(tmp_path, monkeypatch, flag, dtype):
    monkeypatch.chdir(tmp_path)
    state = train_detection.main(["synthetic", "-", "--max-epochs", "0", *flag], device="cpu")
    assert state.model.dtype == dtype
    assert all(p.dtype == torch.float32 for p in state.model.parameters())


def test_debug_images_are_written(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    train_detection.main(["synthetic", "-", "--max-images", "2", "--max-epochs", "1",
                          "--debug-images", *CLI], device="cpu")
    for stem in ("train-sample", "test-sample"):
        for part in ("input", "pred_mask", "mask"):
            with Image.open(tmp_path / f"{stem}_{part}.png") as img:
                assert img.mode == "L" and img.size == (144, 192)


@pytest.mark.parametrize("ext", ["onnx", "npz"])
def test_export_onnx_and_npz_equal_the_jax_package(jax_init, tmp_path, monkeypatch, ext):
    """The JAX trainer's weights (from ``--mask-height 192``) exported by the
    port's trainer: the graph at 800x600 whatever the mask height, as the
    JAX trainer builds it."""
    monkeypatch.chdir(tmp_path)
    assert train_detection.main(["synthetic", "-", "--checkpoint", str(jax_init),
                                 "--export", f"x.{ext}", *CLI], device="cpu") is None
    assert [p.name for p in tmp_path.iterdir()] == [f"x.{ext}"]
    assert_export_equals_jax(tmp_path / f"x.{ext}", "detection",
                             torch.load(jax_init, weights_only=True)["model_state"])


@pytest.mark.parametrize("argv,error", [
    (["hiertext", "data"], FileNotFoundError),
    (["ddi", "data"], FileNotFoundError),
    (["ddi", "data", "--num-devices", "2"], FileNotFoundError),
    (["synthetic", "-", "--mask-height", "160"], SystemExit),
    (["synthetic", "-", "--validate-only"], SystemExit),
])
def test_trainer_refusals(tmp_path, monkeypatch, argv, error):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(error) as info:
        train_detection.main(argv, device="cpu")
    if error is FileNotFoundError:  # a missing dataset root, named before any rank starts
        assert "data/" in str(info.value)
        assert list(tmp_path.iterdir()) == []
    else:
        assert info.value.code == 1


def test_entry_points_need_the_gpu_unless_asked(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_detection.main(["synthetic", "-", "--max-epochs", "0"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_detection.main(["x.pt", "page.png", "out"])


# --------------------------------------------------------- eval_detection


@pytest.mark.parametrize("fmt", ["png", "npy"])
def test_eval_detection_matches_jax(fixed_weights, tmp_path, capsys, fmt):
    page = JaxSyntheticDetection(size=1, page_size=(800, 600), seed=3)[0]["image"]
    grey = ((page[..., 0] + 0.5) * 255).round().astype(np.uint8)[:700, :520]
    Image.fromarray(grey).save(tmp_path / "page.png")
    np.save(tmp_path / "page.npy", grey)
    jax_eval_detection.main([str(fixed_weights / "jax_ckpt"), str(tmp_path / "page.png"),
                             str(tmp_path / "jax")])
    jax_out = capsys.readouterr()
    eval_detection.main([str(fixed_weights / "det.pt"), str(tmp_path / f"page.{fmt}"),
                         str(tmp_path / "port")], device="cpu")
    port_out = capsys.readouterr()
    assert port_out.out == jax_out.out and port_out.out.startswith("Found ")
    assert _shape(port_out.err) == _shape(jax_out.err)

    def png(prefix, part):
        with Image.open(tmp_path / f"{prefix}-{part}.png") as img:
            return img.mode, np.asarray(img)

    model = DetectionModel()
    model.load_state_dict(torch.load(fixed_weights / "det.pt", weights_only=True)["model_state"])
    x = eval_detection.resize((grey / 255.0 - 0.5).astype(np.float32)[..., None], (800, 600))
    with torch.no_grad():
        probs = model.eval()(torch.from_numpy(x[..., 0])[None, None]).numpy()
    assert np.abs(probs - 0.5).min() > MARGIN  # the binary mask cannot flip
    for part, size in (("input", (800, 600)), ("text-probs", (800, 600)),
                       ("text-regions", (700, 520)), ("text-words", (700, 520))):
        (got_mode, got), (want_mode, want) = png("port", part), png("jax", part)
        assert got_mode == want_mode and got.shape[:2] == want.shape[:2] == size, part
        if part == "text-probs":
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(got, want, err_msg=part)
