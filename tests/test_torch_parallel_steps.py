"""The port's data-parallel training steps against the JAX package's mesh
steps, on the CPU: two ``gloo`` ranks (``parallel.spawn``, one process
each) against ``make_recognition_steps(mesh=create_mesh(2))`` (JAX's
``shard_map`` step) and against ``make_detection_steps`` and
``make_layout_steps`` on a batch ``shard_batch``'d over a 2-device JAX mesh
(GSPMD), from the same weights on the same global batch; rank ``r`` holds
the ``r``-th contiguous half, as ``shard_batch`` places it.

The bounds are those of the single-device parity tests of each step
(``test_torch_train_steps.py``, ``test_torch_detection_train.py``,
``test_torch_train_layout.py``, whose docstrings say why): the two
packages differ by float32 rounding, not by semantics. Two semantics are
held apart: the recognizer's batch norm takes each rank's own statistics
(and averages the running ones), the detector's the whole batch's. A
wrong reduction (gradients averaged instead of summed, local statistics
for the detector) moves these numbers by a factor, far outside the bounds.

Also: the world-1 paths (``force_shard_map=True`` in one process, and a
one-rank process group) against the plain steps, bit for bit for the
recognizer and the layout model; the detector's global batch norm takes
the one-pass variance of JAX's ``BatchNormLite`` where the plain f32 step
uses PyTorch's, so it is held to the detection step's bounds. The
distributed balanced BCE on 2 and 3 ranks against the one-process loss on
the concatenated batch (ties at the threshold included). After two steps
every rank's parameters and buffers are bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ocrs_models_tpu.models.layout as jax_layout
from ocrs_models_tpu.data import SyntheticDetection as JaxSyntheticDetection
from ocrs_models_tpu.data.augment import DetectionAugment as JaxDetectionAugment
from ocrs_models_tpu.data.collate import collate_detection as jax_collate_detection
from ocrs_models_tpu.data.collate import collate_layout as jax_collate_layout
from ocrs_models_tpu.data.collate import collate_recognition as jax_collate
from ocrs_models_tpu.models import DetectionModel as JaxDetection
from ocrs_models_tpu.models import RecognitionModel as JaxRecognition
from ocrs_models_tpu.parallel import create_mesh as jax_create_mesh
from ocrs_models_tpu.parallel import replicate_tree as jax_replicate_tree
from ocrs_models_tpu.parallel import shard_batch as jax_shard_batch
from ocrs_models_tpu.training.state import TrainState as JaxTrainState
from ocrs_models_tpu.training.state import make_optimizer as jax_make_optimizer
from ocrs_models_tpu.training.steps import make_detection_steps as jax_detection_steps
from ocrs_models_tpu.training.steps import make_layout_steps as jax_layout_steps
from ocrs_models_tpu.training.steps import make_recognition_steps as jax_recognition_steps
from ocrs_models_torch.data import SyntheticLayout
from ocrs_models_torch.ops.losses import balanced_cross_entropy_loss
from ocrs_models_torch.parallel import create_mesh, spawn
from ocrs_models_torch.weights import (
    detection_state_dict_from_jax,
    layout_state_dict_from_jax,
    recognition_state_dict_from_jax,
)
from torch_parallel_workers import balanced_bce_rank, plain_and_collective, run_steps
from torch_port_common import layout_variables, patch_jax_dropout, random_variables

LR = 1e-3
CLIP = 4.0
HIDDEN = 16
DET_DEPTH = (4, 8, 16, 32, 40, 48, 64)
DET_SIZE = (128, 96)
LAYOUT = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64)
TIMEOUT = 240


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The ranks run torch on one thread each; the test process's own port
    runs (the references of the world-1 cases) do too, so that their sums
    run in the same order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy_sd(sd: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _spawn(tmp_path, fn, world, *args):
    return spawn(fn, world, "cpu", args=args, timeout=TIMEOUT, store_dir=str(tmp_path))


def _jax_state(variables, clip=None, stats=True):
    tx = jax_make_optimizer(clip)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    batch_stats = (jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]) if stats
                   else {})
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=batch_stats,
                         opt_state=tx.init(params), tx=tx)


def _assert_ranks_equal(results):
    assert len({r["digest"] for r in results}) == 1, [r["digest"] for r in results]


# ------------------------------------------------------------- recognition


def _rec_batch():
    """The recognition parity tests' batch: 7 lines of width 40-64 (one
    CTC-incompatible) padded to 8 rows of [1, 64, 64]."""
    rng = np.random.default_rng(0)
    samples = []
    for i in range(7):
        w = int(rng.integers(40, 65))
        text = rng.integers(1, 97, int(rng.integers(0, 9))).astype(np.int32)
        if i == 3:
            w, text = 20, np.asarray([5, 5, 7, 7, 9, 9], np.int32)
        samples.append({"image": rng.uniform(-0.5, 0.5, (64, w, 1)).astype(np.float32),
                        "text": text})
    return jax_collate(samples, width_step=64, batch_multiple=8)


def _nchw_rec(batch):
    out = dict(batch)
    out["image"] = np.ascontiguousarray(batch["image"].transpose(0, 3, 1, 2))
    return out


def _rec_setup():
    jax_model = JaxRecognition(n_classes=97, gru_hidden=HIDDEN, conv_backend="fused",
                               gru_backend="pallas4")
    variables = random_variables(jax_model, (1, 64, 64, 1), 0)
    return jax_model, variables, _numpy_sd(recognition_state_dict_from_jax(variables))


def _assert_rec_step(pm, jm, got_sd, want_sd):
    """One recognition step against JAX's, at ``test_torch_train_steps``'s
    first-step bounds."""
    np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(pm["grad_norm"], jm["grad_norm"], rtol=1e-3)
    assert pm["grad_norms"].keys() == jm["grad_norms"].keys()
    for k, v in jm["grad_norms"].items():
        np.testing.assert_allclose(pm["grad_norms"][k], v, rtol=1e-2, err_msg=k)
    n_far = n_all = 0
    for key, value in want_sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        diff = np.abs(got_sd[key] - value.numpy())
        if key.endswith(("running_mean", "running_var")):
            assert float(diff.max()) <= 1e-5, key
            continue
        assert float(diff.max()) <= 2 * LR + 1e-6, key
        n_far += int((diff > 1e-5).sum())
        n_all += diff.size
    assert n_far <= 0.01 * n_all


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_recognition_on_two_ranks_matches_jax_shard_map(tmp_path, grad_accum):
    jax_model, variables, sd = _rec_setup()
    batch = _rec_batch()
    mesh = jax_create_mesh(2)
    train, _ = jax_recognition_steps(jax_model, mesh=mesh, grad_accum=grad_accum)
    jax_state, jm = train(jax_replicate_tree(_jax_state(variables, CLIP), mesh),
                          jax_shard_batch(batch, mesh), jnp.float32(LR))
    jm = jax.tree_util.tree_map(np.asarray, jm)
    results = _spawn(tmp_path, run_steps, 2, "recognition",
                     {"n_classes": 97, "gru_hidden": HIDDEN}, sd, _nchw_rec(batch), 2, LR,
                     {"grad_accum": grad_accum}, CLIP)
    want = recognition_state_dict_from_jax({"params": jax_state.params,
                                            "batch_stats": jax_state.batch_stats})
    for r in results:
        _assert_rec_step(r["metrics"][0], jm, r["first"], want)
        # preds stay the rank's own rows
        np.testing.assert_array_equal(r["metrics"][0]["preds"],
                                      np.asarray(jm["preds"])[4 * r["rank"]:4 * r["rank"] + 4])
    _assert_ranks_equal(results)


def _in_process(kind, model_kwargs, sd, batch, steps, step_kwargs, clip):
    """``steps`` steps built with ``step_kwargs`` in this process, from
    ``sd``: each step's metrics and the final state dict."""
    from torch_parallel_workers import MODELS, STEPS

    from ocrs_models_torch.training.state import create_train_state

    model = MODELS[kind](**model_kwargs)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    state = create_train_state(model, grad_clip_norm=clip)
    train, _ = STEPS[kind](model, **step_kwargs)
    return [train(state, batch, LR)[1] for _ in range(steps)], model.state_dict()


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_force_shard_map_in_one_process_is_the_plain_step(grad_accum):
    _, _, sd = _rec_setup()
    batch = _nchw_rec(_rec_batch())
    args = ("recognition", {"n_classes": 97, "gru_hidden": HIDDEN}, sd, batch, 2)
    plain, plain_sd = _in_process(*args, {"grad_accum": grad_accum}, CLIP)
    forced, forced_sd = _in_process(*args, {"grad_accum": grad_accum, "force_shard_map": True,
                                            "mesh": create_mesh(devices=["cpu"])}, CLIP)
    for a, b in zip(plain, forced):
        for key in ("loss", "grad_norm", "preds"):
            assert torch.equal(a[key], b[key]), key
        assert all(torch.equal(a["grad_norms"][k], b["grad_norms"][k]) for k in a["grad_norms"])
    assert all(torch.equal(plain_sd[k], forced_sd[k]) for k in plain_sd)


def test_recognition_mesh_without_process_group_refuses_to_train():
    from ocrs_models_torch.models import RecognitionModel
    from ocrs_models_torch.training.steps import make_recognition_steps

    with pytest.raises(ValueError, match="one process per device"):
        make_recognition_steps(RecognitionModel(n_classes=97, gru_hidden=HIDDEN),
                               mesh=create_mesh(devices=["cpu", "cpu"]))


# --------------------------------------------------------------- detection


def _det_batch(n=3, batch_multiple=4, seed=0):
    """The detection parity tests' batch: NHWC pages with one zero-weight
    padding row, each page's negatives cut to as many as its positives
    (the others set to 0.5, in neither pool), so that ``k`` takes every
    pixel of both pools and float noise picks nothing."""
    ds = JaxSyntheticDetection(size=n, page_size=(256, 192), seed=seed,
                               transform=JaxDetectionAugment(DET_SIZE, augment=False))
    batch = jax_collate_detection([ds[i] for i in range(n)], batch_multiple=batch_multiple)
    del batch["n_valid"], batch["path"]
    rng = np.random.default_rng(seed)
    for page in batch["mask"]:
        flat = page.reshape(-1)
        neg = np.flatnonzero(flat < 0.5)
        n_pos = int(np.sum(flat > 0.5))
        flat[rng.permutation(neg)[n_pos:]] = 0.5
    return batch


def _nchw_det(batch):
    out = dict(batch)
    for key in ("image", "mask"):
        out[key] = np.ascontiguousarray(batch[key].transpose(0, 3, 1, 2))
    return out


def _assert_det_step(pm, jm, got_sd, want_sd):
    """One detection step against JAX's, at
    ``test_torch_detection_train``'s first-step bounds."""
    np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(pm["grad_norm"], jm["grad_norm"], rtol=1e-3)
    for k, v in jm["grad_norms"].items():
        np.testing.assert_allclose(pm["grad_norms"][k], v, rtol=1e-2, err_msg=k)
    for key, value in want_sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        diff = float(np.abs(got_sd[key] - value.numpy()).max())
        if key.endswith(("running_mean", "running_var")):
            assert diff <= 1e-2 * float(value.abs().max()), key
        else:
            assert diff <= 2 * LR + 1e-6, key


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_detection_on_two_ranks_matches_jax_gspmd(tmp_path, grad_accum):
    variables = random_variables(JaxDetection(depth_scale=DET_DEPTH), (1, *DET_SIZE, 1), seed=5)
    sd = _numpy_sd(detection_state_dict_from_jax(variables))
    batch = _det_batch()
    mesh = jax_create_mesh(2)
    train, evaluate = jax_detection_steps(JaxDetection(depth_scale=DET_DEPTH),
                                          grad_accum=grad_accum)
    state0 = jax_replicate_tree(_jax_state(variables), mesh)
    jax_state, jm = train(state0, jax_shard_batch(batch, mesh), jnp.float32(LR))
    jm = jax.tree_util.tree_map(np.asarray, jm)
    results = _spawn(tmp_path, run_steps, 2, "detection", {"depth_scale": DET_DEPTH}, sd,
                     _nchw_det(batch), 2, LR, {"grad_accum": grad_accum}, None, True)
    want = detection_state_dict_from_jax({"params": jax_state.params,
                                          "batch_stats": jax_state.batch_stats})
    for r in results:
        pm = r["metrics"][0]
        _assert_det_step(pm, jm, r["first"], want)
        half = slice(2 * r["rank"], 2 * r["rank"] + 2)
        np.testing.assert_allclose(pm["pred"], jm["pred"].transpose(0, 3, 1, 2)[half],
                                   rtol=0, atol=5e-5)
    _assert_ranks_equal(results)
    if grad_accum == 1:
        # The eval step (running statistics, global balanced BCE) after
        # two steps, against JAX's after the same two steps.
        jax_state, _ = train(jax_state, jax_shard_batch(batch, mesh), jnp.float32(LR))
        want_eval = evaluate(jax_state, jax_shard_batch(batch, mesh))
        for r in results:
            np.testing.assert_allclose(r["eval"]["loss"], float(want_eval["loss"]), rtol=1e-4)


# ------------------------------------------------------------------ layout


def _layout_batch():
    samples = [SyntheticLayout(size=6, n_words=32, seed=3)[i] for i in range(6)]
    batch = jax_collate_layout(samples, batch_multiple=4)
    del batch["n_valid"]
    return batch


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_layout_on_two_ranks_matches_jax_gspmd(tmp_path, monkeypatch, grad_accum):
    patch_jax_dropout(monkeypatch)
    variables = layout_variables(jax_layout.LayoutModel(**LAYOUT), 1)
    sd = _numpy_sd(layout_state_dict_from_jax(variables, LAYOUT["n_layers"]))
    batch = _layout_batch()
    assert batch["boxes"].shape == (8, 32, 4)
    mesh = jax_create_mesh(2)
    train, _ = jax_layout_steps(jax_layout.LayoutModel(**LAYOUT), grad_accum=grad_accum)
    jax_state, jm = train(jax_replicate_tree(_jax_state(variables, stats=False), mesh),
                          jax_shard_batch(batch, mesh), jnp.float32(LR), jax.random.key(0))
    jm = jax.tree_util.tree_map(np.asarray, jm)
    results = _spawn(tmp_path, run_steps, 2, "layout", LAYOUT, sd, batch, 2, LR,
                     {"grad_accum": grad_accum})
    want = layout_state_dict_from_jax({"params": jax_state.params}, LAYOUT["n_layers"])
    for r in results:
        pm = r["metrics"][0]
        np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(pm["grad_norm"], jm["grad_norm"], rtol=1e-4)
        for k, v in jm["grad_norms"].items():
            np.testing.assert_allclose(pm["grad_norms"][k], v, rtol=1e-4, err_msg=k)
        half = slice(4 * r["rank"], 4 * r["rank"] + 4)
        np.testing.assert_allclose(pm["probs"], jm["probs"][half], rtol=0, atol=1e-5)
        for key, value in want.items():
            diff = float(np.abs(r["first"][key] - value.numpy()).max())
            assert diff <= 2 * LR + 1e-6, key
    _assert_ranks_equal(results)


# ------------------------------------------------------ world 1, one rank


@pytest.mark.parametrize("kind", ["recognition", "layout", "detection"])
def test_one_rank_process_group_is_the_plain_step(tmp_path, kind):
    """The collective paths on a process group of one rank against the
    plain step in the same rank: bit for bit for the recognizer (shard_map
    forced) and the layout model; the detector's global batch norm within
    the detection step's first-step bounds (one-pass variance)."""
    if kind == "recognition":
        _, _, sd = _rec_setup()
        model_kwargs, batch, kw, clip = ({"n_classes": 97, "gru_hidden": HIDDEN}, _nchw_rec(
            _rec_batch()), {"force_shard_map": True}, CLIP)
    elif kind == "layout":
        variables = layout_variables(jax_layout.LayoutModel(**LAYOUT), 1)
        sd = _numpy_sd(layout_state_dict_from_jax(variables, LAYOUT["n_layers"]))
        model_kwargs, batch, kw, clip = LAYOUT, _layout_batch(), {}, None
    else:
        variables = random_variables(JaxDetection(depth_scale=DET_DEPTH), (1, *DET_SIZE, 1),
                                     seed=5)
        sd = _numpy_sd(detection_state_dict_from_jax(variables))
        model_kwargs, batch, kw, clip = ({"depth_scale": DET_DEPTH}, _nchw_det(_det_batch()),
                                         {}, None)
    ((plain, got),) = _spawn(tmp_path, plain_and_collective, 1, kind, model_kwargs, sd, batch,
                             2, LR, kw, clip)
    if kind == "detection":
        a, b = got["metrics"][0], plain["metrics"][0]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-3)
        for k, v in b["grad_norms"].items():
            np.testing.assert_allclose(a["grad_norms"][k], v, rtol=1e-2, err_msg=k)
        for k, v in plain["first"].items():
            if not k.endswith(("running_mean", "running_var", "num_batches_tracked")):
                assert float(np.abs(got["first"][k] - v).max()) <= 2 * LR + 1e-6, k
        return
    for a, b in zip(got["metrics"], plain["metrics"]):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
        assert a["grad_norms"] == b["grad_norms"]
    assert got["digest"] == plain["digest"]


# -------------------------------------------------------- balanced BCE


def _bce_cases():
    rng = np.random.default_rng(0)
    pred = rng.uniform(0.01, 0.99, (6, 1, 12, 10)).astype(np.float32)
    target = (rng.uniform(size=pred.shape) > 0.7).astype(np.float32)
    yield "plain", pred, target, None
    yield "zero-weight rows", pred, target, np.array([1, 0, 1, 1, 1, 0], np.float32)
    tied = np.clip(np.round(pred * 4) / 4, 0.25, 0.75).astype(np.float32)
    yield "ties", tied, target, np.array([1, 1, 0, 1, 1, 1], np.float32)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", [c[0] for c in _bce_cases()])
def test_distributed_balanced_bce_equals_the_whole_batch(tmp_path, world, case):
    _, pred, target, weight = next(c for c in _bce_cases() if c[0] == case)
    p = torch.from_numpy(pred.copy()).requires_grad_()
    want = balanced_cross_entropy_loss(p, torch.from_numpy(target),
                                       None if weight is None else torch.from_numpy(weight))
    want.backward()
    results = _spawn(tmp_path, balanced_bce_rank, world, pred, target, weight)
    np.testing.assert_allclose(sum(r["share"] for r in results), want.item(), rtol=1e-6)
    np.testing.assert_allclose(np.concatenate([r["grad"] for r in results]), p.grad.numpy(),
                               rtol=1e-6, atol=1e-9)
    if case == "ties":
        g = np.abs(p.grad.numpy()[p.grad.numpy() != 0])
        assert len(np.unique(np.round(g, 7))) > 1  # tied entries share the leftover slots
