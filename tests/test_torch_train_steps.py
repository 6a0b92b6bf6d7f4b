"""Port's recognition train and eval steps vs the JAX package's
``make_recognition_steps`` (stage 1 and the biGRU through their Pallas
kernels in interpret mode), from the same weights on the same batch, plus
the port's optimizer against optax and its copies of the schedules and of
``collate_recognition``.

The model is the shipped CRNN with a narrow GRU (H=16), N=8, W=64; the
batch holds a CTC-incompatible row and a zero-weight padding row, which
both packages keep in the batch-norm batch statistics.

Tolerances, float32 on both sides. The two forwards agree to ~1e-5, but
the JAX package's batch norm (one-pass variance) and the port's differ by
up to ~7e-5 after the first batch norm, so a max-pool window whose two
candidates are closer than that can route its gradient to the other one:
a handful of windows per step, which moves the conv-stack gradients by up
to 2% (relative L2 per tensor). Adam's first steps are ``+-lr`` per entry,
so such entries then step apart and the runs drift further each step.
Hence: step 1 loss rtol 1e-5, grad norm rtol 1e-3, module grad norms rtol
1e-2, identical preds, batch-norm running statistics atol 1e-5,
parameters within 1e-5 but for at most 1% of entries (each within the
``2 * lr`` of one opposite Adam step); gradients within 5e-2 relative L2
of JAX's and within 5e-3 of the port's own float64 run (measured 8e-4: in
the zero-padded image columns the pool candidates tie in exact arithmetic,
and float32 sums pick the winner by their last bit); later steps loss rtol 1e-3, grad norm rtol 5e-2, preds 95% equal,
parameters within ``2 * lr * steps``. The optimizer alone matches optax
at rtol 1e-6 on identical gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ocrs_models_tpu.data.collate import collate_recognition as jax_collate
from ocrs_models_tpu.data.collate import ctc_input_and_target_compatible as jax_compatible
from ocrs_models_tpu.models import RecognitionModel as JaxRecognition
from ocrs_models_tpu.ops.ctc import ctc_loss_forward as jax_ctc_loss_forward
from ocrs_models_tpu.training import schedules as jax_schedules
from ocrs_models_tpu.training.state import TrainState as JaxTrainState
from ocrs_models_tpu.training.state import make_optimizer as jax_make_optimizer
from ocrs_models_tpu.training.steps import make_recognition_steps as jax_make_steps
from ocrs_models_torch.data.collate import collate_recognition, ctc_input_and_target_compatible
from ocrs_models_torch.models import RecognitionModel
from ocrs_models_torch.parallel import create_mesh
from ocrs_models_torch.training import schedules
from ocrs_models_torch.ops import ctc_loss_forward
from ocrs_models_torch.training.state import create_train_state, make_optimizer
from ocrs_models_torch.training.steps import make_recognition_steps, module_names
from ocrs_models_torch.weights import recognition_state_dict_from_jax
from torch_port_common import random_variables

HIDDEN = 16
LR = 1e-3
CLIP = 4.0


def _samples(seed=0, n=7):
    rng = np.random.default_rng(seed)
    samples = []
    for i in range(n):
        w = int(rng.integers(40, 65))
        text = rng.integers(1, 97, int(rng.integers(0, 9))).astype(np.int32)
        if i == 3:  # 6 labels with repeats in 20 // 4 = 5 steps: masked
            w, text = 20, np.asarray([5, 5, 7, 7, 9, 9], np.int32)
        samples.append({"image": rng.uniform(-0.5, 0.5, (64, w, 1)).astype(np.float32),
                        "text": text})
    return samples


def _batches(seed=0):
    """The same batch for both packages: 7 samples padded to 8 rows."""
    samples = _samples(seed)
    jax_batch = jax_collate(samples, width_step=64, batch_multiple=8)
    port_batch = collate_recognition(samples, width_step=64, batch_multiple=8)
    assert port_batch["image"].shape == (8, 1, 64, 64)
    assert list(port_batch["sample_weight"]) == [1, 1, 1, 0, 1, 1, 1, 0]
    return jax_batch, port_batch


def _models(seed=0, hidden=HIDDEN):
    jax_model = JaxRecognition(n_classes=97, gru_hidden=hidden, conv_backend="fused",
                               gru_backend="pallas4")
    variables = random_variables(jax_model, (1, 64, 64, 1), seed)
    port = RecognitionModel(n_classes=97, gru_hidden=hidden)
    port.load_state_dict(recognition_state_dict_from_jax(variables), strict=True)
    return jax_model, variables, port


def _jax_state(variables):
    tx = jax_make_optimizer(CLIP)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                         opt_state=tx.init(params), tx=tx)


def _run(steps, grad_accum, seed=0, hidden=HIDDEN):
    jax_batch, port_batch = _batches(seed)
    jax_model, variables, port = _models(seed, hidden)
    jax_state = _jax_state(variables)
    jax_train, _ = jax_make_steps(jax_model, grad_accum=grad_accum)
    state = create_train_state(port, grad_clip_norm=CLIP)
    train, _ = make_recognition_steps(port, grad_accum=grad_accum)
    jax_metrics, port_metrics = [], []
    for _ in range(steps):
        jax_state, m = jax_train(jax_state, jax_batch, jnp.float32(LR))
        jax_metrics.append(jax.tree_util.tree_map(np.asarray, m))
        state, m = train(state, port_batch, LR)
        port_metrics.append(m)
    return jax_state, jax_metrics, state, port_metrics


def _jax_grads(seed=0):
    """Gradients of the JAX step's loss at the initial weights (its
    ``local_parts`` for one microbatch, divided by the weight sum),
    clipped as the optimizer clips them."""
    jax_batch, _ = _batches(seed)
    jax_model, variables, _ = _models(seed)
    b = jax.tree_util.tree_map(jnp.asarray, jax_batch)

    def loss(params):
        log_probs, _ = jax_model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, b["image"],
            train=True, mutable=["batch_stats"])
        nll = jax_ctc_loss_forward(log_probs, b["text"], b["image_width"] // 4, b["text_len"])
        w = b["sample_weight"]
        return jnp.sum(nll / jnp.maximum(b["text_len"], 1) * w) / jnp.maximum(jnp.sum(w), 1.0)

    grads = jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    clipped, _ = optax.clip_by_global_norm(CLIP).update(grads, None)
    return recognition_state_dict_from_jax({"params": clipped,
                                            "batch_stats": variables["batch_stats"]})


def _port_state_dict(jax_state):
    return recognition_state_dict_from_jax({"params": jax_state.params,
                                            "batch_stats": jax_state.batch_stats})


@pytest.mark.parametrize("steps,grad_accum", [(1, 1), (3, 1), (1, 4), (3, 4)])
def test_train_step_matches_jax(steps, grad_accum):
    _assert_steps_match(*_run(steps, grad_accum), steps)


def test_gru_hidden_100_forward_and_step_match_jax():
    # A biGRU width the cluster kernels do not take (H % 8 != 0: the wide
    # route on the card), from JAX's variables through a strict load: the
    # inference forward's log-probs within 1e-5, then one training step
    # with the first step's bounds above.
    jax_model, variables, port = _models(2, hidden=100)
    jax_batch, port_batch = _batches(2)
    want = jax_model.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                           jnp.asarray(jax_batch["image"]), train=False)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(port_batch["image"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    _assert_steps_match(*_run(1, 1, seed=2, hidden=100), 1)


def _assert_steps_match(jax_state, jax_metrics, state, port_metrics, steps):
    for i, (jm, pm) in enumerate(zip(jax_metrics, port_metrics)):
        first = i == 0
        np.testing.assert_allclose(pm["loss"].item(), jm["loss"], rtol=1e-5 if first else 1e-3)
        np.testing.assert_allclose(pm["grad_norm"].item(), jm["grad_norm"],
                                   rtol=1e-3 if first else 5e-2)
        assert pm["grad_norms"].keys() == jm["grad_norms"].keys()
        for k, v in jm["grad_norms"].items():
            np.testing.assert_allclose(pm["grad_norms"][k].item(), v,
                                       rtol=1e-2 if first else 1e-1, err_msg=k)
        agree = (pm["preds"].numpy() == jm["preds"]).mean()
        assert agree == 1.0 if first else agree >= 0.95
    assert state.step == steps
    want = _port_state_dict(jax_state)
    got = state.model.state_dict()
    n_far = n_all = 0
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        diff = (got[key] - value).abs()
        if key.endswith(("running_mean", "running_var")):
            assert float(diff.max()) <= (1e-5 if steps == 1 else 5e-2), key
            continue
        assert float(diff.max()) <= 2 * LR * steps + 1e-6, key
        n_far += int((diff > 1e-5).sum())
        n_all += diff.numel()
    if steps == 1:
        assert n_far <= 0.01 * n_all


def _port_grads(dtype):
    _, port_batch = _batches()
    _, _, port = _models()
    port = port.to(dtype).train()
    b = {k: torch.from_numpy(v) for k, v in port_batch.items()}
    log_probs = port(b["image"].to(dtype))
    nll = ctc_loss_forward(log_probs, b["text"], b["image_width"] // 4, b["text_len"])
    loss = torch.sum(nll / b["text_len"].clamp(min=1) * b["sample_weight"].to(dtype))
    (loss / b["sample_weight"].sum().clamp(min=1)).backward()
    return {n: p.grad for n, p in port.named_parameters()}


def test_gradients_match_jax():
    # The step's clipped gradients (left in .grad) against JAX's.
    _, _, state, _ = _run(1, 1)
    want = _jax_grads()
    for name, p in state.model.named_parameters():
        rel = float((p.grad - want[name]).norm() / want[name].norm())
        assert rel <= 5e-2, (name, rel)


def test_gradients_match_float64():
    # The port's own float32 gradients against its float64 run (the plain
    # versions under autograd): no precision lost in the port's backward.
    g32 = _port_grads(torch.float32)
    g64 = _port_grads(torch.float64)
    for name, g in g64.items():
        rel = float((g32[name].double() - g).norm() / g.norm())
        assert rel <= 5e-3, (name, rel)


def test_optimizer_matches_optax():
    # Same gradients in, same parameters out: global-norm clip (on in the
    # first and third step, off in the second), then Adam with lr per step.
    rng = np.random.default_rng(3)
    params = {"a": rng.normal(size=(5, 7)).astype(np.float32),
              "b": rng.normal(size=(11,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * scale).astype(np.float32) for k, v in params.items()}
             for scale in (3.0, 0.1, 2.0)]
    lrs = [1e-3, 5e-4, 2e-3]
    tx = jax_make_optimizer(CLIP)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(tp.values(), CLIP)
    for g, lr in zip(grads, lrs):
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, jax.tree_util.tree_map(lambda u: -lr * u, updates))
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = opt.step(lr)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(
            jax.tree_util.tree_map(jnp.asarray, g))), rtol=1e-6)
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_eval_step_matches_jax():
    jax_batch, port_batch = _batches(1)
    jax_model, variables, port = _models(1)
    _, jax_eval = jax_make_steps(jax_model)
    want = jax_eval(_jax_state(variables), jax_batch)
    state = create_train_state(port)
    _, eval_step = make_recognition_steps(port)
    got = eval_step(state, port_batch)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(got["preds"].numpy(), np.asarray(want["preds"]))
    assert port.training  # eval_step restores the mode it found
    assert got["preds"].shape == (8, 64 // 4 + 1)


def test_grad_norm_keys_follow_jax_module_names():
    port = RecognitionModel(n_classes=97, gru_hidden=HIDDEN)
    assert sorted(set(module_names(port).values())) == sorted([
        "conv0", "conv3", "bn4", "conv7", "conv9", "bn10", "conv13", "conv15", "bn16",
        "conv19", "bn20", "gru", "output",
    ])


def test_multi_device_step_is_not_ported():
    # The multi-device step is ported (tests/test_torch_parallel_steps.py);
    # what stays refused: force_shard_map without a mesh is the plain step,
    # as in the JAX package, a mesh of several devices without a process
    # group cannot train, and grad_accum must be positive.
    port = RecognitionModel(n_classes=97, gru_hidden=HIDDEN)
    make_recognition_steps(port, force_shard_map=True)
    with pytest.raises(ValueError, match="one process per device"):
        make_recognition_steps(port, mesh=create_mesh(devices=["cpu", "cpu"]))
    with pytest.raises(ValueError, match="grad_accum"):
        make_recognition_steps(port, grad_accum=0)


def test_collate_matches_jax():
    samples = _samples(2)
    for kw in ({}, {"width_step": 64, "batch_multiple": 8}, {"max_width": 32, "width_step": 32}):
        want = jax_collate(samples, **kw)
        got = collate_recognition(samples, **kw)
        assert got.keys() == want.keys()
        np.testing.assert_array_equal(got["image"], want["image"].transpose(0, 3, 1, 2))
        for key in ("text", "text_len", "image_width", "sample_weight"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for n_in, target in ((5, [1, 1, 2]), (4, [1, 1, 2]), (1, []), (0, []), (3, [4, 4, 4])):
        assert ctc_input_and_target_compatible(n_in, np.asarray(target)) == \
            jax_compatible(n_in, np.asarray(target))


def test_schedules_match_jax():
    metrics = [5.0, 4.0, 4.0, 4.0, 3.9999, 4.0, 4.0, 4.0, 4.0, 1.0, 1.0, 1.0, 1.0, 1.0]
    ours = schedules.ReduceLROnPlateau(1e-3, min_lr=1e-5)
    theirs = jax_schedules.ReduceLROnPlateau(1e-3, min_lr=1e-5)
    assert [ours.step(m) for m in metrics] == [theirs.step(m) for m in metrics]
    for warmup in (0, 5, 50):
        a = schedules.LinearWarmup(2e-3, warmup)
        b = jax_schedules.LinearWarmup(2e-3, warmup)
        assert [a.at_epoch(e) for e in range(60)] == [b.at_epoch(e) for e in range(60)]


def test_train_step_with_a_long_label_matches_jax():
    # A line of 449 characters in the batch (a crop 20 steps wide cannot
    # hold it: weight 0). At the trainers' width_step of 256 the collation
    # pads such labels to 512 (here, at 64, to 464: padded on to 512 in
    # both batches), so S = 1025: past the CUDA kernels' one position a
    # thread. One step against the JAX step on its CPU route (XLA stage 1,
    # scan biGRU and CTC: the Pallas kernels' interpret mode would add some
    # 10 s of compiling), at the first step's bounds.
    samples = _samples(0)
    samples[3]["text"] = np.random.default_rng(3).integers(1, 97, 449).astype(np.int32)
    jax_batch = jax_collate(samples, width_step=64, batch_multiple=8)
    port_batch = collate_recognition(samples, width_step=64, batch_multiple=8)
    for batch in (jax_batch, port_batch):
        assert batch["text"].shape == (8, 464)
        batch["text"] = np.pad(batch["text"], ((0, 0), (0, 512 - 464)))
    assert list(port_batch["sample_weight"]) == [1, 1, 1, 0, 1, 1, 1, 0]
    jax_model, variables, port = _models(0)
    jax_state = _jax_state(variables)
    jax_train, _ = jax_make_steps(jax_model.clone(conv_backend="xla", gru_backend="scan"))
    state = create_train_state(port, grad_clip_norm=CLIP)
    train, _ = make_recognition_steps(port)
    jax_state, m = jax_train(jax_state, jax_batch, jnp.float32(LR))
    state, pm = train(state, port_batch, LR)
    assert np.isfinite(pm["loss"].item())
    _assert_steps_match(jax_state, [jax.tree_util.tree_map(np.asarray, m)], state, [pm], 1)
