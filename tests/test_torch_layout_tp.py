"""The layout model's tensor parallelism (``parallel/tp.py``) on the CPU,
``gloo`` ranks spawned by ``parallel.spawn``, against the JAX package's
tensor-parallel step (``make_layout_steps`` on ``create_mesh_2d`` with
``layout_tp_state_shardings``) and against the port's own plain step.

Tolerances (the JAX package's ``tests/test_parallel_tp.py``): the loss
rtol 1e-5; the parameters after one Adam step rtol 1e-3 / atol 5e-5
(reduction order moves the gradients by float noise, and Adam's first
step is about the gradient's sign times the learning rate), but for the
k projection's bias: softmax is unchanged by a shift of one query's
scores, so that bias's gradient is 0 in exact arithmetic and float noise
(read 1e-9) here, and Adam's first step moves each entry by ``lr * g /
(|g| + 1e-8)`` of that noise, anywhere in ``[-lr, lr]`` (read 2.2e-4
apart at lr 1e-3): those entries are held within ``2 * lr``, as
``test_torch_parallel_steps.py`` holds every parameter after a step, and
their gradients within 1e-6 of 0. The shard -> gather round trip is
exact. Dropout is off against JAX (its stream cannot
be matched), on against the port's plain step: the sharded step draws
the full masks from the same generator and keeps its slices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ocrs_models_tpu.models.layout as jax_layout
from ocrs_models_tpu.data.collate import collate_layout as jax_collate_layout
from ocrs_models_tpu.parallel import create_mesh_2d as jax_create_mesh_2d
from ocrs_models_tpu.parallel import layout_tp_state_shardings, shard_tree
from ocrs_models_tpu.parallel import shard_batch as jax_shard_batch
from ocrs_models_tpu.training.state import TrainState as JaxTrainState
from ocrs_models_tpu.training.state import make_optimizer as jax_make_optimizer
from ocrs_models_tpu.training.steps import make_layout_steps as jax_layout_steps
from ocrs_models_torch.data import SyntheticLayout
from ocrs_models_torch.models import LayoutModel
from ocrs_models_torch.parallel import Mesh2D, layout_tp_spec, shard_layout_model, spawn
from ocrs_models_torch.parallel.tp import _join, _split
from ocrs_models_torch.training.state import create_train_state
from ocrs_models_torch.training.steps import make_layout_steps
from ocrs_models_torch.weights import layout_state_dict_from_jax
from torch_parallel_workers import run_layout_tp
from torch_port_common import layout_variables, patch_jax_dropout

LAYOUT = dict(d_model=32, n_layers=2, n_heads=4, d_ff=64)
LR = 1e-3
TIMEOUT = 240


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    samples = [SyntheticLayout(size=8, n_words=32, seed=5)[i] for i in range(8)]
    boxes = np.stack([b for b, _ in samples]).astype(np.float32)
    labels = np.stack([lb for _, lb in samples]).astype(np.float32)
    return {"boxes": boxes, "labels": labels}


def _spawn(tmp_path, world, *args):
    return spawn(run_layout_tp, world, "cpu", args=args, timeout=TIMEOUT,
                 store_dir=str(tmp_path))


def _numpy_sd(sd):
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def _assert_params_close(got: dict, want: dict, before: dict) -> None:
    """rtol 1e-3 / atol 5e-5, the k bias's entries within 2 * LR (see the
    module's docstring) and their Adam step no larger than LR."""
    assert got.keys() == want.keys()
    d = LAYOUT["d_model"]
    for key, value in want.items():
        got_v = got[key]
        if key.endswith("in_proj_bias"):
            k_bias = slice(d, 2 * d)
            assert np.abs(got_v[k_bias] - value[k_bias]).max() <= 2 * LR, key
            assert np.abs(got_v[k_bias] - before[key][k_bias]).max() <= LR * (1 + 1e-5), key
            got_v, value = np.delete(got_v, np.s_[d:2 * d]), np.delete(value, np.s_[d:2 * d])
        np.testing.assert_allclose(got_v, value, rtol=1e-3, atol=5e-5, err_msg=key)


def test_tp_step_on_a_2x2_mesh_matches_jax(tmp_path, monkeypatch):
    patch_jax_dropout(monkeypatch)
    model = jax_layout.LayoutModel(**LAYOUT)
    variables = layout_variables(model, 2)
    sd = _numpy_sd(layout_state_dict_from_jax(variables, LAYOUT["n_layers"]))
    batch = _batch()
    jbatch = jax_collate_layout([(b, lb) for b, lb in zip(batch["boxes"], batch["labels"])],
                                batch_multiple=4)
    del jbatch["n_valid"]
    tx = jax_make_optimizer(None)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                          opt_state=tx.init(params), tx=tx)
    mesh = jax_create_mesh_2d(2, 2)
    state = shard_tree(state, layout_tp_state_shardings(state, mesh))
    train, _ = jax_layout_steps(model)
    state, jm = train(state, jax_shard_batch(jbatch, mesh), jnp.float32(LR), jax.random.key(0))
    assert state.params["layer_0"]["qkv_kernel"].sharding.spec == \
        jax.sharding.PartitionSpec(None, "model")
    want = layout_state_dict_from_jax({"params": state.params}, LAYOUT["n_layers"])

    results = _spawn(tmp_path, 4, 2, 2, LAYOUT, sd, batch, 1, LR)
    assert [(r["data_rank"], r["model_rank"]) for r in results] == [(0, 0), (0, 1), (1, 0),
                                                                      (1, 1)]
    for r in results:
        pm = r["metrics"][0]
        np.testing.assert_allclose(pm["loss"], float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(pm["grad_norm"], float(jm["grad_norm"]), rtol=1e-4)
        for k, v in jm["grad_norms"].items():
            np.testing.assert_allclose(pm["grad_norms"][k], float(v), rtol=1e-4, err_msg=k)
        _assert_params_close(r["first"], _numpy_sd(want), sd)
        for key, value in sd.items():  # the round trip is exact
            np.testing.assert_array_equal(r["round_trip"][key], value, err_msg=key)
    # Each rank holds half of the split parameters: two of the four heads.
    shapes = results[1]["shapes"]
    assert shapes["encode.layers.0.self_attn.in_proj_weight"] == (48, 32)
    assert shapes["encode.layers.0.self_attn.in_proj_bias"] == (48,)
    assert shapes["encode.layers.0.self_attn.out_proj.weight"] == (32, 16)
    assert shapes["encode.layers.0.self_attn.out_proj.bias"] == (32,)
    assert shapes["encode.layers.1.linear1.weight"] == (32, 32)
    assert shapes["encode.layers.1.linear2.weight"] == (32, 32)
    assert shapes["classify.weight"] == (2, 32)
    for a, b in zip(results[0::2], results[1::2]):  # a model group ends equal
        for key in sd:
            np.testing.assert_array_equal(a["last"][key], b["last"][key], err_msg=key)


@pytest.mark.parametrize("grad_clip_norm", [None, 0.05])
def test_tp_step_with_dropout_equals_the_plain_step(tmp_path, grad_clip_norm):
    """dp=1, mp=2, dropout on: the sharded step and the plain step draw the
    same masks from generators seeded alike. With a clip below the
    gradients' norm, every rank clips by the norm of the whole gradient."""
    torch.manual_seed(4)
    plain = LayoutModel(**LAYOUT)
    sd = _numpy_sd(plain.state_dict())
    batch = _batch()
    state = create_train_state(plain, grad_clip_norm)
    train, _ = make_layout_steps(plain)
    gen = torch.Generator().manual_seed(11)
    losses = []
    for _ in range(2):
        state, m = train(state, batch, LR, gen)
        losses.append(float(m["loss"]))
        if not len(losses) - 1:
            first = _numpy_sd(plain.state_dict())
    results = _spawn(tmp_path, 2, 1, 2, LAYOUT, sd, batch, 2, LR, 11, grad_clip_norm)
    for r in results:
        for step, loss in enumerate(losses):
            np.testing.assert_allclose(r["metrics"][step]["loss"], loss, rtol=1e-5)
        _assert_params_close(r["first"], first, sd)
        if grad_clip_norm is not None:
            assert r["metrics"][0]["grad_norm"] > grad_clip_norm
    for key in sd:  # the model group ends equal
        np.testing.assert_array_equal(results[0]["last"][key], results[1]["last"][key],
                                      err_msg=key)


def test_layout_tp_spec_and_split_join():
    model = LayoutModel(**LAYOUT)
    specs = {k: layout_tp_spec(k) for k in model.state_dict()}
    assert {k for k, v in specs.items() if v == "column"} == {
        f"encode.layers.{i}.{n}" for i in range(2)
        for n in ("self_attn.in_proj_weight", "self_attn.in_proj_bias", "linear1.weight",
                  "linear1.bias")}
    assert {k for k, v in specs.items() if v == "row"} == {
        f"encode.layers.{i}.{n}" for i in range(2)
        for n in ("self_attn.out_proj.weight", "linear2.weight")}
    for name, full in model.state_dict().items():
        shards = [_split(name, full, r, 4) for r in range(4)]
        joined = _join(name, shards) if specs[name] != "replicated" else shards[0]
        assert torch.equal(joined, full), name
    # Heads, not contiguous thirds: rank 1 of 2 holds rows 16:32 of q, k and v.
    w = model.state_dict()["encode.layers.0.self_attn.in_proj_weight"]
    got = _split("encode.layers.0.self_attn.in_proj_weight", w, 1, 2)
    assert torch.equal(got, torch.cat([w[16:32], w[48:64], w[80:96]]))


def test_tp_refusals():
    mesh = Mesh2D((torch.device("cpu"),), 1, 3)
    with pytest.raises(ValueError, match="n_heads"):
        shard_layout_model(LayoutModel(**LAYOUT), mesh)
    with pytest.raises(ValueError, match="shard_layout_model"):
        make_layout_steps(LayoutModel(**LAYOUT), mesh=Mesh2D((torch.device("cpu"),), 1, 2))
