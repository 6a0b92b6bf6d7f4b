"""The port's ONNX and ``.npz`` export against the JAX package's, on the CPU.

The weights are the JAX models' ``init`` variables perturbed with numpy from
a seed (as ``tests/test_onnx_export.py`` does, so that every batch norm is
far from the identity), carried into the port with
``weights.*_state_dict_from_jax``. Both packages then write their files
from the same numbers, and the files are compared byte for byte: the
GraphProto (field 7 of the ModelProto) and every other field of the
ModelProto but ``producer_name``; the ``.npz`` key list, order included,
and each array's dtype, shape and bytes.

Tolerances (float32; "read" is what this CPU gave): the port's
``onnx_eval`` against the port's forward within 2e-4 for detection and
recognition, the JAX tests' bound against flax (read 1.7e-5 on the
recognizer's log-probs of size ~6, 1.2e-7 on the detector's
probabilities), with at least 99.9% of the recognizer's argmaxes equal
(read 100%). The perturbed init weights saturate the detector's sigmoid
(every output 1.0), so its numerics run on ``torch_port_common``'s seeded
weights. Layout within 5e-4 on logits of size ~3: read 1.3e-4 on the
perturbed init weights (all positive, so each LayerNorm input carries a
large common offset and its centring cancels; numpy and torch order
those sums differently) and 2.6e-6 on ``layout_variables``' weights, in
both ``pos_embedding`` modes. numpy's and torch's float32 ``sin`` and
``cos`` agree at coordinates near 500, where XLA's differ by ~1e-3, which
is why the JAX test against flax needs 0.05 (that bound stays as it
is). The port's ``run_graph`` and the JAX ``run_graph`` give bit-equal
outputs on the same graph.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ocrs_models_tpu.export.onnx_check as jax_check
import ocrs_models_tpu.export.onnx_eval as jax_eval
import ocrs_models_tpu.export.onnx_graph as jax_graph
import ocrs_models_tpu.export.onnx_proto as jax_proto
import ocrs_models_tpu.models as jax_models
from ocrs_models_tpu.export.__main__ import _fresh_state as jax_fresh_state
from ocrs_models_tpu.export.__main__ import main as jax_export_main
from ocrs_models_tpu.export.torch_export import export_layout_state_dict
from ocrs_models_tpu.training.export_utils import export_weights as jax_export_weights
from ocrs_models_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint

import ocrs_models_torch.export.onnx_check as port_check
import ocrs_models_torch.export.onnx_eval as port_eval
import ocrs_models_torch.export.onnx_proto as port_proto
from ocrs_models_torch import weights
from ocrs_models_torch.export.__main__ import main as port_export_main
from ocrs_models_torch.models import DetectionModel, LayoutModel, RecognitionModel
from ocrs_models_torch.training.export_utils import (
    builder_kwargs,
    export_weights,
    onnx_bytes,
    read_npz,
)
from ocrs_models_torch.training.state import create_train_state
from ocrs_models_torch.utils.checkpoint import save_checkpoint
from torch_port_common import layout_variables, random_variables

DET_ATOL = REC_ATOL = 2e-4
LAYOUT_ATOL = 5e-4


def _perturb(variables, seed: int = 0):
    """``|v + N(0, 0.1)| + 0.01`` for every leaf, drawn with numpy."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda leaf: (np.abs(np.asarray(leaf, np.float32) + rng.normal(0, 0.1, leaf.shape))
                      + 0.01).astype(np.float32),
        variables)


class JaxState:
    """What JAX ``export_weights`` reads of a train state."""

    def __init__(self, variables):
        self.params = variables["params"]
        self.batch_stats = variables.get("batch_stats", {})


# kind -> (JAX model, init sample shape, init seed, port model, JAX -> port mapping)
SETUPS = {
    "detection": (lambda: jax_models.DetectionModel(), (1, 64, 64, 1), 1,
                  lambda: DetectionModel(), weights.detection_state_dict_from_jax),
    "recognition": (lambda: jax_models.RecognitionModel(n_classes=97), (1, 64, 64, 1), 0,
                    lambda: RecognitionModel(n_classes=97), weights.recognition_state_dict_from_jax),
    "layout": (lambda: jax_models.LayoutModel(), (1, 8, 4), 2,
               lambda: LayoutModel(), weights.layout_state_dict_from_jax),
    "layout-mlp": (lambda: jax_models.LayoutModel(pos_embedding="mlp"), (1, 8, 4), 3,
                   lambda: LayoutModel(pos_embedding="mlp"),
                   lambda v: weights.layout_state_dict_from_jax(v, pos_embedding="mlp")),
}
@functools.cache
def setup(kind: str):
    """``(JAX variables, port model in eval mode)`` on the same weights."""
    jax_model, shape, seed, port_model, to_port = SETUPS[kind]
    init = jax.jit(jax_model().init)(jax.random.key(seed), jnp.zeros(shape))
    variables = _perturb(dict(init), seed)
    model = port_model()
    model.load_state_dict(to_port(variables), strict=True)
    return variables, model.eval()


def _model_name(kind: str) -> str:
    return kind.split("-")[0]


def _fields(data: bytes) -> list:
    return [(f, v) for f, _, v in port_proto._parse_fields(data)]


def _assert_same_model_bytes(port: bytes, jax_bytes: bytes):
    """Equal field by field, ``producer_name`` (field 2) apart; the
    GraphProto (field 7) byte for byte."""
    got, want = _fields(port), _fields(jax_bytes)
    assert [f for f, _ in got] == [f for f, _ in want] == [1, 2, 3, 7, 8]
    for (f, a), (_, b) in zip(got, want):
        if f == 2:
            assert (a, b) == (b"ocrs-models-torch", b"ocrs-models-tpu")
        else:
            assert a == b, f"ModelProto field {f} differs"


def _plain(model) -> tuple:
    """A parsed model (either package's records) as plain values."""
    def arr(a):
        return (str(a.dtype), a.shape, a.tobytes())

    def attr(v):
        return arr(v) if isinstance(v, np.ndarray) else v

    g = model.graph
    return (model.ir_version, model.opset, model.producer, g.name,
            [(n.op_type, n.inputs, n.outputs, n.name, {k: attr(v) for k, v in n.attrs.items()})
             for n in g.nodes],
            g.inputs, g.outputs, {k: arr(v) for k, v in g.initializers.items()})


# ------------------------------------------------------------- proto goldens


def _random_graph(P, seed: int) -> bytes:
    """The seeded random graphs of ``tests/test_onnx_contract.py``."""
    rng = np.random.default_rng(seed)
    nodes, names = [], ["in0"]
    for i in range(int(rng.integers(1, 8))):
        src = names[int(rng.integers(0, len(names)))]
        out = f"v{i}_ü"
        kind = int(rng.integers(0, 5))
        attrs = [{"axis": int(rng.integers(-4, 4))}, {"perm": [int(v) for v in rng.permutation(4)]},
                 {"alpha": float(rng.normal())}, {"mode": "constant" * int(rng.integers(1, 30))},
                 {"value": rng.normal(size=(3, 2)).astype(np.float32)}][kind]
        if kind == 2:
            attrs = {"alpha": attrs["alpha"], "floats": [float(rng.normal()), -1.5]}
        nodes.append(P.node_proto("Custom", [src], [out], **attrs))
        names.append(out)
    init = rng.normal(size=(int(rng.integers(1, 5)),)).astype(np.float32)
    graph = P.graph_proto(
        "fuzz", nodes=nodes, inputs=[P.value_info("in0", ["batch", 3])],
        outputs=[P.value_info(names[-1], [int(rng.integers(1, 9))])],
        initializers=[P.tensor_proto("w0", init),
                      P.tensor_proto("i0", np.array([-1, 2**40, 0], np.int64))])
    return P.model_proto(graph, opset=16, producer="p")


PROTO_CASES = {
    "minimal": lambda P: P.model_proto(P.graph_proto(
        "g", nodes=[P.node_proto("Relu", ["x"], ["y"])], inputs=[P.value_info("x", [1])],
        outputs=[P.value_info("y", [1])], initializers=[]), producer="p"),
    "long_names": lambda P: P.model_proto(P.graph_proto(
        "g" * 200, nodes=[P.node_proto("Relu", ["n" * 300], ["y" * 200], name="k" * 150)],
        inputs=[P.value_info("n" * 300, ["b" * 130, 3])],
        outputs=[P.value_info("y" * 200, ["b" * 130, 3])],
        initializers=[P.tensor_proto("w" * 140, np.ones((3, 50), np.float32))]), producer="p"),
    "negative_int64": lambda P: P.model_proto(P.graph_proto(
        "g", nodes=[P.node_proto("Slice", ["x"], ["y"], starts=[-9223372036854775808],
                                 ends=[-1], axes=[3], axis=-1)],
        inputs=[P.value_info("x", [3])], outputs=[P.value_info("y", [2])],
        initializers=[P.tensor_proto("s", np.array([-1, -(2**63)], np.int64))]), producer="p"),
    **{f"random_{seed}": (lambda P, seed=seed: _random_graph(P, seed)) for seed in range(5)},
}


@pytest.mark.parametrize("case", PROTO_CASES)
def test_writer_bytes_and_parsers_agree_with_jax(case):
    port, jax_bytes = PROTO_CASES[case](port_proto), PROTO_CASES[case](jax_proto)
    assert port == jax_bytes
    want = _plain(jax_proto.parse_model(jax_bytes))
    assert _plain(port_proto.parse_model(jax_bytes)) == want  # the port parses JAX's bytes
    assert _plain(jax_proto.parse_model(port)) == want  # and JAX parses the port's


def test_model_proto_differs_only_in_producer():
    graph = port_proto.graph_proto("g", [port_proto.node_proto("Relu", ["x"], ["y"])],
                                   [port_proto.value_info("x", [1])],
                                   [port_proto.value_info("y", [1])], [])
    _assert_same_model_bytes(port_proto.model_proto(graph), jax_proto.model_proto(graph))
    assert port_proto.parse_model(port_proto.model_proto(graph)).producer == "ocrs-models-torch"


# ---------------------------------------------------------------- the checker


def _mini(P, nodes, inputs, outputs, inits=()):
    return P.model_proto(P.graph_proto("g", nodes=list(nodes), inputs=list(inputs),
                                       outputs=list(outputs), initializers=list(inits)),
                         producer="p")


CHECK_CASES = {
    # The malformed graphs of tests/test_onnx_contract.py's TestChecker.
    "unsqueeze_axes_attribute": lambda P: _mini(
        P, [P.node_proto("Unsqueeze", ["x"], ["y"], axes=[0])],
        [P.value_info("x", [3])], [P.value_info("y", [1, 3])]),
    "slice_starts_attribute": lambda P: _mini(
        P, [P.node_proto("Slice", ["x"], ["y"], starts=[0], ends=[2])],
        [P.value_info("x", [3])], [P.value_info("y", [2])]),
    "float_reshape_shape": lambda P: _mini(
        P, [P.node_proto("Reshape", ["x", "shape"], ["y"])],
        [P.value_info("x", [6])], [P.value_info("y", [2, 3])],
        inits=[P.tensor_proto("shape", np.array([2.0, 3.0], np.float32))]),
    "missing_kernel_shape": lambda P: _mini(
        P, [P.node_proto("MaxPool", ["x"], ["y"], strides=[2, 2])],
        [P.value_info("x", [1, 1, 4, 4])], [P.value_info("y", [1, 1, 2, 2])]),
    "topology_violation": lambda P: _mini(
        P, [P.node_proto("Relu", ["a"], ["b"]), P.node_proto("Relu", ["x"], ["a"])],
        [P.value_info("x", [3])], [P.value_info("b", [3])]),
    "ssa_violation": lambda P: _mini(
        P, [P.node_proto("Relu", ["x"], ["y"]), P.node_proto("Sigmoid", ["x"], ["y"])],
        [P.value_info("x", [3])], [P.value_info("y", [3])]),
    "missing_graph_output": lambda P: _mini(
        P, [P.node_proto("Relu", ["x"], ["y"])],
        [P.value_info("x", [3])], [P.value_info("z", [3])]),
    "gru_missing_hidden_size": lambda P: _mini(
        P, [P.node_proto("GRU", ["x", "w", "r"], ["y"], direction="bidirectional")],
        [P.value_info("x", [5, 1, 8]), P.value_info("w", [2, 48, 8]),
         P.value_info("r", [2, 48, 16])], [P.value_info("y", [5, 2, 1, 16])]),
    "unknown_attribute": lambda P: _mini(
        P, [P.node_proto("Conv", ["x", "w"], ["y"], kernel_shape=[3, 3], output_padding=[1, 1])],
        [P.value_info("x", [1, 1, 4, 4]), P.value_info("w", [1, 1, 3, 3])],
        [P.value_info("y", [1, 1, 4, 4])]),
    # And well-formed ones, which both accept.
    "relu": lambda P: _mini(P, [P.node_proto("Relu", ["x"], ["y"])],
                            [P.value_info("x", [3])], [P.value_info("y", [3])]),
    "unsqueeze_axes_input": lambda P: _mini(
        P, [P.node_proto("Unsqueeze", ["x", "axes"], ["y"])],
        [P.value_info("x", [3])], [P.value_info("y", [1, 3])],
        inits=[P.tensor_proto("axes", np.array([0], np.int64))]),
}


@pytest.mark.parametrize("case", CHECK_CASES)
def test_checker_accepts_and_rejects_what_jax_does(case):
    data = CHECK_CASES[case](port_proto)
    assert data == CHECK_CASES[case](jax_proto)
    outcomes = []
    for check, error in ((port_check.check_bytes, port_check.OnnxCheckError),
                         (jax_check.check_bytes, jax_check.OnnxCheckError)):
        try:
            check(data)
            outcomes.append(None)
        except error as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == (case in ("relu", "unsqueeze_axes_input"))


def test_checker_is_pure_static():
    import inspect

    assert "onnx_eval" not in inspect.getsource(port_check)


# ------------------------------------------------------- graph bytes, per model

GRAPH_CASES = {
    "detection_64x64": ("detection", {"height": 64, "width": 64}),
    "detection_64x96": ("detection", {"height": 64, "width": 96}),
    "recognition": ("recognition", {}),
    "layout_sin": ("layout", {}),
    "layout_mlp": ("layout-mlp", {}),
}


def _jax_onnx(kind: str, variables, path, **kwargs) -> bytes:
    if kind == "layout-mlp":
        # JAX export_weights maps the variables with export_layout_state_dict's
        # defaults (pos_embedding="sin"), which drop the MLP embedding: call
        # its exporter and builder as it does, with the embedding named.
        sd = export_layout_state_dict(variables, pos_embedding="mlp")
        return jax_graph.build_layout_onnx(sd, pos_embedding="mlp")
    jax_export_weights(JaxState(variables), str(path), _model_name(kind), **kwargs)
    return path.read_bytes()


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_onnx_graph_bytes_equal_jax(case, tmp_path):
    kind, kwargs = GRAPH_CASES[case]
    variables, model = setup(kind)
    export_weights(create_train_state(model), str(tmp_path / "port.onnx"), _model_name(kind),
                   **kwargs)
    port = (tmp_path / "port.onnx").read_bytes()
    _assert_same_model_bytes(port, _jax_onnx(kind, variables, tmp_path / "jax.onnx", **kwargs))
    m = port_check.check_bytes(port)
    io = {"detection": (("image", ["batch", 1, kwargs.get("height"), kwargs.get("width")]),
                        "mask"),
          "recognition": (("line_image", ["batch", 1, 64, "seq"]), "chars"),
          "layout": (("word_boxes", ["batch", "box", 4]), "preds")}[_model_name(kind)]
    assert m.graph.inputs == [io[0]] and m.graph.outputs[0][0] == io[1]
    assert (m.ir_version, m.opset) == (8, 16)


def test_recognition_onnx_takes_the_models_gru_width(tmp_path):
    # export_weights reads the biGRU's width from the model
    # (export_utils.builder_kwargs): at gru_hidden=100 its graph is the
    # JAX builder's at hidden=100 byte for byte, with hidden_size 100.
    variables = random_variables(jax_models.RecognitionModel(n_classes=97, gru_hidden=100),
                                 (1, 64, 64, 1), 5)
    model = RecognitionModel(n_classes=97, gru_hidden=100)
    model.load_state_dict(weights.recognition_state_dict_from_jax(variables), strict=True)
    export_weights(create_train_state(model), str(tmp_path / "port.onnx"), "recognition")
    port = (tmp_path / "port.onnx").read_bytes()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    _assert_same_model_bytes(port, jax_graph.build_recognition_onnx(sd, hidden=100))
    grus = [n for n in port_proto.parse_model(port).graph.nodes if n.op_type == "GRU"]
    assert len(grus) == 2 and all(n.attrs["hidden_size"] == 100 for n in grus)


# ------------------------------------------------------------------- numerics


def _run_both(data: bytes, feeds: dict) -> dict:
    """The port's ``run_graph`` on the port's parse, held bit-equal to the
    JAX ``run_graph`` on JAX's parse of the same bytes."""
    got = port_eval.run_graph(port_proto.parse_model(data), feeds)
    want = jax_eval.run_graph(jax_proto.parse_model(data), feeds)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    return got


@pytest.mark.parametrize("batch,width", [(2, 96), (3, 256)])
def test_recognition_onnx_matches_the_port_forward(batch, width):
    x = np.random.default_rng(3).uniform(-0.5, 0.5, (batch, 1, 64, width)).astype(np.float32)
    _, model = setup("recognition")
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    data = _onnx_of_model("recognition", model)
    theirs = _run_both(data, {"line_image": x})["chars"].transpose(1, 0, 2)
    assert theirs.shape == ours.shape == (batch, width // 4 + 1, 97)
    np.testing.assert_allclose(theirs, ours, atol=REC_ATOL, rtol=0)
    assert (ours.argmax(-1) == theirs.argmax(-1)).mean() > 0.999


def _random_model(kind: str):
    """The port model of ``kind`` on ``torch_port_common``'s seeded weights
    (unit-scale kernels, non-trivial batch-norm statistics). The perturbed
    init weights saturate the detector's sigmoid (every output 1.0), so its
    numerics are held on these."""
    jax_model, shape, seed, port_model, to_port = SETUPS[kind]
    if kind.startswith("layout"):
        variables = layout_variables(jax_model(), seed + 10)
    else:
        variables = random_variables(jax_model(), shape, seed + 10)
    model = port_model()
    model.load_state_dict(to_port(variables), strict=True)
    return model.eval()


def _onnx_of_model(kind: str, model, **kwargs) -> bytes:
    state = create_train_state(model)
    return onnx_bytes(_model_name(kind), {k: v.numpy() for k, v in model.state_dict().items()},
                      **{**builder_kwargs(_model_name(kind), state.model), **kwargs})


@pytest.mark.parametrize("batch,height,width", [(1, 64, 64), (2, 64, 96)])
def test_detection_onnx_matches_the_port_forward(batch, height, width):
    x = np.random.default_rng(4).uniform(-0.5, 0.5, (batch, 1, height, width)).astype(np.float32)
    model = _random_model("detection")
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    data = _onnx_of_model("detection", model, height=height, width=width)
    theirs = _run_both(data, {"image": x})["mask"]
    assert theirs.shape == ours.shape == (batch, 1, height, width)
    np.testing.assert_allclose(theirs, ours, atol=DET_ATOL, rtol=0)


@pytest.mark.parametrize("weights_from", ["perturbed_init", "random"])
@pytest.mark.parametrize("kind", ["layout", "layout-mlp"])
def test_layout_onnx_matches_the_port_forward(kind, weights_from):
    boxes = np.random.default_rng(5).uniform(0, 500, (2, 12, 4)).astype(np.float32)
    model = setup(kind)[1] if weights_from == "perturbed_init" else _random_model(kind)
    with torch.no_grad():
        ours = model(torch.from_numpy(boxes)).numpy()
    theirs = _run_both(_onnx_of_model(kind, model), {"word_boxes": boxes})["preds"]
    assert theirs.shape == ours.shape == (2, 12, 2)
    np.testing.assert_allclose(theirs, ours, atol=LAYOUT_ATOL, rtol=0)


# ----------------------------------------------------------------------- .npz


def _assert_same_npz(got_path, want_path):
    got, want = np.load(got_path), np.load(want_path)
    assert got.files == want.files
    for k in want.files:
        a, b = got[k], want[k]
        assert (a.dtype, a.shape) == (b.dtype, b.shape) and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("kind", ["detection", "recognition", "layout", "layout-mlp"])
def test_npz_equals_jax_and_round_trips(kind, tmp_path):
    variables, model = setup(kind)
    export_weights(create_train_state(model), str(tmp_path / "port.npz"), _model_name(kind))
    jax_export_weights(JaxState(variables), str(tmp_path / "jax.npz"), _model_name(kind))
    _assert_same_npz(tmp_path / "port.npz", tmp_path / "jax.npz")

    # Back through the JAX -> port mapping into a fresh model, strictly.
    _, _, _, port_model, to_port = SETUPS[kind]
    fresh = port_model()
    fresh.load_state_dict(to_port(read_npz(tmp_path / "port.npz")), strict=True)
    for key, value in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(fresh.state_dict()[key], value), key


# -------------------------------------------------------------------- convert


@pytest.mark.parametrize("kind", ["recognition", "layout"])
def test_convert_equals_jax_convert(kind, tmp_path):
    """A port trainer checkpoint and the JAX package's Orbax directory of
    the same weights convert to the same three files."""
    state = jax_fresh_state(kind)
    variables = _perturb({"params": state.params, "batch_stats": state.batch_stats}, seed=7)
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    jax_save_checkpoint(str(tmp_path / "jax_ckpt"), state, epoch=3)

    model = {"recognition": lambda: RecognitionModel(n_classes=97), "layout": LayoutModel}[kind]()
    to_port = {"recognition": weights.recognition_state_dict_from_jax,
               "layout": weights.layout_state_dict_from_jax}[kind]
    model.load_state_dict(to_port(variables), strict=True)
    save_checkpoint(str(tmp_path / "port_ckpt.pt"), create_train_state(model), epoch=3)

    for ext in ("onnx", "npz", "pt"):
        jax_out, port_out = tmp_path / f"jax.{ext}", tmp_path / f"port.{ext}"
        assert jax_export_main(["convert", kind, str(tmp_path / "jax_ckpt"), str(jax_out)]) == 0
        assert port_export_main(["convert", kind, str(tmp_path / "port_ckpt.pt"),
                                 str(port_out)]) == 0
        if ext == "onnx":
            _assert_same_model_bytes(port_out.read_bytes(), jax_out.read_bytes())
        elif ext == "npz":
            _assert_same_npz(port_out, jax_out)
        else:
            got = torch.load(port_out, weights_only=True)
            want = torch.load(jax_out, weights_only=True)
            assert got["epoch"] == want["epoch"] == 3 and got["optimizer_state"] == {}
            assert got["model_state"].keys() == want["model_state"].keys()
            for key, value in want["model_state"].items():
                assert torch.equal(got["model_state"][key], value), key


@pytest.mark.parametrize("ext", ["onnx", "npz", "pt"])
def test_convert_takes_a_jax_export_pt(ext, tmp_path):
    """The JAX package's ``--export x.pt`` converts to the file JAX
    ``export_weights`` writes from the same variables."""
    variables, _ = setup("detection")
    jax_export_weights(JaxState(variables), str(tmp_path / "jax.pt"), "detection", epoch=5)
    jax_export_weights(JaxState(variables), str(tmp_path / f"want.{ext}"), "detection", epoch=5)
    out = tmp_path / f"got.{ext}"
    assert port_export_main(["convert", "detection", str(tmp_path / "jax.pt"), str(out)]) == 0
    if ext == "onnx":
        _assert_same_model_bytes(out.read_bytes(), (tmp_path / "want.onnx").read_bytes())
    elif ext == "npz":
        _assert_same_npz(out, tmp_path / "want.npz")
    else:
        got, want = torch.load(out, weights_only=True), torch.load(tmp_path / "want.pt",
                                                                    weights_only=True)
        assert got["epoch"] == 5 and got["model_state"].keys() == want["model_state"].keys()
        for key, value in want["model_state"].items():
            assert torch.equal(got["model_state"][key], value), key


@pytest.mark.parametrize("argv,error", [
    (["convert", "layout", "det.pt", "out.onnx"], RuntimeError),  # a detection checkpoint
    (["convert", "recognition", "det.pt", "out.npz"], RuntimeError),
    (["convert", "detection", "det.pt", "out.bin"], ValueError),
])
def test_convert_refusals_write_nothing(argv, error, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    torch.save({"epoch": 0, "model_state": DetectionModel().state_dict(), "optimizer_state": {}},
               "det.pt")
    with pytest.raises(error):
        port_export_main(argv)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["det.pt"]


def test_export_bare_state_dict_and_failed_check_leaves_no_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _, model = setup("layout")
    torch.save(model.state_dict(), "bare.pt")
    assert port_export_main(["convert", "layout", "bare.pt", "bare.onnx"]) == 0
    port_check.check_bytes((tmp_path / "bare.onnx").read_bytes())

    def broken(data):
        raise port_check.OnnxCheckError("injected")

    monkeypatch.setattr(port_check, "check_bytes", broken)
    with pytest.raises(port_check.OnnxCheckError, match="injected"):
        export_weights(create_train_state(model), "x.onnx", "layout")
    assert not (tmp_path / "x.onnx").exists()
