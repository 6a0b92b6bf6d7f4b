"""Independent strict ONNX checker (opset 16).

The port's copy of ``ocrs_models_tpu/export/onnx_check.py``, table and
all.

Validates a parsed :class:`~.onnx_proto.Model` against the ONNX
specification — graph well-formedness (SSA, topological order, resolvable
names) and per-op schema constraints (input/output arity, attribute
names/types, opset-16 attribute-vs-input conventions).

The op table below is transcribed from the ONNX operator spec
(onnx/defs, opset 16), NOT from what :mod:`.onnx_graph` emits — that is
the point: this checker is the in-repo stand-in for the downstream
ONNX->rten toolchain that consumes the reference's exports
(reference docs/training.md:138-154), so a convention the emitter
and evaluator *both* misremember (e.g. `axes` as an attribute on
opset-16 Unsqueeze, or a float `shape` input to Reshape) fails here even
though emitter-evaluator round trips pass.

Spec subtleties encoded:
- Squeeze/Unsqueeze take `axes` as an int64 INPUT since opset 13; the
  attribute form is illegal at opset >= 13.
- Slice takes starts/ends/axes/steps as INPUTS since opset 10.
- Split takes the split sizes as an optional INPUT since opset 13
  (`num_outputs` does not exist until opset 18).
- ReduceMean keeps `axes` as an ATTRIBUTE through opset 17 (the input
  form arrives at 18) — the mirror image of Squeeze.
- BatchNormalization emits 1 output unless training_mode=1 (opset 15+).
- Graph nodes must be topologically sorted, and every value name is
  single-assignment (ONNX IR spec, "Graphs ... nodes MUST be in
  topological order").
"""

from __future__ import annotations

import numpy as np

from .onnx_proto import Graph, Model, Node

# attr type tags for the table below
_I, _F, _S, _INTS, _FLOATS = "i", "f", "s", "ints", "floats"

_PY_TYPES = {
    _I: lambda v: isinstance(v, int),
    _F: lambda v: isinstance(v, float),
    _S: lambda v: isinstance(v, str),
    _INTS: lambda v: isinstance(v, list) and all(isinstance(x, int) for x in v),
    _FLOATS: lambda v: isinstance(v, list)
    and all(isinstance(x, float) for x in v),
}

# op -> (min_in, max_in, min_out, max_out, required attrs, optional attrs)
_OPS: dict[str, tuple[int, int, int, int, dict, dict]] = {
    "Add": (2, 2, 1, 1, {}, {}),
    "Sub": (2, 2, 1, 1, {}, {}),
    "Mul": (2, 2, 1, 1, {}, {}),
    "Div": (2, 2, 1, 1, {}, {}),
    "Pow": (2, 2, 1, 1, {}, {}),
    "MatMul": (2, 2, 1, 1, {}, {}),
    "Relu": (1, 1, 1, 1, {}, {}),
    "Sigmoid": (1, 1, 1, 1, {}, {}),
    "Tanh": (1, 1, 1, 1, {}, {}),
    "Sqrt": (1, 1, 1, 1, {}, {}),
    "Sin": (1, 1, 1, 1, {}, {}),
    "Cos": (1, 1, 1, 1, {}, {}),
    "Round": (1, 1, 1, 1, {}, {}),
    "Identity": (1, 1, 1, 1, {}, {}),
    "Erf": (1, 1, 1, 1, {}, {}),
    "Concat": (1, 2**31, 1, 1, {"axis": _I}, {}),
    "Conv": (
        2, 3, 1, 1, {},
        {"auto_pad": _S, "dilations": _INTS, "group": _I,
         "kernel_shape": _INTS, "pads": _INTS, "strides": _INTS},
    ),
    "ConvTranspose": (
        2, 3, 1, 1, {},
        {"auto_pad": _S, "dilations": _INTS, "group": _I,
         "kernel_shape": _INTS, "output_padding": _INTS,
         "output_shape": _INTS, "pads": _INTS, "strides": _INTS},
    ),
    "MaxPool": (
        1, 1, 1, 2, {"kernel_shape": _INTS},
        {"auto_pad": _S, "ceil_mode": _I, "dilations": _INTS,
         "pads": _INTS, "storage_order": _I, "strides": _INTS},
    ),
    "AveragePool": (
        1, 1, 1, 1, {"kernel_shape": _INTS},
        {"auto_pad": _S, "ceil_mode": _I, "count_include_pad": _I,
         "pads": _INTS, "strides": _INTS},
    ),
    "BatchNormalization": (
        5, 5, 1, 3, {},
        {"epsilon": _F, "momentum": _F, "training_mode": _I},
    ),
    "GRU": (
        3, 6, 0, 2, {},
        {"activation_alpha": _FLOATS, "activation_beta": _FLOATS,
         "clip": _F, "direction": _S, "hidden_size": _I, "layout": _I,
         "linear_before_reset": _I},
    ),
    "Reshape": (2, 2, 1, 1, {}, {"allowzero": _I}),
    "Transpose": (1, 1, 1, 1, {}, {"perm": _INTS}),
    "Squeeze": (1, 2, 1, 1, {}, {}),
    "Unsqueeze": (2, 2, 1, 1, {}, {}),
    "Slice": (3, 5, 1, 1, {}, {}),
    "Split": (1, 2, 1, 2**31, {}, {"axis": _I}),
    "Softmax": (1, 1, 1, 1, {}, {"axis": _I}),
    "LogSoftmax": (1, 1, 1, 1, {}, {"axis": _I}),
    "ReduceMean": (1, 1, 1, 1, {}, {"axes": _INTS, "keepdims": _I}),
    "Gather": (2, 2, 1, 1, {}, {"axis": _I}),
    "Cast": (1, 1, 1, 1, {"to": _I}, {}),
    "Shape": (1, 1, 1, 1, {}, {"end": _I, "start": _I}),
}

# (op, input position) pairs that may legally be the empty string
# (optional inputs skipped positionally).
_OPTIONAL_EMPTY = {("GRU", 3), ("GRU", 4), ("GRU", 5), ("Conv", 2),
                   ("ConvTranspose", 2), ("Slice", 3), ("Slice", 4),
                   ("Squeeze", 1), ("Split", 1)}

# (op, input position) inputs that, when backed by an initializer, must be
# a 1-D int64 tensor (shape/axes/starts/ends/steps/split operands).
_INT64_OPERANDS = {
    ("Reshape", 1), ("Squeeze", 1), ("Unsqueeze", 1),
    ("Slice", 1), ("Slice", 2), ("Slice", 3), ("Slice", 4),
    ("Split", 1),
}


class OnnxCheckError(AssertionError):
    pass


def _err(errors: list[str], msg: str) -> None:
    errors.append(msg)


def _check_node(node: Node, idx: int, g: Graph, errors: list[str]) -> None:
    where = f"node[{idx}] {node.op_type}({node.name!r})"
    spec = _OPS.get(node.op_type)
    if spec is None:
        _err(errors, f"{where}: op not in opset-16 checker table")
        return
    min_in, max_in, min_out, max_out, req, opt = spec
    n_in, n_out = len(node.inputs), len(node.outputs)
    if not (min_in <= n_in <= max_in):
        _err(errors, f"{where}: {n_in} inputs, spec allows [{min_in},{max_in}]")
    if not (min_out <= n_out <= max_out):
        _err(errors, f"{where}: {n_out} outputs, spec allows [{min_out},{max_out}]")

    allowed = {**req, **opt}
    for k, v in node.attrs.items():
        if k not in allowed:
            _err(errors, f"{where}: attribute {k!r} not allowed at opset 16")
        elif not _PY_TYPES[allowed[k]](v):
            _err(
                errors,
                f"{where}: attribute {k!r} has wrong type "
                f"{type(v).__name__}, spec wants {allowed[k]}",
            )
    for k in req:
        if k not in node.attrs:
            _err(errors, f"{where}: required attribute {k!r} missing")

    # Op-specific semantic constraints.
    if node.op_type == "GRU":
        direction = node.attrs.get("direction", "forward")
        if direction not in ("forward", "reverse", "bidirectional"):
            _err(errors, f"{where}: invalid direction {direction!r}")
        if "hidden_size" not in node.attrs:
            # Optional in the schema but required by every real consumer
            # (shape inference cannot recover it from B-less graphs).
            _err(errors, f"{where}: hidden_size missing (consumers require it)")
        lbr = node.attrs.get("linear_before_reset", 0)
        if lbr not in (0, 1):
            _err(errors, f"{where}: linear_before_reset must be 0/1, got {lbr}")
    if node.op_type == "BatchNormalization":
        if n_out > 1 and node.attrs.get("training_mode", 0) != 1:
            _err(errors, f"{where}: >1 output requires training_mode=1")
    if node.op_type in ("Conv", "ConvTranspose", "MaxPool", "AveragePool"):
        ks = node.attrs.get("kernel_shape")
        pads = node.attrs.get("pads")
        if ks is not None and pads is not None and len(pads) != 2 * len(ks):
            _err(errors, f"{where}: pads length {len(pads)} != 2*kernel rank")

    for pos in _INT64_OPERANDS:
        if pos[0] != node.op_type or pos[1] >= n_in:
            continue
        name = node.inputs[pos[1]]
        if name in g.initializers:
            arr = g.initializers[name]
            if arr.dtype != np.int64:
                _err(
                    errors,
                    f"{where}: input[{pos[1]}] ({name!r}) must be int64, "
                    f"is {arr.dtype}",
                )
            if arr.ndim != 1:
                _err(errors, f"{where}: input[{pos[1]}] must be 1-D")


def check_model(model: Model) -> None:
    """Raise :class:`OnnxCheckError` listing every violation found."""
    errors: list[str] = []
    if model.ir_version < 7:
        _err(errors, f"ir_version {model.ir_version} < 7 (opset-16 era is 8)")
    if not (13 <= model.opset <= 17):
        # The table encodes the opset 13..17 attribute/input conventions.
        _err(errors, f"opset {model.opset} outside the checker's validity window")

    g = model.graph
    if not g.name:
        _err(errors, "graph has no name")

    init_names = list(g.initializers)
    if len(set(init_names)) != len(init_names):
        _err(errors, "duplicate initializer names")
    input_names = [n for n, _ in g.inputs]
    if len(set(input_names)) != len(input_names):
        _err(errors, "duplicate graph input names")
    for name, dims in list(g.inputs) + list(g.outputs):
        if not name:
            _err(errors, "graph input/output with empty name")
        for d in dims:
            if not (isinstance(d, str) or (isinstance(d, int) and d > 0)):
                _err(errors, f"value_info {name!r}: bad dim {d!r}")

    # SSA + topological-order walk.
    available = set(init_names) | set(input_names)
    defined = set(available)
    for idx, node in enumerate(g.nodes):
        where = f"node[{idx}] {node.op_type}({node.name!r})"
        if not node.op_type:
            _err(errors, f"{where}: empty op_type")
        for i, name in enumerate(node.inputs):
            if name == "":
                if (node.op_type, i) not in _OPTIONAL_EMPTY:
                    _err(errors, f"{where}: input[{i}] empty but not optional")
                continue
            if name not in available:
                _err(
                    errors,
                    f"{where}: input {name!r} not defined before use "
                    "(topological order / unknown name)",
                )
        for name in node.outputs:
            if not name:
                _err(errors, f"{where}: empty output name")
            elif name in defined:
                _err(errors, f"{where}: output {name!r} violates SSA")
            defined.add(name)
            available.add(name)
        _check_node(node, idx, g, errors)

    for name, _ in g.outputs:
        if name and name not in available:
            _err(errors, f"graph output {name!r} is never produced")

    if errors:
        raise OnnxCheckError(
            f"{len(errors)} ONNX spec violations:\n" + "\n".join(errors)
        )


def check_bytes(data: bytes) -> Model:
    """Parse + check serialized model bytes; returns the parsed model."""
    from .onnx_proto import parse_model

    model = parse_model(data)
    check_model(model)
    return model
