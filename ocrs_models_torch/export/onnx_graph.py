"""First-party ONNX graph emission for the three models.

The port's copy of ``ocrs_models_tpu/export/onnx_graph.py``: the same
nodes and initializers in the same order, so the same weights give the
same GraphProto bytes. Builds ``ModelProto`` bytes from reference-format
state dicts (the port's own ``state_dict()``, as numpy float32),
reproducing the reference's export
contracts — input/output names, dynamic axes, opset 16:

- detection:   image [batch,1,H,W] -> mask [batch,1,H,W]
  (train_detection.py:398-405)
- recognition: line_image [batch,1,64,seq] -> chars [out_seq,batch,C]
  (train_rec.py:396-409; GRU emitted with linear_before_reset=1 and
  torch's r,z,n gates reordered to ONNX's z,r,h)
- layout:      word_boxes [batch,box,4] -> preds [batch,box,2]
  (train_layout.py:255-269; LayerNorm decomposed into primitive ops so the
  graph stays within opset 16)

Every emitted file is validated by the tests: parsed back with
:mod:`.onnx_proto` and executed with :mod:`.onnx_eval` against the port's
forward pass on the same inputs.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np

from .onnx_proto import graph_proto, model_proto, node_proto, tensor_proto, value_info


class GraphBuilder:
    def __init__(self, name: str):
        self.name = name
        self.nodes: list[bytes] = []
        self.inits: list[bytes] = []
        self._n = 0

    def fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def init(self, hint: str, arr: np.ndarray) -> str:
        name = self.fresh(hint)
        self.inits.append(tensor_proto(name, np.asarray(arr)))
        return name

    def add(
        self,
        op: str,
        inputs: Sequence[str],
        out: str | None = None,
        n_out: int = 1,
        **attrs,
    ):
        outs = (
            [out]
            if (out is not None and n_out == 1)
            else [self.fresh(f"{op.lower()}_out") for _ in range(n_out)]
        )
        self.nodes.append(node_proto(op, inputs, outs, **attrs))
        return outs[0] if n_out == 1 else outs

    def build(self, inputs, outputs, opset: int = 16) -> bytes:
        g = graph_proto(
            self.name,
            self.nodes,
            [value_info(n, d) for n, d in inputs],
            [value_info(n, d) for n, d in outputs],
            self.inits,
        )
        return model_proto(g, opset=opset)


def _f32(sd: Mapping[str, np.ndarray], key: str) -> np.ndarray:
    return np.asarray(sd[key], dtype=np.float32)


# ------------------------------- detection -------------------------------


def _emit_dw_block(g: GraphBuilder, sd, key: str, x: str) -> str:
    """DepthwiseConv block: grouped 3x3 conv -> 1x1 conv -> BN -> ReLU
    (reference models.py:7-28)."""
    dw = _f32(sd, f"{key}.seq.0.weight")  # [C,1,3,3]
    c = dw.shape[0]
    x = g.add(
        "Conv",
        [x, g.init("dw_w", dw)],
        pads=[1, 1, 1, 1],
        strides=[1, 1],
        group=c,
        kernel_shape=[3, 3],
    )
    pw = _f32(sd, f"{key}.seq.1.weight")  # [O,C,1,1]
    x = g.add("Conv", [x, g.init("pw_w", pw)], kernel_shape=[1, 1])
    x = g.add(
        "BatchNormalization",
        [
            x,
            g.init("bn_scale", _f32(sd, f"{key}.seq.2.weight")),
            g.init("bn_bias", _f32(sd, f"{key}.seq.2.bias")),
            g.init("bn_mean", _f32(sd, f"{key}.seq.2.running_mean")),
            g.init("bn_var", _f32(sd, f"{key}.seq.2.running_var")),
        ],
        epsilon=1e-5,
    )
    return g.add("Relu", [x])


def _emit_double_conv(g: GraphBuilder, sd, key: str, x: str) -> str:
    x = _emit_dw_block(g, sd, f"{key}.seq.0", x)
    return _emit_dw_block(g, sd, f"{key}.seq.1", x)


def build_detection_onnx(
    sd: Mapping[str, np.ndarray], height: int = 800, width: int = 600
) -> bytes:
    """U-Net graph (reference models.py:93-143). Batch axis dynamic; spatial
    dims fixed at build time (the trim after each ConvTranspose needs static
    Slice bounds, mirroring what tracing the torch model records)."""
    g = GraphBuilder("ocrs_detection")
    n_levels = 6

    x = _emit_double_conv(g, sd, "in_conv", "image")
    sizes = [(height, width)]
    skips = [x]
    h, w = height, width
    for i in range(n_levels):
        x = _emit_double_conv(g, sd, f"down.{i}.seq.0", x)
        x = g.add("MaxPool", [x], kernel_shape=[2, 2], strides=[2, 2])
        h, w = h // 2, w // 2
        sizes.append((h, w))
        skips.append(x)

    out = skips[-1]
    for i in reversed(range(n_levels)):
        wt = _f32(sd, f"up.{i}.up.weight")  # [in, out, 3, 3]
        out = g.add(
            "ConvTranspose",
            [out, g.init("up_w", wt), g.init("up_b", _f32(sd, f"up.{i}.up.bias"))],
            strides=[2, 2],
            kernel_shape=[3, 3],
        )
        sh, sw = sizes[i]
        out = g.add(
            "Slice",
            [
                out,
                g.init("sl_starts", np.array([0, 0], np.int64)),
                g.init("sl_ends", np.array([sh, sw], np.int64)),
                g.init("sl_axes", np.array([2, 3], np.int64)),
            ],
        )
        out = g.add("Concat", [out, skips[i]], axis=1)
        out = _emit_double_conv(g, sd, f"up.{i}.contract", out)

    out = g.add(
        "Conv",
        [
            out,
            g.init("out_w", _f32(sd, "out_conv.0.weight")),
            g.init("out_b", _f32(sd, "out_conv.0.bias")),
        ],
        kernel_shape=[1, 1],
    )
    g.add("Sigmoid", [out], out="mask")
    return g.build(
        inputs=[("image", ["batch", 1, height, width])],
        outputs=[("mask", ["batch", 1, height, width])],
    )


# ------------------------------ recognition ------------------------------


def _torch_gru_to_onnx(sd, layer: int, hidden: int):
    """Reorder torch GRU weights (gates r,z,n; bias_ih/bias_hh) into ONNX
    GRU inputs W [2,3H,I], R [2,3H,H], B [2,6H] (gates z,r,h;
    linear_before_reset=1 matches torch's n-gate semantics)."""

    def zrn(m):  # rows [r; z; n] -> [z; r; n]
        h = hidden
        return np.concatenate([m[h : 2 * h], m[:h], m[2 * h :]], axis=0)

    ws, rs, bs = [], [], []
    for suffix in ("", "_reverse"):
        w_ih = zrn(np.asarray(sd[f"gru.weight_ih_l{layer}{suffix}"], np.float32))
        w_hh = zrn(np.asarray(sd[f"gru.weight_hh_l{layer}{suffix}"], np.float32))
        b_ih = zrn(np.asarray(sd[f"gru.bias_ih_l{layer}{suffix}"], np.float32))
        b_hh = zrn(np.asarray(sd[f"gru.bias_hh_l{layer}{suffix}"], np.float32))
        ws.append(w_ih)
        rs.append(w_hh)
        bs.append(np.concatenate([b_ih, b_hh]))
    return np.stack(ws), np.stack(rs), np.stack(bs)


def _emit_conv_bn_relu(
    g: GraphBuilder,
    sd,
    x: str,
    conv_key: str,
    bn_key: str | None,
    relu: bool = True,
    kernel: int = 3,
    bias: bool = True,
) -> str:
    w = _f32(sd, f"{conv_key}.weight")
    ins = [x, g.init("conv_w", w)]
    if bias:
        ins.append(g.init("conv_b", _f32(sd, f"{conv_key}.bias")))
    x = g.add(
        "Conv",
        ins,
        pads=[1, 1, 1, 1],
        strides=[1, 1],
        kernel_shape=[kernel, kernel],
    )
    if bn_key is not None:
        x = g.add(
            "BatchNormalization",
            [
                x,
                g.init("bn_scale", _f32(sd, f"{bn_key}.weight")),
                g.init("bn_bias", _f32(sd, f"{bn_key}.bias")),
                g.init("bn_mean", _f32(sd, f"{bn_key}.running_mean")),
                g.init("bn_var", _f32(sd, f"{bn_key}.running_var")),
            ],
            epsilon=1e-5,
        )
    return g.add("Relu", [x]) if relu else x


def build_recognition_onnx(sd: Mapping[str, np.ndarray], hidden: int = 256) -> bytes:
    """CRNN graph (reference models.py:146-268): conv stack -> 2-layer
    bidirectional GRU -> linear + log-softmax. Width (``seq``) and batch are
    dynamic; output is ``chars [out_seq, batch, n_classes]``."""
    g = GraphBuilder("ocrs_recognition")
    x = "line_image"
    # Conv stack (keys follow the reference nn.Sequential indices).
    x = _emit_conv_bn_relu(g, sd, x, "conv.0", None)
    x = g.add("MaxPool", [x], kernel_shape=[2, 2], strides=[2, 2])
    x = _emit_conv_bn_relu(g, sd, x, "conv.3", "conv.4", bias=False)
    x = g.add("MaxPool", [x], kernel_shape=[2, 2], strides=[2, 2])
    x = _emit_conv_bn_relu(g, sd, x, "conv.7", None)
    x = _emit_conv_bn_relu(g, sd, x, "conv.9", "conv.10", bias=False)
    x = g.add("MaxPool", [x], kernel_shape=[2, 1], strides=[2, 1])
    x = _emit_conv_bn_relu(g, sd, x, "conv.13", None)
    x = _emit_conv_bn_relu(g, sd, x, "conv.15", "conv.16", bias=False)
    x = g.add("MaxPool", [x], kernel_shape=[2, 1], strides=[2, 1])
    x = _emit_conv_bn_relu(
        g, sd, x, "conv.19", "conv.20", relu=False, kernel=2, bias=False
    )
    x = g.add("AveragePool", [x], kernel_shape=[4, 1], strides=[4, 1])

    # [N, C, 1, T] -> [T, N, C]  (reference forward permute, models.py:253-260)
    x = g.add("Squeeze", [x, g.init("sq_axes", np.array([2], np.int64))])
    x = g.add("Transpose", [x], perm=[2, 0, 1])

    for layer in range(2):
        w, r, b = _torch_gru_to_onnx(sd, layer, hidden)
        y = g.add(
            "GRU",
            [x, g.init("gru_w", w), g.init("gru_r", r), g.init("gru_b", b)],
            hidden_size=hidden,
            direction="bidirectional",
            linear_before_reset=1,
        )  # Y: [T, 2, N, H]
        y = g.add("Transpose", [y], perm=[0, 2, 1, 3])
        x = g.add(
            "Reshape", [y, g.init("rs_shape", np.array([0, 0, -1], np.int64))]
        )  # [T, N, 2H]

    w_out = _f32(sd, "output.0.weight").T  # [2H, C]
    x = g.add("MatMul", [x, g.init("head_w", w_out)])
    x = g.add("Add", [x, g.init("head_b", _f32(sd, "output.0.bias"))])
    g.add("LogSoftmax", [x], out="chars", axis=2)

    n_classes = w_out.shape[1]
    return g.build(
        inputs=[("line_image", ["batch", 1, 64, "seq"])],
        outputs=[("chars", ["out_seq", "batch", n_classes])],
    )


# --------------------------------- layout --------------------------------


def _emit_layer_norm(g: GraphBuilder, sd, key: str, x: str) -> str:
    """LayerNorm decomposed into opset-16 primitives (LayerNormalization is
    opset 17; the reference exports layout at opset 16)."""
    mean = g.add("ReduceMean", [x], axes=[-1], keepdims=1)
    centered = g.add("Sub", [x, mean])
    var = g.add(
        "ReduceMean", [g.add("Mul", [centered, centered])], axes=[-1], keepdims=1
    )
    std = g.add("Sqrt", [g.add("Add", [var, g.init("ln_eps", np.float32(1e-5))])])
    normed = g.add("Div", [centered, std])
    normed = g.add("Mul", [normed, g.init("ln_scale", _f32(sd, f"{key}.weight"))])
    return g.add("Add", [normed, g.init("ln_bias", _f32(sd, f"{key}.bias"))])


def _emit_linear(g: GraphBuilder, sd, key: str, x: str) -> str:
    x = g.add("MatMul", [x, g.init("lin_w", _f32(sd, f"{key}.weight").T)])
    return g.add("Add", [x, g.init("lin_b", _f32(sd, f"{key}.bias"))])


def build_layout_onnx(
    sd: Mapping[str, np.ndarray],
    d_model: int = 256,
    n_heads: int = 4,
    n_layers: int = 6,
    pos_embedding: str = "sin",
    return_probs: bool = False,
) -> bytes:
    """Layout transformer graph (reference models.py:340-406): sinusoidal
    bbox encoding -> 6 post-LN encoder layers -> linear classifier.

    Attention is emitted over the word axis of each sample, as the port's
    ``LayoutModel`` attends (see the models/layout.py docstring on the
    reference's seq-first encoder)."""
    g = GraphBuilder("ocrs_layout")
    boxes = "word_boxes"  # [batch, box, 4]

    if pos_embedding == "sin":
        depth = d_model // 4 // 2
        rates = (
            1.0 / (10_000.0 ** (np.arange(depth, dtype=np.float32) / depth))
        ).astype(np.float32)
        x = g.add("Round", [boxes])
        x = g.add("Unsqueeze", [x, g.init("unsq_axes", np.array([3], np.int64))])
        ang = g.add("Mul", [x, g.init("rates", rates)])  # [batch, box, 4, depth]
        enc = g.add("Concat", [g.add("Sin", [ang]), g.add("Cos", [ang])], axis=3)
        x = g.add(
            "Reshape", [enc, g.init("rs_shape", np.array([0, 0, -1], np.int64))]
        )  # [batch, box, d_model]
    elif pos_embedding == "mlp":
        x = g.add("Relu", [_emit_linear(g, sd, "embed.0", boxes)])
        x = g.add("Relu", [_emit_linear(g, sd, "embed.2", x)])
    else:
        raise ValueError(f"Unknown pos_embedding {pos_embedding!r}")

    dh = d_model // n_heads
    for i in range(n_layers):
        base = f"encode.layers.{i}"
        qkv = g.add(
            "MatMul",
            [x, g.init("qkv_w", _f32(sd, f"{base}.self_attn.in_proj_weight").T)],
        )
        qkv = g.add(
            "Add", [qkv, g.init("qkv_b", _f32(sd, f"{base}.self_attn.in_proj_bias"))]
        )
        q, k, v = g.add("Split", [qkv], n_out=3, axis=2)

        def heads(t: str) -> str:
            t = g.add(
                "Reshape",
                [t, g.init("h_shape", np.array([0, 0, n_heads, dh], np.int64))],
            )
            return g.add("Transpose", [t], perm=[0, 2, 1, 3])  # [b, h, box, dh]

        qh, vh = heads(q), heads(v)
        kt = g.add("Transpose", [heads(k)], perm=[0, 1, 3, 2])  # [b, h, dh, box]
        scores = g.add("MatMul", [qh, kt])
        scores = g.add(
            "Div", [scores, g.init("scale", np.float32(math.sqrt(dh)))]
        )
        attn = g.add("Softmax", [scores], axis=3)
        ctx = g.add("MatMul", [attn, vh])
        ctx = g.add("Transpose", [ctx], perm=[0, 2, 1, 3])
        ctx = g.add(
            "Reshape", [ctx, g.init("m_shape", np.array([0, 0, -1], np.int64))]
        )
        ctx = _emit_linear(g, sd, f"{base}.self_attn.out_proj", ctx)
        x = _emit_layer_norm(g, sd, f"{base}.norm1", g.add("Add", [x, ctx]))

        ff = g.add("Relu", [_emit_linear(g, sd, f"{base}.linear1", x)])
        ff = _emit_linear(g, sd, f"{base}.linear2", ff)
        x = _emit_layer_norm(g, sd, f"{base}.norm2", g.add("Add", [x, ff]))

    x = _emit_linear(g, sd, "classify", x)
    if return_probs:
        g.add("Sigmoid", [x], out="preds")
    else:
        g.add("Identity", [x], out="preds")
    return g.build(
        inputs=[("word_boxes", ["batch", "box", 4])],
        outputs=[("preds", ["batch", "box", 2])],
    )
