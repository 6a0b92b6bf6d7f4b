"""Reference numpy evaluator for emitted ONNX graphs.

The port's copy of ``ocrs_models_tpu/export/onnx_eval.py``. Executes the
op subset produced by :mod:`.onnx_graph` on the host so the tests and the
GPU smoke can verify emitted files end-to-end: serialize -> parse
(:mod:`.onnx_proto`) -> evaluate -> compare against the port's forward
pass. This is a correctness oracle, not a fast runtime — inference deployment consumes the
.onnx file with the downstream engine (reference docs/training.md:138-154).
"""

from __future__ import annotations

import numpy as np

from .onnx_proto import Graph, Model, Node


def _conv(x, w, b, pads, strides, group):
    n, c, h, wd = x.shape
    o, cg, kh, kw = w.shape
    ph0, pw0, ph1, pw1 = pads
    sh, sw = strides
    xp = np.pad(x, ((0, 0), (0, 0), (ph0, ph1), (pw0, pw1)))
    ho = (h + ph0 + ph1 - kh) // sh + 1
    wo = (wd + pw0 + pw1 - kw) // sw + 1
    wg = w.reshape(group, o // group, cg, kh, kw)
    out = np.zeros((n, group, o // group, ho, wo), np.float32)
    for ki in range(kh):
        for kj in range(kw):
            xs = xp[:, :, ki : ki + ho * sh : sh, kj : kj + wo * sw : sw]
            xs = xs.reshape(n, group, cg, ho, wo)
            out += np.einsum("ngchw,goc->ngohw", xs, wg[:, :, :, ki, kj])
    out = out.reshape(n, o, ho, wo)
    if b is not None:
        out += b[None, :, None, None]
    return out.astype(np.float32)


def _conv_transpose(x, w, b, strides):
    # w: [in, out, kh, kw]; pads 0 -> out = (n-1)*s + k
    n, c, h, wd = x.shape
    _, o, kh, kw = w.shape
    sh, sw = strides
    ho, wo = (h - 1) * sh + kh, (wd - 1) * sw + kw
    out = np.zeros((n, o, ho, wo), np.float32)
    for ki in range(kh):
        for kj in range(kw):
            contrib = np.einsum("nchw,co->nohw", x, w[:, :, ki, kj])
            out[:, :, ki : ki + h * sh : sh, kj : kj + wd * sw : sw] += contrib
    if b is not None:
        out += b[None, :, None, None]
    return out.astype(np.float32)


def _pool(x, kernel, strides, op):
    n, c, h, w = x.shape
    kh, kw = kernel
    sh, sw = strides
    ho = (h - kh) // sh + 1
    wo = (w - kw) // sw + 1
    stack = [
        x[:, :, ki : ki + ho * sh : sh, kj : kj + wo * sw : sw]
        for ki in range(kh)
        for kj in range(kw)
    ]
    stacked = np.stack(stack)
    return (stacked.max(0) if op == "max" else stacked.mean(0)).astype(np.float32)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _gru_direction(x, w, r, b, h0, reverse):
    """One GRU direction with ONNX z,r,h gates and linear_before_reset=1
    (torch semantics)."""
    t_steps, n, _ = x.shape
    hidden = r.shape[1]
    wb, rb = b[: 3 * hidden], b[3 * hidden :]
    h = h0
    ys = []
    steps = range(t_steps - 1, -1, -1) if reverse else range(t_steps)
    gates_x = x @ w.T + wb  # hoisted input projection [T, N, 3H]
    for t in steps:
        gx = gates_x[t]
        gh = h @ r.T + rb
        z = _sigmoid(gx[:, :hidden] + gh[:, :hidden])
        rr = _sigmoid(gx[:, hidden : 2 * hidden] + gh[:, hidden : 2 * hidden])
        hh = np.tanh(gx[:, 2 * hidden :] + rr * gh[:, 2 * hidden :])
        h = (1 - z) * hh + z * h
        ys.append(h)
    if reverse:
        ys.reverse()
    return np.stack(ys)  # [T, N, H]


def _gru(x, w, r, b, direction):
    t_steps, n, _ = x.shape
    hidden = r.shape[2]
    h0 = np.zeros((n, hidden), np.float32)
    outs = [_gru_direction(x, w[0], r[0], b[0], h0, reverse=False)]
    if direction == "bidirectional":
        outs.append(_gru_direction(x, w[1], r[1], b[1], h0, reverse=True))
    return np.stack(outs, axis=1).astype(np.float32)  # [T, D, N, H]


def _softmax(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def run_graph(model: Model, feeds: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    g: Graph = model.graph
    env: dict[str, np.ndarray] = dict(g.initializers)
    env.update({k: np.asarray(v) for k, v in feeds.items()})

    def inp(node: Node, i: int):
        return env[node.inputs[i]] if i < len(node.inputs) else None

    for node in g.nodes:
        a = node.attrs
        op = node.op_type
        if op == "Conv":
            y = _conv(
                inp(node, 0),
                inp(node, 1),
                inp(node, 2),
                a.get("pads", [0, 0, 0, 0]),
                a.get("strides", [1, 1]),
                a.get("group", 1),
            )
        elif op == "ConvTranspose":
            y = _conv_transpose(
                inp(node, 0), inp(node, 1), inp(node, 2), a.get("strides", [1, 1])
            )
        elif op == "BatchNormalization":
            x, scale, bias, mean, var = (inp(node, i) for i in range(5))
            shape = (1, -1, 1, 1)
            y = (x - mean.reshape(shape)) / np.sqrt(
                var.reshape(shape) + a.get("epsilon", 1e-5)
            ) * scale.reshape(shape) + bias.reshape(shape)
            y = y.astype(np.float32)
        elif op == "MaxPool":
            y = _pool(inp(node, 0), a["kernel_shape"], a["strides"], "max")
        elif op == "AveragePool":
            y = _pool(inp(node, 0), a["kernel_shape"], a["strides"], "avg")
        elif op == "Relu":
            y = np.maximum(inp(node, 0), 0)
        elif op == "Sigmoid":
            y = _sigmoid(inp(node, 0)).astype(np.float32)
        elif op == "Concat":
            y = np.concatenate([env[i] for i in node.inputs], axis=a["axis"])
        elif op == "Slice":
            x = inp(node, 0)
            starts, ends, axes = inp(node, 1), inp(node, 2), inp(node, 3)
            idx = [slice(None)] * x.ndim
            for s, e, ax in zip(starts, ends, axes):
                idx[ax] = slice(int(s), int(e))
            y = x[tuple(idx)]
        elif op == "Transpose":
            y = np.transpose(inp(node, 0), a["perm"])
        elif op == "Reshape":
            x, shape = inp(node, 0), [int(v) for v in inp(node, 1)]
            shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
            y = x.reshape(shape)
        elif op == "Squeeze":
            y = np.squeeze(inp(node, 0), axis=tuple(int(v) for v in inp(node, 1)))
        elif op == "Unsqueeze":
            y = np.expand_dims(inp(node, 0), tuple(int(v) for v in inp(node, 1)))
        elif op == "MatMul":
            y = (inp(node, 0) @ inp(node, 1)).astype(np.float32)
        elif op == "Add":
            y = inp(node, 0) + inp(node, 1)
        elif op == "Sub":
            y = inp(node, 0) - inp(node, 1)
        elif op == "Mul":
            y = inp(node, 0) * inp(node, 1)
        elif op == "Div":
            y = inp(node, 0) / inp(node, 1)
        elif op == "Sqrt":
            y = np.sqrt(inp(node, 0))
        elif op == "ReduceMean":
            y = inp(node, 0).mean(axis=tuple(a["axes"]), keepdims=bool(a["keepdims"]))
        elif op == "Softmax":
            y = _softmax(inp(node, 0), a["axis"]).astype(np.float32)
        elif op == "LogSoftmax":
            x = inp(node, 0)
            ax = a["axis"]
            shifted = x - x.max(axis=ax, keepdims=True)
            y = shifted - np.log(np.exp(shifted).sum(axis=ax, keepdims=True))
            y = y.astype(np.float32)
        elif op == "Split":
            y_parts = np.split(inp(node, 0), len(node.outputs), axis=a["axis"])
            for name, part in zip(node.outputs, y_parts):
                env[name] = part
            continue
        elif op == "GRU":
            y = _gru(
                inp(node, 0),
                inp(node, 1),
                inp(node, 2),
                inp(node, 3),
                node.attrs.get("direction", "forward"),
            )
            assert node.attrs.get("linear_before_reset", 0) == 1
        elif op == "Sin":
            y = np.sin(inp(node, 0)).astype(np.float32)
        elif op == "Cos":
            y = np.cos(inp(node, 0)).astype(np.float32)
        elif op == "Round":
            y = np.round(inp(node, 0)).astype(np.float32)
        elif op == "Identity":
            y = inp(node, 0)
        else:
            raise NotImplementedError(f"op {op}")
        env[node.outputs[0]] = y

    return {name: env[name] for name, _ in g.outputs}
