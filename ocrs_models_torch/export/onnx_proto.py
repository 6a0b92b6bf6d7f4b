"""Minimal first-party ONNX protobuf writer/reader (no ``onnx`` package).

The port's copy of ``ocrs_models_tpu/export/onnx_proto.py``: the same
bytes for the same messages, apart from ``model_proto``'s default
``producer``. ONNX model files are protobuf messages (onnx.proto). This module implements
just enough of the protobuf wire format to *emit* a valid ``ModelProto``
for the three exported model graphs (reference export sites:
train_detection.py:398-405, train_rec.py:396-409, train_layout.py:255-269)
and to *parse* one back for verification — the tests and the GPU smoke
round-trip every emitted file through :func:`parse_model` and execute it
with :mod:`.onnx_eval` against the port's forward pass.

Only the fields the exporter uses are supported. Field numbers follow
onnx/onnx.proto (IR version 8, opset 16).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

# TensorProto.DataType
FLOAT = 1
INT64 = 7

# AttributeProto.AttributeType
_ATTR_FLOAT = 1
_ATTR_INT = 2
_ATTR_STRING = 3
_ATTR_TENSOR = 4
_ATTR_FLOATS = 6
_ATTR_INTS = 7


# ----------------------------- wire encoding -----------------------------


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # two's-complement for negative int64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field_num: int, wire: int) -> bytes:
    return _varint((field_num << 3) | wire)


def _len_field(field_num: int, payload: bytes) -> bytes:
    return _tag(field_num, 2) + _varint(len(payload)) + payload


def _str_field(field_num: int, s: str) -> bytes:
    return _len_field(field_num, s.encode("utf-8"))


def _int_field(field_num: int, v: int) -> bytes:
    return _tag(field_num, 0) + _varint(v)


def _float_field(field_num: int, v: float) -> bytes:
    return _tag(field_num, 5) + struct.pack("<f", v)


def _packed_ints(field_num: int, vals: Sequence[int]) -> bytes:
    return _len_field(field_num, b"".join(_varint(v) for v in vals))


# ------------------------------- messages --------------------------------


def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    if arr.dtype == np.int64:
        dtype = INT64
    else:
        arr = arr.astype(np.float32)
        dtype = FLOAT
    out = _packed_ints(1, list(arr.shape))  # dims
    out += _int_field(2, dtype)  # data_type
    out += _str_field(8, name)
    out += _len_field(9, arr.tobytes())  # raw_data (little-endian)
    return out


def _attribute(name: str, value: Any) -> bytes:
    out = _str_field(1, name)
    if isinstance(value, bool):
        raise TypeError("use int for ONNX attributes")
    if isinstance(value, int):
        out += _varint((3 << 3) | 0) + _varint(value)  # i
        out += _int_field(20, _ATTR_INT)
    elif isinstance(value, float):
        out += _float_field(2, value)  # f
        out += _int_field(20, _ATTR_FLOAT)
    elif isinstance(value, str):
        out += _str_field(4, value)  # s (bytes)
        out += _int_field(20, _ATTR_STRING)
    elif isinstance(value, np.ndarray):
        out += _len_field(5, tensor_proto("", value))  # t
        out += _int_field(20, _ATTR_TENSOR)
    elif isinstance(value, (list, tuple)) and all(isinstance(v, int) for v in value):
        out += _packed_ints(8, list(value))  # ints
        out += _int_field(20, _ATTR_INTS)
    elif isinstance(value, (list, tuple)):
        out += b"".join(_float_field(7, float(v)) for v in value)  # floats
        out += _int_field(20, _ATTR_FLOATS)
    else:
        raise TypeError(f"unsupported attribute type for {name}: {type(value)}")
    return out


def node_proto(
    op_type: str,
    inputs: Sequence[str],
    outputs: Sequence[str],
    name: str = "",
    **attrs: Any,
) -> bytes:
    out = b"".join(_str_field(1, i) for i in inputs)
    out += b"".join(_str_field(2, o) for o in outputs)
    out += _str_field(3, name or outputs[0])
    out += _str_field(4, op_type)
    out += b"".join(_len_field(5, _attribute(k, v)) for k, v in attrs.items())
    return out


def value_info(name: str, dims: Sequence[int | str], elem_type: int = FLOAT) -> bytes:
    dim_bytes = b""
    for d in dims:
        if isinstance(d, str):
            dim_bytes += _len_field(1, _str_field(2, d))  # dim_param
        else:
            dim_bytes += _len_field(1, _int_field(1, int(d)))  # dim_value
    # dim_bytes already holds the repeated field-1 Dimension entries, i.e.
    # it *is* the TensorShapeProto payload.
    tensor_type = _int_field(1, elem_type) + _len_field(2, dim_bytes)
    type_proto = _len_field(1, tensor_type)
    return _str_field(1, name) + _len_field(2, type_proto)


def graph_proto(
    name: str,
    nodes: Sequence[bytes],
    inputs: Sequence[bytes],
    outputs: Sequence[bytes],
    initializers: Sequence[bytes],
) -> bytes:
    out = b"".join(_len_field(1, n) for n in nodes)
    out += _str_field(2, name)
    out += b"".join(_len_field(5, t) for t in initializers)
    out += b"".join(_len_field(11, i) for i in inputs)
    out += b"".join(_len_field(12, o) for o in outputs)
    return out


def model_proto(graph: bytes, opset: int = 16, producer: str = "ocrs-models-torch") -> bytes:
    out = _int_field(1, 8)  # ir_version 8
    out += _str_field(2, producer)
    out += _str_field(3, "0.2")
    out += _len_field(7, graph)
    out += _len_field(8, _str_field(1, "") + _int_field(2, opset))  # opset_import
    return out


# ------------------------------- parsing ---------------------------------


def _parse_fields(buf: bytes) -> list[tuple[int, int, Any]]:
    """Decode a protobuf message into (field, wire, value) triples."""
    fields = []
    i = 0
    n = len(buf)
    while i < n:
        tag = 0
        shift = 0
        while True:
            b = buf[i]
            i += 1
            tag |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field_num, wire = tag >> 3, tag & 7
        if wire == 0:
            v = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            fields.append((field_num, 0, v))
        elif wire == 2:
            ln = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            fields.append((field_num, 2, buf[i : i + ln]))
            i += ln
        elif wire == 5:
            fields.append((field_num, 5, struct.unpack("<f", buf[i : i + 4])[0]))
            i += 4
        elif wire == 1:
            fields.append((field_num, 1, struct.unpack("<d", buf[i : i + 8])[0]))
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return fields


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _unpack_ints(payload: bytes) -> list[int]:
    vals = []
    i = 0
    while i < len(payload):
        v = 0
        shift = 0
        while True:
            b = payload[i]
            i += 1
            v |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        vals.append(_signed64(v))
    return vals


@dataclass
class Tensor:
    name: str
    array: np.ndarray


@dataclass
class Node:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    name: str = ""
    attrs: dict = field(default_factory=dict)


@dataclass
class Graph:
    name: str
    nodes: list[Node]
    inputs: list[tuple[str, list]]
    outputs: list[tuple[str, list]]
    initializers: dict


@dataclass
class Model:
    ir_version: int
    opset: int
    producer: str
    graph: Graph


def _parse_tensor(buf: bytes) -> Tensor:
    dims: list[int] = []
    dtype = FLOAT
    name = ""
    raw = b""
    for f, w, v in _parse_fields(buf):
        if f == 1:
            dims.extend(_unpack_ints(v) if w == 2 else [_signed64(v)])
        elif f == 2:
            dtype = v
        elif f == 8:
            name = v.decode()
        elif f == 9:
            raw = v
    np_dtype = np.int64 if dtype == INT64 else np.float32
    arr = np.frombuffer(raw, dtype=np_dtype).reshape(dims)
    return Tensor(name, arr)


def _parse_attr(buf: bytes) -> tuple[str, Any]:
    name = ""
    atype = None
    vals: dict[int, Any] = {}
    floats: list[float] = []
    ints: list[int] = []
    for f, w, v in _parse_fields(buf):
        if f == 1:
            name = v.decode()
        elif f == 20:
            atype = v
        elif f == 2:
            vals["f"] = v
        elif f == 3:
            vals["i"] = _signed64(v)
        elif f == 4:
            vals["s"] = v.decode()
        elif f == 5:
            vals["t"] = _parse_tensor(v).array
        elif f == 7:
            floats.append(v)
        elif f == 8:
            ints.extend(_unpack_ints(v) if w == 2 else [_signed64(v)])
    if atype == _ATTR_INT:
        return name, vals["i"]
    if atype == _ATTR_FLOAT:
        return name, vals["f"]
    if atype == _ATTR_STRING:
        return name, vals["s"]
    if atype == _ATTR_TENSOR:
        return name, vals["t"]
    if atype == _ATTR_INTS:
        return name, ints
    if atype == _ATTR_FLOATS:
        return name, floats
    raise ValueError(f"unsupported attribute type {atype} for {name}")


def _parse_node(buf: bytes) -> Node:
    node = Node("", [], [])
    for f, _, v in _parse_fields(buf):
        if f == 1:
            node.inputs.append(v.decode())
        elif f == 2:
            node.outputs.append(v.decode())
        elif f == 3:
            node.name = v.decode()
        elif f == 4:
            node.op_type = v.decode()
        elif f == 5:
            k, val = _parse_attr(v)
            node.attrs[k] = val
    return node


def _parse_value_info(buf: bytes) -> tuple[str, list]:
    name = ""
    dims: list = []
    for f, _, v in _parse_fields(buf):
        if f == 1:
            name = v.decode()
        elif f == 2:
            for f2, _, v2 in _parse_fields(v):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in _parse_fields(v2):
                        if f3 == 2:  # shape
                            for f4, _, v4 in _parse_fields(v3):
                                if f4 == 1:  # dim
                                    entry: Any = None
                                    for f5, _, v5 in _parse_fields(v4):
                                        if f5 == 1:
                                            entry = _signed64(v5)
                                        elif f5 == 2:
                                            entry = v5.decode()
                                    dims.append(entry)
    return name, dims


def _parse_graph(buf: bytes) -> Graph:
    g = Graph("", [], [], [], {})
    for f, _, v in _parse_fields(buf):
        if f == 1:
            g.nodes.append(_parse_node(v))
        elif f == 2:
            g.name = v.decode()
        elif f == 5:
            t = _parse_tensor(v)
            g.initializers[t.name] = t.array
        elif f == 11:
            g.inputs.append(_parse_value_info(v))
        elif f == 12:
            g.outputs.append(_parse_value_info(v))
    return g


def parse_model(buf: bytes) -> Model:
    ir = 0
    opset = 0
    producer = ""
    graph = None
    for f, _, v in _parse_fields(buf):
        if f == 1:
            ir = v
        elif f == 2:
            producer = v.decode()
        elif f == 7:
            graph = _parse_graph(v)
        elif f == 8:
            for f2, _, v2 in _parse_fields(v):
                if f2 == 2:
                    opset = v2
    assert graph is not None, "no graph in model"
    return Model(ir, opset, producer, graph)
