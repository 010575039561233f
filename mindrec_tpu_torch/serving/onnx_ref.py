"""ONNX decoder and runner, on the card or the CPU.

Port of ``mindrec_tpu/serving/onnx_ref.py``: decodes a standard ONNX
``ModelProto`` (the raw protobuf wire format, no ``onnx`` dependency)
and executes the op subset of the zoo's exported serving graphs
(``io/onnx.py``), here with torch on an explicit device.
:class:`OnnxModel` decodes once and keeps the initializers on the
device; :func:`run_onnx` is the one-call form.  Decoding slices a
``memoryview``, so a graph with hundreds of MB of tables is not copied
field by field.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

# --------------------------------------------------------------------------
# protobuf wire-format decoding
# --------------------------------------------------------------------------


def _read_varint(data, off: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = data[off]
        off += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, off
        shift += 7


def parse_message(data) -> dict[int, list]:
    """-> {field_number: [raw values]} (varints as int, length-delimited
    fields as memoryview slices, fixed32/64 as bytes)."""
    data = memoryview(data)
    fields: dict[int, list] = {}
    off = 0
    n = len(data)
    while off < n:
        key, off = _read_varint(data, off)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, off = _read_varint(data, off)
        elif wire == 2:
            ln, off = _read_varint(data, off)
            v = data[off: off + ln]
            off += ln
        elif wire == 5:
            v = bytes(data[off: off + 4])
            off += 4
        elif wire == 1:
            v = bytes(data[off: off + 8])
            off += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append(v)
    return fields


def _str(v) -> str:
    return bytes(v).decode()


_ONNX_NP = {1: np.float32, 6: np.int32, 7: np.int64, 9: np.bool_,
            11: np.float64}


def _decode_tensor(data) -> tuple[str, np.ndarray]:
    f = parse_message(data)
    dims = [int(d) for d in f.get(1, [])]
    dtype = _ONNX_NP[int(f[2][0])]
    name = _str(f.get(8, [b""])[0])
    if 9 in f:  # raw_data
        arr = np.frombuffer(f[9][0], dtype=dtype)
    elif 4 in f:  # float_data (packed or repeated)
        arr = np.asarray(
            [struct.unpack("<f", v)[0] if isinstance(v, bytes) else v
             for v in f[4]], np.float32)
    elif 7 in f:  # int64_data
        arr = np.asarray([int(v) for v in f[7]], np.int64)
    else:
        arr = np.zeros(0, dtype)
    return name, arr.reshape(dims)


def _decode_attr(data) -> tuple[str, object]:
    f = parse_message(data)
    name = _str(f[1][0])
    atype = int(f.get(20, [0])[0])
    if atype == 1:  # FLOAT
        return name, struct.unpack("<f", f[2][0])[0]
    if atype == 2:  # INT
        return name, int(f[3][0])
    if atype == 7:  # INTS
        return name, [int(v) for v in f.get(8, [])]
    if atype == 4:  # TENSOR
        return name, _decode_tensor(f[5][0])[1]
    if atype == 3:  # STRING
        return name, _str(f[4][0])
    raise ValueError(f"unsupported attribute type {atype}")


def _decode_node(data) -> dict:
    f = parse_message(data)
    return {
        "inputs": [_str(v) for v in f.get(1, [])],
        "outputs": [_str(v) for v in f.get(2, [])],
        "op": _str(f[4][0]),
        "attrs": dict(_decode_attr(a) for a in f.get(5, [])),
    }


def load_onnx(data: bytes) -> dict:
    """ModelProto bytes -> {name, nodes, initializers (numpy), inputs,
    outputs (names), opset}."""
    model = parse_message(data)
    graph = parse_message(model[7][0])

    def vi_name(v):
        return _str(parse_message(v)[1][0])

    return {
        "name": _str(graph.get(2, [b""])[0]),
        "nodes": [_decode_node(n) for n in graph.get(1, [])],
        "initializers": dict(_decode_tensor(t) for t in graph.get(5, [])),
        "inputs": [vi_name(v) for v in graph.get(11, [])],
        "outputs": [vi_name(v) for v in graph.get(12, [])],
        "opset": int(parse_message(model[8][0])[2][0]) if 8 in model else 0,
    }


# --------------------------------------------------------------------------
# execution with torch
# --------------------------------------------------------------------------


def _run_node(op: str, ins: list, attrs: dict):
    if op == "Add":
        return ins[0] + ins[1]
    if op == "Sub":
        return ins[0] - ins[1]
    if op == "Mul":
        return ins[0] * ins[1]
    if op == "MatMul":
        return ins[0] @ ins[1]
    if op == "Gather":
        return torch.index_select(
            ins[0], attrs.get("axis", 0), ins[1].reshape(-1).long()
        ).reshape(*ins[1].shape, *ins[0].shape[1:])
    if op == "Unsqueeze":
        out = ins[0]
        for ax in sorted(attrs["axes"]):
            out = out.unsqueeze(ax)
        return out
    if op == "ReduceSum":
        return torch.sum(ins[0], dim=tuple(attrs["axes"]),
                         keepdim=bool(attrs.get("keepdims", 1)))
    if op == "ReduceMean":
        return torch.mean(ins[0], dim=tuple(attrs["axes"]),
                          keepdim=bool(attrs.get("keepdims", 1)))
    if op == "Reshape":
        return ins[0].reshape([int(d) for d in ins[1].tolist()])
    if op == "Relu":
        return torch.clamp_min(ins[0], 0.0)
    if op == "Sigmoid":
        return 1.0 / (1.0 + torch.exp(-ins[0]))
    if op == "Tanh":
        return torch.tanh(ins[0])
    if op == "Concat":
        return torch.cat(ins, dim=attrs.get("axis", 0))
    raise NotImplementedError(f"onnx_ref: op {op}")


class OnnxModel:
    """A decoded ONNX model whose initializers live on ``device``; call it
    with ``{input name: array or tensor}`` for ``{output name: tensor}``.
    int64 initializers (shape operands) stay on the host, so a Reshape
    reads no device memory."""

    def __init__(self, data: bytes, device="cuda"):
        m = load_onnx(data)
        self.device = torch.device(device)
        self.nodes = m["nodes"]
        self.inputs, self.outputs = m["inputs"], m["outputs"]
        self.initializers = {
            k: torch.from_numpy(v.copy()) if v.dtype == np.int64
            else torch.from_numpy(v.copy()).to(self.device)
            for k, v in m["initializers"].items()}

    @torch.no_grad()
    def __call__(self, feeds: dict) -> dict[str, torch.Tensor]:
        env = dict(self.initializers)
        for name in self.inputs:
            x = feeds[name]
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.ascontiguousarray(x))
            env[name] = x.to(self.device)
        for n in self.nodes:
            env[n["outputs"][0]] = _run_node(
                n["op"], [env[x] for x in n["inputs"]], n["attrs"])
        return {name: env[name] for name in self.outputs}


def run_onnx(data: bytes, feeds: dict, device="cuda") -> dict[str, torch.Tensor]:
    """Execute an ONNX model on named inputs on ``device``; returns named
    output tensors there."""
    return OnnxModel(data, device)(feeds)
