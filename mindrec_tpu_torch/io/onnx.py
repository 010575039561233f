"""ONNX export of the model zoo's serving forwards.

Port of ``mindrec_tpu/io/onnx.py``: a standard ONNX ``ModelProto``
(opset 11, IR version 7, float32 serving precision) of ``predict`` for
Wide&Deep, DeepFM, DCN and the multitable Wide&Deep, written by encoding
the protobuf wire format directly (no ``onnx`` dependency).  The same
parameters give the same bytes as the reference's export.

Tables enter the graph in their logical layout cut to ``vocab_size``
(``from_storage``, float32), whatever their storage layout.  Messages
are assembled by joining lists of parts, so a graph whose tables hold
hundreds of MB is written in one pass (no repeated concatenation).

``serving/onnx_ref.py`` decodes and runs the files, on the card or the
CPU.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from mindrec_tpu_torch.io.export import to_numpy
from mindrec_tpu_torch.ops.embedding import from_storage

# --------------------------------------------------------------------------
# protobuf wire-format primitives
# --------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def f_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(int(value))


def f_bytes(field: int, data: bytes) -> bytes:
    return b"".join((_tag(field, 2), _varint(len(data)), data))


def f_str(field: int, s: str) -> bytes:
    return f_bytes(field, s.encode())


def f_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


# --------------------------------------------------------------------------
# ONNX proto encoders (field numbers of onnx/onnx.proto)
# --------------------------------------------------------------------------

FLOAT, INT32, INT64 = 1, 6, 7  # TensorProto.DataType

_NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
}


def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    parts = [f_varint(1, d) for d in arr.shape]  # dims
    parts.append(f_varint(2, _NP_TO_ONNX[arr.dtype]))  # data_type
    parts.append(f_str(8, name))  # name
    parts.append(f_bytes(9, arr.tobytes()))  # raw_data
    return b"".join(parts)


def _attr(name: str, *, i=None, f=None, ints=None, t=None) -> bytes:
    # AttributeProto: name=1, f=2, i=3, t=5, ints=8, type=20
    out = f_str(1, name)
    if f is not None:
        out += f_float(2, f) + f_varint(20, 1)  # FLOAT
    elif i is not None:
        out += f_varint(3, i) + f_varint(20, 2)  # INT
    elif ints is not None:
        for v in ints:
            out += f_varint(8, v)
        out += f_varint(20, 7)  # INTS
    elif t is not None:
        out += f_bytes(5, t) + f_varint(20, 4)  # TENSOR
    return out


def node(op: str, inputs, outputs, name: str = "", **attrs) -> bytes:
    # NodeProto: input=1, output=2, name=3, op_type=4, attribute=5
    parts = [f_str(1, x) for x in inputs]
    parts += [f_str(2, x) for x in outputs]
    parts.append(f_str(3, name or outputs[0]))
    parts.append(f_str(4, op))
    for k, v in attrs.items():
        if isinstance(v, (list, tuple)):
            parts.append(f_bytes(5, _attr(k, ints=v)))
        elif isinstance(v, float):
            parts.append(f_bytes(5, _attr(k, f=v)))
        elif isinstance(v, bytes):
            parts.append(f_bytes(5, _attr(k, t=v)))
        else:
            parts.append(f_bytes(5, _attr(k, i=v)))
    return b"".join(parts)


def value_info(name: str, elem_type: int, shape) -> bytes:
    # dims: int -> dim_value, str -> dim_param (symbolic batch)
    dims = b"".join(
        f_bytes(1, f_str(2, d) if isinstance(d, str) else f_varint(1, d))
        for d in shape)
    tensor_type = f_varint(1, elem_type) + f_bytes(2, dims)
    return f_str(1, name) + f_bytes(2, f_bytes(1, tensor_type))


class GraphBuilder:
    """A small ONNX graph builder over the raw encoders."""

    def __init__(self, name: str):
        self.name = name
        self.nodes: list[bytes] = []
        self.inits: list[bytes] = []
        self.inputs: list[bytes] = []
        self.outputs: list[bytes] = []
        self._n = 0

    def init(self, name: str, arr) -> str:
        self.inits.append(tensor_proto(name, to_numpy(arr)))
        return name

    def input(self, name: str, elem_type: int, shape) -> str:
        self.inputs.append(value_info(name, elem_type, shape))
        return name

    def output(self, name: str, elem_type: int, shape):
        self.outputs.append(value_info(name, elem_type, shape))

    def op(self, op: str, inputs, n_out: int = 1, **attrs):
        self._n += 1
        outs = [f"{op.lower()}_{self._n}" + ("" if n_out == 1 else f"_{k}")
                for k in range(n_out)]
        self.nodes.append(node(op, inputs, outs, **attrs))
        return outs[0] if n_out == 1 else outs

    def const(self, arr: np.ndarray) -> str:
        self._n += 1
        return self.init(f"const_{self._n}", arr)

    def graph(self) -> bytes:
        # GraphProto: node=1, name=2, initializer=5, input=11, output=12
        parts = [f_bytes(1, n) for n in self.nodes]
        parts.append(f_str(2, self.name))
        parts += [f_bytes(5, t) for t in self.inits]
        parts += [f_bytes(11, v) for v in self.inputs]
        parts += [f_bytes(12, v) for v in self.outputs]
        return b"".join(parts)

    def model(self, opset: int = 11) -> bytes:
        # ModelProto: ir_version=1, producer_name=2, graph=7, opset_import=8
        opset_id = f_str(1, "") + f_varint(2, opset)
        return b"".join((
            f_varint(1, 7),  # IR version 7 (onnx 1.7, the opset-11 era)
            f_str(2, "mindrec_tpu"),  # the reference's producer name
            f_bytes(7, self.graph()),
            f_bytes(8, opset_id),
        ))


# --------------------------------------------------------------------------
# model graphs
# --------------------------------------------------------------------------


def _f32(x) -> np.ndarray:
    return np.asarray(to_numpy(x), np.float32)


def _logical_tables(model, params) -> dict:
    """{table name: logical ``[vocab_size, emb_dim]`` float32 numpy}."""
    out = {}
    for name, (path, spec) in model.table_specs.items():
        node = params
        for h in path:
            node = node[h]
        out[name] = _f32(from_storage(spec, node)[: spec.vocab_size])
    return out


def _mlp_onnx(g: GraphBuilder, x: str, mlp_params, act: str = "Relu",
              act_last: bool = False) -> str:
    n = len(mlp_params)
    for i, layer in enumerate(mlp_params):
        w = g.init(f"mlp_w_{i}", _f32(layer["w"]))
        b = g.init(f"mlp_b_{i}", _f32(layer["b"]))
        x = g.op("Add", [g.op("MatMul", [x, w]), b])
        if i < n - 1 or act_last:
            x = g.op(act, [x])
    return x


def _masked_rows(g: GraphBuilder, table_name: str, table: np.ndarray,
                 ids: str, wts3: str) -> str:
    """Gather(table, ids) * wts[:, :, None] -> [B, F, D]."""
    t = g.init(table_name, table)
    rows = g.op("Gather", [t, ids], axis=0)
    return g.op("Mul", [rows, wts3])


def _flat(g: GraphBuilder, x: str, width: int) -> str:
    return g.op("Reshape", [x, g.const(np.array([-1, width], np.int64))])


def _build_wide_deep(g: GraphBuilder, model, params, ids, wts3, F):
    c = model.config
    tables = _logical_tables(model, params)
    wm = _masked_rows(g, "wide_table", tables["wide"], ids, wts3)
    wide_sum = g.op("ReduceSum", [wm], axes=[1, 2], keepdims=1)  # [B,1,1]
    wide_sum = _flat(g, wide_sum, 1)
    bias = g.init("wide_bias", _f32(params["wide"]["bias"]))
    wide_out = g.op("Add", [wide_sum, bias])
    dm = _masked_rows(g, "deep_table", tables["deep"], ids, wts3)
    deep_out = _mlp_onnx(g, _flat(g, dm, F * c.emb_dim), params["deep"]["mlp"])
    return g.op("Add", [wide_out, deep_out])


def _build_deepfm(g: GraphBuilder, model, params, ids, wts3, F):
    c = model.config
    tables = _logical_tables(model, params)
    lm = _masked_rows(g, "linear_table", tables["linear"], ids, wts3)
    linear = g.op("ReduceSum", [lm], axes=[1, 2], keepdims=1)
    linear = _flat(g, linear, 1)
    vx = _masked_rows(g, "fm_table", tables["fm"], ids, wts3)  # [B,F,D]
    field_sum = g.op("ReduceSum", [vx], axes=[1], keepdims=0)  # [B,D]
    v1 = g.op("ReduceSum", [g.op("Mul", [field_sum, field_sum])],
              axes=[1], keepdims=1)  # [B,1]
    v2 = g.op("ReduceSum", [g.op("Mul", [vx, vx])], axes=[1, 2], keepdims=1)
    v2 = _flat(g, v2, 1)
    half = g.const(np.asarray(0.5, np.float32))
    fm = g.op("Mul", [g.op("Sub", [v1, v2]), half])
    deep_out = _mlp_onnx(g, _flat(g, vx, F * c.emb_dim), params["mlp"])
    return g.op("Add", [g.op("Add", [linear, fm]), deep_out])


def _build_dcn(g: GraphBuilder, model, params, ids, wts3, F):
    c = model.config
    tables = _logical_tables(model, params)
    vx = _masked_rows(g, "emb_table", tables["emb"], ids, wts3)
    d = F * c.emb_dim
    x0 = _flat(g, vx, d)
    # cross net: x_{l+1} = x0 * (x_l @ w_l) + b_l + x_l
    x = x0
    for i, layer in enumerate(params["cross"]):
        w = g.init(f"cross_w_{i}", _f32(layer["w"]).reshape(d, 1))
        b = g.init(f"cross_b_{i}", _f32(layer["b"]))
        xlw = g.op("MatMul", [x, w])  # [B,1]
        x = g.op("Add", [g.op("Add", [g.op("Mul", [x0, xlw]), b]), x])
    deep_out = _mlp_onnx(g, x0, params["mlp"], act_last=True)
    h = g.op("Concat", [deep_out, x], axis=1)
    fw = g.init("final_w", _f32(params["final"]["w"]))
    fb = g.init("final_b", _f32(params["final"]["b"]))
    return g.op("Add", [g.op("MatMul", [h, fw]), fb])


def _build_multitable(g: GraphBuilder, model, params):
    """The Outbrain multitable W&D predict, its own input signature:
    ``continue_val``, 3 single-hot id tensors and 6 multi-hot id/mask
    pairs."""
    from mindrec_tpu_torch.models.multitable import MULTI_FIELDS

    c = model.config
    tables = _logical_tables(model, params)
    cont = g.input("continue_val", FLOAT, ["B", c.continue_field_size])
    ind = g.input("indicator_id", INT32, ["B", c.indicator_field_size])
    e128_id = g.input("emb_128_id", INT32, ["B", c.emb128_field_size])
    e64_id = g.input("emb_64_single_id", INT32,
                     ["B", c.emb64_single_field_size])
    multi = []
    for name, L in zip(MULTI_FIELDS, c.multi_hot_sizes):
        ids = g.input(f"multi_{name}_id", INT32, ["B", L])
        mask = g.input(f"multi_{name}_mask", FLOAT, ["B", L])
        multi.append((ids, mask))

    def emb(table_key, ids, fields, dim):
        t = g.init(table_key, tables[table_key])
        rows = g.op("Gather", [t, ids], axis=0)  # [B, F, dim]
        return _flat(g, rows, fields * dim)

    # deep tower
    parts = [cont,
             emb("emb64_indicator", ind, c.indicator_field_size, 64),
             emb("emb128", e128_id, c.emb128_field_size, 128),
             emb("emb64_single", e64_id, c.emb64_single_field_size, 64)]
    mt = g.init("emb64_multi", tables["emb64_multi"])
    for ids, mask in multi:
        rows = g.op("Gather", [mt, ids], axis=0)  # [B, L, 64]
        masked = g.op("Mul", [rows, g.op("Unsqueeze", [mask], axes=[2])])
        # the reference's mean over the FULL hot dim (divide by L)
        parts.append(g.op("ReduceMean", [masked], axes=[1], keepdims=0))
    deep_in = g.op("Concat", parts, axis=1)
    deep_out = _mlp_onnx(g, deep_in, params["deep"]["mlp"])

    # wide tower
    w = params["wide"]
    cw = g.init("continue_w", _f32(w["continue_w"]))
    val_w = g.op("ReduceSum", [g.op("Mul", [cont, cw])], axes=[1],
                 keepdims=1)

    def wide_sum(table_key, ids):
        t = g.init(f"w_{table_key}", tables[table_key])
        rows = g.op("Gather", [t, ids], axis=0)  # [B, F, 1]
        s = g.op("ReduceSum", [rows], axes=[1, 2], keepdims=1)
        return _flat(g, s, 1)

    acc = g.op("Add", [val_w, wide_sum("w_indicator", ind)])
    acc = g.op("Add", [acc, wide_sum("w128", e128_id)])
    acc = g.op("Add", [acc, wide_sum("w64_single", e64_id)])
    wmt = g.init("w_emb64_multi", tables["w64_multi"])
    for ids, mask in multi:
        ws = g.op("Gather", [wmt, ids], axis=0)  # [B, L, 1]
        wsm = g.op("Mul", [ws, g.op("Unsqueeze", [mask], axes=[2])])
        s = g.op("ReduceSum", [wsm], axes=[1, 2], keepdims=1)
        acc = g.op("Add", [acc, _flat(g, s, 1)])
    bias = g.init("wide_bias", _f32(w["bias"]))
    wide_out = g.op("Add", [acc, bias])
    return g.op("Add", [wide_out, deep_out])


_BUILDERS = {
    "wide_deep": _build_wide_deep,
    "deepfm": _build_deepfm,
    "dcn": _build_dcn,
}


def export_onnx(path: str | Path, model_kind: str, model, params) -> str:
    """Write ``<path>``, an ONNX model computing ``predict`` (the sigmoid
    of the logit).  Criteo models take ``ids [B,F] int32`` and ``wts
    [B,F] f32``; the multitable model takes its 21-column input
    signature.  The batch dimension is symbolic."""
    g = GraphBuilder(f"mindrec_{model_kind}")
    if model_kind == "multitable":
        logits = _build_multitable(g, model, params)
    elif model_kind in _BUILDERS:
        F = int(model.config.field_size)
        ids = g.input("ids", INT32, ["B", F])
        wts = g.input("wts", FLOAT, ["B", F])
        wts3 = g.op("Unsqueeze", [wts], axes=[2])
        logits = _BUILDERS[model_kind](g, model, params, ids, wts3, F)
    else:
        raise ValueError(
            "onnx export supports "
            f"{sorted(_BUILDERS) + ['multitable']}, got {model_kind!r}")
    g.nodes.append(node("Sigmoid", [logits], ["prob"]))
    g.output("prob", FLOAT, ["B", 1])
    path = Path(path)
    path.write_bytes(g.model())
    return str(path)
