"""Serving export: the MREC1 binary and its ``.npz`` sidecar.

Port of ``mindrec_tpu/io/export.py``, the same format, which the C++
client (``serving/infer_client.cc``) reads and runs::

  magic "MREC1" | u32 model_kind | u32 n_tensors |
  per tensor: u32 name_len, name bytes, u32 dtype(0=f32,1=i32),
              u32 ndim, u64 dims[ndim], raw data

Model kinds: 0=wide_deep, 1=deepfm, 2=dcn, 3=multitable (no client).

Embedding tables are written as :func:`~mindrec_tpu_torch.ops.embedding.from_storage`
returns them, ``[padded_vocab, emb_dim]``, whatever the storage layout
(row_packed, feature-major or plain), because the client takes a table's
second dimension as its width.  The reference writes the storage layout
as it is, so a row_packed table reaches its client 128 wide
(``ROADMAP.md`` section 3).  For a plain table ``from_storage`` is the
identity, so a dense-table model's file is byte-identical to the
reference's.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

from mindrec_tpu_torch.ops.embedding import from_storage
from mindrec_tpu_torch.train.step import flatten_params

MAGIC = b"MREC1"
MODEL_KINDS = {"wide_deep": 0, "deepfm": 1, "dcn": 2, "multitable": 3}


def to_numpy(x) -> np.ndarray:
    """A tensor on any device (or an array) as numpy; bfloat16 widens to
    float32 (exact)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def logical_params(model, params) -> dict:
    """``params`` with every embedding table of ``model.table_specs`` in
    its logical ``[padded_vocab, emb_dim]`` layout (other leaves as they
    are)."""
    tables = {tuple(path): spec for path, spec in model.table_specs.values()}

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x, path + (i,)) for i, x in enumerate(node))
        spec = tables.get(path)
        return node if spec is None else from_storage(spec, node)

    return walk(params, ())


def _flat_named(params) -> list[tuple[str, np.ndarray]]:
    return [(k, to_numpy(leaf)) for k, leaf in flatten_params(params)]


def export_model(path: str | Path, model_kind: str, params, model) -> str:
    """Write the MREC1 binary and ``<path>.npz``.  ``model`` gives the
    tables' storage specs.  Returns the binary's path."""
    path = Path(path)
    tensors = _flat_named(logical_params(model, params))
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<II", MODEL_KINDS[model_kind], len(tensors)))
        for name, arr in tensors:
            arr = np.ascontiguousarray(arr)
            if arr.dtype == np.float32:
                dt = 0
            elif arr.dtype == np.int32:
                dt = 1
            else:
                arr = arr.astype(np.float32)
                dt = 0
            nb = name.encode()
            f.write(struct.pack("<I", len(nb)))
            f.write(nb)
            f.write(struct.pack("<II", dt, arr.ndim))
            for d in arr.shape:
                f.write(struct.pack("<Q", d))
            f.write(arr.tobytes())
    np.savez(str(path) + ".npz", **dict(tensors))
    return str(path)


def load_model(path: str | Path) -> tuple[str, dict[str, np.ndarray]]:
    """Read an MREC1 binary back into ``(kind, {name: array})``."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:5] != MAGIC:
        raise ValueError("not an MREC1 file")
    off = 5
    kind, n = struct.unpack_from("<II", data, off)
    off += 8
    tensors = {}
    for _ in range(n):
        (nlen,) = struct.unpack_from("<I", data, off)
        off += 4
        name = data[off: off + nlen].decode()
        off += nlen
        dt, ndim = struct.unpack_from("<II", data, off)
        off += 8
        dims = struct.unpack_from(f"<{ndim}Q", data, off)
        off += 8 * ndim
        dtype = np.float32 if dt == 0 else np.int32
        count = int(np.prod(dims)) if ndim else 1
        arr = np.frombuffer(data, dtype=dtype, count=count,
                            offset=off).reshape(dims)
        off += count * 4
        tensors[name] = arr
    kind_name = {v: k for k, v in MODEL_KINDS.items()}[kind]
    return kind_name, tensors
