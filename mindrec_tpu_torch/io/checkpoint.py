"""Checkpoint save/restore, interchangeable with the JAX package's files.

Port of ``mindrec_tpu/io/checkpoint.py``, with its file format: one
``.npz`` per (checkpoint, rank) named ``{prefix}-{step:010d}-r{rank}.npz``,
flat path-keyed arrays plus an ``__index__`` JSON entry (global shape
and whether the array was saved sliced), written to a hidden temp file,
fsynced, renamed, then the directory fsynced.  Interval and
``keep_max`` retention, :func:`latest_checkpoint`, :func:`merge_sliced`.

Keys are the reference's: its ``TrainState`` NamedTuple flattens to
``.params/deep/table``, ``.opt_w/wide/table/accum``,
``.opt_d/deep/table/m``, ``.step``, ``.rng`` (a NamedTuple field prints
as ``.name``, dict keys sorted, sequences by index, joined by ``/``),
and so does this port's :class:`~mindrec_tpu_torch.train.step.TrainState`
by :func:`flatten_state`.  Keys are only ever made from a state, never
parsed back (``opt_d``'s own keys hold ``/``).

Dtypes as the reference writes them:

* bfloat16 leaves are stored as their 16-bit patterns in numpy's 2-byte
  void type (``|V2``), which is what ``np.savez`` writes for the
  reference's ``ml_dtypes`` bfloat16 arrays.  On restore a ``|V2``
  entry is read as bfloat16 bits and every entry is cast to the dtype
  of the template leaf.  (The reference's own restore cannot read its
  bf16 files back: ``ROADMAP.md`` section 3.)
* the port's dropout key (``ops/prng.py``: int64 holding two 32-bit
  words) is written under ``.rng`` as ``uint32[2]``, the shape and dtype
  of a JAX key.  Either side reads the other's key as words of its own
  generator; the streams differ.

Restore merges ``@@shard(...)`` entries, so a reference checkpoint saved
sliced across devices restores whole.  Saving sliced (sharded tables)
and restoring onto shardings are not ported (``ROADMAP.md`` section 1
item 9).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
from pathlib import Path

import numpy as np
import torch

RNG_KEY = ".rng"
_BF16_BITS = np.dtype("V2")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: sharded tables need multi-GPU "
        f"(ROADMAP.md section 1 item 9)")


# ---------------------------------------------------------------------------
# flat path-keyed view of a state
# ---------------------------------------------------------------------------


def _join(path: str, key: str) -> str:
    return f"{path}/{key}" if path else key


def flatten_state(node, path: str = "") -> list[tuple[str, object]]:
    """(key, leaf) pairs in the reference's flattening order and with its
    key strings; None and empty containers hold no leaf."""
    out = []
    if hasattr(node, "_fields"):  # NamedTuple: JAX prints ".field"
        for f in node._fields:
            out += flatten_state(getattr(node, f), _join(path, "." + f))
    elif isinstance(node, dict):
        for k in sorted(node):
            out += flatten_state(node[k], _join(path, str(k)))
    elif isinstance(node, (list, tuple)):
        for i, x in enumerate(node):
            out += flatten_state(x, _join(path, str(i)))
    elif node is not None:
        out.append((path, node))
    return out


def _rebuild(node, leaves):
    """``node``'s structure with its leaves taken in turn from the
    iterator ``leaves`` (the order of :func:`flatten_state`)."""
    if hasattr(node, "_fields"):
        return type(node)(*(_rebuild(getattr(node, f), leaves)
                            for f in node._fields))
    if isinstance(node, dict):
        built = {k: _rebuild(node[k], leaves) for k in sorted(node)}
        return {k: built[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(x, leaves) for x in node)
    if node is None:
        return None
    return next(leaves)


# ---------------------------------------------------------------------------
# host snapshot and file write
# ---------------------------------------------------------------------------


def _host_numpy(key: str, t) -> np.ndarray:
    """The file's array for a host copy the writer owns."""
    if not isinstance(t, torch.Tensor):
        return np.array(t)  # a copy
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BITS)
    arr = t.numpy()
    if key == RNG_KEY and arr.dtype == np.int64:
        return arr.astype(np.uint32)
    return arr


def _snapshot(state, force_sliced: bool) -> tuple[dict, dict]:
    """Copy the state to host memory of its own NOW: the captured step
    overwrites every leaf in place, so nothing may still be read from the
    card when this returns.  Card leaves are copied synchronously into
    pageable memory on the current stream (after the step enqueued
    there).  Pinned buffers would copy faster, but the writer thread
    would then free them, and freeing pinned memory queries CUDA events,
    which can invalidate a graph being captured on the training thread;
    this way no CUDA call runs off the training thread."""
    if force_sliced:
        raise _not_ported("saving sliced checkpoints (force_sliced=True)")
    arrays, index = {}, {}
    for key, leaf in flatten_state(state):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().to("cpu", copy=True)
        arrays[key] = _host_numpy(key, leaf)
        index[key] = {"global_shape": list(arrays[key].shape), "sliced": False}
    return arrays, index


def _fsync(path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write(directory: Path, prefix: str, rank: int, step: int, arrays: dict,
           index: dict, keep_max: int | None) -> str:
    """Serialize, fsync, rename, fsync the directory: the final name never
    points at truncated data, after a process or a machine crash."""
    path = directory / f"{prefix}-{step:010d}-r{rank}.npz"
    # the leading "." hides it from latest_checkpoint and retention; the
    # .npz suffix keeps np.savez from appending one
    tmp = directory / f".{prefix}-{step:010d}-r{rank}.tmp.npz"
    np.savez(tmp, __index__=json.dumps(index), **arrays)
    _fsync(tmp)
    os.replace(tmp, path)
    _fsync(directory)
    if keep_max is not None:
        _apply_retention(directory, prefix, rank, keep_max)
    return str(path)


def save_checkpoint(directory: str | os.PathLike, state, step: int,
                    prefix: str = "ckpt", keep_max: int | None = None,
                    process_index: int | None = None,
                    force_sliced: bool = False) -> str:
    """Save a state (a ``TrainState`` or any nest of dicts, lists and
    NamedTuples of tensors).  Returns the written file's path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    arrays, index = _snapshot(state, force_sliced)
    return _write(directory, prefix, process_index or 0, step, arrays, index,
                  keep_max)


class AsyncCheckpointer:
    """:meth:`save` snapshots the state to host memory before it returns
    (the next step may then overwrite the state in place) and writes the
    file on a background thread.  At most one write is in flight: a
    second :meth:`save` first waits for the previous one.  Call
    :meth:`wait_until_finished` before reading the file or exiting."""

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="mrec-ckpt")
        self._pending = None

    @property
    def closed(self) -> bool:
        return self._pool is None

    def save(self, directory: str | os.PathLike, state, step: int,
             prefix: str = "ckpt", keep_max: int | None = None,
             process_index: int | None = None, force_sliced: bool = False):
        """Snapshot now, write in the background.  Returns a future whose
        ``.result()`` is the written path."""
        self.wait_until_finished()
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        arrays, index = _snapshot(state, force_sliced)
        self._pending = self._pool.submit(
            _write, directory, prefix, process_index or 0, step, arrays,
            index, keep_max)
        return self._pending

    def wait_until_finished(self) -> str | None:
        """Block until the write in flight (if any) lands; returns its
        path and re-raises its error."""
        if self._pending is None:
            return None
        pending, self._pending = self._pending, None
        return pending.result()

    def close(self):
        if self._pool is not None:
            try:
                self.wait_until_finished()
            finally:
                self._pool.shutdown(wait=True)
                self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _apply_retention(directory: Path, prefix: str, rank: int, keep_max: int):
    pat = re.compile(rf"^{re.escape(prefix)}-(\d+)-r{rank}\.npz$")
    files = sorted(
        (f for f in directory.iterdir() if pat.match(f.name)),
        key=lambda f: int(pat.match(f.name).group(1)),
    )
    for f in files[:-keep_max] if keep_max > 0 else []:
        f.unlink()


def latest_checkpoint(directory: str | os.PathLike, prefix: str = "ckpt",
                      rank: int = 0):
    """-> (path, step) of the newest checkpoint, or (None, -1)."""
    directory = Path(directory)
    pat = re.compile(rf"^{re.escape(prefix)}-(\d+)-r{rank}\.npz$")
    best, best_step = None, -1
    if not directory.exists():
        return None, -1
    for f in directory.iterdir():
        m = pat.match(f.name)
        if m and int(m.group(1)) > best_step:
            best, best_step = f, int(m.group(1))
    return (str(best), best_step) if best else (None, -1)


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------


def _like(arr: np.ndarray, leaf, key: str):
    """The file's array as a new tensor with ``leaf``'s shape check,
    device and dtype (numpy for a numpy leaf)."""
    if tuple(arr.shape) != tuple(leaf.shape):
        raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} != "
                         f"{tuple(leaf.shape)}")
    bf16_bits = arr.dtype.kind == "V" and arr.dtype.itemsize == 2
    if not isinstance(leaf, torch.Tensor):
        if bf16_bits:
            arr = _bits_to_bf16(arr).float().numpy()
        return np.asarray(arr).astype(np.asarray(leaf).dtype)
    if bf16_bits:
        t = _bits_to_bf16(arr)
    elif leaf.dtype == torch.bfloat16:
        t = torch.from_numpy(np.asarray(arr, np.float32).copy())
    else:
        np_dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
        t = torch.from_numpy(np.array(arr, dtype=np_dtype))
    return t.to(device=leaf.device, dtype=leaf.dtype)


def _bits_to_bf16(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(arr.view(np.int16))).view(torch.bfloat16)


def _parse_index(idx_str: str, global_shape):
    """The slices of a shard index string, e.g.
    ``(slice(0, 512, None), slice(None, None, None))``."""
    slices = []
    for m in re.finditer(r"slice\(([^)]*)\)", idx_str):
        parts = [p.strip() for p in m.group(1).split(",")]
        slices.append(slice(*[None if p == "None" else int(p) for p in parts]))
    if not slices:
        return tuple(slice(None) for _ in global_shape)
    return tuple(slices)


def _merge_shards(zs, key: str, global_shape) -> np.ndarray:
    """One array from its ``{key}@@shard...`` entries in the files
    ``zs`` (replicated shards write the same values twice)."""
    out = None
    for z in zs:
        for name in z.files:
            if not name.startswith(f"{key}@@shard"):
                continue
            data = z[name]
            if out is None:
                out = np.zeros(global_shape, dtype=data.dtype)
            out[_parse_index(name.split("@@shard", 1)[1], global_shape)] = data
    if out is None:
        raise KeyError(f"no shards found for {key}")
    return out


def _restore(zs, like):
    index = json.loads(str(zs[0]["__index__"]))
    leaves = []
    for key, leaf in flatten_state(like):
        info = index.get(key)
        if info is None:
            raise KeyError(f"checkpoint missing key {key}")
        if info["sliced"]:
            arr = _merge_shards(zs, key, tuple(info["global_shape"]))
        else:
            arr = zs[0][key]
        leaves.append(_like(arr, leaf, key))
    return _rebuild(like, iter(leaves))


def restore_checkpoint(path: str | os.PathLike, like, shardings=None):
    """A new state with ``like``'s structure, each leaf a new tensor with
    the template leaf's device and dtype (a resumed ``RecModel`` sets
    ``rm.state = restore_checkpoint(path, rm.state)``)."""
    if shardings is not None:
        raise _not_ported("restoring onto shardings (shardings=)")
    with np.load(path, allow_pickle=False) as z:
        return _restore([z], like)


def merge_sliced(paths: list[str], like):
    """Merge per-rank sliced checkpoints into one whole state."""
    zs = [np.load(p, allow_pickle=False) for p in paths]
    try:
        return _restore(zs, like)
    finally:
        for z in zs:
            z.close()
