"""The (data, model) mesh on ``torch.distributed``: rank groups, state
and batch placement, and the collectives.

Port of ``mindrec_tpu/parallel/mesh.py``.  The reference lays a 2-D
logical mesh over its devices and lets GSPMD insert the collectives; the
port runs one process per rank and writes every collective out:

* axis ``data``: data parallelism.  Each data rank takes a contiguous
  slice of the global batch, dense parameters are replicated and their
  gradients are summed over the axis (``train/step.py``).
* axis ``model``: embedding model parallelism.  A table with a
  ``slice_mode`` keeps one block per model rank (``table_row_slice``:
  the vocab axis, ``table_column_slice``: the feature axis), with its
  row-aligned optimizer state; lookups and updates run per shard
  (``ops/sharded_stream.py``, ``ops/embedding.py``).

Rank ``r`` sits at ``(r // model, r % model)``, the reference's
``devices.reshape(data, model)`` order.  :func:`make_mesh` builds one
process group per mesh row (the ``model`` axis) and one per column (the
``data`` axis); every rank of the default group must call it, in the
same order.

Collectives (:func:`all_reduce`, :func:`all_gather`, :func:`all_to_all`)
take an axis (:func:`broadcast_host` runs over every rank) and run over this rank's group of it; an axis of size 1 is
the identity.  Under gloo a CUDA tensor goes through pinned host memory
(chosen by the group's backend); under NCCL it stays on the card.  Each
call appends ``(op, axis, bytes)`` to :data:`COLLECTIVES`, the bytes
this rank sends, so a run can show its collectives stay batch-scale.

Inside :func:`recording` (a captured step, ``train/step.py:CapturedStep``)
those three do not communicate: each hands the recorder a
:class:`RecordedCollective`, a fixed source tensor, a fixed output
tensor of the result's shape and dtype and a closure that computes the
collective from the one into the other, and returns the output tensor.
The capture cuts its graph there and runs the closure between two
replays; the closure logs to :data:`COLLECTIVES` as the eager call does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as tdist

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)

COLLECTIVES: list[tuple[str, str, int]] = []  # (op, axis, bytes) per call


def reset_collectives() -> None:
    COLLECTIVES.clear()


@dataclasses.dataclass(eq=False)
class Mesh:
    """A ``data x model`` grid over the ranks of the default group (or a
    single process).  ``groups[axis]`` is this rank's process group
    along ``axis`` (None for an axis of size 1)."""

    data: int
    model: int
    rank: int = 0
    groups: dict = dataclasses.field(default_factory=dict)
    axis_names: tuple = AXES

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.rank // self.model if axis == DATA_AXIS else self.rank % self.model

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, rank={self.rank}, "
                f"at={self.axis_index(DATA_AXIS), self.axis_index(MODEL_AXIS)})")


def make_mesh(data: int | None = None, model: int = 1) -> Mesh:
    """Build a (data, model) mesh over the default process group;
    ``data=None`` takes every remaining rank.  Without a process group
    the mesh is the single process, ``1 x 1``."""
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    rank = tdist.get_rank() if tdist.is_initialized() else 0
    if data is None:
        data = max(1, world // model)
    if data * model != world:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} ranks, the process "
            f"group has {world}; launch one process per rank "
            f"(mindrec_tpu_torch/examples/run_distribute_train.sh)")
    mesh = Mesh(data, model, rank)
    if world == 1:
        return mesh
    grid = np.arange(world).reshape(data, model)
    # every rank creates every group, in the same order
    for axis, lines in ((MODEL_AXIS, grid), (DATA_AXIS, grid.T)):
        for line in lines:
            ranks = [int(r) for r in line]
            group = tdist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                mesh.groups[axis] = group
    return mesh


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _through_host(x: torch.Tensor, group) -> bool:
    return x.device.type == "cuda" and tdist.get_backend(group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def _log(op: str, axis: str, nbytes: int) -> None:
    COLLECTIVES.append((op, axis, int(nbytes)))


class RecordedCollective(NamedTuple):
    """A collective of a step being captured: at each replay ``run()``
    computes it from ``src`` (which the graph before it wrote) into
    ``out`` (which the graph after it reads), and logs it."""

    op: str
    axis: str
    src: torch.Tensor
    out: torch.Tensor
    run: Callable[[], None]


_RECORDING = threading.local()  # .cut: this thread's recorder, or None


@contextlib.contextmanager
def recording(cut: Callable[[RecordedCollective], None]):
    """Record this thread's collectives instead of running them: each one
    calls ``cut`` with its :class:`RecordedCollective` and returns its
    ``out`` tensor."""
    prev = getattr(_RECORDING, "cut", None)
    _RECORDING.cut = cut
    try:
        yield
    finally:
        _RECORDING.cut = prev


def _collective(op: str, axis: str, x: torch.Tensor, shape,
                compute: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """The one dispatch point of the collectives: ``compute(src)`` (``src``
    the contiguous ``x``) now, or recorded (:func:`recording`)."""
    nbytes = x.numel() * x.element_size()
    cut = getattr(_RECORDING, "cut", None)
    if cut is None:
        _log(op, axis, nbytes)
        return compute(x.contiguous())
    src = x.contiguous()
    out = torch.empty(shape, dtype=x.dtype, device=x.device)

    def run() -> None:
        _log(op, axis, nbytes)
        out.copy_(compute(src))

    cut(RecordedCollective(op, axis, src, out, run))
    return out


def all_reduce(x: torch.Tensor, axis: str, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """``op`` (sum, min or max) of ``x`` over ``axis``; returns a new
    tensor (``x`` itself when the axis has one rank)."""
    group = mesh.groups.get(axis)
    if group is None:
        return x
    red = {"sum": tdist.ReduceOp.SUM, "min": tdist.ReduceOp.MIN,
           "max": tdist.ReduceOp.MAX}[op]

    def compute(src):
        if _through_host(src, group):
            h = _to_host(src)
            tdist.all_reduce(h, op=red, group=group)
            return h.to(src.device)
        out = src.clone()
        tdist.all_reduce(out, op=red, group=group)
        return out

    return _collective("all_reduce", axis, x, x.shape, compute)


def all_gather(x: torch.Tensor, axis: str, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated on dim 0 in axis
    order (equal shapes on every rank)."""
    group = mesh.groups.get(axis)
    if group is None:
        return x
    n = mesh.shape[axis]

    def compute(src):
        s = _to_host(src) if _through_host(src, group) else src
        parts = [torch.empty_like(s) for _ in range(n)]
        tdist.all_gather(parts, s, group=group)
        return torch.cat(parts).to(src.device)

    return _collective("all_gather", axis, x, (n * x.shape[0], *x.shape[1:]),
                       compute)


def all_to_all(x: torch.Tensor, axis: str, mesh: Mesh) -> torch.Tensor:
    """Split ``x`` on dim 0 into one equal block per rank of ``axis``,
    send block ``j`` to rank ``j`` and return the blocks received, in
    rank order (``lax.all_to_all(x, axis, 0, 0, tiled=True)``)."""
    group = mesh.groups.get(axis)
    if group is None:
        return x
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: dim 0 ({x.shape[0]}) must divide by {n}")

    def compute(src):
        s = _to_host(src) if _through_host(src, group) else src
        out = torch.empty_like(s)
        tdist.all_to_all_single(out, s, group=group)
        return out.to(src.device)

    return _collective("all_to_all", axis, x, x.shape, compute)


def _host_collective(x: np.ndarray, device) -> torch.Tensor:
    """A copy of a host array as the tensor a collective takes: on the
    host under gloo, on ``device`` under NCCL."""
    t = torch.from_numpy(np.array(x))
    return t if tdist.get_backend() == "gloo" else t.to(device)


def all_gather_host(x: np.ndarray, axis: str, mesh: Mesh, device="cpu") -> np.ndarray:
    """:func:`all_gather` of a host array (``device``: where NCCL takes
    it; gloo takes it on the host)."""
    if mesh.groups.get(axis) is None:
        return x
    return all_gather(_host_collective(x, device), axis, mesh).cpu().numpy()


def broadcast_host(x: np.ndarray, mesh: Mesh, device="cpu", src: int = 0) -> np.ndarray:
    """Rank ``src``'s host array on every rank of the default group (equal
    shapes and dtypes on every rank; ``x`` itself in one process)."""
    if mesh.size == 1:
        return x
    t = _host_collective(x, device)
    _log("broadcast", "world", t.numel() * t.element_size())
    tdist.broadcast(t, src)
    return t.cpu().numpy()


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the default group (none in one process)."""
    if mesh.size > 1:
        tdist.barrier()


class _ModelSum(torch.autograd.Function):
    """Sum over ``axis`` whose gradient passes through unchanged: every
    rank of the axis holds the same downstream, so the gradient of the
    sum with respect to each rank's part is the incoming gradient."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        return all_reduce(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_over(x: torch.Tensor, axis: str, mesh: Mesh | None) -> torch.Tensor:
    """Differentiable sum over ``axis`` of values every rank of the axis
    then uses alike (a sharded table's partial lookups or l2 terms)."""
    if mesh is None or mesh.groups.get(axis) is None:
        return x
    return _ModelSum.apply(x, axis, mesh)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a rank's local block lies in the global array: ``index`` is
    one slice per dimension (``slice(None)`` for a whole one)."""

    global_shape: tuple
    index: tuple

    def take(self, full):
        return full[self.index]

    def key(self) -> str:
        """The index as the reference's sliced checkpoints spell it,
        ``(slice(0, 512, None), slice(None, None, None))``."""
        return str(tuple(self.index))


def placement(global_shape, pspec, mesh: Mesh) -> Placement | None:
    """This rank's block of an array of ``global_shape`` partitioned per
    ``pspec`` (a tuple of axis names or None per dimension, as
    ``EmbeddingTableSpec.partition_spec``).  None when replicated."""
    index, split = [], False
    for dim, n in enumerate(global_shape):
        axis = pspec[dim] if dim < len(pspec) else None
        k = mesh.shape[axis] if axis is not None else 1
        if k == 1:
            index.append(slice(None))
            continue
        if n % k:
            raise ValueError(f"dimension {dim} ({n}) does not divide by the "
                             f"{axis} axis ({k})")
        m, blk = mesh.axis_index(axis), n // k
        index.append(slice(m * blk, (m + 1) * blk))
        split = True
    return Placement(tuple(global_shape), tuple(index)) if split else None


def _table_pspecs(model, mesh: Mesh) -> dict:
    """flat param key -> (spec, partition spec) of the sliced tables."""
    if mesh is None or mesh.model == 1:
        return {}
    out = {}
    for _name, (path, spec) in getattr(model, "table_specs", {}).items():
        if spec.slice_mode != "none":
            out["/".join(path)] = (spec, spec.partition_spec())
    return out


def _leaf_placements(model, mesh: Mesh):
    """-> (param placement fn, opt-state placement fn) of flat keys."""
    tables = _table_pspecs(model, mesh)

    def param(key, x):
        if key in tables and isinstance(x, torch.Tensor):
            return placement(tuple(x.shape), tables[key][1], mesh)
        return None

    def opt(key, x):
        if key not in tables or not isinstance(x, torch.Tensor):
            return None
        spec, pspec = tables[key]
        if x.dim() == 2 and tuple(x.shape) == tuple(spec.storage_shape):
            return placement(tuple(x.shape), pspec, mesh)
        if (x.dim() >= 1 and not spec.feature_major
                and x.shape[0] == spec.padded_vocab):
            return placement(tuple(x.shape), pspec[: x.dim()], mesh)
        return None

    return param, opt


def state_placements(state, model, mesh: Mesh):
    """A ``TrainState`` of the state's structure holding each leaf's
    :class:`Placement` on this rank (None where replicated), for the
    *global* shapes of ``state`` (an unsharded state, or the template a
    checkpoint restores onto)."""
    return _map_state(state, model, mesh, lambda x, pl: pl)


def _map_state(state, model, mesh, fn):
    from mindrec_tpu_torch.train.step import TrainState, map_leaves

    param, opt = _leaf_placements(model, mesh)

    def opt_tree(tree):
        return {k: map_leaves(lambda _sub, x, k=k: fn(x, opt(k, x)), v)
                for k, v in tree.items()}

    return TrainState(
        params=map_leaves(lambda k, x: fn(x, param(k, x)), state.params),
        opt_w=opt_tree(state.opt_w), opt_d=opt_tree(state.opt_d),
        step=fn(state.step, None), rng=fn(state.rng, None))


def shard_train_state(state, model, mesh: Mesh):
    """This rank's part of an unsharded state: each sliced table and its
    row-aligned optimizer state keep this rank's block (``[Dp, Vc/M]``
    for ``table_row_slice``, ``[Dp/M, Vc]`` for ``table_column_slice``
    on feature-major storage), as a contiguous copy; every other leaf
    is kept as it is (replicated)."""
    def take(x, pl):
        return x if pl is None else pl.take(x).contiguous()

    return _map_state(state, model, mesh, take)


class FullBatch(dict):
    """A batch every data rank holds whole (``shard_batch(...,
    full_batch=True)``); the step takes its own slice of it."""


class LocalBatch(dict):
    """A batch that already is this data rank's slice of the global batch
    (each rank read its own shard of the data, or its own shard of a
    stream); :func:`shard_batch` passes it through."""


def shard_batch(batch: dict, mesh: Mesh, full_batch: bool = False) -> dict:
    """This data rank's contiguous slice of every key's dim 0 (all ranks
    of a model row get the same one).  ``full_batch=True`` is the
    reference's full-batch input mode: every rank gets the whole batch
    (:class:`FullBatch`).  A :class:`LocalBatch` is returned as it is."""
    if full_batch:
        return FullBatch(batch)
    if isinstance(batch, LocalBatch):
        return batch
    n, d = mesh.data, mesh.axis_index(DATA_AXIS)
    out = {}
    for k, v in batch.items():
        rows = v.shape[0] if getattr(v, "ndim", 0) else 0
        if n == 1 or rows == 0:
            out[k] = v
            continue
        if rows % n:
            raise ValueError(f"batch key {k!r}: {rows} rows do not divide "
                             f"by the data axis ({n})")
        b = rows // n
        out[k] = v[d * b: (d + 1) * b]
    return out
