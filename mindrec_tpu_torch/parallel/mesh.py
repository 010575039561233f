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
take an axis and run over this rank's group of it; an axis of size 1 is
the identity.  Under gloo a CUDA tensor goes through pinned host memory
(chosen by the group's backend); under NCCL it stays on the card.  Each
call appends ``(op, axis, bytes)`` to :data:`COLLECTIVES`, the bytes
this rank sends, so a run can show its collectives stay batch-scale.
"""

from __future__ import annotations

import dataclasses
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


def all_reduce(x: torch.Tensor, axis: str, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """``op`` (sum, min or max) of ``x`` over ``axis``; returns a new
    tensor (``x`` itself when the axis has one rank)."""
    group = mesh.groups.get(axis)
    if group is None:
        return x
    red = {"sum": tdist.ReduceOp.SUM, "min": tdist.ReduceOp.MIN,
           "max": tdist.ReduceOp.MAX}[op]
    _log("all_reduce", axis, x.numel() * x.element_size())
    if _through_host(x, group):
        h = _to_host(x.contiguous())
        tdist.all_reduce(h, op=red, group=group)
        return h.to(x.device)
    out = x.clone().contiguous()
    tdist.all_reduce(out, op=red, group=group)
    return out


def all_gather(x: torch.Tensor, axis: str, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated on dim 0 in axis
    order (equal shapes on every rank)."""
    group = mesh.groups.get(axis)
    if group is None:
        return x
    n = mesh.shape[axis]
    _log("all_gather", axis, x.numel() * x.element_size())
    src = _to_host(x.contiguous()) if _through_host(x, group) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    tdist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


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
    _log("all_to_all", axis, x.numel() * x.element_size())
    host = _through_host(x, group)
    src = _to_host(x.contiguous()) if host else x.contiguous()
    out = torch.empty_like(src)
    tdist.all_to_all_single(out, src, group=group)
    return out.to(x.device)


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


def shard_batch(batch: dict, mesh: Mesh, full_batch: bool = False) -> dict:
    """This data rank's contiguous slice of every key's dim 0 (all ranks
    of a model row get the same one).  ``full_batch=True`` is the
    reference's full-batch input mode: every rank gets the whole batch
    (:class:`FullBatch`)."""
    if full_batch:
        return FullBatch(batch)
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
