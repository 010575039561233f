"""Explicit all-to-all embedding exchange for row-sliced tables.

Port of ``mindrec_tpu/ops/a2a.py``: the exchange of unique ids and rows
between the owners of a row-sliced feature-major table
(``TABLE_ROW_SLICE``, ``models/wide_deep/src/wide_and_deep.py:232-249``)
written out, bounded by the unique count and never by the vocab:

1. the caller gives sentinel-padded **unique** column ids ``uq [U]``;
2. model rank ``m`` takes the slice ``uq[m·U/M : (m+1)·U/M]``, so each
   unique id is asked for by one rank;
3. the owner of column ``c`` is ``c // (Vc/M)`` (the contiguous blocks
   of ``table_row_slice``);
4. the slice is bucketed by owner into a ``[M, K]`` matrix (``K`` ids
   per peer, default ``U/M``, lossless) and exchanged with one
   :func:`~mindrec_tpu_torch.parallel.mesh.all_to_all` of ids;
5. each rank reads the rows asked of it and a second all-to-all returns
   them ``[U/M, Dp]``;
6. one all-gather over ``model`` rebuilds the ``[Dp, U]`` unique rows.

Per rank: ``M·K`` ids, ``M·K·Dp`` row values and ``U·Dp`` gathered
values travel, whatever the vocab.  The backward (a
``torch.autograd.Function``) runs the exchange in reverse: each rank's
slice of the row gradient goes back to the owners, which add it into
their block, then a sum over ``data`` when ``data_axis`` is set.  No step
uses it (the streamed step's sorted unique ids make ownership a clip,
``ops/sharded_stream.py``); it is the bounded exchange for lookups whose
ids arrive in any order.
"""

from __future__ import annotations

import torch

from mindrec_tpu_torch.parallel.mesh import all_gather, all_reduce, all_to_all

SENTINEL = 2**31 - 2


def _bucket_by_owner(cols, n_shards: int, shard_cols: int, capacity: int):
    """-> (send ``[M, K]`` owner-local ids, -1 padded; owner; position in
    the owner's bucket; valid) of column ids ``cols``."""
    owner = torch.clamp(torch.div(cols, shard_cols, rounding_mode="floor"),
                        0, n_shards - 1).long()
    local = cols - owner * shard_cols
    onehot = torch.nn.functional.one_hot(owner, n_shards)
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(1)
    valid = (cols < SENTINEL) & (pos < capacity)
    send = torch.full((n_shards, capacity), -1, dtype=torch.int32,
                      device=cols.device)
    send[owner[valid], pos[valid]] = local[valid].to(torch.int32)
    return send, owner, pos, valid


class _UniqueGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, uq, mesh, axis, data_axis, capacity):
        n, m = mesh.shape[axis], mesh.axis_index(axis)
        u_slice = uq.shape[0] // n
        dp, shard_cols = table.shape
        uq_my = uq[m * u_slice:(m + 1) * u_slice].long()
        send, owner, pos, valid = _bucket_by_owner(uq_my, n, shard_cols,
                                                   capacity)
        req = all_to_all(send, axis, mesh).reshape(-1)  # ids asked of us
        ok = req >= 0
        safe = torch.where(ok, req, 0).long()
        rows = table.index_select(1, safe) * ok[None, :].to(table.dtype)
        got = all_to_all(rows.T.reshape(n, capacity, dp).contiguous(), axis,
                         mesh).reshape(n * capacity, dp)
        flat = torch.clamp(owner * capacity + pos, 0, n * capacity - 1)
        mine = got[flat] * valid[:, None].to(got.dtype)  # [U/M, Dp]
        ctx.save_for_backward(table, safe, ok, owner, pos, valid)
        ctx.cfg = (mesh, axis, data_axis, capacity, u_slice)
        return all_gather(mine.contiguous(), axis, mesh).T  # [Dp, U]

    @staticmethod
    def backward(ctx, g):
        table, safe, ok, owner, pos, valid = ctx.saved_tensors
        mesh, axis, data_axis, capacity, u_slice = ctx.cfg
        n, m = mesh.shape[axis], mesh.axis_index(axis)
        dp = table.shape[0]
        g_my = g.T[m * u_slice:(m + 1) * u_slice] * valid[:, None].to(g.dtype)
        buck = g.new_zeros((n, capacity, dp))
        buck[owner[valid], pos[valid]] = g_my[valid]
        back = all_to_all(buck, axis, mesh).reshape(n * capacity, dp)
        back = back * ok[:, None].to(back.dtype)
        dtable = torch.zeros_like(table).index_add_(1, safe, back.T.to(table.dtype))
        if data_axis is not None:
            dtable = all_reduce(dtable, data_axis, mesh)
        return dtable, None, None, None, None, None


def sharded_unique_gather(table: torch.Tensor, uq_cols: torch.Tensor, mesh, *,
                          axis: str = "model", data_axis: str | None = "data",
                          capacity: int | None = None) -> torch.Tensor:
    """All-to-all lookup of unique columns from a row-sliced feature-major
    table.

    ``table``: this rank's ``[Dp, Vc/M]`` block; ``uq_cols``: ``[U]``
    int32 sentinel-padded unique column ids of this rank (alike over
    ``axis``; with ``data_axis`` each data rank may bring its own);
    ``U`` must divide by the model axis.  ``capacity``: ids per peer
    (default ``U/M``, lossless); ids past it read zeros.  Returns the
    ``[Dp, U]`` rows in unique order (zeros for sentinels),
    differentiable in ``table`` (the backward sums over ``data_axis``)."""
    n = mesh.shape[axis]
    u = uq_cols.shape[0]
    if u % n:
        raise ValueError(f"per-rank U={u} must divide by model shards {n}")
    if capacity is None:
        capacity = u // n
    return _UniqueGather.apply(table, uq_cols, mesh, axis, data_axis, capacity)
