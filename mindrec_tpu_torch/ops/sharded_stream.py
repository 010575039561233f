"""The streamed kernels run per shard of a (data, model) mesh.

Port of ``mindrec_tpu/ops/sharded_stream.py``: the sharded-embedding
regime of the reference (``TABLE_ROW_SLICE`` under hybrid parallel,
``models/wide_deep/src/wide_and_deep.py:232-249``) on the port's
hand-written kernels, each rank running them on its own block with the
collectives written out (``parallel/mesh.py``).

Row slice: the step's unique ids are globally sorted and a row-sliced
feature-major table ``[Dp, Vc]`` keeps one contiguous vocab block
``[Dp, Vc/M]`` per model rank, so a rank's owned ids are one contiguous
run of the sorted unique vector and it picks them with a clip::

    cols_local = max(uq_cols - m * Vc_local, -1)

which stays ascending: ids below the block become -1, ids past it stay
past ``Vc_local``; the kernels skip both.

* forward: each model rank gathers its owned unique rows into the
  lanes of a zeroed ``[U, width]`` buffer (``gather_rows``); one sum
  over ``model`` of those lanes rebuilds the rows (disjoint writes);
* backward: each data rank sorts its own ids and sums its positions'
  gradients directly in the global unique order (``segsum_sorted``;
  every local id is one of the global unique ids, so a sorted
  position's segment is its id's place in that vector, found by a
  binary search; the segments it skips read zero), then one sum over
  ``data``;
* update: each model rank updates its block for its owned columns only
  (``adam_cols_from_sums`` / ``ftrl_cols_from_sums`` on the summed
  gradients where the segment sum left them); unowned columns and their
  state are untouched, as lazy updates require.

Column slice keeps ``[Dp/M, Vc]`` per model rank: every rank streams all
unique ids over its sublanes, into the lane window ``off + m * Dp/M``
of the buffer (a run-time argument of ``gather_rows``), and updates its
sublanes from its rows of the summed gradient (a view), with no
collective.

Every collective carries unique rows or gradients, never a table.  The
bucket must hold every distinct id of the global batch (the host prep's
``BucketOverflow``): an id missing from ``uq`` would shift the global
unique indexing.  ``use_kernels=False`` calls the kernels' plain
versions (the reference for the kernels on the card); on the CPU the
wrappers take them anyway.
"""

from __future__ import annotations

import torch

from mindrec_tpu_torch.ops.kernels.gather import gather_rows, gather_rows_plain
from mindrec_tpu_torch.ops.kernels.segsum import (
    segsum_sorted, segsum_sorted_plain, segsum_unsorted, segsum_unsorted_plain,
)
from mindrec_tpu_torch.ops.kernels.update_cols import (
    adam_cols_from_sums, adam_cols_from_sums_plain, ftrl_cols_from_sums,
    ftrl_cols_from_sums_plain,
)
from mindrec_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, all_reduce

MAX_SHARD_SUBLANES = 128  # column slice: Dp / M per rank (ADVICE.md:5)


def owned_cols(uq_cols: torch.Tensor, vc_local: int, m: int) -> torch.Tensor:
    """Global sorted storage columns -> model rank ``m``'s local columns
    (int32, still ascending: below the block -1, past it >= vc_local)."""
    return torch.clamp_min(uq_cols - m * vc_local, -1).to(torch.int32)


def _reduce_lanes(buf: torch.Tensor, lo: int, hi: int, axis: str, mesh) -> torch.Tensor:
    """Sum ``buf[:, lo:hi]`` over ``axis`` in place (the other lanes are
    alike on every rank and do not travel)."""
    if mesh.groups.get(axis) is None or hi <= lo:
        return buf
    buf[:, lo:hi] = all_reduce(buf[:, lo:hi].contiguous(), axis, mesh)
    return buf


def gather_rows_sharded(mesh, tables, uq_cols_list, lane_offsets,
                        buf: torch.Tensor, *, use_kernels: bool = True,
                        axis: str = MODEL_AXIS) -> torch.Tensor:
    """Row-sliced gather into the ``[ub, width]`` float32 unique-row
    buffer, in place; afterwards the tables' lanes are alike on every
    rank of the model row.

    ``tables``: this rank's ``[Dp_t, Vc_t / M]`` blocks; ``uq_cols_list``:
    per table ``[ub]`` int32 ascending global storage columns;
    ``lane_offsets``: each table's first lane.  The tables' lanes of
    ``buf`` must be zero, and only they are summed over ``model``."""
    gather = gather_rows if use_kernels else gather_rows_plain
    m = mesh.axis_index(axis)
    for tbl, uqc, off in zip(tables, uq_cols_list, lane_offsets):
        gather(tbl, owned_cols(uqc, tbl.shape[1], m), buf, off)
    lo = min(lane_offsets)
    hi = max(off + t.shape[0] for off, t in zip(lane_offsets, tables))
    return _reduce_lanes(buf, lo, hi, axis, mesh)


def gather_cols_sharded(mesh, tables, uq_cols_list, lane_offsets,
                        buf: torch.Tensor, *, use_kernels: bool = True,
                        axis: str = MODEL_AXIS) -> torch.Tensor:
    """Column-sliced gather, in place: each rank streams every unique
    column of its ``[Dp/M, Vc]`` block into lanes ``off + m * Dp/M`` of
    ``buf``; one sum over ``model`` merges the lane windows (zero
    before, as in :func:`gather_rows_sharded`).  The reference places
    the window with a one-hot shift matmul because its kernel's lane
    offset is static; here it is a run-time argument.  ``Dp/M`` must be
    at most 128 (``ADVICE.md:5``)."""
    gather = gather_rows if use_kernels else gather_rows_plain
    m, nm = mesh.axis_index(axis), mesh.shape[axis]
    for tbl, uqc, off in zip(tables, uq_cols_list, lane_offsets):
        dpl = tbl.shape[0]
        if dpl > MAX_SHARD_SUBLANES:
            raise ValueError(
                f"column slice: {dpl} sublanes per rank > "
                f"{MAX_SHARD_SUBLANES}; raise the model axis or row-slice")
        gather(tbl, uqc.to(torch.int32), buf, off + m * dpl)
    lo = min(lane_offsets)
    hi = max(off + t.shape[0] * nm for off, t in zip(lane_offsets, tables))
    return _reduce_lanes(buf, lo, hi, axis, mesh)


def _colsliced_rows(mesh, grads, axis):
    """This rank's sublane rows of the summed gradients ``[Dp, U]`` (a
    view)."""
    nm, m = mesh.shape[axis], mesh.axis_index(axis)
    dpl = grads.shape[0] // nm
    return grads[m * dpl:(m + 1) * dpl]


def adam_colsliced_sharded(mesh, table, m, v, uq_cols, grads, gate, lr_t, *,
                           b1=0.9, b2=0.999, eps=1e-8, loss_scale=1.0,
                           use_kernels=True, axis=MODEL_AXIS):
    """Column-sliced LazyAdam, in place: this rank's sublane rows of the
    summed gradients ``[Dp, U]`` (any strides; ``gate`` as in
    ``adam_cols_from_sums``) over its ``[Dp/M, Vc]`` block and state,
    every unique column, no collective (fold 1 only)."""
    fn = adam_cols_from_sums if use_kernels else adam_cols_from_sums_plain
    return fn(table, m, v, uq_cols, _colsliced_rows(mesh, grads, axis), None,
              gate, lr_t, dim=table.shape[0], fold=1, b1=b1, b2=b2, eps=eps,
              loss_scale=loss_scale)


def ftrl_colsliced_sharded(mesh, table, accum, linear, uq_cols, grads, gate,
                           *, learning_rate=5e-2, l1=1e-8, l2=1e-8,
                           loss_scale=1.0, use_kernels=True, axis=MODEL_AXIS):
    """Column-sliced FTRL twin of :func:`adam_colsliced_sharded`."""
    fn = ftrl_cols_from_sums if use_kernels else ftrl_cols_from_sums_plain
    return fn(table, accum, linear, uq_cols,
              _colsliced_rows(mesh, grads, axis), None, gate,
              dim=table.shape[0], fold=1, learning_rate=learning_rate, l1=l1,
              l2=l2, loss_scale=loss_scale)


def local_segments(ids_flat: torch.Tensor, uq: torch.Tensor):
    """A data rank's ``(uidx_sorted, perm)`` in the GLOBAL unique order:
    its ``[N_l]`` ids sorted (``perm``: sorted position -> position), each
    sorted position's segment the place of its id in ``uq`` (``[ub]``
    sorted sentinel-padded global unique ids, which hold every local id),
    ascending with gaps where this rank has no position; both int32."""
    sorted_ids, perm = torch.sort(ids_flat.reshape(-1).to(torch.int32),
                                  stable=True)
    uidx = torch.searchsorted(uq.to(torch.int32).contiguous(), sorted_ids,
                              out_int32=True)
    return uidx, perm.to(torch.int32).contiguous()


def partial_segsum_sharded(mesh, g_delta, ids_flat, uq, ub: int, *,
                           use_kernels: bool = True,
                           data_axis: str = DATA_AXIS) -> torch.Tensor:
    """Sum this data rank's batch-order position gradients into the
    GLOBAL unique order, then over ``data``: ``[width, ub]`` float32.

    ``g_delta``: ``[N_l, width]`` this rank's gradients; ``ids_flat``:
    its ``[N_l]`` raw ids; ``uq``: ``[ub]`` sorted sentinel-padded global
    unique ids, alike on every rank (:func:`local_segments`)."""
    uidx, perm = local_segments(ids_flat, uq)
    seg = segsum_sorted if use_kernels else segsum_sorted_plain
    part = seg(g_delta.contiguous(), uidx, ub, perm=perm, gaps=True)
    return all_reduce(part.contiguous(), data_axis, mesh)


def unsorted_segsum_sharded(mesh, g_delta, ids_flat, ub: int, *,
                            use_kernels: bool = True,
                            data_axis: str = DATA_AXIS) -> torch.Tensor:
    """Tiny-vocab twin of :func:`partial_segsum_sharded`: raw ids are the
    segment ids; each data rank sums its positions
    (``segsum_unsorted``), one sum over ``data`` combines them."""
    seg = segsum_unsorted if use_kernels else segsum_unsorted_plain
    part = seg(g_delta.contiguous(), ids_flat.reshape(-1).to(torch.int32), ub)
    return all_reduce(part.contiguous(), data_axis, mesh)


def adam_cols_sharded(mesh, table, m, v, uq_cols, grads, sub, gate, lr_t, *,
                      dim, fold=1, b1=0.9, b2=0.999, eps=1e-8, loss_scale=1.0,
                      use_kernels=True, axis=MODEL_AXIS):
    """Row-sliced LazyAdam, in place: this rank's owned columns of its
    ``[Dp, Vc/M]`` block and state, from the summed gradients ``[Dp, U]``
    of every unique column (``sub`` and ``gate`` as in
    ``adam_cols_from_sums``; the clipped columns skip the unowned)."""
    fn = adam_cols_from_sums if use_kernels else adam_cols_from_sums_plain
    cols = owned_cols(uq_cols, table.shape[1], mesh.axis_index(axis))
    return fn(table, m, v, cols, grads, sub, gate, lr_t, dim=dim, fold=fold,
              b1=b1, b2=b2, eps=eps, loss_scale=loss_scale)


def ftrl_cols_sharded(mesh, table, accum, linear, uq_cols, grads, sub, gate,
                      *, dim, fold=1, learning_rate=5e-2, l1=1e-8, l2=1e-8,
                      loss_scale=1.0, use_kernels=True, axis=MODEL_AXIS):
    """Row-sliced FTRL twin of :func:`adam_cols_sharded`."""
    fn = ftrl_cols_from_sums if use_kernels else ftrl_cols_from_sums_plain
    cols = owned_cols(uq_cols, table.shape[1], mesh.axis_index(axis))
    return fn(table, accum, linear, cols, grads, sub, gate, dim=dim,
              fold=fold, learning_rate=learning_rate, l1=l1, l2=l2,
              loss_scale=loss_scale)
