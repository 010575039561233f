"""Static-shape sparse utilities for the generic sparse step.

Port of ``mindrec_tpu/ops/sparse.py``.  :func:`unique_pad` has the
semantics of ``jnp.unique(size=, fill_value=, return_inverse=True,
return_counts=True)``: the distinct ids in ascending order, padded with
``fill_value`` to a static ``size``.  It is built from a sort, an
adjacent-difference mask and a cumulative sum, never ``torch.unique``,
whose data-dependent output size would read the count on the host and
so break the CUDA-graph capture of the step (``CapturedStep``).
:func:`segment_sum_rows` is ``jax.ops.segment_sum``.  On the CPU it is
``index_add_`` (a serial loop, in row order).  On the card an
accumulating index-put, the deterministic library route, adds a hot id's
rows one after another (one id repeated 400,000 times took a W&D step to
1.5 s on an H100), so the card sorts the rows by segment and adds them
with a segmented scan (:func:`segment_sum_sorted`): in blocks of 32 rows
by doubling, then the blocks' last partials the same way, level by
level.  Every add joins two rows of one segment, in an order fixed by
the shapes, so the sum is deterministic (a captured step equals the
eager one bit for bit) and never subtracts.  Neither has a kernel of its
own: the reference computes both with XLA ops, not in a Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class UniqueResult(NamedTuple):
    """Result of :func:`unique_pad`.

    ``ids``: ``[size]`` distinct ids, ascending, padded with
    ``fill_value``; ``inverse``: int64 of the input's shape, each
    element's slot in ``ids``; ``count``: int32 scalar on the ids'
    device, the number of distinct ids."""

    ids: torch.Tensor
    inverse: torch.Tensor
    count: torch.Tensor


def unique_pad(ids: torch.Tensor, size: int, fill_value: int) -> UniqueResult:
    """Distinct ``ids`` at a static ``size``, with no host read.  More
    distinct ids than ``size`` are cut to the ``size`` smallest, and the
    inverse of a cut id points past the last slot, as the reference's
    does (so :func:`segment_sum_rows` drops it)."""
    flat = ids.reshape(-1)
    n = flat.numel()
    dev = flat.device
    out = torch.full((size + 1,), fill_value, dtype=flat.dtype, device=dev)
    if n == 0:
        return UniqueResult(out[:size], torch.zeros(ids.shape, dtype=torch.int64,
                                                    device=dev),
                            torch.zeros((), dtype=torch.int32, device=dev))
    sorted_ids, perm = torch.sort(flat, stable=True)
    newv = torch.ones(n, dtype=torch.bool, device=dev)
    newv[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg = torch.cumsum(newv, 0) - 1  # slot of each sorted element
    # equal ids write the same value, so the scatter is deterministic;
    # slots past ``size`` land in the dropped extra element
    out.scatter_(0, torch.clamp(seg, max=size), sorted_ids)
    inverse = torch.empty(n, dtype=torch.int64, device=dev)
    inverse[perm] = seg
    count = torch.clamp(newv.sum(dtype=torch.int32), max=size)
    return UniqueResult(out[:size], inverse.reshape(ids.shape), count)


SCAN_BLOCK = 32  # rows per block of the segmented scan


def _block_scan(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented scan of ``v`` [nb, C, D] within each block of
    C rows, by doubling: row i adds row i - k of the previous round when
    both lie in one segment (``s`` [nb, C], sorted)."""
    k = 1
    while k < v.shape[1]:
        same = (s[:, k:] == s[:, :-k]).unsqueeze(-1)
        add = torch.where(same, v[:, :-k], torch.zeros((), dtype=v.dtype,
                                                       device=v.device))
        v = torch.cat([v[:, :k], v[:, k:] + add], dim=1)
        k *= 2
    return v


def _segmented_scan(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented scan of rows ``v`` [n, D] over sorted segment
    ids ``s`` [n]: each row holds the sum of its segment's rows up to it."""
    n, d = v.shape
    c = SCAN_BLOCK
    nb = -(-n // c)
    pad = nb * c - n
    if pad:  # the pad rows form a segment of their own past the last
        v = torch.cat([v, v.new_zeros((pad, d))])
        s = torch.cat([s, (s[-1:] + 1).expand(pad)])
    vb, sb = v.reshape(nb, c, d), s.reshape(nb, c)
    out = _block_scan(vb, sb)
    if nb > 1:
        # the segment running at the end of block b - 1 continues into
        # block b: its rows there add its sum over the blocks before
        carry = _segmented_scan(out[:, -1], sb[:, -1])
        cont = (sb[1:] == sb[:-1, -1:]).unsqueeze(-1)
        out = torch.cat([out[:1], out[1:] + torch.where(
            cont, carry[:-1].unsqueeze(1), torch.zeros((), dtype=v.dtype,
                                                       device=v.device))])
    return out.reshape(nb * c, d)[:n]


def segment_sum_sorted(values: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """:func:`segment_sum_rows` by a sort and a segmented scan (the card's
    route; any device): deterministic, no atomics, no host read."""
    flat = values.reshape(values.shape[0], -1)
    n, d = flat.shape
    if n == 0:
        return flat.new_zeros((num_segments, *values.shape[1:]))
    seg = segment_ids.reshape(-1).long()
    ok = (seg >= 0) & (seg < num_segments)
    seg = torch.where(ok, seg, torch.full_like(seg, num_segments))
    sorted_seg, order = torch.sort(seg, stable=True)
    scan = _segmented_scan(flat.index_select(0, order), sorted_seg)
    # each segment's total sits on its last row: read it there
    first = torch.searchsorted(sorted_seg, torch.arange(
        num_segments + 1, device=seg.device))
    ends = (first[1:] - 1).clamp(min=0)
    present = (first[1:] > first[:-1]).unsqueeze(1)
    out = torch.where(present, scan.index_select(0, ends),
                      torch.zeros((), dtype=flat.dtype, device=flat.device))
    return out.reshape(num_segments, *values.shape[1:])


def segment_sum_rows(values: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """Sum the rows of ``values`` into ``num_segments`` buckets (static
    count); ids outside ``[0, num_segments)`` are dropped, as
    ``jax.ops.segment_sum`` drops them.  The sum keeps ``values``'
    dtype.  CPU tensors: ``index_add_``; CUDA tensors:
    :func:`segment_sum_sorted`."""
    if values.device.type != "cpu":
        return segment_sum_sorted(values, segment_ids, num_segments)
    seg = segment_ids.reshape(-1).long()
    ok = (seg >= 0) & (seg < num_segments)
    seg = torch.where(ok, seg, torch.zeros_like(seg))
    vals = torch.where(ok.reshape(-1, *([1] * (values.dim() - 1))), values,
                       torch.zeros((), dtype=values.dtype, device=values.device))
    out = torch.zeros((num_segments, *values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, seg, vals)
