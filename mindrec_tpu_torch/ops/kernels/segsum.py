"""Segment-sums of per-position gradients into per-unique-id sums.

Counterparts of ``mindrec_tpu/ops/pallas/stream_segsum.py`` (the kernels
are in ``csrc/segsum.cu``; see its header for the designs and bounds):

* :func:`segsum_sorted` - ``streamed_segsum`` with ``row_major=True``,
  and the ``g[perm]`` gather the reference's step runs in front of it.
  ``uidx_sorted`` is non-decreasing with unit steps; the result is
  ``[D, n_out]`` float32 with column ``u`` the sum of rows ``perm[i]`` of
  the batch-order ``g`` where ``uidx_sorted[i] == u``; columns past the
  last segment are zero.
* :func:`segsum_unsorted` - ``streamed_segsum_unsorted``: the same sum
  for segment ids in any order, ``n_out <= 2048`` (the tiny-vocab path,
  whose segment ids are the raw ids).
* :func:`segsum_cols` - ``streamed_segsum`` with ``row_major=False``:
  the sorted sum of a logical ``[D, N]`` gradient into ``[D, n_out]``.
  The kernel takes the transposed view of a contiguous ``[N, D]`` array
  (the feature-major step's sorted gradients), so no transpose copy sits
  in front of it.

In all three, segment ids outside ``[0, n_out)`` add nothing.
"""

from __future__ import annotations

import ctypes

import torch

from mindrec_tpu_torch.ops.kernels import (
    LAUNCHES, _build, on_cpu, require, require_contiguous,
)

_NAME = "segsum_sorted"
_ARGS = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def segsum_sorted_plain(g: torch.Tensor, uidx_sorted: torch.Tensor,
                        n_out: int, perm: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Plain PyTorch version (``g[perm]``, then ``index_add_`` in float32)."""
    if perm is not None:
        g = g[perm.long()]
    keep = (uidx_sorted >= 0) & (uidx_sorted < n_out)
    out = torch.zeros((n_out, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    out.index_add_(0, uidx_sorted[keep].long(), g[keep].float())
    return out.T.contiguous()


def segsum_sorted(g: torch.Tensor, uidx_sorted: torch.Tensor, n_out: int,
                  perm: torch.Tensor | None = None) -> torch.Tensor:
    """``out[:, u] = sum(g[perm[i], :] for uidx_sorted[i] == u)`` -> [D, n_out].

    ``g``: [R, D] bfloat16 or float32 (D <= 256), the rows in batch
    order; ``perm``: [N] int32 or int64, sorted position -> row of ``g``
    (values in [0, R); N may be less than R), or None for the identity
    (then R == N); ``uidx_sorted``: [N] int32.  CPU tensors take
    :func:`segsum_sorted_plain`; CUDA tensors launch the kernel, which
    reads the rows through ``perm`` (no gather in front of it) and returns
    the transposed view of a row-major [n_out, D] array.  The values of
    ``perm`` are not checked on the card (that would synchronise): one
    outside [0, R) reads out of bounds, where the plain version raises.
    The step's ``perm`` is in range by construction."""
    require(g.dim() == 2 and uidx_sorted.dim() == 1, _NAME,
            f"g [R, D] and uidx_sorted [N] expected, got {tuple(g.shape)} "
            f"and {tuple(uidx_sorted.shape)}")
    n = uidx_sorted.shape[0]
    if perm is None:
        require(g.shape[0] == n, _NAME,
                f"without perm, g must have one row per position: "
                f"{g.shape[0]} rows for {n} positions")
    else:
        require(perm.shape == (n,), _NAME,
                f"perm [{n}] expected, got {tuple(perm.shape)}")
        require(perm.dtype in (torch.int32, torch.int64), _NAME,
                f"perm must be int32 or int64, got {perm.dtype}")
    tensors = (g, uidx_sorted) if perm is None else (g, uidx_sorted, perm)
    if on_cpu(_NAME, *tensors):
        return segsum_sorted_plain(g, uidx_sorted, n_out, perm)
    d = g.shape[1]
    require(g.dtype in (torch.bfloat16, torch.float32), _NAME,
            f"g must be bfloat16 or float32, got {g.dtype}")
    require(uidx_sorted.dtype == torch.int32, _NAME, "uidx_sorted must be int32")
    require(0 < d <= 256, _NAME, f"D must be in [1, 256], got {d}")
    require(max(n, g.shape[0]) < 2**31 and 0 <= n_out < 2**31, _NAME,
            "sizes must fit int32")
    require_contiguous(_NAME, g=g, uidx_sorted=uidx_sorted,
                       **({} if perm is None else {"perm": perm}))
    out = torch.empty((n_out, d), dtype=torch.float32, device=g.device)
    partial = torch.empty(
        _build.scratch_len("mr_segsum_sorted_partial_len", n, d),
        dtype=torch.float32, device=g.device)
    fn = _build.kernel_fn("mr_segsum_sorted", _ARGS)
    rc = fn(g.data_ptr(), int(g.dtype == torch.bfloat16),
            None if perm is None else perm.data_ptr(),
            0 if perm is None else perm.element_size(),
            uidx_sorted.data_ptr(), n, d, n_out, partial.data_ptr(),
            out.data_ptr(), _build.stream_of(g))
    _build.check(rc, _NAME)
    LAUNCHES[_NAME] += 1
    return out.T  # the kernel writes coalesced [n_out, D] rows


_UNSORTED = "segsum_unsorted"
_UNSORTED_ARGS = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
]


def segsum_unsorted_plain(g: torch.Tensor, seg_ids: torch.Tensor,
                          n_out: int) -> torch.Tensor:
    """Plain PyTorch version (``index_add_`` in float32)."""
    return segsum_sorted_plain(g, seg_ids, n_out)


def segsum_unsorted(g: torch.Tensor, seg_ids: torch.Tensor,
                    n_out: int) -> torch.Tensor:
    """``out[:, s] = sum(g[n, :] for seg_ids[n] == s)`` -> [D, n_out].

    ``g``: [N, D] bfloat16 or float32; ``seg_ids``: [N] int32 in any
    order; ``n_out <= 2048``.  CPU tensors take
    :func:`segsum_unsorted_plain`; CUDA tensors launch the kernel."""
    require(g.dim() == 2 and seg_ids.shape == (g.shape[0],), _UNSORTED,
            f"g [N, D] and seg_ids [N] expected, got {tuple(g.shape)} and "
            f"{tuple(seg_ids.shape)}")
    require(0 <= n_out <= 2048, _UNSORTED, f"n_out must be <= 2048, got {n_out}")
    if on_cpu(_UNSORTED, g, seg_ids):
        return segsum_unsorted_plain(g, seg_ids, n_out)
    n, d = g.shape
    require(g.dtype in (torch.bfloat16, torch.float32), _UNSORTED,
            f"g must be bfloat16 or float32, got {g.dtype}")
    require(seg_ids.dtype == torch.int32, _UNSORTED, "seg_ids must be int32")
    require(0 < d <= 32 * 65535 and n < 2**31, _UNSORTED, "sizes out of range")
    require_contiguous(_UNSORTED, g=g, seg_ids=seg_ids)
    out = torch.empty((d, n_out), dtype=torch.float32, device=g.device)
    scratch = torch.empty(
        _build.scratch_len("mr_segsum_unsorted_scratch_len", n, n_out),
        dtype=torch.int32, device=g.device)
    partial = torch.empty(
        _build.scratch_len("mr_segsum_unsorted_partial_len", n, d, n_out),
        dtype=torch.float32, device=g.device)
    fn = _build.kernel_fn("mr_segsum_unsorted", _UNSORTED_ARGS)
    rc = fn(g.data_ptr(), int(g.dtype == torch.bfloat16), seg_ids.data_ptr(),
            n, d, n_out, scratch.data_ptr(), partial.data_ptr(),
            out.data_ptr(), _build.stream_of(g))
    _build.check(rc, _UNSORTED)
    LAUNCHES[_UNSORTED] += 1
    return out


_COLS = "segsum_cols"
_COLS_ARGS = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
]


def segsum_cols_plain(g: torch.Tensor, uidx_sorted: torch.Tensor,
                      n_out: int) -> torch.Tensor:
    """Plain PyTorch version (``index_add_`` along dim 1 in float32), for
    ``g`` in any layout."""
    keep = (uidx_sorted >= 0) & (uidx_sorted < n_out)
    out = torch.zeros((g.shape[0], n_out), dtype=torch.float32,
                      device=g.device)
    return out.index_add_(1, uidx_sorted[keep].long(), g[:, keep].float())


def segsum_cols(g: torch.Tensor, uidx_sorted: torch.Tensor,
                n_out: int) -> torch.Tensor:
    """``out[:, u] = sum(g[:, n] for uidx_sorted[n] == u)`` -> [D, n_out].

    ``g``: [D, N] bfloat16 or float32 (D <= 256); ``uidx_sorted``: [N]
    int32, non-decreasing with unit steps.  Every column is written, zeros
    past the last segment (the step passes ``n_out = N``, one slot per
    position).  CPU tensors take :func:`segsum_cols_plain`, in any layout;
    on any other device ``g`` must be the transposed view of a contiguous
    [N, D] array (strides ``(1, D)``), whose rows the kernel streams, and
    a [D, N]-contiguous ``g`` raises rather than being copied."""
    require(g.dim() == 2 and uidx_sorted.shape == (g.shape[1],), _COLS,
            f"g [D, N] and uidx_sorted [N] expected, got {tuple(g.shape)} "
            f"and {tuple(uidx_sorted.shape)}")
    if g.device.type != "cpu":
        require(g.T.is_contiguous(), _COLS,
                f"g must be the transposed view of a contiguous [N, D] "
                f"(strides (1, D)), got strides {g.stride()}")
    if on_cpu(_COLS, g, uidx_sorted):
        return segsum_cols_plain(g, uidx_sorted, n_out)
    d, n = g.shape
    require(g.dtype in (torch.bfloat16, torch.float32), _COLS,
            f"g must be bfloat16 or float32, got {g.dtype}")
    require(uidx_sorted.dtype == torch.int32, _COLS,
            "uidx_sorted must be int32")
    require(0 < d <= 256 and n < 2**31 and 0 <= n_out < 2**31, _COLS,
            f"D must be in [1, 256] and sizes must fit int32, got D {d}")
    require_contiguous(_COLS, uidx_sorted=uidx_sorted)
    bf16 = int(g.dtype == torch.bfloat16)
    out = torch.empty((d, n_out), dtype=torch.float32, device=g.device)
    partial = torch.empty(
        _build.scratch_len("mr_segsum_cols_partial_len", n, d, bf16),
        dtype=torch.float32, device=g.device)
    fn = _build.kernel_fn("mr_segsum_cols", _COLS_ARGS)
    rc = fn(g.data_ptr(), bf16, uidx_sorted.data_ptr(), n, d, n_out,
            partial.data_ptr(), out.data_ptr(), _build.stream_of(g))
    _build.check(rc, _COLS)
    LAUNCHES[_COLS] += 1
    return out
