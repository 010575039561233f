"""Gathers of feature-major table columns.

Counterparts of ``mindrec_tpu/ops/pallas/stream_gather.py`` (the kernels
``csrc/gather_rows.cu`` and ``csrc/gather_cols.cu``; see their headers
for the designs and bounds):

* :func:`gather_rows` - ``streamed_gather_rows``: ``buf[j, lane_offset +
  p] = table[p, cols[j]]`` for every sublane ``p`` of the ``[Dp, Vc]``
  table, written **in place** into the row-major unique-row buffer; a
  slot whose column lies outside ``[0, Vc)`` (the sentinel) keeps the
  buffer's content.
* :func:`gather_cols` - ``streamed_gather``: ``out[p, j] = table[p,
  cols[j]]`` into a new column-major ``[Dp, N]`` float32 array; a column
  outside ``[0, Vc)`` gives zeros (the reference leaves those outputs
  unwritten).

Columns may repeat.  The reference rounds the gathered values to its
``matmul_dtype`` inside a one-hot matmul; the port copies them exactly.
"""

from __future__ import annotations

import ctypes

import torch

from mindrec_tpu_torch.ops.kernels import (
    LAUNCHES, _build, on_cpu, require, require_contiguous,
)

_NAME = "gather_rows"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGS = [_P, _I, _L, _I, _P, _L, _P, _L, _I, _P]
_MAX_DP = 256  # kMaxDp in csrc/gather_rows.cu


def gather_rows_plain(table: torch.Tensor, cols: torch.Tensor,
                      buf: torch.Tensor, lane_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`gather_rows`, in place."""
    dp, vc = table.shape
    j = torch.nonzero((cols >= 0) & (cols < vc)).flatten()
    buf[j, lane_offset: lane_offset + dp] = table[:, cols[j].long()].T.to(buf.dtype)
    return buf


def gather_rows(table: torch.Tensor, cols: torch.Tensor, buf: torch.Tensor,
                lane_offset: int = 0) -> torch.Tensor:
    """``buf[j, off:off+Dp] = table[:, cols[j]]`` for in-table columns.

    ``table``: [Dp, Vc] float32 or bfloat16 (Dp <= 256); ``cols``: [U]
    int32; ``buf``: [U, width] float32.  CPU tensors take
    :func:`gather_rows_plain`; CUDA tensors launch the kernel.  Returns
    ``buf``."""
    require(table.dim() == 2 and buf.dim() == 2
            and cols.shape == (buf.shape[0],), _NAME,
            f"table [Dp, Vc], cols [U], buf [U, width] expected, got "
            f"{tuple(table.shape)}, {tuple(cols.shape)}, {tuple(buf.shape)}")
    dp, vc = table.shape
    require(0 <= lane_offset and lane_offset + dp <= buf.shape[1], _NAME,
            f"lanes [{lane_offset}, {lane_offset + dp}) exceed width "
            f"{buf.shape[1]}")
    if on_cpu(_NAME, table, cols, buf):
        return gather_rows_plain(table, cols, buf, lane_offset)
    require(table.dtype in (torch.float32, torch.bfloat16), _NAME,
            f"table dtype {table.dtype}")
    require(buf.dtype == torch.float32, _NAME, "buf must be float32")
    require(cols.dtype == torch.int32, _NAME, "cols must be int32")
    require(0 < dp <= _MAX_DP, _NAME, f"Dp must be in [1, {_MAX_DP}], got {dp}")
    require_contiguous(_NAME, table=table, cols=cols, buf=buf)
    fn = _build.kernel_fn("mr_gather_rows", _ARGS)
    rc = fn(table.data_ptr(), int(table.dtype == torch.bfloat16), vc, dp,
            cols.data_ptr(), cols.shape[0], buf.data_ptr(), buf.shape[1],
            lane_offset, _build.stream_of(buf))
    _build.check(rc, _NAME)
    LAUNCHES[_NAME] += 1
    return buf


_COLS = "gather_cols"
_COLS_ARGS = [_P, _I, _L, _I, _P, _L, _P, _P]


def gather_cols_plain(table: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`gather_cols`."""
    dp, vc = table.shape
    ok = (cols >= 0) & (cols < vc)
    out = torch.zeros((dp, cols.shape[0]), dtype=torch.float32,
                      device=table.device)
    out[:, ok] = table[:, cols[ok].long()].float()
    return out


def gather_cols(table: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``out[:, j] = table[:, cols[j]]`` -> [Dp, N] float32, zeros where
    ``cols[j]`` lies outside ``[0, Vc)``.

    ``table``: [Dp, Vc] float32 or bfloat16; ``cols``: [N] int32 (sorted
    in the step, which the kernel's speed but not its result relies on).
    CPU tensors take :func:`gather_cols_plain`; CUDA tensors launch the
    kernel."""
    require(table.dim() == 2 and cols.dim() == 1, _COLS,
            f"table [Dp, Vc] and cols [N] expected, got "
            f"{tuple(table.shape)} and {tuple(cols.shape)}")
    if on_cpu(_COLS, table, cols):
        return gather_cols_plain(table, cols)
    dp, vc = table.shape
    require(table.dtype in (torch.float32, torch.bfloat16), _COLS,
            f"table dtype {table.dtype}")
    require(cols.dtype == torch.int32, _COLS, "cols must be int32")
    require(0 < dp <= 65535 and cols.shape[0] < 2**31, _COLS,
            "sizes out of range")
    require_contiguous(_COLS, table=table, cols=cols)
    out = torch.empty((dp, cols.shape[0]), dtype=torch.float32,
                      device=table.device)
    fn = _build.kernel_fn("mr_gather_cols", _COLS_ARGS)
    rc = fn(table.data_ptr(), int(table.dtype == torch.bfloat16), vc, dp,
            cols.data_ptr(), cols.shape[0], out.data_ptr(),
            _build.stream_of(out))
    _build.check(rc, _COLS)
    LAUNCHES[_COLS] += 1
    return out
