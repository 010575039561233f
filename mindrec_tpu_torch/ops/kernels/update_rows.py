"""Lazy LazyAdam / FTRL updates of the touched rows of row_packed tables.

Counterpart of ``mindrec_tpu/ops/pallas/stream_update_rows.py``
(``streamed_adam_rows`` / ``streamed_ftrl_rows``); the kernels are in
``csrc/update_rows.cu`` (see its header for the design and bound).

Slot ``u`` carries the summed gradient ``g_sel[u]`` of logical row
``rows_sorted[u] * pack + sub_sorted[u]``, whose lanes are
``[sub*dim, (sub+1)*dim)`` of storage row ``rows_sorted[u]``.  Touch
rules, exactly as the reference: slots with ``rows_sorted`` outside the
table or ``present == 0`` are skipped; every other slot updates, even
with a zero gradient; sibling logical rows sharing the storage row keep
their weights and state.  The sorted unique ids must be distinct (the
slots never collide).

Both functions update ``table`` and its state **in place** (the reference
kernels alias their inputs to their outputs) and return them.
"""

from __future__ import annotations

import ctypes

import torch

from mindrec_tpu_torch.ops.kernels import (
    LAUNCHES, _build, on_cpu, require, require_contiguous,
)
from mindrec_tpu_torch.train.optim import adam_math, ftrl_math

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ADAM_ARGS = [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
              _F, _F, _F, _F, _F, _F, _P]
_FTRL_ARGS = [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
              _F, _F, _F, _F, _P]
_FLOATS = (torch.float32, torch.bfloat16)


def _touched(table, rows_sorted, sub_sorted, present, dim):
    """(storage rows [T, 1], lanes [T, dim], slot mask) of touched slots."""
    ok = (rows_sorted >= 0) & (rows_sorted < table.shape[0])
    if present is not None:
        ok &= present != 0
    r = rows_sorted[ok].long()[:, None]
    lanes = (sub_sorted[ok].long()[:, None] * dim
             + torch.arange(dim, device=table.device))
    return r, lanes, ok


def adam_rows_plain(table, m, v, rows_sorted, sub_sorted, g_sel, lr_t, *,
                    dim, pack, present=None, b1=0.9, b2=0.999, eps=1e-8,
                    loss_scale=1.0):
    """Plain PyTorch version of :func:`adam_rows` (gather, update,
    scatter), in place."""
    del pack  # the lane window follows from sub_sorted and dim
    r, lanes, ok = _touched(table, rows_sorted, sub_sorted, present, dim)
    w2, m2, v2 = adam_math(
        g_sel[ok], m[r, lanes], v[r, lanes], table[r, lanes], lr_t,
        b1=b1, b2=b2, eps=eps, inv_scale=1.0 / loss_scale,
    )
    table[r, lanes] = w2.to(table.dtype)
    m[r, lanes] = m2.to(m.dtype)
    v[r, lanes] = v2.to(v.dtype)
    return table, m, v


def ftrl_rows_plain(table, accum, linear, rows_sorted, sub_sorted, g_sel, *,
                    dim, pack, present=None, learning_rate=5e-2, l1=1e-8,
                    l2=1e-8, loss_scale=1.0):
    """Plain PyTorch version of :func:`ftrl_rows`, in place."""
    del pack
    r, lanes, ok = _touched(table, rows_sorted, sub_sorted, present, dim)
    w2, a2, l2_ = ftrl_math(
        g_sel[ok], accum[r, lanes], linear[r, lanes], table[r, lanes],
        learning_rate=learning_rate, l1=l1, l2=l2, inv_scale=1.0 / loss_scale,
    )
    table[r, lanes] = w2.to(table.dtype)
    accum[r, lanes] = a2
    linear[r, lanes] = l2_
    return table, accum, linear


def _check_slots(name, table, states, rows_sorted, sub_sorted, present,
                 g_sel, dim, pack):
    require(table.dim() == 2 and dim * pack <= table.shape[1], name,
            f"table [rows, >= dim*pack] expected, got {tuple(table.shape)}")
    require(table.dtype in _FLOATS, name, f"table dtype {table.dtype}")
    for k, s in states.items():
        require(s.shape == table.shape, name, f"{k} shape {tuple(s.shape)}")
    u = rows_sorted.shape[0]
    require(rows_sorted.shape == (u,) and sub_sorted.shape == (u,), name,
            "rows_sorted and sub_sorted must be [U]")
    require(g_sel.shape == (u, dim) and g_sel.dtype == torch.float32, name,
            f"g_sel must be [U, dim] float32, got {tuple(g_sel.shape)} "
            f"{g_sel.dtype}")
    idx = {"rows_sorted": rows_sorted, "sub_sorted": sub_sorted}
    if present is not None:
        require(present.shape == (u,), name, "present must be [U]")
        idx["present"] = present
    for k, t in idx.items():
        require(t.dtype == torch.int32, name, f"{k} must be int32")
    require(table.numel() < 2**40 and u * dim < 2**31, name,
            "sizes out of range")
    require_contiguous(name, table=table, g_sel=g_sel, **states, **idx)


def adam_rows(table, m, v, rows_sorted, sub_sorted, g_sel, lr_t, *, dim,
              pack, present=None, b1=0.9, b2=0.999, eps=1e-8, loss_scale=1.0):
    """One LazyAdam step over the touched logical rows, in place.

    ``table``: [rows, 128] float32 or bfloat16; ``m``, ``v``: same shape,
    float32 or bfloat16; ``rows_sorted``, ``sub_sorted``, ``present``:
    [U] int32; ``g_sel``: [U, dim] float32 (still multiplied by the loss
    scale); ``lr_t``: the bias-corrected rate, a float32 scalar tensor on
    the table's device."""
    name = "adam_rows"
    ts = [table, m, v, rows_sorted, sub_sorted, g_sel, lr_t]
    if on_cpu(name, *ts, *([present] if present is not None else [])):
        return adam_rows_plain(table, m, v, rows_sorted, sub_sorted, g_sel,
                               lr_t, dim=dim, pack=pack, present=present,
                               b1=b1, b2=b2, eps=eps, loss_scale=loss_scale)
    _check_slots(name, table, {"m": m, "v": v}, rows_sorted, sub_sorted,
                 present, g_sel, dim, pack)
    require(m.dtype == v.dtype and m.dtype in _FLOATS, name,
            f"m/v dtype {m.dtype}/{v.dtype}")
    require(lr_t.numel() == 1 and lr_t.dtype == torch.float32, name,
            "lr_t must be one float32")
    fn = _build.kernel_fn("mr_adam_rows", _ADAM_ARGS)
    rc = fn(table.data_ptr(), int(table.dtype == torch.bfloat16),
            m.data_ptr(), v.data_ptr(), int(m.dtype == torch.bfloat16),
            rows_sorted.data_ptr(), sub_sorted.data_ptr(),
            present.data_ptr() if present is not None else None,
            g_sel.data_ptr(), lr_t.data_ptr(), rows_sorted.shape[0], dim,
            table.shape[0], table.shape[1], b1, 1.0 - b1, b2, 1.0 - b2, eps,
            1.0 / loss_scale, _build.stream_of(table))
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return table, m, v


def ftrl_rows(table, accum, linear, rows_sorted, sub_sorted, g_sel, *, dim,
              pack, present=None, learning_rate=5e-2, l1=1e-8, l2=1e-8,
              loss_scale=1.0):
    """One FTRL-proximal step (``lr_power`` -0.5) over the touched
    logical rows, in place.  ``accum`` and ``linear`` are float32 of the
    table's shape; the other arguments are as in :func:`adam_rows`."""
    name = "ftrl_rows"
    ts = [table, accum, linear, rows_sorted, sub_sorted, g_sel]
    if on_cpu(name, *ts, *([present] if present is not None else [])):
        return ftrl_rows_plain(table, accum, linear, rows_sorted, sub_sorted,
                               g_sel, dim=dim, pack=pack, present=present,
                               learning_rate=learning_rate, l1=l1, l2=l2,
                               loss_scale=loss_scale)
    _check_slots(name, table, {"accum": accum, "linear": linear}, rows_sorted,
                 sub_sorted, present, g_sel, dim, pack)
    require(accum.dtype == torch.float32 and linear.dtype == torch.float32,
            name, "accum and linear must be float32")
    fn = _build.kernel_fn("mr_ftrl_rows", _FTRL_ARGS)
    rc = fn(table.data_ptr(), int(table.dtype == torch.bfloat16),
            accum.data_ptr(), linear.data_ptr(), rows_sorted.data_ptr(),
            sub_sorted.data_ptr(),
            present.data_ptr() if present is not None else None,
            g_sel.data_ptr(), rows_sorted.shape[0], dim, table.shape[0],
            table.shape[1], learning_rate, l1, 2.0 * l2, 1.0 / loss_scale,
            _build.stream_of(table))
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return table, accum, linear
