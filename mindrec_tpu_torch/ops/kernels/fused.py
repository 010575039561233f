"""Fused table pump: the lazy column update of one batch and the gather
of the next batch's columns from the updated table, in one kernel.

Counterpart of ``mindrec_tpu/ops/pallas/stream_fused.py``
(``fused_adam_gather`` / ``fused_ftrl_gather``; the kernels are in
``csrc/fused_cols.cu``, see its header for the design and bound).  The
update is that of ``update_cols.adam_cols_plain`` / ``ftrl_cols_plain``
(sorted storage columns, touch-augmented gradients, duplicate columns summed,
the touch rows gate, ``1 / loss_scale``) and the gather that of
``gather.gather_cols``: ``rows[:, j] = table'[:, next_cols_sorted[j]]``
read from the **updated** table, zeros for columns outside the table.
Semantics are those of update-then-gather; the plain versions are that
sequence.

Both functions update ``table`` and its state **in place** and return
them with the gathered rows.  No train step calls them (as in the
reference, whose steps keep the separate kernels); a pipeline that knows
the next batch's sorted ids one step ahead can.
"""

from __future__ import annotations

import ctypes

import torch

from mindrec_tpu_torch.ops.kernels import LAUNCHES, _build, on_cpu, require
from mindrec_tpu_torch.ops.kernels.gather import gather_cols_plain
from mindrec_tpu_torch.ops.kernels.update_cols import (
    FLOATS, check_args, adam_cols_plain, ftrl_cols_plain,
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_ADAM_ARGS = [_P, _I, _P, _P, _I, _L, _I, _P, _P, _I, _I, _P,
              _F, _F, _F, _F, _F, _F, _P, _I, _P, _P]
_FTRL_ARGS = [_P, _I, _P, _P, _L, _I, _P, _P, _I, _I, _F, _F, _F, _F,
              _P, _I, _P, _P]


def _check_next(name, table, next_cols):
    """Check the next ids; -> rows [Dp, n_g] for the kernel to fill."""
    require(next_cols.dim() == 1 and next_cols.dtype == torch.int32, name,
            "next_cols_sorted must be [n_g] int32")
    require(next_cols.is_contiguous() and next_cols.shape[0] < 2**31, name,
            "next_cols_sorted must be contiguous and fit int32")
    require(table.shape[1] < 2**31, name, "Vc must fit int32")
    return torch.empty((table.shape[0], next_cols.shape[0]),
                       dtype=torch.float32, device=table.device)


def fused_adam_gather_plain(table, m, v, cols_sorted, grads_aug, lr_t,
                            next_cols_sorted, *, dim, fold=1, b1=0.9,
                            b2=0.999, eps=1e-8, loss_scale=1.0):
    """Plain PyTorch version of :func:`fused_adam_gather`: the update,
    then the gather."""
    adam_cols_plain(table, m, v, cols_sorted, grads_aug, lr_t, dim=dim,
                    fold=fold, b1=b1, b2=b2, eps=eps, loss_scale=loss_scale)
    return table, m, v, gather_cols_plain(table, next_cols_sorted)


def fused_ftrl_gather_plain(table, accum, linear, cols_sorted, grads_aug,
                            next_cols_sorted, *, dim, fold=1,
                            learning_rate=5e-2, l1=1e-8, l2=1e-8,
                            loss_scale=1.0):
    """Plain PyTorch version of :func:`fused_ftrl_gather`: the update,
    then the gather."""
    ftrl_cols_plain(table, accum, linear, cols_sorted, grads_aug, dim=dim,
                    fold=fold, learning_rate=learning_rate, l1=l1, l2=l2,
                    loss_scale=loss_scale)
    return table, accum, linear, gather_cols_plain(table, next_cols_sorted)


def fused_adam_gather(table, m, v, cols_sorted, grads_aug, lr_t,
                      next_cols_sorted, *, dim, fold=1, b1=0.9, b2=0.999,
                      eps=1e-8, loss_scale=1.0):
    """One LazyAdam step over the columns in ``cols_sorted``, in place,
    and the gather of ``next_cols_sorted`` from the updated table.

    ``table``: [Dp, Vc] float32 or bfloat16; ``m``, ``v``: same shape,
    float32 or bfloat16; ``cols_sorted``: [n_u] int32 ascending;
    ``grads_aug``: [Dp + 8, n_u] float32; ``lr_t``: the bias-corrected
    rate, a float32 scalar tensor on the table's device;
    ``next_cols_sorted``: [n_g] int32 ascending.  Returns ``(table, m,
    v, rows)`` with ``rows`` [Dp, n_g] float32."""
    name = "fused_adam_gather"
    kw = dict(dim=dim, fold=fold, b1=b1, b2=b2, eps=eps, loss_scale=loss_scale)
    if on_cpu(name, table, m, v, cols_sorted, grads_aug, lr_t,
              next_cols_sorted):
        return fused_adam_gather_plain(table, m, v, cols_sorted, grads_aug,
                                       lr_t, next_cols_sorted, **kw)
    check_args(name, table, {"m": m, "v": v}, cols_sorted, grads_aug, dim, fold)
    require(m.dtype == v.dtype and m.dtype in FLOATS, name,
            f"m/v dtype {m.dtype}/{v.dtype}")
    require(lr_t.numel() == 1 and lr_t.dtype == torch.float32, name,
            "lr_t must be one float32")
    rows = _check_next(name, table, next_cols_sorted)
    dp, vc = table.shape
    fn = _build.kernel_fn("mr_fused_adam_gather", _ADAM_ARGS)
    rc = fn(table.data_ptr(), int(table.dtype == torch.bfloat16),
            m.data_ptr(), v.data_ptr(), int(m.dtype == torch.bfloat16), vc, dp,
            cols_sorted.data_ptr(), grads_aug.data_ptr(), cols_sorted.shape[0],
            fold, lr_t.data_ptr(), b1, 1.0 - b1, b2, 1.0 - b2, eps,
            1.0 / loss_scale, next_cols_sorted.data_ptr(),
            next_cols_sorted.shape[0], rows.data_ptr(),
            _build.stream_of(table))
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return table, m, v, rows


def fused_ftrl_gather(table, accum, linear, cols_sorted, grads_aug,
                      next_cols_sorted, *, dim, fold=1, learning_rate=5e-2,
                      l1=1e-8, l2=1e-8, loss_scale=1.0):
    """One FTRL-proximal step (``lr_power`` -0.5) over the columns in
    ``cols_sorted``, in place, and the gather of ``next_cols_sorted``
    from the updated table.  ``accum`` and ``linear`` are float32 of the
    table's shape; the other arguments and the result are as in
    :func:`fused_adam_gather`."""
    name = "fused_ftrl_gather"
    kw = dict(dim=dim, fold=fold, learning_rate=learning_rate, l1=l1, l2=l2,
              loss_scale=loss_scale)
    if on_cpu(name, table, accum, linear, cols_sorted, grads_aug,
              next_cols_sorted):
        return fused_ftrl_gather_plain(table, accum, linear, cols_sorted,
                                       grads_aug, next_cols_sorted, **kw)
    check_args(name, table, {"accum": accum, "linear": linear}, cols_sorted,
               grads_aug, dim, fold)
    require(accum.dtype == torch.float32 and linear.dtype == torch.float32,
            name, "accum and linear must be float32")
    rows = _check_next(name, table, next_cols_sorted)
    dp, vc = table.shape
    fn = _build.kernel_fn("mr_fused_ftrl_gather", _FTRL_ARGS)
    rc = fn(table.data_ptr(), int(table.dtype == torch.bfloat16),
            accum.data_ptr(), linear.data_ptr(), vc, dp,
            cols_sorted.data_ptr(), grads_aug.data_ptr(), cols_sorted.shape[0],
            fold, learning_rate, l1, 2.0 * l2, 1.0 / loss_scale,
            next_cols_sorted.data_ptr(), next_cols_sorted.shape[0],
            rows.data_ptr(), _build.stream_of(table))
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return table, accum, linear, rows
