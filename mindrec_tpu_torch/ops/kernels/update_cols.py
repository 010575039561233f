"""Lazy LazyAdam / FTRL updates of the touched columns of feature-major
tables.

Counterpart of ``mindrec_tpu/ops/pallas/stream_update.py``
(``streamed_adam_cols`` / ``streamed_ftrl_cols``, with its
``make_aug_grads`` and touch expansion); the kernels are in
``csrc/update_cols.cu`` (see its header for the design and bound).

Storage is ``[Dp, Vc]``; ``cols`` are the sorted storage columns of the
unique slots (``uq // fold``, sentinel-padded).  The kernels
(:func:`adam_cols_from_sums`, :func:`ftrl_cols_from_sums`) take the
summed gradients where the segment sum left them: ``grads`` ``[Dp, U]``
(still multiplied by the loss scale) with any two strides (the transposed
view of the segment sum's row-major ``[U, width]`` rows at the table's
lane offset, or a contiguous ``[Dp, U]``), the fold sub-rows ``sub`` and
an optional ``gate``, and make the touch themselves.  What they stand for
is the touch-augmented ``grads_aug`` ``[Dp + 8, U]`` (:func:`aug_from_sums`:
the gradients over 8 touch rows, :func:`make_aug_grads`, times the gate),
which the plain versions (:func:`adam_cols_plain`, :func:`ftrl_cols_plain`)
and the fused update + gather (``fused.py``) take.

Slots that share a column are summed.  Touch rules, exactly as the
reference: fold 1 - touch row 0 gates every sublane; fold 8 (``emb_dim``
1) - touch row ``p`` gates sublane ``p``; touch comes from the touch rows,
never from the gradient; columns outside the table are skipped.

The functions update ``table`` and its state **in place** (the reference
kernels alias their inputs to their outputs) and return them.
"""

from __future__ import annotations

import ctypes

import torch

from mindrec_tpu_torch.ops.kernels import (
    LAUNCHES, _build, on_cpu, require, require_contiguous,
)
from mindrec_tpu_torch.train.optim import adam_math, ftrl_math

AUG = 8  # touch rows under the gradient rows
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# the sums' pointer, two strides, sub, gate and gate step
_SUMS_IN = [_P, _L, _L, _P, _P, _I]
_ADAM_SUMS_ARGS = [_P, _I, _P, _P, _I, _L, _I, _P, *_SUMS_IN, _I, _I, _P,
                   _F, _F, _F, _F, _F, _F, _P]
_FTRL_SUMS_ARGS = [_P, _I, _P, _P, _L, _I, _P, *_SUMS_IN, _I, _I, _F, _F, _F,
                   _F, _P]
FLOATS = (torch.float32, torch.bfloat16)


def make_aug_grads(grads_t: torch.Tensor, sub: torch.Tensor | None) -> torch.Tensor:
    """[Dp, N] gradients -> [Dp + 8, N] with the touch rows under them.

    ``sub``: per-slot fold sub-row (``id % fold``), or None for an
    unfolded table (touch row 0 is 1 everywhere)."""
    dp, n = grads_t.shape
    r = torch.arange(AUG, device=grads_t.device)[:, None]
    if sub is None:
        touch = (r == 0).expand(AUG, n)
    else:
        touch = r == sub.reshape(1, -1)
    return torch.cat([grads_t, touch.to(grads_t.dtype)])


def aug_from_sums(grads: torch.Tensor, sub: torch.Tensor | None,
                  gate: torch.Tensor | None) -> torch.Tensor:
    """The ``grads_aug`` [Dp + 8, U] that the ``*_from_sums`` entries
    stand for: :func:`make_aug_grads` of ``grads`` and ``sub``, the touch
    rows multiplied by ``gate`` ([U] or one value; None: no gate)."""
    g_aug = make_aug_grads(grads, sub)
    if gate is None:
        return g_aug
    return torch.cat([g_aug[:-AUG], g_aug[-AUG:] * gate.reshape(1, -1)])


def expand_touch(touch: torch.Tensor, dp: int, dim: int, fold: int) -> torch.Tensor:
    """[8, T] summed touch rows -> [Dp, T] bool mask of updated elements."""
    if fold == 1:
        return (touch[0:1] > 0.0).expand(dp, touch.shape[1])
    if dim == 1:
        return touch[:fold] > 0.0
    raise NotImplementedError("fold > 1 requires emb_dim == 1")


def _run_sums(cols: torch.Tensor, grads_aug: torch.Tensor, vc: int):
    """(columns [R] long, summed grads_aug [Dp + 8, R] f32) of the runs
    of equal in-table columns, each summed in slot order (the kernels'
    order)."""
    ok = (cols >= 0) & (cols < vc)
    c = cols[ok].long()
    g = grads_aug[:, ok].float()
    if c.numel() == 0:
        return c, g[:, :0]
    start = torch.ones_like(c, dtype=torch.bool)
    start[1:] = c[1:] != c[:-1]
    first = torch.nonzero(start).flatten()
    length = torch.diff(first, append=first.new_tensor([c.numel()]))
    acc = g[:, first].clone()
    for k in range(1, int(length.max())):
        more = length > k
        acc[:, more] += g[:, first[more] + k]
    return c[first], acc


def check_args(name, table, states, cols, grads_aug, dim, fold):
    dp = _check_table(name, table, states, cols, dim, fold)
    require(grads_aug.shape == (dp + AUG, cols.shape[0])
            and grads_aug.dtype == torch.float32, name,
            f"grads_aug must be [Dp + 8, U] float32, got "
            f"{tuple(grads_aug.shape)} {grads_aug.dtype}")
    require_contiguous(name, grads_aug=grads_aug)


def _check_table(name, table, states, cols, dim, fold) -> int:
    require(table.dim() == 2 and table.dtype in FLOATS, name,
            f"table [Dp, Vc] float expected, got {tuple(table.shape)} "
            f"{table.dtype}")
    dp, _vc = table.shape
    for k, s in states.items():
        require(s.shape == table.shape, name, f"{k} shape {tuple(s.shape)}")
    n = cols.shape[0]
    require(cols.shape == (n,) and cols.dtype == torch.int32, name,
            "cols must be [U] int32")
    require(fold == 1 or (dim == 1 and dp <= fold <= AUG), name,
            f"fold {fold} needs emb_dim 1 and Dp <= fold <= 8")
    require(table.numel() < 2**40 and n < 2**31, name, "sizes out of range")
    require_contiguous(name, table=table, cols=cols, **states)
    return dp


def _check_sums(name, table, cols, grads, sub, gate, fold):
    """The ``*_from_sums`` inputs; -> the kernel's (slot stride, lane
    stride, sub pointer, gate pointer, gate step)."""
    dp, n = table.shape[0], cols.shape[0]
    require(grads.shape == (dp, n) and grads.dtype == torch.float32, name,
            f"grads must be [Dp, U] float32, got {tuple(grads.shape)} "
            f"{grads.dtype}")
    require(min(grads.stride()) >= 0, name, "grads strides must be >= 0")
    require((sub is not None) == (fold > 1), name,
            "sub is given exactly when fold > 1")
    if sub is not None:
        require(sub.shape == (n,) and sub.dtype == torch.int32, name,
                "sub must be [U] int32")
        require_contiguous(name, sub=sub)
    step = 0
    if gate is not None:
        require(gate.dtype == torch.float32 and gate.numel() in (1, n), name,
                f"gate must be float32 of 1 or U elements, got "
                f"{tuple(gate.shape)} {gate.dtype}")
        require_contiguous(name, gate=gate)
        step = int(gate.numel() == n and n > 1)
    return (grads.stride(1), grads.stride(0),
            None if sub is None else sub.data_ptr(),
            None if gate is None else gate.data_ptr(), step)


def adam_cols_plain(table, m, v, cols, grads_aug, lr_t, *, dim, fold=1,
                    b1=0.9, b2=0.999, eps=1e-8, loss_scale=1.0):
    """One LazyAdam step over the touched columns from ``grads_aug``
    [Dp + 8, U], in place, in plain PyTorch (the arithmetic of
    :func:`adam_cols_from_sums`)."""
    dp, vc = table.shape
    c, acc = _run_sums(cols, grads_aug, vc)
    mask = expand_touch(acc[dp:], dp, dim, fold)
    w_old, m_old, v_old = table[:, c], m[:, c], v[:, c]
    w2, m2, v2 = adam_math(acc[:dp], m_old, v_old, w_old, lr_t, b1=b1, b2=b2,
                           eps=eps, inv_scale=1.0 / loss_scale)
    table[:, c] = torch.where(mask, w2.to(table.dtype), w_old)
    m[:, c] = torch.where(mask, m2.to(m.dtype), m_old)
    v[:, c] = torch.where(mask, v2.to(v.dtype), v_old)
    return table, m, v


def ftrl_cols_plain(table, accum, linear, cols, grads_aug, *, dim, fold=1,
                    learning_rate=5e-2, l1=1e-8, l2=1e-8, loss_scale=1.0):
    """One FTRL-proximal step over the touched columns from ``grads_aug``,
    in place, in plain PyTorch (the arithmetic of
    :func:`ftrl_cols_from_sums`)."""
    dp, vc = table.shape
    c, acc = _run_sums(cols, grads_aug, vc)
    mask = expand_touch(acc[dp:], dp, dim, fold)
    w_old, a_old, l_old = table[:, c], accum[:, c], linear[:, c]
    w2, a2, l2_ = ftrl_math(acc[:dp], a_old, l_old, w_old,
                            learning_rate=learning_rate, l1=l1, l2=l2,
                            inv_scale=1.0 / loss_scale)
    table[:, c] = torch.where(mask, w2.to(table.dtype), w_old)
    accum[:, c] = torch.where(mask, a2, a_old)
    linear[:, c] = torch.where(mask, l2_, l_old)
    return table, accum, linear


def adam_cols_from_sums_plain(table, m, v, cols, grads, sub, gate, lr_t, *,
                              dim, fold=1, **kw):
    """Plain PyTorch version of :func:`adam_cols_from_sums`, in place:
    :func:`adam_cols_plain` of :func:`aug_from_sums`."""
    return adam_cols_plain(table, m, v, cols, aug_from_sums(grads, sub, gate),
                           lr_t, dim=dim, fold=fold, **kw)


def ftrl_cols_from_sums_plain(table, accum, linear, cols, grads, sub, gate, *,
                              dim, fold=1, **kw):
    """Plain PyTorch version of :func:`ftrl_cols_from_sums`, in place:
    :func:`ftrl_cols_plain` of :func:`aug_from_sums`."""
    return ftrl_cols_plain(table, accum, linear, cols,
                           aug_from_sums(grads, sub, gate), dim=dim,
                           fold=fold, **kw)


def _launched_in_place(name):
    LAUNCHES[name] += 1
    LAUNCHES["cols_in_place"] += 1


def adam_cols_from_sums(table, m, v, cols, grads, sub, gate, lr_t, *, dim,
                        fold=1, b1=0.9, b2=0.999, eps=1e-8, loss_scale=1.0):
    """One LazyAdam step over the touched columns, in place, from the
    summed gradients where they lie.

    ``table``: [Dp, Vc] float32 or bfloat16; ``m``, ``v``: same shape,
    float32 or bfloat16; ``cols``: [U] int32 sorted; ``grads``: [Dp, U]
    float32 with any strides; ``sub``: [U] int32 fold sub-rows (fold > 1;
    None at fold 1); ``gate``: None or float32 of [U] elements or one (a
    tiny group's presence, the overflow flag or their product); ``lr_t``:
    the bias-corrected rate, a float32 scalar tensor on the table's
    device.  On the CPU: :func:`adam_cols_from_sums_plain`."""
    name = "adam_cols"
    extra = [x for x in (sub, gate) if x is not None]
    kw = dict(dim=dim, fold=fold, b1=b1, b2=b2, eps=eps,
              loss_scale=loss_scale)
    if on_cpu(name, table, m, v, cols, grads, lr_t, *extra):
        return adam_cols_from_sums_plain(table, m, v, cols, grads, sub, gate,
                                         lr_t, **kw)
    _check_table(name, table, {"m": m, "v": v}, cols, dim, fold)
    ins = _check_sums(name, table, cols, grads, sub, gate, fold)
    require(m.dtype == v.dtype and m.dtype in FLOATS, name,
            f"m/v dtype {m.dtype}/{v.dtype}")
    require(lr_t.numel() == 1 and lr_t.dtype == torch.float32, name,
            "lr_t must be one float32")
    dp, vc = table.shape
    fn = _build.kernel_fn("mr_adam_cols_sums", _ADAM_SUMS_ARGS)
    rc = fn(table.data_ptr(), int(table.dtype == torch.bfloat16),
            m.data_ptr(), v.data_ptr(), int(m.dtype == torch.bfloat16), vc, dp,
            cols.data_ptr(), grads.data_ptr(), *ins, cols.shape[0], fold,
            lr_t.data_ptr(), b1, 1.0 - b1, b2, 1.0 - b2, eps, 1.0 / loss_scale,
            _build.stream_of(table))
    _build.check(rc, name)
    _launched_in_place(name)
    return table, m, v


def ftrl_cols_from_sums(table, accum, linear, cols, grads, sub, gate, *, dim,
                        fold=1, learning_rate=5e-2, l1=1e-8, l2=1e-8,
                        loss_scale=1.0):
    """One FTRL-proximal step (``lr_power`` -0.5) over the touched
    columns, in place, from the summed gradients where they lie.
    ``accum`` and ``linear`` are float32 of the table's shape; the other
    arguments are as in :func:`adam_cols_from_sums`."""
    name = "ftrl_cols"
    extra = [x for x in (sub, gate) if x is not None]
    kw = dict(dim=dim, fold=fold, learning_rate=learning_rate, l1=l1, l2=l2,
              loss_scale=loss_scale)
    if on_cpu(name, table, accum, linear, cols, grads, *extra):
        return ftrl_cols_from_sums_plain(table, accum, linear, cols, grads,
                                         sub, gate, **kw)
    _check_table(name, table, {"accum": accum, "linear": linear}, cols, dim,
                 fold)
    ins = _check_sums(name, table, cols, grads, sub, gate, fold)
    require(accum.dtype == torch.float32 and linear.dtype == torch.float32,
            name, "accum and linear must be float32")
    dp, vc = table.shape
    fn = _build.kernel_fn("mr_ftrl_cols_sums", _FTRL_SUMS_ARGS)
    rc = fn(table.data_ptr(), int(table.dtype == torch.bfloat16),
            accum.data_ptr(), linear.data_ptr(), vc, dp, cols.data_ptr(),
            grads.data_ptr(), *ins, cols.shape[0], fold, learning_rate, l1,
            2.0 * l2, 1.0 / loss_scale, _build.stream_of(table))
    _build.check(rc, name)
    _launched_in_place(name)
    return table, accum, linear
