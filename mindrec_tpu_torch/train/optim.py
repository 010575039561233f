"""Optimizers for recommender training: FTRL, Adam/LazyAdam, SGD.

Port of ``mindrec_tpu/train/optim.py``.  Each optimizer is an
:class:`Optimizer` with ``init_leaf(p) -> state``, a dense
``update_leaf(g, state, p) -> (p', state')`` and the sparse updates of
the generic step, ``update_rows(grad_rows, row_ids, state, table)`` and
``update_cols(grad_cols, col_ids, touch, state, table)``; ``kind`` and
``hyper`` expose the rule to the update kernels
(``ops/kernels/update_rows.py``, ``update_cols.py``), whose plain
versions call the same ``adam_math`` / ``ftrl_math`` below, so the
optimizer arithmetic has one implementation.

The sparse updates read and write only the rows (columns) they are
given, **in place**, and return ``(table, state')``.  Elements where
``touch`` is False keep their weight and state (the reference's
``where(touch, new, old)``).  ``live`` (a bool per slot, the real slots
of a padded unique list, a prefix) keeps the fill slots from writing
their own values, so a fill id that is also a live row cannot undo that
row's update (the reference's fault at ``ADVICE.md:3``): each fill slot
repeats a live slot, id, gradient and all, so every duplicate write is
the same value and the scatter stays deterministic, with no host read.  Gradients arrive multiplied by the loss scale and are
divided by it here (reference ``sens`` semantics).

Defaults are the reference's: FTRL lr 5e-2, l1 = l2 = 1e-8, initial
accumulator 1.0, ``lr_power`` -0.5; Adam lr 3.5e-4, eps 1e-8.
``state_dtype`` of Adam is the storage type of m and v (bf16 in the
benchmark recipe); the arithmetic is float32 throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init_leaf: Callable[[torch.Tensor], Any]
    update_leaf: Callable[..., tuple[torch.Tensor, Any]]
    kind: str = "custom"
    hyper: dict = dataclasses.field(default_factory=dict)
    # update_rows(grad_rows [U, D], row_ids [U], state, table, touch=None,
    #             live=None); update_cols(grad_cols [Dp, U], col_ids [U],
    #             touch [Dp, U] bool, state, table, live=None)
    update_rows: Callable[..., tuple[torch.Tensor, Any]] | None = None
    update_cols: Callable[..., tuple[torch.Tensor, Any]] | None = None


def live_sources(live: torch.Tensor) -> torch.Tensor:
    """For slots whose live ones are a prefix: each slot's source slot,
    itself if live, else live slot ``i % count`` (slot 0 when none is
    live).  A fill slot that takes its source's id, gradient and touch
    computes and writes exactly its source's value, so the duplicate
    writes agree (the scatter stays deterministic) and spread over the
    live rows rather than all landing on one."""
    n = live.shape[0]
    slots = torch.arange(n, device=live.device)
    count = live.sum().clamp(min=1)
    return torch.where(live, slots, torch.remainder(slots, count))


def _masked_update(axis, rule, grads, ids, touch, live, table, bufs):
    """Apply ``rule(grads, table_old, *bufs_old) -> (table', *bufs')``
    to the rows (``axis`` 0) or columns (``axis`` 1) ``ids`` of
    ``table`` and of its state tensors ``bufs``, in place, keeping the
    elements where ``touch`` is False.  ``live`` marks the real slots, a
    prefix; a fill slot repeats a live slot (:func:`live_sources`)."""
    if live is not None:
        src = live_sources(live)
        ids = ids.index_select(0, src)
        grads = grads.index_select(axis, src)
        if touch is not None and touch.shape[axis] == src.shape[0]:
            touch = touch.index_select(axis, src)
    idx = ids.long()
    targets = (table, *bufs)
    olds = [t.index_select(axis, idx) for t in targets]
    news = rule(grads, *olds)
    for t, old, new in zip(targets, olds, news):
        val = new.to(t.dtype)
        if touch is not None:
            val = torch.where(touch, val, old)
        t.index_copy_(axis, idx, val)


def ftrl_math(g, accum, linear, w, *, learning_rate, l1, l2, inv_scale,
              lr_power=-0.5):
    """One FTRL-proximal step in float32 -> (w', accum', linear')."""
    g = g.float() * inv_scale
    w32 = w.float()
    accum_new = accum.float() + g * g
    if lr_power == -0.5:
        sq_new, sq_old = torch.sqrt(accum_new), torch.sqrt(accum.float())
    else:
        sq_new = torch.pow(accum_new, -lr_power)
        sq_old = torch.pow(accum.float(), -lr_power)
    # a tensor divisor: on the card PyTorch turns division by a Python
    # number into a product with its float32 reciprocal, which rounds
    # apart from the kernels' division (and the CPU's)
    lr = torch.full((), learning_rate, dtype=torch.float32, device=g.device)
    sigma = (sq_new - sq_old) / lr
    linear_new = linear.float() + g - sigma * w32
    quadratic = sq_new / lr + 2.0 * l2
    w_new = torch.where(
        torch.abs(linear_new) > l1,
        (torch.sign(linear_new) * l1 - linear_new) / quadratic,
        torch.zeros_like(linear_new),
    )
    return w_new, accum_new, linear_new


def adam_math(g, m, v, w, lr_t, *, b1, b2, eps, inv_scale):
    """One Adam step in float32 -> (w', m', v').  ``lr_t`` is the
    bias-corrected rate (a float32 tensor)."""
    g = g.float() * inv_scale
    m_new = b1 * m.float() + (1.0 - b1) * g
    v_new = b2 * v.float() + (1.0 - b2) * g * g
    w_new = w.float() - lr_t * m_new / (torch.sqrt(v_new) + eps)
    return w_new, m_new, v_new


def adam_lr_t(step: torch.Tensor, *, learning_rate, b1, b2) -> torch.Tensor:
    """Bias-corrected Adam rate for the (already incremented) ``step``,
    a float32 tensor on the step's device (no host sync)."""
    s = step.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=s.device)
    return (
        learning_rate * torch.sqrt(one - torch.pow(b2, s))
        / (one - torch.pow(b1, s))
    )


def ftrl(
    learning_rate: float = 5e-2,
    l1: float = 1e-8,
    l2: float = 1e-8,
    initial_accum: float = 1.0,
    lr_power: float = -0.5,
    loss_scale: float = 1.0,
) -> Optimizer:
    inv_scale = 1.0 / loss_scale

    def init_leaf(p):
        return {
            "accum": torch.full_like(p, initial_accum, dtype=torch.float32),
            "linear": torch.zeros_like(p, dtype=torch.float32),
        }

    def update_leaf(g, state, p):
        w, a, lin = ftrl_math(
            g, state["accum"], state["linear"], p,
            learning_rate=learning_rate, l1=l1, l2=l2, inv_scale=inv_scale,
            lr_power=lr_power,
        )
        return w.to(p.dtype), {"accum": a, "linear": lin}

    def rule(g, w, a, lin):
        return ftrl_math(g, a, lin, w, learning_rate=learning_rate, l1=l1,
                         l2=l2, inv_scale=inv_scale, lr_power=lr_power)

    def update_rows(grad_rows, row_ids, state, table, touch=None, live=None):
        _masked_update(0, rule, grad_rows, row_ids, touch, live, table,
                       (state["accum"], state["linear"]))
        return table, state

    def update_cols(grad_cols, col_ids, touch, state, table, live=None):
        _masked_update(1, rule, grad_cols, col_ids, touch, live, table,
                       (state["accum"], state["linear"]))
        return table, state

    return Optimizer(
        init_leaf, update_leaf, kind="ftrl", update_rows=update_rows,
        update_cols=update_cols,
        hyper={
            "learning_rate": learning_rate, "l1": l1, "l2": l2,
            "initial_accum": initial_accum, "lr_power": lr_power,
            "loss_scale": loss_scale,
        },
    )


def adam(
    learning_rate: float = 3.5e-4,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    loss_scale: float = 1.0,
    state_dtype: torch.dtype = torch.float32,
) -> Optimizer:
    """Adam with a per-leaf step counter; on row-sparse tables the
    update kernels give LazyAdam semantics (only touched rows' moments
    advance, bias correction uses the table's step)."""
    inv_scale = 1.0 / loss_scale

    def init_leaf(p):
        return {
            "m": torch.zeros_like(p, dtype=state_dtype),
            "v": torch.zeros_like(p, dtype=state_dtype),
            "step": torch.zeros((), dtype=torch.int32, device=p.device),
        }

    def update_leaf(g, state, p):
        step = state["step"] + 1
        lr_t = adam_lr_t(step, learning_rate=learning_rate, b1=b1, b2=b2)
        w, m, v = adam_math(g, state["m"], state["v"], p, lr_t, b1=b1, b2=b2,
                            eps=eps, inv_scale=inv_scale)
        return w.to(p.dtype), {"m": m.to(state_dtype), "v": v.to(state_dtype),
                               "step": step}

    def sparse_update(axis, grads, ids, touch, live, state, table):
        step = state["step"] + 1
        lr_t = adam_lr_t(step, learning_rate=learning_rate, b1=b1, b2=b2)

        def rule(g, w, m, v):
            return adam_math(g, m, v, w, lr_t, b1=b1, b2=b2, eps=eps,
                             inv_scale=inv_scale)

        _masked_update(axis, rule, grads, ids, touch, live, table,
                       (state["m"], state["v"]))
        return table, {"m": state["m"], "v": state["v"], "step": step}

    def update_rows(grad_rows, row_ids, state, table, touch=None, live=None):
        return sparse_update(0, grad_rows, row_ids, touch, live, state, table)

    def update_cols(grad_cols, col_ids, touch, state, table, live=None):
        return sparse_update(1, grad_cols, col_ids, touch, live, state, table)

    return Optimizer(
        init_leaf, update_leaf, kind="adam", update_rows=update_rows,
        update_cols=update_cols,
        hyper={
            "learning_rate": learning_rate, "b1": b1, "b2": b2, "eps": eps,
            "loss_scale": loss_scale, "state_dtype": state_dtype,
        },
    )


def lazy_adam(**kw) -> Optimizer:
    """Alias: ``adam`` is already lazy on row-sparse tables."""
    return adam(**kw)


def sgd(learning_rate: float = 1e-2, loss_scale: float = 1.0) -> Optimizer:
    inv_scale = 1.0 / loss_scale

    def init_leaf(p):
        return ()

    def update_leaf(g, state, p):
        new = p.float() - learning_rate * g.float() * inv_scale
        return new.to(p.dtype), state

    def rule(g, w):
        return (w.float() - learning_rate * g.float() * inv_scale,)

    def update_rows(grad_rows, row_ids, state, table, touch=None, live=None):
        _masked_update(0, rule, grad_rows, row_ids, touch, live, table, ())
        return table, state

    def update_cols(grad_cols, col_ids, touch, state, table, live=None):
        _masked_update(1, rule, grad_cols, col_ids, touch, live, table, ())
        return table, state

    return Optimizer(
        init_leaf, update_leaf, kind="sgd", update_rows=update_rows,
        update_cols=update_cols,
        hyper={"learning_rate": learning_rate, "loss_scale": loss_scale},
    )
