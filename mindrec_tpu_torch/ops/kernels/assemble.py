"""The multitable model's feature assembly: the MLP's bf16 input and the
wide tables' logit sum from each id group's batch-order rows, and each
group's gradient rows, written once.

Replaces no Pallas kernel (the JAX reference leaves the assembly to XLA's
fusion, ``mindrec_tpu/models/multitable.py:274-283``); the kernels are in
``csrc/assemble.cu`` (see its header for the design and bound).

A group (:class:`AsmGroup`) holds ``N = B * F`` positions in batch order
(sample-major), each a row of ``width`` bf16 lanes in which the group's
deep table takes ``[deep_off, deep_off + deep_dim)`` and its folded wide
table (``emb_dim`` 1) ``[wide_off, wide_off + fold)``, the position's
weight at sublane ``id % fold``.  ``deep_in`` ``[B, cont + ...]`` bf16 is
the continuous values, then per group in order either its ``F``
positions' deep lanes side by side or, for a pooled group (``fields``:
the lengths of its multi-hot fields, which sum to ``F``; ``masks``: one
``[B, L_k]`` float32 mask each), each field's masked rows averaged over
the full length ``L_k``.  ``wide`` ``[B, 1]`` float32 sums every
position's wide weight (times its mask in a pooled group).

:func:`assemble` is differentiable in the groups' rows.  CPU tensors take
:func:`assemble_plain`; CUDA tensors launch the kernels (``LAUNCHES``
``assemble_fwd`` and ``assemble_bwd``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from mindrec_tpu_torch.ops.kernels import (
    LAUNCHES, _build, on_cpu, require, require_contiguous,
)

_FWD, _BWD = "assemble_fwd", "assemble_bwd"
_MAX_GROUPS, _MAX_FIELDS = 4, 8  # kMaxGroups, kMaxFields in csrc/assemble.cu
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_PLAN = [_I, _L, _I, _I, _P, _P, _P]  # ng, B, out_w, cont_dim, ptrs, ints, invs
_FWD_ARGS = [*_PLAN, _P, _P, _P, _P]
_BWD_ARGS = [*_PLAN, _P, _P, _P]


class AsmGroup(NamedTuple):
    """One id group as :func:`assemble` reads it."""

    rows: torch.Tensor  # [B * F, width] bf16, batch order
    ids: torch.Tensor  # [B * F] int32: the wide sublane is id % fold
    deep_off: int
    deep_dim: int
    wide_off: int
    fold: int
    fields: tuple = ()  # pooled: the fields' lengths; () copies the F rows
    masks: tuple = ()  # pooled: [B, L_k] float32 per field


def _inv(n: int) -> float:
    return float(np.float32(1.0 / n))


def assemble_plain(groups, cont: torch.Tensor):
    """Plain PyTorch version of :func:`assemble` (autograd gives its
    backward): the model's arithmetic, bf16 mask products, float32 sums,
    one rounding to bf16 at the end."""
    B = cont.shape[0]
    parts, wides = [cont.float()], []
    for g in groups:
        n = g.rows.shape[0]
        deep = g.rows[:, g.deep_off: g.deep_off + g.deep_dim]
        lane = torch.arange(g.fold, device=g.ids.device)
        own = (lane[None, :] == torch.remainder(g.ids, g.fold)[:, None])
        w = g.rows[:, g.wide_off: g.wide_off + g.fold] * own.to(g.rows.dtype)
        if not g.fields:
            parts.append(deep.reshape(B, -1).float())
            wides.append(torch.sum(w.reshape(B, n // B, -1), dim=(1, 2),
                                   dtype=torch.float32))
            continue
        mask = torch.cat(list(g.masks), dim=1).to(g.rows.dtype)  # [B, F]
        masked = deep.reshape(B, n // B, -1) * mask[:, :, None]
        start = 0
        for L in g.fields:
            parts.append(masked[:, start: start + L].float().sum(dim=1)
                         * _inv(L))
            start += L
        wsum = torch.sum(w, dim=-1).reshape(B, -1)
        wides.append(torch.sum(wsum * mask, dim=1, dtype=torch.float32))
    wide = wides[0]
    for x in wides[1:]:
        wide = wide + x
    return torch.cat(parts, dim=1).to(torch.bfloat16), wide[:, None]


def _check(groups, cont):
    require(0 < len(groups) <= _MAX_GROUPS, _FWD,
            f"1 to {_MAX_GROUPS} groups, got {len(groups)}")
    require(cont.dim() == 2, _FWD, "cont must be [B, C]")
    B = cont.shape[0]
    for i, g in enumerate(groups):
        n = g.rows.shape[0]
        require(g.rows.dim() == 2 and n % B == 0 and g.ids.shape == (n,),
                _FWD, f"group {i}: rows [B * F, width] and ids [B * F] "
                f"expected, got {tuple(g.rows.shape)}, {tuple(g.ids.shape)}")
        require(len(g.fields) <= _MAX_FIELDS
                and len(g.masks) == len(g.fields)
                and (not g.fields or sum(g.fields) == n // B), _FWD,
                f"group {i}: fields {g.fields} must sum to F = {n // B}, "
                f"one mask each, at most {_MAX_FIELDS}")
        for L, m in zip(g.fields, g.masks):
            require(m.shape == (B, L), _FWD,
                    f"group {i}: mask {tuple(m.shape)} for a field of {L}")


def _plan(groups, cont, grads=None):
    """The flat arrays of ``mr_assemble_fwd`` / ``mr_assemble_bwd``."""
    ptrs = np.zeros((len(groups), 3 + _MAX_FIELDS), np.int64)
    ints = np.zeros((len(groups), 8 + _MAX_FIELDS), np.int32)
    invs = np.zeros((len(groups), _MAX_FIELDS), np.float32)
    for i, g in enumerate(groups):
        ptrs[i, :3] = (g.rows.data_ptr(), g.ids.data_ptr(),
                       0 if grads is None else grads[i].data_ptr())
        ptrs[i, 3: 3 + len(g.masks)] = [m.data_ptr() for m in g.masks]
        ints[i, :7] = (g.rows.shape[1], g.rows.shape[0] // cont.shape[0],
                       g.deep_off, g.deep_dim, g.wide_off, g.fold,
                       len(g.fields))
        ints[i, 8: 8 + len(g.fields)] = g.fields
        invs[i, : len(g.fields)] = [_inv(L) for L in g.fields]
    return (len(groups), cont.shape[0], _width(groups, *cont.shape),
            cont.shape[1], ptrs.ctypes.data, ints.ctypes.data,
            invs.ctypes.data), (ptrs, ints, invs)


def _width(groups, B: int, cont_dim: int) -> int:
    """Columns of ``deep_in``."""
    return cont_dim + sum(
        g.deep_dim * (len(g.fields) or g.rows.shape[0] // B) for g in groups)


def assemble_forward(groups, cont: torch.Tensor):
    """The forward kernel alone (checked CUDA tensors, no autograd) ->
    (``deep_in``, ``wide``)."""
    args, keep = _plan(groups, cont)
    deep_in = torch.empty((cont.shape[0], args[2]), dtype=torch.bfloat16,
                          device=cont.device)
    wide = torch.empty((cont.shape[0], 1), dtype=torch.float32,
                       device=cont.device)
    fn = _build.kernel_fn("mr_assemble_fwd", _FWD_ARGS)
    rc = fn(*args, cont.data_ptr(), deep_in.data_ptr(), wide.data_ptr(),
            _build.stream_of(cont))
    del keep  # the plan's arrays lived through the call
    _build.check(rc, _FWD)
    LAUNCHES[_FWD] += 1
    return deep_in, wide


def assemble_backward(groups, cont: torch.Tensor, d_deep: torch.Tensor,
                      d_wide: torch.Tensor, out=None) -> list:
    """The backward kernel alone: each group's gradient rows, written
    whole, from ``d_deep`` (``deep_in``'s shape, bf16) and ``d_wide``
    [B, 1] float32,
    into ``out`` (one tensor shaped as each group's rows) or new tensors.
    Only the shapes of ``cont`` and of the groups' rows are read."""
    d_deep = d_deep.to(torch.bfloat16).contiguous()
    d_wide = d_wide.float().contiguous()
    require(d_deep.shape == (cont.shape[0], _width(groups, *cont.shape))
            and d_wide.numel() == cont.shape[0], _BWD,
            f"d_deep {tuple(d_deep.shape)}, d_wide {tuple(d_wide.shape)}")
    grads = out or [torch.empty_like(g.rows) for g in groups]
    args, keep = _plan(groups, cont, grads)
    fn = _build.kernel_fn("mr_assemble_bwd", _BWD_ARGS)
    rc = fn(*args, d_deep.data_ptr(), d_wide.data_ptr(),
            _build.stream_of(d_deep))
    del keep
    _build.check(rc, _BWD)
    LAUNCHES[_BWD] += 1
    return grads


class _Assemble(torch.autograd.Function):
    @staticmethod
    def forward(ctx, groups, cont, *rows):
        # the backward reads ids, masks and the layout, never the rows
        ctx.save_for_backward(*(t for g in groups for t in (g.ids, *g.masks)))
        ctx.layout = [(g.rows.shape, g.deep_off, g.deep_dim, g.wide_off,
                       g.fold, g.fields) for g in groups]
        ctx.cont_shape = cont.shape
        return assemble_forward(groups, cont)

    @staticmethod
    def backward(ctx, d_deep, d_wide):
        saved, groups = list(ctx.saved_tensors), []
        for shape, *lay, fields in ctx.layout:
            ids, masks = saved[0], tuple(saved[1: 1 + len(fields)])
            del saved[: 1 + len(fields)]
            # the gradient rows, handed over as the rows they shape
            grad = torch.empty(shape, dtype=torch.bfloat16, device=ids.device)
            groups.append(AsmGroup(grad, ids, *lay, fields, masks))
        cont = torch.empty(ctx.cont_shape, device="meta")
        return (None, None, *assemble_backward(
            groups, cont, d_deep, d_wide, out=[g.rows for g in groups]))


def assemble(groups, cont: torch.Tensor):
    """-> (``deep_in`` [B, C + ...] bf16, ``wide`` [B, 1] float32) of the
    groups (module docstring) and the continuous values ``cont`` [B, C]
    float32; differentiable in each group's ``rows``.

    CPU tensors take :func:`assemble_plain`; CUDA tensors launch the
    forward kernel, and autograd the backward one, which writes each
    group's gradient rows whole (zeros outside the tables' lanes and in
    the wide sublanes a position does not own)."""
    groups = list(groups)
    _check(groups, cont)
    tensors = [cont] + [t for g in groups for t in (g.rows, g.ids, *g.masks)]
    if on_cpu(_FWD, *tensors):
        return assemble_plain(groups, cont)
    require(cont.dtype == torch.float32, _FWD, "cont must be float32")
    for i, g in enumerate(groups):
        require(g.rows.dtype == torch.bfloat16, _FWD,
                f"group {i}: rows must be bfloat16")
        require(g.ids.dtype == torch.int32, _FWD, f"group {i}: ids must be int32")
        require(all(m.dtype == torch.float32 for m in g.masks), _FWD,
                f"group {i}: masks must be float32")
        require(g.deep_off % 8 == 0 and g.deep_dim % 8 == 0
                and g.wide_off % 8 == 0 and 0 < g.fold <= 8
                and g.rows.shape[1] % 8 == 0, _FWD,
                f"group {i}: lanes must start on multiples of 8 (deep "
                f"{g.deep_off}+{g.deep_dim}, wide {g.wide_off}+{g.fold}, "
                f"width {g.rows.shape[1]})")
        require_contiguous(_FWD, rows=g.rows, ids=g.ids,
                           **{f"mask{k}": m for k, m in enumerate(g.masks)})
    require_contiguous(_FWD, cont=cont)
    return _Assemble.apply(groups, cont, *(g.rows for g in groups))
