"""Sparse CTR train step (one device, row_packed tables) and eval step.

Port of the ``use_pallas and row_layout`` branch of
``mindrec_tpu/train/step.py:make_train_step`` for one id group of
unsharded, non-tiny, row_packed tables, with its tail ``_finish_sparse``
and ``_packed_table_update``.  One step, in order:

1. sort metadata (``perm``, ``uq_ids``, ``uidx``, ``uidx_sorted``) from
   host prep (:func:`make_batch_sort`) or from a device sort;
2. the unique ids, cut or padded with the sentinel ``2**31 - 2`` to the
   static bucket ``ub``, gather their rows from packed storage into one
   ``[ub, 128]`` float32 buffer, the tables side by side in its lanes;
3. the buffer expands to batch order (``buf[uidx]``, in ``matmul_dtype``)
   and the model runs forward and backward from it;
4. the per-position gradients move to sorted order (``g[perm]``);
5. ``segsum_sorted`` sums duplicates per unique id (kernel);
6. ``adam_rows`` / ``ftrl_rows`` update only the touched rows (kernels);
   the dense parameters take their optimizer's dense update.

The step updates the tables and their optimizer state **in place** and
returns a new :class:`TrainState` that shares them: the state passed in
must not be used again (the reference donates it).  With
``use_kernels=False`` the step calls the kernels' plain versions
directly on any device (the reference for the kernels on the card).
Every other branch of the reference (dense models, multi-group,
tiny-vocab, feature-major, sharded, ``row_layout=False``) raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from mindrec_tpu_torch.ops.embedding import packed_expand, packed_gather
from mindrec_tpu_torch.ops.kernels.segsum import segsum_sorted, segsum_sorted_plain
from mindrec_tpu_torch.ops.kernels.update_rows import (
    adam_rows, adam_rows_plain, ftrl_rows, ftrl_rows_plain,
)
from mindrec_tpu_torch.train.optim import Optimizer, adam_lr_t

SENTINEL = 2**31 - 2  # padded unique slot: past every vocab


# ---------------------------------------------------------------------------
# flat path-keyed view of a nested parameter dict
# ---------------------------------------------------------------------------


def _leaves(node, path=()):
    """(path, leaf) pairs in the reference's order: dict keys sorted,
    sequences by index."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _leaves(node[k], path + (k,))
    elif isinstance(node, (list, tuple)):
        for i, x in enumerate(node):
            yield from _leaves(x, path + (i,))
    else:
        yield path, node


def _path_key(path) -> str:
    return "/".join(str(p) for p in path)


def map_leaves(fn, node, path=()):
    """Rebuild a nested dict/list with ``fn(key, leaf)`` at each leaf."""
    if isinstance(node, dict):
        return {k: map_leaves(fn, v, path + (k,)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(
            map_leaves(fn, x, path + (i,)) for i, x in enumerate(node)
        )
    return fn(_path_key(path), node)


def flatten_params(params) -> list[tuple[str, Any]]:
    """-> ordered list of ("deep/mlp/0/w"-style key, leaf)."""
    return [(_path_key(p), leaf) for p, leaf in _leaves(params)]


def param_keys(params) -> list[str]:
    return [k for k, _ in flatten_params(params)]


def is_wide_key(key: str) -> bool:
    return "wide" in key


# ---------------------------------------------------------------------------
# train state
# ---------------------------------------------------------------------------


class TrainState(NamedTuple):
    params: dict  # nested model parameters
    opt_w: dict  # path key -> optimizer state (wide side)
    opt_d: dict  # path key -> optimizer state (deep side)
    step: torch.Tensor  # int32 scalar on the device


def init_train_state(model, seed: int, opt_w: Optimizer, opt_d: Optimizer,
                     device="cuda") -> TrainState:
    """Random parameters from ``torch.Generator(device).manual_seed(seed)``
    and fresh optimizer state, all on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init(gen, device=device)
    flat = flatten_params(params)
    return TrainState(
        params=params,
        opt_w={k: opt_w.init_leaf(p) for k, p in flat if is_wide_key(k)},
        opt_d={k: opt_d.init_leaf(p) for k, p in flat if not is_wide_key(k)},
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# row_packed table update
# ---------------------------------------------------------------------------


def _packed_table_update(opt: Optimizer, g_cols, rows_sorted, sub_sorted,
                         leaf_state, table, spec, present=None,
                         use_kernels=True):
    """Row-sparse optimizer update of a row_packed table, in place.

    ``g_cols``: [dim, U] summed unique gradients (segsum layout);
    ``rows_sorted`` / ``sub_sorted``: ``uq // pack`` / ``uq % pack`` of
    the padded sorted unique ids (int32); ``present``: optional [U] gate.
    Returns (table, new leaf state)."""
    h = opt.hyper
    g_sel = g_cols.T.contiguous()  # [U, dim]
    kw = dict(dim=spec.emb_dim, pack=spec.pack, present=present,
              loss_scale=h["loss_scale"])
    if opt.kind == "adam":
        step = leaf_state["step"] + 1
        lr_t = adam_lr_t(step, learning_rate=h["learning_rate"], b1=h["b1"],
                         b2=h["b2"])
        fn = adam_rows if use_kernels else adam_rows_plain
        fn(table, leaf_state["m"], leaf_state["v"], rows_sorted, sub_sorted,
           g_sel, lr_t, b1=h["b1"], b2=h["b2"], eps=h["eps"], **kw)
        return table, {"m": leaf_state["m"], "v": leaf_state["v"],
                       "step": step}
    if opt.kind == "ftrl":
        if h["lr_power"] != -0.5:
            raise NotImplementedError("row updates fix lr_power at -0.5")
        fn = ftrl_rows if use_kernels else ftrl_rows_plain
        fn(table, leaf_state["accum"], leaf_state["linear"], rows_sorted,
           sub_sorted, g_sel, learning_rate=h["learning_rate"], l1=h["l1"],
           l2=h["l2"], **kw)
        return table, leaf_state
    if opt.kind == "sgd":
        delta = packed_expand(
            spec, (-h["learning_rate"] / h["loss_scale"]) * g_sel.float(),
            sub_sorted,
        )
        if present is not None:
            delta = delta * present.to(delta.dtype).reshape(-1, 1)
        ok = (rows_sorted >= 0) & (rows_sorted < table.shape[0])
        table.index_add_(0, rows_sorted[ok].long(), delta[ok].to(table.dtype))
        return table, leaf_state
    raise ValueError(f"row_packed update supports ftrl/adam/sgd "
                     f"(kind={opt.kind})")


# ---------------------------------------------------------------------------
# step builder
# ---------------------------------------------------------------------------


def _get(params, path):
    node = params
    for h in path:
        node = node[h]
    return node


def _supported(model, sparse, row_layout, tiny_vocab):
    """Raise NotImplementedError for every branch this port lacks."""
    if not sparse:
        raise NotImplementedError("the dense train step is not ported yet")
    if not row_layout:
        raise NotImplementedError(
            "row_layout=False (feature-major streaming) is not ported yet"
        )
    if getattr(model, "table_groups", None):
        raise NotImplementedError("multi-group models are not ported yet")
    specs = model.table_specs
    for name, (_path, spec) in specs.items():
        if not spec.row_packed:
            raise NotImplementedError(
                f"table {name}: only row_packed tables are ported "
                f"(layout={spec.layout!r}, slice_mode={spec.slice_mode!r})"
            )
        if spec.slice_mode != "none" or spec.target != "device":
            raise NotImplementedError(
                f"table {name}: sharded or host tables are not ported yet"
            )
    bound = max(spec.vocab_size + 9 for _p, spec in specs.values())
    if (bound + 2047) // 2048 * 2048 <= min(tiny_vocab, 2048):
        raise NotImplementedError(
            "tiny-vocab id groups (streamed_segsum_unsorted) are not "
            "ported yet; pass tiny_vocab=0 to sort them instead"
        )


def _sort_meta(batch, flat):
    """-> (perm, uq_ids, uidx, uidx_sorted, uq_len): host-prepared (batch
    keys of :func:`make_batch_sort`) or derived by a device sort."""
    n = flat.numel()
    if "perm" in batch:
        perm = batch["perm"].reshape(-1)
        sorted_ids = batch["sorted_ids"].reshape(-1) if "sorted_ids" in batch else None
        inv = batch["inv"].reshape(-1) if "inv" in batch else None
    else:
        sorted_ids, perm = torch.sort(flat, stable=True)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(n, dtype=perm.dtype, device=perm.device)

    def uidx_of(sorted_ids):
        newv = torch.ones(n, dtype=torch.bool, device=flat.device)
        newv[1:] = sorted_ids[1:] != sorted_ids[:-1]
        return newv, torch.cumsum(newv, 0, dtype=torch.int32) - 1

    if "uq_ids" in batch:
        uq = batch["uq_ids"].reshape(-1)
        uidx_b = batch["uidx"].reshape(-1)
        if "uidx_sorted" in batch:
            uidx_s = batch["uidx_sorted"].reshape(-1)
        elif sorted_ids is None:
            raise ValueError("batch has uq_ids but neither uidx_sorted nor "
                             "sorted_ids to derive it from")
        else:
            uidx_s = uidx_of(sorted_ids)[1]
        return perm, uq, uidx_b, uidx_s, uq.numel()
    if sorted_ids is None or inv is None:
        raise ValueError("batch prep must supply uq_ids/uidx/uidx_sorted "
                         "when it omits sorted_ids/inv")
    newv, uidx_s = uidx_of(sorted_ids)
    uq = torch.sort(torch.where(newv, sorted_ids,
                                torch.full_like(sorted_ids, SENTINEL))).values
    return perm, uq, uidx_s[inv], uidx_s, n


def make_train_step(
    model,
    opt_w: Optimizer,
    opt_d: Optimizer,
    sparse: bool | None = None,
    loss_scale: float | None = None,
    use_kernels: bool = True,
    check_overflow: bool = False,
    matmul_dtype: torch.dtype = torch.bfloat16,
    row_layout: bool = True,
    unique_bucket: int | None = None,
    tiny_vocab: int = 2048,
):
    """Build ``step(state, batch) -> (state, (loss_w, loss_d))``.

    ``batch``: tensors on the state's device, ``ids [B,F] int32``,
    ``wts [B,F] f32``, ``label [B,1] f32``, plus optionally the host-prep
    keys of :func:`make_batch_sort`.  ``unique_bucket``: static bound on
    distinct ids per batch (rounded up to 2048); defaults to the length
    of the batch's ``uq_ids`` (host prep) or the lossless ``B*F``.
    ``matmul_dtype``: type of the expanded rows and of their gradients
    (bf16 in production, as the reference).  ``check_overflow``: skip
    the update (but advance the step) when a gradient is not finite;
    this reads one flag on the host each step."""
    cfg = model.config
    if sparse is None:
        sparse = bool(getattr(cfg, "sparse", False))
    _supported(model, sparse, row_layout, tiny_vocab)
    sens = float(loss_scale if loss_scale is not None
                 else getattr(cfg, "loss_scale", 1.0))
    table_specs = model.table_specs
    table_keys = {"/".join(path): (name, path, spec)
                  for name, (path, spec) in table_specs.items()}
    # lane layout of the unique row buffer: tables side by side
    offs, off = {}, 0
    for name, (_path, spec) in table_specs.items():
        offs[name] = off
        off += spec.emb_dim
    width = max(128, -(-off // 128) * 128)
    segsum = segsum_sorted if use_kernels else segsum_sorted_plain

    def step(state: TrainState, batch):
        params = state.params
        ids = batch["ids"]
        B, F = int(ids.shape[0]), int(ids.shape[1])
        flat = ids.reshape(-1)
        perm, uq, uidx_b, uidx_s, uq_len = _sort_meta(batch, flat)
        ub = unique_bucket if unique_bucket is not None else uq_len
        ub = (int(ub) + 2047) // 2048 * 2048
        if ub <= uq_len:
            uq_b = uq[:ub]
        else:
            uq_b = torch.cat([uq, uq.new_full((ub - uq_len,), SENTINEL)])
        uq_b = uq_b.to(torch.int32)

        parts, rows_sorted, sub_sorted = [], {}, {}
        for name, (path, spec) in table_specs.items():
            p = spec.pack
            rows_sorted[name] = torch.div(uq_b, p, rounding_mode="floor")
            sub_sorted[name] = torch.remainder(uq_b, p)
            parts.append(packed_gather(spec, _get(params, path), uq_b).float())
        if off < width:
            parts.append(uq_b.new_zeros((ub, width - off), dtype=torch.float32))
        buf = torch.cat(parts, dim=1)  # [ub, width]
        rows_pos = buf.to(matmul_dtype)[uidx_b.long()].requires_grad_(True)

        leaves = {}  # dense parameters, tracked for autograd

        def track(key, leaf):
            if key in table_keys:
                return leaf
            leaves[key] = leaf.detach().requires_grad_(True)
            return leaves[key]

        p_view = map_leaves(track, params)
        rows = {
            name: rows_pos[:, offs[name]: offs[name] + spec.emb_dim]
            .reshape(B, F, spec.emb_dim)
            for name, (_path, spec) in table_specs.items()
        }
        with torch.enable_grad():
            logits = model.apply_rows(p_view, rows, batch["wts"])
            loss_w, loss_d = model.loss(p_view, logits, batch["label"])
            inputs = [*leaves.values(), rows_pos]
            grads = torch.autograd.grad(loss_d * sens, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs, grads)]
        g_deltas = grads[-1]  # [N, width] batch order
        dense_grads = dict(zip(leaves, grads[:-1]))
        losses = (loss_w.detach(), loss_d.detach())
        next_step = state.step + 1

        if check_overflow:
            finite = torch.stack(
                [torch.isfinite(g).all() for g in grads]
            ).all()
            if not bool(finite):  # keep params and state, advance step
                return state._replace(step=next_step), losses

        g_uq_all = segsum(g_deltas[perm.long()], uidx_s.to(torch.int32), ub)
        opt_w_state, opt_d_state = dict(state.opt_w), dict(state.opt_d)

        def dense_update(key, leaf):
            if key in table_keys:
                return leaf
            opt, states = ((opt_w, opt_w_state) if is_wide_key(key)
                           else (opt_d, opt_d_state))
            p2, states[key] = opt.update_leaf(dense_grads[key], states[key],
                                              leaf)
            return p2

        new_params = map_leaves(dense_update, params)
        for key, (name, path, spec) in table_keys.items():
            wide = is_wide_key(key)
            states = opt_w_state if wide else opt_d_state
            o = offs[name]
            _table, states[key] = _packed_table_update(
                opt_w if wide else opt_d, g_uq_all[o: o + spec.emb_dim],
                rows_sorted[name], sub_sorted[name], states[key],
                _get(params, path), spec, use_kernels=use_kernels,
            )
        return TrainState(new_params, opt_w_state, opt_d_state,
                          next_step), losses

    return step


# ---------------------------------------------------------------------------
# host batch prep and eval
# ---------------------------------------------------------------------------


class BucketOverflow(RuntimeError):
    """A batch's distinct-id count exceeded the step's ``unique_bucket``."""

    def __init__(self, n_unique: int, bucket: int):
        super().__init__(
            f"batch has {n_unique} distinct ids > unique_bucket "
            f"{bucket}; raise the bucket or shrink the batch"
        )
        self.n_unique = n_unique
        self.bucket = bucket


def make_batch_sort(field_size: int, unique_bucket: int | None = None,
                    minimal: bool = False):
    """Host-side batch prep (numpy): attach ``perm``, ``uq_ids``,
    ``uidx``, ``uidx_sorted`` (and ``sorted_ids``/``inv`` unless
    ``minimal``) so the step skips its device sort.  Port of the numpy
    path of the reference's ``make_batch_sort`` for one id group; raises
    :class:`BucketOverflow` when a batch has more distinct ids than
    ``unique_bucket``."""
    del field_size  # kept for the reference's signature

    def prep(batch: dict) -> dict:
        ids = np.asarray(batch["ids"]).reshape(-1)
        n = ids.size
        perm = np.argsort(ids, kind="stable").astype(np.int32)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n, dtype=np.int32)
        sorted_ids = ids[perm]
        newv = np.empty(n, bool)
        newv[0] = True
        np.not_equal(sorted_ids[1:], sorted_ids[:-1], out=newv[1:])
        uidx_sorted = np.cumsum(newv, dtype=np.int32) - 1
        uq = np.full(n, SENTINEL, np.int32)
        u = sorted_ids[newv]
        uq[: u.size] = u
        if unique_bucket is not None and u.size > unique_bucket:
            raise BucketOverflow(int(u.size), unique_bucket)
        out = dict(batch)
        if not minimal:
            out["sorted_ids"] = sorted_ids
            out["inv"] = inv
        out["perm"] = perm
        out["uq_ids"] = uq
        out["uidx"] = uidx_sorted[inv]
        out["uidx_sorted"] = uidx_sorted
        return out

    return prep


def make_eval_step(model):
    """``eval_step(params, batch) -> (probs, labels)`` (sigmoid head)."""

    @torch.no_grad()
    def eval_step(params, batch):
        return model.predict_batch(params, batch), batch["label"]

    return eval_step
