"""CTR train steps (one device) and eval step.

Port of ``mindrec_tpu/train/step.py:make_train_step`` for unsharded
tables: the dense step (``dense_step``) and the two streamed
(``use_pallas``) branches of the sparse step, with their tail
``_finish_sparse``, ``_packed_table_update`` and
``_streamed_table_update``.

``sparse=False`` (every model config's default) is the dense step:
autograd runs through ``model.apply_batch(params, batch, train=True,
rng)`` over every parameter, full tables included (a table's gradient
is the backward of ``embedding``: ids sorted, each id's rows summed in
chunks in a fixed order, so deterministic), and every leaf takes its optimizer's dense ``update_leaf``: wide keys
the wide optimizer, the rest the deep one.  So dense FTRL updates every
row of a wide table (an untouched row whose ``|linear| <= l1`` becomes
0), and a dense table's l2 term covers the whole table every step, as
in the reference.  No kernel runs on this path.

Every step splits the state's key (``TrainState.rng``, ``ops/prng.py``)
and passes the subkey to the model, so ``dropout_flag`` trains on every
path.

``row_layout=True`` (the default) serves one or several id groups (the
multitable model declares four) and either storage layout.  One step,
per id group, in order:

1. sort metadata (``perm``, ``uq_ids``, ``uidx``, ``uidx_sorted``) from
   host prep (:func:`make_batch_sort`, ``{group}:``-prefixed keys for
   named groups) or from a device sort; a tiny group (whole id space
   within ``tiny_vocab`` <= 2048) skips the sort, its unique set being
   the whole id space;
2. the unique ids, cut or padded with the sentinel ``2**31 - 2`` to the
   static bucket ``ub``, gather their rows into one ``[ub, width]``
   float32 buffer, the group's tables side by side in its lanes:
   row_packed tables first (``packed_gather``), then feature-major
   tables, each over its full ``Dp`` sublanes (``gather_rows``, kernel);
3. the buffer expands to batch order (``buf[uidx]``, in ``matmul_dtype``)
   and the model runs forward and backward from it (folded wide tables
   masked to the owning sublane);
4. the per-position gradients are summed per unique slot by
   ``segsum_sorted`` (kernel), which reads them in batch order through
   ``perm``, or, in a tiny group, by raw id with ``segsum_unsorted``
   (kernel), whose presence counts gate the lazy updates;
5. the tables update only the touched rows: row_packed tables with
   ``adam_rows`` / ``ftrl_rows``, feature-major tables with
   ``adam_cols`` / ``ftrl_cols`` from touch-augmented gradients
   (kernels); the dense parameters take their optimizer's dense update.

``row_layout=False`` is the feature-major formulation for a single id
group of feature-major tables; nothing in it is row-major until the
expansion:

1. sort metadata as above, the unique ids kept at their full length N
   (one slot per position, sentinel-padded; no bucket);
2. per table, ``gather_cols`` (kernel) reads the unique ids' columns
   into ``[Dp, N]``; folded tables are masked to the owning sublane and
   sublane padding is dropped in unique space, the tables are
   concatenated along features to ``[sum_d, N]`` and cast to
   ``matmul_dtype``;
3. one gather of the transposed block expands it to batch order
   ``[N, sum_d]``; the gradient is taken at the expanded rows, so the
   expansion itself carries no gradient;
4. the gradients move to sorted order (``g[perm]``) and are summed per
   unique slot by ``segsum_cols`` (kernel), which takes their transposed
   view ``[sum_d, N]`` and reads the row-major memory itself;
5. split per table, fold-masked and padded back to ``Dp`` sublanes, they
   update the tables with ``adam_cols`` / ``ftrl_cols`` (kernels).

The sparse steps update the tables and their optimizer state **in
place** and return a new :class:`TrainState` that shares them: the state
passed in must not be used again (the reference donates it).  With
``use_kernels=False`` they call the kernels' plain versions directly on
any device (the reference for the kernels on the card).  The generic
sparse path without the streamed kernels, sharded or host-resident
tables and non-sparse table specs under ``sparse=True`` raise
``NotImplementedError``; so does ``row_layout=False`` for a multi-group
model or a row_packed table (the reference drops those to its generic
path).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from mindrec_tpu_torch.ops import prng
from mindrec_tpu_torch.ops.embedding import packed_expand, packed_gather
from mindrec_tpu_torch.ops.kernels.gather import (
    gather_cols, gather_cols_plain, gather_rows, gather_rows_plain,
)
from mindrec_tpu_torch.ops.kernels.segsum import (
    segsum_cols, segsum_cols_plain, segsum_sorted, segsum_sorted_plain,
    segsum_unsorted, segsum_unsorted_plain,
)
from mindrec_tpu_torch.ops.kernels.update_cols import (
    AUG, adam_cols, adam_cols_plain, ftrl_cols, ftrl_cols_plain,
    make_aug_grads,
)
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
    rng: torch.Tensor  # the dropout key (ops/prng.py) on the device


def init_train_state(model, seed: int, opt_w: Optimizer, opt_d: Optimizer,
                     device="cuda") -> TrainState:
    """Random parameters from ``torch.Generator(device).manual_seed(seed)``,
    fresh optimizer state and the key ``prng.key(seed)``, all on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init(gen, device=device)
    flat = flatten_params(params)
    return TrainState(
        params=params,
        opt_w={k: opt_w.init_leaf(p) for k, p in flat if is_wide_key(k)},
        opt_d={k: opt_d.init_leaf(p) for k, p in flat if not is_wide_key(k)},
        step=torch.zeros((), dtype=torch.int32, device=device),
        rng=prng.key(seed, device),
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
# feature-major table update
# ---------------------------------------------------------------------------


def _streamed_table_update(opt: Optimizer, grads_aug, cols, leaf_state, table,
                           spec, use_kernels=True):
    """Column-sparse optimizer update of a feature-major ``[Dp, Vc]``
    table, in place.

    ``grads_aug``: [Dp+8, U] touch-augmented summed gradients
    (``make_aug_grads``); ``cols``: [U] int32 sorted storage columns.
    Returns (table, new leaf state)."""
    h = opt.hyper
    dp, vc = table.shape
    kw = dict(dim=spec.emb_dim, fold=spec.fold, loss_scale=h["loss_scale"])
    if opt.kind == "sgd":
        # no touch mask (as the reference): absent columns get no gradient
        delta = (-h["learning_rate"] / h["loss_scale"]) * grads_aug[:dp].float()
        ok = (cols >= 0) & (cols < vc)
        table.index_add_(1, cols[ok].long(), delta[:, ok].to(table.dtype))
        return table, leaf_state
    if opt.kind == "adam":
        step = leaf_state["step"] + 1
        lr_t = adam_lr_t(step, learning_rate=h["learning_rate"], b1=h["b1"],
                         b2=h["b2"])
        fn = adam_cols if use_kernels else adam_cols_plain
        fn(table, leaf_state["m"], leaf_state["v"], cols, grads_aug, lr_t,
           b1=h["b1"], b2=h["b2"], eps=h["eps"], **kw)
        return table, {"m": leaf_state["m"], "v": leaf_state["v"],
                       "step": step}
    if opt.kind == "ftrl":
        if h["lr_power"] != -0.5:
            raise NotImplementedError("column updates fix lr_power at -0.5")
        fn = ftrl_cols if use_kernels else ftrl_cols_plain
        fn(table, leaf_state["accum"], leaf_state["linear"], cols, grads_aug,
           learning_rate=h["learning_rate"], l1=h["l1"], l2=h["l2"], **kw)
        return table, leaf_state
    raise ValueError(f"feature-major update supports ftrl/adam/sgd "
                     f"(kind={opt.kind})")


# ---------------------------------------------------------------------------
# step builder
# ---------------------------------------------------------------------------


def _get(params, path):
    node = params
    for h in path:
        node = node[h]
    return node


def _keep_unless(finite, new, old):
    """``new`` where the device flag ``finite`` holds, else ``old``, leaf
    by leaf of an optimizer state (None: ``new``)."""
    if finite is None:
        return new
    if isinstance(new, dict):
        return {k: _keep_unless(finite, v, old[k]) for k, v in new.items()}
    if isinstance(new, torch.Tensor) and new is not old:
        return torch.where(finite, new, old)
    return new


def _supported(model, sparse, row_layout):
    """Raise NotImplementedError for every branch this port lacks."""
    for name, (_path, spec) in model.table_specs.items():
        if spec.slice_mode != "none" or spec.target != "device":
            raise NotImplementedError(
                f"table {name}: sharded or host tables are not ported yet "
                f"(slice_mode={spec.slice_mode!r}, target={spec.target!r})"
            )
    if not sparse:
        return
    groups = getattr(model, "table_groups", None)
    if not row_layout and groups and (len(groups) > 1
                                      or "_default" not in groups):
        raise NotImplementedError(
            "row_layout=False handles single-id-group models; multi-group "
            "models stream with row_layout=True (the reference's other "
            "choice, its generic path, is not ported)"
        )
    for name, (_path, spec) in model.table_specs.items():
        if not row_layout and spec.row_packed:
            raise NotImplementedError(
                f"table {name}: row_layout=False streams feature-major "
                f"tables, but this one is row_packed (the default layout); "
                f"build the model with table_layout='feature_major' (the "
                f"reference drops to its generic path here, which is not "
                f"ported)"
            )
        if not spec.sparse:
            # the reference trains these (dynamic_embedding over plain
            # row-major tables) on its generic path only
            raise NotImplementedError(
                f"table {name}: the sparse step over non-sparse (plain "
                f"row-major) table specs is the generic path, not ported "
                f"yet (ROADMAP.md section 1 item 3)"
            )


def _id_bound(table_specs, names) -> int:
    """Ids of a group lie below this bound (vocab + dummy + spare),
    rounded up to 2048."""
    bound = max(table_specs[n][1].vocab_size + 9 for n in names)
    return (bound + 2047) // 2048 * 2048


def _group_ids(batch, keys):
    """[B, F_g] ids of an id group: its batch keys side by side."""
    parts = [batch[k] for k in keys]
    if len(parts) == 1:
        return parts[0]
    B = int(parts[0].shape[0])
    return torch.cat([p.reshape(B, -1) for p in parts], dim=1)


def _fold_mask(dp: int, dim: int, sub, dtype):
    """[Dp, N] one-hot: 1 where sublane p belongs to fold sub-row sub[n]."""
    p_row = torch.arange(dp, device=sub.device) // dim
    return (p_row[:, None] == sub[None, :]).to(dtype)


def _fold_mask_rows(dp: int, dim: int, sub, dtype):
    """Row-major twin of :func:`_fold_mask`: [N, Dp]."""
    lane = torch.arange(dp, device=sub.device) // dim
    return (lane[None, :] == sub[:, None]).to(dtype)


def _sort_meta(batch, flat, pref=""):
    """-> (perm, uq_ids, uidx, uidx_sorted, uq_len) of one id group:
    host-prepared (batch keys of :func:`make_batch_sort`, ``{group}:``
    prefixed for named groups) or derived by a device sort."""
    n = flat.numel()
    if pref + "perm" in batch:
        perm = batch[pref + "perm"].reshape(-1)
        sorted_ids = batch.get(pref + "sorted_ids")
        inv = batch.get(pref + "inv")
        sorted_ids = None if sorted_ids is None else sorted_ids.reshape(-1)
        inv = None if inv is None else inv.reshape(-1)
    else:
        sorted_ids, perm = torch.sort(flat, stable=True)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(n, dtype=perm.dtype, device=perm.device)

    def uidx_of(sorted_ids):
        newv = torch.ones(sorted_ids.numel(), dtype=torch.bool,
                          device=flat.device)
        newv[1:] = sorted_ids[1:] != sorted_ids[:-1]
        return newv, torch.cumsum(newv, 0, dtype=torch.int32) - 1

    if pref + "uq_ids" in batch:
        uq = batch[pref + "uq_ids"].reshape(-1)
        uidx_b = batch[pref + "uidx"].reshape(-1)
        if pref + "uidx_sorted" in batch:
            uidx_s = batch[pref + "uidx_sorted"].reshape(-1)
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


class _Group(NamedTuple):
    """Static layout of one id group's unique-row buffer."""

    keys: tuple
    tables: tuple  # table names, row_packed first (the lane order)
    offs: dict  # table name -> first lane
    lanes: dict  # table name -> lanes (emb_dim, or Dp if feature-major)
    width: int  # buffer lanes, a multiple of 128
    tiny: bool  # sort-free path: the whole id space is the unique set
    id_bound: int


def _group_layouts(table_specs, table_groups, tiny_vocab):
    out = {}
    for g, info in table_groups.items():
        names = tuple(sorted(info["tables"],
                             key=lambda n: not table_specs[n][1].row_packed))
        offs, lanes, off = {}, {}, 0
        for name in names:
            spec = table_specs[name][1]
            offs[name] = off
            lanes[name] = spec.emb_dim if spec.row_packed else spec.padded_dim
            off += lanes[name]
        bound = _id_bound(table_specs, names)
        out[g] = _Group(
            keys=tuple(info["keys"]), tables=names, offs=offs, lanes=lanes,
            width=max(128, -(-off // 128) * 128),
            tiny=bound <= min(tiny_vocab, 2048), id_bound=bound,
        )
    return out


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
    unique_bucket: int | dict | None = None,
    tiny_vocab: int = 2048,
    jit: bool = False,
    donate: bool = True,
):
    """Build ``step(state, batch) -> (state, (loss_w, loss_d))``.

    ``batch``: tensors on the state's device: the model's id keys (``ids
    [B,F] int32`` and ``wts [B,F] f32`` for Criteo models; the
    multitable keys otherwise), ``label [B,1] f32``, plus optionally the
    host-prep keys of :func:`make_batch_sort`.  ``sparse``: the sparse
    step (True) or the dense step (False; the parameters below that
    name sort metadata, buckets and kernels are sparse-step ones);
    None takes the model config's ``sparse`` or ``dynamic_embedding``.
    ``unique_bucket``: static
    bound on distinct ids per batch (rounded up to 2048), an int for a
    sole id group or ``{group: int}``; defaults to the length of the
    group's ``uq_ids`` (host prep) or the lossless position count.
    ``tiny_vocab``: groups whose id space fits this bound (at most 2048)
    skip the sort: their unique set is the whole id space and the
    backward is one unsorted segment-sum, with presence counts gating
    the lazy updates.  ``matmul_dtype``: type of the expanded rows and of
    their gradients (bf16 in production, as the reference).
    ``check_overflow``: skip the update (but advance the step and the
    key) when a gradient is not finite, by a flag on the device that
    gates every touch and selects every dense leaf and optimizer state
    (nothing is read on the host, so the guarded step can be captured).
    ``row_layout=False``: the feature-major formulation (module
    docstring) for a single id group of feature-major tables; it takes
    the unique ids at their full length and ignores ``unique_bucket``
    and ``tiny_vocab`` (both ``row_layout=True`` parameters, as in the
    reference).

    ``jit=True`` (the reference's ``jax.jit``): on a CUDA state the step
    is captured once per batch signature in a CUDA graph and replayed
    (:class:`CapturedStep`); on the CPU it is the eager step.
    ``donate``: the sparse steps update the tables in place, and a
    captured step every leaf, so the state passed in is always donated;
    ``donate=False`` raises."""
    if not donate:
        raise NotImplementedError(
            "the port's step updates the state in place (it is donated); "
            "donate=False is not ported")
    cfg = model.config
    if sparse is None:
        sparse = bool(getattr(cfg, "sparse", False)
                      or getattr(cfg, "dynamic_embedding", False))
    _supported(model, sparse, row_layout)
    sens = float(loss_scale if loss_scale is not None
                 else getattr(cfg, "loss_scale", 1.0))
    table_specs = model.table_specs
    # the sparse step updates these leaves from their rows' gradients;
    # the dense step differentiates them like every other leaf
    table_keys = {"/".join(path): (name, path, spec)
                  for name, (path, spec) in table_specs.items()
                  if sparse}
    table_groups = getattr(model, "table_groups", None) or {
        "_default": {"keys": ("ids",), "tables": tuple(table_specs)}
    }
    layouts = _group_layouts(table_specs, table_groups, tiny_vocab)
    segsum = segsum_sorted if use_kernels else segsum_sorted_plain
    unsorted = segsum_unsorted if use_kernels else segsum_unsorted_plain
    gather = gather_rows if use_kernels else gather_rows_plain
    ones_cache = {}  # (positions, device) -> the [N, 1] presence input

    def presence_ones(n, device):
        key = (n, str(device))
        if key not in ones_cache:
            ones_cache[key] = torch.ones((n, 1), dtype=matmul_dtype,
                                         device=device)
        return ones_cache[key]

    def bucket_of(g, uq_len):
        if isinstance(unique_bucket, dict):
            ub = unique_bucket.get(g)
        else:
            ub = unique_bucket if len(table_groups) == 1 else None
        ub = ub if ub is not None else uq_len
        return (int(ub) + 2047) // 2048 * 2048

    def forward_meta(params, batch):
        """Per group: sort metadata and the [ub, width] unique-row buffer
        (row_packed tables gathered first, then the feature-major tables
        by the gather kernel into their lanes)."""
        gdata = {}
        for g, lay in layouts.items():
            ids_g = _group_ids(batch, lay.keys)
            flat = ids_g.reshape(-1).contiguous()
            if lay.tiny:
                perm = uidx_s = None
                ub = lay.id_bound
                uq_b = torch.arange(ub, dtype=torch.int32, device=flat.device)
                uidx_b = flat
            else:
                pref = "" if g == "_default" else f"{g}:"
                perm, uq, uidx_b, uidx_s, uq_len = _sort_meta(batch, flat, pref)
                ub = bucket_of(g, uq_len)
                if ub <= uq_len:
                    uq_b = uq[:ub]
                else:
                    uq_b = torch.cat([uq, uq.new_full((ub - uq_len,), SENTINEL)])
                uq_b = uq_b.to(torch.int32)
            parts, cols, subs = [], {}, {}
            for name in lay.tables:
                path, spec = table_specs[name]
                if spec.row_packed:
                    p = spec.pack
                    cols[name] = torch.div(uq_b, p, rounding_mode="floor")
                    subs[name] = torch.remainder(uq_b, p)
                    parts.append(packed_gather(spec, _get(params, path), uq_b)
                                 .float())
                else:
                    r = spec.fold
                    cols[name] = torch.div(uq_b, r, rounding_mode="floor")
                    subs[name] = torch.remainder(uq_b, r) if r > 1 else None
            used = sum(x.shape[1] for x in parts)
            if used < lay.width:
                parts.append(uq_b.new_zeros((ub, lay.width - used),
                                            dtype=torch.float32))
            buf = torch.cat(parts, dim=1)  # [ub, width]
            for name in lay.tables:
                path, spec = table_specs[name]
                if not spec.row_packed:
                    gather(_get(params, path), cols[name], buf, lay.offs[name])
            gdata[g] = dict(buf=buf, flat=flat, perm=perm, uidx_b=uidx_b,
                            uidx_s=uidx_s, ub=ub, cols=cols, subs=subs,
                            shape=tuple(ids_g.shape[:2]))
        return gdata

    def table_rows(gdata, rows_pos):
        """Each table's rows in batch order: its lanes of the group's
        expanded buffer, folded tables masked to the owning sublane."""
        rows = {}
        for g, lay in layouts.items():
            gd = gdata[g]
            for name in lay.tables:
                spec = table_specs[name][1]
                o, dpf = lay.offs[name], lay.lanes[name]
                r = rows_pos[g][:, o: o + dpf]
                if spec.fold > 1:
                    sub = torch.remainder(gd["flat"], spec.fold)
                    r = r * _fold_mask_rows(dpf, spec.emb_dim, sub, r.dtype)
                else:
                    r = r[:, : spec.emb_dim]  # drop sublane padding
                rows[name] = r.reshape(*gd["shape"], -1)
        return rows

    def backward_sums(gdata, g_deltas):
        """Per table: summed gradients per unique slot [lanes, ub] f32,
        and the presence gate [1, ub] of tiny groups' tables."""
        col_grads, touch_mask = {}, {}
        for g, lay in layouts.items():
            gd = gdata[g]
            gpos = g_deltas[g].contiguous()
            if lay.tiny:
                # no crossing: reduce batch-order gradients by raw id;
                # presence counts keep absent ids untouched
                g_uq_all = unsorted(gpos, gd["flat"], gd["ub"])
                counts = unsorted(presence_ones(gd["flat"].numel(), gpos.device),
                                  gd["flat"], gd["ub"])
                present = (counts > 0).float()
                for name in lay.tables:
                    touch_mask[name] = present
            else:
                # the sum reads the batch-order rows through perm: no
                # gather in front of it
                g_uq_all = segsum(gpos, gd["uidx_s"].to(torch.int32), gd["ub"],
                                  perm=gd["perm"])
            for name in lay.tables:
                spec = table_specs[name][1]
                o, dpf = lay.offs[name], lay.lanes[name]
                gcol = g_uq_all[o: o + dpf]
                if spec.fold > 1:  # defensive re-mask, as the reference
                    gcol = gcol * _fold_mask(dpf, spec.emb_dim,
                                             gd["subs"][name], gcol.dtype)
                col_grads[name] = gcol
        return col_grads, touch_mask

    def call_rows(p_view, rows, batch, rng):
        """The model's forward from per-table rows, in training."""
        if hasattr(model, "apply_rows_batch"):
            return model.apply_rows_batch(p_view, rows, batch, train=True,
                                          rng=rng)
        return model.apply_rows(p_view, rows, batch["wts"], train=True,
                                rng=rng)

    def run_model(params, label, rows_pos, forward):
        """Forward and backward: ``forward(p_view, rows_pos) -> logits``
        over the parameters (a sparse step's tables are reached through
        the expanded rows ``rows_pos``, leaf tensors).  -> (gradients of
        the other leaves by key, gradients of ``rows_pos`` in its order,
        (loss_w, loss_d))."""
        leaves = {}  # dense parameters, tracked for autograd

        def track(key, leaf):
            if key in table_keys:
                return leaf
            leaves[key] = leaf.detach().requires_grad_(True)
            return leaves[key]

        p_view = map_leaves(track, params)
        with torch.enable_grad():
            logits = forward(p_view, rows_pos)
            loss_w, loss_d = model.loss(p_view, logits, label)
            inputs = [*leaves.values(), *rows_pos]
            grads = torch.autograd.grad(loss_d * sens, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs, grads)]
        return (dict(zip(leaves, grads[: len(leaves)])), grads[len(leaves):],
                (loss_w.detach(), loss_d.detach()))

    def guard(dense_grads, g_deltas):
        """check_overflow: -> (finite, dense_grads, g_deltas), where
        ``finite`` is a bool scalar on the device (None without the
        guard) and the gradients are zeroed unless it holds, so no NaN
        reaches a kernel.  Nothing is read on the host."""
        if not check_overflow:
            return None, dense_grads, g_deltas
        finite = torch.stack([torch.isfinite(g).all()
                              for g in (*dense_grads.values(), *g_deltas)]).all()
        return (finite,
                {k: torch.where(finite, g, 0.0) for k, g in dense_grads.items()},
                [torch.where(finite, g, 0.0) for g in g_deltas])

    def finish(state, dense_grads, col_grads, cols, subs, touch_mask, losses,
               rng, finite=None):
        """The shared tail: dense updates, then each table's lazy update
        from its summed gradients (``_finish_sparse`` of the reference).
        ``finite`` (the guard's flag) gates every table's touches and
        selects every dense leaf and optimizer state: where it is False
        all keep their values and only ``step`` and the key ``rng``
        advance (the reference's ``_guard``)."""
        params = state.params
        opt_w_state, opt_d_state = dict(state.opt_w), dict(state.opt_d)

        def dense_update(key, leaf):
            if key in table_keys:
                return leaf
            opt, states = ((opt_w, opt_w_state) if is_wide_key(key)
                           else (opt_d, opt_d_state))
            p2, st = opt.update_leaf(dense_grads[key], states[key], leaf)
            states[key] = _keep_unless(finite, st, states[key])
            return _keep_unless(finite, p2, leaf)

        new_params = map_leaves(dense_update, params)
        for key, (name, path, spec) in table_keys.items():
            wide = is_wide_key(key)
            states = opt_w_state if wide else opt_d_state
            opt = opt_w if wide else opt_d
            table = _get(params, path)
            gate = touch_mask.get(name)
            if finite is not None:  # no touch at all on overflow
                f = finite.to(torch.float32).reshape(1, 1)
                gate = f if gate is None else gate * f
            if spec.row_packed:
                u = cols[name].shape[0]
                present = None if gate is None else (
                    (gate > 0).to(torch.int32).expand(1, u).reshape(-1)
                    .contiguous())
                _t, st = _packed_table_update(
                    opt, col_grads[name], cols[name], subs[name], states[key],
                    table, spec, present=present, use_kernels=use_kernels,
                )
            else:
                g_aug = make_aug_grads(col_grads[name], subs[name])
                if gate is not None:  # absent ids of a tiny group: no touch
                    g_aug = torch.cat([g_aug[:-AUG], g_aug[-AUG:] * gate])
                _t, st = _streamed_table_update(
                    opt, g_aug.contiguous(), cols[name], states[key], table,
                    spec, use_kernels=use_kernels,
                )
            states[key] = _keep_unless(finite, st, states[key])
        return TrainState(new_params, opt_w_state, opt_d_state,
                          state.step + 1, rng), losses

    def step_rows(state: TrainState, batch):
        rng, sub = prng.split(state.rng)
        gdata = forward_meta(state.params, batch)
        rows_pos = [
            gd["buf"].to(matmul_dtype)[gd["uidx_b"].long()]
            .requires_grad_(True)
            for gd in gdata.values()
        ]
        dense_grads, g_deltas, losses = run_model(
            state.params, batch["label"], rows_pos,
            lambda p, rp: call_rows(
                p, table_rows(gdata, dict(zip(gdata, rp))), batch, sub))
        finite, dense_grads, g_deltas = guard(dense_grads, g_deltas)
        col_grads, touch_mask = backward_sums(gdata,
                                              dict(zip(gdata, g_deltas)))
        cols, subs = {}, {}
        for gd in gdata.values():
            cols.update(gd["cols"])
            subs.update(gd["subs"])
        return finish(state, dense_grads, col_grads, cols, subs, touch_mask,
                      losses, rng, finite)

    gather_c = gather_cols if use_kernels else gather_cols_plain
    segsum_c = segsum_cols if use_kernels else segsum_cols_plain

    def step_cols(state: TrainState, batch):
        """The feature-major formulation (``row_layout=False``)."""
        rng, sub = prng.split(state.rng)
        ids = batch["ids"]
        flat = ids.reshape(-1).contiguous()
        n_pos = flat.numel()
        perm, uq, uidx_b, uidx_s, uq_len = _sort_meta(batch, flat)
        if uq_len != n_pos:
            raise ValueError(
                f"row_layout=False takes uq_ids at their full length "
                f"{n_pos} (one slot per position), got {uq_len}; trimming "
                f"them to a bucket is a row_layout=True contract")
        uq = uq.to(torch.int32)
        parts, dims, cols, subs = [], {}, {}, {}
        for name, (path, spec) in table_specs.items():
            r = spec.fold
            cols[name] = torch.div(uq, r, rounding_mode="floor") if r > 1 else uq
            subs[name] = torch.remainder(uq, r) if r > 1 else None
            rows_u = gather_c(_get(state.params, path), cols[name])  # [Dp, N]
            if r > 1:  # keep the owning sublane only, in unique space
                rows_u = rows_u * _fold_mask(rows_u.shape[0], spec.emb_dim,
                                             subs[name], rows_u.dtype)
            else:
                rows_u = rows_u[: spec.emb_dim]  # drop sublane padding
            parts.append(rows_u)
            dims[name] = rows_u.shape[0]
        big = (parts[0] if len(parts) == 1 else torch.cat(parts)).to(matmul_dtype)
        # one gather expands every table to batch order; the gradient is
        # taken at the expanded rows
        rows_pos = big.T.contiguous()[uidx_b.long()].requires_grad_(True)

        def rows_of(rp):
            rows, off = {}, 0
            for name, dn in dims.items():
                rows[name] = rp[0][:, off: off + dn].reshape(*ids.shape[:2], dn)
                off += dn
            return rows

        dense_grads, g_deltas, losses = run_model(
            state.params, batch["label"], [rows_pos],
            lambda p, rp: call_rows(p, rows_of(rp), batch, sub))
        finite, dense_grads, g_deltas = guard(dense_grads, g_deltas)
        g_sorted = g_deltas[0][perm.long()]  # [N, sum_d], sorted order
        # the kernel reads the [sum_d, N] view's row-major memory: no copy
        g_uq = segsum_c(g_sorted.T, uidx_s.to(torch.int32), n_pos)
        col_grads, off = {}, 0
        for name, (path, spec) in table_specs.items():
            dn = dims[name]
            g = g_uq[off: off + dn]
            off += dn
            if spec.fold > 1:
                # the expanded rows are unmasked: zero the sublanes the
                # fold mask zeroed in the forward
                g = g * _fold_mask(dn, spec.emb_dim, subs[name], g.dtype)
            dp_full = _get(state.params, path).shape[0]
            if dn < dp_full:  # restore the sublane padding
                g = torch.cat([g, g.new_zeros((dp_full - dn, n_pos))])
            col_grads[name] = g
        return finish(state, dense_grads, col_grads, cols, subs, {}, losses,
                      rng, finite)

    def step_dense(state: TrainState, batch):
        """The dense step (``sparse=False``): every leaf's gradient by
        autograd through the model's lookups, then its dense update."""
        rng, sub = prng.split(state.rng)
        dense_grads, _, losses = run_model(
            state.params, batch["label"], [],
            lambda p, _rp: model.apply_batch(p, batch, train=True, rng=sub))
        finite, dense_grads, _ = guard(dense_grads, [])
        return finish(state, dense_grads, {}, {}, {}, {}, losses, rng, finite)

    if not sparse:
        step = step_dense
    else:
        step = step_rows if row_layout else step_cols
    step.takes_device_batches = True  # RecModel stages batches for it
    return CapturedStep(step) if jit else step


# ---------------------------------------------------------------------------
# the captured step (jit=True)
# ---------------------------------------------------------------------------


def _state_tensors(state: TrainState) -> list[torch.Tensor]:
    return [leaf for _p, leaf in _leaves(
        {"params": state.params, "opt_w": state.opt_w, "opt_d": state.opt_d,
         "step": state.step, "rng": state.rng})
        if isinstance(leaf, torch.Tensor)]


def _state_key(state: TrainState) -> tuple:
    """Where and how the state's tensors lie: a graph replays only on
    tensors at these addresses with these shapes, types and strides (the
    caching allocator may hand a new state an old one's addresses)."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype, t.stride())
                 for t in _state_tensors(state))


def _step_in_place(step, state: TrainState, batch):
    """Run ``step`` and copy every leaf it replaced into ``state``'s own
    tensors (the tables it already updates in place), so that ``state``
    stays the live state at fixed addresses."""
    new, losses = step(state, batch)
    for old, fresh in zip(_state_tensors(state), _state_tensors(new)):
        if fresh is not old:
            old.copy_(fresh)
    return losses


class CapturedStep:
    """The train step captured in a CUDA graph per batch signature (keys,
    shapes, dtypes) and state, then replayed: the counterpart of the
    reference's ``jax.jit(step, donate_argnums=(0,))``.

    The first call of a signature runs the step eagerly on a side stream
    (the warm-up: it builds the kernel library, asks the kernels' scratch
    sizes and makes every lazily cached tensor, and it is this batch's
    real step), then captures one step into a ``torch.cuda.CUDAGraph``
    over static copies of the batch.  Later calls copy the batch into the
    static inputs and replay.  The graph updates the caller's
    :class:`TrainState` in place (every leaf keeps its address) and the
    returned losses are copies that the next replay does not overwrite.
    A bucket regrow is a new signature and gets one new capture; graphs
    of the live state's earlier signatures are kept for batches still in
    flight.  A call with another state (a callback replaced it) drops
    every graph, and with it every private memory pool, held for the
    state it replaces: that state was donated, so no graph of it can be
    replayed again.  A capture that fails raises: it never falls back to
    the eager step.

    A kernel wrapper counts its launch when the graph is captured, not on
    each replay.  Since :meth:`reset_counts`, ``recorded`` sums what the
    captures counted (launches put into graphs, not run) and ``replayed``
    what the replays launched, so the kernels' real launches are
    ``LAUNCHES - recorded + replayed``.  On a CPU state the call is the
    eager step."""

    takes_device_batches = True  # RecModel stages batches for it

    def __init__(self, step):
        self.step = step
        self._graphs = {}  # batch signature -> entry, for the live state
        self._state = None
        self._state_key = None
        self.reset_counts()

    @property
    def graphs(self) -> int:
        """Graphs held: one per batch signature of the live state."""
        return len(self._graphs)

    def reset_counts(self) -> None:
        self.captures = self.replays = 0
        self.recorded = {}  # kernel -> launches counted by captures
        self.replayed = {}  # kernel -> launches made by replays

    def __call__(self, state: TrainState, batch):
        if state.step.device.type != "cuda":
            return self.step(state, batch)
        if state is not self._state:
            key = _state_key(state)
            if key != self._state_key:
                self._graphs.clear()  # the replaced state's graphs
                self._state_key = key
            self._state = state
        sig = tuple((k, tuple(v.shape), v.dtype, str(v.device))
                    for k, v in sorted(batch.items()))
        entry = self._graphs.get(sig)
        if entry is None:
            return state, self._capture(sig, state, batch)
        graph, static, losses, per_replay = entry
        for k, v in batch.items():
            static[k].copy_(v)
        graph.replay()
        self.replays += 1
        for k, n in per_replay.items():
            self.replayed[k] = self.replayed.get(k, 0) + n
        return state, tuple(x.clone() for x in losses)

    def _capture(self, key, state, batch):
        from mindrec_tpu_torch.data.criteo import STAGING_LOCK
        from mindrec_tpu_torch.ops.kernels import LAUNCHES

        dev = state.step.device
        with torch.cuda.device(dev):
            cur = torch.cuda.current_stream(dev)
            static = {k: v.clone() for k, v in batch.items()}
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                losses = tuple(x.clone() for x in
                               _step_in_place(self.step, state, static))
            cur.wait_stream(side)
            before = dict(LAUNCHES)
            graph = torch.cuda.CUDAGraph()
            # the input pipeline's staging thread waits while we capture
            with STAGING_LOCK, torch.cuda.graph(graph):
                out = _step_in_place(self.step, state, static)
        per_replay = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                      if LAUNCHES[k] != before[k]}
        self._graphs[key] = (graph, static, out, per_replay)
        self.captures += 1
        for k, n in per_replay.items():
            self.recorded[k] = self.recorded.get(k, 0) + n
        return losses


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


def prep_groups(model, tiny_vocab: int = 2048) -> dict | None:
    """The id groups host prep should sort for a model: its
    ``table_groups`` minus tiny groups, whose sort metadata the step
    never reads.  None for single-group models (prep uses the bare
    ``ids`` contract); possibly an empty dict otherwise."""
    groups = getattr(model, "table_groups", None)
    if groups is None or ("_default" in groups and len(groups) == 1):
        return None
    specs = model.table_specs
    return {g: info for g, info in groups.items()
            if _id_bound(specs, info["tables"]) > tiny_vocab}


def _np_sort_meta(ids):
    """-> (sorted_ids, perm, inv, uq [n], uidx, uidx_sorted, n_unique)."""
    n = ids.size
    perm = np.argsort(ids, kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n, dtype=np.int32)
    sorted_ids = ids[perm]
    newv = np.empty(n, bool)
    newv[:1] = True
    np.not_equal(sorted_ids[1:], sorted_ids[:-1], out=newv[1:])
    uidx_sorted = np.cumsum(newv, dtype=np.int32) - 1
    uq = np.full(n, SENTINEL, np.int32)
    u = sorted_ids[newv]
    uq[: u.size] = u
    return sorted_ids, perm, inv, uq, uidx_sorted[inv], uidx_sorted, int(u.size)


def make_batch_sort(field_size: int, unique_bucket=None,
                    native: bool | None = None, minimal: bool = False,
                    groups: dict | None = None,
                    kept_budget: dict | None = None):
    """Host-side batch prep: attach ``perm``, ``uq_ids``, ``uidx``,
    ``uidx_sorted`` (and ``sorted_ids``/``inv`` unless ``minimal``) so
    the step skips its device sort.  Port of the reference's
    ``make_batch_sort``.

    ``native``: None (the default) or True sorts with the native radix
    sort (``native/batchprep.cc``, built by g++ at first use; a failed
    build raises), whose ctypes call releases the GIL so a thread pool
    overlaps prep with the device step; False takes the numpy path (the
    tests pin exact native <-> numpy parity).

    ``unique_bucket``: the step's static bucket (an int, or ``{group:
    int}``); a batch with more distinct ids raises
    :class:`BucketOverflow`.  ``groups``: a model's ``table_groups`` (or
    :func:`prep_groups` of it): prep runs per id group over its batch
    keys side by side and emits ``{group}:``-prefixed keys (bare keys for
    ``_default``).  ``kept_budget``: ``{group: int}``; a group that
    declares ``mask_keys`` then has its sorted stream compacted to the
    masked-in positions, padded to this static length: pad slots point
    at position 0 with segment ``n_unique``, which holds a sentinel id
    (raises :class:`BucketOverflow` when the batch keeps more positions
    than the budget, or when ``n_unique >= unique_bucket``).  An id
    occurring only at masked positions is then not touched."""
    del field_size  # kept for the reference's signature
    if native is False:
        sort_meta = _np_sort_meta
    else:
        from mindrec_tpu_torch.native import batchprep

        def sort_meta(ids):
            return batchprep.batch_prep(ids, uq_len=ids.size, minimal=minimal)

    def group_items(batch):
        if groups is None:
            yield "", np.asarray(batch["ids"]).reshape(-1), unique_bucket, None, None
            return
        for g, info in groups.items():
            keys = info["keys"] if isinstance(info, dict) else tuple(info)
            parts = [np.asarray(batch[k]) for k in keys]
            B = parts[0].shape[0]
            ids_g = np.concatenate([p.reshape(B, -1) for p in parts], axis=1)
            bucket = (unique_bucket.get(g) if isinstance(unique_bucket, dict)
                      else unique_bucket)
            budget = (kept_budget or {}).get(g)
            mask_keys = info.get("mask_keys") if isinstance(info, dict) else None
            mask = None
            if budget is not None and mask_keys:
                mask = np.concatenate(
                    [np.asarray(batch[k]).reshape(B, -1) for k in mask_keys],
                    axis=1).reshape(-1)
            pref = "" if g == "_default" else f"{g}:"
            yield pref, ids_g.reshape(-1), bucket, mask, budget

    def prep_one(out, pref, ids, bucket, mask, budget):
        n = ids.size
        if mask is not None:
            # sort only the masked-in positions (the others carry exactly
            # zero gradient)
            pos = np.flatnonzero(mask > 0).astype(np.int32)
            nk = pos.size
            if nk > budget:
                raise BucketOverflow(nk, budget)
            _s, perm_k, _i, uq_k, uidx_k, uidx_sorted_k, nu = sort_meta(
                ids[pos])
            if bucket is not None and nu >= bucket:
                # >=: the pad slots' segment needs index nu
                raise BucketOverflow(nu + 1, bucket)
            perm = np.zeros(budget, np.int32)  # pads: position 0 ...
            perm[:nk] = pos[perm_k]
            uidx_sorted = np.full(budget, nu, np.int32)  # ... segment nu
            uidx_sorted[:nk] = uidx_sorted_k
            uq = np.full(n, SENTINEL, np.int32)
            uq[:nk] = uq_k
            uidx = np.zeros(n, np.int32)
            uidx[pos] = uidx_k
            out[pref + "perm"] = perm
            out[pref + "uq_ids"] = uq
            out[pref + "uidx"] = uidx
            out[pref + "uidx_sorted"] = uidx_sorted
            return
        sorted_ids, perm, inv, uq, uidx, uidx_sorted, nu = sort_meta(ids)
        if bucket is not None and nu > bucket:
            raise BucketOverflow(nu, bucket)
        if not minimal:
            out[pref + "sorted_ids"] = sorted_ids
            out[pref + "inv"] = inv
        out[pref + "perm"] = perm
        out[pref + "uq_ids"] = uq
        out[pref + "uidx"] = uidx
        out[pref + "uidx_sorted"] = uidx_sorted

    def prep(batch: dict) -> dict:
        out = dict(batch)
        for item in group_items(batch):
            prep_one(out, *item)
        return out

    return prep


def make_eval_step(model):
    """``eval_step(params, batch) -> (probs, labels)`` (sigmoid head)."""

    @torch.no_grad()
    def eval_step(params, batch):
        return model.predict_batch(params, batch), batch["label"]

    eval_step.takes_device_batches = True
    return eval_step
