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
   and the model runs forward and backward from it: a model with
   ``apply_groups_batch`` (the multitable model) takes each group's rows
   whole (:class:`GroupRows`), any other its per-table slices
   (:func:`table_rows`: folded wide tables masked to the owning sublane);
4. the per-position gradients are summed per unique slot by
   ``segsum_sorted`` (kernel), which reads them in batch order through
   ``perm``, or, in a tiny group, by raw id with ``segsum_unsorted``
   (kernel), whose presence counts gate the lazy updates;
5. the tables update only the touched rows: row_packed tables with
   ``adam_rows`` / ``ftrl_rows``, feature-major tables with
   ``adam_cols`` / ``ftrl_cols`` (kernels), which read each table's sums
   in place, as the transposed view of the segment sum's row-major
   ``[ub, width]`` rows at the table's lanes (folded tables: their
   re-masked copy), and make the touch from the fold sub-rows and the
   gate (a tiny group's presence, the overflow guard's flag) themselves
   (``adam_cols_from_sums`` / ``ftrl_cols_from_sums``; tables sliced over
   a mesh run them per shard on the same sums); the dense parameters take
   their optimizer's dense update.

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
   update the tables with ``adam_cols`` / ``ftrl_cols`` (kernels), which
   read each table's ``[Dp, N]`` rows of the sums in place and make the
   touch themselves, as in the row layout.

``use_pallas=False`` is the reference's generic path, framework ops
over any id groups and every layout (``mindrec_tpu/train/step.py``
``sparse_step``'s generic backend):

1. per table, each position's row: ``packed_gather`` of row_packed
   storage, a column take of feature-major storage (folded tables masked
   to the owning sublane), a row gather of plain row-major specs (the
   reference takes columns of those, ``jnp.take(table, cols, axis=1)``,
   and trains NaN: section 3, reference fault 9);
2. the model's forward and backward from those rows, and the dense
   parameters' update;
3. per table, the gradients summed per distinct id
   (:func:`~mindrec_tpu_torch.ops.sparse.unique_pad` and
   :func:`~mindrec_tpu_torch.ops.sparse.segment_sum_rows`) and the
   optimizer's masked sparse update: row_packed tables through two
   unique passes (logical ids, then storage rows, each id's sum placed
   in its lanes), feature-major tables from touch-augmented gradients
   (``update_cols``), plain specs by rows (``update_rows``).  Fill slots
   of the padded unique lists never write their own values
   (``train/optim.py``), so a fill id that is a live row cannot drop
   that row's update (``ADVICE.md:3``).

It honours any FTRL ``lr_power``; the streamed branches fix it at -0.5
and raise otherwise (the reference's streamed kernels ignore it:
section 3, reference fault 10).  It makes no host read, so ``jit=True``
captures it like the streamed steps.

The sparse steps update the tables and their optimizer state **in
place** and return a new :class:`TrainState` that shares them: the state
passed in must not be used again (the reference donates it), unless the
step is built with ``donate=False``, which runs it on a copy.  With
``use_kernels=False`` the streamed branches call the kernels' plain
versions directly on any device (the reference for the kernels on the
card).  Host-resident tables raise ``NotImplementedError``
(``train/host_target.py`` trains them).

On a mesh (the model's ``mesh``, ``parallel/mesh.py``, more than one
rank) each rank runs the step on its slice of the global batch
(``shard_batch``; a :class:`~mindrec_tpu_torch.parallel.mesh.FullBatch`
is sliced here) and its block of each sliced table (``shard_train_state``):

* data parallelism: the loss is differentiated at ``1 / data`` of its
  scale, so the dense gradients summed over ``data`` are those of the
  global batch's mean; the losses returned are the global means; the
  overflow guard's flag is the AND over every rank; dropout draws the
  masks of the rank's rows of the global batch (``prng.batch_rows``);
* the streamed branch (``row_layout=True``) takes the global unique
  vector (host prep's ``uq_ids`` gathered over ``data``, or a sort of the
  ids gathered over ``data``) and runs the kernels per shard
  (``ops/sharded_stream.py``): row-sliced tables gather their owned
  columns and sum the lanes over ``model``, column-sliced ones gather
  their sublanes at a lane offset; the backward sums each data rank's
  positions in the global unique order, then over ``data``; each table
  updates its owned block; replicated tables update alike on every rank;
* the generic path (``use_pallas=False`` and the reference's fallbacks,
  with its warnings word for word: column slice at ``fold > 1``,
  ``row_layout=False`` on a mesh, a mesh without a ``data`` axis)
  gathers each table's position gradients over ``data`` and every rank
  updates its block of it (its owned ids);
* the dense step reads sliced tables through the sharded lookup
  (``ops/embedding.py``) and sums every gradient over ``data``: a
  replicated table's gradient travels whole, as in any data-parallel
  dense step.

A one-rank mesh keeps the plain path.  ``jit=True`` on a mesh captures
the step as on one card (:class:`CapturedStep`), cut at every collective:
the graphs run on the card and each collective runs between two of them,
so gloo's host copies (and NCCL's calls) stay outside every graph.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import warnings
from typing import Any, NamedTuple

import numpy as np
import torch

from mindrec_tpu_torch.ops import prng
from mindrec_tpu_torch.ops.embedding import packed_expand, packed_gather
from mindrec_tpu_torch.ops.group_rows import (
    GroupLayout, GroupRows, fold_mask_rows, table_rows,
)
from mindrec_tpu_torch.ops.kernels.gather import (
    gather_cols, gather_cols_plain, gather_rows, gather_rows_plain,
)
from mindrec_tpu_torch.ops.kernels.segsum import (
    segsum_cols, segsum_cols_plain, segsum_sorted, segsum_sorted_plain,
    segsum_unsorted, segsum_unsorted_plain,
)
from mindrec_tpu_torch.ops.kernels.update_cols import (
    adam_cols_from_sums, adam_cols_from_sums_plain, expand_touch,
    ftrl_cols_from_sums, ftrl_cols_from_sums_plain, make_aug_grads,
)
from mindrec_tpu_torch.ops.kernels.update_rows import (
    adam_rows, adam_rows_plain, ftrl_rows, ftrl_rows_plain,
)
from mindrec_tpu_torch.ops import sharded_stream as ss
from mindrec_tpu_torch.ops.embedding import storage_rows
from mindrec_tpu_torch.ops.sparse import segment_sum_rows, unique_pad
from mindrec_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, FullBatch, all_gather, all_reduce, recording,
    shard_batch,
)
from mindrec_tpu_torch.train.optim import Optimizer, adam_lr_t, live_sources
from mindrec_tpu_torch.utils.profiling import span

SENTINEL = 2**31 - 2  # padded unique slot: past every vocab
_LR_POWER_MSG = (
    "the streamed updates fix FTRL's lr_power at -0.5 (the reference's "
    "streamed kernels ignore it: ROADMAP.md section 3, reference fault "
    "10); build the step with use_pallas=False, the generic path, which "
    "takes any lr_power")


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
            raise NotImplementedError(_LR_POWER_MSG)
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


def _streamed_table_update(opt: Optimizer, grads, cols, sub, gate, leaf_state,
                           table, spec, use_kernels=True, mesh=None):
    """Column-sparse optimizer update of a feature-major ``[Dp, Vc]``
    table, in place.

    ``grads``: [Dp, U] summed gradients, any strides (read where the
    segment sum left them); ``cols``: [U] int32 sorted storage columns;
    ``sub``: their fold sub-rows (None at fold 1); ``gate``: None, or a
    float32 [U] or one-element gate of every touch (a tiny group's
    presence, the overflow guard's flag, or their product).  The update
    kernels read the sums in place and make the touch themselves
    (``adam_cols_from_sums`` / ``ftrl_cols_from_sums``).  With ``mesh``
    the table is this rank's block of a sliced table and the update runs
    per shard (``ops/sharded_stream.py``), on the same sums.  Returns
    (table, new leaf state)."""
    h = opt.hyper
    if mesh is not None:
        return _sharded_table_update(opt, grads, cols, sub, gate, leaf_state,
                                     table, spec, use_kernels, mesh)
    vc = table.shape[1]
    kw = dict(dim=spec.emb_dim, fold=spec.fold, loss_scale=h["loss_scale"])
    if opt.kind == "sgd":
        # no touch mask (as the reference): absent columns get no gradient
        delta = (-h["learning_rate"] / h["loss_scale"]) * grads.float()
        ok = (cols >= 0) & (cols < vc)
        table.index_add_(1, cols[ok].long(), delta[:, ok].to(table.dtype))
        return table, leaf_state
    if opt.kind == "adam":
        step = leaf_state["step"] + 1
        lr_t = adam_lr_t(step, learning_rate=h["learning_rate"], b1=h["b1"],
                         b2=h["b2"])
        fn = adam_cols_from_sums if use_kernels else adam_cols_from_sums_plain
        fn(table, leaf_state["m"], leaf_state["v"], cols, grads, sub, gate,
           lr_t, b1=h["b1"], b2=h["b2"], eps=h["eps"], **kw)
        return table, {"m": leaf_state["m"], "v": leaf_state["v"],
                       "step": step}
    if opt.kind == "ftrl":
        if h["lr_power"] != -0.5:
            raise NotImplementedError(_LR_POWER_MSG)
        fn = ftrl_cols_from_sums if use_kernels else ftrl_cols_from_sums_plain
        fn(table, leaf_state["accum"], leaf_state["linear"], cols, grads, sub,
           gate, learning_rate=h["learning_rate"], l1=h["l1"], l2=h["l2"],
           **kw)
        return table, leaf_state
    raise ValueError(f"feature-major update supports ftrl/adam/sgd "
                     f"(kind={opt.kind})")


def _sharded_table_update(opt: Optimizer, grads, cols, sub, gate, leaf_state,
                          table, spec, use_kernels, mesh):
    """:func:`_streamed_table_update` of this rank's block of a row- or
    column-sliced table: its owned columns (row slice) or its sublanes
    of every column (column slice, fold 1: no ``sub``)."""
    h = opt.hyper
    col = spec.slice_mode == "table_column_slice"
    kw = dict(loss_scale=h["loss_scale"], use_kernels=use_kernels)
    ins = (grads, gate) if col else (grads, sub, gate)
    if not col:
        kw.update(dim=spec.emb_dim, fold=spec.fold)
    if opt.kind == "adam":
        step = leaf_state["step"] + 1
        lr_t = adam_lr_t(step, learning_rate=h["learning_rate"], b1=h["b1"],
                         b2=h["b2"])
        fn = ss.adam_colsliced_sharded if col else ss.adam_cols_sharded
        fn(mesh, table, leaf_state["m"], leaf_state["v"], cols, *ins, lr_t,
           b1=h["b1"], b2=h["b2"], eps=h["eps"], **kw)
        return table, {"m": leaf_state["m"], "v": leaf_state["v"],
                       "step": step}
    if opt.kind == "ftrl":
        if h["lr_power"] != -0.5:
            raise NotImplementedError(_LR_POWER_MSG)
        fn = ss.ftrl_colsliced_sharded if col else ss.ftrl_cols_sharded
        fn(mesh, table, leaf_state["accum"], leaf_state["linear"], cols, *ins,
           learning_rate=h["learning_rate"], l1=h["l1"], l2=h["l2"], **kw)
        return table, leaf_state
    raise ValueError(f"sharded streamed update supports ftrl/adam "
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


def _supported(model):
    """Raise NotImplementedError for the tables this port does not train
    on the device."""
    for name, (_path, spec) in model.table_specs.items():
        if spec.target == "host":
            raise NotImplementedError(
                f"table {name} lives on the host (target='host': "
                f"parameter_server=True without vocab_cache_size); the "
                f"device step does not train it: use "
                f"train/host_target.py:HostTargetAdapter"
            )


def _mesh_of(model):
    """The model's mesh when it has more than one rank, else None (a
    one-rank mesh keeps the plain path)."""
    mesh = getattr(model, "mesh", None)
    return mesh if mesh is not None and mesh.size > 1 else None


def _mesh_fallback(model, mesh, row_layout) -> tuple[bool, set]:
    """The reference's fallbacks of the streamed branch on a mesh, with
    its warnings: -> (take the generic path, the tables the streamed
    branch shards)."""
    specs = model.table_specs
    model_shards = mesh.model if "model" in mesh.axis_names else 1
    split = ({name for name, (_p, spec) in specs.items()
              if spec.slice_mode != "none"} if model_shards > 1 else set())
    if split:
        def shardable(spec):
            if spec.slice_mode == "table_row_slice":
                return True
            if spec.slice_mode == "table_column_slice":
                dp = spec.storage_shape[0]
                return (spec.fold == 1 and dp % model_shards == 0
                        and dp // model_shards <= ss.MAX_SHARD_SUBLANES)
            return False

        unsupported = sorted(n for n in split if not shardable(specs[n][1]))
        if unsupported or not row_layout:
            warnings.warn(
                "the streamed pallas path composes with a model mesh only "
                "for table_row_slice / fold-1 table_column_slice tables "
                f"under row_layout=True (unsupported: "
                f"{unsupported or 'row_layout=False'}); falling back to "
                "the generic sharded path (correct, bounded collectives, "
                "but slower)", stacklevel=3)
            return True, set()
    if not row_layout:
        warnings.warn(
            "the feature-major streamed path (row_layout=False) is "
            "single-device; falling back to the generic path on this "
            f"{mesh.size}-device mesh", stacklevel=3)
        return True, set()
    if "data" not in mesh.axis_names:
        warnings.warn(
            f"mesh axes {tuple(mesh.axis_names)} lack 'data'; falling back "
            "to the generic sharded path (build meshes with "
            "parallel.mesh.make_mesh for the streamed composition)",
            stacklevel=3)
        return True, set()
    return False, split


def _generic_branch(model, row_layout, use_pallas) -> bool:
    """Whether the sparse step takes the generic path: asked for
    (``use_pallas=False``), or the reference's fallbacks, row_packed
    tables under ``row_layout=False`` (with a warning) and plain
    row-major specs.  A multi-group model under ``row_layout=False``
    raises unless ``use_pallas`` is False, as in the reference."""
    if use_pallas is False:
        return True
    groups = getattr(model, "table_groups", None)
    specs = [spec for _p, spec in model.table_specs.values()]
    if not row_layout and groups and (len(groups) > 1
                                      or "_default" not in groups):
        raise NotImplementedError(
            "the feature-major streamed path (row_layout=False) handles "
            "single-id-group models; multi-group models stream with "
            "row_layout=True (the default) or take use_pallas=False"
        )
    if not row_layout and any(spec.row_packed for spec in specs):
        warnings.warn(
            "row_layout=False streams feature-major [Dp, Vc] tables, but "
            "this model stores row_packed tables (the default layout); "
            "falling back to the generic path: build specs with "
            "table_layout='feature_major' to use the streamed "
            "formulation", stacklevel=3,
        )
        return True
    return any(not spec.sparse for spec in specs)


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


def _group_layouts(table_specs, table_groups, tiny_vocab, split=()):
    """Per id group its :class:`GroupLayout`; a group holding a table of
    ``split`` (sliced over a mesh) is never tiny."""
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
        out[g] = GroupLayout(
            keys=tuple(info["keys"]), tables=names, offs=offs, lanes=lanes,
            width=max(128, -(-off // 128) * 128),
            tiny=(bound <= min(tiny_vocab, 2048)
                  and not any(n in split for n in names)),
            id_bound=bound,
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
    use_pallas: bool | None = None,
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

    ``use_pallas``: the sparse step's branch.  False takes the generic
    path (module docstring).  None and True take the streamed branches,
    whose kernels run on the card and whose plain versions run on the
    CPU; they fall back to the generic path, as the reference does, for
    row_packed tables under ``row_layout=False`` (with a warning) and for
    plain row-major specs.  The reference's None picks its generic path
    on the CPU, because its streamed kernels target the TPU; the port's
    kernels have plain versions on the CPU, so None keeps the streamed
    branches on every device.

    ``jit=True`` (the reference's ``jax.jit``): on a CUDA state the step
    is captured once per batch signature in CUDA graphs and replayed
    (:class:`CapturedStep`; on a mesh one graph between two collectives);
    on the CPU it is the eager step.
    ``donate``: the steps update the state passed in (the sparse steps
    their tables in place, a captured step every leaf); ``donate=False``
    runs the step on a copy and leaves the state passed in as it was, bit
    for bit (a captured step copies it into a state of its own, replays
    there and returns a copy)."""
    cfg = model.config
    if sparse is None:
        sparse = bool(getattr(cfg, "sparse", False)
                      or getattr(cfg, "dynamic_embedding", False))
    _supported(model)
    mesh = _mesh_of(model)
    generic = bool(sparse) and _generic_branch(model, row_layout, use_pallas)
    split = set()  # tables the streamed branch runs per shard
    if sparse and not generic and mesh is not None:
        generic, split = _mesh_fallback(model, mesh, row_layout)
    n_data = mesh.data if mesh is not None else 1
    # the generic and dense paths read every sliced table per shard
    sliced = ({n for n, (_p, spec) in model.table_specs.items()
               if spec.slice_mode != "none"}
              if mesh is not None and mesh.model > 1 else set())
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
    if sparse and not generic:
        for key, (name, _path, _spec) in table_keys.items():
            opt = opt_w if is_wide_key(key) else opt_d
            if opt.kind == "ftrl" and opt.hyper["lr_power"] != -0.5:
                raise NotImplementedError(f"table {name}: {_LR_POWER_MSG}")
    layouts = _group_layouts(table_specs, table_groups, tiny_vocab, split)
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

    def _mesh_sort_meta(batch, flat, pref):
        """Sort metadata on a mesh: the GLOBAL unique vector (host prep's
        ``uq_ids`` slices gathered over ``data``, or a sort of the ids
        gathered over ``data``) and this rank's positions' unique
        indices; the sorted-order keys are never read (the backward sorts
        locally, ``ops/sharded_stream.py``)."""
        if pref + "perm" in batch and batch[pref + "perm"].numel() != flat.numel():
            raise ValueError(
                "compacted host prep (kept_budget) is single-device: on a "
                "mesh the backward orders positions by their raw ids")
        if pref + "uq_ids" in batch:
            uq = all_gather(batch[pref + "uq_ids"].reshape(-1).contiguous(),
                            DATA_AXIS, mesh)
            return None, uq, batch[pref + "uidx"].reshape(-1), None, uq.numel()
        flat_all = all_gather(flat, DATA_AXIS, mesh)
        _p, uq, uidx_all, _s, uq_len = _sort_meta({}, flat_all)
        d, n = mesh.axis_index(DATA_AXIS), flat.numel()
        return None, uq, uidx_all[d * n:(d + 1) * n], None, uq_len

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
                meta = _mesh_sort_meta if mesh is not None else _sort_meta
                perm, uq, uidx_b, uidx_s, uq_len = meta(batch, flat, pref)
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
            # sliced tables first: their lanes are summed over the model
            # axis while the lanes of the other feature-major tables are
            # still zero
            for mode, fn in (("table_row_slice", ss.gather_rows_sharded),
                             ("table_column_slice", ss.gather_cols_sharded)):
                names = [n for n in lay.tables if n in split
                         and table_specs[n][1].slice_mode == mode]
                if names:
                    fn(mesh, [_get(params, table_specs[n][0]) for n in names],
                       [cols[n] for n in names], [lay.offs[n] for n in names],
                       buf, use_kernels=use_kernels)
            for name in lay.tables:
                path, spec = table_specs[name]
                if not spec.row_packed and name not in split:
                    gather(_get(params, path), cols[name], buf, lay.offs[name])
            gdata[g] = dict(buf=buf, flat=flat, perm=perm, uidx_b=uidx_b,
                            uidx_s=uidx_s, ub=ub, cols=cols, subs=subs,
                            uq=uq_b, shape=tuple(ids_g.shape[:2]))
        return gdata

    def backward_sums(gdata, g_deltas):
        """Per table: summed gradients per unique slot [lanes, ub] f32,
        and the presence gate [1, ub] of tiny groups' tables."""
        col_grads, touch_mask = {}, {}
        for g, lay in layouts.items():
            gd = gdata[g]
            gpos = g_deltas[g].contiguous()
            if mesh is not None:
                # the sums travel over the data axis: only the tables' lanes
                gpos = gpos[:, : sum(lay.lanes.values())].contiguous()
            if lay.tiny:
                # no crossing: reduce batch-order gradients by raw id;
                # presence counts keep absent ids untouched
                ones = presence_ones(gd["flat"].numel(), gpos.device)
                if mesh is not None:
                    g_uq_all, counts = (
                        ss.unsorted_segsum_sharded(mesh, x, gd["flat"], gd["ub"],
                                                   use_kernels=use_kernels)
                        for x in (gpos, ones))
                else:
                    g_uq_all = unsorted(gpos, gd["flat"], gd["ub"])
                    counts = unsorted(ones, gd["flat"], gd["ub"])
                present = (counts > 0).float()
                for name in lay.tables:
                    touch_mask[name] = present
            elif mesh is not None:
                # each data rank sums its positions in the global unique
                # order, then one sum over data
                g_uq_all = ss.partial_segsum_sharded(
                    mesh, gpos, gd["flat"], gd["uq"], gd["ub"],
                    use_kernels=use_kernels)
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

    def run_model(params, label, rows_pos, forward, key):
        """Forward and backward: ``forward(p_view, rows_pos, sub) ->
        logits`` over the parameters (a sparse step's tables are reached
        through the expanded rows ``rows_pos``, leaf tensors), ``sub`` the
        dropout key split off ``key``.  -> (gradients of the other leaves
        by key, gradients of ``rows_pos`` in its order, (loss_w, loss_d),
        the state's next key)."""
        dev = label.device
        leaves = {}  # dense parameters, tracked for autograd

        def track(key, leaf):
            if key in table_keys:
                return leaf
            leaves[key] = leaf.detach().requires_grad_(True)
            return leaves[key]

        p_view = map_leaves(track, params)
        # a data rank draws its rows' dropout masks of the global batch
        first = mesh.axis_index(DATA_AXIS) * label.shape[0] if mesh else 0
        with torch.enable_grad(), prng.batch_rows(first):
            with span("forward", dev):
                rng, sub = prng.split(key)
                logits = forward(p_view, rows_pos, sub)
                loss_w, loss_d = model.loss(p_view, logits, label)
            inputs = [*leaves.values(), *rows_pos]
            with span("backward", dev):
                # at 1/data of the scale: the sums over data are the
                # global batch's gradients
                grads = torch.autograd.grad(loss_d * (sens / n_data), inputs,
                                            allow_unused=True)
                grads = [torch.zeros_like(x) if g is None else g
                         for x, g in zip(inputs, grads)]
                losses = (loss_w.detach(), loss_d.detach())
                if n_data > 1:  # the global batch's means
                    both = all_reduce(torch.stack(losses), DATA_AXIS,
                                      mesh) / n_data
                    losses = (both[0], both[1])
        return (dict(zip(leaves, grads[: len(leaves)])), grads[len(leaves):],
                losses, rng)

    def guard(dense_grads, g_deltas, dev):
        """check_overflow: -> (finite, dense_grads, g_deltas), where
        ``finite`` is a bool scalar on the device (None without the
        guard) and the gradients are zeroed unless it holds, so no NaN
        reaches a kernel.  Nothing is read on the host."""
        if not check_overflow:
            return None, dense_grads, g_deltas
        with span("update", dev):
            finite = torch.stack([torch.isfinite(g).all() for g in
                                  (*dense_grads.values(), *g_deltas)]).all()
            if mesh is not None:  # every rank keeps or drops the step alike
                f = finite.to(torch.int32).reshape(1)
                for axis in (DATA_AXIS, MODEL_AXIS):
                    f = all_reduce(f, axis, mesh, op="min")
                finite = f.reshape(()) > 0
            return (finite,
                    {k: torch.where(finite, g, 0.0)
                     for k, g in dense_grads.items()},
                    [torch.where(finite, g, 0.0) for g in g_deltas])

    def reduce_over_data(grads: dict) -> dict:
        """Sum each gradient over ``data``, one collective per dtype."""
        if n_data == 1 or not grads:
            return grads
        out = dict(grads)
        for dt in {g.dtype for g in grads.values()}:
            keys = [k for k, g in grads.items() if g.dtype == dt]
            flat = all_reduce(torch.cat([grads[k].reshape(-1) for k in keys]),
                              DATA_AXIS, mesh)
            off = 0
            for k in keys:
                n = grads[k].numel()
                out[k] = flat[off: off + n].view_as(grads[k])
                off += n
        return out

    def dense_updates(state, dense_grads, finite):
        """Every leaf but the sparse step's tables takes its optimizer's
        dense update; -> (params, opt_w state, opt_d state)."""
        opt_w_state, opt_d_state = dict(state.opt_w), dict(state.opt_d)
        dense_grads = reduce_over_data(dense_grads)

        def dense_update(key, leaf):
            if key in table_keys:
                return leaf
            opt, states = ((opt_w, opt_w_state) if is_wide_key(key)
                           else (opt_d, opt_d_state))
            p2, st = opt.update_leaf(dense_grads[key], states[key], leaf)
            states[key] = _keep_unless(finite, st, states[key])
            return _keep_unless(finite, p2, leaf)

        return map_leaves(dense_update, state.params), opt_w_state, opt_d_state

    def finish(state, dense_grads, col_grads, cols, subs, touch_mask, losses,
               rng, finite=None):
        """The shared tail: dense updates, then each table's lazy update
        from its summed gradients (``_finish_sparse`` of the reference).
        ``finite`` (the guard's flag) gates every table's touches and
        selects every dense leaf and optimizer state: where it is False
        all keep their values and only ``step`` and the key ``rng``
        advance (the reference's ``_guard``)."""
        params = state.params
        dev = state.step.device
        with span("update", dev):
            with span("update.dense", dev):
                new_params, opt_w_state, opt_d_state = dense_updates(
                    state, dense_grads, finite)
            with span("update.tables", dev):
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
                            (gate > 0).to(torch.int32).expand(1, u)
                            .reshape(-1).contiguous())
                        _t, st = _packed_table_update(
                            opt, col_grads[name], cols[name], subs[name],
                            states[key], table, spec, present=present,
                            use_kernels=use_kernels,
                        )
                    else:
                        # the sums where the segment sum left them; the
                        # gate keeps absent ids of a tiny group untouched
                        _t, st = _streamed_table_update(
                            opt, col_grads[name], cols[name], subs[name],
                            None if gate is None else gate.reshape(-1),
                            states[key], table, spec, use_kernels=use_kernels,
                            mesh=mesh if name in split else None,
                        )
                    states[key] = _keep_unless(finite, st, states[key])
            return TrainState(new_params, opt_w_state, opt_d_state,
                              state.step + 1, rng), losses

    def step_rows(state: TrainState, batch):
        dev = state.step.device
        with span("meta", dev):
            gdata = forward_meta(state.params, batch)
        with span("expand", dev):
            rows_pos = [
                gd["buf"].to(matmul_dtype)[gd["uidx_b"].long()]
                .requires_grad_(True)
                for gd in gdata.values()
            ]
        def groups_of(rp):
            return {g: GroupRows(r, gd["flat"], gd["shape"], layouts[g])
                    for (g, gd), r in zip(gdata.items(), rp)}

        if hasattr(model, "apply_groups_batch"):
            # the model assembles its input from the groups' rows itself
            def forward(p, rp, sub):
                return model.apply_groups_batch(
                    p, groups_of(rp), batch, train=True, rng=sub,
                    use_kernels=use_kernels)
        else:
            def forward(p, rp, sub):
                return call_rows(p, table_rows(table_specs, groups_of(rp)),
                                 batch, sub)
        dense_grads, g_deltas, losses, rng = run_model(
            state.params, batch["label"], rows_pos, forward, state.rng)
        finite, dense_grads, g_deltas = guard(dense_grads, g_deltas, dev)
        with span("segsum", dev):
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
        dev = state.step.device
        ids = batch["ids"]
        flat = ids.reshape(-1).contiguous()
        n_pos = flat.numel()
        with span("meta", dev):
            perm, uq, uidx_b, uidx_s, uq_len = _sort_meta(batch, flat)
            if uq_len != n_pos:
                raise ValueError(
                    f"row_layout=False takes uq_ids at their full length "
                    f"{n_pos} (one slot per position), got {uq_len}; "
                    f"trimming them to a bucket is a row_layout=True "
                    f"contract")
            uq = uq.to(torch.int32)
            parts, dims, cols, subs = [], {}, {}, {}
            for name, (path, spec) in table_specs.items():
                r = spec.fold
                cols[name] = (torch.div(uq, r, rounding_mode="floor")
                              if r > 1 else uq)
                subs[name] = torch.remainder(uq, r) if r > 1 else None
                rows_u = gather_c(_get(state.params, path),
                                  cols[name])  # [Dp, N]
                if r > 1:  # keep the owning sublane only, in unique space
                    rows_u = rows_u * _fold_mask(rows_u.shape[0], spec.emb_dim,
                                                 subs[name], rows_u.dtype)
                else:
                    rows_u = rows_u[: spec.emb_dim]  # drop sublane padding
                parts.append(rows_u)
                dims[name] = rows_u.shape[0]
            big = (parts[0] if len(parts) == 1
                   else torch.cat(parts)).to(matmul_dtype)
        with span("expand", dev):
            # one gather expands every table to batch order; the gradient
            # is taken at the expanded rows
            rows_pos = big.T.contiguous()[uidx_b.long()].requires_grad_(True)

        def rows_of(rp):
            rows, off = {}, 0
            for name, dn in dims.items():
                rows[name] = rp[0][:, off: off + dn].reshape(*ids.shape[:2], dn)
                off += dn
            return rows

        dense_grads, g_deltas, losses, rng = run_model(
            state.params, batch["label"], [rows_pos],
            lambda p, rp, sub: call_rows(p, rows_of(rp), batch, sub),
            state.rng)
        finite, dense_grads, g_deltas = guard(dense_grads, g_deltas, dev)
        with span("segsum", dev):
            g_sorted = g_deltas[0][perm.long()]  # [N, sum_d], sorted order
            # the kernel reads the [sum_d, N] view's row-major memory: no
            # copy
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
        dense_grads, _, losses, rng = run_model(
            state.params, batch["label"], [],
            lambda p, _rp, sub: model.apply_batch(p, batch, train=True,
                                                  rng=sub),
            state.rng)
        finite, dense_grads, _ = guard(dense_grads, [], state.step.device)
        return finish(state, dense_grads, {}, {}, {}, {}, losses, rng, finite)

    group_of = {t: g for g, info in table_groups.items() for t in info["tables"]}

    def generic_rows(params, ids_g):
        """Each table's row at each position, [N, lanes], before fold
        masks: a take of its storage in its layout."""
        rows, flats = {}, {}
        for name, (path, spec) in table_specs.items():
            table = _get(params, path)
            flat = ids_g[group_of[name]].reshape(-1)
            flats[name] = flat
            if name in sliced:  # this rank's block, summed over model
                with torch.no_grad():
                    r = storage_rows(spec, table, flat, mesh)
            elif spec.row_packed:
                r = packed_gather(spec, table, flat)
            elif spec.feature_major:
                cols = (torch.div(flat, spec.fold, rounding_mode="floor")
                        if spec.fold > 1 else flat)
                r = table.index_select(1, cols.long()).T
            else:  # plain row-major specs: rows, not columns (fault 9)
                r = table.index_select(0, flat.long())
            rows[name] = r.detach().requires_grad_(True)
        return rows, flats

    def owned(keys, n_local):
        """(local index, owned flag) of global row/column ``keys`` in this
        rank's row-sliced block of ``n_local``; unowned ones map to 0."""
        local = keys - mesh.axis_index(MODEL_AXIS) * n_local
        own = (local >= 0) & (local < n_local)
        return torch.where(own, local, 0), own

    def generic_table_update(opt, g, flat, leaf_state, table, spec, finite,
                             shard=False):
        """The masked sparse update of one table from its per-position
        gradients ``g`` [N, lanes], in place; -> (table, leaf state).
        ``shard``: ``table`` is this rank's block of a sliced table, which
        updates its owned ids (row slice, gradients of the others zeroed
        and untouched) or its lanes of every id (column slice)."""
        row_slice = shard and spec.slice_mode == "table_row_slice"
        col_slice = shard and spec.slice_mode == "table_column_slice"
        m = mesh.axis_index(MODEL_AXIS) if shard else 0
        if opt.update_rows is None:
            raise ValueError(f"the generic path needs an optimizer with "
                             f"sparse updates (kind={opt.kind})")
        n = flat.numel()
        slots = torch.arange(n, device=flat.device)
        g = g.float()
        ok = None if finite is None else finite.reshape(1, 1)
        if spec.row_packed:
            # 1) sum per logical id; 2) fold logical siblings into their
            # unique storage rows.  Distinct logical ids own distinct
            # (row, lane) places, so the reference's second segment sum
            # adds each to zeros: a scatter places it exactly
            uq = unique_pad(flat, n, spec.padded_vocab - 1)
            summed = segment_sum_rows(g, uq.inverse, n)  # [n, dim]
            # each fill slot repeats a live id (and its sum), so the
            # scatters below write agreeing duplicates
            src = live_sources(slots < uq.count)
            ids_l = uq.ids.index_select(0, src)
            summed = summed.index_select(0, src)
            p, d = spec.pack, spec.emb_dim
            sub = torch.remainder(ids_l, p).long()
            uq_r = unique_pad(torch.div(ids_l, p, rounding_mode="floor"), n,
                              table.shape[0] - 1)
            inv = uq_r.inverse.long()
            g_rows = summed.new_zeros((n, p, d))
            g_rows[inv, sub] = summed
            t_rows = torch.zeros((n, p), dtype=torch.bool, device=g.device)
            t_rows.index_put_((inv, sub), torch.ones(
                (), dtype=torch.bool, device=g.device))  # no host scalar
            lanes = table.shape[1] - p * d
            g_rows = g_rows.reshape(n, p * d)
            touch = t_rows.repeat_interleave(d, dim=1)
            if lanes:  # lanes past pack * dim: never touched
                g_rows = torch.cat([g_rows, g_rows.new_zeros((n, lanes))], 1)
                touch = torch.cat([touch, touch.new_zeros((n, lanes))], 1)
            if ok is not None:
                touch = touch & ok
            return opt.update_rows(g_rows, uq_r.ids, leaf_state, table,
                                   touch=touch, live=slots < uq_r.count)
        if spec.feature_major:
            fold = spec.fold
            cols = torch.div(flat, fold, rounding_mode="floor") if fold > 1 else flat
            sub = torch.remainder(flat, fold) if fold > 1 else None
            g_aug = make_aug_grads(g.T, sub)  # [Dp + 8, N]
            if row_slice:  # unowned ids: no gradient, no touch
                cols, own = owned(cols, table.shape[1])
                g_aug = g_aug * own[None, :].to(g_aug.dtype)
            uq = unique_pad(cols, n, table.shape[1] - 1)
            summed = segment_sum_rows(g_aug.T, uq.inverse, n).T  # [Dp + 8, n]
            dp = spec.padded_dim
            touch = expand_touch(summed[dp:], dp, spec.emb_dim, fold)
            g_sum = summed[:dp]
            if col_slice:  # this rank's sublanes
                dpl = table.shape[0]
                g_sum, touch = (x[m * dpl:(m + 1) * dpl] for x in (g_sum, touch))
            if ok is not None:
                touch = touch & ok
            return opt.update_cols(g_sum, uq.ids, touch, leaf_state,
                                   table, live=slots < uq.count)
        touch, ids = ok, flat
        if row_slice:
            ids, own = owned(flat, table.shape[0])
            g = g * own[:, None].to(g.dtype)
        if col_slice:
            dl = table.shape[1]
            g = g[:, m * dl:(m + 1) * dl]
        uq = unique_pad(ids, n, table.shape[0] - 1)
        summed = segment_sum_rows(g, uq.inverse, n)
        if row_slice:  # rows no owned position names stay untouched
            present = segment_sum_rows(own[:, None].float(), uq.inverse, n) > 0
            touch = present if ok is None else present & ok
        return opt.update_rows(summed, uq.ids, leaf_state, table, touch=touch,
                               live=slots < uq.count)

    def step_generic(state: TrainState, batch):
        """The generic path (``use_pallas=False``, module docstring)."""
        dev = state.step.device
        with span("meta", dev):
            ids_g = {g: _group_ids(batch, info["keys"])
                     for g, info in table_groups.items()}
            rows_in, flats = generic_rows(state.params, ids_g)
        names = list(rows_in)

        def rows_of(rp):
            rows = {}
            for name, r in zip(names, rp):
                spec = table_specs[name][1]
                if spec.fold > 1:
                    sub_f = torch.remainder(flats[name], spec.fold)
                    r = r * fold_mask_rows(r.shape[1], spec.emb_dim, sub_f,
                                            r.dtype)
                else:
                    r = r[:, : spec.emb_dim]  # drop sublane padding
                rows[name] = r.reshape(*ids_g[group_of[name]].shape[:2], -1)
            return rows

        dense_grads, g_rows, losses, rng = run_model(
            state.params, batch["label"], [rows_in[n] for n in names],
            lambda p, rp, sub: call_rows(p, rows_of(rp), batch, sub),
            state.rng)
        finite, dense_grads, g_rows = guard(dense_grads, g_rows, dev)
        grads_of = dict(zip(names, g_rows))
        with span("update", dev):
            with span("update.dense", dev):
                new_params, opt_w_state, opt_d_state = dense_updates(
                    state, dense_grads, finite)
            # the generic path sums each table's gradients per id inside
            # its update
            with span("update.tables", dev):
                for key, (name, path, spec) in table_keys.items():
                    opt, states = ((opt_w, opt_w_state) if is_wide_key(key)
                                   else (opt_d, opt_d_state))
                    g, flat = grads_of[name], flats[name]
                    if n_data > 1:  # the global batch's positions, per rank
                        g = all_gather(g.contiguous(), DATA_AXIS, mesh)
                        flat = all_gather(flat.contiguous(), DATA_AXIS, mesh)
                    _t, st = generic_table_update(
                        opt, g, flat, states[key], _get(state.params, path),
                        spec, finite, shard=name in sliced)
                    states[key] = _keep_unless(finite, st, states[key])
            return TrainState(new_params, opt_w_state, opt_d_state,
                              state.step + 1, rng), losses

    if not sparse:
        step = step_dense
    elif generic:
        step = step_generic
    else:
        step = step_rows if row_layout else step_cols
    if mesh is not None:
        step = _take_data_slice(step, mesh)
    step.takes_device_batches = True  # RecModel stages batches for it
    if jit:
        return CapturedStep(step, donate=donate)
    return step if donate else _non_donating(step)


def _take_data_slice(step, mesh):
    """``step`` on this data rank's slice of a :class:`FullBatch`."""
    def run(state: TrainState, batch):
        if isinstance(batch, FullBatch):
            batch = shard_batch(dict(batch), mesh)
        return step(state, batch)

    run.__name__ = step.__name__
    return run


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


def _clone_state(state: TrainState) -> TrainState:
    """A copy of every tensor of the state."""
    def copy(_key, x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    return TrainState(*(map_leaves(copy, x) for x in state))


def _non_donating(step):
    """``step`` run on a copy of the state (``donate=False``)."""
    def run(state: TrainState, batch):
        return step(_clone_state(state), batch)

    run.takes_device_batches = True
    return run


def _step_in_place(step, state: TrainState, batch):
    """Run ``step`` and copy every leaf it replaced into ``state``'s own
    tensors (the tables it already updates in place), so that ``state``
    stays the live state at fixed addresses."""
    new, losses = step(state, batch)
    with span("update", state.step.device):
        for old, fresh in zip(_state_tensors(state), _state_tensors(new)):
            if fresh is not old:
                old.copy_(fresh)
    return losses


class _Captured(NamedTuple):
    """One batch signature's capture: the step's graphs in capture order
    (one memory pool), the collective recorded after each graph but the
    last (``parallel/mesh.py``), the static batch and losses, and the
    kernel launches one replay makes."""

    graphs: list
    cuts: list
    static: dict
    losses: tuple
    per_replay: dict

    def replay(self) -> None:
        """Every graph and collective, strictly in capture order: a
        graph's tensors freed in capture may back a later graph's."""
        for graph, cut in itertools.zip_longest(self.graphs, self.cuts):
            graph.replay()
            if cut is not None:
                cut.run()


@contextlib.contextmanager
def _capture_segments(graphs: list, cuts: list):
    """Capture the calling thread's work into ``graphs``: a new graph, in
    the first one's memory pool, after each collective, which is appended
    to ``cuts`` (``mesh.recording``)."""
    live = []  # the graph being captured

    def begin():
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=graphs[0].pool() if graphs else None)
        graphs.append(g)
        live.append(g)

    def end():
        live.pop().capture_end()

    def cut(rec):
        end()
        cuts.append(rec)
        begin()

    begin()
    try:
        with recording(cut):
            yield
    finally:
        if live:
            end()


class CapturedStep:
    """The train step captured in CUDA graphs per batch signature (type,
    keys, shapes, dtypes) and state, then replayed: the counterpart of
    the reference's ``jax.jit(step, donate_argnums=(0,))``.

    The first call of a signature runs the step eagerly on a side stream
    (the warm-up: it builds the kernel library, asks the kernels' scratch
    sizes and makes every lazily cached tensor, and it is this batch's
    real step), then captures one step over static copies of the batch
    (of the batch's own type, so a ``FullBatch`` is still sliced).  On one
    device that is one ``torch.cuda.CUDAGraph``.  On a mesh every
    collective of ``parallel/mesh.py`` ends one graph and starts the next
    (``mesh.recording``): the graphs share one memory pool, every tensor
    that crosses a cut (a collective's source and its output) is held
    with them, and a replay runs graph 0, collective 0, graph 1, ... in
    capture order, each collective from its fixed source into its fixed
    output, eagerly between two replays (gloo through pinned host memory,
    NCCL on the card).  A capture does not communicate, so the ranks stay
    in step whichever of them captures: its warm-up makes the same
    collectives as a replay.  Later calls copy the batch into the static
    inputs and replay.  The graphs update the caller's
    :class:`TrainState` in place (every leaf keeps its address) and the
    returned losses are copies that the next replay does not overwrite.
    A bucket regrow is a new signature and gets one new capture; graphs
    of the live state's earlier signatures are kept for batches still in
    flight.  A call with another state (a callback replaced it) drops
    every graph, and with it every private memory pool, held for the
    state it replaces: that state was donated, so no graph of it can be
    replayed again.  A capture that fails raises: it never falls back to
    the eager step.

    ``donate=False``: the caller's state is copied into a state the
    captured step owns (cloned at the first call and whenever the shapes
    change), the graphs replay on that one, and the call returns a copy
    of it; the state passed in is left as it was.

    A kernel wrapper counts its launch when a graph is captured, not on
    each replay.  Since :meth:`reset_counts`, ``recorded`` sums what the
    captures counted (launches put into graphs, not run) and ``replayed``
    what the replays launched, so the kernels' real launches are
    ``LAUNCHES - recorded + replayed`` (:func:`real_launches`);
    ``segments`` gives the graphs of each signature held.  On a CPU state
    the call is the eager step."""

    takes_device_batches = True  # RecModel stages batches for it

    def __init__(self, step, donate: bool = True):
        self.step = step
        self.donate = donate
        self._own = None  # donate=False: the state the graphs run on
        self._graphs = {}  # batch signature -> _Captured, for the live state
        self._state = None
        self._state_key = None
        self.reset_counts()

    @property
    def graphs(self) -> int:
        """Captures held: one per batch signature of the live state."""
        return len(self._graphs)

    @property
    def segments(self) -> list[int]:
        """Graphs per capture held (1 without a mesh; on a mesh one more
        than the step's collectives)."""
        return [len(c.graphs) for c in self._graphs.values()]

    def reset_counts(self) -> None:
        self.captures = self.replays = 0
        self.recorded = {}  # kernel -> launches counted by captures
        self.replayed = {}  # kernel -> launches made by replays

    def __call__(self, state: TrainState, batch):
        if state.step.device.type != "cuda":
            return self.step(state if self.donate else _clone_state(state),
                             batch)
        if not self.donate:
            own = self._own
            spec = [(t.shape, t.dtype, t.device)
                    for t in _state_tensors(state)]
            if own is None or spec != [(t.shape, t.dtype, t.device)
                                       for t in _state_tensors(own)]:
                own = self._own = _clone_state(state)
            else:
                for dst, src in zip(_state_tensors(own), _state_tensors(state)):
                    dst.copy_(src)
            _same, losses = self._donated(own, batch)
            return _clone_state(own), losses
        return self._donated(state, batch)

    def _donated(self, state: TrainState, batch):
        if state is not self._state:
            key = _state_key(state)
            if key != self._state_key:
                self._graphs.clear()  # the replaced state's graphs
                self._state_key = key
            self._state = state
        sig = (type(batch), tuple((k, tuple(v.shape), v.dtype, str(v.device))
                                  for k, v in sorted(batch.items())))
        cap = self._graphs.get(sig)
        if cap is None:
            with span("captured.capture"):
                return state, self._capture(sig, state, batch)
        with span("inputs", state.step.device):
            for k, v in batch.items():
                cap.static[k].copy_(v)
        with span("captured.replay"):
            cap.replay()
        self.replays += 1
        for k, n in cap.per_replay.items():
            self.replayed[k] = self.replayed.get(k, 0) + n
        return state, tuple(x.clone() for x in cap.losses)

    def _capture(self, key, state, batch):
        from mindrec_tpu_torch.data.criteo import STAGING_LOCK
        from mindrec_tpu_torch.ops.kernels import LAUNCHES

        dev = state.step.device
        with torch.cuda.device(dev):
            cur = torch.cuda.current_stream(dev)
            static = type(batch)({k: v.clone() for k, v in batch.items()})
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                losses = tuple(x.clone() for x in
                               _step_in_place(self.step, state, static))
            cur.wait_stream(side)
            before = dict(LAUNCHES)
            graphs, cuts = [], []
            # the input pipeline's staging thread waits while we capture,
            # and no garbage collection runs until the last graph is
            # captured: a collected CUDA graph destroys its executable,
            # which invalidates a capture in progress
            collecting = gc.isenabled()
            gc.disable()
            try:
                with STAGING_LOCK:
                    torch.cuda.synchronize(dev)
                    torch.cuda.empty_cache()
                    with torch.cuda.stream(side), _capture_segments(graphs, cuts):
                        out = _step_in_place(self.step, state, static)
            finally:
                if collecting:
                    gc.enable()
        per_replay = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                      if LAUNCHES[k] != before[k]}
        self._graphs[key] = _Captured(graphs, cuts, static, out, per_replay)
        self.captures += 1
        for k, n in per_replay.items():
            self.recorded[k] = self.recorded.get(k, 0) + n
        return losses


def real_launches(step) -> dict:
    """Kernel launches since the counters were set to 0
    (``ops.kernels.reset_launches`` and, for a :class:`CapturedStep`,
    its ``reset_counts``).  A captured step's wrappers count their
    launches when a graph is captured, so its recorded launches are taken
    out and its replays' launches added."""
    from mindrec_tpu_torch.ops.kernels import LAUNCHES

    out = dict(LAUNCHES)
    if isinstance(step, CapturedStep):
        for k in out:
            out[k] += step.replayed.get(k, 0) - step.recorded.get(k, 0)
    return out


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
