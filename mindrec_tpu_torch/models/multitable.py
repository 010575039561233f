"""Multitable Wide&Deep (Outbrain).

Port of ``mindrec_tpu/models/multitable.py`` (the reference's
``wide_and_deep_multitable/src/wide_and_deep.py:110-560``):

* 4 embedding tables: 128-dim x 650k, 64-dim single x 17.3k, 64-dim
  multi-hot x 20.9k (shared by 6 multi-hot fields), 64-dim indicator x
  16, plus a ``[V, 1]`` wide weight table for each, all in feature-major
  storage (the reference's default);
* the 6 multi-hot fields are mask-multiplied then averaged over the
  **full** hot length (divide by L, not by the mask sum);
* wide tower: continue-value weights plus the per-table wide weights;
* loss: both heads plain mean sigmoid cross-entropy (no l2).

The sparse step (``train/step.py``) reads :attr:`table_specs` and
:attr:`table_groups` (8 tables over 4 id spaces; the ``multi`` group
declares ``mask_keys`` so host prep may compact masked positions) and
calls :meth:`apply_groups_batch` with each group's batch-order rows: with
the bf16 MLP the feature assembly (``ops/kernels/assemble.py``: one
kernel pair on the card, its plain version on the CPU), in float32
:meth:`apply_rows_batch` over the per-table slices.  The dense step calls :meth:`apply_batch` (the
lookups inside).  With ``dropout_flag`` and ``keep_prob < 1`` the
deep tower drops its input and every hidden layer before each matmul,
as Wide&Deep's does.

Batch layout (dict): ``continue_val [B,32] f32``, ``indicator_id
[B,Fi] i32``, ``emb_128_id [B,F128] i32``, ``emb_64_single_id [B,F64]
i32``, 6x (``multi_<name>_id [B,Lk] i32`` + ``multi_<name>_mask [B,Lk]
f32``), ``label [B,1] f32``, ``display_id [B] i32``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from mindrec_tpu_torch.models.wide_deep import ACTS, sigmoid_cross_entropy
from mindrec_tpu_torch.ops import prng
from mindrec_tpu_torch.ops.embedding import EmbeddingTableSpec, lookup
from mindrec_tpu_torch.ops.group_rows import table_rows
from mindrec_tpu_torch.ops.kernels.assemble import (
    AsmGroup, assemble, assemble_plain,
)
from mindrec_tpu_torch.utils.profiling import backward_span, span

MULTI_FIELDS = (
    "doc_ad_category",
    "doc_event_entity",
    "doc_ad_entity",
    "doc_event_topic",
    "doc_event_category",
    "doc_ad_topic",
)


@dataclasses.dataclass(frozen=True)
class MultiTableConfig:
    """Defaults = the reference constants (same fields as the JAX
    package's config)."""

    batch_size: int = 131072
    continue_field_size: int = 32
    indicator_field_size: int = 13
    emb128_field_size: int = 3
    emb64_single_field_size: int = 6
    multi_hot_sizes: Sequence[int] = (3, 10, 10, 10, 3, 3)
    emb_128_size: int = 650000
    emb64_single_size: int = 17300
    emb64_multi_size: int = 20900
    indicator_size: int = 16
    deep_layer_dim: Sequence[int] = (1024, 1024, 1024, 1024, 1024)
    deep_layer_act: str = "relu"
    keep_prob: float = 1.0
    dropout_flag: bool = False
    use_mixed_precision: bool = True
    loss_scale: float = 1000.0
    ftrl_lr: float = 5e-2
    adam_lr: float = 3.5e-4
    init_args: tuple = (-0.01, 0.01)
    sparse: bool = False
    emb128_slice_mode: str = "none"

    @property
    def input_emb_dim(self) -> int:
        return (
            self.continue_field_size
            + self.indicator_field_size * 64
            + self.emb128_field_size * 128
            + self.emb64_single_field_size * 64
            + len(MULTI_FIELDS) * 64
        )


class MultiTableWideDeepModel:
    WIDE_KEYS = ("wide",)

    def __init__(self, config: MultiTableConfig, mesh=None):
        c = config
        self.mesh = mesh  # emb128_slice_mode splits emb128 over its model axis
        self.config = c
        self._pool_cache = {}  # device -> _make_pool_matrix(device)

        def mk(name, vocab, dim, slice_mode="none"):
            return EmbeddingTableSpec(
                vocab_size=vocab, emb_dim=dim, name=name,
                init_args=c.init_args, sparse=c.sparse, slice_mode=slice_mode,
                layout="feature_major",  # the reference's default
            )

        self.specs = {
            "emb128": mk("emb128_embedding", c.emb_128_size, 128,
                         c.emb128_slice_mode),
            "emb64_single": mk("emb64_single", c.emb64_single_size, 64),
            "emb64_multi": mk("emb64_multi", c.emb64_multi_size, 64),
            "emb64_indicator": mk("emb64_indicator", c.indicator_size, 64),
            "w128": mk("wide_emb128_w", c.emb_128_size, 1),
            "w64_single": mk("wide_emb64_single_w", c.emb64_single_size, 1),
            "w64_multi": mk("wide_emb64_multi_w", c.emb64_multi_size, 1),
            "w_indicator": mk("wide_indicator_w", c.indicator_size, 1),
        }
        dims = [c.input_emb_dim, *c.deep_layer_dim, 1]
        self.mlp_dims = list(zip(dims[:-1], dims[1:]))
        self.act = ACTS[c.deep_layer_act]

    _PATHS = {
        "emb128": ("deep", "emb128"),
        "emb64_single": ("deep", "emb64_single"),
        "emb64_multi": ("deep", "emb64_multi"),
        "emb64_indicator": ("deep", "emb64_indicator"),
        "w128": ("wide", "emb128_w"),
        "w64_single": ("wide", "emb64_single_w"),
        "w64_multi": ("wide", "emb64_multi_w"),
        "w_indicator": ("wide", "indicator_w"),
    }

    @property
    def table_specs(self):
        return {name: (self._PATHS[name], spec)
                for name, spec in self.specs.items()}

    @property
    def table_groups(self):
        return {
            "indicator": {
                "keys": ("indicator_id",),
                "tables": ("emb64_indicator", "w_indicator"),
            },
            "emb128": {"keys": ("emb_128_id",), "tables": ("emb128", "w128")},
            "emb64_single": {
                "keys": ("emb_64_single_id",),
                "tables": ("emb64_single", "w64_single"),
            },
            "multi": {
                "keys": tuple(f"multi_{n}_id" for n in MULTI_FIELDS),
                "tables": ("emb64_multi", "w64_multi"),
                # mask == 0 positions have exactly zero gradient (both
                # towers multiply by the mask), so host prep may compact
                # them out of the group's sorted backward stream
                "mask_keys": tuple(f"multi_{n}_mask" for n in MULTI_FIELDS),
            },
        }

    def init(self, generator: torch.Generator, device="cuda") -> dict:
        """Random parameters (N(0, 0.01) MLP and continue weights, tables
        per their spec) in the reference's layout."""
        def normal(*shape):
            return 0.01 * torch.randn(shape, generator=generator,
                                      dtype=torch.float32, device=device)

        tables = {name: spec.init_table(generator, device)
                  for name, spec in self.specs.items()}
        c = self.config
        return {
            "deep": {
                "emb128": tables["emb128"],
                "emb64_single": tables["emb64_single"],
                "emb64_multi": tables["emb64_multi"],
                "emb64_indicator": tables["emb64_indicator"],
                "mlp": [{"w": normal(i, o), "b": normal(o)}
                        for i, o in self.mlp_dims],
            },
            "wide": {
                "continue_w": normal(c.continue_field_size),
                "emb128_w": tables["w128"],
                "emb64_single_w": tables["w64_single"],
                "emb64_multi_w": tables["w64_multi"],
                "indicator_w": tables["w_indicator"],
                "bias": normal(1),
            },
        }

    def _pool_matrix(self, device):
        """``[sum(Lk), 6]`` field one-hot and the float32 ``1/Lk`` per
        field: one matmul and one small multiply give the 6 masked
        full-length means.  Made once per device: the host-to-device
        copy of ``1/Lk`` cannot run inside a captured step."""
        key = str(device)
        if key not in self._pool_cache:
            self._pool_cache[key] = self._make_pool_matrix(device)
        return self._pool_cache[key]

    def _make_pool_matrix(self, device):
        sizes = self.config.multi_hot_sizes
        p = torch.zeros((sum(sizes), len(sizes)), dtype=torch.float32,
                        device=device)
        off = 0
        for f, lk in enumerate(sizes):
            p[off: off + lk, f] = 1.0
            off += lk
        inv_l = torch.tensor([1.0 / lk for lk in sizes], dtype=torch.float32,
                             device=device)
        return p, inv_l

    def _mlp(self, mlp_params, x, train=False, rng=None):
        c = self.config
        dtype = torch.bfloat16 if c.use_mixed_precision else torch.float32
        # the span's device time is the train step's MLP, forward and
        # backward; an eval forward takes no gradient and marks nothing
        with span("mlp", x.device if x.requires_grad else None):
            h = x.to(dtype)
            n = len(mlp_params)
            for i, layer in enumerate(mlp_params):
                if (train and c.dropout_flag and c.keep_prob < 1.0
                        and rng is not None):
                    rng, sub = prng.split(rng)
                    h = prng.dropout(h, c.keep_prob, sub)
                h = torch.matmul(h, layer["w"].to(dtype)) + layer["b"].to(dtype)
                if i < n - 1:
                    h = self.act(h)
            backward_span("mlp", h, x)
            return h.float()

    def apply_rows_batch(self, params, rows, batch, train=False, rng=None):
        """Forward from pre-gathered rows (the sparse step's entry).

        ``rows`` is keyed by table name: deep tables give ``[B, F_g, D]``,
        wide tables ``[B, F_g, 1]`` (or ``[B, F_g, 8]`` for a folded
        feature-major table, only the owning sublane nonzero); the multi
        group's ``F_g`` is the 6 multi-hot fields concatenated in
        ``MULTI_FIELDS`` order."""
        w = params["wide"]
        cont = batch["continue_val"]
        B = cont.shape[0]

        # deep tower: one masked multiply over [B, sum(Lk), 64] and one
        # pooling matmul with float32 sums (the reference's bf16 einsum
        # with float32 accumulation)
        multi = rows["emb64_multi"]
        mask_all = torch.cat(
            [batch[f"multi_{n}_mask"] for n in MULTI_FIELDS], dim=1
        )
        masked = multi * mask_all[:, :, None].to(multi.dtype)
        pool_p, inv_l = self._pool_matrix(multi.device)
        pooled = (torch.einsum("bld,lf->bfd", masked.float(), pool_p)
                  * inv_l[None, :, None])
        deep_in = torch.cat([
            cont.float(),
            rows["emb64_indicator"].reshape(B, -1).float(),
            rows["emb128"].reshape(B, -1).float(),
            rows["emb64_single"].reshape(B, -1).float(),
            pooled.reshape(B, -1),
        ], dim=1)
        deep_out = self._mlp(params["deep"]["mlp"], deep_in, train, rng)

        # wide tower: folded wide rows are summed over their last axis
        val_w = torch.sum(cont * w["continue_w"][None, :], dim=1, keepdim=True)

        def wsum(r):
            return torch.sum(r, dim=(1, 2), dtype=torch.float32)[:, None]

        wmulti = torch.sum(rows["w64_multi"], dim=-1)  # [B, sum(Lk)]
        wm = torch.sum(wmulti * mask_all.to(wmulti.dtype), dim=1,
                       keepdim=True, dtype=torch.float32)
        wide_out = (val_w + wsum(rows["w_indicator"]) + wsum(rows["w128"])
                    + wsum(rows["w64_single"]) + wm + w["bias"])
        return wide_out + deep_out

    def apply_groups_batch(self, params, groups, batch, train=False,
                           rng=None, use_kernels=True):
        """The sparse step's entry: forward from each id group's rows in
        batch order (``ops/group_rows.py:GroupRows``, keyed as
        :attr:`table_groups`).  With the bf16 MLP and bf16 rows the
        feature assembly builds the MLP's input and the wide tables' sum
        (:meth:`apply_assembled`); otherwise :meth:`apply_rows_batch` over
        :func:`table_rows`' slices."""
        if (self.config.use_mixed_precision
                and all(gr.rows.dtype == torch.bfloat16
                        for gr in groups.values())):
            return self.apply_assembled(params, groups, batch, train, rng,
                                        use_kernels)
        return self.apply_rows_batch(
            params, table_rows(self.table_specs, groups), batch, train, rng)

    def assembly_groups(self, groups, batch) -> list:
        """The groups as :func:`assemble` reads them: each group's rows,
        ids and lanes, and the multi group's fields and masks, in
        :attr:`table_groups`' order, which is the deep input's
        (indicator, emb128, emb64_single, then the pooled multi group)."""
        parts = []
        for g, info in self.table_groups.items():
            gr = groups[g]
            deep, wide = info["tables"]
            pooled = "mask_keys" in info
            parts.append(AsmGroup(
                rows=gr.rows, ids=gr.ids, deep_off=gr.layout.offs[deep],
                deep_dim=self.specs[deep].emb_dim,
                wide_off=gr.layout.offs[wide], fold=self.specs[wide].fold,
                fields=tuple(self.config.multi_hot_sizes) if pooled else (),
                masks=tuple(batch[k] for k in info["mask_keys"]) if pooled
                else ()))
        return parts

    def apply_assembled(self, params, groups, batch, train=False, rng=None,
                        use_kernels=True):
        """:meth:`apply_rows_batch` through :func:`assemble` (the kernels
        on the card with ``use_kernels``, else their plain version): the
        deep input in bf16 (continuous values, the indicator, emb128 and
        single rows, the six pooled multi-hot means) and the wide tables'
        float32 sum, each group's rows read whole.  Only the continue
        term, the bias and the MLP stay here."""
        cont = batch["continue_val"]
        fn = assemble if use_kernels else assemble_plain
        deep_in, wide_sum = fn(self.assembly_groups(groups, batch), cont)
        deep_out = self._mlp(params["deep"]["mlp"], deep_in, train, rng)
        w = params["wide"]
        val_w = torch.sum(cont * w["continue_w"][None, :], dim=1, keepdim=True)
        return val_w + wide_sum + w["bias"] + deep_out

    def apply(self, params, batch, train=False, rng=None):
        """Forward with the lookups inside -> logits [B, 1]."""
        ids = {
            "emb64_indicator": batch["indicator_id"],
            "w_indicator": batch["indicator_id"],
            "emb128": batch["emb_128_id"],
            "w128": batch["emb_128_id"],
            "emb64_single": batch["emb_64_single_id"],
            "w64_single": batch["emb_64_single_id"],
        }
        multi_ids = torch.cat([batch[f"multi_{n}_id"] for n in MULTI_FIELDS],
                              dim=1)
        ids["emb64_multi"] = ids["w64_multi"] = multi_ids
        rows = {}
        for name, (path, spec) in self.table_specs.items():
            rows[name] = lookup(spec, params[path[0]][path[1]], ids[name],
                                self.mesh)
        return self.apply_rows_batch(params, rows, batch, train, rng)

    def apply_batch(self, params, batch, train=False, rng=None):
        return self.apply(params, batch, train, rng)

    def loss(self, params, logits, label):
        """(wide_loss, deep_loss): both the plain mean sigmoid CE."""
        ce = torch.mean(sigmoid_cross_entropy(logits, label))
        return ce, ce

    def predict(self, params, batch):
        return torch.sigmoid(self.apply(params, batch))

    def predict_batch(self, params, batch):
        return self.predict(params, batch)
