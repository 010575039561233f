"""Deep & Cross Network (DCN).

Port of ``mindrec_tpu/models/dcn.py``: the config, the parameter layout
of ``init`` (the reference's keys: ``emb/table``, ``cross``, ``mlp``,
``final``), the forward from pre-gathered rows and the loss.

* ``cross_layer_num`` rank-1 cross layers over the flattened masked
  embeddings ``x0``: ``x_{l+1} = x0 * (x_l @ w_l) + b_l + x_l`` with
  ``w_l``, ``b_l`` of size ``[F * D]``, in the promoted type of ``x0``
  and the float32 parameters;
* a parallel deep tower (every layer activated), bfloat16 under
  ``use_mixed_precision``;
* a final dense layer over ``concat(deep_out, cross_out)``;
* loss: mean sigmoid cross-entropy.

The reference pads the cross chain to a multiple of 128 lanes, a layout
trick of its hardware with no effect on the values; it is not carried
over.  As in the reference, ``keep_prob`` and ``dropout_flag`` are
config fields that the forward never reads (the forward takes ``train``
and ``rng`` like the other models' and ignores them).
``use_one_hot_embeddings`` looks the rows up as a one-hot
``[B*F, padded_vocab]`` product with a dense table (``torch.matmul``,
bf16 under mixed precision), as the reference's XLA dot does.
``table_slice_mode`` slices the table over the model axis of ``mesh``
(``parallel/mesh.py``): the lookup (one-hot or not) reads this rank's
block and sums over ``model``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from mindrec_tpu_torch.models.wide_deep import ACTS, sigmoid_cross_entropy
from mindrec_tpu_torch.ops.embedding import EmbeddingTableSpec, lookup, sharded
from mindrec_tpu_torch.parallel.mesh import sum_over


@dataclasses.dataclass(frozen=True)
class DCNConfig:
    """Defaults = the reference config (same fields as the JAX
    package's)."""

    batch_size: int = 16000
    field_size: int = 39
    vocab_size: int = 200000
    emb_dim: int = 27
    deep_layer_dim: Sequence[int] = (1024, 1024)
    cross_layer_num: int = 6
    deep_layer_act: str = "relu"
    keep_prob: float = 1.0
    dropout_flag: bool = False
    use_mixed_precision: bool = False
    sparse: bool = False
    # lookup as a one-hot matmul; needs a dense table
    use_one_hot_embeddings: bool = False
    loss_scale: float = 1.0
    learning_rate: float = 1e-4
    init_args: tuple = (-0.01, 0.01)
    table_slice_mode: str = "none"


class DCNModel:
    """Functional DCN: ``init`` builds the parameter dict, the forward
    takes it as an argument (as the reference does)."""

    WIDE_KEYS = ()

    def __init__(self, config: DCNConfig, mesh=None):
        c = config
        self.mesh = mesh  # table_slice_mode splits the table over its model axis
        self.config = c
        self.emb_spec = EmbeddingTableSpec(
            vocab_size=c.vocab_size, emb_dim=c.emb_dim, name="dcn_embedding",
            slice_mode=c.table_slice_mode, sparse=c.sparse,
            init_args=c.init_args,
        )
        self.input_size = c.field_size * c.emb_dim
        dims = [self.input_size, *c.deep_layer_dim]
        self.mlp_dims = list(zip(dims[:-1], dims[1:]))
        self.act = ACTS[c.deep_layer_act]

    @property
    def table_specs(self):
        return {"emb": (("emb", "table"), self.emb_spec)}

    def init(self, generator: torch.Generator, device="cuda") -> dict:
        """Random parameters (N(0, 0.01) dense layers and cross vectors,
        the table per its spec)."""
        c = self.config

        def normal(*shape):
            return 0.01 * torch.randn(shape, generator=generator,
                                      dtype=torch.float32, device=device)

        d = self.input_size
        return {
            "emb": {"table": self.emb_spec.init_table(generator, device)},
            "cross": [{"w": normal(d), "b": normal(d)}
                      for _ in range(c.cross_layer_num)],
            "mlp": [{"w": normal(i, o), "b": normal(o)}
                    for i, o in self.mlp_dims],
            "final": {"w": normal(d + c.deep_layer_dim[-1], 1),
                      "b": normal(1)},
        }

    def _cross_net(self, cross_params, x0):
        """``x_{l+1} = x0 * (x_l @ w_l) + b_l + x_l`` (rank-1 cross)."""
        if cross_params:
            x0 = x0.to(torch.promote_types(x0.dtype,
                                           cross_params[0]["w"].dtype))
        x = x0
        for layer in cross_params:
            xlw = torch.matmul(x, layer["w"])  # [B]
            x = x0 * xlw[:, None] + layer["b"][None, :] + x
        return x

    def _deep_net(self, mlp_params, x):
        dtype = (torch.bfloat16 if self.config.use_mixed_precision
                 else torch.float32)
        h = x.to(dtype)
        for layer in mlp_params:
            h = torch.matmul(h, layer["w"].to(dtype)) + layer["b"].to(dtype)
            h = self.act(h)
        return h.float()

    def apply_rows(self, params, rows, wts, train=False, rng=None):
        """Forward from pre-gathered rows ``{"emb": [B,F,D]}`` and weights
        ``wts [B,F]`` -> logits [B, 1]."""
        emb = rows["emb"]
        x0 = (emb * wts[:, :, None].to(emb.dtype)).reshape(-1, self.input_size)
        deep_out = self._deep_net(params["mlp"], x0)
        cross_out = self._cross_net(params["cross"], x0)
        h = torch.cat([deep_out, cross_out.to(deep_out.dtype)], dim=1)
        return torch.matmul(h, params["final"]["w"]) + params["final"]["b"]

    def apply(self, params, ids, wts, train=False, rng=None):
        """Forward with the lookup inside: ``ids``, ``wts`` [B, F]."""
        c = self.config
        table = params["emb"]["table"]
        if c.use_one_hot_embeddings:
            if c.sparse:
                raise ValueError("use_one_hot_embeddings requires a dense table")
            dtype = (torch.bfloat16 if c.use_mixed_precision
                     else torch.float32)
            flat = ids.reshape(-1, 1).long()
            split = sharded(self.emb_spec, self.mesh)
            m = self.mesh.axis_index("model") if split else 0
            if split and c.table_slice_mode == "table_row_slice":
                flat = flat - m * table.shape[0]  # this rank's rows
            oh = (flat == torch.arange(table.shape[0], device=flat.device)
                  ).to(dtype)  # ids outside the table give zero rows
            rows_flat = torch.matmul(oh, table.to(dtype)).float()
            if split and c.table_slice_mode == "table_column_slice":
                w = rows_flat.shape[1]
                rows_flat = torch.nn.functional.pad(
                    rows_flat, (m * w, c.emb_dim - (m + 1) * w))
            if split:
                rows_flat = sum_over(rows_flat, "model", self.mesh)
            rows = {"emb": rows_flat.reshape(*ids.shape, c.emb_dim)}
        else:
            rows = {"emb": lookup(self.emb_spec, table, ids, self.mesh)}
        return self.apply_rows(params, rows, wts, train, rng)

    def apply_batch(self, params, batch, train=False, rng=None):
        return self.apply(params, batch["ids"], batch["wts"], train, rng)

    def predict(self, params, ids, wts):
        """Eval head: sigmoid of the logits."""
        return torch.sigmoid(self.apply(params, ids, wts))

    def predict_batch(self, params, batch):
        return self.predict(params, batch["ids"], batch["wts"])

    def loss(self, params, logits, label):
        ce = torch.mean(sigmoid_cross_entropy(logits, label))
        return ce, ce
