"""DeepFM CTR model.

Port of ``mindrec_tpu/models/deepfm.py``: the config, the parameter
layout of ``init`` (the reference's keys: ``linear/table``, ``fm/table``,
``mlp``), the forward from pre-gathered rows and the loss.

* linear term: ``sum_f(w[id_f] * wt_f)``;
* FM pairwise term by the sum-square minus square-sum identity:
  ``0.5 * sum_d((sum_f v)^2 - sum_f v^2)``, reductions in float32;
* deep tower: MLP over the flattened masked embeddings, bfloat16 end to
  end under ``use_mixed_precision``, with Wide&Deep's inverted dropout
  when ``dropout_flag`` is set (off by default, as in the reference);
* loss: mean sigmoid cross-entropy, plus ``l2_coef / 2 * (|w|^2 +
  |V|^2)`` unless sparse.

No parameter path contains "wide", so ``train/step.py`` routes every
parameter to the deep optimizer (the reference's single-Adam recipe).
The reference sums over fields with a tiled-identity matmul, a layout
trick of its hardware; here the field sum is a float32 ``sum`` over the
field axis, the same value.  ``table_slice_mode`` slices ``fm_v`` over
the model axis of ``mesh`` (``parallel/mesh.py``): its lookups and l2
term read this rank's block and sum over ``model``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from mindrec_tpu_torch.models.wide_deep import ACTS, sigmoid_cross_entropy
from mindrec_tpu_torch.ops import prng
from mindrec_tpu_torch.ops.embedding import EmbeddingTableSpec, lookup, sharded
from mindrec_tpu_torch.parallel.mesh import sum_over


@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    """Defaults = the reference config (same fields as the JAX
    package's)."""

    batch_size: int = 16000
    field_size: int = 39
    vocab_size: int = 184965
    emb_dim: int = 80
    deep_layer_dim: Sequence[int] = (1024, 512, 256, 128)
    deep_layer_act: str = "relu"
    keep_prob: float = 0.9
    dropout_flag: bool = False
    use_mixed_precision: bool = True
    sparse: bool = False
    l2_coef: float = 8e-5
    loss_scale: float = 1024.0
    learning_rate: float = 5e-4
    epsilon: float = 5e-8
    init_args: tuple = (-0.01, 0.01)
    table_dtype: str = "float32"
    table_layout: str = "auto"  # auto | row_packed | feature_major
    table_slice_mode: str = "none"


class DeepFMModel:
    """Functional DeepFM: ``init`` builds the parameter dict, the forward
    takes it as an argument (as the reference does)."""

    WIDE_KEYS = ()

    def __init__(self, config: DeepFMConfig, mesh=None):
        c = config
        self.mesh = mesh  # table_slice_mode splits fm_v over its model axis
        self.config = c
        self.w_spec = EmbeddingTableSpec(
            vocab_size=c.vocab_size, emb_dim=1, name="fm_w", sparse=c.sparse,
            init_args=c.init_args, dtype=c.table_dtype, layout=c.table_layout,
        )
        self.v_spec = EmbeddingTableSpec(
            vocab_size=c.vocab_size, emb_dim=c.emb_dim, name="fm_v",
            slice_mode=c.table_slice_mode,
            sparse=c.sparse, init_args=c.init_args, dtype=c.table_dtype,
            layout=c.table_layout,
        )
        dims = [c.field_size * c.emb_dim, *c.deep_layer_dim, 1]
        self.mlp_dims = list(zip(dims[:-1], dims[1:]))
        self.act = ACTS[c.deep_layer_act]

    @property
    def table_specs(self):
        return {
            "linear": (("linear", "table"), self.w_spec),
            "fm": (("fm", "table"), self.v_spec),
        }

    def init(self, generator: torch.Generator, device="cuda") -> dict:
        """Random parameters (N(0, 0.01) MLP, tables per their spec)."""
        def normal(*shape):
            return 0.01 * torch.randn(shape, generator=generator,
                                      dtype=torch.float32, device=device)

        return {
            "linear": {"table": self.w_spec.init_table(generator, device)},
            "fm": {"table": self.v_spec.init_table(generator, device)},
            "mlp": [{"w": normal(i, o), "b": normal(o)}
                    for i, o in self.mlp_dims],
        }

    def _mlp(self, mlp_params, x, train=False, rng=None):
        c = self.config
        dtype = torch.bfloat16 if c.use_mixed_precision else torch.float32
        h = x.to(dtype)
        n = len(mlp_params)
        for i, layer in enumerate(mlp_params):
            if train and c.dropout_flag and c.keep_prob < 1.0 and rng is not None:
                rng, sub = prng.split(rng)
                h = prng.dropout(h, c.keep_prob, sub)
            h = torch.matmul(h, layer["w"].to(dtype)) + layer["b"].to(dtype)
            if i < n - 1:
                h = self.act(h)
        return h.float()

    def apply_rows(self, params, rows, wts, train=False, rng=None):
        """Forward from pre-gathered rows ``{"linear": [B,F,1], "fm":
        [B,F,D]}`` and weights ``wts [B,F]`` -> logits [B, 1].  A folded
        feature-major linear table gives ``[B,F,8]`` rows with only the
        owning sublane nonzero; the linear sum covers them too.  The
        elementwise work stays in the rows' type; reductions are taken
        in float32."""
        c = self.config
        w_rows, v_rows = rows["linear"], rows["fm"]
        linear_out = torch.sum(
            w_rows * wts[:, :, None].to(w_rows.dtype), dim=(1, 2),
            dtype=torch.float32,
        )[:, None]
        vx = v_rows * wts[:, :, None].to(v_rows.dtype)  # [B, F, D]
        field_sum = torch.sum(vx, dim=1, dtype=torch.float32)  # [B, D]
        v1 = torch.sum(torch.square(field_sum), dim=1)
        v2 = torch.sum(torch.square(vx.float()), dim=(1, 2))
        fm_out = (0.5 * (v1 - v2))[:, None]
        deep_in = vx.reshape(-1, c.field_size * c.emb_dim)
        return (linear_out + fm_out
                + self._mlp(params["mlp"], deep_in, train, rng))

    def apply(self, params, ids, wts, train=False, rng=None):
        """Forward with the lookups inside: ``ids``, ``wts`` [B, F]."""
        rows = {
            name: lookup(spec, params[path[0]][path[1]], ids, self.mesh)
            for name, (path, spec) in self.table_specs.items()
        }
        return self.apply_rows(params, rows, wts, train, rng)

    def apply_batch(self, params, batch, train=False, rng=None):
        return self.apply(params, batch["ids"], batch["wts"], train, rng)

    def predict(self, params, ids, wts):
        """Eval head: sigmoid of the logits."""
        return torch.sigmoid(self.apply(params, ids, wts))

    def predict_batch(self, params, batch):
        return self.predict(params, batch["ids"], batch["wts"])

    def loss(self, params, logits, label):
        """(loss, loss): mean sigmoid-CE; dense tables add their l2
        term (no table-wide l2 on the sparse path)."""
        ce = torch.mean(sigmoid_cross_entropy(logits, label))
        if self.config.sparse:
            return ce, ce
        v2 = torch.sum(torch.square(params["fm"]["table"].float()))
        if sharded(self.v_spec, self.mesh):
            v2 = sum_over(v2, "model", self.mesh)
        l2 = 0.5 * (
            torch.sum(torch.square(params["linear"]["table"].float())) + v2)
        loss = ce + self.config.l2_coef * l2
        return loss, loss
