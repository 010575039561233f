"""Wide&Deep CTR model.

Port of ``mindrec_tpu/models/wide_deep.py``: the config, the parameter
layout of ``init`` (nested dicts with the reference's keys, so
``train/step.py`` splits wide and deep parameters by the same path
names), the forward with the lookups inside (``apply``,
``apply_batch``: the dense step's entry) and from pre-gathered rows
(``apply_rows``: the sparse steps'), the loss with the ``no_l2loss``
rule and ``sigmoid_cross_entropy``.

* forward: ``wide = sum_f(w[id_f] * wt_f) + b``;
  ``deep = MLP(concat_f(emb[id_f] * wt_f))``; ``logit = wide + deep``.
* the MLP stays bfloat16 end to end under ``use_mixed_precision``; its
  matmuls are plain ``torch.matmul``.
* dropout (``train`` with ``dropout_flag`` and ``keep_prob < 1`` and a
  key): inverted, before every layer's matmul, the first included (so
  the embedding input is dropped too), one subkey per layer split off
  the step's key (``ops/prng.py``);
* loss: mean sigmoid cross-entropy; the deep side adds
  ``l2_coef * sum(table^2) / 2`` unless sparse or PS.
* ``mesh`` (``parallel/mesh.py``): with ``deep_table_slice_mode`` the
  deep table is this rank's block; the lookups and the l2 term read it
  per shard and sum over ``model``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from mindrec_tpu_torch.ops import prng
from mindrec_tpu_torch.ops.embedding import EmbeddingTableSpec, lookup, sharded
from mindrec_tpu_torch.parallel.mesh import sum_over

ACTS = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh}


@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    """Defaults = the reference accuracy recipe (same fields as the JAX
    package's config)."""

    batch_size: int = 16000
    field_size: int = 39
    vocab_size: int = 200000
    emb_dim: int = 80
    deep_layer_dim: Sequence[int] = (1024, 512, 256, 128)
    deep_layer_act: str = "relu"
    keep_prob: float = 1.0
    dropout_flag: bool = False
    use_mixed_precision: bool = True
    sparse: bool = False
    dynamic_embedding: bool = False
    vocab_cache_size: int = 0
    parameter_server: bool = False
    deep_table_slice_mode: str = "none"
    l2_coef: float = 8e-5
    loss_scale: float = 1024.0
    init_args: tuple = (-0.01, 0.01)
    table_dtype: str = "float32"
    table_layout: str = "auto"

    @property
    def no_l2loss(self) -> bool:
        return self.parameter_server or self.sparse or self.dynamic_embedding


class WideDeepModel:
    """Functional Wide&Deep: ``init`` builds the parameter dict, the
    forward takes it as an argument (as the reference does)."""

    WIDE_KEYS = ("wide",)

    def __init__(self, config: WideDeepConfig, mesh=None):
        c = config
        self.mesh = mesh
        # the cache (vocab_cache_size) and dynamic-embedding regimes leave
        # the model as it is: train/cached.py and train/dynamic.py carry
        # them (the model is built with vocab_size = cache rows / capacity).
        # PS mode without the cache declares host tables, which
        # train/host_target.py trains (the reference's CPU-target lookup)
        target = ("host" if c.parameter_server and c.vocab_cache_size == 0
                  else "device")
        self.config = c
        self.wide_spec = EmbeddingTableSpec(
            vocab_size=c.vocab_size, emb_dim=1, name="wide_embedding",
            sparse=c.sparse, target=target, init_args=c.init_args,
            dtype=c.table_dtype, layout=c.table_layout,
        )
        self.deep_spec = EmbeddingTableSpec(
            vocab_size=c.vocab_size, emb_dim=c.emb_dim, name="deep_embedding",
            slice_mode=c.deep_table_slice_mode, sparse=c.sparse, target=target,
            init_args=c.init_args, dtype=c.table_dtype, layout=c.table_layout,
        )
        dims = [c.field_size * c.emb_dim, *c.deep_layer_dim, 1]
        self.mlp_dims = list(zip(dims[:-1], dims[1:]))
        self.act = ACTS[c.deep_layer_act]

    @property
    def table_specs(self):
        return {
            "wide": (("wide", "table"), self.wide_spec),
            "deep": (("deep", "table"), self.deep_spec),
        }

    def init(self, generator: torch.Generator, device="cuda",
             tables: bool = True) -> dict:
        """Random parameters (N(0, 0.01) MLP, tables per their spec);
        ``tables=False`` leaves the tables out, never building them (the
        host-target regime's dense state)."""
        def normal(*shape):
            return 0.01 * torch.randn(shape, generator=generator,
                                      dtype=torch.float32, device=device)

        mlp = [{"w": normal(i, o), "b": normal(o)} for i, o in self.mlp_dims]
        wide = {"table": self.wide_spec.init_table(generator, device)} if tables else {}
        wide["bias"] = normal(1)
        deep = {"table": self.deep_spec.init_table(generator, device)} if tables else {}
        deep["mlp"] = mlp
        return {"wide": wide, "deep": deep}

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
        """Forward from pre-gathered rows ``{"wide": [B,F,1],
        "deep": [B,F,D]}`` and weights ``wts [B,F]`` -> logits [B, 1].
        A folded feature-major wide table gives ``[B,F,8]`` rows with
        only the owning sublane nonzero; the wide sum covers them too."""
        c = self.config
        wide_rows, deep_rows = rows["wide"], rows["deep"]
        mask = wts[:, :, None].to(deep_rows.dtype)
        wide_out = torch.sum(
            wide_rows * wts[:, :, None].to(wide_rows.dtype), dim=(1, 2),
            dtype=torch.float32,
        )
        wide_out = wide_out[:, None] + params["wide"]["bias"]
        deep_in = (deep_rows * mask).reshape(-1, c.field_size * c.emb_dim)
        return wide_out + self._mlp(params["deep"]["mlp"], deep_in, train, rng)

    def apply(self, params, ids, wts, train=False, rng=None):
        """Forward with the lookups inside: ``ids``, ``wts`` [B, F]."""
        rows = {
            name: lookup(spec, params[path[0]][path[1]], ids, self.mesh)
            for name, (path, spec) in self.table_specs.items()
        }
        return self.apply_rows(params, rows, wts, train, rng)

    def apply_batch(self, params, batch, train=False, rng=None):
        """Model-agnostic entry of the dense step."""
        return self.apply(params, batch["ids"], batch["wts"], train, rng)

    def predict(self, params, ids, wts):
        """Eval head: sigmoid of the logits."""
        return torch.sigmoid(self.apply(params, ids, wts))

    def predict_batch(self, params, batch):
        return self.predict(params, batch["ids"], batch["wts"])

    def loss(self, params, logits, label):
        """(wide_loss, deep_loss): mean sigmoid-CE; the deep side adds the
        table l2 term unless sparse/PS."""
        ce = torch.mean(sigmoid_cross_entropy(logits, label))
        if self.config.no_l2loss:
            return ce, ce
        l2 = 0.5 * torch.sum(torch.square(params["deep"]["table"].float()))
        if sharded(self.deep_spec, self.mesh):
            l2 = sum_over(l2, "model", self.mesh)
        return ce, ce + self.config.l2_coef * l2


def sigmoid_cross_entropy(logits, labels):
    """Numerically stable sigmoid cross-entropy with logits."""
    labels = labels.to(logits.dtype)
    return (
        torch.clamp(logits, min=0.0)
        - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
