"""Plain float32 reference of the sparse multitable (Outbrain)
Wide&Deep training step.

Tables (logical ``[vocab, dim]``): ``deep/emb128`` (the ``emb_128_id``
fields), ``deep/emb64_single`` (``emb_64_single_id``), ``deep/emb64_multi``
(the six multi-hot fields, one table), ``deep/emb64_indicator``
(``indicator_id``), and beside each a ``[vocab, 1]`` wide table
(``wide/emb128_w``, ``wide/emb64_single_w``, ``wide/emb64_multi_w``,
``wide/indicator_w``); dense leaves ``wide/continue_w [32]``,
``wide/bias [1]`` and the MLP ``deep/mlp/<i>/{w,b}``.

Forward (the reference model's): the deep input is the continuous
values, the indicator, emb128 and single rows, and per multi-hot field
the masked rows summed and divided by the field's full length L; the
wide output is ``continue_val . continue_w`` plus every wide row (the
multi-hot ones masked) plus the bias; the loss is the mean sigmoid
cross-entropy.  An id group's present ids (at any position, masked or
not: lossless prep) are its touched rows: FTRL on the wide tables, Adam
on the deep tables, each lazily; FTRL on ``continue_w`` and the bias and
Adam on every MLP leaf, whole.
"""

from __future__ import annotations

import torch

from portbench.sources.outbrain import MULTI_FIELDS
from portbench.reference.common import (
    Trainer, mean_loss, mlp, mlp_leaves, no_tf32,
)

GROUPS = {  # id group -> (batch keys, deep table, wide table)
    "indicator": (("indicator_id",), "deep/emb64_indicator",
                  "wide/indicator_w"),
    "emb128": (("emb_128_id",), "deep/emb128", "wide/emb128_w"),
    "emb64_single": (("emb_64_single_id",), "deep/emb64_single",
                     "wide/emb64_single_w"),
    "multi": (tuple(f"multi_{n}_id" for n in MULTI_FIELDS),
              "deep/emb64_multi", "wide/emb64_multi_w"),
}
TABLES = tuple(t for _k, d, w in GROUPS.values() for t in (d, w))


def leaves(config: dict) -> list[tuple[str, tuple]]:
    """(key, shape) of every parameter leaf; tables logical
    ``[vocab, dim]``."""
    c = config
    width = (c["continue_field_size"] + c["indicator_field_size"] * 64
             + c["emb128_field_size"] * 128
             + c["emb64_single_field_size"] * 64
             + len(c["multi_hot_sizes"]) * 64)
    vocab = {"emb128": c["emb_128_size"], "emb64_single": c["emb64_single_size"],
             "emb64_multi": c["emb64_multi_size"],
             "emb64_indicator": c["indicator_size"]}
    dims = {"emb128": 128, "emb64_single": 64, "emb64_multi": 64,
            "emb64_indicator": 64}
    deep = [(f"deep/{k}", (vocab[k], dims[k])) for k in vocab]
    wide = [(w, (vocab[d.split("/")[1]], 1))
            for _keys, d, w in (GROUPS["emb128"], GROUPS["emb64_single"],
                                GROUPS["multi"], GROUPS["indicator"])]
    return (deep + wide + mlp_leaves([width, *c["deep_layer_dim"], 1])
            + [("wide/continue_w", (c["continue_field_size"],)),
               ("wide/bias", (1,))])


class Reference(Trainer):
    def __init__(self, config: dict, weights: dict, precision="float32",
                 half_batch=False):
        super().__init__(weights, config["optimizers"], set(TABLES))
        self.config = config
        self.precision = precision
        self.half_batch = half_batch
        self.n_layers = len(config["deep_layer_dim"]) + 1

    def step(self, batch: dict) -> float:
        c, p = self.config, self.params
        dev = p["deep/emb128"].device

        def t(k, dtype=torch.float32):
            return torch.as_tensor(batch[k], device=dev).to(dtype)

        cont, label = t("continue_val"), t("label")
        B = cont.shape[0]
        mask = torch.cat([t(f"multi_{n}_mask") for n in MULTI_FIELDS], 1)
        uqs = {}
        for g, (keys, _d, _w) in GROUPS.items():
            ids = torch.cat([t(k, torch.long).reshape(B, -1) for k in keys], 1)
            uqs[g] = torch.unique(ids.reshape(-1), return_inverse=True)
        with no_tf32(), torch.enable_grad():
            rows = {}
            for g, (_k, d, w) in GROUPS.items():
                for k in (d, w):
                    rows[k] = p[k][uqs[g][0]].requires_grad_(True)
            mlp_keys = [(f"deep/mlp/{i}/w", f"deep/mlp/{i}/b")
                        for i in range(self.n_layers)]
            dense = {k: p[k].requires_grad_(True)
                     for pair in mlp_keys for k in pair}
            for k in ("wide/continue_w", "wide/bias"):
                dense[k] = p[k].requires_grad_(True)

            def pos(g, k):  # [B, F_g, dim] rows at the group's positions
                return rows[k][uqs[g][1]].reshape(B, -1, rows[k].shape[1])

            multi = pos("multi", "deep/emb64_multi") * mask[:, :, None]
            pooled, off = [], 0
            for L in c["multi_hot_sizes"]:
                pooled.append(multi[:, off:off + L].sum(1) / L)
                off += L
            deep_in = torch.cat([
                cont,
                pos("indicator", "deep/emb64_indicator").reshape(B, -1),
                pos("emb128", "deep/emb128").reshape(B, -1),
                pos("emb64_single", "deep/emb64_single").reshape(B, -1),
                torch.cat(pooled, 1),
            ], 1)
            deep = mlp([(dense[w], dense[b]) for w, b in mlp_keys], deep_in,
                       self.precision)
            wide = ((cont * dense["wide/continue_w"]).sum(1, keepdim=True)
                    + pos("indicator", "wide/indicator_w").sum((1, 2))[:, None]
                    + pos("emb128", "wide/emb128_w").sum((1, 2))[:, None]
                    + pos("emb64_single", "wide/emb64_single_w").sum((1, 2))[:, None]
                    + (pos("multi", "wide/emb64_multi_w")[:, :, 0] * mask)
                    .sum(1, keepdim=True)
                    + dense["wide/bias"])
            loss = mean_loss(wide + deep, label, self.half_batch)
            keys = list(rows) + list(dense)
            grads = torch.autograd.grad(
                loss, [rows[k] for k in rows] + [dense[k] for k in dense])
        for k in dense:
            p[k] = p[k].detach()
        group_of = {k: g for g, (_k, d, w) in GROUPS.items() for k in (d, w)}
        with torch.no_grad():
            for k, g in zip(keys, grads):
                self.update(k, g, uqs[group_of[k]][0] if k in group_of
                            else None)
        return float(loss.detach())
