"""Plain float32 reference of the sparse Wide&Deep training step.

One step, from a raw batch ``{"ids" [B,F], "wts" [B,F], "label" [B,1]}``:

1. the distinct ids of the batch and each position's index into them
   (``torch.unique``), worked out here from the raw ids;
2. each table's rows at those ids (a gather), expanded to the batch's
   positions;
3. ``logit = sum_f w[id_f] wt_f + b + MLP(concat_f(e[id_f] wt_f))``, the
   mean sigmoid cross-entropy (no l2 term: the sparse recipe's rule);
4. autograd: the expansion's backward sums the gradients of an id's
   duplicate positions into its row;
5. FTRL on the wide table's present rows and on the wide bias, Adam on
   the deep table's present rows (lazy: its own step count, the other
   rows and their state untouched) and on every MLP leaf.

Keys follow the parameter paths: ``wide/table``, ``wide/bias``,
``deep/table``, ``deep/mlp/<i>/w`` and ``deep/mlp/<i>/b``;
:func:`leaves` gives them with their shapes.
"""

from __future__ import annotations

import torch

from portbench.reference.common import (
    Trainer, mean_loss, mlp, mlp_leaves, no_tf32,
)

TABLES = ("wide/table", "deep/table")


def leaves(config: dict) -> list[tuple[str, tuple]]:
    """(key, shape) of every parameter leaf; tables logical
    ``[vocab, dim]``."""
    c = config
    dims = [c["field_size"] * c["emb_dim"], *c["deep_layer_dim"], 1]
    return ([("wide/table", (c["vocab_size"], 1)),
             ("deep/table", (c["vocab_size"], c["emb_dim"]))]
            + mlp_leaves(dims) + [("wide/bias", (1,))])


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
        dev = p["deep/table"].device
        ids = torch.as_tensor(batch["ids"], device=dev).long()
        wts = torch.as_tensor(batch["wts"], device=dev).float()
        label = torch.as_tensor(batch["label"], device=dev).float()
        B, F = ids.shape
        uq, inv = torch.unique(ids.reshape(-1), return_inverse=True)
        with no_tf32(), torch.enable_grad():
            rows = {k: p[k][uq].requires_grad_(True) for k in TABLES}
            mlp_keys = [(f"deep/mlp/{i}/w", f"deep/mlp/{i}/b")
                        for i in range(self.n_layers)]
            dense = {k: p[k].requires_grad_(True)
                     for pair in mlp_keys for k in pair}
            dense["wide/bias"] = p["wide/bias"].requires_grad_(True)
            w_pos = rows["wide/table"][inv].reshape(B, F)
            e_pos = rows["deep/table"][inv].reshape(B, F, -1)
            wide = (w_pos * wts).sum(1, keepdim=True) + dense["wide/bias"]
            deep_in = (e_pos * wts[:, :, None]).reshape(B, -1)
            deep = mlp([(dense[w], dense[b]) for w, b in mlp_keys], deep_in,
                       self.precision)
            loss = mean_loss(wide + deep, label, self.half_batch)
            keys = list(rows) + list(dense)
            grads = torch.autograd.grad(
                loss, [rows[k] for k in rows] + [dense[k] for k in dense])
        for k in dense:
            p[k] = p[k].detach()
        with torch.no_grad():
            for k, g in zip(keys, grads):
                self.update(k, g, uq if k in TABLES else None)
        return float(loss.detach())
