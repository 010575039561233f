"""Plain float32 pieces shared by the references: the loss, the MLP, the
lower-precision control, and the trainer that applies each leaf's
optimizer rule (``portbench/optimizers/<kind>.py``).

Nothing here imports the program or JAX.  TF32 is switched off by
:func:`no_tf32` for every reference run, so a float32 matmul on the card
is float32.  On tables the rules are lazy: only the rows present in a
batch move, with the table's own step count.
"""

from __future__ import annotations

import contextlib

import torch

from portbench.optimizers import optimizer

E4M3_MAX = 448.0  # largest finite float8_e4m3fn
E5M2_MAX = 57344.0  # largest finite float8_e5m2


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls in float32 (not TF32) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _q(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to a float8 type with one scale per tensor (its
    largest magnitude maps to the type's largest finite value)."""
    s = x.abs().max().clamp_min(1e-30) / top
    return (x / s).to(dtype).to(torch.float32) * s


class Fp8MatMul(torch.autograd.Function):
    """``x @ w`` as float8 training computes it (Micikevicius et al.,
    2022): the forward's operands in e4m3, the gradient that flows back
    in e5m2, each with one scale per tensor; products accumulated in
    float32."""

    @staticmethod
    def forward(ctx, x, w):
        xq = _q(x, torch.float8_e4m3fn, E4M3_MAX)
        wq = _q(w, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _q(g, torch.float8_e5m2, E5M2_MAX)
        return gq @ wq.T, xq.T @ gq


def mlp(layers, h: torch.Tensor, precision: str) -> torch.Tensor:
    """ReLU MLP, no activation after the last layer.  ``precision``
    ``"float32"``: float32 operands; ``"fp8"`` (the control): every
    matmul in float8 (:class:`Fp8MatMul`)."""
    n = len(layers)
    for i, (w, b) in enumerate(layers):
        if precision == "fp8":
            h = Fp8MatMul.apply(h, w) + b
        else:
            h = h @ w + b
        if i < n - 1:
            h = torch.relu(h)
    return h


def mlp_leaves(dims: list[int]) -> list[tuple[str, tuple]]:
    """(key, shape) of an MLP's weights and biases for layer widths
    ``dims`` (input first)."""
    out = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out += [(f"deep/mlp/{i}/w", (a, b)), (f"deep/mlp/{i}/b", (b,))]
    return out


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample sigmoid cross-entropy with logits."""
    return (torch.clamp(logits, min=0.0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def mean_loss(logits, labels, half_batch: bool) -> torch.Tensor:
    """The mean cross-entropy; ``half_batch`` (a planted fault) takes the
    mean over the first half of the batch and leaves the rest out."""
    ce = sigmoid_ce(logits, labels)
    if half_batch:
        ce = ce[: ce.shape[0] // 2]
    return ce.mean()


class Trainer:
    """Parameters by key (tables logical ``[vocab, dim]``), their
    optimizer state, the touched rows of each table, and the update of
    one step: the dense leaves whole, the tables at the rows a batch
    holds (lazily)."""

    frozen = False  # a planted fault: every update leaves the state as it was

    def __init__(self, weights: dict, optimizers: dict, tables: set):
        self.params = {k: v.clone().float() for k, v in weights.items()}
        self.hyper = optimizers
        self.tables = tables
        self.state = {k: self.optimizer(k).init_state(w, self.side(k))
                      for k, w in self.params.items()}
        self.steps = {k: 0 for k in self.params}
        self.touched = {k: torch.zeros(self.params[k].shape[0],
                                       dtype=torch.bool,
                                       device=self.params[k].device)
                        for k in tables}

    @staticmethod
    def is_wide(key: str) -> bool:
        return key.split("/")[0] == "wide"

    def side(self, key: str) -> dict:
        return self.hyper["wide" if self.is_wide(key) else "deep"]

    def optimizer(self, key: str):
        """The module of leaf ``key``'s optimizer."""
        return optimizer(self.side(key))

    def update(self, key: str, g: torch.Tensor, rows=None) -> None:
        """One optimizer step of leaf ``key``: the whole leaf, or (a
        table) only ``rows``, each with its gradient row in ``g``."""
        if self.frozen:
            return
        self.steps[key] += 1
        w, st, hyper = self.params[key], self.state[key], self.side(key)
        if rows is not None:
            self.touched[key][rows] = True
            sel = {k: v[rows] for k, v in st.items()}
            w_r = w[rows]
        else:
            sel, w_r = dict(st), w
        w_new, st_new = self.optimizer(key).update(w_r, sel, g,
                                                   self.steps[key], hyper)
        if rows is None:
            self.params[key] = w_new
            st.update(st_new)
        else:
            w[rows] = w_new
            for k, v in st_new.items():
                st[k][rows] = v
