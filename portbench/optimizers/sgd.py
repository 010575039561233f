"""Plain SGD, ``w - lr g``, lazy on tables (the rows a batch holds): the
port's ``optim.sgd``.  It keeps no state, so its first gradient comes
from the weight's change."""

from __future__ import annotations

import torch


def build(spec: dict, loss_scale: float):
    from mindrec_tpu_torch.train import optim

    return optim.sgd(learning_rate=spec["learning_rate"],
                     loss_scale=loss_scale)


def init_state(w: torch.Tensor, hyper: dict) -> dict:
    return {}


def update(w, st, g, t, hyper):
    return w - hyper["learning_rate"] * g, {}


def state_inits(hyper: dict) -> dict:
    return {}


def grad_from_state(hyper: dict, w0, w1, state: dict) -> torch.Tensor:
    """``(w0 - w1) / lr``."""
    return (w0.float() - w1.float()) / hyper["learning_rate"]
