"""FTRL-proximal with ``lr_power`` -0.5 (McMahan et al., 2013): the
port's ``optim.ftrl``."""

from __future__ import annotations

import math

import torch


def build(spec: dict, loss_scale: float):
    from mindrec_tpu_torch.train import optim

    kw = {k: v for k, v in spec.items() if k != "kind"}
    return optim.ftrl(loss_scale=loss_scale, **kw)


def init_state(w: torch.Tensor, hyper: dict) -> dict:
    return {"accum": torch.full_like(w, hyper["initial_accum"]),
            "linear": torch.zeros_like(w)}


def update(w, st, g, t, hyper):
    """FTRL-proximal, lr_power -0.5, on whole tensors -> (w', state')."""
    lr, l1, l2 = hyper["learning_rate"], hyper["l1"], hyper["l2"]
    accum = st["accum"] + g * g
    sigma = (torch.sqrt(accum) - torch.sqrt(st["accum"])) / lr
    linear = st["linear"] + g - sigma * w
    quadratic = torch.sqrt(accum) / lr + 2.0 * l2
    w_new = torch.where(linear.abs() > l1,
                        (torch.sign(linear) * l1 - linear) / quadratic,
                        torch.zeros_like(linear))
    return w_new, {"accum": accum, "linear": linear}


def state_inits(hyper: dict) -> dict:
    return {"accum": hyper["initial_accum"], "linear": 0.0}


def grad_from_state(hyper: dict, w0, w1, state: dict) -> torch.Tensor:
    """``linear + (sqrt(accum) - sqrt(accum0)) / lr * w0``, which is the
    gradient exactly."""
    a0 = float(hyper["initial_accum"])
    sigma = (torch.sqrt(state["accum"].float()) - math.sqrt(a0)) / hyper["learning_rate"]
    return state["linear"].float() + sigma * w0.float()
