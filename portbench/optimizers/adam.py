"""Adam with bias correction (Kingma and Ba, 2015), lazy on tables: only
the rows present in a batch move, with the table's own step count.  The
port's ``optim.lazy_adam``; ``state_dtype`` (``"float32"`` or
``"bfloat16"``) is the storage type of its m and v."""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build(spec: dict, loss_scale: float):
    from mindrec_tpu_torch.train import optim

    kw = {k: v for k, v in spec.items() if k != "kind"}
    kw["state_dtype"] = _DTYPES[kw.get("state_dtype", "float32")]
    return optim.lazy_adam(loss_scale=loss_scale, **kw)


def init_state(w: torch.Tensor, hyper: dict) -> dict:
    return {"m": torch.zeros_like(w), "v": torch.zeros_like(w)}


def update(w, st, g, t, hyper):
    """Adam with bias correction at step ``t`` (1-based)."""
    b1, b2 = hyper["b1"], hyper["b2"]
    m = b1 * st["m"] + (1.0 - b1) * g
    v = b2 * st["v"] + (1.0 - b2) * g * g
    lr_t = hyper["learning_rate"] * (1.0 - b2 ** t) ** 0.5 / (1.0 - b1 ** t)
    return w - lr_t * m / (torch.sqrt(v) + hyper["eps"]), {"m": m, "v": v}


def state_inits(hyper: dict) -> dict:
    return {"m": 0.0, "v": 0.0}


def grad_from_state(hyper: dict, w0, w1, state: dict) -> torch.Tensor:
    """``m / (1 - b1)``: after one step m is ``(1 - b1) g``."""
    return state["m"].float() / (1.0 - hyper["b1"])
