"""Carry train state between the JAX reference and this port.

The JAX package's ``TrainState`` (params, opt_w, opt_d, step) converted
to nested dicts of numpy arrays maps onto
this port's :class:`~mindrec_tpu_torch.train.step.TrainState` leaf for
leaf for every ported model (Wide&Deep, multitable, DeepFM, DCN; a model
without wide parameters has an empty ``opt_w``): the storage layouts
(row_packed and feature-major) and parameter keys are the same, and
dtypes are kept (bf16 Adam moments stay bf16).  numpy has no bfloat16 of its
own; bf16 arrays from JAX carry the ``ml_dtypes`` type named
"bfloat16" and are moved as their 16-bit patterns.  A JAX PRNG key has
no torch counterpart (the port's keys are its own counter-based hash,
``ops/prng.py``), so the port's ``rng`` is made from a seed and is not
carried back.
"""

from __future__ import annotations

import numpy as np
import torch

from mindrec_tpu_torch.ops import prng
from mindrec_tpu_torch.train.step import TrainState, map_leaves


def _to_torch(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(arr.view(np.uint16)))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy (the step updates tables in place, so a view would change
    under a later step)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the type JAX gives bf16 arrays on the host

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def _tree(fn, node):
    return map_leaves(lambda _key, leaf: fn(leaf), node)


def state_from_jax(params, opt_w, opt_d, step, device="cuda",
                   seed: int = 0) -> TrainState:
    """JAX train state (nested dicts/lists of numpy arrays) -> port state
    on ``device``, its key ``prng.key(seed)``."""
    conv = lambda x: _to_torch(x, device)  # noqa: E731
    return TrainState(
        params=_tree(conv, params),
        opt_w=_tree(conv, opt_w),
        opt_d=_tree(conv, opt_d),
        step=conv(np.asarray(step, np.int32)),
        rng=prng.key(seed, device),
    )


def state_to_jax(state: TrainState):
    """Port state -> (params, opt_w, opt_d, step) as numpy, the reverse
    of :func:`state_from_jax` (the key stays behind)."""
    return (
        _tree(_to_numpy, state.params),
        _tree(_to_numpy, state.opt_w),
        _tree(_to_numpy, state.opt_d),
        _to_numpy(state.step),
    )
