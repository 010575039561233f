"""Matmul operations per training step.

The model's reference module (``portbench/reference/<model>.py``) gives
them as ``matmul_flops_per_step(config)`` where it defines one (a model
whose matmuls are not all MLP layers, such as a cross network).  Else
the MLP's: a dense layer ``in -> out`` over a batch of B rows takes
``2 B in out`` operations forward and twice that backward (the input's
and the weight's gradients): ``6 B sum(in out)`` per step.  Biases,
activations, the embedding work and the optimizers are left out (they
are not matmuls).  Widths from the configuration file, as
``portbench/weights.py`` lays the layers out.
"""

from __future__ import annotations

from portbench.weights import leaves, model_module


def matmul_flops_per_step(config: dict) -> float:
    """The model's own count, or 6 * batch * sum(in * out) over its
    MLP's layers."""
    own = getattr(model_module(config), "matmul_flops_per_step", None)
    if own is not None:
        return float(own(config))
    inner = sum(shape[0] * shape[1] for key, shape in leaves(config)
                if "/mlp/" in key and key.endswith("/w"))
    return 6.0 * config["batch_size"] * inner
