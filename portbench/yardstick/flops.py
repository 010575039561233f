"""Operations of the MLP per training step.

A dense layer ``in -> out`` over a batch of B rows takes ``2 B in out``
operations forward and twice that backward (the input's and the weight's
gradients): ``6 B sum(in out)`` per step.  Biases, activations, the
embedding work and the optimizers are left out (they are not matmuls).
Widths from the configuration file, as ``portbench/weights.py`` lays the
layers out.
"""

from __future__ import annotations

from portbench.weights import leaves


def mlp_flops_per_step(config: dict) -> float:
    """6 * batch * sum(in * out) over the MLP's layers."""
    inner = sum(shape[0] * shape[1] for key, shape in leaves(config)
                if "/mlp/" in key and key.endswith("/w"))
    return 6.0 * config["batch_size"] * inner
