"""The whole step's share of the card's bf16 peak: the matmuls' forward
and backward operations per step (``portbench/yardstick/flops.py``) times
the steps traced, over the traced steps' time on the device
(``Trace.steps_s``) times 989 TFLOP/s, in percent."""

from portbench.yardstick.peaks import BF16_FLOPS


def read(run):
    if not run.trace.steps_s or not run.trace.steps:
        return None
    return (100.0 * run.flops_per_step * run.trace.steps
            / (run.trace.steps_s * BF16_FLOPS))
