"""The port's kernels' share of their roofline: the sum of the bounds of
every kernel call in the traced steps (``portbench/yardstick/
kernel_bytes.py``, from each step's staged batch) over the device time
of the port's kernels in those steps, in percent.  None when no kernel
of the port ran."""


def read(run):
    ms = run.trace.device_ms_per_step("kernels")
    if not ms:
        return None
    return 100.0 * run.bound_ms / (ms * run.trace.steps)
