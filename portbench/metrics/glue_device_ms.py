"""Device ms per step in operations that are neither the port's own CUDA
kernels nor cuBLAS matmuls: the step glue of ``train/step.py`` (the
gathers, the expansion to batch order, casts, elementwise work, copies
of the batch into the graph's inputs)."""


def read(run):
    return run.trace.device_ms_per_step("glue")
