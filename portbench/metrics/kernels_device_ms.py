"""Device ms per step in the port's own CUDA kernels (by the names of
``mindrec_tpu_torch/csrc/*.cu``'s ``__global__`` functions)."""


def read(run):
    return run.trace.device_ms_per_step("kernels")
