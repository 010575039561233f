"""Device ms per step in cuBLAS's matmul kernels: the model's MLP
forward and backward."""


def read(run):
    return run.trace.device_ms_per_step("gemm")
