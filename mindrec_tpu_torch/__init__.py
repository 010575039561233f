"""PyTorch/CUDA port of mindrec_tpu for NVIDIA Hopper (H100).

The JAX package ``mindrec_tpu`` is the reference; this package keeps its
module names and paths so each part has an obvious counterpart.  It
imports ``torch`` and numpy only.  Every Pallas kernel on the ported path
is a CUDA C++ kernel under ``csrc/`` (built at first use by
``ops/kernels/_build.py``); each kernel module also holds the plain
PyTorch version that CPU tensors take.

Ported so far: the sparse Wide&Deep train step on one device with
row_packed tables (``train/step.py:make_train_step``).
"""

__version__ = "0.1.0"
