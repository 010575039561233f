"""PyTorch/CUDA port of mindrec_tpu for NVIDIA Hopper (H100).

The JAX package ``mindrec_tpu`` is the reference; this package keeps its
module names and paths so each part has an obvious counterpart.  It
imports ``torch`` and numpy only.  Every Pallas kernel on the ported path
is a CUDA C++ kernel under ``csrc/`` (built at first use by
``ops/kernels/_build.py``); each kernel module also holds the plain
PyTorch version that CPU tensors take.

Ported so far: the sparse train step on one device
(``train/step.py:make_train_step``) in both streamed formulations
(``row_layout=True`` for one or several id groups of row_packed or
feature-major tables, with the tiny-vocab path; ``row_layout=False`` for
a single group of feature-major tables), the Wide&Deep, DeepFM, DCN and
multitable (Outbrain) Wide&Deep models, and a CUDA counterpart of every
Pallas kernel of the reference.
"""

__version__ = "0.1.0"
