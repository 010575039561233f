"""PyTorch/CUDA port of mindrec_tpu for NVIDIA Hopper (H100).

The JAX package ``mindrec_tpu`` is the reference; this package keeps its
module names and paths so each part has an obvious counterpart.  It
imports ``torch`` and numpy only.  Every Pallas kernel on the ported path
is a CUDA C++ kernel under ``csrc/`` (built at first use by
``ops/kernels/_build.py``); each kernel module also holds the plain
PyTorch version that CPU tensors take.

Ported so far:

* ``train/rec_model.py:RecModel`` (``train``, ``online_train``,
  ``eval``) over the host-prep input pipeline (``data/pipeline.py``:
  native prep in a thread pool, the adaptive unique bucket, staging on
  a side CUDA stream by ``data/criteo.py:PrefetchToDevice``), with the
  step captured in a CUDA graph (``jit=True``);
* the native batch prep (``native/batchprep.cc``, built by g++ at first
  use), metrics (AUC, grouped MAP@12) and callbacks (loss, eval,
  ``TimeMonitor`` with the step's floor, checkpoints, exports);
* checkpoints interchangeable with the reference's files
  (``io/checkpoint.py``: save, async save, retention, restore, merge of
  sliced files), the MREC1 export and the C++ client that serves it on
  the host (``io/export.py``, ``serving/infer_client.cc``, built by g++
  at first use), the ONNX export and a runner of it on the card
  (``io/onnx.py``, ``serving/onnx_ref.py``), ``serving/records2bin.py``
  and the profiler hooks and speed-of-light floor
  (``utils/profiling.py``);
* the sparse train step on one device (``train/step.py``) in both
  streamed formulations (``row_layout=True`` for one or several id
  groups of row_packed or feature-major tables, with the tiny-vocab
  path; ``row_layout=False`` for a single group of feature-major
  tables), with the overflow guard on the device;
* the Wide&Deep, DeepFM, DCN and multitable (Outbrain) Wide&Deep
  models, and a CUDA counterpart of every Pallas kernel of the
  reference;
* the hierarchical embedding cache (``ops/cache.py``: the native LRU
  ``native/cache.cc``, host RAM/SSD tiers; ``train/cached.py``: the
  in-place swap, the serial protocol and the pipelined trainer) and the
  hash-based dynamic embeddings (``native/hashstore.cc``,
  ``train/dynamic.py``, ``ops/embedding.py:HashEmbeddingLookup``,
  ``train/callbacks.py:EvictionCallback``), both built by g++ at first
  use;
* the input side (``data/``): packed shards, TFRecord, H5 and Outbrain
  TFRecord readers and writers, Criteo TSV preprocessing, the
  planted-model generator, the compact wire with device prep, superbatch
  staging and ``RecModel(input_recipe="auto")``, and the online-learning
  sources (channels, a Kafka client and stub broker).
"""

__version__ = "0.1.0"

from mindrec_tpu_torch.train.rec_model import RecModel  # noqa: E402

__all__ = ["__version__", "RecModel"]
