"""ctypes binding of the native host batch prep (``batchprep.cc``).

Port of ``mindrec_tpu/native/batchprep.py``.  The library is built from
this directory's ``batchprep.cc`` by ``g++`` at first use (never at
import) into ``mindrec_tpu_torch/_build/batchprep-<hash>/`` (listed in
``.gitignore``), where the hash covers the source and the flags, so a
changed source rebuilds and an unchanged one is reused.  A build that
fails raises with the compiler's output: there is no quiet numpy
fallback (``make_batch_sort(native=False)`` asks for numpy explicitly).

ctypes releases the GIL for the call's duration, so a plain Python
thread pool (``data/pipeline.py:HostPrepPool``) overlaps prep with the
device step.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from mindrec_tpu_torch.native import build as native_build

SRC = Path(__file__).resolve().parent / "batchprep.cc"
LIB_NAME = "libmindrec_batchprep.so"
BUILD_ROOT = native_build.BUILD_ROOT
SENTINEL = np.int32(2**31 - 2)

_I32P = ctypes.POINTER(ctypes.c_int32)
_lock = threading.Lock()
_fn = None


def build() -> Path:
    """Compile ``batchprep.cc`` with g++ (once per source hash); returns
    the library path.  Raises with the compiler's output on failure."""
    return native_build.build_library("batchprep", SRC, LIB_NAME,
                                      root=BUILD_ROOT)


def _load():
    global _fn
    with _lock:
        if _fn is None:
            fn = ctypes.CDLL(str(build())).mrec_batch_prep_i32
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                _I32P, ctypes.c_int64,  # ids, n
                _I32P, _I32P, _I32P,    # sorted_ids, perm, inv
                _I32P, _I32P, _I32P,    # uq, uidx, uidx_sorted
                ctypes.c_int64, ctypes.c_int32,  # uq_len, uq_fill
            ]
            _fn = fn
    return _fn


def batch_prep(ids: np.ndarray, uq_len: int | None = None,
               minimal: bool = False):
    """-> (sorted_ids, perm, inv, uq, uidx, uidx_sorted, n_unique).

    ``uq`` is sentinel-padded to ``uq_len`` (default ``ids.size``);
    ``n_unique`` may exceed ``uq_len``: the caller decides whether that
    is an error or a re-bucket trigger.  ``minimal=True`` skips
    ``sorted_ids`` and ``inv`` (returned as None): the train step never
    reads them when the full unique metadata is present."""
    fn = _load()
    ids = np.ascontiguousarray(ids, dtype=np.int32).reshape(-1)
    n = ids.size
    if uq_len is None:
        uq_len = n
    if minimal:
        sorted_ids = inv = sp = ip = None
    else:
        sorted_ids = np.empty(n, np.int32)
        inv = np.empty(n, np.int32)
        sp = sorted_ids.ctypes.data_as(_I32P)
        ip = inv.ctypes.data_as(_I32P)
    perm = np.empty(n, np.int32)
    uq = np.empty(uq_len, np.int32)
    uidx = np.empty(n, np.int32)
    uidx_sorted = np.empty(n, np.int32)
    nu = fn(ids.ctypes.data_as(_I32P), n, sp, perm.ctypes.data_as(_I32P), ip,
            uq.ctypes.data_as(_I32P), uidx.ctypes.data_as(_I32P),
            uidx_sorted.ctypes.data_as(_I32P), uq_len, SENTINEL)
    return sorted_ids, perm, inv, uq, uidx, uidx_sorted, int(nu)
