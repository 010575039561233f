"""Host-side hash embedding store (the reference's ``MapParameter``).

Port of ``mindrec_tpu/native/hashstore.py``: maps arbitrary int64
feature keys to dense slots of a fixed-capacity arena, with admission
and eviction:

* a key is *admitted* (gets a real slot) once it has been seen in at
  least ``permit_threshold`` distinct steps;
* keys untouched for ``evict_threshold`` steps are erased and their
  slots recycled.

The native store is this directory's ``hashstore.cc`` (with
``hashstore_impl.h``), built by g++ at first use into
``mindrec_tpu_torch/_build/hashstore-<hash>/``; a failed build raises.
:class:`PyHashStore` is the plain version (the same admission, clock and
free-slot stack; its ``evict`` and ``items`` list keys in insertion
order where the native store lists them in bucket order).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from mindrec_tpu_torch.native import build as native_build

HERE = Path(__file__).resolve().parent
SRC = HERE / "hashstore.cc"
HEADER = HERE / "hashstore_impl.h"
LIB_NAME = "libmindrec_hashstore.so"

_I64P = ctypes.POINTER(ctypes.c_int64)
_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native_build.build_library(
                "hashstore", SRC, LIB_NAME, headers=(HEADER,))))
            lib.hs_create.restype = ctypes.c_void_p
            lib.hs_create.argtypes = [ctypes.c_int64] * 3
            lib.hs_destroy.argtypes = [ctypes.c_void_p]
            lib.hs_size.restype = ctypes.c_int64
            lib.hs_size.argtypes = [ctypes.c_void_p]
            lib.hs_lookup_or_insert.argtypes = [
                ctypes.c_void_p, _I64P, ctypes.c_int64, _I64P, ctypes.c_int]
            lib.hs_evict.restype = ctypes.c_int64
            lib.hs_evict.argtypes = [ctypes.c_void_p, _I64P]
            lib.hs_erase.argtypes = [ctypes.c_void_p, _I64P, ctypes.c_int64]
            lib.hs_items.restype = ctypes.c_int64
            lib.hs_items.argtypes = [ctypes.c_void_p, _I64P, _I64P]
            _lib = lib
    return _lib


class PyHashStore:
    """The plain version of the native store."""

    def __init__(self, capacity: int, permit_threshold: int = 1,
                 evict_threshold: int = 0x7FFFFFFF):
        self.capacity = int(capacity)
        self.permit_threshold = int(permit_threshold)
        self.evict_threshold = int(evict_threshold)
        self.step = 0
        self._map: dict[int, int] = {}  # key -> slot
        self._seen: dict[int, int] = {}  # key -> distinct steps seen
        self._seen_step: dict[int, int] = {}  # key -> last step counted
        self._last: dict[int, int] = {}  # key -> last touched step
        self._free = list(range(self.capacity - 1, -1, -1))

    def __len__(self):
        return len(self._map)

    def lookup_or_insert(self, keys, force: bool = False) -> np.ndarray:
        """One step's id -> slot translation (-1: not admitted, or the
        arena is full).  Advances the step clock."""
        self.step += 1
        keys = np.asarray(keys, dtype=np.int64).reshape(-1)
        out = np.empty(keys.shape[0], dtype=np.int64)
        for i, k in enumerate(keys.tolist()):
            slot = self._map.get(k)
            if slot is not None:
                self._last[k] = self.step
                out[i] = slot
                continue
            if self._seen_step.get(k) != self.step:
                self._seen[k] = self._seen.get(k, 0) + 1
                self._seen_step[k] = self.step
            if (force or self._seen[k] >= self.permit_threshold) and self._free:
                slot = self._free.pop()
                self._map[k] = slot
                self._last[k] = self.step
                out[i] = slot
            else:
                out[i] = -1
        return out

    def evict(self) -> np.ndarray:
        """Erase keys idle for >= evict_threshold steps; -> freed slots."""
        dead = [k for k, last in self._last.items()
                if self.step - last >= self.evict_threshold]
        freed = []
        for k in dead:
            slot = self._map.pop(k)
            del self._last[k]
            self._seen.pop(k, None)
            self._seen_step.pop(k, None)
            self._free.append(slot)
            freed.append(slot)
        return np.asarray(freed, dtype=np.int64)

    def erase(self, keys) -> None:
        for k in np.asarray(keys, dtype=np.int64).reshape(-1).tolist():
            slot = self._map.pop(k, None)
            if slot is not None:
                self._last.pop(k, None)
                self._free.append(slot)

    def items(self) -> tuple[np.ndarray, np.ndarray]:
        keys = np.fromiter(self._map.keys(), np.int64, len(self._map))
        slots = np.fromiter(self._map.values(), np.int64, len(self._map))
        return keys, slots


class NativeHashStore:
    """ctypes binding of the C++ store (``hashstore.cc``)."""

    def __init__(self, capacity: int, permit_threshold: int = 1,
                 evict_threshold: int = 0x7FFFFFFF):
        self._lib = _load()
        self.capacity = int(capacity)
        self.permit_threshold = int(permit_threshold)
        self.evict_threshold = int(evict_threshold)
        self._h = self._lib.hs_create(self.capacity, self.permit_threshold,
                                      self.evict_threshold)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.hs_destroy(h)

    def __len__(self):
        return int(self._lib.hs_size(self._h))

    @staticmethod
    def _ptr(a):
        return a.ctypes.data_as(_I64P)

    def lookup_or_insert(self, keys, force: bool = False) -> np.ndarray:
        keys = np.ascontiguousarray(np.asarray(keys, dtype=np.int64).reshape(-1))
        out = np.empty(keys.shape[0], dtype=np.int64)
        self._lib.hs_lookup_or_insert(self._h, self._ptr(keys), keys.shape[0],
                                      self._ptr(out), int(force))
        return out

    def evict(self) -> np.ndarray:
        out = np.empty(self.capacity, dtype=np.int64)
        n = self._lib.hs_evict(self._h, self._ptr(out))
        return out[:n].copy()

    def erase(self, keys) -> None:
        keys = np.ascontiguousarray(np.asarray(keys, dtype=np.int64).reshape(-1))
        self._lib.hs_erase(self._h, self._ptr(keys), keys.shape[0])

    def items(self) -> tuple[np.ndarray, np.ndarray]:
        n = len(self)
        keys = np.empty(max(n, 1), dtype=np.int64)
        slots = np.empty(max(n, 1), dtype=np.int64)
        n = self._lib.hs_items(self._h, self._ptr(keys), self._ptr(slots))
        return keys[:n].copy(), slots[:n].copy()


def HashStore(capacity: int, permit_threshold: int = 1,
              evict_threshold: int = 0x7FFFFFFF, prefer_native: bool = True):
    """The native store (a failed build raises), or the Python one when
    ``prefer_native=False``."""
    cls = NativeHashStore if prefer_native else PyHashStore
    return cls(capacity, permit_threshold, evict_threshold)
