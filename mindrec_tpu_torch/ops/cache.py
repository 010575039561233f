"""Hierarchical embedding cache: device arena <-> host RAM <-> SSD.

Port of ``mindrec_tpu/ops/cache.py`` (the reference's embedding-cache
training mode: control surface ``vocab_cache_size``, RAM cap + SSD
spill):

* the train step only ever sees a dense ``[cache_rows + 1, dim]`` arena
  on the device (static shapes; slot ids instead of feature ids);
* a C++ LRU manager (``native/cache.cc``, built by g++ at first use into
  ``mindrec_tpu_torch/_build/cache-<hash>/``) translates each batch's
  huge feature ids into arena slots and emits the swap lists;
* :class:`HostTier` holds the full table on the host: the rows below
  ``ram_rows`` in RAM, the rest in an SSD-backed memmap file (the
  RAM-cap knob), both materialised lazily;
* the swap itself is two device index ops, in place: gather the
  evicted rows out, then scatter the loaded rows in.

With ``remote_addrs`` the tiers live in table-server processes instead
(``ops/remote.py``: PS mode).

There is no silent fallback: :func:`LruCache` builds the native LRU or
raises; the Python LRU (the plain version) is reached only by asking
for it (``prefer_native=False``).  Each :class:`HostTier` keeps one
seeded ``np.random.Generator`` and draws fresh rows from it in order (the
reference's default builds a new generator on every call, so every read
that materialises rows hands out the same first vectors again).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from mindrec_tpu_torch.native import build as native_build
from mindrec_tpu_torch.ops.remote import RemoteTier

SRC = Path(__file__).resolve().parents[1] / "native" / "cache.cc"
LIB_NAME = "libmindrec_cache.so"

_I64P = ctypes.POINTER(ctypes.c_int64)
_lock = threading.Lock()
_lib = None


def _load_cache_lib():
    """The native LRU library, built at first use (raises on failure)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native_build.build_library(
                "cache", SRC, LIB_NAME)))
            lib.lru_create.restype = ctypes.c_void_p
            lib.lru_create.argtypes = [ctypes.c_int64]
            lib.lru_destroy.argtypes = [ctypes.c_void_p]
            lib.lru_size.restype = ctypes.c_int64
            lib.lru_size.argtypes = [ctypes.c_void_p]
            lib.lru_lookup.restype = ctypes.c_int64
            lib.lru_lookup.argtypes = ([ctypes.c_void_p, _I64P, ctypes.c_int64]
                                       + [_I64P] * 6)
            _lib = lib
    return _lib


class PyLruCache:
    """The plain version of ``native/cache.cc``: the same LRU semantics,
    one Python step per id."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._od = OrderedDict()  # key -> slot, MRU last
        self._free = list(range(capacity - 1, -1, -1))

    def __len__(self):
        return len(self._od)

    def lookup(self, ids: np.ndarray):
        """-> (slots, load_ids, load_slots, evict_ids, evict_slots); a
        slot of -1 when every resident row is pinned by this batch."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        slots = np.empty_like(ids)
        load_ids, load_slots, evict_ids, evict_slots = [], [], [], []
        # pin every resident id of the batch (even ones after a miss), so
        # that a miss cannot evict a later id of the same batch: its
        # reload would lose the row's training updates
        pinned = {k for k in ids.tolist() if k in self._od}
        for i, k in enumerate(ids.tolist()):
            if k in self._od:
                self._od.move_to_end(k)
                slots[i] = self._od[k]
                pinned.add(k)
                continue
            if self._free:
                s = self._free.pop()
            else:
                victim = next((c for c in self._od if c not in pinned), None)
                if victim is None:
                    slots[i] = -1
                    continue
                s = self._od.pop(victim)
                evict_ids.append(victim)
                evict_slots.append(s)
            self._od[k] = s
            pinned.add(k)
            load_ids.append(k)
            load_slots.append(s)
            slots[i] = s
        return (slots, np.asarray(load_ids, np.int64),
                np.asarray(load_slots, np.int64),
                np.asarray(evict_ids, np.int64),
                np.asarray(evict_slots, np.int64))


class NativeLruCache:
    """ctypes binding of the C++ LRU (``native/cache.cc``)."""

    def __init__(self, capacity: int):
        self._lib = _load_cache_lib()
        self.capacity = capacity
        self._h = self._lib.lru_create(capacity)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.lru_destroy(h)

    def __len__(self):
        return int(self._lib.lru_size(self._h))

    def lookup(self, ids: np.ndarray):
        ids = np.ascontiguousarray(np.asarray(ids, np.int64).reshape(-1))
        n = ids.shape[0]
        out = [np.empty(n, np.int64) for _ in range(5)]
        n_evict = np.zeros(1, np.int64)
        p = [a.ctypes.data_as(_I64P) for a in (ids, *out, n_evict)]
        n_load = self._lib.lru_lookup(self._h, p[0], n, *p[1:])
        ne = int(n_evict[0])
        slots, load_ids, load_slots, evict_ids, evict_slots = out
        return (slots, load_ids[:n_load].copy(), load_slots[:n_load].copy(),
                evict_ids[:ne].copy(), evict_slots[:ne].copy())


def LruCache(capacity: int, prefer_native: bool = True):
    """The native LRU (a failed build raises), or the Python one when
    ``prefer_native=False``."""
    return NativeLruCache(capacity) if prefer_native else PyLruCache(capacity)


class HostTier:
    """Host-side full (virtual) table: RAM for ids below ``ram_rows``, an
    SSD-backed spill file for the rest (the RAM-cap knob).

    Rows materialise lazily (an unseen row gets ``init_fn`` on its first
    read), so a 10^10-row virtual vocab costs only the touched rows: the
    RAM tier is a dense ``[ram_rows, dim]`` array allocated at first use
    and the SSD tier an append-allocated file with an id -> file-row
    dict, grown in chunks of :attr:`SSD_GROW` rows.  The default init is
    N(0, 0.01) from one generator seeded with ``seed``, drawn in order."""

    SSD_GROW = 4096  # the file grows in chunks of this many rows

    def __init__(self, vocab_size: int, dim: int, ram_bytes: int | None = None,
                 spill_dir: str | None = None, init_fn=None, seed: int = 0):
        self.vocab_size = vocab_size
        self.dim = dim
        if ram_bytes is None:
            ram_rows = vocab_size
        else:
            ram_rows = max(min(vocab_size, ram_bytes // (dim * 4)), 0)
        self.ram_rows = int(ram_rows)
        self._rng = np.random.default_rng(seed)
        self._init_fn = init_fn or (
            lambda n: self._rng.normal(0, 0.01, (n, dim)).astype(np.float32))
        self._ram = None  # lazy dense [ram_rows, dim]
        self._ram_init = None  # bool bitmap over ram_rows
        self._ssd = None  # np.memmap, grown on demand
        self._ssd_rows = 0  # rows allocated in the file
        self._ssd_index: dict[int, int] = {}  # feature id -> file row
        self._ssd_path = None
        if self.ram_rows < vocab_size:
            if spill_dir is None:
                raise ValueError("spill_dir required when table exceeds ram cap")
            Path(spill_dir).mkdir(parents=True, exist_ok=True)
            self._ssd_path = str(Path(spill_dir) / f"emb_spill_{id(self)}_{dim}.bin")

    @property
    def ssd_rows_used(self) -> int:
        """Rows held in the spill file."""
        return len(self._ssd_index)

    @property
    def ram_rows_touched(self) -> int:
        """RAM rows materialised so far."""
        return 0 if self._ram_init is None else int(self._ram_init.sum())

    def _ensure_ram(self):
        if self._ram is None:
            self._ram = np.zeros((self.ram_rows, self.dim), np.float32)
            self._ram_init = np.zeros(self.ram_rows, bool)

    def _ssd_reserve(self, rows: int) -> None:
        """Grow the spill file to hold >= ``rows`` rows (one remap)."""
        if rows <= self._ssd_rows:
            return
        new_rows = -(-rows // self.SSD_GROW) * self.SSD_GROW
        if self._ssd is not None:
            self._ssd.flush()  # the data persists in the file
        self._ssd = np.memmap(self._ssd_path, dtype=np.float32,
                              mode="r+" if self._ssd_rows else "w+",
                              shape=(new_rows, self.dim))
        self._ssd_rows = new_rows

    def _ssd_slots(self, fids: np.ndarray) -> np.ndarray:
        """id -> file row; new ids get contiguous fresh rows (one file
        grow, one init draw, in sorted id order)."""
        idx = self._ssd_index
        slots = np.fromiter((idx.get(f, -1) for f in fids.tolist()), np.int64,
                            fids.size)
        miss = slots < 0
        if miss.any():
            new_fids = np.unique(fids[miss])
            base = len(idx)
            self._ssd_reserve(base + new_fids.size)
            for j, f in enumerate(new_fids.tolist()):
                idx[f] = base + j
            self._ssd[base: base + new_fids.size] = self._init_fn(new_fids.size)
            slots[miss] = np.fromiter((idx[f] for f in fids[miss].tolist()),
                                      np.int64, int(miss.sum()))
        return slots

    def read(self, ids: np.ndarray) -> np.ndarray:
        """Rows by feature id ``[n, dim]`` float32 (unseen rows are
        initialised, in sorted id order: RAM ids first, then SSD ids)."""
        self._ensure_ram()
        ids = np.asarray(ids, np.int64).reshape(-1)
        out = np.empty((ids.shape[0], self.dim), np.float32)
        in_ram = ids < self.ram_rows
        ram_ids = ids[in_ram]
        if ram_ids.size:
            fresh = ram_ids[~self._ram_init[ram_ids]]
            if fresh.size:
                fresh = np.unique(fresh)
                self._ram[fresh] = self._init_fn(fresh.size)
                self._ram_init[fresh] = True
            out[in_ram] = self._ram[ram_ids]
        pos = np.nonzero(~in_ram)[0]
        if pos.size:
            slots = self._ssd_slots(ids[pos])  # may create the file
            out[pos] = self._ssd[slots]
        return out

    def write(self, ids: np.ndarray, rows: np.ndarray) -> None:
        self._ensure_ram()
        ids = np.asarray(ids, np.int64).reshape(-1)
        rows = np.asarray(rows, np.float32).reshape(ids.shape[0], self.dim)
        in_ram = ids < self.ram_rows
        if in_ram.any():
            self._ram[ids[in_ram]] = rows[in_ram]
            self._ram_init[ids[in_ram]] = True
        pos = np.nonzero(~in_ram)[0]
        if pos.size:
            slots = self._ssd_slots(ids[pos])  # may create the file
            self._ssd[slots] = rows[pos]

    def flush(self):
        if self._ssd is not None:
            self._ssd.flush()


def make_tier(name: str, dim: int, vocab_size: int, init_std: float = 0.01,
              init_bias: float = 0.0, *, remote_addrs=None,
              ram_bytes: int | None = None, spill_dir: str | None = None,
              seed: int = 0):
    """One tier of a table: a :class:`RemoteTier` named ``name`` on the
    ``remote_addrs`` servers, else a :class:`HostTier`.  Unseen rows are
    ``init_bias + init_std * N(0, 1)``: the servers' per-id draw, or the
    host tier's generator (``init_std`` must then be 0 or 0.01)."""
    if remote_addrs:
        return RemoteTier(remote_addrs, name, dim, init_std=init_std,
                          seed=seed, init_bias=init_bias)
    if init_std not in (0.0, 0.01):
        raise ValueError(f"a host tier draws N(0, 0.01) or a constant, not "
                         f"std {init_std}")
    init = None if init_std else (
        lambda n: np.full((n, dim), init_bias, np.float32))
    return HostTier(vocab_size, dim, ram_bytes, spill_dir, init_fn=init,
                    seed=seed)


def cache_swap(arena: torch.Tensor, evict_slots: torch.Tensor,
               load_slots: torch.Tensor, load_rows: torch.Tensor):
    """In-place device swap of a row-major arena: -> (arena, evicted).

    The evicted rows are gathered into their own tensor before the loaded
    rows are scattered in, so a slot recycled within one batch hands out
    its old row.  The slot lists are padded with the arena's last row
    (the dummy slot), whose pad load rows are zeros."""
    evicted = arena[evict_slots.long()]
    arena.index_copy_(0, load_slots.long(), load_rows.to(arena.dtype))
    return arena, evicted


class CachedEmbeddingTable:
    """Glue object: ties an LRU manager to host tiers for one table.

    ``state_names`` adds row-aligned companion tiers (e.g. m, v) that
    swap together with the parameter rows.  The arena has one extra
    scratch row (index ``cache_rows``) absorbing pad slots.
    ``remote_addrs`` ("host:port" table servers) puts every tier on the
    servers (:class:`~mindrec_tpu_torch.ops.remote.RemoteTier`: the param
    tier ``table_name`` with the servers' N(0, 0.01) init, each state
    tier ``table_name.<state>`` zero; the RAM cap and spill are the
    servers'); ``ram_bytes`` and ``spill_dir`` then go unused."""

    def __init__(self, vocab_size: int, dim: int, cache_rows: int,
                 max_swap: int, ram_bytes: int | None = None,
                 spill_dir: str | None = None, state_names=(), seed: int = 0,
                 remote_addrs=None, table_name: str = "emb"):
        self.vocab_size = vocab_size
        self.dim = dim
        self.cache_rows = cache_rows
        self.max_swap = max_swap
        self.lru = LruCache(cache_rows)
        tier = functools.partial(make_tier, dim=dim, vocab_size=vocab_size,
                                 remote_addrs=remote_addrs, ram_bytes=ram_bytes,
                                 spill_dir=spill_dir, seed=seed)
        self.param_tier = tier(table_name)
        self.state_tiers = {name: tier(f"{table_name}.{name}", init_std=0.0)
                            for name in state_names}
        self.dummy_slot = cache_rows
        # id -> slot mirror of the LRU's resident set (the native LRU has
        # no iteration API); flush_all walks it
        self._resident: dict[int, int] = {}

    def init_arena(self, device="cuda") -> torch.Tensor:
        return torch.zeros((self.cache_rows + 1, self.dim), dtype=torch.float32,
                           device=device)

    def init_state_arena(self, name: str, device="cuda") -> torch.Tensor:
        del name
        return self.init_arena(device)

    def prepare(self, ids: np.ndarray):
        """Host step: ids -> slots and the padded swap lists + host rows."""
        slots, load_ids, load_slots, evict_ids, evict_slots = self.lru.lookup(ids)
        for i in evict_ids.tolist():
            self._resident.pop(i, None)
        for i, s in zip(load_ids.tolist(), load_slots.tolist()):
            self._resident[i] = s
        if (slots < 0).any():
            raise RuntimeError(
                "cache thrash: batch needs more distinct rows than cache_rows")
        k = self.max_swap
        if load_ids.shape[0] > k or evict_ids.shape[0] > k:
            raise RuntimeError(f"swap overflow: load={load_ids.shape[0]} "
                               f"evict={evict_ids.shape[0]} > max_swap={k}")

        def pad_slots(s):
            out = np.full(k, self.dummy_slot, np.int64)
            out[: s.shape[0]] = s
            return out

        load_rows = {}
        for name, tier in (("param", self.param_tier), *self.state_tiers.items()):
            r = np.zeros((k, self.dim), np.float32)
            r[: load_ids.shape[0]] = tier.read(load_ids)
            load_rows[name] = r
        return {
            "slots": slots.reshape(np.asarray(ids).shape).astype(np.int32),
            "load_slots": pad_slots(load_slots).astype(np.int32),
            "evict_slots": pad_slots(evict_slots).astype(np.int32),
            "load_rows": load_rows,
            "evict_ids": evict_ids,
            "n_evict": evict_ids.shape[0],
        }

    def writeback(self, evict_ids: np.ndarray, evicted_rows: dict):
        """Persist evicted (dirty) rows to the host tiers."""
        n = evict_ids.shape[0]
        if n == 0:
            return
        self.param_tier.write(evict_ids, _host(evicted_rows["param"])[:n])
        for name, tier in self.state_tiers.items():
            tier.write(evict_ids, _host(evicted_rows[name])[:n])

    def flush_all(self, arena, state_arenas: dict):
        """Write every resident row back to the host tiers (checkpoint)."""
        if not self._resident:
            return
        ids = np.fromiter(self._resident.keys(), np.int64)
        slots = torch.from_numpy(np.fromiter(self._resident.values(), np.int64))
        self.param_tier.write(ids, _host(arena[slots.to(arena.device)]))
        for name, tier in self.state_tiers.items():
            a = state_arenas[name]
            tier.write(ids, _host(a[slots.to(a.device)]))
        self.param_tier.flush()


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)
