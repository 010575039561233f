"""Hierarchical-cache training adapter (TB-scale embedding tables).

Port of ``mindrec_tpu/train/cached.py``, the reference's embedding-cache
training mode: the card holds a ``cache_rows``-row cache of each table;
misses pull rows from host tiers (RAM cap + SSD spill), and evicted
dirty rows flow back out with their optimizer state.

* the model is built with ``vocab_size = cache_rows``; the train step
  (captured or eager) trains on dense **slot** ids with static shapes;
* one C++ LRU (``native/cache.cc``) serves all tables sharing the id
  space (the Criteo models' wide and deep tables see the same ids),
  emitting the batch's slots and the load / evict lists, padded to a
  power of two (at least 256, at most ``max_swap``) with the dummy slot
  ``cache_rows``;
* :meth:`CachedTrainingAdapter.apply_swap` writes the loaded rows into
  the live state's table and optimizer-state tensors **in place**
  (after gathering the evicted rows into their own tensors), so the
  state keeps its tensors and a captured step keeps its graph;
* the evicted rows go to a pinned host buffer by ``non_blocking``
  copies on the current stream, followed by an event;
  :meth:`~CachedTrainingAdapter.writeback` waits for that event alone
  (never the whole device) and writes the rows to per-table host tiers:
  param rows with N(0, 0.01) lazy init, FTRL ``accum`` with its 1.0
  init, everything else zero.

Per-step protocol (:func:`cached_train_step`)::

    prep   = adapter.prepare(batch)          # host: LRU + tier reads
    state  = adapter.apply_swap(state, prep) # device: swap in place
    adapter.writeback(prep)                  # host: persist evicted
    batch  = adapter.transform(batch, prep)  # ids -> slots, staged
    state, loss = step_fn(state, batch)      # the ordinary step

:class:`AsyncCachedTrainer` runs the host chain (``writeback(b)`` then
``prepare(b + 1)``) on a worker thread in the same order, so it is bit
for bit the serial protocol.  Remote tiers (``remote_addrs``) are PS
mode and raise (``ROADMAP.md`` section 1 item 8).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mindrec_tpu_torch.data.criteo import STAGING_LOCK, to_device
from mindrec_tpu_torch.ops.cache import HostTier, LruCache, _no_remote
from mindrec_tpu_torch.ops.embedding import read_rows, write_rows
from mindrec_tpu_torch.train.step import _get, is_wide_key


def _swap_storage(spec, storage, load_slots, load_rows, evict_slots):
    """In-place swap on one table in its storage convention -> the
    evicted rows ``[k, emb_dim]`` (their own tensor).

    The evicted rows are gathered BEFORE the load is scattered, so a slot
    recycled within one batch hands out its old row.  Pad entries of both
    lists are the dummy slot; its pad load rows are zeros, so duplicate
    pad writes all write the same zeros."""
    evicted = read_rows(spec, storage, evict_slots)
    write_rows(spec, storage, load_slots, load_rows)
    return evicted


class CachedTrainingAdapter:
    """Glue for cache-mode training of any model whose ``table_specs``
    tables share one id space.

    ``model``: built with ``vocab_size = cache_rows``; ``virtual_vocab``:
    the full vocab; ``cache_rows``: rows resident on the card per table
    (the reference's ``vocab_cache_size``); ``max_swap``: the per-step
    swap budget; ``ram_bytes`` / ``spill_dir``: the :class:`HostTier`
    knobs; ``io_workers``: threads for the per-tier reads of
    :meth:`prepare` (default one per tier)."""

    FTRL_ACCUM_INIT = 1.0

    def __init__(self, model, virtual_vocab: int, cache_rows: int,
                 max_swap: int, ram_bytes: int | None = None,
                 spill_dir: str | None = None, remote_addrs=None,
                 seed: int = 0, io_workers: int | None = None):
        if remote_addrs:
            raise _no_remote()
        self.model = model
        self.cache_rows = cache_rows
        self.max_swap = max_swap
        self.lru = LruCache(cache_rows)
        self._shadow: dict[int, int] = {}  # id -> slot (for flush_all)
        self.tables = {}  # name -> (path, spec)
        self.tiers = {}  # name -> {"param": tier, <state>: tier}
        for name, (path, spec) in model.table_specs.items():
            states = ("accum", "linear") if is_wide_key("/".join(path)) else ("m", "v")
            self.tables[name] = (path, spec)
            tiers = {"param": HostTier(virtual_vocab, spec.emb_dim, ram_bytes,
                                       spill_dir, seed=seed)}
            for s in states:
                bias = self.FTRL_ACCUM_INIT if s == "accum" else 0.0
                tiers[s] = HostTier(
                    virtual_vocab, spec.emb_dim, ram_bytes, spill_dir,
                    init_fn=lambda n, b=bias, d=spec.emb_dim: np.full(
                        (n, d), b, np.float32))
            self.tiers[name] = tiers
        n_tiers = sum(len(t) for t in self.tiers.values())
        self._io = ThreadPoolExecutor(max_workers=io_workers or max(n_tiers, 1),
                                      thread_name_prefix="cache-io")

    # -- host side -----------------------------------------------------

    def prepare(self, batch: dict) -> dict:
        """LRU lookup + tier reads for this batch's ids (host arrays)."""
        ids = np.asarray(batch["ids"], np.int64)
        slots, load_ids, load_slots, evict_ids, evict_slots = self.lru.lookup(
            ids.reshape(-1))
        if (slots < 0).any():
            raise RuntimeError(
                "cache thrash: batch touches more distinct ids than cache_rows")
        if load_ids.shape[0] > self.max_swap or evict_ids.shape[0] > self.max_swap:
            raise RuntimeError(
                f"swap overflow: load={load_ids.shape[0]} "
                f"evict={evict_ids.shape[0]} > max_swap={self.max_swap}")
        # pad to the next power of two (at least 256), not max_swap: the
        # steady-state traffic is a small share of the cold start's
        n = max(load_ids.shape[0], evict_ids.shape[0], 1)
        k = min(self.max_swap, max(256, 1 << (n - 1).bit_length()))
        for i, s in zip(load_ids.tolist(), load_slots.tolist()):
            self._shadow[i] = s
        for i in evict_ids.tolist():
            self._shadow.pop(i, None)

        def pad(a):
            out = np.full(k, self.cache_rows, np.int64)  # the dummy slot
            out[: a.shape[0]] = a
            return out

        def read_into(out, tier):
            if load_ids.shape[0]:
                out[: load_ids.shape[0]] = tier.read(load_ids)

        # one [tiers, k, dim] block per table; each tier owns its RAM/SSD
        # state, so the reads fan out on the io pool
        load_rows, futs = {}, []
        for name, tiers in self.tiers.items():
            block = np.zeros((len(tiers), k, tiers["param"].dim), np.float32)
            load_rows[name] = block
            futs += [self._io.submit(read_into, block[i], t)
                     for i, t in enumerate(tiers.values())]
        for f in futs:
            f.result()
        return {
            "slots": slots.reshape(ids.shape).astype(np.int32),
            "load_slots": pad(load_slots),
            "evict_slots": pad(evict_slots),
            "load_rows": load_rows,
            "load_ids": load_ids,
            "evict_ids": evict_ids,
        }

    def transform(self, batch: dict, prep: dict) -> dict:
        """The batch with slots for ids, staged on the device of the state
        that :meth:`apply_swap` swapped ``prep`` into."""
        out = dict(batch)
        out["ids"] = prep["slots"]
        return to_device(out, prep["device"])

    def writeback(self, prep: dict) -> None:
        """Persist the evicted rows that :meth:`apply_swap` gathered; waits
        only for the event after their copy to the host."""
        evict_ids = prep["evict_ids"]
        if evict_ids.shape[0] == 0:
            return
        event = prep.get("evicted_event")
        # a capture in flight on another thread forbids both the wait and
        # the release of pinned memory (which records events); captures
        # hold the staging lock
        with STAGING_LOCK:
            if event is not None:
                event.synchronize()
            blocks = prep.pop("evicted")
            rows = {name: block.float().numpy().copy()
                    for name, block in blocks.items()}
            del blocks
        for name, block in rows.items():
            for i, tier in enumerate(self.tiers[name].values()):
                tier.write(evict_ids, block[i])

    # -- device side ---------------------------------------------------

    def apply_swap(self, state, prep: dict):
        """Swap this batch's rows in place on the state's device; returns
        the same state.  Stores the evicted rows (a host buffer, pinned on
        the card) and the event after their copy into ``prep``."""
        dev = prep["device"] = state.step.device
        load_slots = torch.from_numpy(prep["load_slots"]).to(dev)
        evict_slots = torch.from_numpy(prep["evict_slots"]).to(dev)
        n = prep["evict_ids"].shape[0]
        on_card = dev.type == "cuda"
        evicted = {}
        for name, (path, spec) in self.tables.items():
            key = "/".join(map(str, path))
            rows = to_device({"r": prep["load_rows"][name]}, dev)["r"]
            opt_state = state.opt_w if key in state.opt_w else state.opt_d
            targets = [_get(state.params, path)] + [
                opt_state[key][t] for t in self.tiers[name] if t != "param"]
            ev = [_swap_storage(spec, t, load_slots, rows[i], evict_slots)
                  for i, t in enumerate(targets)]
            if n:
                out = torch.empty((len(ev), n, spec.emb_dim), dtype=ev[0].dtype,
                                  pin_memory=on_card)
                out.copy_(torch.stack([e[:n] for e in ev]), non_blocking=on_card)
                evicted[name] = out
        prep["evicted"] = evicted
        if on_card and n:
            event = torch.cuda.Event()
            event.record()
            prep["evicted_event"] = event
        return state

    # -- checkpoint ----------------------------------------------------

    def flush_all(self, state) -> None:
        """Write every resident row (params + optimizer state) to the tiers."""
        if not self._shadow:
            return
        ids = np.fromiter(self._shadow.keys(), np.int64)
        slots = np.fromiter(self._shadow.values(), np.int64)
        for name, (path, spec) in self.tables.items():
            key = "/".join(map(str, path))
            opt_state = state.opt_w if key in state.opt_w else state.opt_d
            for tname, tier in self.tiers[name].items():
                leaf = (_get(state.params, path) if tname == "param"
                        else opt_state[key][tname])
                tier.write(ids, read_rows(spec, leaf, slots).float().cpu().numpy())
        for tiers in self.tiers.values():
            for t in tiers.values():
                t.flush()


def cached_train_step(adapter: CachedTrainingAdapter, step_fn, state, batch):
    """One cache-mode training step (the module docstring's protocol)."""
    prep = adapter.prepare(batch)
    state = adapter.apply_swap(state, prep)
    adapter.writeback(prep)
    return step_fn(state, adapter.transform(batch, prep))


class AsyncCachedTrainer:
    """Pipelined cache-mode training: a worker thread runs the host chain
    (``writeback(b)`` then ``prepare(b + 1)``) while the main thread
    swaps rows on the device and launches the steps.

    The host operations run in exactly the serial protocol's order, so
    the result is bit for bit that of :func:`cached_train_step` in a
    loop.  The hand-off is one deep: the worker reaches ``writeback(b)``
    only after ``step(b + 1)`` was fed, which follows the main thread's
    ``apply_swap(b)``.  If the worker dies, the call that meets its error
    raises it, and every later ``step`` or ``finish`` raises at once.

    Usage::

        trainer = AsyncCachedTrainer(adapter, step_fn, state)
        for batch in data:
            losses = trainer.step(batch)
        state = trainer.finish()
    """

    _POLL_S = 0.05

    def __init__(self, adapter: CachedTrainingAdapter, step_fn, state):
        self.adapter = adapter
        self.step_fn = step_fn
        self.state = state
        self.losses = None
        self._in_q = queue.Queue(maxsize=1)
        self._out_q = queue.Queue(maxsize=1)
        self._err = None
        self._dead = False
        self._thread = threading.Thread(target=self._worker,
                                        name="cache-prep", daemon=True)
        self._thread.start()

    def _worker(self):
        prev = None
        try:
            while True:
                batch = self._in_q.get()
                if prev is not None:
                    # waits for the swap that gathered these rows, i.e.
                    # overlaps the step on the card
                    self.adapter.writeback(prev)
                if batch is None:
                    self._out_q.put(None)
                    return
                prev = self.adapter.prepare(batch)
                self._out_q.put((batch, prev))
        except Exception as e:  # surfaced by step() / finish()
            self._err = e
            self._dead = True
            self._out_q.put(None)

    def _put(self, item):
        """Hand ``item`` to the worker, or return once it has died (its
        error then waits in the output queue)."""
        if self._dead and self._err is None:
            raise RuntimeError("the cache-prep worker died earlier; this "
                               "trainer cannot continue")
        while not self._dead:
            try:
                self._in_q.put(item, timeout=self._POLL_S)
                return
            except queue.Full:
                pass

    def _run(self, item):
        b, prep = item
        st = self.adapter.apply_swap(self.state, prep)
        self.state, self.losses = self.step_fn(st, self.adapter.transform(b, prep))

    def _raise_err(self):
        err, self._err = self._err, None
        raise err

    def step(self, batch):
        """Feed one batch and run its swap and step; returns that step's
        losses (device tensors, not read)."""
        self._put(batch)
        item = self._out_q.get()
        if item is None:
            self._raise_err()
        self._run(item)
        return self.losses

    def finish(self):
        """Drain the pipeline (the last writeback); -> the final state."""
        self._put(None)
        self._out_q.get()
        self._thread.join()
        if self._err is not None:
            self._raise_err()
        return self.state
