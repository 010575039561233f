"""Dynamic (hash) embedding training adapter.

Port of ``mindrec_tpu/train/dynamic.py``: ties the host hash store
(``native/hashstore.cc``, the reference's ``MapParameter``) into the
training loop, as the reference's dynamic-embedding mode (W&D with
``dynamic_embedding=True``):

* the model is built with ``vocab_size = capacity`` and trains on dense
  *slot* ids: static shapes, one captured graph;
* :meth:`~DynamicEmbeddingAdapter.transform_batch` maps raw (arbitrary
  int64) feature ids to slots on the host, applying admission (ids under
  the ``permit_filter_value`` threshold hit the dummy row, as do ids met
  with the arena full) and advancing the eviction clock;
* :meth:`~DynamicEmbeddingAdapter.evict` erases expired keys and resets
  their table and optimizer-state rows in place (params re-drawn from
  the adapter's numpy generator, optimizer state zeroed), so the state
  keeps its tensors and a captured step its graph.  A batch transformed
  ahead of an eviction is safe: its keys were touched at its step, so
  none of them is idle;
* :meth:`~DynamicEmbeddingAdapter.export_tables` /
  :meth:`~DynamicEmbeddingAdapter.import_tables` give the incremental
  (key-wise) checkpoint of live features.

The distributed hash store (``remote_addrs``) is PS mode and raises
(``ROADMAP.md`` section 1 item 8).
"""

from __future__ import annotations

import numpy as np

from mindrec_tpu_torch.native.hashstore import HashStore
from mindrec_tpu_torch.ops.embedding import read_rows, write_rows
from mindrec_tpu_torch.train.step import _get


class DynamicEmbeddingAdapter:
    """One instance serves all tables that share the id space (the
    Criteo models' wide and deep tables share ids).  ``store`` injects
    any object with the hash store's methods."""

    def __init__(self, capacity: int, permit_filter_value: int = 1,
                 evict_filter_value: int = 0x7FFFFFFF, seed: int = 0,
                 store=None, remote_addrs=None, table_name: str = "dyn"):
        if permit_filter_value < 1 or evict_filter_value < 1:
            raise ValueError("filter thresholds must be >= 1")
        if remote_addrs and store is None:
            raise NotImplementedError(
                "the distributed hash store (remote_addrs=) belongs to PS "
                "mode, which is not ported yet (ROADMAP.md section 1 item 8)")
        del table_name  # names a remote table
        self.capacity = capacity
        self.store = store if store is not None else HashStore(
            capacity=capacity, permit_threshold=permit_filter_value,
            evict_threshold=evict_filter_value)
        self.dummy_slot = capacity  # the model is built with vocab_size=capacity
        self._rng = np.random.default_rng(seed)

    # -- hot path ------------------------------------------------------

    def transform_batch(self, batch: dict) -> dict:
        """Raw ids -> arena slots (host side, one step of the clock)."""
        ids = np.asarray(batch["ids"])
        slots = self.store.lookup_or_insert(ids.reshape(-1))
        slots = np.where(slots < 0, self.dummy_slot, slots)
        out = dict(batch)
        out["ids"] = slots.reshape(ids.shape).astype(np.int32)
        return out

    def evict(self, state, tables) -> tuple:
        """Erase expired keys; reset the freed rows in place (params
        re-drawn N(0, 0.01), optimizer state zeroed).  -> (the same
        state, n_evicted).

        ``tables``: the model's ``table_specs`` dict or a list of
        ``(path, spec)`` pairs (the spec carries the storage layout)."""
        freed = self.store.evict()
        if freed.size == 0:
            return state, 0
        for path, spec in _norm_tables(tables):
            key = "/".join(map(str, path))
            node = _get(state.params, path)
            fresh = self._rng.normal(0, 0.01, (freed.size, spec.emb_dim)).astype(np.float32)
            write_rows(spec, node, freed, fresh)
            zeros = np.zeros((freed.size, spec.emb_dim), np.float32)
            for opt_state in (state.opt_w, state.opt_d):
                for leaf in opt_state.get(key, {}).values():
                    if getattr(leaf, "shape", None) == node.shape:
                        write_rows(spec, leaf, freed, zeros)
        return state, int(freed.size)

    # -- incremental checkpoint ---------------------------------------

    def export_tables(self, params, tables) -> dict:
        """``{"__keys__": keys, path: rows [n_live, emb_dim]}`` on the host
        for every admitted key."""
        keys, slots = self.store.items()
        out = {"__keys__": keys}
        for path, spec in _norm_tables(tables):
            rows = read_rows(spec, _get(params, path), slots)
            out["/".join(map(str, path))] = rows.float().cpu().numpy()
        return out

    def import_tables(self, params, blob: dict, tables):
        """Admit the blob's keys (forced) and write their rows in place;
        returns ``params``."""
        slots = self.store.lookup_or_insert(blob["__keys__"], force=True)
        ok = slots >= 0
        for path, spec in _norm_tables(tables):
            write_rows(spec, _get(params, path), slots[ok],
                       np.asarray(blob["/".join(map(str, path))])[ok])
        return params


def _norm_tables(tables):
    return list(tables.values()) if isinstance(tables, dict) else list(tables)
