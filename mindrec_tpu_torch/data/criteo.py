"""Criteo-style batches: synthetic, packed on disk, staged on the card.

``criteo_field_sizes``, :class:`SyntheticCriteo`,
:func:`write_packed_shards` and :class:`PackedCriteoDataset` are copies
of ``mindrec_tpu/data/criteo.py`` (numpy only), so the same seed gives
the same batches in both packages and either package reads the shards
the other writes (``.npz`` files of ``line_per_sample`` samples per
packed row; a batch of B samples is B / line_per_sample rows).
:func:`to_device` stages a host batch through pinned memory with
non-blocking copies on the current stream; :class:`PrefetchToDevice`
(port of the reference's) stages the next batches from a background
thread on a side stream (:func:`stage_batch`) while the step runs.

Batch layout: ``{"ids": [B,F] int32, "wts": [B,F] f32, "label": [B,1] f32}``.
"""

from __future__ import annotations

import os
import queue
import threading
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

# Criteo-Kaggle categorical cardinalities (C1..C26)
CRITEO_KAGGLE_CAT_CARDINALITIES = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18,
    15, 286181, 105, 142572,
)
N_DENSE_FIELDS = 13  # int columns, bucketized into small id ranges
# Held while a batch is staged on the card and while a train step is
# captured in a CUDA graph (train/step.py:CapturedStep): a staging
# thread's CUDA calls (pinned allocations, copies, events) must not
# interleave with a capture, which any of them can invalidate.
STAGING_LOCK = threading.Lock()


def criteo_field_sizes(vocab_size: int, field_size: int = 39) -> np.ndarray:
    """Per-field id-range sizes proportional to the real criteo schema,
    scaled so they sum to ``vocab_size``."""
    dense = [64.0] * min(N_DENSE_FIELDS, field_size)
    n_cat = field_size - len(dense)
    cats = [
        float(CRITEO_KAGGLE_CAT_CARDINALITIES[i % 26]) for i in range(n_cat)
    ]
    base = np.array(dense + cats, np.float64)
    small = base < 10000
    fixed = base[small].sum()
    scale = max(vocab_size - fixed, 1) / max(base[~small].sum(), 1)
    sizes = np.where(small, base, np.maximum(base * scale, 4.0)).astype(np.int64)
    sizes[np.argmax(sizes)] += vocab_size - sizes.sum()
    return np.maximum(sizes, 1)


class SyntheticCriteo:
    """Synthetic criteo-like stream with a power-law id distribution;
    ``fields="criteo"`` sizes the field ranges like the real schema,
    ``fields="uniform"`` gives every field an equal slice."""

    def __init__(
        self,
        batch_size: int,
        field_size: int = 39,
        vocab_size: int = 200000,
        steps: int = 100,
        seed: int = 0,
        zipf_a: float = 1.1,
        label_noise: float = 0.25,
        model_seed: int = 777,
        fields: str = "uniform",
    ):
        self.batch_size = batch_size
        self.field_size = field_size
        self.vocab_size = vocab_size
        self.steps = steps
        self.seed = seed
        self.zipf_a = zipf_a
        self.label_noise = label_noise
        if fields == "criteo":
            sizes = criteo_field_sizes(vocab_size, field_size)
        elif fields == "uniform":
            per_field = max(vocab_size // field_size, 1)
            sizes = np.full(field_size, per_field, np.int64)
        else:
            raise ValueError(f"fields must be uniform|criteo, got {fields}")
        self._field_sizes = sizes
        self._field_offsets = np.concatenate(
            [[0], np.cumsum(sizes)[:-1]]
        ).astype(np.int64)
        rng = np.random.default_rng(model_seed)
        self._hidden_w = rng.normal(0, 1.0, size=vocab_size).astype(np.float32)

    def __len__(self):
        return self.steps

    def get_batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed + step)
        b, f = self.batch_size, self.field_size
        raw = rng.zipf(self.zipf_a, size=(b, f)).astype(np.int64)
        ids = (raw % self._field_sizes[None, :]) + self._field_offsets[None, :]
        ids = (ids % self.vocab_size).astype(np.int32)
        wts = np.ones((b, f), np.float32)
        logit = self._hidden_w[ids].mean(axis=1) * 3.0
        p = 1.0 / (1.0 + np.exp(-logit))
        noise = rng.uniform(size=b)
        label = ((1 - self.label_noise) * p + self.label_noise * noise > 0.5).astype(
            np.float32
        )[:, None]
        return {"ids": ids, "wts": wts, "label": label}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        for s in range(self.steps):
            yield self.get_batch(s)


# ---------------------------------------------------------------------------
# packed on-disk format (.npz shards, 1000 samples per packed row)
# ---------------------------------------------------------------------------

LINE_PER_SAMPLE = 1000  # the reference's packing factor


def write_packed_shards(
    out_dir: str | os.PathLike,
    batches: Iterator[dict[str, np.ndarray]],
    rows_per_shard: int = 256,
    line_per_sample: int = LINE_PER_SAMPLE,
):
    """Pack a sample stream into ``part-*.npz`` shards of
    ``rows_per_shard`` packed rows, ``line_per_sample`` samples each; a
    last partial row is dropped.  Returns the number of shards."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    buf_ids, buf_wts, buf_lab = [], [], []
    shard_idx = 0
    rows: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    def flush_shard():
        nonlocal shard_idx, rows
        if not rows:
            return
        ids = np.stack([r[0] for r in rows])
        wts = np.stack([r[1] for r in rows])
        lab = np.stack([r[2] for r in rows])
        np.savez(out / f"part-{shard_idx:05d}.npz", ids=ids, wts=wts, label=lab)
        shard_idx += 1
        rows = []

    for batch in batches:
        n = batch["ids"].shape[0]
        for i in range(n):
            buf_ids.append(batch["ids"][i])
            buf_wts.append(batch["wts"][i])
            buf_lab.append(batch["label"][i])
            if len(buf_ids) == line_per_sample:
                rows.append((np.stack(buf_ids), np.stack(buf_wts),
                             np.stack(buf_lab)))
                buf_ids, buf_wts, buf_lab = [], [], []
                if len(rows) == rows_per_shard:
                    flush_shard()
    flush_shard()
    return shard_idx


class PackedCriteoDataset:
    """Reader over packed npz shards: a batch of B samples is
    B / line_per_sample packed rows, files sharded by
    ``(num_shards, shard_id)``."""

    def __init__(
        self,
        data_dir: str | os.PathLike,
        batch_size: int,
        num_shards: int = 1,
        shard_id: int = 0,
        line_per_sample: int = LINE_PER_SAMPLE,
        drop_remainder: bool = True,
    ):
        if batch_size % line_per_sample != 0:
            raise ValueError(
                f"batch_size ({batch_size}) must be a multiple of "
                f"line_per_sample ({line_per_sample})"
            )
        self.files = sorted(Path(data_dir).glob("part-*.npz"))
        if not self.files:
            raise FileNotFoundError(f"no part-*.npz under {data_dir}")
        self.batch_size = batch_size
        self.rows_per_batch = batch_size // line_per_sample
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.line_per_sample = line_per_sample
        self.drop_remainder = drop_remainder

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        pend_i, pend_w, pend_l = [], [], []
        for fi, f in enumerate(self.files):
            if fi % self.num_shards != self.shard_id:
                continue
            with np.load(f) as z:
                ids, wts, lab = z["ids"], z["wts"], z["label"]
            for r in range(ids.shape[0]):
                pend_i.append(ids[r])
                pend_w.append(wts[r])
                pend_l.append(lab[r])
                if len(pend_i) == self.rows_per_batch:
                    yield self._assemble(pend_i, pend_w, pend_l)
                    pend_i, pend_w, pend_l = [], [], []
        if pend_i and not self.drop_remainder:
            yield self._assemble(pend_i, pend_w, pend_l)

    @staticmethod
    def _assemble(pi, pw, pl):
        ids = np.concatenate(pi, axis=0).astype(np.int32)
        wts = np.concatenate(pw, axis=0).astype(np.float32)
        lab = np.concatenate(pl, axis=0).reshape(-1, 1).astype(np.float32)
        return {"ids": ids, "wts": wts, "label": lab}


def to_device(batch: dict, device="cuda") -> dict[str, torch.Tensor]:
    """Host numpy batch -> tensors on ``device``.  On a CUDA device the
    arrays go through pinned memory with ``non_blocking=True`` copies on
    the current stream (the caller's later kernels are ordered after
    them on that stream)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out


def stage_batch(batch: dict, device, stream):
    """Stage a host batch on ``device`` as :class:`PrefetchToDevice` does:
    each array copied into pinned memory, then to the card by a
    ``non_blocking`` copy on ``stream``.  Returns the tensors and an
    event recorded on ``stream`` after the copies."""
    # the pinned copies are released inside the lock too: freeing
    # pinned memory records and queries events
    with STAGING_LOCK, torch.cuda.stream(stream):
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
               .to(device, non_blocking=True)
               for k, v in batch.items()}
        ready = torch.cuda.Event()
        ready.record(stream)
    return out, ready


class PrefetchToDevice:
    """Async host->device prefetch: a background thread stages the next
    ``depth`` batches on the card while the current step runs.

    Each batch is copied into pinned host memory and then to ``device``
    by ``non_blocking`` copies on a side CUDA stream, which records an
    event.  The consumer's current stream waits on that event before it
    gets the batch, and each staged tensor is marked with
    ``record_stream`` for the consumer's stream, so the allocator does
    not hand its memory out again while the consumer may still use it.
    An exception of the source or of the staging surfaces in the
    consumer, in order.  ``sharding``: a mesh (``parallel/mesh.py``);
    each rank stages only its data slice of each batch
    (``shard_batch``)."""

    def __init__(self, it, depth: int = 2, sharding=None, device="cuda"):
        self.sharding = sharding
        self.it = iter(it)
        self.depth = depth
        self.device = torch.device(device)
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.stream = torch.cuda.Stream(self.device)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="mrec-prefetch")
        self._thread.start()

    def _stage(self, batch):
        if self.sharding is not None:
            from mindrec_tpu_torch.parallel.mesh import shard_batch

            batch = shard_batch(batch, self.sharding)
        return stage_batch(batch, self.device, self.stream)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            with torch.cuda.device(self.device):
                for batch in self.it:
                    if not self._put(self._stage(batch)):
                        return
        except BaseException as e:  # surfaces in the consumer, in order
            self._put(e)
        finally:
            self._put(self._done)

    def close(self) -> None:
        """Stop the thread (a consumer that leaves early) and close the
        source iterator it drove."""
        self._stop.set()
        self._thread.join(timeout=10)
        close = getattr(self.it, "close", None)
        if close is not None and not self._thread.is_alive():
            close()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._done:
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
        out, ready = item
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(ready)
        for t in out.values():
            t.record_stream(consumer)
        return out
