"""Input pipeline: raw host batches -> multi-worker host prep -> staging
on the card on a side stream -> the train step.

Port of ``mindrec_tpu/data/pipeline.py`` on its host-prep path:

* :class:`HostPrepPool`: N worker threads run the native batch prep
  (``native/batchprep.cc``; its ctypes call releases the GIL, so plain
  threads overlap with the step and nothing is pickled) and yield the
  batches in source order; a bounded number in flight applies
  back-pressure.
* :class:`AdaptiveBucket`: the ``unique_bucket`` policy: it tracks the
  running distinct-id count, warns past ``warn_frac`` occupancy and, on
  overflow, grows the bucket (rounded to the 2048 quantum), so the
  trainer captures the step once more at the new shape instead of
  failing.
* :class:`SparseInputPipeline`: source -> prep pool ->
  :class:`~mindrec_tpu_torch.data.criteo.PrefetchToDevice`; on
  :class:`~mindrec_tpu_torch.train.step.BucketOverflow` it grows the
  policy, preps the batch again at the new bucket and calls
  ``on_grow``.  Batches already staged stay valid: a larger bucket only
  pads further.

Steady-state throughput = max(step, prep / workers, host->device copy).
Not ported here: the wire format, device-side prep (``host_prep=False``),
superbatch staging and sharded staging (``ROADMAP.md`` §1 items 6 and
10); each raises ``NotImplementedError``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import threading

import numpy as np

from mindrec_tpu_torch.data.criteo import PrefetchToDevice
from mindrec_tpu_torch.train.step import BucketOverflow, make_batch_sort


def round_bucket(n: int, quantum: int = 2048) -> int:
    """Round a distinct-id bound up to the 2048-row quantum that the
    step rounds ``unique_bucket`` to."""
    return max(quantum, (int(n) + quantum - 1) // quantum * quantum)


class AdaptiveBucket:
    """``unique_bucket`` policy.

    ``observe(nu)`` tracks the running max distinct-id count and warns
    once past ``warn_frac`` occupancy; ``grow(nu)`` returns the new
    bucket after an overflow (``nu * headroom``, tile-rounded)."""

    def __init__(self, bucket: int, headroom: float = 1.2,
                 warn_frac: float = 0.9, quantum: int = 2048,
                 log=print):
        self.bucket = round_bucket(bucket, quantum)
        self.headroom = headroom
        self.warn_frac = warn_frac
        self.quantum = quantum
        self.max_seen = 0
        self._warned = False
        self._log = log

    @classmethod
    def from_sample(cls, batches, **kw) -> "AdaptiveBucket":
        """Bucket = most distinct ids in the sample batches x headroom."""
        headroom = kw.get("headroom", 1.2)
        mx = max(int(np.unique(np.asarray(b["ids"])).size) for b in batches)
        return cls(int(mx * headroom), **kw)

    def observe(self, nu: int):
        if nu > self.max_seen:
            self.max_seen = nu
        if not self._warned and nu > self.warn_frac * self.bucket:
            self._warned = True
            self._log(
                f"[mindrec] unique_bucket at {nu}/{self.bucket} "
                f"(> {self.warn_frac:.0%}); an overflow will re-jit at "
                f"~{round_bucket(int(self.bucket * self.headroom), self.quantum)}",
                flush=True,
            )

    def grow(self, nu: int) -> int:
        new = round_bucket(int(max(nu, self.bucket) * self.headroom),
                           self.quantum)
        self._log(
            f"[mindrec] unique_bucket overflow: {nu} distinct ids > "
            f"{self.bucket}; growing to {new} (one-time re-jit)",
            flush=True,
        )
        self.bucket = new
        self._warned = False
        return new


class HostPrepPool:
    """Ordered multi-worker prep over an iterator of host batches.

    ``prep`` runs inside ``workers`` threads; at most ``depth`` batches
    are in flight; results are yielded strictly in source order.
    ``prep`` may raise: the exception surfaces on the consumer side in
    order, carrying ``.raw_batch`` so a supervisor can retry."""

    def __init__(self, source, prep, workers: int = 1, depth: int = 3):
        self.source = source
        self.prep = prep
        self.workers = max(1, int(workers))
        self.depth = max(self.workers, int(depth))

    def __iter__(self):
        ex = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix="mrec-prep"
        )
        futs: collections.deque = collections.deque()
        it = iter(self.source)

        def submit_next() -> bool:
            try:
                raw = next(it)
            except StopIteration:
                return False
            fut = ex.submit(self.prep, raw)
            fut.raw_batch = raw
            futs.append(fut)
            return True

        try:
            for _ in range(self.depth):
                if not submit_next():
                    break
            while futs:
                fut = futs.popleft()
                try:
                    out = fut.result()
                except BaseException as e:
                    e.raw_batch = fut.raw_batch
                    raise
                submit_next()
                yield out
        finally:
            ex.shutdown(wait=False, cancel_futures=True)


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md section 1 item {item})")


class SparseInputPipeline:
    """raw host batches -> prep pool -> (optional) staging on the card.

    Yields batches ready for ``make_train_step``: the step sizes its
    unique buffer from the length of ``uq_ids``, which is trimmed to
    ``policy.bucket``, so a regrow is a new batch signature.

    Args:
      source: iterable of raw host batches (dicts with ``ids`` etc.).
      field_size: ids per sample (prep contract).
      policy: :class:`AdaptiveBucket` (or None: lossless prep, no
        bucket checks; the step then uses the full ``uq_ids`` length).
      workers/depth: prep pool size.
      device: True stages each batch onto the current CUDA device with
        :class:`PrefetchToDevice` (tensors); False yields the numpy
        dicts (host-side consumers and CPU tests).
      minimal: drop ``sorted_ids``/``inv`` from the prep output (the
        step never reads them).
      on_grow: callable(new_bucket) invoked after a re-bucket.
      prefetch_depth: batches staged ahead on the card.
      groups: a model's id groups (``step.prep_groups``): per-group
        lossless prep with ``{group}:``-prefixed keys; no policy then.
      wire, host_prep=False, decode=False, superbatch > 1,
        unstack=False, pad_tail, sharding: not ported (raise).
    """

    def __init__(self, source, field_size: int, policy=None,
                 workers: int = 1, depth: int = 3, device: bool = True,
                 sharding=None, minimal: bool = True, on_grow=None,
                 prefetch_depth: int = 2, groups: dict | None = None,
                 wire=None, host_prep: bool = True, audit_every: int = 16,
                 decode: bool = True, superbatch: int = 1,
                 unstack: bool = True, pad_tail: bool = False):
        del audit_every  # device-prep audit: not ported with host_prep=False
        if wire is not None:
            raise _not_ported("the wire format (wire=)", 6)
        if not host_prep:
            raise _not_ported("device-side prep (host_prep=False)", 6)
        if not decode or not unstack or int(superbatch) > 1 or pad_tail:
            raise _not_ported("superbatch staging (superbatch, decode, "
                              "unstack, pad_tail)", 6)
        if sharding is not None:
            raise _not_ported("sharded staging (sharding=)", 10)
        if groups is not None and policy is not None:
            raise ValueError(
                "AdaptiveBucket policy is single-group; pass policy=None "
                "with groups (per-group buckets can be passed to "
                "make_batch_sort directly)"
            )
        self.source = source
        self.field_size = field_size
        self.policy = policy
        self.workers = workers
        self.depth = depth
        self.device = device
        self.minimal = minimal
        self.on_grow = on_grow
        self.prefetch_depth = prefetch_depth
        self.groups = groups
        self._lock = threading.Lock()
        self._make_prep()

    def _make_prep(self):
        policy = self.policy
        base = make_batch_sort(
            self.field_size,
            unique_bucket=policy.bucket if policy is not None else None,
            minimal=self.minimal, groups=self.groups,
        )
        if policy is None:
            self._prep = base
            return

        def prep(raw):
            out = base(raw)
            # distinct count = final unique index + 1
            policy.observe(int(out["uidx_sorted"][-1]) + 1)
            # trim the sentinel-padded unique ids to the bucket: the step
            # sizes its buffer from this length (a regrow is a new
            # signature) and the host->device copy shrinks to the bucket
            if out["uq_ids"].shape[0] > policy.bucket:
                out["uq_ids"] = out["uq_ids"][: policy.bucket]
            return out

        self._prep = prep

    def _prep_supervised(self, raw):
        """Prep with re-bucket-and-retry on overflow (thread-safe: two
        workers may hit the same overflow)."""
        while True:
            try:
                return self._prep(raw)
            except BucketOverflow as e:
                with self._lock:
                    if e.n_unique > self.policy.bucket:  # not already grown
                        new = self.policy.grow(e.n_unique)
                        self._make_prep()
                        if self.on_grow is not None:
                            self.on_grow(new)

    def __iter__(self):
        prep = self._prep_supervised if self.policy is not None else self._prep
        src = iter(HostPrepPool(self.source, prep, self.workers, self.depth))
        if not self.device:
            return src
        return iter(PrefetchToDevice(src, depth=self.prefetch_depth))
