"""Input pipeline: raw host batches -> multi-worker host prep -> staging
on the card on a side stream -> the train step.

Port of ``mindrec_tpu/data/pipeline.py``:

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

* device prep (``host_prep=False``): no host sort; the raw (optionally
  wire-encoded) batches go to the card and the step sorts there, with a
  host audit of the distinct-id count every ``audit_every`` batches that
  grows the bucket and calls ``on_grow``;
* the compact wire (``wire=``, ``data/wire.py``): batches are packed on
  the host in the prep pool and decoded on the card after staging;
* superbatch staging (``superbatch=k``): k batches stacked on the host
  and staged as one copy, then sliced apart on the card (a slice is a
  view, not a transfer); ``decode=False`` / ``unstack=False`` hand the
  packed supergroups to a consumer that slices and decodes in its own
  step (``RecModel``'s fused step).

Steady-state throughput = max(step, prep / workers, host->device copy).
Sharded staging (``sharding=`` a mesh, ``parallel/mesh.py``): prep runs
on the global batch (so ``uq_ids`` is the global unique vector), then
each rank stages only its data slice (``shard_batch``); with superbatch
staging or the wire it raises ``ValueError``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import itertools
import threading

import numpy as np

from mindrec_tpu_torch.data.criteo import PrefetchToDevice
from mindrec_tpu_torch.parallel.mesh import shard_batch
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


def _stack_groups(it, k: int, pad_tail: bool = False):
    """Group k consecutive batches into one stacked dict (axis-0 stack
    per key) so the device staging pays ONE transfer round-trip per
    group; the tail group may be shorter.

    ``pad_tail``: pad a short tail group to k by repeating its last
    batch and attach the REAL batch count under ``"__sb_n__"`` (0-d
    int32), so every group has one shape and a fused consumer (one
    captured slice + decode + step per batch) needs no second capture
    for the tail; consumers must run only the first ``__sb_n__``
    slices."""
    def stack(group):
        if pad_tail:
            # __sb_n__ rides EVERY group (not just padded ones) so full
            # and tail groups have one structure
            real = len(group)
            group = group + [group[-1]] * (k - real)
            out = stack_keys(group)
            out["__sb_n__"] = np.int32(real)
            return out
        return stack_keys(group)

    def stack_keys(group):
        try:
            return {
                key: np.stack([g[key] for g in group]) for key in group[0]
            }
        except ValueError as e:
            # a mid-group AdaptiveBucket regrow changes the uq arrays'
            # length; surface the cause instead of np.stack's opaque
            # shape error (flushing the short pre-grow group would drop
            # the size guarantee consumers rely on)
            raise ValueError(
                "superbatch group has ragged per-key shapes — most "
                "likely the unique bucket grew mid-group (AdaptiveBucket "
                "on_grow); use a bucket with enough headroom to cover "
                f"the stream, or superbatch=1: {e}"
            ) from e

    group = []
    for b in it:
        group.append(b)
        if len(group) == k:
            yield stack(group)
            group = []
    if group:
        yield stack(group)


def _unstack_groups(it):
    """Inverse of :func:`_stack_groups` after staging: slicing a staged
    tensor is a view on the card, no further transfer."""
    for sb in it:
        if "__sb_n__" in sb:
            sb = dict(sb)
            n = int(sb.pop("__sb_n__"))
        else:
            n = next(iter(sb.values())).shape[0]
        for i in range(n):
            yield {key: v[i] for key, v in sb.items()}


class SparseInputPipeline:
    """raw host batches -> prep pool -> (optional) staging on the card.

    Yields batches ready for ``make_train_step``: with host prep the step
    sizes its unique buffer from the length of ``uq_ids``, which is
    trimmed to ``policy.bucket``, so a regrow is a new batch signature;
    with device prep the step is built with ``unique_bucket=
    policy.bucket`` and ``on_grow`` rebuilds it.

    Args:
      source: iterable of raw host batches (dicts with ``ids`` etc.).
      field_size: ids per sample (prep contract).
      policy: :class:`AdaptiveBucket` (or None: lossless prep, no
        bucket checks; the step then uses the full ``uq_ids`` length).
      workers/depth: prep pool size.
      device: True stages each batch onto the current CUDA device with
        :class:`PrefetchToDevice` (tensors); False yields the numpy
        dicts (host-side consumers and CPU tests).
      sharding: a :class:`~mindrec_tpu_torch.parallel.mesh.Mesh`: each
        rank stages (or yields) its data slice of each prepped batch.
      minimal: drop ``sorted_ids``/``inv`` from the prep output (the
        step never reads them).
      on_grow: callable(new_bucket) invoked after a re-bucket.
      prefetch_depth: batches (or supergroups) staged ahead on the card.
      groups: a model's id groups (``step.prep_groups``): per-group
        lossless prep with ``{group}:``-prefixed keys; no policy then.
      wire: a :class:`~mindrec_tpu_torch.data.wire.BatchWire`: batches
        are packed on the host and decoded after staging (on the card,
        or on the CPU with ``device=False``); the decoded batch has the
        unpacked layout.
      host_prep: False is device prep: no host sort, only the (encoded)
        raw batches are staged and the step sorts on the card (build it
        with ``unique_bucket=policy.bucket``).  The bucket is audited on
        the host every ``audit_every`` batches (``np.unique``; the
        step would drop the ids past a too-small bucket), growing the
        policy and calling ``on_grow`` as host prep does.
      decode: with ``wire``, False yields the staged packed batches for
        a consumer that decodes inside its own step.
      superbatch: stage k batches per copy (stacked on the host, sliced
        apart on the card); consumers see ordinary batches and the tail
        group may be smaller.
      unstack: with ``superbatch`` > 1 and ``decode=False``, False
        yields the staged [k, ...] supergroups themselves.
      pad_tail: pad a short tail group to k (see :func:`_stack_groups`);
        the real count stays on the host.
    """

    def __init__(self, source, field_size: int, policy=None,
                 workers: int = 1, depth: int = 3, device: bool = True,
                 sharding=None, minimal: bool = True, on_grow=None,
                 prefetch_depth: int = 2, groups: dict | None = None,
                 wire=None, host_prep: bool = True, audit_every: int = 16,
                 decode: bool = True, superbatch: int = 1,
                 unstack: bool = True, pad_tail: bool = False):
        if superbatch > 1 and sharding is not None:
            # staged supergroups are [k, B, ...]: a per-batch slice would
            # cut the group axis instead (the reference's guard)
            raise ValueError(
                "superbatch>1 stages stacked [k, B, ...] arrays; a "
                "per-batch sharding would shard the group axis; use "
                "superbatch=1 with sharding, or shard after unstacking"
            )
        if wire is not None and sharding is not None:
            raise ValueError(
                "the wire packs whole batches; sharded staging slices "
                "decoded batches: take wire=None with sharding")
        if not unstack and (superbatch <= 1 or decode):
            raise ValueError(
                "unstack=False yields staged supergroups for fused "
                "consumers; it requires superbatch>1 and decode=False"
            )
        if not host_prep and groups is not None:
            raise ValueError("device-prep mode is single-id-group only")
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
        self.wire = wire
        self.host_prep = host_prep
        self.audit_every = audit_every
        self.superbatch = int(superbatch)
        self.unstack = unstack
        self.pad_tail = bool(pad_tail)
        self.sharding = sharding
        self._decode = wire.decoder() if wire is not None and decode else None
        self._lock = threading.Lock()
        self._make_prep()

    def _make_prep(self):
        policy = self.policy
        encode = self.wire.encode if self.wire is not None else None

        if not self.host_prep:
            # device prep: no host sort; the optional wire encode and the
            # periodic bucket audit
            counter = itertools.count()
            audit = self.audit_every

            def prep(raw):
                if policy is not None and audit and next(counter) % audit == 0:
                    nu = int(np.unique(np.asarray(raw["ids"])).size)
                    policy.observe(nu)
                    if nu > policy.bucket:
                        raise BucketOverflow(nu, policy.bucket)
                return encode(raw) if encode is not None else dict(raw)

            self._prep = prep
            return

        base = make_batch_sort(
            self.field_size,
            unique_bucket=policy.bucket if policy is not None else None,
            minimal=self.minimal, groups=self.groups,
        )
        if policy is None:
            self._prep = (
                base if encode is None else (lambda raw: encode(base(raw)))
            )
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
            return out if encode is None else encode(out)

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
        counts = None
        if self.sharding is not None:  # this rank's slice travels
            mesh = self.sharding
            src = (shard_batch(b, mesh) for b in src)
        if self.superbatch > 1:
            src = _stack_groups(src, self.superbatch, self.pad_tail)
            if self.pad_tail and self.device:
                # keep each group's real batch count on the host: staged,
                # the consumer's int() would be a read from the card
                counts = collections.deque()

                def strip(it_):
                    for sb in it_:
                        sb = dict(sb)
                        counts.append(int(sb.pop("__sb_n__")))
                        yield sb

                src = strip(src)
        it = _staged(src, self.prefetch_depth) if self.device else src
        if counts is not None:
            def reattach(it_):
                for sb in it_:
                    out = dict(sb)
                    out["__sb_n__"] = counts.popleft()
                    yield out

            it = reattach(it)
        if self.superbatch > 1 and self.unstack:
            it = _unstack_groups(it)
        if self._decode is None:
            return it
        return (self._decode(b) for b in it)


def _staged(src, depth):
    """Stage ``src`` on the card; leaving the loop early (``close()``)
    stops the staging thread."""
    pf = PrefetchToDevice(src, depth=depth)
    try:
        yield from pf
    finally:
        pf.close()
