"""RecModel: the high-level training API.

Port of ``mindrec_tpu/train/rec_model.py``: a model wrapper exposing
``train`` / ``eval`` / ``online_train`` with the reference's semantics:

* ``online_train`` loops over an unbounded stream until it is exhausted
  or a callback requests a stop; sink mode takes exactly one batch per
  sink iteration and ``sink_size`` must be 1 (ValueError otherwise,
  TypeError for a non-bool sink mode); on the CPU sink mode is off;
* the callback lifecycle around epochs and steps.

"Dataset sink" is the input pipeline: with ``unique_bucket`` or
``host_prep`` the raw host batches go through
:class:`~mindrec_tpu_torch.data.pipeline.SparseInputPipeline` (native
prep in a thread pool, staging on a side CUDA stream); otherwise
:class:`~mindrec_tpu_torch.data.criteo.PrefetchToDevice` stages them.
With ``jit=True`` the step on the card is captured in a CUDA graph per
batch signature and replayed (``train/step.py:CapturedStep``); on the
CPU (``device="cpu"``) it runs eagerly.

Dense models (every model config's default, ``sparse=False``) take no
bucket and no host prep: their batches go through ``PrefetchToDevice``
to the dense step, captured like the sparse steps.

A ``train_step`` or ``eval_step`` that is not a step of
``make_train_step`` / ``make_eval_step`` (those carry
``takes_device_batches``), such as the cache regime's
``cached_train_step`` wrapper (``train/cached.py``), gets each batch
untouched, as the dataset yields it: no input pipeline, no staging, so
the ids reach the LRU or the hash store as host arrays; the wrapper
stages what its inner step needs.

The input recipes of the reference: ``wire=`` packs batches on the host
and decodes them on the card (``data/wire.py``); ``prep_placement=
"device"`` stages only the (encoded) raw batches and the step sorts on
the card at a static ``unique_bucket``; ``input_recipe="auto"``
measures the host->device link once and picks host prep, or device prep
with the compact wire, superbatch staging and the fused step (one
CUDA-graph replay per batch that slices, decodes and steps).
On a mesh (the model's ``mesh``, ``parallel/mesh.py``, more than one
rank) ``rank_id`` is the process group's rank and every rank runs the
same ``RecModel`` on the same global batches: the state is initialised
whole and cut to this rank's blocks (``shard_train_state``; its
placement tree is ``shardings``), the step is captured as on one card
(``jit``; its graphs are cut at every collective), each batch is cut to
this rank's data slice before staging, ``eval`` gathers the
predictions over ``data`` before the metrics, callbacks print on rank 0
and ``CheckpointCallback`` saves one sliced file per rank.
"""

from __future__ import annotations

import sys
from typing import Iterable

import numpy as np
import torch

from mindrec_tpu_torch.data.criteo import PrefetchToDevice, to_device
from mindrec_tpu_torch.data.pipeline import AdaptiveBucket, SparseInputPipeline
from mindrec_tpu_torch.parallel.mesh import (
    DATA_AXIS, all_gather, shard_batch, shard_train_state, state_placements,
)
from mindrec_tpu_torch.train import optim as optim_lib
from mindrec_tpu_torch.train.callbacks import CallbackManager, RunContext
from mindrec_tpu_torch.train.metrics import AUCMetric
from mindrec_tpu_torch.train.step import (
    CapturedStep, TrainState, init_train_state, make_eval_step,
    make_train_step, prep_groups,
)


class RecModel:
    """High-level wrapper tying a model, dual optimizers, metrics and the
    train/eval step functions together.

    Args:
      model: a model object from ``mindrec_tpu_torch.models``.
      opt_w / opt_d: wide/deep optimizers; defaults: FTRL and Adam at
        the model config's loss scale.
      metrics: dict name -> Metric; default ``{"auc": AUCMetric()}``.
      seed: parameter init seed.
      jit: capture the train step in CUDA graphs on the card (on a mesh,
        one graph between two collectives).
      donate: the step updates the state in place; False runs it on a
        copy and leaves the state passed in as it was.
      unique_bucket: an int or :class:`AdaptiveBucket` bound on distinct
        ids per batch; ``train(dataset_sink_mode=True)`` then treats the
        dataset as raw host batches and runs prep pool -> staging ->
        step, growing the bucket (one new capture) on overflow.
      prep_workers: host prep threads.
      host_prep: run the pipeline without a bucket (lossless prep; the
        form for multi-id-group models, which get per-group prep).
      wire: a :class:`~mindrec_tpu_torch.data.wire.BatchWire`: batches
        are packed on the host and decoded on the card after staging.
      prep_placement: ``"host"`` (default) sorts on the host;
        ``"device"`` stages only the (encoded) raw batches and the step
        sorts on the card at the static ``unique_bucket`` (required),
        audited on the host every ``audit_every`` batches; a regrow
        rebuilds the step (one new capture).
      input_recipe: ``"auto"`` measures the host->device link at the
        first ``train(dataset_sink_mode=True)`` on the card
        (:func:`~mindrec_tpu_torch.data.wire.measure_link`) and keeps
        host prep where the link hides under the step, else picks device
        prep, the compact wire, superbatch staging (one copy per k
        batches) and the fused step; it needs ``unique_bucket`` and a
        single-id-group model, else it keeps the configured pipeline.
        A no-op on the CPU.
      device: where the state lives, ``"cuda"`` (default) or ``"cpu"``.
    """

    def __init__(
        self,
        model,
        opt_w=None,
        opt_d=None,
        metrics=None,
        seed: int = 0,
        jit: bool = True,
        donate: bool = True,
        unique_bucket=None,
        prep_workers: int = 1,
        host_prep: bool | None = None,
        wire=None,
        prep_placement: str = "host",
        audit_every: int = 16,
        input_recipe: str = "none",
        device="cuda",
    ):
        if prep_placement not in ("host", "device"):
            raise ValueError(
                f"prep_placement must be 'host' or 'device', got "
                f"{prep_placement!r}"
            )
        if input_recipe not in ("none", "auto"):
            raise ValueError(f"input_recipe must be 'none' or 'auto', "
                             f"got {input_recipe!r}")
        self.model = model
        self.device = torch.device(device)
        sens = float(getattr(model.config, "loss_scale", 1.0))
        self.opt_w = opt_w or optim_lib.ftrl(loss_scale=sens)
        self.opt_d = opt_d or optim_lib.adam(loss_scale=sens)
        self.metrics = metrics if metrics is not None else {"auc": AUCMetric()}
        self.bucket_policy = None
        if unique_bucket is not None:
            self.bucket_policy = (
                unique_bucket if isinstance(unique_bucket, AdaptiveBucket)
                else AdaptiveBucket(int(unique_bucket))
            )
        self.prep_workers = prep_workers
        self.host_prep = (host_prep if host_prep is not None
                          else unique_bucket is not None)
        if prep_placement == "device":
            if self.bucket_policy is None:
                raise ValueError(
                    "prep_placement='device' needs unique_bucket (the "
                    "step's static distinct-id bound)"
                )
            self.host_prep = True  # the pipeline still runs (audit, wire)
        self.wire = wire
        self.prep_placement = prep_placement
        self.audit_every = audit_every
        self.input_recipe = input_recipe
        self._recipe_resolved = input_recipe != "auto"
        self.link = None  # (fixed ms per put, bytes/s) once measured
        mesh = getattr(model, "mesh", None)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None:
            if prep_placement != "host" or input_recipe != "none" or wire:
                raise ValueError(
                    "on a mesh batches take host prep (or none): device "
                    "prep, the wire and input_recipe='auto' are one-card "
                    "recipes")
        self._superbatch = 1
        self._fused = None  # (fused step, superbatch k)
        # with host prep the step sizes its unique buffer from the trimmed
        # uq_ids (a regrow is a new signature); in device placement the
        # bucket is static and a regrow rebuilds the step
        self._step_kw = dict(jit=jit, donate=donate)
        if prep_placement == "device":
            self._step_kw["unique_bucket"] = self.bucket_policy.bucket
        self.train_step = make_train_step(model, self.opt_w, self.opt_d,
                                          **self._step_kw)
        self.eval_step = make_eval_step(model)
        self.state: TrainState = init_train_state(
            model, seed, self.opt_w, self.opt_d, device=self.device)
        self.rank_id = self.mesh.rank if self.mesh is not None else 0
        self.shardings = None  # the state's placement tree on a mesh
        if self.mesh is not None:
            self.shardings = state_placements(self.state, model, self.mesh)
            self.state = shard_train_state(self.state, model, self.mesh)

    def _on_bucket_grow(self, new_bucket: int):
        """Device placement: the host audit grew the bucket; rebuild the
        step at the new static bound (one new capture)."""
        self._step_kw["unique_bucket"] = new_bucket
        self.train_step = make_train_step(self.model, self.opt_w, self.opt_d,
                                          **self._step_kw)
        if self._fused is not None:
            self._build_fused(new_bucket)

    # ------------------------------------------------------------------
    # the measured input recipe (link physics -> prep placement)
    # ------------------------------------------------------------------

    def _resolve_recipe(self):
        """``input_recipe='auto'``: measure the host->device link once and
        set the wire, the prep placement and the superbatch depth from its
        affine cost model (fixed ms per put + bytes/s)."""
        self._recipe_resolved = True
        if self.device.type != "cuda":
            return
        cfg = self.model.config
        groups = getattr(self.model, "table_groups", None)
        multi = groups is not None and not (
            len(groups) == 1 and "_default" in groups
        )
        if self.bucket_policy is None or multi or self.wire is not None:
            return  # keep the explicitly configured pipeline
        from mindrec_tpu_torch.data.wire import BatchWire, measure_link

        fixed_ms, bw = measure_link(self.device)
        self.link = (fixed_ms, bw)
        B, F = int(cfg.batch_size), int(cfg.field_size)
        wire = BatchWire.for_sparse(int(cfg.vocab_size), B, F,
                                    host_prep=False)
        probe = {
            "ids": np.zeros((B, F), np.int32),
            "wts": np.zeros((B, F), np.float32),
            "label": np.zeros((B, 1), np.float32),
        }
        wire_bytes = wire.wire_bytes(probe)
        # host-prep payload: raw batch + perm/uidx/uidx_sorted i32 + the
        # bucket-trimmed unique ids (the minimal prep set)
        host_bytes = (
            B * F * 4 * 2 + B * 4 + B * F * 4 * 3
            + self.bucket_policy.bucket * 4
        )
        host_ms = host_bytes / bw * 1e3
        # step-time proxy, only to decide whether the link is the
        # bottleneck at all: the captured W&D bench step on an NVIDIA H100
        # 80GB HBM3 at 700 W, 4.66-4.72 ms per 16,000 samples (about 3.4M
        # samples/s; PERF.md section 6, PRs 10-11), scaled by batch size
        step_proxy_ms = B / 3.4e6 * 1e3
        if fixed_ms + host_ms <= step_proxy_ms:
            return  # a fast link: host prep (the smallest step) wins
        # amortize the link's fixed per-put cost to <= ~5 ms per batch,
        # capped at 16 (staging memory), a power of two
        k = max(1, min(16, -(-int(fixed_ms) // 5)))
        k = 1 << (k - 1).bit_length() if k > 1 else 1
        self.wire = wire
        self.prep_placement = "device"
        self.host_prep = True
        self._superbatch = k
        self._step_kw["unique_bucket"] = self.bucket_policy.bucket
        self.train_step = make_train_step(self.model, self.opt_w, self.opt_d,
                                          **self._step_kw)
        if k > 1:
            self._build_fused(self.bucket_policy.bucket)
        print(
            f"[mindrec] auto input recipe: link fixed={fixed_ms:.0f} ms/put"
            f", bw={bw / 1e6:.0f} MB/s -> device-prep compact wire "
            f"({wire_bytes / 1e6:.2f} MB/batch vs {host_bytes / 1e6:.2f} "
            f"host-prep), superbatch={k}"
            + (", fused slice/decode/step" if k > 1 else ""),
            flush=True,
        )

    def _build_fused(self, bucket: int):
        """The fused step: one step that decodes one batch's packed
        arena and trains on it, captured once (``jit``) so each batch is
        one CUDA-graph replay; the batch's slice of the staged supergroup
        is copied into the graph's static input."""
        kw = {**self._step_kw, "jit": False, "unique_bucket": bucket}
        raw_step = make_train_step(self.model, self.opt_w, self.opt_d, **kw)
        decode = self.wire.decoder()

        def fused(state, batch):
            return raw_step(state, decode(batch))

        fused.takes_device_batches = True
        self._fused = (CapturedStep(fused) if self._step_kw["jit"] else fused,
                       self._superbatch)

    @property
    def params(self):
        return self.state.params

    def _tensors(self, batch) -> dict:
        """A batch as tensors on the state's device (host batches are
        staged here; staged batches pass through)."""
        if all(isinstance(v, torch.Tensor) and v.device == self.state.step.device
               for v in batch.values()):
            return batch
        return to_device(batch, self.state.step.device)

    def _exec_step(self, batch):
        """Run one train step; returns its (loss_w, loss_d).  A wrapper
        ``train_step`` gets the batch untouched.  The fused step's
        batches arrive as ``{"__sup__": staged supergroup, "__i__":
        slice}`` markers."""
        if "__sup__" in batch:
            sup, i = batch["__sup__"], batch["__i__"]
            one = self._tensors({k: v[i] for k, v in sup.items()})
            self.state, losses = self._fused[0](self.state, one)
            return losses
        if _takes_device_batches(self.train_step):
            batch = self._tensors(batch)
        self.state, losses = self.train_step(self.state, batch)
        return losses

    # ------------------------------------------------------------------
    # offline training
    # ------------------------------------------------------------------

    def train(
        self,
        epoch: int,
        train_dataset,
        callbacks=None,
        dataset_sink_mode: bool = True,
    ):
        """Epoch-bounded training over a re-iterable dataset."""
        self._check_sink_mode_type(dataset_sink_mode)
        cb = CallbackManager(callbacks)
        ctx = RunContext(rank_id=self.rank_id, train_state=self.state,
                         shardings=self.shardings)
        cb.on_train_begin(ctx)
        step_num = 0
        for ep in range(1, epoch + 1):
            ctx.epoch_num = ep
            cb.on_train_epoch_begin(ctx)
            it = self._maybe_sink(train_dataset, dataset_sink_mode)
            try:
                for batch in it:
                    step_num += 1
                    ctx.cur_step_num = step_num
                    cb.on_train_step_begin(ctx)
                    losses = self._exec_step(batch)
                    ctx.net_outputs = losses
                    ctx.train_state = self.state
                    cb.on_train_step_end(ctx)
                    if ctx.train_state is not self.state:
                        # a callback replaced the state: train on it
                        self.state = ctx.train_state
                    if ctx.stop_requested:
                        break
            finally:
                _close(it)
            cb.on_train_epoch_end(ctx)
            if ctx.stop_requested:
                break
        cb.on_train_end(ctx)
        return self.state

    # ------------------------------------------------------------------
    # online (streaming, unbounded) training
    # ------------------------------------------------------------------

    def online_train(
        self,
        train_dataset,
        callbacks=None,
        dataset_sink_mode: bool = False,
        sink_size: int = 1,
    ):
        """Unbounded streaming training: iterates ``train_dataset`` (any
        iterable) until it is exhausted or a callback requests a stop;
        the epoch loop is unbounded (``sys.maxsize``)."""
        self._check_sink_mode_type(dataset_sink_mode)
        if sink_size < 1:
            raise ValueError(
                f"The 'sink_size' must be a positive integer, but got {sink_size}."
            )
        if dataset_sink_mode and sink_size != 1:
            raise ValueError(
                "The 'sink_size' must be 1 for online training in dataset "
                f"sink mode, but got {sink_size}."
            )
        if self.state.step.device.type == "cpu":
            dataset_sink_mode = False  # a CPU target runs without sink

        cb = CallbackManager(callbacks)
        ctx = RunContext(rank_id=self.rank_id, train_state=self.state,
                         shardings=self.shardings)
        cb.on_train_begin(ctx)
        step_num = 0
        it = iter(self._maybe_sink(train_dataset, dataset_sink_mode))
        try:
            for ep in range(1, sys.maxsize):
                if ctx.stop_requested:
                    break
                ctx.epoch_num = ep
                cb.on_train_epoch_begin(ctx)
                # one "epoch" of a stream = one sink iteration (one batch)
                try:
                    batch = next(it)
                except StopIteration:
                    cb.on_train_epoch_end(ctx)
                    break
                step_num += 1
                ctx.cur_step_num = step_num
                cb.on_train_step_begin(ctx)
                losses = self._exec_step(batch)
                ctx.net_outputs = losses
                ctx.train_state = self.state
                cb.on_train_step_end(ctx)
                if ctx.train_state is not self.state:
                    self.state = ctx.train_state
                cb.on_train_epoch_end(ctx)
        finally:
            _close(it)
        cb.on_train_end(ctx)
        return self.state

    # ------------------------------------------------------------------
    # eval
    # ------------------------------------------------------------------

    def eval(self, dataset, metrics=None) -> dict:
        metrics = metrics or self.metrics
        for m in metrics.values():
            m.clear()
        own = _takes_device_batches(self.eval_step)
        for batch in dataset:
            part = batch if self.mesh is None else shard_batch(batch, self.mesh)
            probs, labels = self.eval_step(
                self.state.params, self._tensors(part) if own else part)
            if self.mesh is not None:  # the global batch's predictions
                probs, labels = (all_gather(torch.as_tensor(x).contiguous(),
                                            DATA_AXIS, self.mesh)
                                 for x in (probs, labels))
            # a replaced eval step (a regime's adapter) may hand back
            # the host batch's labels as they came
            probs = _host(probs).astype(np.float32)
            labels = _host(labels).astype(np.float32)
            for m in metrics.values():
                # metrics may declare extra batch columns (the grouped
                # MAP@12 needs display_id) via a `needs` attribute
                extra = [_host(batch[k]) for k in getattr(m, "needs", ())]
                m.update(probs, labels, *extra)
        return {name: m.eval() for name, m in metrics.items()}

    # ------------------------------------------------------------------

    @staticmethod
    def _check_sink_mode_type(dataset_sink_mode):
        if not isinstance(dataset_sink_mode, bool):
            raise TypeError(
                "The 'dataset_sink_mode' must be a bool, but got "
                f"{type(dataset_sink_mode).__name__}."
            )

    def _maybe_sink(self, dataset, sink: bool) -> Iterable:
        if self.mesh is not None:
            return self._mesh_sink(dataset, sink)
        if not sink or not _takes_device_batches(self.train_step):
            return iter(dataset)
        if not self._recipe_resolved:
            self._resolve_recipe()
        on_card = self.state.step.device.type == "cuda"
        field_size = int(getattr(self.model.config, "field_size", 0))
        if self._fused is not None:
            pipe = SparseInputPipeline(
                dataset, field_size=field_size, policy=self.bucket_policy,
                workers=self.prep_workers, device=on_card, wire=self.wire,
                host_prep=False, audit_every=self.audit_every,
                on_grow=self._on_bucket_grow, superbatch=self._fused[1],
                unstack=False, decode=False, pad_tail=True,
            )
            return _fused_markers(pipe)
        if self.host_prep:
            # raw host batches -> prep pool -> staging, with adaptive
            # re-bucketing (one id group) or per-group lossless prep
            groups = prep_groups(self.model)  # tiny groups need no sort
            device_prep = self.prep_placement == "device"
            if device_prep and groups is not None:
                raise ValueError(
                    "prep_placement='device' is single-id-group only")
            return iter(SparseInputPipeline(
                dataset, field_size=field_size,
                policy=(self.bucket_policy
                        if (device_prep or groups is None) else None),
                groups=groups,
                workers=self.prep_workers,
                device=on_card,
                wire=self.wire,
                host_prep=not device_prep,
                audit_every=self.audit_every,
                on_grow=self._on_bucket_grow if device_prep else None,
            ))
        if on_card:
            return PrefetchToDevice(dataset, depth=2,
                                    device=self.state.step.device)
        return iter(dataset)


    def _mesh_sink(self, dataset, sink: bool) -> Iterable:
        """On a mesh: this rank's slice of each batch, host-prepped on the
        global batch when the step takes prep, staged on the card in sink
        mode."""
        on_card = self.state.step.device.type == "cuda"
        if self.host_prep:
            groups = prep_groups(self.model)
            return iter(SparseInputPipeline(
                dataset, field_size=int(getattr(self.model.config,
                                                "field_size", 0)),
                policy=self.bucket_policy if groups is None else None,
                groups=groups, workers=self.prep_workers,
                device=on_card and sink, sharding=self.mesh,
                audit_every=self.audit_every,
            ))
        if sink and on_card:
            return PrefetchToDevice(dataset, depth=2, sharding=self.mesh,
                                    device=self.state.step.device)
        return (shard_batch(b, self.mesh) for b in dataset)


def _fused_markers(pipe):
    """Staged supergroups -> one marker per real batch (a padded tail's
    repeats are skipped)."""
    it = iter(pipe)
    try:
        for sup in it:
            sup = dict(sup)
            n = int(sup.pop("__sb_n__"))
            for i in range(n):
                yield {"__sup__": sup, "__i__": i}
    finally:
        _close(it)


def _takes_device_batches(fn) -> bool:
    """A step of make_train_step / make_eval_step (RecModel stages its
    batches), not a wrapper that takes host batches."""
    return bool(getattr(fn, "takes_device_batches", False))


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _close(it) -> None:
    """Stop a prefetch thread a loop left early."""
    close = getattr(it, "close", None)
    if close is not None:
        close()
