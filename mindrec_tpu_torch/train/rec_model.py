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

Not ported yet (each raises ``NotImplementedError``): the wire format,
``prep_placement="device"`` and ``input_recipe="auto"`` (``ROADMAP.md``
section 1 item 6).  Multi-GPU is item 10: ``rank_id`` is 0.
"""

from __future__ import annotations

import sys
from typing import Iterable

import numpy as np
import torch

from mindrec_tpu_torch.data.criteo import PrefetchToDevice, to_device
from mindrec_tpu_torch.data.pipeline import AdaptiveBucket, SparseInputPipeline
from mindrec_tpu_torch.train import optim as optim_lib
from mindrec_tpu_torch.train.callbacks import CallbackManager, RunContext
from mindrec_tpu_torch.train.metrics import AUCMetric
from mindrec_tpu_torch.train.step import (
    TrainState, init_train_state, make_eval_step, make_train_step,
    prep_groups,
)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md section 1 item 6)")


class RecModel:
    """High-level wrapper tying a model, dual optimizers, metrics and the
    train/eval step functions together.

    Args:
      model: a model object from ``mindrec_tpu_torch.models``.
      opt_w / opt_d: wide/deep optimizers; defaults: FTRL and Adam at
        the model config's loss scale.
      metrics: dict name -> Metric; default ``{"auc": AUCMetric()}``.
      seed: parameter init seed.
      jit: capture the train step in a CUDA graph on the card.
      donate: the step updates the state in place (False raises).
      unique_bucket: an int or :class:`AdaptiveBucket` bound on distinct
        ids per batch; ``train(dataset_sink_mode=True)`` then treats the
        dataset as raw host batches and runs prep pool -> staging ->
        step, growing the bucket (one new capture) on overflow.
      prep_workers: host prep threads.
      host_prep: run the pipeline without a bucket (lossless prep; the
        form for multi-id-group models, which get per-group prep).
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
        if wire is not None:
            raise _not_ported("the wire format (wire=)")
        if prep_placement == "device":
            raise _not_ported("device-side prep (prep_placement='device')")
        if input_recipe == "auto":
            raise _not_ported("the measured input recipe (input_recipe='auto')")
        del audit_every  # the device-prep audit's period
        self.model = model
        self.device = torch.device(device)
        sens = float(getattr(model.config, "loss_scale", 1.0))
        self.opt_w = opt_w or optim_lib.ftrl(loss_scale=sens)
        self.opt_d = opt_d or optim_lib.adam(loss_scale=sens)
        self.metrics = metrics if metrics is not None else {"auc": AUCMetric()}
        self.train_step = make_train_step(model, self.opt_w, self.opt_d,
                                          jit=jit, donate=donate)
        self.eval_step = make_eval_step(model)
        self.state: TrainState = init_train_state(
            model, seed, self.opt_w, self.opt_d, device=self.device)
        self.bucket_policy = None
        if unique_bucket is not None:
            self.bucket_policy = (
                unique_bucket if isinstance(unique_bucket, AdaptiveBucket)
                else AdaptiveBucket(int(unique_bucket))
            )
        self.prep_workers = prep_workers
        self.host_prep = (host_prep if host_prep is not None
                          else unique_bucket is not None)
        self.rank_id = 0

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
        ``train_step`` gets the batch untouched."""
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
        ctx = RunContext(rank_id=self.rank_id, train_state=self.state)
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
        ctx = RunContext(rank_id=self.rank_id, train_state=self.state)
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
            probs, labels = self.eval_step(
                self.state.params, self._tensors(batch) if own else batch)
            probs = probs.float().cpu().numpy()
            labels = labels.float().cpu().numpy()
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
        if not sink or not _takes_device_batches(self.train_step):
            return iter(dataset)
        on_card = self.state.step.device.type == "cuda"
        if self.host_prep:
            # raw host batches -> prep pool -> staging, with adaptive
            # re-bucketing (one id group) or per-group lossless prep
            groups = prep_groups(self.model)  # tiny groups need no sort
            return iter(SparseInputPipeline(
                dataset,
                field_size=int(getattr(self.model.config, "field_size", 0)),
                policy=self.bucket_policy if groups is None else None,
                groups=groups,
                workers=self.prep_workers,
                device=on_card,
            ))
        if on_card:
            return PrefetchToDevice(dataset, depth=2,
                                    device=self.state.step.device)
        return iter(dataset)


def _takes_device_batches(fn) -> bool:
    """A step of make_train_step / make_eval_step (RecModel stages its
    batches), not a wrapper that takes host batches."""
    return bool(getattr(fn, "takes_device_batches", False))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(it) -> None:
    """Stop a prefetch thread a loop left early."""
    close = getattr(it, "close", None)
    if close is not None:
        close()
