"""Training callbacks: the run context and its lifecycle hooks.

Port of ``mindrec_tpu/train/callbacks.py`` (the same messages): per-step
loss logging with the rank id, per-epoch eval with an ``eval.log``, step
timing and fault injection.  Not ported yet: ``CheckpointCallback`` and
``ExportCallback`` (they need ``io/``, ``ROADMAP.md`` section 1 item 5),
``EvictionCallback`` (the dynamic tables, item 8) and
``TimeMonitor(speed_of_light=...)`` (its floor needs the card's
constants).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np


def _scalar(x) -> float:
    """A loss as a Python float (a tensor on any device, or numpy)."""
    return float(x.item()) if hasattr(x, "item") else float(np.asarray(x))


@dataclass
class RunContext:
    """State handed to callbacks each step/epoch."""

    epoch_num: int = 0
    cur_step_num: int = 0
    batch_num: int = 0
    net_outputs: Any = None
    train_state: Any = None
    rank_id: int = 0
    _stop: bool = field(default=False, repr=False)

    def request_stop(self):
        self._stop = True

    @property
    def stop_requested(self) -> bool:
        return self._stop


class Callback:
    def on_train_begin(self, ctx: RunContext):
        pass

    def on_train_end(self, ctx: RunContext):
        pass

    def on_train_epoch_begin(self, ctx: RunContext):
        pass

    def on_train_epoch_end(self, ctx: RunContext):
        pass

    def on_train_step_begin(self, ctx: RunContext):
        pass

    def on_train_step_end(self, ctx: RunContext):
        pass


class CallbackManager(Callback):
    def __init__(self, callbacks):
        self.callbacks = list(callbacks or [])

    def _fan(self, name, ctx):
        for cb in self.callbacks:
            getattr(cb, name)(ctx)

    def on_train_begin(self, ctx):
        self._fan("on_train_begin", ctx)

    def on_train_end(self, ctx):
        self._fan("on_train_end", ctx)

    def on_train_epoch_begin(self, ctx):
        self._fan("on_train_epoch_begin", ctx)

    def on_train_epoch_end(self, ctx):
        self._fan("on_train_epoch_end", ctx)

    def on_train_step_begin(self, ctx):
        self._fan("on_train_step_begin", ctx)

    def on_train_step_end(self, ctx):
        self._fan("on_train_step_end", ctx)


class LossCallback(Callback):
    """Print / append the per-step wide and deep losses with the rank id;
    raises on a NaN or Inf loss.  Reading a loss waits for its step."""

    def __init__(self, loss_file: Optional[str] = None, per_print_times: int = 1):
        self.loss_file = loss_file
        self.per_print_times = per_print_times

    def on_train_step_end(self, ctx: RunContext):
        if ctx.cur_step_num % self.per_print_times != 0:
            return
        out = ctx.net_outputs
        if isinstance(out, tuple) and len(out) == 2:
            loss_w, loss_d = _scalar(out[0]), _scalar(out[1])
            msg = (
                f"epoch: {ctx.epoch_num} step: {ctx.cur_step_num}, "
                f"wide_loss is {loss_w:.6f}, deep_loss is {loss_d:.6f}"
            )
            bad = not (np.isfinite(loss_w) and np.isfinite(loss_d))
        else:
            loss = _scalar(out)
            msg = f"epoch: {ctx.epoch_num} step: {ctx.cur_step_num}, loss is {loss:.6f}"
            bad = not np.isfinite(loss)
        if bad:
            raise ValueError(f"loss is NaN or Inf at step {ctx.cur_step_num}: {msg}")
        print(f"[rank {ctx.rank_id}] {msg}", flush=True)
        if self.loss_file:
            with open(self.loss_file, "a") as f:
                f.write(msg + "\n")


class EvalCallback(Callback):
    """Run eval at each epoch end and append the AUC to an eval log."""

    def __init__(self, rec_model, dataset, eval_file: Optional[str] = None):
        self.rec_model = rec_model
        self.dataset = dataset
        self.eval_file = eval_file
        self.history: list[float] = []

    def on_train_epoch_end(self, ctx: RunContext):
        metrics = self.rec_model.eval(self.dataset)
        auc = metrics.get("auc")
        self.history.append(auc)
        msg = f"epoch: {ctx.epoch_num}, auc: {auc}"
        print(msg, flush=True)
        if self.eval_file:
            with open(self.eval_file, "a") as f:
                f.write(time.strftime("%Y-%m-%d %H:%M:%S ") + msg + "\n")


class TimeMonitor(Callback):
    """Epoch and per-step timing on the host clock.  A step's time is
    its enqueue unless something in it (a callback reading the loss, a
    full prefetch queue) waits for the card.  ``speed_of_light`` is not
    ported: the reference's floor is a TPU model."""

    def __init__(self, data_size: Optional[int] = None,
                 speed_of_light=None, batch_size: Optional[int] = None):
        if speed_of_light is not None:
            raise NotImplementedError(
                "TimeMonitor(speed_of_light=...) needs a step floor with "
                "the card's constants, which is not ported yet")
        self.data_size = data_size
        self.step_times: list[float] = []
        self._epoch_t0 = None
        self._step_t0 = None
        self.batch_size = batch_size

    def on_train_epoch_begin(self, ctx):
        self._epoch_t0 = time.perf_counter()
        self.step_times = []

    def on_train_step_begin(self, ctx):
        self._step_t0 = time.perf_counter()

    def on_train_step_end(self, ctx):
        if self._step_t0 is not None:
            self.step_times.append(time.perf_counter() - self._step_t0)

    def on_train_epoch_end(self, ctx):
        dt = time.perf_counter() - self._epoch_t0
        n = len(self.step_times) or 1
        print(
            f"epoch time: {dt * 1000:.3f} ms, per step time: "
            f"{dt * 1000 / n:.3f} ms",
            flush=True,
        )


class FaultInjector(Callback):
    """Crash the trainer at a given step (the fault-injection half of the
    elastic-recovery story); ``once_marker`` crashes only on the first
    run."""

    def __init__(self, crash_at_step: int, once_marker: str | None = None):
        self.crash_at_step = crash_at_step
        self.once_marker = once_marker

    def on_train_step_end(self, ctx: RunContext):
        if ctx.cur_step_num != self.crash_at_step:
            return
        if self.once_marker:
            from pathlib import Path as _P

            marker = _P(self.once_marker)
            if marker.exists():
                return  # already crashed once; let the restart finish
            marker.touch()
        raise RuntimeError(
            f"FaultInjector: simulated crash at step {ctx.cur_step_num}"
        )
