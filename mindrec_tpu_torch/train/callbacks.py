"""Training callbacks: the run context and its lifecycle hooks.

Port of ``mindrec_tpu/train/callbacks.py`` (the same messages): per-step
loss logging with the rank id, per-epoch eval with an ``eval.log``, step
timing with the step's speed-of-light floor, interval checkpoints with
``keep_max`` retention, periodic serving exports, fault injection and
periodic feature eviction with an incremental export of the dynamic
tables.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from mindrec_tpu_torch.utils import profiling


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
    # on a mesh: the state's placement tree (parallel/mesh.py), for
    # sliced checkpoints
    shardings: Any = None
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
        with profiling.span("train.callbacks"):
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
    """Print / append the per-step wide and deep losses with the rank id
    (rank 0 only: on a mesh every rank's losses are the global batch's);
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
        if ctx.rank_id != 0:
            return
        print(f"[rank {ctx.rank_id}] {msg}", flush=True)
        if self.loss_file:
            with open(self.loss_file, "a") as f:
                f.write(msg + "\n")


class EvalCallback(Callback):
    """Run eval at each epoch end (every rank: eval gathers over the
    mesh) and append the AUC to an eval log (rank 0)."""

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
        if ctx.rank_id != 0:
            return
        print(msg, flush=True)
        if self.eval_file:
            with open(self.eval_file, "a") as f:
                f.write(time.strftime("%Y-%m-%d %H:%M:%S ") + msg + "\n")


class TimeMonitor(Callback):
    """Epoch and per-step timing on the host clock.  A step's time is
    its enqueue unless something in it (a callback reading the loss, a
    full prefetch queue) waits for the card; the epoch's end waits for
    the card, so the epoch time holds every step's device work.

    ``speed_of_light``: a model (its floor is derived from its static
    shapes at ``batch_size``, default its config's) or a precomputed
    :func:`~mindrec_tpu_torch.utils.profiling.sparse_step_floor` dict;
    each epoch line then also reports samples/s as a share of that
    analytic floor, in the reference's words.  The rate is the epoch's
    time per step, where the reference takes the median step time: on
    the card a step's host time is its enqueue, which can be shorter
    than the floor itself.

    With the program's spans on (``utils/profiling.enable_spans``) on a
    CUDA state, the line also gives each span's device ms per step over
    the epoch, ``between_steps`` among them, from two
    :func:`~mindrec_tpu_torch.utils.profiling.span_totals` readings (one
    at each end of the epoch)."""

    def __init__(self, data_size: Optional[int] = None,
                 speed_of_light=None, batch_size: Optional[int] = None):
        self.data_size = data_size
        self.step_times: list[float] = []
        self._epoch_t0 = None
        self._step_t0 = None
        self._spans0 = None
        self.batch_size = batch_size
        self.floor = None
        if speed_of_light is not None:
            if isinstance(speed_of_light, dict):
                self.floor = speed_of_light
            else:  # a model: the floor of its static shapes
                bs = batch_size or speed_of_light.config.batch_size
                self.batch_size = bs
                self.floor = profiling.sparse_step_floor(speed_of_light, bs)

    @staticmethod
    def _card(ctx):
        """The CUDA device of the context's state, or None."""
        step = getattr(getattr(ctx, "train_state", None), "step", None)
        if isinstance(step, torch.Tensor) and step.device.type == "cuda":
            return step.device
        return None

    def on_train_epoch_begin(self, ctx):
        card = self._card(ctx)
        self._spans0 = (profiling.span_totals(card)
                        if card is not None and profiling.spans_enabled()
                        else None)
        self._epoch_t0 = time.perf_counter()
        self.step_times = []

    def on_train_step_begin(self, ctx):
        self._step_t0 = time.perf_counter()

    def on_train_step_end(self, ctx):
        if self._step_t0 is not None:
            self.step_times.append(time.perf_counter() - self._step_t0)

    def on_train_epoch_end(self, ctx):
        card = self._card(ctx)
        if card is not None:
            torch.cuda.synchronize(card)
        dt = time.perf_counter() - self._epoch_t0
        n = len(self.step_times) or 1
        line = (
            f"epoch time: {dt * 1000:.3f} ms, per step time: "
            f"{dt * 1000 / n:.3f} ms"
        )
        if self.floor and self.batch_size and self.step_times:
            per_step = dt / n
            sps = self.batch_size / per_step
            pct = 100.0 * (self.floor["floor_ms"] / 1e3) / per_step
            line += (
                f", {sps:,.0f} samples/s = {pct:.0f}% of the "
                f"{self.floor['floor_samples_per_sec']:,}/s analytic "
                f"floor (hbm {self.floor['hbm_ms']} ms + mxu "
                f"{self.floor['mxu_ms']} ms)"
            )
        if self._spans0 is not None and card is not None:
            spans = profiling.per_step(profiling.span_totals(card),
                                       self._spans0, len(self.step_times))
            if spans:
                line += ", device ms per step: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in spans.items())
        if getattr(ctx, "rank_id", 0) == 0:  # callers may pass no context
            print(line, flush=True)


def _global_step(ctx: RunContext) -> int:
    """The state's optimizer step (one host read), which survives a
    restart; the run-local count for a state without one."""
    try:
        return int(ctx.train_state.step)
    except (AttributeError, TypeError):
        return ctx.cur_step_num


class CheckpointCallback(Callback):
    """Save every ``save_steps`` steps, keep at most ``keep_max`` files,
    numbered by the global step, so a resumed run's saves sort after the
    earlier ones.  ``async_save=True`` snapshots the state to host memory
    before the next step and writes the file on a background thread
    (``io/checkpoint.py:AsyncCheckpointer``); the callback can be used
    again in later ``train`` / ``online_train`` calls.  Resume with
    ``rm.state = restore_checkpoint(path, rm.state)``.  On a mesh (the
    context's ``shardings``) each rank saves its sliced file
    ``-r<rank>``; resume with ``restore_checkpoint(every rank's file,
    rm.state, shardings=rm.shardings)``."""

    def __init__(self, directory: str, prefix: str = "ckpt",
                 save_steps: int = 100, keep_max: int = 5,
                 async_save: bool = False):
        self.directory = directory
        self.prefix = prefix
        self.save_steps = save_steps
        self.keep_max = keep_max
        self.async_save = async_save
        self.saved: list[str] = []
        self._async = None

    def on_train_step_end(self, ctx: RunContext):
        if ctx.cur_step_num % self.save_steps != 0:
            return
        from mindrec_tpu_torch.io import checkpoint

        kw = dict(step=_global_step(ctx), prefix=self.prefix,
                  keep_max=self.keep_max, process_index=ctx.rank_id)
        if ctx.shardings is not None:
            kw.update(force_sliced=True, shardings=ctx.shardings)
        if not self.async_save:
            self.saved.append(checkpoint.save_checkpoint(
                self.directory, ctx.train_state, **kw))
            return
        if self._async is None or self._async.closed:
            self._async = checkpoint.AsyncCheckpointer()
        fut = self._async.save(self.directory, ctx.train_state, **kw)
        # .saved holds paths only, appended once each file has landed
        fut.add_done_callback(
            lambda f: self.saved.append(f.result())
            if f.exception() is None else None)

    def on_train_end(self, ctx: RunContext):
        if self._async is not None:
            self._async.close()


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


class ExportCallback(Callback):
    """Export the serving artifacts every ``export_steps`` steps (online
    training ends in a serving side that reloads the freshest model):
    ``<dir>/<prefix>-<global_step>.mrec`` and its ``.npz`` sidecar
    (``io/export.py``), plus ``.onnx`` when ``onnx_model`` is given
    (``io/onnx.py``).  Keeps the newest ``keep_max`` exports and a
    ``<prefix>-latest`` symlink, swapped atomically, for pollers.

    ``model`` gives the tables' storage specs for MREC1 (default:
    ``onnx_model``); one of the two is required."""

    def __init__(self, directory: str, model_kind: str,
                 export_steps: int = 100, prefix: str = "model",
                 keep_max: int = 5, onnx_model=None, model=None):
        from pathlib import Path as _P

        self.model = model if model is not None else onnx_model
        if self.model is None:
            raise ValueError("ExportCallback needs model= (or onnx_model=) "
                             "for the tables' storage specs")
        self.directory = _P(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.model_kind = model_kind
        self.export_steps = export_steps
        self.prefix = prefix
        self.keep_max = keep_max
        self.onnx_model = onnx_model
        self.exported: list[str] = []

    def on_train_step_end(self, ctx: RunContext):
        if ctx.cur_step_num % self.export_steps != 0:
            return
        import os

        from mindrec_tpu_torch.io.export import export_model

        params = ctx.train_state.params
        path = self.directory / f"{self.prefix}-{_global_step(ctx):010d}.mrec"
        export_model(path, self.model_kind, params, self.model)
        if self.onnx_model is not None:
            from mindrec_tpu_torch.io.onnx import export_onnx

            export_onnx(path.with_suffix(".onnx"), self.model_kind,
                        self.onnx_model, params)
        self.exported.append(str(path))
        # atomic latest pointer for serving-side pollers
        link = self.directory / f"{self.prefix}-latest"
        tmp = self.directory / f".{self.prefix}-latest.tmp"
        try:
            if tmp.exists() or tmp.is_symlink():
                tmp.unlink()
            tmp.symlink_to(path.name)
            os.replace(tmp, link)
        except OSError:
            pass  # filesystems without symlinks: pollers sort by name
        while len(self.exported) > self.keep_max:
            old = self.exported.pop(0)  # ".../<prefix>-<step>.mrec"
            for victim in (old, old + ".npz", old[: -len(".mrec")] + ".onnx"):
                try:
                    os.unlink(victim)
                except FileNotFoundError:
                    pass


class EvictionCallback(Callback):
    """Periodic feature eviction (and an optional incremental hash-table
    export) for dynamic-embedding online training.

    Every ``every_steps`` steps it

    1. calls ``adapter.evict``: expired keys leave the hash store, their
       table rows re-initialise and their optimizer state zeroes, in
       place (``train/dynamic.py``); the state goes back through
       ``ctx.train_state``;
    2. with ``export_path``, reads the admitted keys and their rows to the
       host (``adapter.export_tables``) and writes them to
       ``export_path`` as ``.npz``, atomically (a temporary file, then
       ``os.replace``): the artifact a serving process loads with
       ``adapter.import_tables``.  With ``async_export`` the write runs
       on one worker thread, so a slow disk holds back the next export,
       not every step; write errors surface in order."""

    def __init__(self, adapter, tables, every_steps: int = 100,
                 export_path=None, async_export: bool = True):
        if int(every_steps) < 1:
            raise ValueError(f"every_steps must be >= 1, got {every_steps}")
        self.adapter = adapter
        self.tables = tables
        self.every = int(every_steps)
        self.export_path = export_path
        self.evicted_total = 0
        self.exports = 0
        self._pool = None
        self._pending = None
        if export_path is not None and async_export:
            import concurrent.futures

            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="mrec-evict-export")

    def _write(self, blob):
        import os

        tmp = str(self.export_path) + ".tmp.npz"
        np.savez(tmp, **blob)
        os.replace(tmp, self.export_path)

    def on_train_step_end(self, ctx: RunContext):
        if ctx.cur_step_num % self.every != 0:
            return
        state, n = self.adapter.evict(ctx.train_state, self.tables)
        self.evicted_total += int(n)
        ctx.train_state = state
        if self.export_path is None:
            return
        blob = self.adapter.export_tables(state.params, self.tables)
        if self._pool is not None:
            if self._pending is not None:
                self._pending.result()  # surface write errors in order
            self._pending = self._pool.submit(self._write, blob)
        else:
            self._write(blob)
        self.exports += 1

    def on_train_end(self, ctx: RunContext):
        if self._pending is not None:
            self._pending.result()
            self._pending = None
