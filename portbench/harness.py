"""One run of one cell: set-up, the measured window, the check.

A cell of ``BENCHMARK.json`` names a configuration
(``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<traffic>.json``).  Each is found by name, with
what it names in turn:

* the configuration's ``model`` names its plain reference
  ``portbench/reference/<model>.py`` (``leaves``, ``TABLES``,
  ``Reference``, and where the model needs them ``init_std`` for its
  initial weights and ``matmul_flops_per_step`` for its MFU), its plan
  of kernel calls ``portbench/yardstick/steps/<model>.py`` and its small
  CPU cut ``portbench/tests/small/<model>.json``; its ``program`` names
  the port's classes; each side of its ``optimizers`` names a kind,
  ``portbench/optimizers/<kind>.py``;
* the traffic's ``generator`` names ``portbench/sources/<generator>.py``;
* the cell's limits are ``portbench/limits/<workload>.json``, and each
  per-layer metric is read by ``portbench/metrics/<metric>.py``.

A metric named ``<base>.<suffix>`` (the same quantity, split by the
cells that report it, with a bound or an end-to-end metric of their
own) is measured or read as ``<base>``.  So a new one-card cell, mix,
generator, model, optimizer or per-layer metric is new files and
entries, not an edit.  What still takes an edit: a new end-to-end
quantity (:func:`end_to_end`), a new number of the check
(``portbench/checks.py``), a cell on more than one card (a run drives
one process on one card), and a model whose parameter keys do not start
with ``wide/`` or ``deep/`` (the side that picks a leaf's optimizer).

In order, a run:

1. draws the ring of raw batches from ``--seed`` with the frozen
   generators (``portbench/sources/``), and the initial weights on the
   device from the same seed;
2. builds the program (``RecModel(jit=True)`` of the recipe) with those
   weights, and preps and stages the ring through the program's input
   pipeline (a single id group at the traffic's fixed unique bucket,
   so every seed captures the same shapes);
3. drives the program's entry point, ``RecModel.train(1, ring,
   dataset_sink_mode=False)``, through its first three steps (the first
   captures the step in a CUDA graph), reading its state after steps 1
   and 3 for the check (``portbench/checks.py``), then through the
   traffic's warm-up steps, and on until the traffic's ``settle_s``
   seconds have passed since the first three steps (the card's step
   time settles a while after a process starts; see :class:`Until`):
   set-up ends there (``setup_s``);
4. the window: the same object trains on, cycling the staged ring,
   until ``--seconds`` have passed on the host clock (``--trace 0``) or
   for the traffic's ``trace_steps`` under ``torch.profiler`` (``--trace
   1``, with the program's spans on since set-up, read after one lead
   step under the profiler and after the window); a callback records a
   CUDA event after each step and never waits for the card; the window
   ends with ``torch.cuda.synchronize()``;
5. reads the memory peak, frees the program, runs the plain reference
   over the same three batches from the same weights, and compares.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from portbench import checks
from portbench.optimizers import optimizer
from portbench.program import Callback, Program, span_ms_per_step
from portbench.sources import make_source
from portbench.trace import WINDOW, Trace, port_kernel_names
from portbench.weights import make_weights, model_module, table_keys
from portbench.yardstick.flops import matmul_flops_per_step
from portbench.yardstick.kernel_bytes import step_bound_ms

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "mindrec_tpu")
CHECK_STEPS = 3


def load_cell(workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic, limits and metrics."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    here = root / "portbench"
    return {
        "cell": cell,
        "config": config,
        "traffic": json.loads(
            (here / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads(
            (here / "limits" / f"{workload}.json").read_text())["limits"],
        "end_to_end": [m for m in bench["end_to_end"]
                       if workload in m.get("workloads", [workload])],
        "per_layer": [m for m in bench["per_layer"]
                      if workload in m.get("workloads", [workload])],
    }


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (names compared whole: ``mindrec_tpu_torch`` is not
    ``mindrec_tpu``)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


class Ring:
    """The staged batches, cycled from ``start`` without end; ``used``
    lists each step's ring index."""

    def __init__(self, staged: list, start: int = 0):
        self.staged, self.start, self.used = staged, start, []

    def __iter__(self):
        i = self.start
        while True:
            self.used.append(i % len(self.staged))
            yield self.staged[i % len(self.staged)]
            i += 1


class Stop(Callback):
    """Stops training after ``steps`` steps."""

    def __init__(self, steps: int):
        self.steps, self.losses = steps, []

    def on_train_step_end(self, ctx):
        self.losses.append(ctx.net_outputs[1])
        if len(self.losses) >= self.steps:
            ctx.request_stop()


class FirstSteps(Stop):
    """The check's readings of the program's first three steps: each
    step's loss; after step 1 each leaf's first gradient from its
    weight and optimizer state; after step 3 each leaf's change and each
    table's moved rows."""

    def __init__(self, program):
        super().__init__(CHECK_STEPS)
        self.p = program
        self.x0 = {k: v.clone() for k, v in program.leaves().items()}
        self.readings = {"loss": [], "grad": {}, "change": {}, "moved": {},
                         "table_grads": {}}

    def on_train_step_end(self, ctx):
        super().on_train_step_end(ctx)
        n, p, r = len(self.losses), self.p, self.readings
        r["loss"].append(float(ctx.net_outputs[1]))
        if n == 1:
            deep = set(checks.deep_tables(
                {k: p.logical(k, self.x0[k]) for k in table_keys(p.config)}))
            now = p.leaves()
            for k in self.x0:
                g = checks.grad_from_state(p.opt_hyper(k), self.x0[k], now[k],
                                           p.opt_state(k))
                r["grad"][k] = checks.norm(g)
                if k in deep:  # kept on the host until the reference ran
                    r["table_grads"][k] = p.logical(k, g).cpu()
        if n == CHECK_STEPS:
            specs_keys = set(table_keys(p.config))
            for k, leaf in p.leaves().items():
                r["change"][k] = checks.norm(leaf.float() - self.x0[k].float())
                if k not in specs_keys:
                    continue
                h = p.opt_hyper(k)
                inits = optimizer(h).state_inits(h)
                state = p.opt_state(k)
                st = {n_: p.logical(k, state[n_]) for n_ in inits}
                r["moved"][k] = checks.moved_rows(
                    p.logical(k, leaf), p.logical(k, self.x0[k]), st, inits)
            self.x0 = None


class Until(Callback):
    """Stops training at the first step end after ``deadline`` on the
    host clock: the settling steps of set-up.  On an H100 the W&D step
    runs about 6% slower (4.70 against 4.44 ms) for 5-20 s after a
    process's first steps, and steadily faster after, whether the card
    was busy or idle meanwhile."""

    def __init__(self, deadline: float):
        self.deadline = deadline

    def on_train_step_end(self, ctx):
        if time.perf_counter() >= self.deadline:
            ctx.request_stop()


class Window(Stop):
    """The measured steps: a CUDA event after each (on the card) or the
    host clock (on the CPU), the loss tensors kept; stops once
    ``seconds`` have passed on the host clock or after ``steps``."""

    def __init__(self, seconds: float, steps: int | None, cuda: bool):
        super().__init__(steps or sys.maxsize)
        self.seconds, self.cuda = seconds, cuda
        self.marks = []

    def begin(self):
        self.t0 = time.perf_counter()
        self.marks.append(self._mark())

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def on_train_step_end(self, ctx):
        self.marks.append(self._mark())
        super().on_train_step_end(ctx)
        if time.perf_counter() - self.t0 >= self.seconds:
            ctx.request_stop()

    def step_ms(self) -> list[float]:
        if not self.cuda:
            return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]
        return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]


class TracedRun:
    """What a per-layer metric reads (``portbench/metrics/``): the trace,
    the program's counter of captures, the kernels' bounds over the
    traced steps, the matmul operations of a step, and the program's
    spans, ``{span: device ms per step}`` over the traced steps."""

    def __init__(self, trace, captures, bound_ms, flops_per_step,
                 spans: dict):
        self.trace = trace
        self.captures = captures
        self.bound_ms = bound_ms
        self.flops_per_step = flops_per_step
        self.spans = spans


def p95(values: list[float]) -> float:
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def card_line() -> str:
    """The card's name and power limit, and the versions, for the log."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi failed: {e}"
    return (f"card {smi}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}")


def base_name(name: str) -> str:
    """The quantity a metric's name measures: the part before its first
    dot (``step_ms_p95.mt`` is ``step_ms_p95`` in the cells it lists)."""
    return name.split(".")[0]


def _reader(name: str):
    return importlib.import_module(
        f"portbench.metrics.{base_name(name)}").read


def setup(cd: dict, seed: int, dev, tamper=None, warmup: bool = True,
          spans: bool = False):
    """Set-up of one run: the ring drawn from ``seed``, the program built
    with the seed's weights (``spans``: with the program's spans on), the
    ring staged, the first three steps read for the check, the warm-up
    steps.  -> (program, staged ring, raw ring, the check's readings of
    the program)."""
    config, traffic = cd["config"], cd["traffic"]
    marks = [("start", time.perf_counter())]

    def mark(what):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        marks.append((what, time.perf_counter()))

    raw = [make_source(config, traffic, seed).get_batch(i)
           for i in range(traffic["ring"])]
    mark("traffic")
    program = Program(config, make_weights(config, seed, dev), dev, spans)
    if tamper is not None:
        tamper(program)
    mark("program")
    staged = program.stage(raw, traffic["unique_bucket"])
    mark("staging")
    first = FirstSteps(program)
    program.train(Ring(staged), [first])
    mark("first_steps")
    if warmup:
        settled_at = marks[-1][1] + float(traffic.get("settle_s", 0))
        program.train(Ring(staged, CHECK_STEPS),
                      [Stop(traffic["warmup_steps"])])
        mark("warmup")
        if time.perf_counter() < settled_at:
            program.train(Ring(staged, CHECK_STEPS + traffic["warmup_steps"]),
                          [Until(settled_at)])
            mark("settle")
    program.setup_phases = {b[0]: round(b[1] - a[1], 3)
                            for a, b in zip(marks, marks[1:])}
    return program, staged, raw, first.readings


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda", tamper=None,
             root: Path = ROOT, cell_data: dict | None = None) -> tuple[dict, list]:
    """One run; -> (the result line's object, the check's lines).
    ``tamper(program)``, for the harness's own tests, breaks the timed
    path underneath after the program is built; ``cell_data`` replaces
    the cell's files (the tests' small sizes)."""
    cd = cell_data or load_cell(workload, root)
    config, traffic, limits = cd["config"], cd["traffic"], cd["limits"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    spans = trace and cuda
    before_setup = time.perf_counter() - t_start  # imports, CUDA, the card
    program, staged, raw, readings = setup(cd, seed, dev, tamper,
                                           spans=spans)
    bounds = [step_bound_ms(config, b) for b in staged] if trace and cuda else []
    phases = {"start": round(before_setup, 3), **program.setup_phases}
    if cuda:
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()  # the check's set-up copies are gone
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    first = CHECK_STEPS + traffic["warmup_steps"]
    ring = Ring(staged, first + int(spans))  # the lead step takes ``first``
    win = Window(seconds, traffic["trace_steps"] if trace else None, cuda)
    spans0, prof = {}, None
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # one step under the profiler before the spans' first reading,
            # so that no span holds the profiler's start (as
            # tools/span_phases.py reads them)
            program.train(Ring(staged, first), [Stop(1)])
            spans0 = program.span_totals()
            captures0 = getattr(program.step, "captures", 0)
            with record_function(WINDOW):
                win.begin()
                program.train(ring, [win])
                torch.cuda.synchronize(dev)
    else:
        captures0 = getattr(program.step, "captures", 0)
        if cuda:
            torch.cuda.synchronize(dev)
        win.begin()
        program.train(ring, [win])
        if cuda:
            torch.cuda.synchronize(dev)
    wall = time.perf_counter() - win.t0
    steps = len(win.losses)
    captures = getattr(program.step, "captures", 0) - captures0
    span_ms = (span_ms_per_step(program.span_totals(), spans0, steps)
               if spans else {})
    losses = torch.stack([x.float() for x in win.losses]).cpu()
    failed = int((~torch.isfinite(losses)).sum())
    step_ms = win.step_ms()
    # reserved, not allocated: the captured graph's private pool holds
    # the step's activations outside the allocated count
    peak = torch.cuda.max_memory_reserved(dev) if cuda else 0
    used = ring.used[:steps]
    del program, staged, ring, win
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    metrics, breakdown, dev_extra = {}, None, {}
    lines = [f"setup phases (s): {phases}; window {wall:.3f} s, {steps} steps"]
    if not trace:
        values = end_to_end(steps, config["batch_size"], wall, step_ms,
                            setup_s)
        metrics = {m["name"]: {"value": values[base_name(m["name"])],
                               "unit": m["unit"]}
                   for m in cd["end_to_end"]}
    elif cuda:
        tr = Trace(prof, port_kernel_names(root), steps)
        del prof
        lines.append(tr.summary())
        run = TracedRun(tr, captures, sum(bounds[i] for i in used),
                        matmul_flops_per_step(config), span_ms)
        for m in cd["per_layer"]:
            value = _reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        dev_extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}

    numbers = checks.compare(readings, reference(config, seed, dev, raw))
    correct = checks.verdict(numbers, limits)
    lines += [f"check {k} {numbers[k][0]!r} limit {limits.get(k)!r} "
              f"({numbers[k][1]})" for k in checks.NUMBERS]
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
        **dev_extra,
    }
    result = result_line(correct, steps, failed, metrics, device_info,
                         breakdown, {k: (numbers[k][0], limits.get(k))
                                     for k in checks.NUMBERS})
    return result, lines


def end_to_end(steps: int, batch_size: int, wall: float,
               step_ms: list[float], setup_s: float) -> dict:
    """{quantity: value} of every end-to-end quantity the harness
    measures; a metric of ``BENCHMARK.json`` takes the one of its base
    name."""
    return {"train_samples_per_s": steps * batch_size / wall,
            "step_ms_p95": p95(step_ms), "setup_s": setup_s}


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, breakdown: dict | None, compared: dict) -> dict:
    """The last line's object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, ``breakdown`` in a traced run, and last
    ``checks``, each number the check compared beside its limit."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": _num(v), "limit": lim}
                     for k, (v, lim) in compared.items()}
    return out


def _num(x):
    return x if isinstance(x, int) or math.isfinite(x) else str(x)


def reference(config: dict, seed: int, dev, raw: list, precision="float32",
              half_batch=False, frozen=False) -> dict:
    """The plain reference's readings over the ring's first three raw
    batches, from the weights drawn again from ``seed``; ``frozen`` (a
    planted fault) leaves the state unchanged at every step."""
    weights = make_weights(config, seed, dev)
    trainer = model_module(config).Reference(
        config, weights, precision=precision, half_batch=half_batch)
    trainer.frozen = frozen
    out = checks.reference_readings(trainer, weights, raw[:CHECK_STEPS])
    del trainer, weights
    return out
