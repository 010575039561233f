#!/usr/bin/env python3
"""A benchmark cell's train step by phase, from the program's spans, on
one card::

    python3 tools/span_phases.py --workload wd_bench.criteo --seed 7 --spans 1
    python3 tools/span_phases.py --workload mt_outbrain.lossless --seed 7 \\
        --spans 1 --trace 1

Set-up is ``portbench/run.py``'s (the cell's ring and weights from the
seed, ``RecModel(jit=True)``, staging, the first steps, warm-up and
settling), with the program's spans turned on before the step's first
capture when ``--spans 1``; then one window of ``--seconds`` (or, with
``--trace 1``, the cell's ``trace_steps`` under ``torch.profiler``).
The check against the reference is not run.  Prints one JSON line:

* ``samples_per_s`` and ``step_ms`` (the mean interval between the CUDA
  events recorded after each step), which compare spans on with off;
* ``span_ms``: each span's device ms per step over the window
  (``utils/profiling.span_totals`` after less before), ``between_steps``
  among them, and ``tiled_ms``, the top-level spans plus
  ``between_steps``, beside ``step_ms``;
* traced: the device ms per step by class, ``span`` being the marks
  (``csrc/span.cu``), the top-level spans' sum beside the busy device
  time less the marks, the ten longest idle gaps, each with the
  innermost host event at its middle, the innermost program span around
  it and where it lies in the window, and ``phases``: each device
  operation put in the innermost span open on the device when it ran
  (the marks of a step, in the order the capture made them, tell which
  span each mark opens or closes), with each span's busy ms per step and
  its five longest operations.

One step runs between set-up and the window, and the spans are read
after it: the first window step's ``between_steps`` then starts where
the window's first CUDA event does (traced, inside the profiler, so
that neither holds the profiler's start).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

TOP = ("inputs", "meta", "expand", "forward", "backward", "segsum", "update")
HOST = ("train.next_batch", "train.step", "train.callbacks",
        "captured.capture", "captured.replay", "pipeline.prep",
        "pipeline.stage", "pipeline.wait")
NESTED = ("mlp", "update.dense", "update.tables")


def _union_ms(ops) -> float:
    """Device ms covered by the (start us, end us) intervals."""
    total, end = 0.0, None
    for a, b in sorted(ops):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def _gaps(tr, names: set, n: int = 10) -> list:
    """The ``n`` longest idle gaps: [ms, innermost host event, innermost
    program span at the gap's middle, ms from the window's first device
    operation to the gap's start (negative: before it)]."""
    first = min(a for _n, _c, a, _b in tr.ops)
    out = []
    for dur, a, b in tr.gaps[:n]:
        mid = (a + b) / 2
        over = sorted((e - s, name) for s, e, name in tr.host if s <= mid <= e)
        spans = [name for _d, name in over if name in names]
        out.append([dur / 1e3, over[0][1] if over else "no host event",
                    spans[0] if spans else None, (a - first) / 1e3])
    return out


def _phases(tr, seq: list, steps: int) -> dict:
    """Each device operation's time put in the innermost span open on
    the device: ``seq`` is one step's marks as (span, enters) in device
    order.  -> {span: [busy ms per step, [[op, ms per step]] x 5]};
    ``between_steps`` holds what ran outside every span."""
    stack, k, busy, by_op = [], 0, {}, {}
    for name, _c, a, b in sorted(tr.ops, key=lambda o: o[2]):
        if "span_mark" in name:
            span, enters = seq[k % len(seq)]
            k += 1
            if enters:
                stack.append(span)
            elif stack and stack[-1] == span:
                stack.pop()
            else:
                raise RuntimeError(f"mark {k} closes {span!r}, open: {stack}")
            continue
        where = stack[-1] if stack else "between_steps"
        busy[where] = busy.get(where, 0.0) + (b - a)
        ops = by_op.setdefault(where, {})
        ops[name[:100]] = ops.get(name[:100], 0.0) + (b - a)
    if k % len(seq):
        raise RuntimeError(f"{k} marks in the window, {len(seq)} a step")
    return {w: [t / 1e3 / steps,
                [[n, v / 1e3 / steps] for n, v in
                 sorted(by_op[w].items(), key=lambda kv: -kv[1])[:5]]]
            for w, t in busy.items()}


def measure(cd: dict, seed: int, dev, spans: bool, seconds: float,
            trace: bool) -> dict:
    """One run of the cell's data ``cd`` (``portbench.harness.load_cell``)
    on ``dev``; -> the result line's object."""
    import torch

    from mindrec_tpu_torch.utils import profiling
    from portbench import harness
    from portbench.trace import WINDOW, Trace, port_kernel_names

    cuda = dev.type == "cuda"
    traffic = cd["traffic"]
    profiling.enable_spans(spans)
    captured = []  # the marks the captures put in their graphs, in order
    mark = profiling._mark

    def logged(name, device, flags):
        if torch.cuda.is_current_stream_capturing():
            captured.append((name, bool(flags & 1)))
        mark(name, device, flags)

    profiling._mark = logged
    try:
        program, staged, _raw, _readings = harness.setup(cd, seed, dev)
    finally:
        profiling._mark = mark
    setup_s = time.perf_counter() - T_START
    if cuda:
        torch.cuda.synchronize(dev)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    start = harness.CHECK_STEPS + traffic["warmup_steps"]
    ring = harness.Ring(staged, start + 1)
    win = harness.Window(seconds, traffic["trace_steps"] if trace else None,
                         cuda)

    def lead():  # one step, then the spans' reading before the window
        program.train(harness.Ring(staged, start), [harness.Stop(1)])
        return profiling.span_totals(dev)

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     experimental_config=profiling.all_threads_config()) as prof:
            before = lead()
            with record_function(WINDOW):
                win.begin()
                program.train(ring, [win])
                torch.cuda.synchronize(dev)
    else:
        before = lead()
        win.begin()
        program.train(ring, [win])
        if cuda:
            torch.cuda.synchronize(dev)
    wall = time.perf_counter() - win.t0
    after = profiling.span_totals(dev)
    steps = len(win.losses)
    step_ms = win.step_ms()
    span_ms = profiling.per_step(after, before, steps)
    out = {
        "seed": seed, "spans": int(spans), "trace": int(trace),
        "card": harness.card_line() if cuda else "cpu", "steps": steps,
        "setup_s": setup_s,
        "samples_per_s": steps * cd["config"]["batch_size"] / wall,
        "step_ms": sum(step_ms) / len(step_ms),
        "step_ms_p95": harness.p95(step_ms),
        "span_ms": span_ms,
    }
    if span_ms:
        tiled = sum(span_ms.get(k, 0.0) for k in (*TOP, "between_steps"))
        out["tiled_ms"] = tiled
        out["tiled_vs_step_pct"] = 100.0 * (tiled / out["step_ms"] - 1.0)
    if prof is not None:
        tr = Trace(prof, port_kernel_names(ROOT), steps)
        ops = [(a, b) for n, _c, a, b in tr.ops if "span_mark" not in n]
        marks = [(a, b) for n, _c, a, b in tr.ops if "span_mark" in n]
        per = {c: tr.device_ms_per_step(c) for c in ("kernels", "gemm", "glue")}
        per["span"] = _union_ms(marks) / steps if marks else None
        if marks:  # the marks are __global__ functions of csrc/ too
            per["kernels"] -= per["span"]
        busy = _union_ms(ops) / steps
        out.update(
            device_ms_per_step=per, busy_less_span_ms=busy,
            marks_per_step=len(marks) / steps,
            window_s=tr.window_s, busy_s=tr.busy_s, steps_s=tr.steps_s,
            idle_gaps=_gaps(tr, set(HOST) | set(TOP) | set(NESTED)),
            top_ops=tr.top_ops())
        if marks:  # a replay: the eager inputs marks, then the graph's
            out["phases"] = _phases(
                tr, [("inputs", True), ("inputs", False), *captured], steps)
        if span_ms:
            top = sum(span_ms.get(k, 0.0) for k in TOP)
            out["top_spans_vs_busy_pct"] = 100.0 * (top / busy - 1.0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("span_phases: no CUDA card", file=sys.stderr)
        return 2
    out = measure(harness.load_cell(args.workload), args.seed,
                  torch.device("cuda"), bool(args.spans), args.seconds,
                  bool(args.trace))
    print(json.dumps({"workload": args.workload, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
