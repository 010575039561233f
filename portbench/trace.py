"""Reading the profiler's trace of a traced window.

The harness wraps the traced window in a ``torch.profiler`` span named
:data:`WINDOW`; every device operation (kernel, copy, fill) inside it is
kept, clipped to the span, and put in one class:

* ``span``: the marks of the program's spans (``span_mark`` of
  ``mindrec_tpu_torch/csrc/span.cu``; a traced run turns the spans on),
  so that no other class counts them;
* ``kernels``: the port's own CUDA kernels, by the names of the
  ``__global__`` functions in ``mindrec_tpu_torch/csrc/*.cu`` (the
  program's kernel names, read at run time);
* ``gemm``: cuBLAS's matmul kernels (names holding gemm, gemv, nvjet,
  xmma, cutlass or splitKreduce);
* ``glue``: every other device operation (PyTorch's elementwise,
  gather, copy and fill kernels and copies).

``busy_s`` is the union of the operations' intervals, ``window_s`` the
span's length; the idle gaps are named by the innermost host-side event
that was running in their middle.  ``steps_s`` is the traced steps' time
on the device: from the first device operation to the last, less the
idle time while the profiler itself held the host (:data:`PROFILER_OWN`,
CUPTI fetching a trace buffer); the idle share and the MFU are taken
over it, so that neither reads the profiler's start, stop or buffers.
"""

from __future__ import annotations

import re
from pathlib import Path

WINDOW = "portbench.window"
PROFILER_OWN = frozenset({"Activity Buffer Request"})
GEMM = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|splitkreduce", re.I)
SPAN_MARK = "span_mark"  # the program's span marks: csrc/span.cu
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def port_kernel_names(root: Path) -> set[str]:
    """Names of the port's CUDA kernels (``__global__`` functions)."""
    names = set()
    for src in sorted((root / "mindrec_tpu_torch" / "csrc").glob("*.cu")):
        names.update(_GLOBAL.findall(src.read_text()))
    return names


def _matcher(kernel_names: set[str]):
    """A regex that finds any of the names in a device operation's name,
    demangled (``void name<...>(...)``) or mangled (``_Z<len><name>...``)."""
    alts = [rf"(?<![A-Za-z0-9_]){re.escape(k)}(?![A-Za-z0-9_])"
            for k in kernel_names]
    alts += [rf"_Z{len(k)}{re.escape(k)}" for k in kernel_names]
    return re.compile("|".join(alts)) if alts else re.compile(r"(?!x)x")


class Trace:
    """Device operations of one traced window, classified."""

    def __init__(self, prof, kernel_names: set[str], steps: int):
        from torch.autograd import DeviceType

        events = list(prof.events())
        port = _matcher(kernel_names)
        mark = _matcher({SPAN_MARK})
        spans = [e for e in events if e.name == WINDOW]
        if not spans:
            raise RuntimeError(f"the trace holds no {WINDOW!r} span")
        t0, t1 = spans[0].time_range.start, spans[0].time_range.end
        self.steps = steps
        self.window_s = (t1 - t0) / 1e6
        self.ops = []  # (name, class, start us, end us)
        self.host = []  # (start us, end us, name) of host-side events
        for e in events:
            a, b = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                # the profiler mirrors a host span on the device timeline
                # (a user annotation): not an operation
                if e.name == WINDOW or getattr(e, "is_user_annotation", False):
                    continue
                a, b = max(a, t0), min(b, t1)
                if b > a:
                    self.ops.append((e.name, self.classify(e.name, port, mark),
                                     a, b))
            elif e.name != WINDOW and b > t0 and a < t1:
                self.host.append((a, b, e.name))
        self.ops.sort(key=lambda o: o[2])
        merged = []
        for _n, _c, a, b in self.ops:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) / 1e6
        own = 0.0  # idle device time while the profiler held the host
        for s, e, name in self.host:
            if name in PROFILER_OWN:
                own += sum(max(0.0, min(b, e) - max(a, s)) for (_a0, a), (b, _b1)
                           in zip(merged, merged[1:]))
        self.steps_s = ((merged[-1][1] - merged[0][0] - own) / 1e6
                        if merged else 0.0)
        edges = [t0] + [x for ab in merged for x in ab] + [t1]
        self.gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                            for i in range(0, len(edges), 2)
                            if edges[i + 1] > edges[i]), reverse=True)

    @staticmethod
    def classify(name: str, port, mark) -> str:
        if mark.search(name):
            return "span"
        if port.search(name):
            return "kernels"
        if GEMM.search(name):
            return "gemm"
        return "glue"

    def device_ms_per_step(self, cls: str) -> float | None:
        """Device ms per traced step in one class; None when the class
        ran nothing."""
        got = [b - a for _n, c, a, b in self.ops if c == cls]
        if not got or not self.steps:
            return None
        return sum(got) / 1e3 / self.steps

    def summary(self) -> str:
        """One line: device ms per step by class, and the port's kernels
        seen."""
        seen = sorted({n[:60] for n, c, _a, _b in self.ops if c == "kernels"})
        per = {c: self.device_ms_per_step(c) for c in ("kernels", "gemm",
                                                       "glue", "span")}
        return (f"trace: {self.steps} steps, {len(self.ops)} device ops, "
                f"window {self.window_s:.6f} s, steps {self.steps_s:.6f} s, "
                f"busy {self.busy_s:.6f} s, "
                f"ms per step {per}; port kernels seen: {seen}")

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time
        in the window, summed by name."""
        by = {}
        for name, _c, a, b in self.ops:
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[[name, seconds]] of the longest idle gaps, each named by the
        innermost host-side event running at its middle."""
        out = []
        for dur, a, b in self.gaps[:n]:
            mid = (a + b) / 2
            over = [(e - s, name) for s, e, name in self.host if s <= mid <= e]
            out.append([min(over)[1] if over else "no host event", dur / 1e6])
        return out
