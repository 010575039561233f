"""Profiling hooks and the sparse step's speed-of-light floor.

Port of ``mindrec_tpu/utils/profiling.py``:

* :class:`Profiler` / :func:`profile`: ``torch.profiler`` over the CPU
  and, where there is one, the CUDA device, started at construction and
  stopped at :meth:`Profiler.analyse`, which writes a Chrome trace
  (``<output_path>/trace.json``, readable by ``chrome://tracing`` and
  Perfetto);
* spans (:func:`span`, one switch :func:`enable_spans`, off by default):
  named phases of the program.  On, a span is a host range in that trace
  and, on a CUDA device, a mark at its enter and its exit
  (``csrc/span.cu``) that accumulates the phase's device time in a small
  buffer per device, read by :func:`span_totals`; the marks are nodes of
  a captured step's CUDA graph, so they time the phases inside it on
  every replay;
* :func:`step_annotation`: a span named ``<name>#<step>``;
* :func:`dump_ir`: the reference's ``save_graphs`` dump, here a listing
  of one step's operators and, on the card, the captured step's CUDA
  graph as DOT;
* :func:`sparse_step_floor`: the analytic lower bound on the sparse
  train step's time from static byte and FLOP counts, the reference's
  model with this card's constants.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from pathlib import Path

import torch

from mindrec_tpu_torch.ops.kernels import _build

# NVIDIA H100 SXM (data sheet, dense rates): HBM3 at 3.35 TB/s, 989
# TFLOP/s bf16 on the tensor cores; HBM moves whole 32-byte sectors, so a
# scattered read costs at least one sector.  A card held below its 700 W
# limit runs slower under load.
HBM_GBPS = 3350.0
MXU_TFLOPS = 989.0
SECTOR_BYTES = 32


class Profiler:
    """Start the profiler now, stop it and write the trace at
    :meth:`analyse` (the reference's ``Profiler`` shape).  It records
    every thread where this PyTorch can, so the input pipeline's spans on
    its worker threads are in the trace too."""

    def __init__(self, output_path: str = "./profiler_data"):
        self.output_path = Path(output_path)
        self.output_path.mkdir(parents=True, exist_ok=True)
        self.trace_path = self.output_path / "trace.json"
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(
            activities=acts, experimental_config=all_threads_config())
        self._prof.__enter__()
        self._started = True

    def analyse(self) -> str:
        """Stop and write the Chrome trace; returns its path."""
        if self._started:
            self._started = False
            self._prof.__exit__(None, None, None)
            self._prof.export_chrome_trace(str(self.trace_path))
        return str(self.trace_path)


@contextlib.contextmanager
def profile(output_path: str = "./profiler_data"):
    p = Profiler(output_path)
    try:
        yield p
    finally:
        p.analyse()


def all_threads_config():
    """The profiler's setting that records every thread, or None where
    this PyTorch has none (it then records the thread that started it)."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


def step_annotation(name: str, step: int):
    """A per-step span named ``<name>#<step>`` (host range only)."""
    return span(f"{name}#{step}")


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

SPAN_SLOTS = 64  # distinct span names a process can mark on the device
_HEAD = 4  # csrc/span.cu: last top-level exit, gap ns, gap count, spare
_ENTER, _TOP = 1, 4  # mark flags (an exit has no _ENTER)
_NOOP = contextlib.nullcontext()


class _Spans:
    """The switch, the slot of each span name and each device's buffer of
    ``int64[_HEAD + 3 * SPAN_SLOTS]`` (start, total ns, count per slot)."""

    def __init__(self):
        self.on = False
        self.slots: dict[str, int] = {}
        self.buffers: dict[int, torch.Tensor] = {}
        self.lock = threading.Lock()
        self.open = threading.local()  # per thread: device -> open spans


_SPANS = _Spans()


def enable_spans(on: bool = True) -> None:
    """Turn the program's spans on or off (off by default).  A step reads
    the switch when it is captured or run eagerly: a captured graph keeps
    the marks it was captured with, so turn spans on before the first
    step."""
    _SPANS.on = bool(on)


def spans_enabled() -> bool:
    return _SPANS.on


def _device_index(device: torch.device) -> int:
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def _slot(name: str) -> int:
    slot = _SPANS.slots.get(name)
    if slot is None:
        with _SPANS.lock:
            slot = _SPANS.slots.setdefault(name, len(_SPANS.slots))
        if slot >= SPAN_SLOTS:
            raise RuntimeError(f"span {name!r}: more than {SPAN_SLOTS} span "
                               f"names marked on the device")
    return slot


def _buffer(device: torch.device) -> torch.Tensor:
    """The device's mark buffer, made at the first mark on it.  That mark
    has to come before any capture (a capture's warm-up step makes it), so
    the buffer lies outside every graph's memory pool and lives for the
    process."""
    i = _device_index(device)
    buf = _SPANS.buffers.get(i)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the span buffer of cuda:{i} is made at the first mark, "
                f"which has to run outside a CUDA-graph capture (run the "
                f"step once eagerly first)")
        with _SPANS.lock:
            buf = _SPANS.buffers.get(i)
            if buf is None:
                buf = torch.zeros(_HEAD + 3 * SPAN_SLOTS, dtype=torch.int64,
                                  device=torch.device("cuda", i))
                torch.cuda.synchronize(i)
                _SPANS.buffers[i] = buf
    return buf


def _mark(name: str, device: torch.device, flags: int) -> None:
    """One ``span_mark`` launch on the current stream of ``device``."""
    buf = _buffer(device)
    fn = _build.kernel_fn("mr_span_mark", [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p])
    _build.check(fn(buf.data_ptr(), SPAN_SLOTS, _slot(name), flags,
                    _build.stream_of(buf)), "span_mark")


class _Span:
    """A span that is on: a host range, and on a CUDA device an enter and
    an exit mark.  A span opened while no other is open on the device in
    this thread is top-level: the device time between two top-level spans
    is ``between_steps``."""

    __slots__ = ("name", "device", "top", "range")

    def __init__(self, name: str, device):
        self.name = name
        dev = None if device is None else torch.device(device)
        self.device = dev if dev is not None and dev.type == "cuda" else None

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        if self.device is not None:
            depth = getattr(_SPANS.open, "depth", None)
            if depth is None:
                depth = _SPANS.open.depth = {}
            i = _device_index(self.device)
            self.top = depth.get(i, 0) == 0
            depth[i] = depth.get(i, 0) + 1
            _mark(self.name, self.device, _ENTER | (_TOP if self.top else 0))
        return self

    def __exit__(self, *exc):
        if self.device is not None:
            _mark(self.name, self.device, _TOP if self.top else 0)
            _SPANS.open.depth[_device_index(self.device)] -= 1
        self.range.__exit__(*exc)
        return False


def span(name: str, device=None):
    """A span of the program named ``name``, as a context manager.

    Off (the default): one shared no-op context; nothing is launched and
    nothing goes into a graph.  On: a ``torch.profiler.record_function``
    range, and where ``device`` is a CUDA device a mark at enter and at
    exit on its current stream (:func:`span_totals` sums their device
    time).  ``device=None``: the host range alone."""
    if not _SPANS.on:
        return _NOOP
    return _Span(name, device)


def backward_span(name: str, out: torch.Tensor, inp: torch.Tensor) -> None:
    """The backward of the work from ``inp`` to ``out`` as device time of
    span ``name``: a mark when ``out``'s gradient is ready (that backward
    starts) and one when ``inp``'s is (it has ended), from gradient hooks,
    which the autograd engine runs on its own thread on the forward's
    stream (inside a capture too).  No host range: the backward runs on
    another thread than the step.  Nothing when spans are off, off the
    card, or when either tensor takes no gradient."""
    if not (_SPANS.on and out.is_cuda and out.requires_grad
            and inp.requires_grad):
        return
    dev = out.device
    out.register_hook(lambda _g: _mark(name, dev, _ENTER))
    inp.register_hook(lambda _g: _mark(name, dev, 0))


def span_totals(device) -> dict:
    """``{name: (device ms, count)}`` of every span marked on ``device``
    since the process started, and ``between_steps``: the device time
    from one top-level span's exit to the next one's enter (between two
    steps, and where the host launches a graph between two top-level
    spans), with the number of such gaps.  Waits for the device, then
    copies the buffer to the host once; empty off the card or before the
    first mark."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    buf = _SPANS.buffers.get(_device_index(dev))
    if buf is None:
        return {}
    torch.cuda.synchronize(dev)
    v = buf.cpu().tolist()
    total = v[_HEAD + SPAN_SLOTS: _HEAD + 2 * SPAN_SLOTS]
    count = v[_HEAD + 2 * SPAN_SLOTS:]
    out = {name: (total[s] / 1e6, count[s])
           for name, s in sorted(_SPANS.slots.items(), key=lambda kv: kv[1])
           if count[s]}
    if v[2]:
        out["between_steps"] = (v[1] / 1e6, v[2])
    return out


def per_step(after: dict, before: dict, steps: int) -> dict:
    """Device ms per step of each span between two :func:`span_totals`
    readings over ``steps`` steps."""
    if steps <= 0:
        return {}
    return {name: (ms - before.get(name, (0.0, 0))[0]) / steps
            for name, (ms, n) in after.items()
            if n != before.get(name, (0.0, 0))[1]}


def _copy_args(x):
    """Tensors (inside tuples, lists, dicts) copied; the rest shared."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _copy_args(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_copy_args(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_copy_args(v) for v in x)
    return x


def _on_card(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        return any(_on_card(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_on_card(v) for v in x)
    return False


def dump_ir(fn, *example_args, path: str = "./graphs", name: str = "jit_fn",
            **example_kwargs) -> dict:
    """The port's ``save_graphs``: what one call ``fn(*example_args)``
    runs, written under ``path``; returns the file paths by kind.

    * ``ops``: ``<name>.ops.txt``, the operators and kernels of one call
      as ``torch.profiler`` counts them (calls and time of each), on
      every device;
    * ``cuda_graph`` (arguments on the card): ``<name>.cuda_graph.dot``,
      the call captured in a CUDA graph with
      ``torch.cuda.CUDAGraph.enable_debug_mode`` and written by
      ``debug_dump`` (a DOT file of the graph's kernel and copy nodes).
      The graph is built with ``keep_graph=True``: without it, PyTorch
      2.11 frees the captured graph when it instantiates it, and
      ``debug_dump`` then writes nothing.

    The calls run on copies of the arguments, so a step that updates its
    state in place leaves the caller's state as it was.  A
    :class:`~mindrec_tpu_torch.train.step.CapturedStep` is dumped through
    the step it captures (a graph is not captured inside another)."""
    from mindrec_tpu_torch.train.step import CapturedStep

    inner = fn.step if isinstance(fn, CapturedStep) else fn
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    card = _on_card((example_args, example_kwargs))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    args, kwargs = _copy_args((example_args, example_kwargs))
    with torch.profiler.profile(activities=acts) as prof:
        inner(*args, **kwargs)
        if card:
            torch.cuda.synchronize()
    ops = out / f"{name}.ops.txt"
    sort = "cuda_time_total" if card else "cpu_time_total"
    ops.write_text(prof.key_averages().table(sort_by=sort, row_limit=-1))
    files = {"ops": str(ops)}
    if card:
        args, kwargs = _copy_args((example_args, example_kwargs))
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.enable_debug_mode()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # a warm-up on the copies
            inner(*_copy_args(args), **_copy_args(kwargs))
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            inner(*args, **kwargs)
        dot = out / f"{name}.cuda_graph.dot"
        graph.debug_dump(str(dot))
        if not dot.exists() or dot.stat().st_size == 0:
            raise RuntimeError(f"CUDAGraph.debug_dump wrote nothing to {dot}")
        files["cuda_graph"] = str(dot)
        del graph
    return files


# ---------------------------------------------------------------------------
# speed-of-light floor
# ---------------------------------------------------------------------------


def _dsize(dtype_name: str) -> int:
    return 2 if "16" in str(dtype_name) else 4


def sparse_step_floor(model, batch_size: int, *, unique_bucket=None,
                      hbm_gbps: float = HBM_GBPS,
                      mxu_tflops: float = MXU_TFLOPS) -> dict:
    """Analytic LOWER BOUND on the sparse train step's time from static
    byte and FLOP counts (the reference's model):

    * the gather streams every sparse table's touched storage once and
      writes the ``[U, width]`` unique-row buffer;
    * the two order crossings move ``N`` random rows each way, at least
      one ``SECTOR_BYTES`` read per row;
    * the optimizer update reads and writes the table and two state
      arrays; per table the traffic is at least ``min(whole array,
      touched rows or columns at sector granularity)``;
    * the MLP does ``6 * B * sum(in * out)`` FLOPs (forward 2, backward
      4) at the bf16 tensor-core rate.

    Terms left out (elementwise epilogues, the segment sum, host work)
    only make the real step slower.  Returns the byte and FLOP breakdown,
    ``floor_ms`` and ``floor_samples_per_sec``.
    """
    specs = getattr(model, "table_specs", {})
    cfg = model.config
    n_positions = batch_size * int(getattr(cfg, "field_size", 0) or 0)
    u = int(unique_bucket) if unique_bucket else n_positions

    table_bytes = 0
    width = 0
    for _name, (_path, spec) in specs.items():
        rows, cols = spec.storage_shape
        dt = _dsize(getattr(spec, "dtype", "float32"))
        tb = rows * cols * dt
        if getattr(spec, "row_packed", False):
            # packed layout: at least one storage row per touched unique
            touched = min(tb, u * max(SECTOR_BYTES, cols * dt))
            width += spec.emb_dim
        else:
            # feature-major: per touched column, its bytes in sectors
            touched = min(tb, u * max(SECTOR_BYTES, rows * dt))
            width += rows
        gather = touched
        # adam/ftrl: 3 arrays read + 3 written (state at table width)
        update = 6 * touched
        table_bytes += gather + update
    lane_width = max(128, -(-width // 128) * 128)
    buf_bytes = u * lane_width * 4  # the [U, width] f32 buffer write

    # order crossings: batch -> sorted and sorted -> batch, N random rows
    # each (sector-granular reads + bf16 row writes)
    row_write = lane_width * 2
    crossing_bytes = (
        2 * n_positions * (SECTOR_BYTES + row_write) if n_positions else 0
    )

    mlp_flops = 0
    dims = getattr(model, "mlp_dims", None)
    if dims:
        mlp_flops = 6 * batch_size * sum(i * o for i, o in dims)

    hbm_bytes = table_bytes + buf_bytes + crossing_bytes
    hbm_ms = hbm_bytes / (hbm_gbps * 1e6)
    mxu_ms = mlp_flops / (mxu_tflops * 1e9)
    floor_ms = hbm_ms + mxu_ms
    return {
        "table_bytes": int(table_bytes),
        "crossing_bytes": int(crossing_bytes),
        "buffer_bytes": int(buf_bytes),
        "hbm_bytes": int(hbm_bytes),
        "mlp_flops": int(mlp_flops),
        "hbm_ms": round(hbm_ms, 3),
        "mxu_ms": round(mxu_ms, 3),
        "floor_ms": round(floor_ms, 3),
        "floor_samples_per_sec": (
            round(batch_size / (floor_ms / 1e3)) if floor_ms else None
        ),
        "hbm_gbps": hbm_gbps,
        "mxu_tflops": mxu_tflops,
    }
