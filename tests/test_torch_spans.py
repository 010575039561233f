"""The program's spans (``mindrec_tpu_torch/utils/profiling.py``) on the
CPU: off, ``span`` is one shared no-op and training is what it is with
spans on, bit for bit; on, a ``torch.profiler`` trace of the eager steps
holds the host ranges of the entry point, the input pipeline and each
phase of every step formulation, nested as documented; ``TimeMonitor``'s
epoch line with and without spans.  The device marks run only on a card
(``tests/test_torch_cuda.py``)."""

import contextlib
import io
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mindrec_tpu_torch import RecModel
from mindrec_tpu_torch.data.criteo import SyntheticCriteo
from mindrec_tpu_torch.data.outbrain import SyntheticOutbrain
from mindrec_tpu_torch.models import multitable, wide_deep
from mindrec_tpu_torch.train import callbacks, optim
from mindrec_tpu_torch.train.step import (
    _state_tensors, init_train_state, make_train_step,
)
from mindrec_tpu_torch.utils import profiling

WD = dict(batch_size=64, field_size=6, vocab_size=3000, emb_dim=8,
          deep_layer_dim=(32, 16), sparse=True, loss_scale=1024.0)
MT = dict(batch_size=64, continue_field_size=4, indicator_field_size=2,
          emb128_field_size=1, emb64_single_field_size=2,
          multi_hot_sizes=(3, 4, 3, 2, 2, 3), emb_128_size=3000,
          emb64_single_size=50, emb64_multi_size=2500, indicator_size=16,
          deep_layer_dim=(32, 16), loss_scale=1000.0, sparse=True)
STEP_SPANS = {"meta", "expand", "forward", "mlp", "backward", "segsum",
              "update", "update.dense", "update.tables"}


@pytest.fixture
def spans_on():
    was = profiling.spans_enabled()
    profiling.enable_spans(True)
    try:
        yield
    finally:
        profiling.enable_spans(was)


def _wd(**kw):
    return wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**{**WD, **kw}))


def _wd_raw(n=3):
    data = SyntheticCriteo(WD["batch_size"], WD["field_size"],
                           WD["vocab_size"], seed=4)
    return [data.get_batch(i) for i in range(n)]


def _mt():
    return multitable.MultiTableWideDeepModel(
        multitable.MultiTableConfig(**MT))


def _mt_raw(n=3):
    return list(SyntheticOutbrain(multitable.MultiTableConfig(**MT), n,
                                  seed=2))


def _ranges(prof) -> dict:
    """{name: [(start us, end us, thread)]} of the trace's host events."""
    out = {}
    for e in prof.events():
        out.setdefault(e.name, []).append(
            (e.time_range.start, e.time_range.end, e.thread))
    return out


def _inside(inner, outer) -> bool:
    """Every range of ``inner`` lies inside some range of ``outer``."""
    return all(any(a0 <= a and b <= b0 for a0, b0, _t0 in outer)
               for a, b, _t in inner)


def test_spans_off_are_one_shared_noop():
    assert not profiling.spans_enabled()
    a = profiling.span("meta", torch.device("cpu"))
    assert a is profiling.span("update") is profiling.step_annotation("s", 1)
    assert isinstance(a, contextlib.nullcontext)
    x = torch.ones(3, requires_grad=True)
    y = x * 2
    profiling.backward_span("mlp", y, x)  # off: registers no hook
    assert not y._backward_hooks and not x._backward_hooks
    assert profiling.span_totals("cpu") == {}


@pytest.mark.parametrize("kind", ["wd", "multitable"])
def test_spans_leave_training_bit_identical(kind):
    """``RecModel(jit=False)`` on the CPU trains to the same state, bit
    for bit, with spans off and on."""
    model, raw = (_wd(), _wd_raw()) if kind == "wd" else (_mt(), _mt_raw())
    states = []
    for on in (False, True):
        profiling.enable_spans(on)
        try:
            rm = RecModel(model, seed=3, jit=False, device="cpu")
            rm.train(1, raw, dataset_sink_mode=False)
        finally:
            profiling.enable_spans(False)
        assert int(rm.state.step) == len(raw)
        states.append([t.clone() for t in _state_tensors(rm.state)])
    for x, y in zip(*states):
        assert torch.equal(x, y)


def test_trace_names_the_entry_point_pipeline_and_phases(spans_on):
    """One W&D epoch through ``RecModel.train`` with host prep in a worker
    thread: the entry point's spans around each step, the pipeline's on
    the prep thread and where the loop waits, every phase inside
    ``train.step`` in the step's order, ``mlp`` inside ``forward`` and the
    update's parts inside ``update``."""
    raw = _wd_raw()
    rm = RecModel(_wd(), seed=3, jit=False, device="cpu", unique_bucket=2048)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=profiling.all_threads_config()) as prof:
        rm.train(1, raw)
    r = _ranges(prof)
    for name in ("train.next_batch", "train.step", "train.callbacks",
                 "pipeline.wait", *STEP_SPANS):
        assert name in r, name
    main = r["train.step"][0][2]
    assert len(r["train.step"]) == len(raw)
    # each step's begin and end, the epoch's and the run's
    assert len(r["train.callbacks"]) == 2 * len(raw) + 4
    assert len(r["train.next_batch"]) == len(raw) + 1  # and the end
    assert _inside(r["pipeline.wait"], r["train.next_batch"])
    if profiling.all_threads_config() is not None:
        assert len(r["pipeline.prep"]) == len(raw)
        assert all(t != main for _a, _b, t in r["pipeline.prep"])
    for name in STEP_SPANS:
        assert len(r[name]) == len(raw), name
        assert _inside(r[name], r["train.step"]), name
    assert _inside(r["mlp"], r["forward"])
    assert _inside(r["update.dense"], r["update"])
    assert _inside(r["update.tables"], r["update"])
    order = ["meta", "expand", "forward", "backward", "segsum", "update"]
    for i in range(len(raw)):
        starts = [r[n][i][0] for n in order]
        ends = [r[n][i][1] for n in order]
        assert starts == sorted(starts)
        assert all(e <= s for e, s in zip(ends, starts[1:]))


@pytest.mark.parametrize("form,want", [
    ("cols", STEP_SPANS),
    ("generic", STEP_SPANS - {"expand", "segsum"}),
    ("dense", STEP_SPANS - {"meta", "expand", "segsum"}),
    ("guarded", STEP_SPANS),
])
def test_each_step_formulation_names_its_phases(spans_on, form, want):
    """The column layout, the generic path and the dense step mark the
    phases they have under the same names; the overflow guard's work is
    the update's (two ``update`` ranges a step)."""
    model = _wd(table_layout="feature_major") if form == "cols" else _wd()
    if form == "dense":
        model = _wd(sparse=False)
    opts = (optim.ftrl(loss_scale=1024.0), optim.lazy_adam(loss_scale=1024.0))
    kw = {"cols": dict(row_layout=False), "generic": dict(use_pallas=False),
          "dense": {}, "guarded": dict(check_overflow=True)}[form]
    step = make_train_step(model, *opts, **kw)
    state = init_train_state(model, 1, *opts, device="cpu")
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in _wd_raw(1)[0].items()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _losses = step(state, batch)
    r = _ranges(prof)
    assert {n for n in STEP_SPANS if n in r} == want
    assert len(r["update"]) == (2 if form == "guarded" else 1)
    assert _inside(r["mlp"], r["forward"])


def _epoch_line(monitor, steps=4) -> str:
    """One epoch of ``steps`` steps of 5 ms on a fake clock, the printed
    line."""
    clock = iter([0.0] + [x for i in range(steps)
                          for x in (0.005 * i, 0.005 * (i + 1))]
                 + [0.005 * steps])
    out = io.StringIO()
    real = time.perf_counter
    time.perf_counter = lambda: next(clock)
    try:
        with contextlib.redirect_stdout(out):
            monitor.on_train_epoch_begin(None)
            for _ in range(steps):
                monitor.on_train_step_begin(None)
                monitor.on_train_step_end(None)
            monitor.on_train_epoch_end(None)
    finally:
        time.perf_counter = real
    return out.getvalue()


def test_time_monitor_adds_the_spans_device_ms(monkeypatch):
    """With spans on and a card, the epoch line gains each span's device
    ms per step, ``between_steps`` included, from the readings at the
    epoch's two ends; with spans off it is the plain line."""
    before = {"meta": (10.0, 5), "update": (4.0, 5)}
    after = {"meta": (12.0, 9), "update": (6.0, 9), "inputs": (0.4, 4),
             "between_steps": (0.2, 8)}
    reads = []
    monkeypatch.setattr(callbacks.TimeMonitor, "_card",
                        staticmethod(lambda ctx: torch.device("cuda", 0)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(profiling, "span_totals",
                        lambda dev: reads.pop(0))
    plain = "epoch time: 20.000 ms, per step time: 5.000 ms\n"
    assert _epoch_line(callbacks.TimeMonitor()) == plain
    profiling.enable_spans(True)
    try:
        reads[:] = [before, after]
        line = _epoch_line(callbacks.TimeMonitor())
    finally:
        profiling.enable_spans(False)
    assert line == (plain[:-1] + ", device ms per step: meta 0.5000, "
                    "update 0.5000, inputs 0.1000, between_steps 0.0500\n")
    assert reads == []


def test_span_totals_per_step_arithmetic():
    before = {"a": (1.0, 2)}
    after = {"a": (3.0, 6), "b": (2.0, 4), "c": (0.5, 0)}
    assert profiling.per_step(after, before, 4) == {"a": 0.5, "b": 0.5}
    assert profiling.per_step(after, before, 0) == {}
    assert profiling.per_step({"a": (1.0, 2)}, before, 3) == {}


def test_train_criteo_profiling_leaves_spans_as_it_found_them(tmp_path,
                                                              monkeypatch):
    """``--enable_profiling`` turns the spans on for the run and back off
    after it; the trace holds the entry point's and the step's spans."""
    from mindrec_tpu_torch.examples import train_criteo

    monkeypatch.chdir(tmp_path)
    train_criteo.main([
        "--device", "cpu", "--enable_profiling", "--sparse", "1",
        "--batch_size", "32", "--vocab_size", "2000", "--emb_dim", "8",
        "--deep_layer_dim", "[16, 8]", "--epochs", "1",
        "--steps_per_epoch", "2"])
    assert not profiling.spans_enabled()
    text = (tmp_path / "profiler_data" / "trace.json").read_text()
    for name in ("train.step", "meta", "forward", "mlp", "update.tables"):
        assert f'"{name}"' in text, name
