"""The port's profiling hooks (``mindrec_tpu_torch/utils/profiling.py``)
and ``TimeMonitor(speed_of_light=...)`` against the JAX package's on the
CPU.

``sparse_step_floor`` is the reference's byte and FLOP model with the
card's constants; given the reference's constants (the rates as
arguments, ``SECTOR_BYTES`` patched to 512) it returns the reference's
dict exactly, for row_packed, feature-major and multi-table models.
"""

import io
import json
import time
from contextlib import redirect_stdout

import pytest
import torch

from mindrec_tpu.models import deepfm as jfm
from mindrec_tpu.models import multitable as jmt
from mindrec_tpu.models import wide_deep as jwd
from mindrec_tpu.train import callbacks as jcb
from mindrec_tpu.utils import profiling as jprof
from mindrec_tpu_torch.models import deepfm, multitable, wide_deep
from mindrec_tpu_torch.train import callbacks
from mindrec_tpu_torch.utils import profiling

CASES = {
    # the W&D bench recipe's shapes (bench.py:86-119), row_packed
    "wd": (jwd, wide_deep, "WideDeepConfig", "WideDeepModel",
           dict(batch_size=16000, field_size=39, vocab_size=5_860_000,
                emb_dim=16, deep_layer_dim=(1024,) * 7, sparse=True)),
    "wd_bf16_fm": (jwd, wide_deep, "WideDeepConfig", "WideDeepModel",
                   dict(batch_size=4096, field_size=39, vocab_size=200_000,
                        emb_dim=16, deep_layer_dim=(256, 128), sparse=True,
                        table_dtype="bfloat16",
                        table_layout="feature_major")),
    "deepfm": (jfm, deepfm, "DeepFMConfig", "DeepFMModel",
               dict(sparse=True, table_layout="feature_major")),
    "multitable": (jmt, multitable, "MultiTableConfig",
                   "MultiTableWideDeepModel", dict(sparse=True)),
}


def _pair(name):
    jmod, tmod, cfg, cls, kw = CASES[name]
    return (getattr(jmod, cls)(getattr(jmod, cfg)(**kw)),
            getattr(tmod, cls)(getattr(tmod, cfg)(**kw)))


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("bucket", [None, 100_000])
def test_floor_matches_reference_with_its_constants(name, bucket,
                                                    monkeypatch):
    jm, tm = _pair(name)
    bs = jm.config.batch_size
    want = jprof.sparse_step_floor(jm, bs, unique_bucket=bucket)
    monkeypatch.setattr(profiling, "SECTOR_BYTES", jprof.SECTOR_BYTES)
    got = profiling.sparse_step_floor(
        tm, bs, unique_bucket=bucket, hbm_gbps=jprof.HBM_GBPS,
        mxu_tflops=jprof.MXU_TFLOPS)
    assert got == want


def test_floor_uses_the_cards_constants():
    _jm, tm = _pair("wd")
    f = profiling.sparse_step_floor(tm, 16000)
    assert (f["hbm_gbps"], f["mxu_tflops"]) == (3350.0, 989.0)
    assert f["hbm_ms"] == round(f["hbm_bytes"] / 3350.0e6, 3)
    assert f["mxu_ms"] == round(f["mlp_flops"] / 989.0e9, 3)
    assert f["floor_samples_per_sec"] == pytest.approx(
        16000 / (f["floor_ms"] / 1e3), rel=1e-3)


def _epoch_line(monitor, step_s) -> str:
    """One epoch of three steps on a fake clock, the printed line."""
    clock = iter([0.0] + [x for s in step_s for x in (0.0, s)] + [sum(step_s)])
    out = io.StringIO()
    real = time.perf_counter
    time.perf_counter = lambda: next(clock)
    try:
        with redirect_stdout(out):
            monitor.on_train_epoch_begin(None)
            for _ in step_s:
                monitor.on_train_step_begin(None)
                monitor.on_train_step_end(None)
            monitor.on_train_epoch_end(None)
    finally:
        time.perf_counter = real
    return out.getvalue()


def test_time_monitor_line_matches_reference():
    """Given the same floor and step times both print the same line (the
    step times' median, which the reference rates, equals the epoch's
    time per step, which the port rates); from a model the port's floor
    is ``sparse_step_floor`` of its shapes."""
    _jm, tm = _pair("wd")
    floor = profiling.sparse_step_floor(tm, 16000)
    steps = [0.004, 0.005, 0.006]
    want = _epoch_line(jcb.TimeMonitor(speed_of_light=floor,
                                       batch_size=16000), steps)
    got = _epoch_line(callbacks.TimeMonitor(speed_of_light=floor,
                                            batch_size=16000), steps)
    assert got == want and "analytic floor" in got
    mon = callbacks.TimeMonitor(speed_of_light=tm)
    assert mon.floor == floor and mon.batch_size == 16000
    assert _epoch_line(mon, steps) == got
    plain = _epoch_line(callbacks.TimeMonitor(), steps)
    assert plain == _epoch_line(jcb.TimeMonitor(), steps)
    # uneven steps: 12 ms over 3 steps rates 4 ms per step
    uneven = _epoch_line(mon, [0.001, 0.002, 0.009])
    assert "per step time: 4.000 ms, 4,000,000 samples/s" in uneven


def test_profile_writes_a_trace_with_the_annotation(tmp_path):
    """With the program's spans on, ``step_annotation`` is a span of its
    name (off, it is the shared no-op)."""
    x = torch.randn(64, 64)
    profiling.enable_spans(True)
    try:
        with profiling.profile(str(tmp_path / "prof")) as p:
            for step in range(2):
                with profiling.step_annotation("train_step", step):
                    x = torch.tanh(x @ x)
    finally:
        profiling.enable_spans(False)
    path = p.analyse()  # a second call returns the same path
    trace = json.loads(open(path).read())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"train_step#0", "train_step#1"} <= names
    assert any("mm" in str(n) for n in names)
    assert sum(e.get("name") == "train_step#1"
               for e in trace["traceEvents"]) == 1
