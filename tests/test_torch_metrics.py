"""The port's metrics and callbacks against the JAX package's: AUC with
ties and random scores, ``AUCMetric``, ``GroupedMapMetric``, and the
messages of ``LossCallback``, ``EvalCallback`` and ``TimeMonitor``."""

import numpy as np
import pytest
import torch

from mindrec_tpu.train import callbacks as jcb
from mindrec_tpu.train import metrics as jmetrics
from mindrec_tpu_torch.train import callbacks as tcb
from mindrec_tpu_torch.train import metrics as tmetrics


@pytest.mark.parametrize("case", ["random", "ties", "all_tied", "levels"])
def test_roc_auc_matches_reference(case):
    rng = np.random.default_rng(0)
    labels = (rng.uniform(size=3000) > 0.6).astype(np.float32)
    if case == "random":
        scores = rng.uniform(size=3000).astype(np.float32)
    elif case == "ties":  # runs of equal scores, labels mixed inside them
        scores = np.round(rng.uniform(size=3000), 2).astype(np.float32)
    elif case == "all_tied":
        scores = np.full(3000, 0.5, np.float32)
    else:  # a few levels, the midranks over long runs
        scores = rng.integers(0, 4, size=3000).astype(np.float64) / 3
    got = tmetrics.roc_auc(labels, scores)
    assert got == jmetrics.roc_auc(labels, scores)
    if case == "all_tied":
        assert got == 0.5
    with pytest.raises(ValueError):
        tmetrics.roc_auc(np.ones(4), np.arange(4.0))


def test_auc_metric_matches_reference():
    rng = np.random.default_rng(1)
    t, j = tmetrics.AUCMetric(), jmetrics.AUCMetric()
    with pytest.raises(RuntimeError):
        t.eval()
    for _ in range(4):
        p = np.round(rng.uniform(size=(64, 1)), 3).astype(np.float32)
        y = (rng.uniform(size=(64, 1)) > 0.5).astype(np.float32)
        t.update(p, y)
        j.update(p, y)
    assert t.eval() == j.eval()
    t.clear()
    with pytest.raises(RuntimeError):
        t.eval()


def test_grouped_map_matches_reference():
    rng = np.random.default_rng(2)
    t, j = tmetrics.GroupedMapMetric(k=12), jmetrics.GroupedMapMetric(k=12)
    assert t.needs == j.needs == ("display_id",)
    for _ in range(3):
        n = 400
        p = np.round(rng.uniform(size=n), 2).astype(np.float32)
        y = (rng.uniform(size=n) > 0.8).astype(np.float32)
        g = rng.integers(0, 40, size=n).astype(np.int32)
        t.update(p, y, g)
        j.update(p, y, g)
    assert t.eval() == j.eval()


def _ctx(mod, **kw):
    return mod.RunContext(epoch_num=2, cur_step_num=6, rank_id=0, **kw)


def test_loss_callback_messages_match_reference(capsys, tmp_path):
    out = (torch.tensor(0.125), torch.tensor(0.5))
    tcb.LossCallback(loss_file=str(tmp_path / "t.log")).on_train_step_end(
        _ctx(tcb, net_outputs=out))
    mine = capsys.readouterr().out
    jcb.LossCallback(loss_file=str(tmp_path / "j.log")).on_train_step_end(
        _ctx(jcb, net_outputs=(np.float32(0.125), np.float32(0.5))))
    assert mine == capsys.readouterr().out
    assert (tmp_path / "t.log").read_text() == (tmp_path / "j.log").read_text()
    tcb.LossCallback().on_train_step_end(_ctx(tcb, net_outputs=torch.tensor(0.25)))
    jcb.LossCallback().on_train_step_end(_ctx(jcb, net_outputs=np.float32(0.25)))
    a, b = capsys.readouterr().out.splitlines()
    assert a == b
    for mod, bad in ((tcb, (torch.tensor(0.1), torch.tensor(float("nan")))),
                     (jcb, (np.float32(0.1), np.float32(np.inf)))):
        with pytest.raises(ValueError, match="loss is NaN or Inf at step 6"):
            mod.LossCallback().on_train_step_end(_ctx(mod, net_outputs=bad))


def test_eval_and_time_callbacks_match_reference(capsys, monkeypatch):
    class Fake:
        def eval(self, dataset):
            return {"auc": 0.75}

    for mod in (tcb, jcb):
        mod.EvalCallback(Fake(), []).on_train_epoch_end(_ctx(mod))
    a, b = capsys.readouterr().out.splitlines()
    assert a == b == "epoch: 2, auc: 0.75"
    outs = []
    for mod in (tcb, jcb):
        ticks = iter([0.0, 0.001, 0.003, 0.010])
        monkeypatch.setattr(mod.time, "perf_counter", lambda t=ticks: next(t))
        tm = mod.TimeMonitor()
        ctx = _ctx(mod)
        tm.on_train_epoch_begin(ctx)
        tm.on_train_step_begin(ctx)
        tm.on_train_step_end(ctx)
        tm.on_train_epoch_end(ctx)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == (
        "epoch time: 10.000 ms, per step time: 10.000 ms\n")
    # speed_of_light: the same floor and one step spanning the epoch (the
    # reference rates the median step, the port the epoch per step)
    floor = {"floor_ms": 1.0, "floor_samples_per_sec": 16000,
             "hbm_ms": 0.6, "mxu_ms": 0.4}
    outs = []
    for mod in (tcb, jcb):
        ticks = iter([0.0, 0.0, 0.010, 0.010])
        monkeypatch.setattr(mod.time, "perf_counter", lambda t=ticks: next(t))
        tm = mod.TimeMonitor(speed_of_light=floor, batch_size=16)
        ctx = _ctx(mod)
        tm.on_train_epoch_begin(ctx)
        tm.on_train_step_begin(ctx)
        tm.on_train_step_end(ctx)
        tm.on_train_epoch_end(ctx)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == (
        "epoch time: 10.000 ms, per step time: 10.000 ms, 1,600 samples/s "
        "= 10% of the 16,000/s analytic floor (hbm 0.6 ms + mxu 0.4 ms)\n")


def test_fault_injector_and_stop(tmp_path):
    ctx = _ctx(tcb)
    tcb.FaultInjector(5).on_train_step_end(ctx)  # not its step
    with pytest.raises(RuntimeError, match="simulated crash at step 6"):
        tcb.FaultInjector(6).on_train_step_end(ctx)
    marker = tmp_path / "crashed"
    with pytest.raises(RuntimeError):
        tcb.FaultInjector(6, once_marker=str(marker)).on_train_step_end(ctx)
    tcb.FaultInjector(6, once_marker=str(marker)).on_train_step_end(ctx)
    assert not ctx.stop_requested
    ctx.request_stop()
    assert ctx.stop_requested
