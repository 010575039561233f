"""The port's ``RecModel`` against the JAX package on the CPU.

``train`` runs over raw host batches through the port's
``SparseInputPipeline`` (native prep, one regrow of the unique bucket),
held against the JAX ``SparseInputPipeline(device=False)`` feeding the
JAX streamed step (``use_pallas=True``, Pallas in interpret mode) from
the same state, carried across by ``convert.state_from_jax``.  Both
steps run the expanded rows in float32, so the tolerances are those of
``tests/test_torch_step.py::test_step_matches_jax_f32``: losses rtol
1e-5, every leaf rtol 1e-4 / atol 1e-8.  The input recipes (the wire,
device prep, the fused step, ``input_recipe="auto"``) and online
training from a Kafka stub broker are held to the reference the same
way; the fused step to the per-batch path bit for bit."""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindrec_tpu.data import kafka_stub as jstub
from mindrec_tpu.data import kafka_wire as jkw
from mindrec_tpu.data import pipeline as jpipeline
from mindrec_tpu.data import streaming as jstreaming
from mindrec_tpu.data import wire as jwire
from mindrec_tpu.models import multitable as jmt
from mindrec_tpu.models import wide_deep as jwd
from mindrec_tpu.ops.pallas import stream_update
from mindrec_tpu.train import optim as jopt
from mindrec_tpu.train import rec_model as jrec
from mindrec_tpu.train import step as jstep
from mindrec_tpu_torch import RecModel, convert
from mindrec_tpu_torch.data import (
    kafka_stub, kafka_wire, preprocess, streaming, wire,
)
from mindrec_tpu_torch.data.criteo import SyntheticCriteo, to_device
from mindrec_tpu_torch.data.outbrain import SyntheticOutbrain
from mindrec_tpu_torch.data.pipeline import AdaptiveBucket
from mindrec_tpu_torch.models import multitable, wide_deep
from mindrec_tpu_torch.train import optim
from mindrec_tpu_torch.train.callbacks import Callback
from mindrec_tpu_torch.train.step import _state_tensors, make_train_step

WD = dict(batch_size=32, field_size=4, vocab_size=50_000, emb_dim=8,
          deep_layer_dim=(16, 8), sparse=True, use_mixed_precision=False,
          loss_scale=1024.0)
MT = dict(batch_size=32, continue_field_size=4, indicator_field_size=2,
          emb128_field_size=2, emb64_single_field_size=2,
          multi_hot_sizes=(3, 4, 3, 2, 2, 3), emb_128_size=3000,
          emb64_single_size=50, emb64_multi_size=2500, indicator_size=16,
          deep_layer_dim=(32, 16), loss_scale=1000.0, sparse=True,
          use_mixed_precision=False)
MT_OPT = (dict(learning_rate=5e-2, l1=5e-4, l2=5e-4, initial_accum=0.1,
               loss_scale=1000.0),
          dict(learning_rate=1e-3, eps=1e-6, loss_scale=1000.0))


@pytest.fixture(autouse=True)
def _interpret_kernels():
    stream_update.INTERPRET = True
    try:
        yield
    finally:
        stream_update.INTERPRET = False


def _quiet(*a, **k):
    pass


class _Record(Callback):
    def __init__(self, stop_at=None):
        self.losses, self.events, self.stop_at = [], [], stop_at

    def on_train_epoch_begin(self, ctx):
        self.events.append(("epoch", ctx.epoch_num))

    def on_train_step_end(self, ctx):
        self.losses.append(tuple(float(x) for x in ctx.net_outputs))
        self.events.append(("step", ctx.cur_step_num))
        if ctx.cur_step_num == self.stop_at:
            ctx.request_stop()


def _wd_batches():
    """3 batches over 100 ids, then 3 over 50,000: one regrow."""
    rng = np.random.default_rng(1)

    def batch(vocab):
        return {
            "ids": rng.integers(0, vocab, size=(32, 4)).astype(np.int32),
            "wts": rng.uniform(0.5, 1.5, size=(32, 4)).astype(np.float32),
            "label": rng.integers(0, 2, size=(32, 1)).astype(np.float32),
        }

    return [batch(100) for _ in range(3)] + [batch(50_000) for _ in range(3)]


def _wd_setup():
    jm = jwd.WideDeepModel(jwd.WideDeepConfig(**WD))
    tm = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**WD))
    jo = (jopt.ftrl(loss_scale=1024.0), jopt.lazy_adam(loss_scale=1024.0))
    to = (optim.ftrl(loss_scale=1024.0), optim.lazy_adam(loss_scale=1024.0))
    return jm, jo, tm, to


def _mt_setup():
    jm = jmt.MultiTableWideDeepModel(jmt.MultiTableConfig(**MT))
    tm = multitable.MultiTableWideDeepModel(multitable.MultiTableConfig(**MT))
    jo = (jopt.ftrl(**MT_OPT[0]), jopt.lazy_adam(**MT_OPT[1]))
    to = (optim.ftrl(**MT_OPT[0]), optim.lazy_adam(**MT_OPT[1]))
    return jm, jo, tm, to


def _carry(jm, jo):
    js = jstep.init_train_state(jm, jax.random.PRNGKey(0), *jo)
    host = jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d))
    return js, convert.state_from_jax(*host, np.asarray(js.step), device="cpu")


def _rec_model(tm, to, ts, **kw):
    """RecModel on the CPU at the JAX state, its step in float32."""
    rm = RecModel(tm, opt_w=to[0], opt_d=to[1], device="cpu", **kw)
    rm.train_step = make_train_step(tm, *to, matmul_dtype=torch.float32,
                                    jit=True)
    rm.state = ts
    return rm


def _compare(js, ts):
    def leaves(tree):
        return [(jax.tree_util.keystr(p), np.asarray(x, np.float32))
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]

    ref = leaves(jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d)))
    got = leaves(convert.state_to_jax(ts)[:3])
    assert [k for k, _ in ref] == [k for k, _ in got]
    for (k, a), (_, b) in zip(ref, got):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-8, err_msg=k)


def _jax_losses(jm, jo, js, pipe):
    # jitted (the same function as jit=False, compiled once per bucket;
    # op by op, interpret mode takes 2.5x as long here)
    j_fn = jstep.make_train_step(jm, *jo, jit=True, donate=False,
                                 use_pallas=True, row_layout=True,
                                 matmul_dtype=jnp.float32)
    losses = []
    for b in pipe:
        js, (lw, ld) = j_fn(js, b)
        losses.append((float(lw), float(ld)))
    return js, losses


def test_train_with_regrow_matches_jax():
    jm, jo, tm, to = _wd_setup()
    js, ts = _carry(jm, jo)
    data = _wd_batches()
    rec = _Record()
    rm = _rec_model(tm, to, ts, prep_workers=1,
                    unique_bucket=AdaptiveBucket(96, quantum=16, log=_quiet))
    state = rm.train(1, data, callbacks=[rec], dataset_sink_mode=True)
    assert int(state.step) == 6 and rm.bucket_policy.bucket == 160
    jpol = jpipeline.AdaptiveBucket(96, quantum=16, log=_quiet)
    js, jlosses = _jax_losses(jm, jo, js, jpipeline.SparseInputPipeline(
        iter(data), field_size=4, policy=jpol, workers=1, device=False))
    assert jpol.bucket == 160
    np.testing.assert_allclose(rec.losses, jlosses, rtol=1e-5)
    _compare(js, state)


def test_multigroup_host_prep_matches_jax():
    jm, jo, tm, to = _mt_setup()
    js, ts = _carry(jm, jo)
    data = list(SyntheticOutbrain(multitable.MultiTableConfig(**MT), 3, seed=1))
    rec = _Record()
    rm = _rec_model(tm, to, ts, host_prep=True, prep_workers=2)
    state = rm.train(1, data, callbacks=[rec], dataset_sink_mode=True)
    assert int(state.step) == 3
    js, jlosses = _jax_losses(jm, jo, js, jpipeline.SparseInputPipeline(
        iter(data), field_size=0, groups=jstep.prep_groups(jm), workers=2,
        device=False))
    np.testing.assert_allclose(rec.losses, jlosses, rtol=1e-5)
    _compare(js, state)


def test_eval_auc_matches_jax():
    jm, jo, tm, to = _wd_setup()
    js, ts = _carry(jm, jo)
    data = _wd_batches()[:4]
    jrm = jrec.RecModel(jm, opt_w=jo[0], opt_d=jo[1])
    jrm.state = js
    rm = _rec_model(tm, to, ts)
    got, want = rm.eval(data)["auc"], jrm.eval(data)["auc"]
    assert abs(got - want) <= 1e-6 and 0.0 < got < 1.0


def test_online_train_errors_exhaustion_and_stop():
    _jm, _jo, tm, to = _wd_setup()
    rm = RecModel(tm, opt_w=to[0], opt_d=to[1], device="cpu")
    data = _wd_batches()[:3]
    with pytest.raises(ValueError, match=r"The 'sink_size' must be a positive "
                       r"integer, but got 0\."):
        rm.online_train(data, sink_size=0)
    with pytest.raises(ValueError, match=r"The 'sink_size' must be 1 for online "
                       r"training in dataset sink mode, but got 2\."):
        rm.online_train(data, dataset_sink_mode=True, sink_size=2)
    with pytest.raises(TypeError, match=r"The 'dataset_sink_mode' must be a "
                       r"bool, but got str\."):
        rm.online_train(data, dataset_sink_mode="yes")
    rec = _Record()
    state = rm.online_train(iter(data), callbacks=[rec])
    assert int(state.step) == 3
    assert rec.events == [("epoch", 1), ("step", 1), ("epoch", 2), ("step", 2),
                          ("epoch", 3), ("step", 3), ("epoch", 4)]
    rec = _Record(stop_at=2)
    state = rm.online_train(iter(data * 5), callbacks=[rec])
    assert int(state.step) == 5 and len(rec.losses) == 2


@pytest.mark.parametrize("kw,exc", [
    ({"wire": object(), "donate": False}, None),
    ({"prep_placement": "device", "unique_bucket": 64, "donate": False},
     None),
    ({"input_recipe": "auto", "donate": False}, None),
    ({"prep_placement": "disk"}, ValueError),
    ({"input_recipe": "fast"}, ValueError),
    ({"donate": False}, None),
])
def test_unported_options_raise(kw, exc):
    """Bad option values raise.  ``donate=False`` builds wherever the
    reference's does, with the wire, device prep and the auto recipe too,
    and its step leaves the state passed in as it was."""
    _jm, _jo, tm, _to = _wd_setup()
    if exc is not None:
        with pytest.raises(exc):
            RecModel(tm, device="cpu", **kw)
        return
    rm = RecModel(tm, device="cpu", **kw)
    if "unique_bucket" in kw:
        return  # its step takes device-prepped batches
    before = [x.clone() for x in _state_tensors(rm.state)]
    b = SyntheticCriteo(32, 4, 50_000, seed=1).get_batch(0)
    state, _losses = rm.train_step(rm.state, to_device(b, "cpu"))
    assert state is not rm.state and int(state.step) == 1
    for x, y in zip(before, _state_tensors(rm.state)):
        assert torch.equal(x, y)


def test_ported_input_options_build():
    _jm, _jo, tm, _to = _wd_setup()
    w = wire.BatchWire.for_sparse(50_000, 32, 4)
    rm = RecModel(tm, device="cpu", wire=w, prep_placement="device",
                  unique_bucket=64, input_recipe="auto")
    assert rm.wire is w and rm.host_prep and rm.prep_placement == "device"
    with pytest.raises(ValueError, match="unique_bucket"):
        RecModel(tm, device="cpu", prep_placement="device")


# ---------------------------------------------------------------------------
# the input recipes: the wire, device prep, the fused step, "auto"
# ---------------------------------------------------------------------------


def _device_prep_pair(wire_kw=None):
    """The port's and the reference's RecModel with device prep and the
    wire from one state, both steps streamed in float32 (the reference's
    Pallas kernels in interpret mode) at the bucket the audit grows."""
    jm, jo, tm, to = _wd_setup()
    js, ts = _carry(jm, jo)
    wire_kw = wire_kw or {}
    kw = dict(prep_workers=1, prep_placement="device", audit_every=1)
    rm = RecModel(tm, opt_w=to[0], opt_d=to[1], device="cpu",
                  unique_bucket=AdaptiveBucket(96, quantum=16, log=_quiet),
                  wire=wire.BatchWire.for_sparse(50_000, 32, 4, **wire_kw),
                  **kw)
    rm._step_kw["matmul_dtype"] = torch.float32
    rm.train_step = make_train_step(tm, *to, **rm._step_kw)
    rm.state = ts
    jrm = jrec.RecModel(jm, opt_w=jo[0], opt_d=jo[1],
                        unique_bucket=jpipeline.AdaptiveBucket(
                            96, quantum=16, log=_quiet),
                        wire=jwire.BatchWire.for_sparse(50_000, 32, 4,
                                                        **wire_kw), **kw)
    jrm._step_kw.update(use_pallas=True, row_layout=True, donate=False,
                        matmul_dtype=jnp.float32)
    jrm.train_step = jstep.make_train_step(jm, *jo, **jrm._step_kw)
    jrm.state = js
    return rm, jrm


@pytest.mark.parametrize("lossy_wts", [True, False])
def test_device_prep_wire_matches_jax(lossy_wts):
    """prep_placement="device" with the wire: raw batches encoded on the
    host, decoded, sorted in the step; the audit regrows the bucket (one
    step rebuild) as the reference's does."""
    rm, jrm = _device_prep_pair({"lossy_wts": lossy_wts})
    data = _wd_batches()
    rec, jrec_ = _Record(), _Record()
    state = rm.train(1, data, callbacks=[rec], dataset_sink_mode=True)
    jrm.train(1, data, callbacks=[jrec_], dataset_sink_mode=True)
    assert int(state.step) == 6
    assert rm.bucket_policy.bucket == jrm.bucket_policy.bucket == 160
    np.testing.assert_allclose(rec.losses, jrec_.losses, rtol=1e-5)
    _compare(jrm.state, state)


def test_fused_step_equals_per_batch_device_prep():
    """The fused superbatch step (forced: k = 3 over 7 batches, a padded
    tail of 1) trains bit for bit as the per-batch device-prep path."""
    _jm, _jo, tm, to = _wd_setup()
    data = _wd_batches() + _wd_batches()[:1]

    def run(fused):
        rm = RecModel(tm, opt_w=to[0], opt_d=to[1], device="cpu", seed=3,
                      unique_bucket=AdaptiveBucket(2048, log=_quiet),
                      prep_placement="device",
                      wire=wire.BatchWire.for_sparse(50_000, 32, 4))
        if fused:
            rm._superbatch = 3
            rm._build_fused(rm.bucket_policy.bucket)
        rec = _Record()
        rm.train(1, [dict(b) for b in data], callbacks=[rec],
                 dataset_sink_mode=True)
        return rm, rec.losses

    plain, lp = run(False)
    fused, lf = run(True)
    assert fused._fused is not None and plain._fused is None
    assert int(plain.state.step) == int(fused.state.step) == 7
    assert lp == lf
    for a, b in zip(_state_tensors(plain.state), _state_tensors(fused.state)):
        assert torch.equal(a, b)


def test_auto_recipe_is_a_no_op_on_the_cpu():
    _jm, _jo, tm, to = _wd_setup()
    rm = RecModel(tm, opt_w=to[0], opt_d=to[1], device="cpu",
                  unique_bucket=2048, input_recipe="auto")
    state = rm.train(1, _wd_batches()[:5], dataset_sink_mode=True)
    assert int(state.step) == 5
    assert rm._fused is None and rm.wire is None and rm.link is None
    assert rm.prep_placement == "host"


@pytest.mark.parametrize("link", [(0.02, 20e9), (80.0, 60e6)])
def test_resolve_recipe_decides_as_the_reference(monkeypatch, link):
    """``_resolve_recipe`` with the link measurement replaced: a PCIe-like
    link keeps host prep; the tunnel's 80 ms per put and 60 MB/s choose
    device prep, the wire and k = 16 (the reference's tunnel figures),
    as the reference decides."""
    cfg = dict(WD, batch_size=16_000, field_size=39, vocab_size=100_000)
    tm = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**cfg))
    jm = jwd.WideDeepModel(jwd.WideDeepConfig(**cfg))
    monkeypatch.setattr(wire, "measure_link", lambda *a, **k: link)
    monkeypatch.setattr(jwire, "measure_link", lambda *a, **k: link)
    monkeypatch.setattr(jrec.jax, "default_backend", lambda: "tpu")
    rm = RecModel(tm, device="cpu", unique_bucket=150_000,
                  input_recipe="auto")
    rm.device = torch.device("cuda")  # decide as on the card
    rm._resolve_recipe()
    jrm = jrec.RecModel(jm, unique_bucket=150_000, input_recipe="auto")
    jrm._resolve_recipe()
    assert rm.prep_placement == jrm.prep_placement
    assert rm._superbatch == getattr(jrm, "_superbatch", 1)
    assert (rm._fused is None) == (jrm._fused is None)
    assert (rm.wire is None) == (jrm.wire is None)
    if link[0] > 1:
        assert rm.prep_placement == "device" and rm._superbatch == 16
        probe = {"ids": np.zeros((16_000, 39), np.int32),
                 "wts": np.zeros((16_000, 39), np.float32),
                 "label": np.zeros((16_000, 1), np.float32)}
        assert rm.wire.wire_bytes(probe) == jrm.wire.wire_bytes(probe)
    else:
        assert rm.prep_placement == "host" and rm.link == link


def _kafka_rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return ["\t".join([str(int(rng.uniform() > 0.7))]
                      + [str(int(rng.integers(0, 50))) for _ in range(13)]
                      + [f"v{int(rng.integers(0, 4))}" for _ in range(26)])
            for _ in range(n)]


def _kafka_chain(stub_mod, kw_mod, smod, stats, rows):
    """Produce ``rows`` over 2 partitions (16 rows per JSON message, as
    examples/kafka_producer.py) into a fresh stub; read them back through
    KafkaSource -> CriteoFeatureEngineer -> Channel -> StreamingDataset."""
    broker = stub_mod.StubKafkaBroker()
    bootstrap = broker.start()
    try:
        smod.create_topic("criteo", 2, bootstrap_servers=bootstrap)
        for part in range(2):
            prod = kw_mod.MiniKafkaProducer(
                bootstrap, value_serializer=lambda v: json.dumps(v).encode())
            mine = [r.split("\t") for i, r in enumerate(rows) if i % 2 == part]
            for i in range(0, len(mine), 16):
                prod.send("criteo", value=mine[i:i + 16], partition=part)
            prod.close()
        src = smod.KafkaSource("criteo", [0, 1], bootstrap_servers=bootstrap,
                               count=2, idle_timeout_ms=300,
                               auto_offset_reset="earliest")
        fe = smod.CriteoFeatureEngineer(stats)
        ch = smod.Channel(num_shards=1)
        feeder = smod.feed_channel_from_iterator(
            (fe([r for m in msgs for r in json.loads(m)]) for msgs in src), ch)
        return broker, feeder, smod.StreamingDataset(ch.receiver(0))
    except BaseException:
        broker.stop()
        raise


def test_kafka_online_train_matches_jax(tmp_path, monkeypatch):
    """stub broker -> KafkaSource -> CriteoFeatureEngineer -> Channel ->
    StreamingDataset -> online_train, the port's chain against the
    reference's, from one state: the same losses and state."""
    monkeypatch.setitem(sys.modules, "kafka", None)
    monkeypatch.setitem(sys.modules, "kafka.admin", None)
    rows = _kafka_rows(64) * 3  # every cat value clears the count > 6
    tsv = tmp_path / "day0.tsv"
    tsv.write_text("\n".join(rows) + "\n")
    stats = preprocess.collect_stats([str(tsv)], workers=1)
    cfg = dict(batch_size=32, field_size=39, vocab_size=stats.vocab_size,
               emb_dim=4, deep_layer_dim=(8,), sparse=True,
               use_mixed_precision=False, loss_scale=1.0)
    jm = jwd.WideDeepModel(jwd.WideDeepConfig(**cfg))
    tm = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**cfg))
    jo = (jopt.ftrl(), jopt.lazy_adam())
    to = (optim.ftrl(), optim.lazy_adam())
    js, ts = _carry(jm, jo)
    rm = _rec_model(tm, to, ts)
    jrm = jrec.RecModel(jm, opt_w=jo[0], opt_d=jo[1])
    jrm.train_step = jstep.make_train_step(
        jm, *jo, jit=True, donate=False, use_pallas=True, row_layout=True,
        matmul_dtype=jnp.float32)
    jrm.state = js
    losses = []
    for mods, model in (((kafka_stub, kafka_wire, streaming), rm),
                        ((jstub, jkw, jstreaming), jrm)):
        broker, feeder, ds = _kafka_chain(*mods, stats, rows)
        try:
            rec = _Record()
            model.online_train(ds, callbacks=[rec])
            feeder.join(timeout=30)
            assert not feeder.is_alive()
        finally:
            broker.stop()
        losses.append(rec.losses)
    assert len(losses[0]) == len(losses[1]) == 6
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    _compare(jrm.state, rm.state)
