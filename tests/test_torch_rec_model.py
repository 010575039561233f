"""The port's ``RecModel`` against the JAX package on the CPU.

``train`` runs over raw host batches through the port's
``SparseInputPipeline`` (native prep, one regrow of the unique bucket),
held against the JAX ``SparseInputPipeline(device=False)`` feeding the
JAX streamed step (``use_pallas=True``, Pallas in interpret mode) from
the same state, carried across by ``convert.state_from_jax``.  Both
steps run the expanded rows in float32, so the tolerances are those of
``tests/test_torch_step.py::test_step_matches_jax_f32``: losses rtol
1e-5, every leaf rtol 1e-4 / atol 1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindrec_tpu.data import pipeline as jpipeline
from mindrec_tpu.models import multitable as jmt
from mindrec_tpu.models import wide_deep as jwd
from mindrec_tpu.ops.pallas import stream_update
from mindrec_tpu.train import optim as jopt
from mindrec_tpu.train import rec_model as jrec
from mindrec_tpu.train import step as jstep
from mindrec_tpu_torch import RecModel, convert
from mindrec_tpu_torch.data.outbrain import SyntheticOutbrain
from mindrec_tpu_torch.data.pipeline import AdaptiveBucket
from mindrec_tpu_torch.models import multitable, wide_deep
from mindrec_tpu_torch.train import optim
from mindrec_tpu_torch.train.callbacks import Callback
from mindrec_tpu_torch.train.step import make_train_step

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
    ({"wire": object()}, NotImplementedError),
    ({"prep_placement": "device"}, NotImplementedError),
    ({"input_recipe": "auto"}, NotImplementedError),
    ({"prep_placement": "disk"}, ValueError),
    ({"input_recipe": "fast"}, ValueError),
    ({"donate": False}, NotImplementedError),
])
def test_unported_options_raise(kw, exc):
    _jm, _jo, tm, _to = _wd_setup()
    with pytest.raises(exc):
        RecModel(tm, device="cpu", **kw)


def test_dense_model_raises():
    cfg = wide_deep.WideDeepConfig(**{**WD, "sparse": False})
    with pytest.raises(NotImplementedError, match="dense train step"):
        RecModel(wide_deep.WideDeepModel(cfg), device="cpu")
