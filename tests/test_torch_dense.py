"""The port's dense train step (``make_train_step(sparse=False)``, every
model config's default), dropout, DCN's one-hot lookup and ``max_norm``
lookups against the JAX package on the same inputs.

State is made once in JAX and carried into the port by
``convert.state_from_jax``; the JAX dense step runs op by op
(``make_train_step(sparse=False, jit=False)``).  The two packages draw
dropout masks from different generators, so the dropout parity tests
record the masks the reference draws (its own split/bernoulli sequence)
and hand the same masks to the port.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindrec_tpu.models import dcn as jdcn
from mindrec_tpu.models import deepfm as jdeepfm
from mindrec_tpu.models import multitable as jmt
from mindrec_tpu.models import wide_deep as jwd
from mindrec_tpu.ops import embedding as jemb
from mindrec_tpu.train import optim as jopt
from mindrec_tpu.train import rec_model as jrec
from mindrec_tpu.train import step as jstep
from mindrec_tpu_torch import RecModel, convert
from mindrec_tpu_torch.data.criteo import SyntheticCriteo, to_device
from mindrec_tpu_torch.data.outbrain import SyntheticOutbrain
from mindrec_tpu_torch.models import dcn, deepfm, multitable, wide_deep
from mindrec_tpu_torch.ops import embedding, prng
from mindrec_tpu_torch.train import optim
from mindrec_tpu_torch.train.callbacks import Callback
from mindrec_tpu_torch.train.step import (
    _state_tensors, make_train_step,
)
from test_torch_guard import _no_host_reads

B, F, V = 64, 4, 2000
WD = dict(batch_size=B, field_size=F, vocab_size=V, emb_dim=16,
          deep_layer_dim=(32, 16), loss_scale=1024.0)
FM = dict(batch_size=B, field_size=F, vocab_size=V, emb_dim=20,
          deep_layer_dim=(32, 16), loss_scale=1024.0)
DCN = dict(batch_size=B, field_size=F, vocab_size=V, emb_dim=7,
           deep_layer_dim=(32, 32), cross_layer_num=3, loss_scale=1024.0)
MT = dict(batch_size=B, continue_field_size=4, indicator_field_size=2,
          emb128_field_size=2, emb64_single_field_size=2,
          multi_hot_sizes=(3, 4, 3, 2, 2, 3), emb_128_size=2000,
          emb64_single_size=50, emb64_multi_size=1500, indicator_size=16,
          deep_layer_dim=(32, 16), loss_scale=1000.0)


def _wd_opts(mod, dt, sd):
    return (mod.ftrl(loss_scale=1024.0),
            mod.lazy_adam(loss_scale=1024.0, state_dtype=getattr(dt, sd)))


def _fm_opts(mod, dt, sd):  # one Adam on both sides of the split
    return tuple(mod.adam(learning_rate=5e-4, eps=5e-8, loss_scale=1024.0,
                          state_dtype=getattr(dt, sd)) for _ in range(2))


def _mt_opts(mod, dt, sd):
    return (mod.ftrl(learning_rate=5e-2, l1=5e-4, l2=5e-4, initial_accum=0.1,
                     loss_scale=1000.0),
            mod.lazy_adam(learning_rate=1e-3, eps=1e-6, loss_scale=1000.0,
                          state_dtype=getattr(dt, sd)))


MODELS = {
    "wd": (jwd.WideDeepModel, jwd.WideDeepConfig, wide_deep.WideDeepModel,
           wide_deep.WideDeepConfig, WD, _wd_opts),
    "deepfm": (jdeepfm.DeepFMModel, jdeepfm.DeepFMConfig, deepfm.DeepFMModel,
               deepfm.DeepFMConfig, FM, _fm_opts),
    "dcn": (jdcn.DCNModel, jdcn.DCNConfig, dcn.DCNModel, dcn.DCNConfig, DCN,
            _fm_opts),
    "multitable": (jmt.MultiTableWideDeepModel, jmt.MultiTableConfig,
                   multitable.MultiTableWideDeepModel,
                   multitable.MultiTableConfig, MT, _mt_opts),
}
MLP = {"wd": ("deep", "mlp"), "deepfm": ("mlp",),
       "multitable": ("deep", "mlp")}


def _setup(which, mixed, state_dtype="float32", **cfg_kw):
    """(jax model, jax state, jax opts, port model, port state, port opts)
    from one JAX init, dense tables (the configs' default)."""
    jcls, jcfg, tcls, tcfg, base, opts = MODELS[which]
    kw = {**base, "use_mixed_precision": mixed, **cfg_kw}
    jm, tm = jcls(jcfg(**kw)), tcls(tcfg(**kw))
    jo, to = opts(jopt, jnp, state_dtype), opts(optim, torch, state_dtype)
    js = jstep.init_train_state(jm, jax.random.PRNGKey(0), *jo)
    host = jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d))
    ts = convert.state_from_jax(*host, np.asarray(js.step), device="cpu")
    return jm, js, jo, tm, ts, to


def _batches(which, tm, n, seed=3):
    if which == "multitable":
        return list(SyntheticOutbrain(tm.config, n, seed=seed))
    data = SyntheticCriteo(B, F, V, seed=seed)
    return [data.get_batch(i) for i in range(n)]


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x, np.float32))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _compare(js, ts, rtol, atol, keep=lambda key: True):
    ref = _leaves(jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d)))
    got = _leaves(convert.state_to_jax(ts)[:3])
    assert [k for k, _ in ref] == [k for k, _ in got]
    for (k, a), (_, b) in zip(ref, got):
        if keep(k):
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=k)


def _run_both(jm, js, jo, tm, ts, to, batches, **step_kw):
    """The same batches through the JAX dense step (op by op) and the
    port's; losses must agree to rtol 1e-5 at every step."""
    j_fn = jstep.make_train_step(jm, *jo, jit=False, **step_kw)
    t_fn = make_train_step(tm, *to, **step_kw)
    for b in batches:
        js, (jlw, jld) = j_fn(js, b)
        ts, (tlw, tld) = t_fn(ts, to_device(b, "cpu"))
        np.testing.assert_allclose(float(tlw), float(jlw), rtol=1e-5)
        np.testing.assert_allclose(float(tld), float(jld), rtol=1e-5)
    assert int(ts.step) == int(js.step) == len(batches)
    return js, ts


@contextlib.contextmanager
def _reference_masks(monkeypatch):
    """Record the masks the reference draws (``jax.random.bernoulli``, its
    own split sequence), then hand them to the port's draws in order."""
    masks = []
    real = jax.random.bernoulli

    def record(key, p, shape=None):
        out = real(key, p, shape)
        masks.append(np.asarray(out))
        return out

    def replay(key, p, shape):
        m = masks.pop(0)
        assert tuple(m.shape) == tuple(shape)
        return torch.from_numpy(np.array(m))

    with monkeypatch.context() as m:
        m.setattr(jax.random, "bernoulli", record)
        m.setattr(prng, "bernoulli", replay)
        yield masks


# ---------------------------------------------------------------------------
# the dense step against the JAX dense step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["wd", "deepfm", "dcn", "multitable"])
def test_dense_step_matches_jax_f32(which):
    """Three float32 dense steps (autograd over every leaf, full tables
    included, then each leaf's dense update; W&D and DeepFM with their
    tables' l2 term): losses within rtol 1e-5, every parameter and
    optimizer leaf within rtol 1e-4 / atol 1e-8, the tolerances of
    ``tests/test_torch_step.py::test_step_matches_jax_f32``."""
    jm, js, jo, tm, ts, to = _setup(which, mixed=False)
    js, ts = _run_both(jm, js, jo, tm, ts, to, _batches(which, tm, 3))
    _compare(js, ts, rtol=1e-4, atol=1e-8)


@pytest.mark.parametrize("which", ["wd", "deepfm", "multitable"])
def test_dense_step_matches_jax_mixed_precision(which):
    """The configs' precision (bf16 MLP) with bf16 Adam moments, three
    steps, at ``test_step_matches_jax_mixed_precision``'s tolerances:
    losses rtol 1e-5, tables and weight matrices atol 5e-5, the tables'
    optimizer state rtol 2e-2 / atol 1e-6 (XLA and PyTorch sum the bf16
    gradients in other orders).  Biases are held to 1.5e-4, as in
    ``test_default_path_step_matches_jax_mixed_precision``: Adam divides
    by sqrt(v), so a bf16 bias gradient that sums to almost nothing moves
    its weight a good part of a step either way."""
    jm, js, jo, tm, ts, to = _setup(which, mixed=True, state_dtype="bfloat16")
    js, ts = _run_both(jm, js, jo, tm, ts, to, _batches(which, tm, 3))
    tables = {"/".join(p) for p, _ in tm.table_specs.values()}

    def table_state(k):
        return any(f"'{t}']" in k for t in tables)

    def param(k):
        return not k.startswith(("[1]", "[2]"))

    _compare(js, ts, rtol=0, atol=5e-5,
             keep=lambda k: param(k) and not k.endswith(("['b']", "['bias']")))
    _compare(js, ts, rtol=0, atol=1.5e-4, keep=param)
    _compare(js, ts, rtol=2e-2, atol=1e-6,
             keep=lambda k: not param(k) and table_state(k))


def test_dense_ftrl_updates_every_wide_row():
    """Dense FTRL touches the whole wide table: every row no batch id
    touched, its ``linear`` still 0 (<= l1), becomes 0 at the first step,
    as the reference's dense update does; touched rows keep a weight."""
    jm, js, jo, tm, ts, to = _setup("wd", mixed=False)
    batch = _batches("wd", tm, 1)[0]
    js, ts = _run_both(jm, js, jo, tm, ts, to, [batch])
    _compare(js, ts, rtol=1e-4, atol=1e-8)
    wide = ts.params["wide"]["table"][:, 0]
    touched = np.zeros(wide.shape[0], bool)
    touched[np.unique(batch["ids"])] = True
    assert (wide[~torch.from_numpy(touched)] == 0).all()
    assert (wide[torch.from_numpy(touched)] != 0).all()


@pytest.mark.parametrize("bad", [np.inf, np.nan])
def test_dense_check_overflow_matches_jax(bad, monkeypatch):
    """check_overflow on the dense step, with no host read: a non-finite
    gradient keeps every parameter and optimizer leaf and advances the
    step and the key (the reference's ``_guard``); the other steps match
    the JAX guarded dense step."""
    jm, js, jo, tm, ts, to = _setup("wd", mixed=False)
    j_fn = jstep.make_train_step(jm, *jo, jit=False, check_overflow=True)
    t_fn = make_train_step(tm, *to, check_overflow=True)
    for i, b in enumerate(_batches("wd", tm, 3, seed=8)):
        if i == 1:
            b["wts"][3, 2] = bad
            before = [t.clone() for t in _state_tensors(ts)]
        js, _ = j_fn(js, b)
        tb = to_device(b, "cpu")
        with _no_host_reads(monkeypatch):
            ts, _ = t_fn(ts, tb)
        if i == 1:  # every leaf but the key and the step kept
            after = _state_tensors(ts)
            for x, y in zip(before[:-2], after[:-2]):
                assert torch.equal(x, y)
            assert not torch.equal(before[-2], after[-2])  # rng advanced
    assert int(ts.step) == int(js.step) == 3
    assert int(ts.opt_d["deep/table"]["step"]) == 2
    _compare(js, ts, rtol=1e-4, atol=1e-8)


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("which", ["wd", "deepfm", "multitable"])
def test_dropout_mlp_with_reference_masks_matches_jax(which, mixed,
                                                      monkeypatch):
    """``_mlp(train=True, rng=key)``: inverted dropout before every
    layer's matmul, the input's included, with the masks of the
    reference's own split/bernoulli sequence from ``key`` handed to the
    port; float32 within rtol 1e-5, bf16 within the 2e-3 of the other
    bf16 forward tests.  Each layer draws once, and the dropped output
    differs from the undropped one."""
    jm, js, _, tm, ts, _ = _setup(which, mixed, dropout_flag=True,
                                  keep_prob=0.7)
    jmlp, tmlp = js.params, ts.params
    for k in MLP[which]:
        jmlp, tmlp = jmlp[k], tmlp[k]
    x = np.random.default_rng(0).normal(
        size=(B, tm.mlp_dims[0][0])).astype(np.float32)
    with _reference_masks(monkeypatch) as masks:
        want = np.asarray(jm._mlp(jmlp, jnp.asarray(x), True,
                                  jax.random.PRNGKey(5)))
        assert [m.shape for m in masks] == [(B, i) for i, _ in tm.mlp_dims]
        got = tm._mlp(tmlp, torch.from_numpy(x), True, prng.key(0, "cpu"))
        assert masks == []
    tol = dict(rtol=1e-5, atol=1e-6) if not mixed else dict(atol=2e-3)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    plain = tm._mlp(tmlp, torch.from_numpy(x))
    assert not torch.equal(got, plain)


@pytest.mark.parametrize("which", ["wd", "deepfm", "multitable"])
def test_dense_step_with_reference_masks_matches_jax(which, monkeypatch):
    """Three float32 dense steps with ``dropout_flag=True, keep_prob=0.8``,
    the port fed the masks the JAX step draws from its key: losses and
    state at the f32 parity tolerances (the mask's backward included)."""
    jm, js, jo, tm, ts, to = _setup(which, mixed=False, dropout_flag=True,
                                    keep_prob=0.8)
    with _reference_masks(monkeypatch) as masks:
        js, ts = _run_both(jm, js, jo, tm, ts, to, _batches(which, tm, 3))
        assert masks == []
    _compare(js, ts, rtol=1e-4, atol=1e-8)


@pytest.mark.parametrize("off", [dict(dropout_flag=False, keep_prob=0.5),
                                 dict(dropout_flag=True, keep_prob=1.0)],
                         ids=["flag_off", "keep_all"])
@pytest.mark.parametrize("which", ["wd", "deepfm", "multitable"])
def test_dropout_off_is_the_plain_path(which, off):
    """Dropout configured off (no flag, as DeepFM's default keep_prob 0.9
    without it, or keep_prob 1) draws nothing: the forward in training
    equals the forward in eval, and two dense steps equal those of the
    config without dropout bit for bit."""
    plain = {"dropout_flag": False, "keep_prob": 1.0}
    *_, tm, ts, to = _setup(which, mixed=True, **off)
    *_, tm0, ts0, _ = _setup(which, mixed=True, **plain)
    b = to_device(_batches(which, tm, 1)[0], "cpu")
    key = prng.key(1, "cpu")
    torch.testing.assert_close(tm.apply_batch(ts.params, b, True, key),
                               tm.apply_batch(ts.params, b), rtol=0, atol=0)
    fa, fb = make_train_step(tm, *to), make_train_step(tm0, *to)
    for b in _batches(which, tm, 2):
        ts, la = fa(ts, to_device(b, "cpu"))
        ts0, lb = fb(ts0, to_device(b, "cpu"))
        assert all(torch.equal(x, y) for x, y in zip(la, lb))
    for x, y in zip(_state_tensors(ts), _state_tensors(ts0)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("path", ["dense", "rows", "cols"])
def test_dropout_trains_on_every_step_path(path, monkeypatch):
    """``dropout_flag=True`` on the dense step and both sparse steps
    (``row_layout=True`` on row_packed tables, ``row_layout=False`` on
    feature-major ones): finite losses, the key advanced each step, the
    masks changed the result, and the same state and key give the same
    result again.  The dense and row steps read nothing on the host (the
    CPU plain versions of the column kernels read run lengths there)."""
    kw = {"dense": {}, "rows": {"sparse": True},
          "cols": {"sparse": True, "table_layout": "feature_major"}}[path]
    step_kw = {"row_layout": False} if path == "cols" else {}
    drop = dict(dropout_flag=True, keep_prob=0.5)

    def run(**cfg):
        *_, tm, ts, to = _setup("wd", mixed=False, **kw, **cfg)
        fn = make_train_step(tm, *to, matmul_dtype=torch.float32, **step_kw)
        keys, losses = [ts.rng.clone()], []
        for b in _batches("wd", tm, 2):
            tb = to_device(b, "cpu")
            with (_no_host_reads(monkeypatch) if path != "cols"
                  else contextlib.nullcontext()):
                ts, (_, ld) = fn(ts, tb)
            keys.append(ts.rng.clone())
            losses.append(float(ld))
        return ts, keys, losses

    ts, keys, losses = run(**drop)
    assert np.isfinite(losses).all()
    assert all(not torch.equal(a, b) for a, b in zip(keys, keys[1:]))
    again = run(**drop)[0]
    for x, y in zip(_state_tensors(ts), _state_tensors(again)):
        assert torch.equal(x, y)
    plain = run()[0]
    assert not torch.equal(ts.params["deep"]["mlp"][0]["w"],
                           plain.params["deep"]["mlp"][0]["w"])


def test_prng_keys_split_and_masks():
    """The port's keys: deterministic, split into distinct keys, masks
    kept at their rate (within 0.002 over 10^6 draws) and unlike the
    next subkey's, the same on a second draw."""
    k = prng.key(7, "cpu")
    assert torch.equal(k, prng.key(7, "cpu"))
    assert not torch.equal(k, prng.key(8, "cpu"))
    nxt, sub = prng.split(k)
    assert len({tuple(t.tolist()) for t in (k, nxt, sub)}) == 3
    m = prng.bernoulli(sub, 0.9, (1000, 1000))
    assert m.dtype == torch.bool and m.shape == (1000, 1000)
    assert abs(m.float().mean().item() - 0.9) < 2e-3
    assert torch.equal(m, prng.bernoulli(sub, 0.9, (1000, 1000)))
    other = prng.bernoulli(prng.split(nxt)[1], 0.9, (1000, 1000))
    assert 0.8 < (m == other).float().mean().item() < 0.84  # ~0.82
    h = torch.ones(4, 8, dtype=torch.bfloat16)
    out = prng.dropout(h, 0.9, sub)
    kept = prng.bernoulli(sub, 0.9, (4, 8))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out[~kept], torch.zeros_like(out[~kept]))
    # 1 / bf16(0.9) = 1 / 0.8984375, rounded to bf16
    assert (out[kept] == torch.tensor(1 / 0.8984375).to(torch.bfloat16)).all()


# ---------------------------------------------------------------------------
# DCN's one-hot lookup and max_norm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "bf16"])
def test_dcn_one_hot_forward_matches_jax(mixed):
    """The one-hot ``[B*F, padded_vocab]`` product (bf16 under mixed
    precision) gives the reference's logits (f32 rtol 1e-5; bf16 within
    the 2e-3 of the bf16 forward tests) and, in f32, the gather lookup's
    bit for bit; on a sparse table it is a ValueError."""
    jm, js, _, tm, ts, _ = _setup("dcn", mixed, use_one_hot_embeddings=True)
    b = _batches("dcn", tm, 1)[0]
    tb = to_device(b, "cpu")
    want = np.asarray(jm.apply_batch(js.params, b))
    got = tm.apply_batch(ts.params, tb)
    tol = dict(rtol=1e-5, atol=1e-6) if not mixed else dict(atol=2e-3)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    if not mixed:
        gather = dcn.DCNModel(dcn.DCNConfig(**{**DCN, "use_mixed_precision":
                                               False}))
        torch.testing.assert_close(got, gather.apply_batch(ts.params, tb),
                                   rtol=0, atol=0)
    sparse = dcn.DCNModel(dcn.DCNConfig(**{**DCN, "sparse": True,
                                           "use_one_hot_embeddings": True}))
    with pytest.raises(ValueError, match="dense table"):
        sparse.apply_batch(ts.params, tb)


def test_dcn_one_hot_dense_step_matches_jax():
    """Three float32 dense steps through the one-hot lookup (the table's
    gradient is the one-hot's transposed product): the f32 parity
    tolerances."""
    jm, js, jo, tm, ts, to = _setup("dcn", mixed=False,
                                    use_one_hot_embeddings=True)
    js, ts = _run_both(jm, js, jo, tm, ts, to, _batches("dcn", tm, 3))
    _compare(js, ts, rtol=1e-4, atol=1e-8)


@pytest.mark.parametrize("layout", ["dense", "row_packed", "feature_major"])
def test_max_norm_lookup_matches_jax(layout):
    """``lookup`` with ``max_norm`` scales each row by ``min(1, max_norm /
    max(norm, 1e-12))`` as the reference's ``EmbeddingLookup`` does, on
    every storage layout: rows with larger norms are clipped to it (a
    zero row stays zero), the rest are unchanged (rtol 1e-6)."""
    kw = dict(vocab_size=V, emb_dim=16, max_norm=0.04,
              sparse=layout != "dense",
              layout="auto" if layout == "dense" else layout)
    jspec, tspec = jemb.EmbeddingTableSpec(**kw), embedding.EmbeddingTableSpec(**kw)
    jl = jemb.EmbeddingLookup(jspec)
    table = np.asarray(jl.init(jax.random.PRNGKey(3)))
    ids = np.random.default_rng(0).integers(0, V + 1, size=(B, F)).astype(
        np.int32)  # id V is the zero dummy row
    want = np.asarray(jl(jnp.asarray(table), jnp.asarray(ids)))
    got = embedding.lookup(tspec, torch.from_numpy(np.array(table)),
                           torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)
    norms = np.linalg.norm(want, axis=-1)
    assert (norms > 0.04 * (1 - 1e-6)).any() and (norms < 0.039).any()
    assert norms.max() <= 0.04 * (1 + 1e-6)


# ---------------------------------------------------------------------------
# RecModel over a dense model
# ---------------------------------------------------------------------------


class _Record(Callback):
    def __init__(self):
        self.losses = []

    def on_train_step_end(self, ctx):
        self.losses.append(tuple(float(x) for x in ctx.net_outputs))


def test_rec_model_trains_default_dense_wd_on_cpu():
    """``RecModel(model, device="cpu")`` with a default-config W&D (dense
    tables, bf16 MLP, FTRL + dense Adam, l2 8e-5, loss scale 1024) at a
    small width: ``train`` over host batches gives the JAX ``RecModel``'s
    losses at every step (rtol 1e-5, as the mixed-precision step tests)
    and ``eval`` its AUC within 1e-3."""
    cfg = dict(batch_size=B, field_size=F, vocab_size=V, emb_dim=8,
               deep_layer_dim=(16, 8))
    tm = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**cfg))
    jm = jwd.WideDeepModel(jwd.WideDeepConfig(**cfg))
    assert not tm.config.sparse and tm.config.use_mixed_precision
    rm = RecModel(tm, device="cpu")
    jrm = jrec.RecModel(jm)
    host = jax.tree.map(np.asarray, (jrm.state.params, jrm.state.opt_w,
                                     jrm.state.opt_d))
    rm.state = convert.state_from_jax(*host, np.asarray(jrm.state.step),
                                      device="cpu")
    data = SyntheticCriteo(B, F, V, seed=21)
    train = [data.get_batch(i) for i in range(4)]
    held = [data.get_batch(i) for i in range(4, 7)]
    rec, jrec_ = _Record(), _Record()
    state = rm.train(1, train, callbacks=[rec])
    jrm.train(1, train, callbacks=[jrec_], dataset_sink_mode=False)
    assert int(state.step) == 4
    np.testing.assert_allclose(rec.losses, jrec_.losses, rtol=1e-5)
    got, want = rm.eval(held)["auc"], jrm.eval(held)["auc"]
    assert 0.0 < got < 1.0 and abs(got - want) <= 1e-3
