"""The port's generic sparse step (``make_train_step(use_pallas=False)``)
against the JAX package's generic path (``use_pallas=False``) on the
same inputs, for every model the reference's generic path trains on one
device: Wide&Deep on row_packed and feature-major tables, DeepFM, DCN
and the multitable model, with FTRL at ``lr_power`` -0.5 and -0.7.

State is made once in JAX and carried into the port by
``convert.state_from_jax``.  Both sides run float32 models
(``use_mixed_precision=False``) for three steps; the losses agree within
rtol 1e-5, and every parameter and optimizer leaf within rtol 1e-5 /
atol 1e-7 (the same float32 arithmetic, the MLP's products and the
per-id gradient sums added in other orders).  Also here: ``donate=False``
and the reference's fault at ``ADVICE.md:3`` (its fill row is a live
storage row at ``vocab_size = 2048 * pack - 8``), held against a float64
numpy oracle instead of the reference.

bf16 tables are not held to the reference here: its generic path
differentiates the bf16 rows and sums their gradients in bf16
(``jax.ops.segment_sum`` keeps the dtype), the port in float32, so after
one step the tables differ by a bf16 rounding of the sums and the dense
updates drift apart from there, beyond one bf16 ulp; the port's bf16
tables are held by the streamed paths' tests and on the card.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindrec_tpu.models import dcn as jdcn
from mindrec_tpu.models import deepfm as jdeepfm
from mindrec_tpu.models import multitable as jmt
from mindrec_tpu.models import wide_deep as jwd
from mindrec_tpu.train import optim as jopt
from mindrec_tpu.train import step as jstep
from mindrec_tpu_torch import convert
from mindrec_tpu_torch.data.criteo import SyntheticCriteo, to_device
from mindrec_tpu_torch.data.outbrain import SyntheticOutbrain
from mindrec_tpu_torch.models import dcn, deepfm, multitable, wide_deep
from mindrec_tpu_torch.ops.embedding import from_storage
from mindrec_tpu_torch.train import optim
from mindrec_tpu_torch.train.step import _leaves as leaves_of
from mindrec_tpu_torch.train.step import make_train_step

B, F, V = 64, 4, 4000
CRITEO = dict(batch_size=B, field_size=F, vocab_size=V, loss_scale=1024.0,
              sparse=True, use_mixed_precision=False)
MODELS = {
    "wide_deep": (jwd.WideDeepModel, jwd.WideDeepConfig, wide_deep.WideDeepModel,
                  wide_deep.WideDeepConfig,
                  dict(CRITEO, emb_dim=16, deep_layer_dim=(32, 32))),
    "wide_deep_fm_layout": (
        jwd.WideDeepModel, jwd.WideDeepConfig, wide_deep.WideDeepModel,
        wide_deep.WideDeepConfig,
        dict(CRITEO, emb_dim=16, deep_layer_dim=(32, 32),
             table_layout="feature_major")),
    "deepfm": (jdeepfm.DeepFMModel, jdeepfm.DeepFMConfig, deepfm.DeepFMModel,
               deepfm.DeepFMConfig,
               dict(CRITEO, emb_dim=20, deep_layer_dim=(32, 16))),
    "dcn": (jdcn.DCNModel, jdcn.DCNConfig, dcn.DCNModel, dcn.DCNConfig,
            dict(CRITEO, emb_dim=7, deep_layer_dim=(32, 32),
                 cross_layer_num=3)),
    "multitable": (
        jmt.MultiTableWideDeepModel, jmt.MultiTableConfig,
        multitable.MultiTableWideDeepModel, multitable.MultiTableConfig,
        dict(batch_size=32, continue_field_size=4, indicator_field_size=2,
             emb128_field_size=2, emb64_single_field_size=2,
             multi_hot_sizes=(3, 4, 3, 2, 2, 3), emb_128_size=3000,
             emb64_single_size=50, emb64_multi_size=2500, indicator_size=16,
             deep_layer_dim=(32, 16), loss_scale=1000.0, sparse=True,
             use_mixed_precision=False)),
}


def _opts(mod, dtypes, lr_power, loss_scale):
    """FTRL (at ``lr_power``) on the wide side, LazyAdam on the deep."""
    return (mod.ftrl(learning_rate=5e-2, l1=5e-4, l2=5e-4, initial_accum=0.1,
                     lr_power=lr_power, loss_scale=loss_scale),
            mod.lazy_adam(learning_rate=1e-3, eps=1e-6, loss_scale=loss_scale,
                          state_dtype=dtypes.float32))


def _setup(which, lr_power=-0.5, **cfg_kw):
    jcls, jcfg, tcls, tcfg, base = MODELS[which]
    kw = {**base, **cfg_kw}
    jm, tm = jcls(jcfg(**kw)), tcls(tcfg(**kw))
    ls = kw["loss_scale"]
    jo, to = _opts(jopt, jnp, lr_power, ls), _opts(optim, torch, lr_power, ls)
    if which in ("deepfm", "dcn"):  # no wide keys: FTRL on the deep side
        jo, to = jo[::-1], to[::-1]
    js = jstep.init_train_state(jm, jax.random.PRNGKey(0), *jo)
    host = jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d))
    ts = convert.state_from_jax(*host, np.asarray(js.step), device="cpu")
    return jm, js, jo, tm, ts, to


def _batches(which, n, seed=3):
    kw = MODELS[which][4]
    if which == "multitable":
        return list(SyntheticOutbrain(multitable.MultiTableConfig(**kw), n,
                                      seed=seed))
    data = SyntheticCriteo(kw["batch_size"], kw["field_size"], kw["vocab_size"],
                           seed=seed)
    return [data.get_batch(i) for i in range(n)]


def _flat(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x, np.float32))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _compare(js, ts, rtol=1e-5, atol=1e-7):
    ref = _flat(jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d)))
    got = _flat(convert.state_to_jax(ts)[:3])
    assert [k for k, _ in ref] == [k for k, _ in got]
    for (k, a), (_, b) in zip(ref, got):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=k)


def _run(which, lr_power, steps=3, **step_kw):
    jm, js, jo, tm, ts, to = _setup(which, lr_power)
    j_fn = jstep.make_train_step(jm, *jo, jit=True, donate=False,
                                 use_pallas=False)
    t_fn = make_train_step(tm, *to, use_pallas=False, **step_kw)
    for b in _batches(which, steps):
        js, (jlw, jld) = j_fn(js, b)
        ts, (tlw, tld) = t_fn(ts, to_device(b, "cpu"))
        np.testing.assert_allclose(float(tlw), float(jlw), rtol=1e-5)
        np.testing.assert_allclose(float(tld), float(jld), rtol=1e-5)
    assert int(ts.step) == steps
    return js, ts


@pytest.mark.parametrize("lr_power", [-0.5, -0.7])
@pytest.mark.parametrize("which", list(MODELS))
def test_generic_step_matches_reference(which, lr_power):
    js, ts = _run(which, lr_power)
    _compare(js, ts)


def test_generic_step_captures_on_cpu_as_eager():
    """``jit=True`` on a CPU state is the eager step: equal bit for bit."""
    _jm, _js, _jo, tm, ts, to = _setup("wide_deep")
    ts2 = convert.state_from_jax(*convert.state_to_jax(ts), device="cpu")
    a = make_train_step(tm, *to, use_pallas=False)
    b = make_train_step(tm, *to, use_pallas=False, jit=True)
    for batch in _batches("wide_deep", 2):
        ts, la = a(ts, to_device(batch, "cpu"))
        ts2, lb = b(ts2, to_device(batch, "cpu"))
        assert float(la[1]) == float(lb[1])
    for (_, x), (_, y) in zip(leaves_of(ts), leaves_of(ts2)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("use_pallas", [False, None])
def test_donate_false_keeps_the_state(use_pallas, jit):
    """``donate=False`` leaves the state passed in bit for bit as it was,
    and its result equals the donating step's."""
    _jm, _js, _jo, tm, ts, to = _setup("wide_deep")
    keep = convert.state_to_jax(ts)
    nd = make_train_step(tm, *to, use_pallas=use_pallas, donate=False, jit=jit)
    d = make_train_step(tm, *to, use_pallas=use_pallas)
    batch = to_device(_batches("wide_deep", 1)[0], "cpu")
    out, (_, l1) = nd(ts, batch)
    for (_, x), (_, y) in zip(_flat(keep), _flat(convert.state_to_jax(ts))):
        np.testing.assert_array_equal(x, y)
    ref, (_, l2) = d(ts, batch)
    assert float(l1) == float(l2)
    for (_, x), (_, y) in zip(leaves_of(out), leaves_of(ref)):
        assert torch.equal(x, y)


def test_row_layout_false_on_packed_tables_warns_and_matches():
    """``row_layout=False`` on row_packed tables falls back to the generic
    path with the reference's warning, and trains as ``use_pallas=False``
    does."""
    _jm, _js, _jo, tm, ts, to = _setup("deepfm")
    ts2 = convert.state_from_jax(*convert.state_to_jax(ts), device="cpu")
    with pytest.warns(UserWarning, match="falling back to the generic path"):
        a = make_train_step(tm, *to, row_layout=False)
    b = make_train_step(tm, *to, use_pallas=False)
    for batch in _batches("deepfm", 2):
        ts, la = a(ts, to_device(batch, "cpu"))
        ts2, lb = b(ts2, to_device(batch, "cpu"))
        assert float(la[1]) == float(lb[1])
    for (_, x), (_, y) in zip(leaves_of(ts), leaves_of(ts2)):
        assert torch.equal(x, y)


def test_streamed_branches_raise_on_lr_power_naming_the_generic_path():
    _jm, _js, _jo, tm, _ts, to = _setup("wide_deep", lr_power=-0.7)
    with pytest.raises(NotImplementedError, match="use_pallas=False"):
        make_train_step(tm, *to)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        make_train_step(tm, *to, use_pallas=False)


def _logical(spec, table):
    return from_storage(spec, table).double().numpy()


def test_fill_row_update_lands_advice_3():
    """``vocab_size = 2048 * 16 - 8`` with emb 8 (pack 16): the deep
    table's last storage row 2047 holds trainable ids 32752-32759 and is
    the reference's fill row.  One LazyAdam step touching id 32752: the
    reference drops its update (the fault); the port's table and moments
    equal a float64 numpy LazyAdam of the same gradients within rtol 1e-5
    (float32 arithmetic), and every untouched row keeps its bits.  The
    gradients are the port's own autograd of the model through its
    lookups, independent of the step's unique and segment-sum code."""
    vocab = 2048 * 16 - 8
    kw = dict(CRITEO, vocab_size=vocab, emb_dim=8, deep_layer_dim=(16,))
    jm, tm = jwd.WideDeepModel(jwd.WideDeepConfig(**kw)), \
        wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**kw))
    spec = tm.deep_spec
    assert spec.pack == 16 and spec.packed_rows == 2048
    jo, to = _opts(jopt, jnp, -0.5, 1024.0), _opts(optim, torch, -0.5, 1024.0)
    js = jstep.init_train_state(jm, jax.random.PRNGKey(0), *jo)
    host = jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d))
    ts = convert.state_from_jax(*host, np.asarray(js.step), device="cpu")
    b = SyntheticCriteo(B, F, vocab, seed=4).get_batch(0)
    b["ids"][:3, 0] = [32752, 32759, 32752]
    batch = to_device(b, "cpu")
    table0 = ts.params["deep"]["table"].clone()

    # float64 oracle of one LazyAdam step from autograd gradients
    params = {k: v for k, v in ts.params.items()}
    full = from_storage(spec, table0).requires_grad_(True)
    wide = from_storage(tm.wide_spec, ts.params["wide"]["table"])
    ids = batch["ids"].long()
    rows = {"wide": wide[ids], "deep": full[ids]}
    logits = tm.apply_rows(params, rows, batch["wts"])
    _lw, ld = tm.loss(params, logits, batch["label"])
    (g,) = torch.autograd.grad(ld * 1024.0, full)
    g64 = g.double().numpy() / 1024.0
    touched = np.zeros(spec.padded_vocab, bool)
    touched[np.unique(b["ids"])] = True
    b1, b2, lr, eps = 0.9, 0.999, 1e-3, 1e-6
    m = (1 - b1) * g64
    v = (1 - b2) * g64 * g64
    lr_t = lr * np.sqrt(1 - b2) / (1 - b1)
    w0 = _logical(spec, table0)
    want = np.where(touched[:, None], w0 - lr_t * m / (np.sqrt(v) + eps), w0)

    fn = make_train_step(tm, *to, use_pallas=False)
    ts, _ = fn(ts, batch)
    got = _logical(spec, ts.params["deep"]["table"])
    assert not np.array_equal(got[32752], w0[32752])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    np.testing.assert_array_equal(got[~touched], w0[~touched])
    np.testing.assert_allclose(
        _logical(spec, ts.opt_d["deep/table"]["m"]),
        np.where(touched[:, None], m, 0.0), rtol=1e-5, atol=1e-12)

    j_fn = jstep.make_train_step(jm, *jo, jit=True, donate=False,
                                 use_pallas=False)
    js, _ = j_fn(js, b)
    ref = np.asarray(js.params["deep"]["table"], np.float64)
    assert np.array_equal(ref[2047, :8], w0[32752])  # the reference's drop


def _to_layout(state, src, dst):
    """A state of model ``src`` carried to model ``dst`` (the same model
    with other table layouts): every table and every table-shaped
    optimizer leaf through the logical ``[padded_vocab, emb_dim]`` rows
    (``from_storage`` / ``to_storage``); the rest is shared."""
    from mindrec_tpu_torch.ops.embedding import to_storage

    params = {k: dict(v) for k, v in state.params.items()}
    opt_w, opt_d = dict(state.opt_w), dict(state.opt_d)
    for name, (path, s_spec) in src.table_specs.items():
        d_spec = dst.table_specs[name][1]
        key = "/".join(path)

        def conv(x):
            return to_storage(d_spec, from_storage(s_spec, x)).contiguous()

        params[path[0]][path[1]] = conv(params[path[0]][path[1]])
        opts = opt_w if key in opt_w else opt_d
        opts[key] = {k: conv(v) if v.dim() == 2 else v
                     for k, v in opts[key].items()}
    return state._replace(params=params, opt_w=opt_w, opt_d=opt_d)


def test_plain_specs_match_feature_major_oracle_fault_9():
    """``dynamic_embedding=True`` with ``sparse=False`` (the reference's
    ``run_dynamic_embedding_train.sh`` with ``wide_deep_config.yaml``)
    gives plain row-major specs, which the sparse step trains on the
    generic path.  The reference takes their columns
    (``jnp.take(table, cols, axis=1)``) and trains NaN with no row
    changed (section 3, reference fault 9).  The port takes their rows:
    three steps equal the same model on feature-major tables
    (``sparse=True``, the generic path, tables carried over by the
    layout helpers): losses within rtol 1e-6, the tables and their
    optimizer state within rtol 1e-5 / atol 1e-7 (per-id sums of the same
    float32 gradients in another order)."""
    from mindrec_tpu_torch.train.step import init_train_state

    kw = dict(batch_size=8, field_size=4, vocab_size=1000, emb_dim=8,
              deep_layer_dim=(16,), dynamic_embedding=True, loss_scale=1024.0,
              use_mixed_precision=False)
    plain = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**kw))
    fm = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(
        **kw, sparse=True, table_layout="feature_major"))
    assert not plain.deep_spec.sparse and fm.deep_spec.feature_major
    to = _opts(optim, torch, -0.5, 1024.0)
    ts = init_train_state(plain, 0, *to, device="cpu")
    ts_fm = _to_layout(ts, plain, fm)
    deep0 = ts.params["deep"]["table"].clone()
    a = make_train_step(plain, *to)
    assert a.__name__ == "step_generic"
    b = make_train_step(fm, *to, use_pallas=False)
    data = SyntheticCriteo(8, 4, 1000, seed=7)
    for i in range(3):
        batch = to_device(data.get_batch(i), "cpu")
        ts, (_, la) = a(ts, batch)
        ts_fm, (_, lb) = b(ts_fm, batch)
        assert np.isfinite(float(la))
        np.testing.assert_allclose(float(la), float(lb), rtol=1e-6)
    back = _to_layout(ts_fm, fm, plain)
    for (k, x), (_, y) in zip(_flat(convert.state_to_jax(ts)[:3]),
                              _flat(convert.state_to_jax(back)[:3])):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-7, err_msg=k)
    changed = (ts.params["deep"]["table"] != deep0).any(dim=1)
    assert int(changed.sum()) > 0

    jm = jwd.WideDeepModel(jwd.WideDeepConfig(**kw))
    jo = _opts(jopt, jnp, -0.5, 1024.0)
    js = jstep.init_train_state(jm, jax.random.PRNGKey(0), *jo)
    j_fn = jstep.make_train_step(jm, *jo, jit=True, donate=False,
                                 use_pallas=False)
    jdeep0 = np.asarray(js.params["deep"]["table"])
    js, (_, jld) = j_fn(js, data.get_batch(0))
    assert np.isnan(float(jld))
    assert np.array_equal(np.asarray(js.params["deep"]["table"]), jdeep0)
