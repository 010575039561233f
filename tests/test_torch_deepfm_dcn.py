"""The port's DeepFM and DCN (models, state conversion, and the sparse
step on their default row_packed tables) against the JAX package on the
same inputs.

State is made once in JAX and carried into the port by
``convert.state_from_jax``.  The JAX step runs the streamed Pallas path
in interpret mode (``use_pallas=True``), as the other parity tests do.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindrec_tpu.models import dcn as jdcn
from mindrec_tpu.models import deepfm as jdeepfm
from mindrec_tpu.ops.pallas import stream_update
from mindrec_tpu.train import optim as jopt
from mindrec_tpu.train import step as jstep
from mindrec_tpu_torch import convert
from mindrec_tpu_torch.data.criteo import SyntheticCriteo, to_device
from mindrec_tpu_torch.models import dcn, deepfm
from mindrec_tpu_torch.train import optim
from mindrec_tpu_torch.train.step import (
    CapturedStep, make_batch_sort, make_eval_step, make_train_step,
    param_keys,
)

B, F, V = 64, 4, 4000
FM = dict(batch_size=B, field_size=F, vocab_size=V, emb_dim=20,
          deep_layer_dim=(32, 16), loss_scale=1024.0)
# emb 7 packs 16 logical rows into a storage row with 16 unused lanes
DCN = dict(batch_size=B, field_size=F, vocab_size=V, emb_dim=7,
           deep_layer_dim=(32, 32), cross_layer_num=3, loss_scale=1024.0)
MODELS = {
    "deepfm": (jdeepfm.DeepFMModel, jdeepfm.DeepFMConfig,
               deepfm.DeepFMModel, deepfm.DeepFMConfig, FM),
    "dcn": (jdcn.DCNModel, jdcn.DCNConfig, dcn.DCNModel, dcn.DCNConfig, DCN),
}


@pytest.fixture(autouse=True)
def _interpret_kernels():
    stream_update.INTERPRET = True
    yield
    stream_update.INTERPRET = False


def _adam(mod, dtypes, state_dtype, **kw):
    return mod.adam(loss_scale=1024.0,
                    state_dtype=getattr(dtypes, state_dtype), **kw)


def _setup(which, mixed=False, state_dtype="float32", **cfg_kw):
    """(jax model, jax state, jax opts, port model, port state, port opts)
    from one JAX init; one Adam on both sides of the split, as the bench
    recipes build it."""
    jcls, jcfg, tcls, tcfg, base = MODELS[which]
    kw = {**base, "use_mixed_precision": mixed, "sparse": True, **cfg_kw}
    jm, tm = jcls(jcfg(**kw)), tcls(tcfg(**kw))
    lr = dict(learning_rate=5e-4, eps=5e-8)
    jo = (_adam(jopt, jnp, state_dtype, **lr), _adam(jopt, jnp, state_dtype, **lr))
    to = (_adam(optim, torch, state_dtype, **lr),
          _adam(optim, torch, state_dtype, **lr))
    js = jstep.init_train_state(jm, jax.random.PRNGKey(0), *jo)
    host = jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d))
    ts = convert.state_from_jax(*host, np.asarray(js.step), device="cpu")
    return jm, js, jo, tm, ts, to


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x, np.float32))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _compare(js, ts, rtol, atol, only=None):
    ref = _leaves(jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d)))
    got = _leaves(convert.state_to_jax(ts)[:3])
    assert [k for k, _ in ref] == [k for k, _ in got]
    for (k, a), (_, b) in zip(ref, got):
        if only is None or any(s in k for s in only):
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("which", ["deepfm", "dcn"])
def test_config_and_specs_match_reference(which):
    """The configs have the reference's fields and defaults; the tables
    have its names, paths and storage shapes, at the defaults (dense) and
    at the sparse bench recipes (DeepFM emb 80 -> pack 1, DCN emb 27 ->
    pack 4)."""
    jcls, jcfg, tcls, tcfg, _ = MODELS[which]
    mine = {f.name: f.default for f in dataclasses.fields(tcfg)}
    ref = {f.name: f.default for f in dataclasses.fields(jcfg)}
    assert mine == ref
    for kw in ({}, {"sparse": True}):
        jm, tm = jcls(jcfg(**kw)), tcls(tcfg(**kw))
        assert list(tm.table_specs) == list(jm.table_specs)
        for name, (path, spec) in tm.table_specs.items():
            jpath, jspec = jm.table_specs[name]
            assert path == jpath
            assert spec.storage_shape == jspec.storage_shape
            assert (spec.row_packed, spec.pack, spec.fold) == (
                jspec.row_packed, jspec.pack, jspec.fold)
        assert tm.mlp_dims == jm.mlp_dims and tm.WIDE_KEYS == jm.WIDE_KEYS
    sparse = tcls(tcfg(sparse=True))
    packs = {n: s.pack for n, (_, s) in sparse.table_specs.items()}
    assert packs == ({"linear": 128, "fm": 1} if which == "deepfm"
                     else {"emb": 4})


def test_deepfm_feature_major_recipe_shapes():
    """The published recipe with ``table_layout="feature_major"``: fm
    [80, 188416], linear folded 8 ways into [8, 23552]."""
    m = deepfm.DeepFMModel(deepfm.DeepFMConfig(
        sparse=True, table_layout="feature_major"))
    assert m.v_spec.storage_shape == (80, 188416) and m.v_spec.fold == 1
    assert m.w_spec.storage_shape == (8, 23552) and m.w_spec.fold == 8


@pytest.mark.parametrize("which,sparse", [
    ("deepfm", True), ("deepfm", False), ("dcn", True), ("dcn", False),
])
def test_forward_and_loss_match_jax(which, sparse):
    """apply_rows on the same rows and the loss (DeepFM adds the tables'
    l2 term when not sparse): float32, rtol 1e-5 (other summation orders
    in the matmuls and reductions)."""
    jm, js, _, tm, ts, _ = _setup(which, sparse=sparse)
    rng = np.random.default_rng(0)
    wts = rng.uniform(size=(B, F)).astype(np.float32)
    label = (rng.uniform(size=(B, 1)) > 0.5).astype(np.float32)
    rows = {name: rng.normal(size=(B, F, spec.emb_dim)).astype(np.float32)
            for name, (_, spec) in tm.table_specs.items()}
    jl = jm.apply_rows(js.params, rows, wts)
    tl = tm.apply_rows(ts.params,
                       {k: torch.from_numpy(v) for k, v in rows.items()},
                       torch.from_numpy(wts))
    assert tl.shape == (B, 1) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)
    jloss = jm.loss(js.params, jl, label)
    tloss = tm.loss(ts.params, tl, torch.from_numpy(label))
    np.testing.assert_allclose([float(x) for x in tloss],
                               [float(x) for x in jloss], rtol=1e-5)
    assert param_keys(ts.params) == jstep.param_keys(js.params)


@pytest.mark.parametrize("which,layout", [
    ("deepfm", "auto"), ("deepfm", "feature_major"), ("dcn", "auto"),
])
def test_apply_and_predict_match_jax(which, layout):
    """apply / predict / predict_batch with the lookups inside, on
    row_packed and (DeepFM) feature-major storage; and the eval step."""
    kw = {"table_layout": layout} if which == "deepfm" else {}
    jm, js, _, tm, ts, _ = _setup(which, **kw)
    b = SyntheticCriteo(B, F, V, seed=4).get_batch(0)
    tb = to_device(b, "cpu")
    jl = jm.apply(js.params, b["ids"], b["wts"])
    tl = tm.apply(ts.params, tb["ids"], tb["wts"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tm.apply_batch(ts.params, tb).numpy(),
                               tl.numpy(), rtol=0, atol=0)
    jp = jm.predict(js.params, b["ids"], b["wts"])
    tp, lab = make_eval_step(tm)(ts.params, tb)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(lab.numpy(), b["label"])


def test_deepfm_mixed_precision_forward_matches_jax():
    """bf16 rows and a bf16 tower: the FM reductions are float32 on both
    sides; the logits agree to a few bf16 ulps of the tower's sums."""
    jm, js, _, tm, ts, _ = _setup("deepfm", mixed=True)
    rng = np.random.default_rng(1)
    wts = np.ones((B, F), np.float32)
    rows = {"linear": rng.normal(size=(B, F, 1)).astype(np.float32) * 0.1,
            "fm": rng.normal(size=(B, F, 20)).astype(np.float32) * 0.1}
    jl = jm.apply_rows(js.params,
                       {k: jnp.asarray(v).astype(jnp.bfloat16)
                        for k, v in rows.items()}, wts)
    tl = tm.apply_rows(ts.params,
                       {k: torch.from_numpy(v).to(torch.bfloat16)
                        for k, v in rows.items()}, torch.from_numpy(wts))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-3)


def test_dcn_cross_layer_and_one_hot():
    """One cross layer equals ``x0 * (x0 @ w) + b + x0`` and the chain
    equals the reference's; the one-hot lookup on the dense table gives
    the gather lookup's rows, in float32 bit for bit."""
    jm, js, _, tm, ts, _ = _setup("dcn", sparse=False)
    x0 = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, tm.input_size)).astype(np.float32))
    layer = ts.params["cross"][0]
    want = x0 * (x0 @ layer["w"])[:, None] + layer["b"][None, :] + x0
    torch.testing.assert_close(tm._cross_net(ts.params["cross"][:1], x0), want)
    np.testing.assert_allclose(
        tm._cross_net(ts.params["cross"], x0).numpy(),
        np.asarray(jm._cross_net(js.params["cross"], jnp.asarray(x0.numpy()))),
        rtol=1e-5, atol=1e-7)
    one_hot = dcn.DCNModel(dcn.DCNConfig(**{**DCN,
                                           "use_one_hot_embeddings": True}))
    b = to_device(SyntheticCriteo(B, F, V, seed=4).get_batch(0), "cpu")
    torch.testing.assert_close(one_hot.apply_batch(ts.params, b),
                               tm.apply_batch(ts.params, b), rtol=0, atol=0)


@pytest.mark.parametrize("make", [
    lambda: deepfm.DeepFMModel(deepfm.DeepFMConfig(
        table_slice_mode="table_row_slice")),
    lambda: dcn.DCNModel(dcn.DCNConfig(table_slice_mode="table_row_slice")),
], ids=["deepfm_sliced", "dcn_sliced"])
def test_unported_options_raise(make):
    """Sliced tables are ported: the models build (the sliced table
    feature-major, its partition spec naming the model axis) and train
    on a mesh (``tests/test_torch_parallel.py``), captured too
    (``jit=True`` builds a ``CapturedStep``, cut at every collective)."""
    from mindrec_tpu_torch.parallel.mesh import Mesh

    model = make()
    (name, (_path, spec)), = [(n, ps) for n, ps in model.table_specs.items()
                              if ps[1].slice_mode != "none"]
    assert "model" in spec.partition_spec()
    model.mesh = Mesh(2, 1)
    step = make_train_step(model, optim.ftrl(), optim.adam(), jit=True)
    assert isinstance(step, CapturedStep)


@pytest.mark.parametrize("which", ["deepfm", "dcn"])
def test_convert_round_trip(which):
    """Parameters and optimizer state (bf16 m/v on the tables) go to the
    port and back bit for bit, row_packed and feature-major."""
    kws = [{}] + ([{"table_layout": "feature_major"}]
                  if which == "deepfm" else [])
    for kw in kws:
        _, js, _, _, ts, _ = _setup(which, state_dtype="bfloat16", **kw)
        key = "fm/table" if which == "deepfm" else "emb/table"
        assert ts.opt_w == {} and ts.opt_d[key]["m"].dtype == torch.bfloat16
        back = convert.state_to_jax(ts)
        ref = jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d))
        for x, y in zip(jax.tree.leaves(back[:3]), jax.tree.leaves(ref)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("which,prep", [
    ("deepfm", "device_sort"), ("deepfm", "host_minimal"),
    ("dcn", "device_sort"), ("dcn", "host_minimal"),
])
def test_default_path_step_matches_jax_f32(which, prep):
    """Three float32 steps on the default row_packed tables
    (``row_layout=True``; DeepFM linear pack 128 and fm pack 4, DCN pack
    16), Adam on the packed tables: losses within rtol 1e-5, every
    parameter and optimizer leaf within rtol 1e-4 / atol 1e-8 (the
    tolerances of the Wide&Deep parity test, for the same reasons)."""
    jm, js, jo, tm, ts, to = _setup(which)
    j_fn = jstep.make_train_step(jm, *jo, jit=True, donate=False,
                                 use_pallas=True, matmul_dtype=jnp.float32)
    t_fn = make_train_step(tm, *to, matmul_dtype=torch.float32)
    prep_fn = None if prep == "device_sort" else make_batch_sort(F, minimal=True)
    data = SyntheticCriteo(B, F, V, seed=3)
    for i in range(3):
        b = data.get_batch(i)
        js, (jlw, jld) = j_fn(js, b)
        ts, (tlw, tld) = t_fn(ts, to_device(prep_fn(b) if prep_fn else b, "cpu"))
        np.testing.assert_allclose(float(tlw), float(jlw), rtol=1e-5)
        np.testing.assert_allclose(float(tld), float(jld), rtol=1e-5)
    assert int(ts.step) == 3
    _compare(js, ts, rtol=1e-4, atol=1e-8)


@pytest.mark.parametrize("which", ["deepfm", "dcn"])
def test_default_path_step_matches_jax_mixed_precision(which):
    """The bench recipes' precision: bf16 tower, bf16 rows and gradients,
    bf16 Adam moments, explicit bucket.  Losses agree to rtol 1e-5 (DCN's
    cross chain is float32 on both sides); table weights to atol 7.5e-5
    (a seventh of one Adam step of 5e-4, the Wide&Deep test's share),
    dense weights to 1.5e-4 (a tenth of the three steps' travel: Adam
    divides by sqrt(v), so a bf16 bias gradient that sums to almost
    nothing moves its weight a good part of a step either way) and the tables' moments to rtol 2e-2, as
    in the Wide&Deep mixed-precision test: XLA and PyTorch reduce the
    bf16 gradient sums in other orders and the reference rounds each
    summed table gradient to bf16 where the port keeps float32.  The
    absolute floor is 1e-6 for v and 1e-5 for m (1% of a typical moment
    of 1e-3): a summed gradient whose terms nearly cancel keeps the bf16
    rounding of its terms."""
    jm, js, jo, tm, ts, to = _setup(which, mixed=True, state_dtype="bfloat16")
    j_fn = jstep.make_train_step(jm, *jo, jit=True, donate=False,
                                 use_pallas=True, unique_bucket=2048)
    t_fn = make_train_step(tm, *to, unique_bucket=2048)
    data = SyntheticCriteo(B, F, V, seed=3)
    for i in range(3):
        b = data.get_batch(i)
        js, (_, jld) = j_fn(js, b)
        ts, (_, tld) = t_fn(ts, to_device(b, "cpu"))
        np.testing.assert_allclose(float(tld), float(jld), rtol=1e-5)
    _compare(js, ts, rtol=0, atol=7.5e-5, only=["['table']"])
    _compare(js, ts, rtol=0, atol=1.5e-4, only=["['w']", "['b']"])
    _compare(js, ts, rtol=2e-2, atol=1e-5, only=["table']['m']"])
    _compare(js, ts, rtol=2e-2, atol=1e-6, only=["table']['v']"])
