"""The port's multitable Wide&Deep step (several id groups, feature-major
tables, the tiny-vocab path) and the modules it runs, against the JAX
package on the same inputs.

The JAX side runs the streamed Pallas path (``use_pallas=True``,
``row_layout=True``) in interpret mode.  State is made once in JAX and
carried into the port by ``convert.state_from_jax``.  The small config
keeps two groups tiny (indicator, emb64_single: the sort-free path with
presence counts) and two sorted (emb128 at buffer width 256, multi).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindrec_tpu.data import outbrain as joutbrain
from mindrec_tpu.models import multitable as jmt
from mindrec_tpu.models import wide_deep as jwd
from mindrec_tpu.ops.pallas import stream_update
from mindrec_tpu.train import optim as jopt
from mindrec_tpu.train import step as jstep
from mindrec_tpu_torch import convert
from mindrec_tpu_torch.data.criteo import SyntheticCriteo
from mindrec_tpu_torch.data.outbrain import SyntheticOutbrain, to_device
from mindrec_tpu_torch.models import multitable, wide_deep
from mindrec_tpu_torch.ops.embedding import from_storage
from mindrec_tpu_torch.train import optim
from mindrec_tpu_torch.train.step import (
    BucketOverflow, make_batch_sort, make_eval_step, make_train_step,
    param_keys, prep_groups,
)

KW = dict(
    batch_size=32, continue_field_size=4, indicator_field_size=2,
    emb128_field_size=2, emb64_single_field_size=2,
    multi_hot_sizes=(3, 4, 3, 2, 2, 3), emb_128_size=3000,
    emb64_single_size=50, emb64_multi_size=2500, indicator_size=16,
    deep_layer_dim=(32, 16), loss_scale=1000.0, sparse=True,
)
FTRL = dict(learning_rate=5e-2, l1=5e-4, l2=5e-4, initial_accum=0.1,
            loss_scale=1000.0)
ADAM = dict(learning_rate=1e-3, eps=1e-6, loss_scale=1000.0)


@pytest.fixture(autouse=True)
def _interpret_kernels():
    stream_update.INTERPRET = True
    try:
        yield
    finally:
        stream_update.INTERPRET = False


def _setup(mixed=False, **cfg_kw):
    kw = {**KW, "use_mixed_precision": mixed, **cfg_kw}
    jm = jmt.MultiTableWideDeepModel(jmt.MultiTableConfig(**kw))
    tm = multitable.MultiTableWideDeepModel(multitable.MultiTableConfig(**kw))
    jo = (jopt.ftrl(**FTRL), jopt.lazy_adam(**ADAM))
    to = (optim.ftrl(**FTRL), optim.lazy_adam(**ADAM))
    js = jstep.init_train_state(jm, jax.random.PRNGKey(0), *jo)
    host = jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d))
    ts = convert.state_from_jax(*host, np.asarray(js.step), device="cpu")
    return jm, js, jo, tm, ts, to


def _batches(n, seed=0, pad_masked=False, **cfg_kw):
    """SyntheticOutbrain batches; ``pad_masked`` writes the padding id 0
    into masked multi-hot slots (the usual padding convention)."""
    cfg = multitable.MultiTableConfig(**{**KW, **cfg_kw})
    out = []
    for b in SyntheticOutbrain(cfg, n, seed=seed):
        if pad_masked:
            for name in multitable.MULTI_FIELDS:
                b[f"multi_{name}_id"][b[f"multi_{name}_mask"] == 0] = 0
        out.append(b)
    return out


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x, np.float32))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _compare(js, ts, rtol, atol, only=None, of_max=0.0):
    """Every leaf of params and optimizer state (or those whose key holds
    one of ``only``); ``of_max`` adds ``of_max * max|leaf|`` to atol."""
    ref = _leaves(jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d)))
    got = _leaves(convert.state_to_jax(ts)[:3])
    assert [k for k, _ in ref] == [k for k, _ in got]
    for (k, a), (_, b) in zip(ref, got):
        if only is not None and not any(s in k for s in only):
            continue
        np.testing.assert_allclose(b, a, rtol=rtol, err_msg=k,
                                   atol=atol + of_max * np.abs(a).max())


@pytest.mark.parametrize("prep", ["device_meta", "host_prep", "compacted"])
def test_multitable_step_matches_jax_f32(prep):
    """Three float32 steps of the multi-group step.  Losses within rtol
    1e-5; every parameter and optimizer leaf within rtol 1e-4 / atol 1e-7
    (XLA and PyTorch sum the MLP's products and the batch means in other
    orders, ~1e-7 relative, which Adam's m/sqrt(v) can amplify a
    little).  Compacted prep (kept_budget) gives both sides the same
    compacted stream, so they agree on the padding row too."""
    jm, js, jo, tm, ts, to = _setup()
    j_fn = jstep.make_train_step(jm, *jo, jit=True, donate=False,
                                 use_pallas=True, row_layout=True,
                                 matmul_dtype=jnp.float32)
    t_fn = make_train_step(tm, *to, matmul_dtype=torch.float32)
    if prep == "host_prep":
        prep_fn = make_batch_sort(0, groups=tm.table_groups)
    elif prep == "compacted":
        prep_fn = make_batch_sort(0, groups=prep_groups(tm), minimal=True,
                                  kept_budget={"multi": 512})
    else:
        prep_fn = None
    for b in _batches(3, seed=1, pad_masked=prep == "compacted"):
        if prep_fn is not None:
            b = prep_fn(b)
        js, (jlw, jld) = j_fn(js, b)
        ts, (tlw, tld) = t_fn(ts, to_device(b, "cpu"))
        np.testing.assert_allclose(float(tlw), float(jlw), rtol=1e-5)
        np.testing.assert_allclose(float(tld), float(jld), rtol=1e-5)
    assert int(ts.step) == 3 and int(ts.opt_d["deep/emb128"]["step"]) == 3
    _compare(js, ts, rtol=1e-4, atol=1e-7)


def test_multitable_step_matches_jax_mixed_precision():
    """The production precision: bf16 MLP, bf16 rows and gradients
    (matmul_dtype bf16 on both sides).  Losses still agree to rtol 1e-5.
    The reference rounds the gathered table values and the summed table
    gradients to bf16 inside its one-hot matmuls where the port keeps
    float32, and the bf16 MLP gradients are reduced in other orders, so
    weights are held to atol 5e-5 (a twentieth of one Adam step of 1e-3).
    The tables' optimizer state carries the reference's bf16 rounding of
    each summed gradient (2**-8 relative) into FTRL's linear term, whose
    small entries then differ by a large ratio: it is held to rtol 2e-2
    plus one bf16 ulp of the leaf's largest value (2**-7 * max)."""
    jm, js, jo, tm, ts, to = _setup(mixed=True)
    j_fn = jstep.make_train_step(jm, *jo, jit=True, donate=False,
                                 use_pallas=True, row_layout=True)
    t_fn = make_train_step(tm, *to)
    for b in _batches(2, seed=2):
        js, (_, jld) = j_fn(js, b)
        ts, (_, tld) = t_fn(ts, to_device(b, "cpu"))
        np.testing.assert_allclose(float(tld), float(jld), rtol=1e-5)
    _compare(js, ts, rtol=0, atol=5e-5, only=["[0]"])  # parameters
    tables = [f"/{p[1]}']" for p, _ in tm.table_specs.values()]
    _compare(js, ts, rtol=2e-2, atol=0.0, of_max=2.0**-7, only=tables)


def test_compaction_skips_only_the_padding_row():
    """Host-prep compaction against the device-derived metadata of the
    same batches: equal except the padding id's row, which only the
    uncompacted stream touches (the documented semantic)."""
    *_, tm, ts, to = _setup()
    ts2 = convert.state_from_jax(*convert.state_to_jax(ts), device="cpu")
    fn = make_train_step(tm, *to, matmul_dtype=torch.float32)
    prep = make_batch_sort(0, groups=prep_groups(tm), minimal=True,
                           kept_budget={"multi": 512})
    for b in _batches(2, seed=3, pad_masked=True):
        ts, (_, la) = fn(ts, to_device(b, "cpu"))
        ts2, (_, lb) = fn(ts2, to_device(prep(b), "cpu"))
        np.testing.assert_allclose(float(lb), float(la), rtol=1e-6)
    for side, name, spec in (("deep", "emb64_multi", tm.specs["emb64_multi"]),
                             ("wide", "emb64_multi_w", tm.specs["w64_multi"])):
        a = from_storage(spec, ts.params[side][name])
        b = from_storage(spec, ts2.params[side][name])
        np.testing.assert_allclose(b[1:].numpy(), a[1:].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    np.testing.assert_allclose(ts2.params["deep"]["emb128"].numpy(),
                               ts.params["deep"]["emb128"].numpy(),
                               rtol=1e-5, atol=1e-7)


def test_tiny_group_leaves_absent_ids_untouched():
    """The tiny groups enumerate their whole id space; ids absent from
    the batch keep weights and optimizer state (presence gate)."""
    *_, tm, ts, to = _setup()
    before = convert.state_to_jax(ts)
    b = _batches(1, seed=4)[0]
    b["indicator_id"][:] = 3  # one live indicator id
    ts, _ = make_train_step(tm, *to, matmul_dtype=torch.float32)(
        ts, to_device(b, "cpu"))
    spec = tm.specs["emb64_indicator"]
    old = from_storage(spec, torch.from_numpy(before[0]["deep"]["emb64_indicator"]))
    new = from_storage(spec, ts.params["deep"]["emb64_indicator"])
    changed = (old != new).any(dim=1)
    assert changed[3] and int(changed.sum()) == 1
    m_new = ts.opt_d["deep/emb64_indicator"]["m"]
    assert int((m_new != 0).any(dim=0).sum()) == 1  # one column, fold 1
    wspec = tm.specs["w_indicator"]
    wa = from_storage(wspec, torch.from_numpy(before[0]["wide"]["indicator_w"]))
    wb = from_storage(wspec, ts.params["wide"]["indicator_w"])
    assert torch.nonzero((wa != wb).flatten()).flatten().tolist() == [3]


def test_batch_sort_groups_match_reference():
    """make_batch_sort(groups=, kept_budget=) equals the reference's numpy
    path, and raises BucketOverflow on both of its compaction limits."""
    tm = multitable.MultiTableWideDeepModel(multitable.MultiTableConfig(**KW))
    jm = jmt.MultiTableWideDeepModel(jmt.MultiTableConfig(**KW))
    assert prep_groups(tm).keys() == jstep.prep_groups(jm).keys()
    b = _batches(1, seed=5, pad_masked=True)[0]
    for kw in (dict(groups=tm.table_groups),
               dict(groups=prep_groups(tm), minimal=True,
                    kept_budget={"multi": 512}),
               dict(groups=prep_groups(tm), unique_bucket={"emb128": 64})):
        jkw = {**kw, "groups": jm.table_groups if "minimal" not in kw
               and "unique_bucket" not in kw else jstep.prep_groups(jm)}
        want = jstep.make_batch_sort(0, native=False, **jkw)(dict(b))
        got = make_batch_sort(0, **kw)(dict(b))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    kept = int(sum(b[f"multi_{n}_mask"].sum() for n in multitable.MULTI_FIELDS))
    with pytest.raises(BucketOverflow):
        make_batch_sort(0, groups=prep_groups(tm),
                        kept_budget={"multi": kept - 1})(b)
    with pytest.raises(BucketOverflow):
        make_batch_sort(0, groups=prep_groups(tm), kept_budget={"multi": 512},
                        unique_bucket={"multi": 8})(b)


def test_forward_predict_and_convert_match_jax():
    """apply / predict (lookups inside), the parameter layout and a state
    round trip through convert (list-valued mlp, f32 m/v) agree with the
    reference."""
    jm, js, _, tm, ts, _ = _setup()
    assert param_keys(ts.params) == jstep.param_keys(js.params)
    back = convert.state_to_jax(ts)
    ref = jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d))
    for x, y in zip(jax.tree.leaves(back[:3]), jax.tree.leaves(ref)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert ts.opt_d["deep/emb128"]["m"].dtype == torch.float32
    b = _batches(1, seed=6)[0]
    jp, _ = jstep.make_eval_step(jm)(js.params, b)
    tp, lab = make_eval_step(tm)(ts.params, to_device(b, "cpu"))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(lab.numpy(), b["label"])


def test_synthetic_outbrain_matches_reference():
    cfg = multitable.MultiTableConfig(**KW)
    mine = list(SyntheticOutbrain(cfg, 2, seed=7))
    ref = list(joutbrain.SyntheticOutbrain(jmt.MultiTableConfig(**KW), 2, seed=7))
    for a, b in zip(mine, ref):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# single-group Wide&Deep on the new branches
# ---------------------------------------------------------------------------

WD = dict(batch_size=64, field_size=4, emb_dim=16, deep_layer_dim=(32, 32),
          sparse=True, loss_scale=1024.0, use_mixed_precision=False)


@pytest.mark.parametrize("change", [
    {"vocab_size": 4000, "table_layout": "feature_major"},
    {"vocab_size": 500},  # tiny group, row_packed tables behind the gate
    {"vocab_size": 500, "table_layout": "feature_major"},
])
def test_wide_deep_new_branches_match_jax(change):
    """Single-group Wide&Deep with feature-major tables (wide fold 8,
    deep Dp 16) and/or a tiny vocab: three float32 steps against the
    reference, tolerances as the row_packed parity test."""
    kw = {**WD, **change}
    jm = jwd.WideDeepModel(jwd.WideDeepConfig(**kw))
    tm = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**kw))
    jo = (jopt.ftrl(loss_scale=1024.0), jopt.lazy_adam(loss_scale=1024.0))
    to = (optim.ftrl(loss_scale=1024.0), optim.lazy_adam(loss_scale=1024.0))
    js = jstep.init_train_state(jm, jax.random.PRNGKey(0), *jo)
    host = jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d))
    ts = convert.state_from_jax(*host, np.asarray(js.step), device="cpu")
    j_fn = jstep.make_train_step(jm, *jo, jit=True, donate=False,
                                 use_pallas=True, matmul_dtype=jnp.float32)
    t_fn = make_train_step(tm, *to, matmul_dtype=torch.float32)
    data = SyntheticCriteo(64, 4, kw["vocab_size"], seed=3)
    for i in range(3):
        b = data.get_batch(i)
        js, (_, jld) = j_fn(js, b)
        ts, (_, tld) = t_fn(ts, to_device(b, "cpu"))
        np.testing.assert_allclose(float(tld), float(jld), rtol=1e-5)
    _compare(js, ts, rtol=1e-4, atol=1e-8)


def test_plain_step_equals_kernel_step_multitable_on_cpu():
    """use_kernels=False calls the plain versions directly; on the CPU
    the wrappers take the same plain versions, so the states are equal."""
    *_, tm, ts, to = _setup()
    ts2 = convert.state_from_jax(*convert.state_to_jax(ts), device="cpu")
    a = make_train_step(tm, *to)
    b = make_train_step(tm, *to, use_kernels=False)
    for batch in _batches(2, seed=8):
        batch = to_device(batch, "cpu")
        ts, la = a(ts, batch)
        ts2, lb = b(ts2, batch)
        assert float(la[1]) == float(lb[1])
    for (_, x), (_, y) in zip(_leaves(convert.state_to_jax(ts)),
                              _leaves(convert.state_to_jax(ts2))):
        np.testing.assert_array_equal(x, y)


def test_multitable_check_overflow_matches_jax():
    """``check_overflow=True`` on the multi-group step, an ``inf`` in
    ``continue_val`` at step 2: both packages skip that update and advance
    the step, and after three steps every leaf agrees within 1e-7 (two
    float32 updates, as in the float32 parity test)."""
    jm, js, jo, tm, ts, to = _setup()
    j_fn = jstep.make_train_step(jm, *jo, jit=True, donate=False,
                                 use_pallas=True, row_layout=True,
                                 matmul_dtype=jnp.float32,
                                 check_overflow=True)
    t_fn = make_train_step(tm, *to, matmul_dtype=torch.float32,
                           check_overflow=True)
    for i, b in enumerate(_batches(3, seed=4)):
        if i == 1:
            b["continue_val"][0, 0] = np.inf
            before = convert.state_to_jax(ts)
        js, _ = j_fn(js, b)
        ts, _ = t_fn(ts, to_device(b, "cpu"))
        if i == 1:
            after = convert.state_to_jax(ts)
            for (k, x), (_, y) in zip(_leaves(before[:3]), _leaves(after[:3])):
                np.testing.assert_array_equal(x, y, err_msg=k)
    assert int(ts.step) == int(js.step) == 3
    _compare(js, ts, rtol=0, atol=1e-7)


def test_config_dataclass_matches_reference():
    """The port's config has the reference's fields and defaults, and its
    tables are feature-major (the reference's default layout)."""
    mine = {f.name: f.default for f in dataclasses.fields(multitable.MultiTableConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jmt.MultiTableConfig)}
    assert mine == ref
    c = multitable.MultiTableConfig()
    assert c.input_emb_dim == jmt.MultiTableConfig().input_emb_dim == 2016
    jm = jmt.MultiTableWideDeepModel(jmt.MultiTableConfig(sparse=True))
    tm = multitable.MultiTableWideDeepModel(multitable.MultiTableConfig(sparse=True))
    for name, (path, spec) in tm.table_specs.items():
        jpath, jspec = jm.table_specs[name]
        assert path == jpath and spec.feature_major
        assert spec.storage_shape == jspec.storage_shape
