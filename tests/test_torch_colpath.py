"""The feature-major (``row_layout=False``) path of the port against the
JAX package: its two kernels' plain versions and the two fused
update+gather functions against the Pallas kernels in interpret mode, and
three steps of Wide&Deep and of DeepFM on feature-major tables against
the JAX step, on the same numpy inputs.

The Pallas kernels run with ``matmul_dtype=float32`` (their one-hot
products are then exact up to the host's float32 dot), as the JAX
package's own tests run them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindrec_tpu.models import deepfm as jdeepfm
from mindrec_tpu.models import wide_deep as jwd
from mindrec_tpu.ops.pallas import stream_fused, stream_update
from mindrec_tpu.ops.pallas.stream_gather import streamed_gather
from mindrec_tpu.ops.pallas.stream_segsum import streamed_segsum
from mindrec_tpu.train import optim as jopt
from mindrec_tpu.train import step as jstep
from mindrec_tpu_torch import convert
from mindrec_tpu_torch.data.criteo import SyntheticCriteo, to_device
from mindrec_tpu_torch.models import deepfm, multitable, wide_deep
from mindrec_tpu_torch.ops import kernels
from mindrec_tpu_torch.ops.kernels.fused import (
    fused_adam_gather, fused_ftrl_gather,
)
from mindrec_tpu_torch.ops.kernels.gather import gather_cols
from mindrec_tpu_torch.ops.kernels.segsum import segsum_cols
from mindrec_tpu_torch.ops.kernels.update_cols import (
    adam_cols, ftrl_cols, make_aug_grads,
)
from mindrec_tpu_torch.train import optim
from mindrec_tpu_torch.train.step import make_batch_sort, make_train_step

SENT = 2**31 - 2
VC = 1024


@pytest.fixture(autouse=True)
def _interpret_kernels():
    stream_update.INTERPRET = True
    yield
    stream_update.INTERPRET = False


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# gather_cols vs streamed_gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp,fold,dtype", [
    (16, 1, "float32"), (8, 8, "float32"), (16, 1, "bfloat16"),
])
def test_gather_cols_matches_pallas(dp, fold, dtype):
    """Sorted columns with duplicates (a folded table's ids // 8) and a
    sentinel tail.  The reference leaves the outputs of columns that no
    table tile owns unwritten, so it is compared on the live columns; the
    port writes zeros there."""
    rng = np.random.default_rng(dp + fold)
    live = 430
    ids = np.sort(rng.choice(VC * fold, size=live, replace=False))
    cols = np.concatenate([ids // fold,
                           np.full(594, SENT // fold)]).astype(np.int32)
    table = rng.normal(size=(dp, VC)).astype(np.float32)
    t_j = jnp.asarray(table).astype(getattr(jnp, dtype))
    ref = streamed_gather(t_j.astype(jnp.float32), jnp.asarray(cols),
                          tile=256, chunk=256, matmul_dtype=jnp.float32,
                          interpret=True)
    t_t = _t(table).to(getattr(torch, dtype))
    out = gather_cols(t_t, _t(cols))
    assert out.shape == (dp, cols.size) and out.dtype == torch.float32
    # the reference places values with a one-hot f32 dot (reduced internal
    # precision on some hosts); the port copies them
    np.testing.assert_allclose(out.numpy()[:, :live],
                               np.asarray(ref)[:, :live], rtol=2e-5, atol=0)
    np.testing.assert_array_equal(out.numpy()[:, :live],
                                  t_t.float().numpy()[:, cols[:live]])
    assert np.all(out.numpy()[:, live:] == 0.0)


def test_gather_cols_negative_and_unsorted_columns():
    """Columns outside [0, Vc) on either side give zeros; the result does
    not depend on the order of the columns."""
    table = _t(np.arange(24, dtype=np.float32).reshape(3, 8))
    cols = _t(np.array([5, -1, 0, 8, 7, 5], np.int32))
    out = gather_cols(table, cols).numpy()
    want = np.zeros((3, 6), np.float32)
    for j, c in enumerate([5, None, 0, None, 7, 5]):
        if c is not None:
            want[:, j] = table.numpy()[:, c]
    np.testing.assert_array_equal(out, want)


# ---------------------------------------------------------------------------
# segsum_cols vs streamed_segsum(row_major=False)
# ---------------------------------------------------------------------------


def _uidx(rng, n, max_run):
    reps = rng.integers(1, max_run + 1, size=n)
    return np.repeat(np.arange(n), reps)[:n].astype(np.int32)


@pytest.mark.parametrize("dtype,n,max_run,n_out", [
    ("float32", 600, 4, 1024),    # empty tail: ~240 segments of 1024
    ("bfloat16", 700, 9, 1024),   # production input type
    ("bfloat16", 512, 1, 512),    # all-distinct ids
    ("float32", 900, 400, 1024),  # runs that cross many 256-position chunks
])
def test_segsum_cols_matches_pallas(dtype, n, max_run, n_out):
    rng = np.random.default_rng(n)
    uidx = _uidx(rng, n, max_run)
    g32 = rng.normal(size=(24, n)).astype(np.float32)
    g_j = jnp.asarray(g32).astype(getattr(jnp, dtype))
    ref = streamed_segsum(g_j, jnp.asarray(uidx), n_out=n_out,
                          matmul_dtype=jnp.float32, interpret=True)
    out = segsum_cols(_t(g32).to(getattr(torch, dtype)), _t(uidx), n_out)
    assert out.shape == (24, n_out) == ref.shape
    assert out.dtype == torch.float32
    # the reference never writes its 512-column output blocks past the
    # last segment's block, so it is compared up to that block; the port
    # zeroes its whole tail
    last = int(uidx[-1])
    seen = min(n_out, (last // 512 + 1) * 512)
    # f32 sums over the same terms in another order
    np.testing.assert_allclose(out.numpy()[:, :seen],
                               np.asarray(ref)[:, :seen], rtol=1e-5,
                               atol=1e-5)
    assert np.all(out.numpy()[:, last + 1:] == 0.0)


def test_segsum_cols_ignores_segments_past_n_out():
    uidx = np.repeat(np.arange(8), 4).astype(np.int32)
    g = np.ones((3, 32), np.float32)
    out = segsum_cols(_t(g), _t(uidx), 5).numpy()
    np.testing.assert_array_equal(out, np.full((3, 5), 4.0, np.float32))


# ---------------------------------------------------------------------------
# fused update + gather vs fused_adam_gather / fused_ftrl_gather
# ---------------------------------------------------------------------------


def _fused_inputs(seed, n_u, n_g, fold=1, skew_empty=False, sentinels=0,
                  scale=1.0):
    """The inputs of the reference's own fused tests (uniform ids, or
    ``skew_empty``: column ranges with gradients and no next ids, next
    ids and no gradients, and neither), plus sentinel pads on both id
    lists and folded slots masked to their sublane."""
    rng = np.random.default_rng(seed)
    dp, ids_hi = 8, VC * fold
    if skew_empty:
        ids_u = np.sort(rng.integers(0, ids_hi // 4, n_u))
        ids_g = np.sort(np.concatenate([
            rng.integers(0, ids_hi // 8, n_g // 2),
            rng.integers(ids_hi // 2, 3 * ids_hi // 4, n_g - n_g // 2)]))
    else:
        ids_u = np.sort(rng.integers(0, ids_hi, n_u))
        ids_g = np.sort(rng.integers(0, ids_hi, n_g))
    pad = np.full(sentinels, SENT)
    ids_u = np.concatenate([ids_u, pad]).astype(np.int32)
    ids_g = np.concatenate([ids_g, pad]).astype(np.int32)
    table = (rng.normal(size=(dp, VC)) * scale).astype(np.float32)
    g = rng.normal(size=(dp, ids_u.size)).astype(np.float32)
    sub = None
    if fold > 1:
        sub = (ids_u % fold).astype(np.int32)
        g *= np.arange(dp)[:, None] == sub[None, :]
    aug = make_aug_grads(_t(g), None if sub is None else _t(sub)).numpy()
    return (ids_u // fold).astype(np.int32), (ids_g // fold).astype(np.int32), \
        table, aug, n_g


FUSED_CASES = [
    dict(seed=0, n_u=300, n_g=200),
    dict(seed=1, n_u=300, n_g=200, skew_empty=True),
    dict(seed=3, n_u=200, n_g=200, fold=8),
    dict(seed=4, n_u=280, n_g=180, fold=8, skew_empty=True, sentinels=40),
    dict(seed=5, n_u=216, n_g=152, sentinels=40),
]
FUSED_IDS = ["uniform", "skew_empty", "fold8", "fold8_skew_sentinels",
             "sentinels"]


@pytest.mark.parametrize("case", FUSED_CASES, ids=FUSED_IDS)
def test_fused_adam_gather_matches_pallas(case):
    cols_u, cols_g, table, aug, live_g = _fused_inputs(**case)
    fold = case.get("fold", 1)
    dim = 1 if fold > 1 else 8
    rng = np.random.default_rng(9)
    m = (rng.normal(size=table.shape) * 1e-2).astype(np.float32)
    v = np.abs(rng.normal(size=table.shape) * 1e-3).astype(np.float32)
    hyper = dict(dim=dim, fold=fold, loss_scale=4.0)
    ref = stream_fused.fused_adam_gather(
        jnp.asarray(table), jnp.asarray(m), jnp.asarray(v),
        jnp.asarray(cols_u), jnp.asarray(aug), jnp.float32(1e-2),
        jnp.asarray(cols_g), tile=128, chunk=64, matmul_dtype=jnp.float32,
        interpret=True, **hyper)
    t_t, m_t, v_t = _t(table), _t(m), _t(v)
    out = fused_adam_gather(t_t, m_t, v_t, _t(cols_u), _t(aug),
                            torch.tensor(1e-2), _t(cols_g), **hyper)
    assert out[0] is t_t and out[1] is m_t and out[2] is v_t  # in place
    # the reference sums gradients and gathers with one-hot f32 dots
    for got, want in zip(out[:3], ref[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=1e-8)
    rows = out[3].numpy()
    assert rows.shape == (8, cols_g.size)
    np.testing.assert_allclose(rows[:, :live_g],
                               np.asarray(ref[3])[:, :live_g], rtol=2e-5,
                               atol=1e-8)
    # the rows are the updated table's columns, sentinel columns zero
    np.testing.assert_array_equal(rows[:, :live_g],
                                  t_t.numpy()[:, cols_g[:live_g]])
    assert np.all(rows[:, live_g:] == 0.0)
    # and the whole is the separate update followed by the gather
    t2, m2, v2 = _t(table), _t(m), _t(v)
    adam_cols(t2, m2, v2, _t(cols_u), _t(aug), torch.tensor(1e-2), **hyper)
    for x, y in ((t_t, t2), (m_t, m2), (v_t, v2),
                 (out[3], gather_cols(t2, _t(cols_g)))):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("case", FUSED_CASES, ids=FUSED_IDS)
def test_fused_ftrl_gather_matches_pallas(case):
    # weights of the size FTRL keeps (as the ftrl_cols parity test): at
    # |w| ~ 1 the step's lin + G - sigma * w cancels to a few digits
    cols_u, cols_g, table, aug, live_g = _fused_inputs(scale=0.01, **case)
    fold = case.get("fold", 1)
    dim = 1 if fold > 1 else 8
    rng = np.random.default_rng(11)
    accum = (0.1 + np.abs(rng.normal(size=table.shape))).astype(np.float32)
    linear = (rng.normal(size=table.shape) * 0.1).astype(np.float32)
    hyper = dict(dim=dim, fold=fold, learning_rate=5e-2, l1=5e-4, l2=5e-4,
                 loss_scale=2.0)
    ref = stream_fused.fused_ftrl_gather(
        jnp.asarray(table), jnp.asarray(accum), jnp.asarray(linear),
        jnp.asarray(cols_u), jnp.asarray(aug), jnp.asarray(cols_g), tile=128,
        chunk=64, matmul_dtype=jnp.float32, interpret=True, **hyper)
    t_t, a_t, l_t = _t(table), _t(accum), _t(linear)
    out = fused_ftrl_gather(t_t, a_t, l_t, _t(cols_u), _t(aug), _t(cols_g),
                            **hyper)
    assert out[0] is t_t and out[1] is a_t and out[2] is l_t  # in place
    # G from the reference's one-hot f32 dot, carried through the
    # cancellation in (sign * l1 - linear')
    for got, want in zip(out[:3], ref[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=1e-7)
    rows = out[3].numpy()
    np.testing.assert_allclose(rows[:, :live_g],
                               np.asarray(ref[3])[:, :live_g], rtol=2e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(rows[:, :live_g],
                                  t_t.numpy()[:, cols_g[:live_g]])
    assert np.all(rows[:, live_g:] == 0.0)
    t2, a2, l2 = _t(table), _t(accum), _t(linear)
    ftrl_cols(t2, a2, l2, _t(cols_u), _t(aug), **hyper)
    for x, y in ((t_t, t2), (a_t, a2), (l_t, l2),
                 (out[3], gather_cols(t2, _t(cols_g)))):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_colpath_wrappers_take_plain_only_on_cpu():
    """The four kernels of this path: CPU tensors count no launch; meta
    tensors (a device without kernels) raise rather than fall back."""
    kernels.reset_launches()
    t = torch.zeros((8, 64))
    cols = torch.tensor([0, 0, 3, SENT // 8], dtype=torch.int32)
    aug = torch.ones((16, 4))
    gather_cols(t, cols)
    segsum_cols(torch.ones((2, 4)), torch.tensor([0, 0, 1, 2],
                                                 dtype=torch.int32), 16)
    fused_adam_gather(t, t.clone(), t.clone(), cols, aug, torch.tensor(1e-3),
                      cols, dim=1, fold=8)
    fused_ftrl_gather(t, t + 1.0, t.clone(), cols, aug, cols, dim=1, fold=8)
    assert sum(kernels.LAUNCHES.values()) == 0
    assert {"gather_cols", "segsum_cols", "fused_adam_gather",
            "fused_ftrl_gather"} <= set(kernels.LAUNCHES)
    m, mc = torch.zeros((8, 64), device="meta"), cols.to("meta")
    with pytest.raises(ValueError, match="gather_cols"):
        gather_cols(m, mc)
    with pytest.raises(ValueError, match="segsum_cols"):
        segsum_cols(torch.ones((2, 4), device="meta"), mc, 16)
    with pytest.raises(ValueError, match="fused_adam_gather"):
        fused_adam_gather(m, m, m, mc, aug.to("meta"),
                          torch.zeros((), device="meta"), mc, dim=1, fold=8)
    with pytest.raises(ValueError, match="fused_ftrl_gather"):
        fused_ftrl_gather(m, m, m, mc, aug.to("meta"), mc, dim=1, fold=8)


def test_segsum_cols_takes_only_the_row_major_view_off_the_cpu():
    """Off the CPU ``segsum_cols`` streams the rows of a contiguous
    [N, D]: a [D, N]-contiguous ``g`` raises, naming the layout, instead of
    being copied; the transposed view passes the layout check (and a meta
    tensor then raises for its device).  On the CPU any layout is summed."""
    uidx = torch.tensor([0, 0, 1, 2], dtype=torch.int32)
    rows = torch.arange(12, dtype=torch.float32).reshape(4, 3)  # [N, D]
    with pytest.raises(ValueError, match=r"segsum_cols: g must be the "
                       r"transposed view of a contiguous \[N, D\]"):
        segsum_cols(rows.T.contiguous().to("meta"), uidx.to("meta"), 4)
    with pytest.raises(ValueError, match="CPU or one CUDA device"):
        segsum_cols(rows.to("meta").T, uidx.to("meta"), 4)
    want = [[3.0, 6.0, 9.0, 0.0], [5.0, 7.0, 10.0, 0.0], [7.0, 8.0, 11.0, 0.0]]
    for g in (rows.T, rows.T.contiguous()):
        np.testing.assert_array_equal(segsum_cols(g, uidx, 4).numpy(), want)


# ---------------------------------------------------------------------------
# the row_layout=False step
# ---------------------------------------------------------------------------

B, F = 64, 4
WD = dict(batch_size=B, field_size=F, vocab_size=4000, emb_dim=12,
          deep_layer_dim=(32, 32), sparse=True, loss_scale=1024.0,
          use_mixed_precision=False, table_layout="feature_major")
FM = dict(batch_size=B, field_size=F, vocab_size=4000, emb_dim=20,
          deep_layer_dim=(32, 16), sparse=True, loss_scale=1024.0,
          use_mixed_precision=False, table_layout="feature_major")


def _setup(which, state_dtype="float32", **cfg_kw):
    """(jax model, jax state, jax opts, port model, port state, port
    opts) from one JAX init: Wide&Deep (FTRL on the folded wide table,
    LazyAdam on the deep table, emb 12 -> Dp 16 with sublane padding) or
    DeepFM (one Adam; linear folded, fm emb 20 -> Dp 24)."""
    sd_j, sd_t = getattr(jnp, state_dtype), getattr(torch, state_dtype)
    if which == "wide_deep":
        kw = {**WD, **cfg_kw}
        jm = jwd.WideDeepModel(jwd.WideDeepConfig(**kw))
        tm = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**kw))
        jo = (jopt.ftrl(loss_scale=1024.0),
              jopt.lazy_adam(loss_scale=1024.0, state_dtype=sd_j))
        to = (optim.ftrl(loss_scale=1024.0),
              optim.lazy_adam(loss_scale=1024.0, state_dtype=sd_t))
    else:
        kw = {**FM, **cfg_kw}
        jm = jdeepfm.DeepFMModel(jdeepfm.DeepFMConfig(**kw))
        tm = deepfm.DeepFMModel(deepfm.DeepFMConfig(**kw))
        akw = dict(learning_rate=5e-4, eps=5e-8, loss_scale=1024.0)
        jo = tuple(jopt.adam(state_dtype=sd_j, **akw) for _ in range(2))
        to = tuple(optim.adam(state_dtype=sd_t, **akw) for _ in range(2))
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


@pytest.mark.parametrize("which,prep", [
    ("wide_deep", "device_sort"), ("wide_deep", "host_prep"),
    ("wide_deep", "host_minimal"), ("deepfm", "device_sort"),
    ("deepfm", "host_minimal"),
])
def test_colpath_step_matches_jax_f32(which, prep):
    """Three float32 steps with ``row_layout=False`` on feature-major
    tables: losses within rtol 1e-5; every parameter and optimizer leaf
    within rtol 1e-4 / atol 1e-8 (the tolerances of the row-layout parity
    tests: XLA and PyTorch sum the MLP's products and the batch means in
    other orders, which Adam's m / sqrt(v) can amplify a little)."""
    jm, js, jo, tm, ts, to = _setup(which)
    j_fn = jstep.make_train_step(jm, *jo, jit=True, donate=False,
                                 use_pallas=True, row_layout=False,
                                 matmul_dtype=jnp.float32)
    t_fn = make_train_step(tm, *to, row_layout=False,
                           matmul_dtype=torch.float32)
    prep_fn = (None if prep == "device_sort"
               else make_batch_sort(F, minimal=prep == "host_minimal"))
    data = SyntheticCriteo(B, F, 4000, seed=3)
    for i in range(3):
        b = data.get_batch(i)
        js, (jlw, jld) = j_fn(js, b)
        ts, (tlw, tld) = t_fn(ts, to_device(prep_fn(b) if prep_fn else b, "cpu"))
        np.testing.assert_allclose(float(tlw), float(jlw), rtol=1e-5)
        np.testing.assert_allclose(float(tld), float(jld), rtol=1e-5)
    assert int(ts.step) == 3
    _compare(js, ts, rtol=1e-4, atol=1e-8)


def test_colpath_step_matches_jax_mixed_precision():
    """DeepFM at the recipe's precision on the feature-major path: bf16
    tower, bf16 expanded rows and gradients, bf16 Adam moments.  Losses
    agree to rtol 1e-5; tolerances on the state as in the row-layout
    mixed-precision tests (the reference rounds table values and summed
    gradients to bf16 inside its one-hot products, the port keeps
    float32): table weights atol 7.5e-5, dense weights 1.5e-4, moments
    rtol 2e-2 with floors 1e-5 (m) and 1e-6 (v)."""
    jm, js, jo, tm, ts, to = _setup("deepfm", state_dtype="bfloat16",
                                    use_mixed_precision=True)
    j_fn = jstep.make_train_step(jm, *jo, jit=True, donate=False,
                                 use_pallas=True, row_layout=False)
    t_fn = make_train_step(tm, *to, row_layout=False)
    data = SyntheticCriteo(B, F, 4000, seed=3)
    for i in range(3):
        b = data.get_batch(i)
        js, (_, jld) = j_fn(js, b)
        ts, (_, tld) = t_fn(ts, to_device(b, "cpu"))
        np.testing.assert_allclose(float(tld), float(jld), rtol=1e-5)
    assert ts.opt_d["fm/table"]["m"].dtype == torch.bfloat16
    _compare(js, ts, rtol=0, atol=7.5e-5, only=["['table']"])
    _compare(js, ts, rtol=0, atol=1.5e-4, only=["['w']", "['b']"])
    _compare(js, ts, rtol=2e-2, atol=1e-5, only=["table']['m']"])
    _compare(js, ts, rtol=2e-2, atol=1e-6, only=["table']['v']"])


@pytest.mark.parametrize("which", ["wide_deep", "deepfm"])
def test_colpath_equals_row_layout_path(which):
    """Both formulations compute the same step: from one state and the
    same batches, ``row_layout=False`` and ``row_layout=True`` on the
    same feature-major tables agree to float32 summation order."""
    *_, tm, ts, to = _setup(which)
    ts2 = convert.state_from_jax(*convert.state_to_jax(ts), device="cpu")
    a = make_train_step(tm, *to, row_layout=False, matmul_dtype=torch.float32)
    b = make_train_step(tm, *to, row_layout=True, matmul_dtype=torch.float32)
    data = SyntheticCriteo(B, F, 4000, seed=9)
    for i in range(2):
        batch = to_device(data.get_batch(i), "cpu")
        ts, la = a(ts, batch)
        ts2, lb = b(ts2, batch)
        np.testing.assert_allclose(float(la[1]), float(lb[1]), rtol=1e-6)
    for (k, x), (_, y) in zip(_leaves(convert.state_to_jax(ts)[:3]),
                              _leaves(convert.state_to_jax(ts2)[:3])):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-8, err_msg=k)


def test_colpath_plain_step_equals_kernel_step_on_cpu():
    """use_kernels=False calls the plain versions directly; on the CPU
    the wrappers take the same plain versions, so the states are equal.
    ``check_overflow`` keeps the state on a non-finite gradient."""
    *_, tm, ts, to = _setup("deepfm")
    ts2 = convert.state_from_jax(*convert.state_to_jax(ts), device="cpu")
    a = make_train_step(tm, *to, row_layout=False)
    b = make_train_step(tm, *to, row_layout=False, use_kernels=False)
    data = SyntheticCriteo(B, F, 4000, seed=9)
    for i in range(2):
        batch = to_device(data.get_batch(i), "cpu")
        ts, la = a(ts, batch)
        ts2, lb = b(ts2, batch)
        assert float(la[1]) == float(lb[1])
    for (_, x), (_, y) in zip(_leaves(convert.state_to_jax(ts)),
                              _leaves(convert.state_to_jax(ts2))):
        np.testing.assert_array_equal(x, y)
    before = convert.state_to_jax(ts)
    bad = data.get_batch(2)
    bad["wts"][0, 0] = np.inf
    guard = make_train_step(tm, *to, row_layout=False, check_overflow=True)
    ts, _ = guard(ts, to_device(bad, "cpu"))
    after = convert.state_to_jax(ts)
    assert int(after[3]) == int(before[3]) + 1
    for (_, x), (_, y) in zip(_leaves(before[:3]), _leaves(after[:3])):
        np.testing.assert_array_equal(x, y)


def test_colpath_guards():
    """``row_layout=False`` raises for a multi-group model unless
    ``use_pallas=False`` (as the reference); on row_packed tables it warns,
    naming the layout, and falls back to the generic path (as the
    reference; ``tests/test_torch_generic.py`` holds that path to it); and
    it raises for unique ids trimmed to a bucket, which only the
    row-layout path takes."""
    mt = multitable.MultiTableWideDeepModel(
        multitable.MultiTableConfig(sparse=True))
    with pytest.raises(NotImplementedError, match="single-id-group"):
        make_train_step(mt, optim.ftrl(), optim.adam(), row_layout=False)
    fn = make_train_step(mt, optim.ftrl(), optim.adam(), row_layout=False,
                         use_pallas=False)
    assert fn.__name__ == "step_generic"
    packed = deepfm.DeepFMModel(deepfm.DeepFMConfig(
        **{**FM, "table_layout": "auto"}))
    with pytest.warns(UserWarning, match="feature_major"):
        fn = make_train_step(packed, optim.adam(), optim.adam(),
                             row_layout=False)
    assert fn.__name__ == "step_generic"
    *_, tm, ts, to = _setup("deepfm")
    fn = make_train_step(tm, *to, row_layout=False)
    hb = make_batch_sort(F, minimal=True)(
        SyntheticCriteo(B, F, 4000, seed=1).get_batch(0))
    hb["uq_ids"] = hb["uq_ids"][:128]
    with pytest.raises(ValueError, match="full length"):
        fn(ts, to_device(hb, "cpu"))
