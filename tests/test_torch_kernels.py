"""The port's kernels (their plain versions on the CPU) against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs.

Each kernel wrapper takes its plain PyTorch version for CPU tensors, so
these tests hold the plain versions, and the touch rules they share with
the CUDA kernels, to the reference.  ``tests/test_torch_cuda.py`` holds
the CUDA kernels to the plain versions on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindrec_tpu.ops import embedding as jemb
from mindrec_tpu.ops.pallas import stream_update
from mindrec_tpu.ops.pallas.stream_gather import streamed_gather_rows
from mindrec_tpu.ops.pallas.stream_segsum import (
    streamed_segsum, streamed_segsum_unsorted,
)
from mindrec_tpu.ops.pallas.stream_update_rows import (
    streamed_adam_rows, streamed_ftrl_rows,
)
from mindrec_tpu_torch.ops import embedding as temb
from mindrec_tpu_torch.ops import kernels
from mindrec_tpu_torch.ops.kernels.gather import gather_cols, gather_rows
from mindrec_tpu_torch.ops.kernels.segsum import (
    segsum_cols, segsum_sorted, segsum_sorted_plain, segsum_unsorted,
)
from mindrec_tpu_torch.ops.kernels.update_cols import (
    adam_cols, ftrl_cols, make_aug_grads,
)
from mindrec_tpu_torch.ops.kernels.update_rows import adam_rows, ftrl_rows

SENT = 2**31 - 2
N_ROWS = 256


@pytest.fixture(autouse=True)
def _interpret_kernels():
    stream_update.INTERPRET = True
    yield
    stream_update.INTERPRET = False


def _t(a):
    return torch.from_numpy(np.array(a))


def _uidx(rng, n, max_run):
    """Monotone unit-step segment ids with runs of 1..max_run."""
    reps = rng.integers(1, max_run + 1, size=n)
    return np.repeat(np.arange(n), reps)[:n].astype(np.int32)


# ---------------------------------------------------------------------------
# segsum_sorted vs streamed_segsum(row_major=True)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,n,max_run,n_out", [
    ("float32", 600, 4, 1024),   # empty tail: ~240 segments of 1024
    ("bfloat16", 700, 9, 512),   # production input type
    ("bfloat16", 512, 1, 512),   # all-distinct ids, bucket == segments
])
def test_segsum_matches_pallas(dtype, n, max_run, n_out):
    rng = np.random.default_rng(n)
    uidx = _uidx(rng, n, max_run)
    g32 = rng.normal(size=(n, 24)).astype(np.float32)
    g_j = jnp.asarray(g32).astype(getattr(jnp, dtype))
    ref = streamed_segsum(
        g_j, jnp.asarray(uidx), row_major=True, n_out=n_out,
        matmul_dtype=jnp.float32, interpret=True,
    )
    g_t = _t(g32).to(getattr(torch, dtype))
    out = segsum_sorted(g_t, _t(uidx), n_out)
    assert out.shape == (24, n_out) and out.dtype == torch.float32
    # the reference never writes its 512-column output blocks past the
    # last segment's block (uninitialised there: NaN in interpret mode),
    # so it is compared up to that block; the port zeroes its whole tail
    last = int(uidx[-1])
    seen = min(n_out, (last // 512 + 1) * 512)
    # f32 sums over the same terms in another order
    np.testing.assert_allclose(out.numpy()[:, :seen],
                               np.asarray(ref)[:, :seen], rtol=1e-5,
                               atol=1e-5)
    assert np.all(out.numpy()[:, last + 1:] == 0.0)


def test_segsum_ignores_segments_past_n_out():
    """Segment ids at or past n_out (and negative ones) add nothing."""
    uidx = np.repeat(np.arange(8), 4).astype(np.int32)
    g = np.ones((32, 3), np.float32)
    out = segsum_sorted_plain(_t(g), _t(uidx), 5).numpy()
    np.testing.assert_array_equal(out, np.full((3, 5), 4.0, np.float32))
    uidx[:4] = -1
    out = segsum_sorted_plain(_t(g), _t(uidx), 5).numpy()
    assert np.all(out[:, 0] == 0.0) and np.all(out[:, 1:] == 4.0)


# ---------------------------------------------------------------------------
# row updates vs streamed_{adam,ftrl}_rows
# ---------------------------------------------------------------------------


def _slots(rng, pack, n_uq, n_sent):
    """Sorted distinct logical ids (siblings share storage rows when
    pack > 1), padded with sentinel slots; plus a present gate with some
    zeros and gradients with some exactly-zero slots."""
    uq = np.sort(rng.choice(N_ROWS * pack, size=n_uq, replace=False))
    uq = np.concatenate([uq, np.full(n_sent, SENT)]).astype(np.int32)
    n = uq.size
    present = (rng.uniform(size=n) > 0.2).astype(np.int32)
    return uq // pack, uq % pack, present, n


def _grads(rng, n, dim, scale=1024.0):
    g = (rng.normal(size=(n, dim)) * scale * 1e-2).astype(np.float32)
    g[::5] = 0.0  # touched with a zero gradient
    return g


@pytest.mark.parametrize("pack,state_dtype", [
    (1, "float32"), (8, "float32"), (8, "bfloat16"), (1, "bfloat16"),
])
def test_adam_rows_matches_pallas(pack, state_dtype):
    rng = np.random.default_rng(pack)
    dim = 128 // pack
    rows, sub, present, n = _slots(rng, pack, n_uq=40 * pack // 2 + 30,
                                   n_sent=13)
    g = _grads(rng, n, dim)
    table = rng.normal(size=(N_ROWS, 128)).astype(np.float32) * 0.01
    m = rng.normal(size=(N_ROWS, 128)).astype(np.float32) * 1e-3
    v = np.abs(rng.normal(size=(N_ROWS, 128))).astype(np.float32) * 1e-6
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, loss_scale=1024.0)
    lr_t = 3.5e-4 * np.sqrt(1 - 0.999**3) / (1 - 0.9**3)
    sd_j = getattr(jnp, state_dtype)
    ref = streamed_adam_rows(
        jnp.asarray(table), jnp.asarray(m).astype(sd_j),
        jnp.asarray(v).astype(sd_j), jnp.asarray(rows), jnp.asarray(sub),
        jnp.asarray(g), jnp.float32(lr_t), dim=dim, pack=pack,
        present=jnp.asarray(present), matmul_dtype=jnp.float32,
        interpret=True, **hyper,
    )
    sd_t = getattr(torch, state_dtype)
    t_t, m_t, v_t = _t(table), _t(m).to(sd_t), _t(v).to(sd_t)
    out = adam_rows(t_t, m_t, v_t, _t(rows), _t(sub), _t(g),
                    torch.tensor(lr_t, dtype=torch.float32), dim=dim,
                    pack=pack, present=_t(present), **hyper)
    assert out[0] is t_t and out[1] is m_t  # in place
    # The port's arithmetic is numpy's float32 exactly.  The reference
    # places G with a one-hot f32 dot that XLA's CPU backend may run at
    # reduced internal precision (seen on AMX hosts: G off by ~5e-6
    # relative), so weights and f32 moments get rtol 2e-5; a bf16 moment
    # may then round to its neighbour, one bf16 ulp (2**-7 relative).
    for got, want in zip(out, ref):
        rtol = 2.0**-7 if got.dtype == torch.bfloat16 else 2e-5
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=rtol, atol=1e-8)


def test_ftrl_rows_matches_pallas():
    rng = np.random.default_rng(7)
    pack, dim = 128, 1
    rows, sub, present, n = _slots(rng, pack, n_uq=900, n_sent=21)
    g = _grads(rng, n, dim)
    table = rng.normal(size=(N_ROWS, 128)).astype(np.float32) * 0.01
    accum = (1.0 + np.abs(rng.normal(size=(N_ROWS, 128)))).astype(np.float32)
    linear = rng.normal(size=(N_ROWS, 128)).astype(np.float32) * 0.1
    hyper = dict(learning_rate=5e-2, l1=1e-3, l2=1e-3, loss_scale=1024.0)
    ref = streamed_ftrl_rows(
        jnp.asarray(table), jnp.asarray(accum), jnp.asarray(linear),
        jnp.asarray(rows), jnp.asarray(sub), jnp.asarray(g), dim=dim,
        pack=pack, present=jnp.asarray(present), matmul_dtype=jnp.float32,
        interpret=True, **hyper,
    )
    out = ftrl_rows(_t(table), _t(accum), _t(linear), _t(rows), _t(sub),
                    _t(g), dim=dim, pack=pack, present=_t(present), **hyper)
    for got, want in zip(out, ref):
        # G comes from the reference's one-hot f32 dot (see the Adam test:
        # ~5e-6 relative on AMX hosts), and sigma, a difference of square
        # roots, carries it into w' through the cancellation in
        # (sign*l1 - lin'): a few 1e-8 on weights of ~1e-2
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("kind", ["adam", "ftrl"])
def test_row_updates_touch_rules(kind):
    """Lazy-update semantics, checked element by element: exactly the
    lanes of present, in-table slots change; zero-gradient slots change
    too; siblings, sentinel slots and gated slots keep every value."""
    rng = np.random.default_rng(11)
    pack, dim = 8, 16
    rows, sub, present, n = _slots(rng, pack, n_uq=60, n_sent=5)
    g = _grads(rng, n, dim)  # every fifth slot has a zero gradient
    table = _t(rng.normal(size=(N_ROWS, 128)).astype(np.float32))
    s1 = _t(rng.normal(size=(N_ROWS, 128)).astype(np.float32) * 1e-2)
    s2 = _t(1.0 + np.abs(rng.normal(size=(N_ROWS, 128))).astype(np.float32))
    before = [x.clone() for x in (table, s1, s2)]
    if kind == "adam":  # m = s1, v = s2
        adam_rows(table, s1, s2, _t(rows), _t(sub), _t(g),
                  torch.tensor(1e-3), dim=dim, pack=pack, present=_t(present))
    else:  # accum = s2 (> 0), linear = s1
        ftrl_rows(table, s2, s1, _t(rows), _t(sub), _t(g), dim=dim,
                  pack=pack, present=_t(present))
    expect = np.zeros((N_ROWS, 128), bool)
    for r, s, p in zip(rows, sub, present):
        if p and r < N_ROWS:
            expect[r, s * dim:(s + 1) * dim] = True
    assert expect.sum() > 0 and (~expect[np.unique(rows[rows < N_ROWS])]).any()
    for new, old in zip((table, s1, s2), before):
        changed = (new != old).numpy()
        assert not (changed & ~expect).any(), "an untouched lane changed"
    # every touched lane's weight moved, zero-gradient slots included
    assert (table != before[0]).numpy()[expect].all()
    assert (g[(present == 1) & (rows < N_ROWS)] == 0).any()


# ---------------------------------------------------------------------------
# wrappers: device rules and launch counts
# ---------------------------------------------------------------------------


def test_wrappers_take_plain_only_on_cpu():
    """CPU tensors take the plain version without counting a launch;
    tensors on any other device never do (meta stands in for a device
    this sandbox lacks)."""
    kernels.reset_launches()
    g = torch.ones((4, 2))
    uidx = torch.tensor([0, 0, 1, 2], dtype=torch.int32)
    np.testing.assert_array_equal(segsum_sorted(g, uidx, 4).numpy(),
                                  segsum_sorted_plain(g, uidx, 4).numpy())
    assert kernels.LAUNCHES == dict.fromkeys(
        ("segsum_sorted", "adam_rows", "ftrl_rows", "segsum_unsorted",
         "adam_cols", "ftrl_cols", "gather_rows", "segsum_cols",
         "gather_cols", "fused_adam_gather", "fused_ftrl_gather"), 0)
    with pytest.raises(ValueError, match="segsum_sorted"):
        segsum_sorted(g.to("meta"), uidx.to("meta"), 4)
    t = torch.zeros((8, 128), device="meta")
    idx = torch.zeros(2, dtype=torch.int32, device="meta")
    gs = torch.zeros((2, 16), device="meta")
    with pytest.raises(ValueError, match="adam_rows"):
        adam_rows(t, t, t, idx, idx, gs, torch.zeros((), device="meta"),
                  dim=16, pack=8)
    with pytest.raises(ValueError, match="ftrl_rows"):
        ftrl_rows(t, t, t, idx, idx, gs, dim=16, pack=8)
    with pytest.raises(ValueError, match="segsum_sorted"):
        segsum_sorted(g, uidx.to("meta"), 4)  # mixed devices


# ---------------------------------------------------------------------------
# storage layout and packed gather vs the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("emb_dim,pack", [(128, 1), (16, 8), (1, 128)])
def test_storage_and_packed_gather_match(emb_dim, pack):
    kw = dict(vocab_size=3000, emb_dim=emb_dim, sparse=True)
    js, ts = jemb.EmbeddingTableSpec(**kw), temb.EmbeddingTableSpec(**kw)
    assert ts.pack == js.pack == pack
    for attr in ("padded_vocab", "dummy_id", "row_packed", "packed_rows",
                 "storage_shape"):
        assert getattr(ts, attr) == getattr(js, attr), attr
    rng = np.random.default_rng(emb_dim)
    logical = rng.normal(size=(js.padded_vocab, emb_dim)).astype(np.float32)
    st_j = np.asarray(jemb.to_storage(js, jnp.asarray(logical)))
    st_t = temb.to_storage(ts, _t(logical)).numpy()
    assert st_t.shape == st_j.shape and st_t.tobytes() == st_j.tobytes()
    np.testing.assert_array_equal(temb.from_storage(ts, _t(st_t)).numpy(),
                                  logical)
    ids = np.concatenate([rng.integers(0, 3000, size=50),
                          [0, 2999, 3000, SENT, 2**31 - 1]]).astype(np.int32)
    got = temb.packed_gather(ts, _t(st_t), _t(ids)).numpy()
    want = np.asarray(jemb.packed_gather(js, jnp.asarray(st_j),
                                         jnp.asarray(ids)))
    np.testing.assert_array_equal(got, want)
    sub = ids[:50] % pack
    vals = rng.normal(size=(50, emb_dim)).astype(np.float32)
    np.testing.assert_array_equal(
        temb.packed_expand(ts, _t(vals), _t(sub)).numpy(),
        np.asarray(jemb.packed_expand(js, jnp.asarray(vals), jnp.asarray(sub))),
    )


def test_bench_recipe_storage_shapes():
    """The benchmark recipe's tables (vocab 5.86M): deep [733184, 128]
    f32 at pack 8, wide [47104, 128] f32 at pack 128."""
    deep = temb.EmbeddingTableSpec(5_860_000, 16, sparse=True)
    wide = temb.EmbeddingTableSpec(5_860_000, 1, sparse=True)
    assert (deep.pack, deep.storage_shape) == (8, (733184, 128))
    assert (wide.pack, wide.storage_shape) == (128, (47104, 128))


# ---------------------------------------------------------------------------
# the feature-major kernels: gather_rows, segsum_unsorted, adam/ftrl_cols
# ---------------------------------------------------------------------------

VC = 1024  # storage columns of the test tables (4 tiles of 256)


def test_gather_rows_matches_pallas():
    """Sorted columns with duplicates (a folded table's ids // 8) and
    sentinels, written at a nonzero lane offset into a buffer whose other
    lanes and sentinel rows must keep their content."""
    rng = np.random.default_rng(21)
    dp, width, off = 16, 128, 40
    ids = np.sort(rng.choice(VC * 8, size=430, replace=False))
    cols = np.concatenate([ids // 8, np.full(82, SENT // 8)]).astype(np.int32)
    assert (np.diff(cols[:430]) == 0).any()  # duplicate columns
    table = rng.normal(size=(dp, VC)).astype(np.float32)
    base = rng.normal(size=(cols.size, width)).astype(np.float32)
    ref = streamed_gather_rows(
        jnp.asarray(table), jnp.asarray(cols), jnp.asarray(base),
        lane_offset=off, tile=256, chunk=256, matmul_dtype=jnp.float32,
        interpret=True,
    )
    buf = _t(base)
    out = gather_rows(_t(table), _t(cols), buf, lane_offset=off)
    assert out is buf  # in place
    # the reference places values with a one-hot f32 dot (see the Adam
    # rows test: reduced internal precision on some hosts)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=0)
    np.testing.assert_array_equal(out.numpy()[430:], base[430:])
    np.testing.assert_array_equal(out.numpy()[:, :off], base[:, :off])
    np.testing.assert_array_equal(out.numpy()[:430, off:off + dp],
                                  table[:, cols[:430]].T)


@pytest.mark.parametrize("dtype,n_out", [("float32", 512), ("bfloat16", 2048)])
def test_segsum_unsorted_matches_pallas(dtype, n_out):
    """Ids in any order, with -1 pads and ids at or past n_out (which add
    nothing), against streamed_segsum_unsorted."""
    rng = np.random.default_rng(n_out)
    n = 3000
    seg = rng.integers(-1, n_out + 40, size=n).astype(np.int32)
    seg[:400] = 7  # one hot id
    g32 = rng.normal(size=(n, 24)).astype(np.float32)
    g_j = jnp.asarray(g32).astype(getattr(jnp, dtype))
    ref = streamed_segsum_unsorted(g_j, jnp.asarray(seg), n_out,
                                   matmul_dtype=jnp.float32, interpret=True)
    out = segsum_unsorted(_t(g32).to(getattr(torch, dtype)), _t(seg), n_out)
    assert out.shape == (24, n_out) and out.dtype == torch.float32
    # f32 sums over the same terms in another order (bf16 inputs are
    # exact in f32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)


def _col_slots(rng, fold, n_uq, n_sent, dups=0):
    """Sorted storage columns of distinct ids (folded tables share a
    column between neighbouring ids), ``dups`` repeated slots, sentinel
    pads; and each slot's fold sub-row."""
    ids = np.sort(rng.choice(VC * fold, size=n_uq, replace=False))
    if dups:
        ids = np.sort(np.concatenate([ids, rng.choice(ids, dups)]))
    ids = np.concatenate([ids, np.full(n_sent, SENT)]).astype(np.int32)
    return ids // fold, ids % fold


def _aug(rng, dp, dim, fold, sub, scale=10.0):
    """[Dp+8, U] touch-augmented gradients as the step builds them: folded
    slots masked to their sublane; every fifth slot a zero gradient;
    every seventh slot's touch rows zeroed (an absent tiny-group id) with
    a gradient that must not apply."""
    n = sub.size
    g = (rng.normal(size=(dp, n)) * scale).astype(np.float32)
    if fold > 1:
        g *= (np.arange(dp)[:, None] // dim == sub[None, :])
    g[:, ::5] = 0.0
    aug = make_aug_grads(_t(g), _t(sub) if fold > 1 else None).numpy().copy()
    aug[dp:, 3::7] = 0.0
    return aug


@pytest.mark.parametrize("fold,dim,dp,state_dtype", [
    (1, 12, 16, "float32"),   # padded sublanes 12..15, duplicated slots
    (1, 64, 64, "bfloat16"),
    (8, 1, 8, "float32"),     # folded wide table: duplicate columns
])
def test_adam_cols_matches_pallas(fold, dim, dp, state_dtype):
    rng = np.random.default_rng(fold * 100 + dim)
    cols, sub = _col_slots(rng, fold, n_uq=600, n_sent=44,
                           dups=20 if fold == 1 else 0)
    aug = _aug(rng, dp, dim, fold, sub)
    table = (rng.normal(size=(dp, VC)) * 0.01).astype(np.float32)
    m = (rng.normal(size=(dp, VC)) * 1e-3).astype(np.float32)
    v = np.abs(rng.normal(size=(dp, VC)) * 1e-6).astype(np.float32)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-6, loss_scale=1000.0)
    lr_t = 1e-3 * np.sqrt(1 - 0.999**2) / (1 - 0.9**2)
    sd_j = getattr(jnp, state_dtype)
    ref = stream_update.streamed_adam_cols(
        jnp.asarray(table), jnp.asarray(m).astype(sd_j),
        jnp.asarray(v).astype(sd_j), jnp.asarray(cols), jnp.asarray(aug),
        jnp.float32(lr_t), dim=dim, fold=fold, tile=256, chunk=256,
        matmul_dtype=jnp.float32, interpret=True, **hyper,
    )
    sd_t = getattr(torch, state_dtype)
    t_t, m_t, v_t = _t(table), _t(m).to(sd_t), _t(v).to(sd_t)
    out = adam_cols(t_t, m_t, v_t, _t(cols), _t(aug),
                    torch.tensor(lr_t, dtype=torch.float32), dim=dim,
                    fold=fold, **hyper)
    assert out[0] is t_t and out[2] is v_t  # in place
    # tolerances as the rows test: the reference's one-hot f32 dot; a
    # bf16 moment may round to its neighbour
    for got, want in zip(out, ref):
        rtol = 2.0**-7 if got.dtype == torch.bfloat16 else 2e-5
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=rtol, atol=1e-8)


@pytest.mark.parametrize("fold,dim,dp", [(8, 1, 8), (1, 16, 16)])
def test_ftrl_cols_matches_pallas(fold, dim, dp):
    rng = np.random.default_rng(fold + 7)
    cols, sub = _col_slots(rng, fold, n_uq=700, n_sent=68)
    aug = _aug(rng, dp, dim, fold, sub)
    table = (rng.normal(size=(dp, VC)) * 0.01).astype(np.float32)
    accum = (0.1 + np.abs(rng.normal(size=(dp, VC)))).astype(np.float32)
    linear = (rng.normal(size=(dp, VC)) * 0.1).astype(np.float32)
    hyper = dict(learning_rate=5e-2, l1=5e-4, l2=5e-4, loss_scale=1000.0)
    ref = stream_update.streamed_ftrl_cols(
        jnp.asarray(table), jnp.asarray(accum), jnp.asarray(linear),
        jnp.asarray(cols), jnp.asarray(aug), dim=dim, fold=fold, tile=256,
        chunk=256, matmul_dtype=jnp.float32, interpret=True, **hyper,
    )
    out = ftrl_cols(_t(table), _t(accum), _t(linear), _t(cols), _t(aug),
                    dim=dim, fold=fold, **hyper)
    for got, want in zip(out, ref):
        # as the rows test: G from the reference's one-hot f32 dot, carried
        # through the cancellation in (sign*l1 - lin')
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("kind,fold", [("adam", 1), ("adam", 8),
                                       ("ftrl", 1), ("ftrl", 8)])
def test_col_updates_touch_rules(kind, fold):
    """Lazy-update semantics, element by element: exactly the sublanes
    gated by a nonzero touch row change (zero-gradient slots too);
    sentinel columns, zeroed touch rows, untouched columns and a folded
    column's other sublanes keep every value."""
    rng = np.random.default_rng(31 + fold)
    dim, dp = (1, 8) if fold > 1 else (16, 16)
    cols, sub = _col_slots(rng, fold, n_uq=300, n_sent=12)
    aug = _aug(rng, dp, dim, fold, sub)
    table = _t(rng.normal(size=(dp, VC)).astype(np.float32) * 1e-2)
    # |s1| bounded away from 0, so a zero-gradient Adam step still moves
    # every touched weight by more than its rounding
    s1 = _t((rng.choice([-1.0, 1.0], size=(dp, VC))
             * rng.uniform(0.5, 1.5, size=(dp, VC))).astype(np.float32) * 1e-2)
    s2 = _t(1.0 + np.abs(rng.normal(size=(dp, VC))).astype(np.float32))
    before = [x.clone() for x in (table, s1, s2)]
    if kind == "adam":  # m = s1, v = s2
        adam_cols(table, s1, s2, _t(cols), _t(aug), torch.tensor(1e-3),
                  dim=dim, fold=fold)
    else:  # accum = s2 (> 0), linear = s1
        ftrl_cols(table, s2, s1, _t(cols), _t(aug), dim=dim, fold=fold)
    expect = np.zeros((dp, VC), bool)
    for u, c in enumerate(cols):
        if c >= VC:
            continue
        if fold == 1:
            expect[:, c] |= aug[dp, u] > 0
        else:
            expect[:fold, c] |= aug[dp:dp + fold, u] > 0
    for new, old in zip((table, s1, s2), before):
        changed = (new != old).numpy()
        assert not (changed & ~expect).any(), "an untouched element changed"
    assert (table != before[0]).numpy()[expect].all()
    live = cols < VC
    assert ((aug[:dp, live] == 0).all(axis=0) & (aug[dp:, live] > 0).any(axis=0)).any()
    assert ((aug[dp:, live] == 0).all(axis=0) & (aug[:dp, live] != 0).any(axis=0)).any()


def test_make_aug_grads_matches_reference():
    rng = np.random.default_rng(3)
    g = rng.normal(size=(8, 50)).astype(np.float32)
    sub = rng.integers(0, 8, size=50).astype(np.int32)
    for s in (None, sub):
        want = stream_update.make_aug_grads(
            jnp.asarray(g), None if s is None else jnp.asarray(s))
        got = make_aug_grads(_t(g), None if s is None else _t(s))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_new_wrappers_take_plain_only_on_cpu():
    """The four feature-major kernels: CPU tensors count no launch; meta
    tensors (a device without kernels) raise rather than fall back."""
    kernels.reset_launches()
    t = torch.zeros((8, 64))
    cols = torch.tensor([0, 0, 3, SENT // 8], dtype=torch.int32)
    gather_rows(t, cols, torch.zeros((4, 128)), 8)
    segsum_unsorted(torch.ones((4, 2)), cols, 16)
    aug = torch.ones((16, 4))
    adam_cols(t, t.clone(), t.clone(), cols, aug, torch.tensor(1e-3), dim=1,
              fold=8)
    ftrl_cols(t, t + 1.0, t.clone(), cols, aug, dim=1, fold=8)
    assert sum(kernels.LAUNCHES.values()) == 0
    m = torch.zeros((8, 64), device="meta")
    mc = cols.to("meta")
    with pytest.raises(ValueError, match="gather_rows"):
        gather_rows(m, mc, torch.zeros((4, 128), device="meta"), 8)
    with pytest.raises(ValueError, match="segsum_unsorted"):
        segsum_unsorted(torch.ones((4, 2), device="meta"), mc, 16)
    with pytest.raises(ValueError, match="adam_cols"):
        adam_cols(m, m, m, mc, aug.to("meta"), torch.zeros((), device="meta"),
                  dim=1, fold=8)
    with pytest.raises(ValueError, match="ftrl_cols"):
        ftrl_cols(m, m, m, mc, aug.to("meta"), dim=1, fold=8)


@pytest.mark.parametrize("emb_dim", [1, 12, 64, 128])
def test_feature_major_storage_and_lookup_match(emb_dim):
    """Feature-major specs (fold 8 at emb_dim 1, sublane padding at 12):
    storage bytes, from_storage and lookup equal the reference's."""
    kw = dict(vocab_size=3000, emb_dim=emb_dim, sparse=True,
              layout="feature_major")
    js, ts = jemb.EmbeddingTableSpec(**kw), temb.EmbeddingTableSpec(**kw)
    for attr in ("padded_vocab", "fold", "padded_dim", "storage_shape",
                 "feature_major", "row_packed"):
        assert getattr(ts, attr) == getattr(js, attr), attr
    rng = np.random.default_rng(emb_dim)
    logical = rng.normal(size=(js.padded_vocab, emb_dim)).astype(np.float32)
    st_j = np.asarray(jemb.to_storage(js, jnp.asarray(logical)))
    st_t = temb.to_storage(ts, _t(logical)).numpy()
    assert st_t.shape == st_j.shape and st_t.tobytes() == st_j.tobytes()
    np.testing.assert_array_equal(temb.from_storage(ts, _t(st_t)).numpy(),
                                  jemb.from_storage(js, st_j))
    ids = rng.integers(0, 3001, size=(7, 5)).astype(np.int32)
    want = np.asarray(jemb.EmbeddingLookup(js)(jnp.asarray(st_j), jnp.asarray(ids)))
    got = temb.lookup(ts, _t(st_t), _t(ids)).numpy()
    np.testing.assert_array_equal(got, want)


def test_multitable_recipe_storage_shapes():
    """The multitable recipe's feature-major tables: emb128 [128, 655360],
    w128 [8, 81920] (fold 8), the indicator pair [64, 8192] / [8, 1024]."""
    def spec(v, d):
        return temb.EmbeddingTableSpec(v, d, sparse=True, layout="feature_major")
    assert spec(650000, 128).storage_shape == (128, 655360)
    assert spec(650000, 1).storage_shape == (8, 81920)
    assert spec(16, 64).storage_shape == (64, 8192)
    assert spec(16, 1).storage_shape == (8, 1024)
    assert spec(20900, 64).storage_shape == (64, 24576)


# ---------------------------------------------------------------------------
# the column-major twins against the row-major kernels' plain versions
# (their parity with the Pallas kernels is in tests/test_torch_colpath.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segsum_cols_is_segsum_sorted_of_the_transpose(dtype):
    """Kernels 1 and 4 compute one function on transposed inputs: same
    segments, same float32 sums (up to their order), same zero tail."""
    rng = np.random.default_rng(5)
    uidx = _t(_uidx(rng, 900, 6))
    g = _t(rng.normal(size=(900, 24)).astype(np.float32)).to(
        getattr(torch, dtype))
    rows = segsum_sorted(g, uidx, 1024)
    cols = segsum_cols(g.T.contiguous(), uidx, 1024)
    assert cols.shape == rows.shape == (24, 1024) and cols.is_contiguous()
    torch.testing.assert_close(cols, rows, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fold", [1, 8])
def test_gather_cols_is_gather_rows_transposed(fold):
    """Kernels 8 and 9 read the same columns; the column-major one writes
    zeros where the row-major one keeps its (zeroed) buffer."""
    rng = np.random.default_rng(6 + fold)
    dp = 8 if fold > 1 else 16
    cols, _sub = _col_slots(rng, fold, n_uq=300, n_sent=84)
    table = _t(rng.normal(size=(dp, VC)).astype(np.float32))
    rows = gather_rows(table, _t(cols), torch.zeros((cols.size, 128)), 0)
    out = gather_cols(table, _t(cols))
    np.testing.assert_array_equal(out.numpy(), rows.numpy()[:, :dp].T)
