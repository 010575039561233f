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
from mindrec_tpu.ops.pallas.stream_segsum import streamed_segsum
from mindrec_tpu.ops.pallas.stream_update_rows import (
    streamed_adam_rows, streamed_ftrl_rows,
)
from mindrec_tpu_torch.ops import embedding as temb
from mindrec_tpu_torch.ops import kernels
from mindrec_tpu_torch.ops.kernels.segsum import segsum_sorted, segsum_sorted_plain
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
    assert kernels.LAUNCHES == {"segsum_sorted": 0, "adam_rows": 0,
                                "ftrl_rows": 0}
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
