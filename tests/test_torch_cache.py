"""The port's hierarchical embedding cache against the JAX package: the
LRU (native, Python, and the reference's native LRU), the host tiers,
row reads and writes in every storage convention, and cache-mode
training (serial, pipelined, through ``RecModel``).

State is made once in JAX and carried over by ``convert.state_from_jax``;
the JAX step runs its streamed Pallas path in interpret mode.  The
reference's ``HostTier`` default init draws the same first vectors on
every call (``ROADMAP.md`` section 3, reference fault 3), so parity
tests give both sides' param tiers the same ``init_fn`` by setting the
tiers' ``_init_fn`` attribute.
"""

import functools
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindrec_tpu.models import wide_deep as jwd
from mindrec_tpu.ops import cache as jcache
from mindrec_tpu.ops import embedding as jemb
from mindrec_tpu.ops.pallas import stream_update
from mindrec_tpu.train import cached as jcached
from mindrec_tpu.train import optim as jopt
from mindrec_tpu.train import step as jstep
from mindrec_tpu_torch import convert
from mindrec_tpu_torch.models import wide_deep
from mindrec_tpu_torch.ops import cache
from mindrec_tpu_torch.ops.embedding import (
    EmbeddingTableSpec, read_rows, write_rows,
)
from mindrec_tpu_torch.train import cached, optim
from mindrec_tpu_torch.train.rec_model import RecModel
from mindrec_tpu_torch.train.step import init_train_state, make_train_step

V, F, B, D = 512, 4, 8, 8  # virtual vocab, fields, batch, emb dim
STEPS = 6


@pytest.fixture(autouse=True)
def _interpret_kernels():
    stream_update.INTERPRET = True
    yield
    stream_update.INTERPRET = False


def _dead_addr() -> str:
    """A localhost address nothing listens on."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def port_lrus(capacity):
    return {"native": cache.LruCache(capacity),
            "python": cache.LruCache(capacity, prefer_native=False)}


# ---------------------------------------------------------------------------
# LRU
# ---------------------------------------------------------------------------


def test_lru_churn_matches_reference():
    """Long eviction churn over a 10x-capacity id space (with duplicates
    in a batch and sentinel-valued keys): the port's native and Python
    LRUs give the reference native LRU's slots, load and evict lists
    exactly, step for step."""
    ref = jcache.NativeLruCache(64)
    ports = port_lrus(64)
    rng = np.random.default_rng(7)
    lo = np.iinfo(np.int64).min
    for step in range(300):
        ids = rng.integers(0, 640, size=24)
        if step % 37 == 0:
            ids[:2] = [lo, lo + 1]
        want = ref.lookup(ids)
        for name, lru in ports.items():
            got = lru.lookup(ids)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b, err_msg=f"{name} @ {step}")
        assert len(ports["native"]) == len(ports["python"]), step
    # the reference's native size() drops resident sentinel-valued keys
    # after a rebuild of its map (ROADMAP.md section 3, reference fault 4)
    assert len(ref) < len(ports["native"])


@pytest.mark.parametrize("kind", ["native", "python"])
def test_lru_hit_miss_and_eviction_order(kind):
    lru = port_lrus(3)[kind]
    slots, load_ids, _, evict_ids, _ = lru.lookup([10, 20, 10])
    assert slots[0] == slots[2] and sorted(load_ids.tolist()) == [10, 20]
    assert evict_ids.size == 0
    slots2, load2, _, evict2, _ = lru.lookup([20, 10])
    assert load2.size == 0 and evict2.size == 0 and slots2[0] == slots[1]
    lru.lookup([30])
    lru.lookup([10])  # LRU order now 20, 30, 10
    _, load_ids, load_slots, evict_ids, evict_slots = lru.lookup([40])
    assert evict_ids.tolist() == [20] and load_ids.tolist() == [40]
    assert load_slots.tolist() == evict_slots.tolist()  # slot recycled


@pytest.mark.parametrize("kind", ["native", "python"])
def test_lru_sentinel_valued_keys(kind):
    """INT64_MIN and INT64_MIN + 1 are the native map's empty and
    tombstone values; they behave like any other id."""
    lru = port_lrus(4)[kind]
    lo = np.iinfo(np.int64).min
    ids = np.array([lo, lo + 1, 7], np.int64)
    slots, *_ = lru.lookup(ids)
    assert len(set(slots.tolist())) == 3
    slots2, load2, *_ = lru.lookup(ids)
    np.testing.assert_array_equal(slots, slots2)
    assert load2.size == 0
    lru.lookup(np.array([100, 101, 102, 103], np.int64))  # evicts them
    slots4, load4, *_ = lru.lookup(ids)
    assert load4.size == 3 and len(set(slots4.tolist())) == 3


@pytest.mark.parametrize("kind", ["native", "python"])
def test_lru_pins_current_batch(kind):
    """Ids of the batch never evict each other: with capacity 3, a batch
    of 4 distinct ids gets 3 distinct slots and one -1; a resident id met
    after a miss is not evicted by it."""
    lru = port_lrus(3)[kind]
    slots, *_ = lru.lookup([1, 2, 3, 4])
    live = slots[slots >= 0].tolist()
    assert len(live) == 3 and len(set(live)) == 3 and (slots < 0).sum() == 1
    lru2 = port_lrus(2)[kind]
    lru2.lookup([5])
    lru2.lookup([6])  # 5 is least recent
    slots, load_ids, _, evict_ids, _ = lru2.lookup([7, 5])
    assert evict_ids.tolist() == [6] and load_ids.tolist() == [7]
    assert slots[1] >= 0


def test_lru_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "cache.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(cache, "SRC", bad)
    monkeypatch.setattr(cache, "_lib", None)
    monkeypatch.setattr(cache.native_build, "BUILD_ROOT", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="failed to build cache.cc"):
        cache.LruCache(4)


# ---------------------------------------------------------------------------
# host tiers
# ---------------------------------------------------------------------------


def test_host_tier_ram_ssd_split_matches_reference(tmp_path):
    """A 50-row RAM cap over 100 ids: RAM and SSD rows, lazy init order
    and write-backs give the reference's bytes when both tiers draw from
    the same generator."""
    dim = 8
    port = cache.HostTier(100, dim, ram_bytes=50 * dim * 4,
                          spill_dir=str(tmp_path / "p"))
    ref = jcache.HostTier(100, dim, ram_bytes=50 * dim * 4,
                          spill_dir=str(tmp_path / "r"))
    gens = [np.random.default_rng(11), np.random.default_rng(11)]
    for tier, g in zip((port, ref), gens):
        tier._init_fn = lambda n, g=g: g.normal(0, 0.01, (n, dim)).astype(np.float32)
    assert port.ram_rows == ref.ram_rows == 50
    rng = np.random.default_rng(3)
    for _ in range(6):
        ids = rng.integers(0, 100, 12)
        np.testing.assert_array_equal(port.read(ids), ref.read(ids))
        w_ids = rng.choice(100, 5, replace=False)
        w = rng.normal(size=(5, dim)).astype(np.float32)
        port.write(w_ids, w)
        ref.write(w_ids, w)
    everything = np.arange(100)
    np.testing.assert_array_equal(port.read(everything), ref.read(everything))
    assert list((tmp_path / "p").glob("emb_spill_*.bin"))
    assert port.ssd_rows_used == len(ref._ssd_index)


def test_host_tier_draws_in_order_not_fault_3(tmp_path):
    """Reference fault 3: the reference's default init hands the rows
    first read in every call the same vectors.  The port's tier draws
    from one generator in order: sorted fresh RAM ids, then sorted fresh
    SSD ids, call after call."""
    ref = jcache.HostTier(1000, 4, seed=0)
    assert np.array_equal(ref.read([1, 2]), ref.read([10, 11]))  # the fault
    t = cache.HostTier(1000, 4, ram_bytes=500 * 16, spill_dir=str(tmp_path),
                       seed=0)
    g = np.random.default_rng(0)
    a = t.read([2, 1])
    np.testing.assert_array_equal(a[::-1], g.normal(0, 0.01, (2, 4)).astype(np.float32))
    b = t.read([700, 11, 10, 600, 1])  # two fresh RAM, two fresh SSD ids
    ram = g.normal(0, 0.01, (2, 4)).astype(np.float32)
    ssd = g.normal(0, 0.01, (2, 4)).astype(np.float32)
    np.testing.assert_array_equal(b[[2, 1]], ram)
    np.testing.assert_array_equal(b[[3, 0]], ssd)
    np.testing.assert_array_equal(b[4], a[1])  # id 1 kept its row
    assert not np.array_equal(a, b[1:3])


def test_cache_swap_recycles_a_slot_within_a_batch():
    """Evicted rows are read before the load: a slot evicted and loaded
    in one swap hands out its old row; pads hit the dummy row with
    zeros."""
    arena = torch.arange(20.0).reshape(5, 4)
    old = arena.clone()
    out, evicted = cache.cache_swap(
        arena, evict_slots=torch.tensor([1, 4, 4]),
        load_slots=torch.tensor([1, 4, 4]),
        load_rows=torch.tensor([[7.0] * 4, [0.0] * 4, [0.0] * 4]))
    assert out is arena
    torch.testing.assert_close(evicted, old[[1, 4, 4]], rtol=0, atol=0)
    torch.testing.assert_close(arena[1], torch.full((4,), 7.0), rtol=0, atol=0)
    assert not arena[4].any()


def test_cached_embedding_table_round_trip(tmp_path):
    """prepare -> swap -> writeback -> flush_all keeps every id's row and
    state row, through evictions and the SSD tier."""
    tab = cache.CachedEmbeddingTable(
        vocab_size=1000, dim=4, cache_rows=8, max_swap=16, ram_bytes=300 * 16,
        spill_dir=str(tmp_path), state_names=("m",))
    arena, m = tab.init_arena("cpu"), tab.init_state_arena("m", "cpu")
    truth = {}
    rng = np.random.default_rng(1)
    for step in range(12):
        ids = rng.choice([3, 5, 9, 400, 401, 777, 12, 13, 14, 999], 4,
                         replace=False)
        prep = tab.prepare(ids)
        ls, es = (torch.from_numpy(prep[k]).long() for k in ("load_slots",
                                                              "evict_slots"))
        _, ev = cache.cache_swap(arena, es, ls,
                                 torch.from_numpy(prep["load_rows"]["param"]))
        _, ev_m = cache.cache_swap(m, es, ls,
                                   torch.from_numpy(prep["load_rows"]["m"]))
        tab.writeback(prep["evict_ids"], {"param": ev, "m": ev_m})
        slots = torch.from_numpy(prep["slots"]).long()
        for i, s in zip(ids.tolist(), slots.tolist()):
            arena[s] = float(step * 1000 + i)  # "train" the rows
            m[s] = float(i)
            truth[i] = float(step * 1000 + i)
    tab.flush_all(arena, {"m": m})
    ids = np.array(sorted(truth))
    np.testing.assert_array_equal(tab.param_tier.read(ids)[:, 0],
                                  [truth[i] for i in ids])
    np.testing.assert_array_equal(tab.state_tiers["m"].read(ids)[:, 0], ids)
    assert tab.param_tier.ssd_rows_used > 0
    # remote tiers (PS mode) connect to their servers when built
    with pytest.raises(ConnectionRefusedError):
        cache.CachedEmbeddingTable(10, 4, 4, 4, remote_addrs=[_dead_addr()])


# ---------------------------------------------------------------------------
# row reads and writes, every storage convention
# ---------------------------------------------------------------------------

LAYOUTS = {
    "row_packed": dict(sparse=True, emb_dim=8),
    "row_major": dict(sparse=False, emb_dim=8),
    "feature_major": dict(sparse=True, emb_dim=12, layout="feature_major"),
    "feature_major_fold8": dict(sparse=True, emb_dim=1, layout="feature_major"),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_read_write_rows_match_reference(layout):
    """read_rows and write_rows against the reference's on a random
    storage array, bit for bit; write_rows writes in place."""
    kw = LAYOUTS[layout]
    jspec = jemb.EmbeddingTableSpec(vocab_size=3000, **kw)
    spec = EmbeddingTableSpec(vocab_size=3000, **kw)
    assert (spec.row_packed, spec.feature_major, spec.fold) == (
        jspec.row_packed, jspec.feature_major, jspec.fold)
    rng = np.random.default_rng(5)
    storage = rng.normal(size=spec.storage_shape).astype(np.float32)
    ids = rng.choice(3000, 300, replace=False)
    t = torch.from_numpy(storage.copy())
    np.testing.assert_array_equal(read_rows(spec, t, ids).numpy(),
                                  jemb.read_rows(jspec, storage, ids))
    rows = rng.normal(size=(300, spec.emb_dim)).astype(np.float32)
    want = np.asarray(jemb.write_rows(jspec, jnp.asarray(storage), ids, rows))
    ptr = t.data_ptr()
    out = write_rows(spec, t, torch.from_numpy(ids), rows)
    assert out is t and t.data_ptr() == ptr
    np.testing.assert_array_equal(t.numpy(), want)


# ---------------------------------------------------------------------------
# cache-mode training
# ---------------------------------------------------------------------------


def _batches(seed=3, n=STEPS, vocab=V):
    rng = np.random.default_rng(seed)
    return [{
        "ids": rng.integers(0, vocab, (B, F)).astype(np.int64),
        "wts": rng.normal(size=(B, F)).astype(np.float32),
        "label": rng.integers(0, 2, (B, 1)).astype(np.float32),
    } for _ in range(n)]


def _cfg(cache_rows, layout):
    return dict(batch_size=B, field_size=F, vocab_size=cache_rows, emb_dim=D,
                deep_layer_dim=(16, 8), sparse=True, loss_scale=1.0,
                use_mixed_precision=False, table_layout=layout)


def _seed_tiers(adapter, seed=7):
    """Write per-id rows into every param tier (the same for every run),
    so that runs with other cache sizes start from one virtual table."""
    rng = np.random.default_rng(seed)
    for tiers in adapter.tiers.values():
        d = tiers["param"].dim
        tiers["param"].write(np.arange(V),
                             rng.normal(0, 0.01, (V, d)).astype(np.float32))


def _same_init(adapters):
    """Give the param tiers of every adapter the same init_fn (one
    generator per table and adapter, seeded alike)."""
    for adapter in adapters:
        for j, tiers in enumerate(adapter.tiers.values()):
            g = np.random.default_rng(100 + j)
            d = tiers["param"].dim
            tiers["param"]._init_fn = (
                lambda n, g=g, d=d: g.normal(0, 0.01, (n, d)).astype(np.float32))


def _touched_rows(adapter, batches):
    touched = np.unique(np.concatenate([b["ids"].reshape(-1) for b in batches]))
    return {(n, t): adapter.tiers[n][t].read(touched)
            for n in adapter.tiers for t in adapter.tiers[n]}


def _port_run(cache_rows, tmp_path, batches, layout="auto", mode="serial",
              seed_tiers=True):
    model = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**_cfg(cache_rows, layout)))
    opts = (optim.ftrl(loss_scale=1.0), optim.lazy_adam(loss_scale=1.0))
    state = init_train_state(model, 0, *opts, device="cpu")
    adapter = cached.CachedTrainingAdapter(
        model, virtual_vocab=V, cache_rows=cache_rows, max_swap=B * F + 8,
        ram_bytes=300 * D * 4, spill_dir=str(tmp_path))
    if seed_tiers:
        _seed_tiers(adapter)
    step = make_train_step(model, *opts)
    losses = []
    if mode == "async":
        trainer = cached.AsyncCachedTrainer(adapter, step, state)
        for b in batches:
            losses.append(float(trainer.step(b)[1]))
        state = trainer.finish()
    else:
        for b in batches:
            state, (_lw, ld) = cached.cached_train_step(adapter, step, state, b)
            losses.append(float(ld))
    adapter.flush_all(state)
    return losses, _touched_rows(adapter, batches), state


@pytest.mark.parametrize("layout", ["auto", "feature_major"])
def test_cached_training_matches_reference(layout, tmp_path):
    """Four cache-mode steps with a 40-row cache (evictions and reloads
    every step, the SSD tier in use), port against the reference's
    adapter and streamed step: losses within rtol 1e-5, every touched
    tier row and the final state within rtol 1e-4 / atol 1e-8 (XLA and
    PyTorch sum the MLP's products in other orders, ~1e-7 relative,
    which Adam's m/sqrt(v) can amplify a little); the LRU traffic is
    the same (the same loads and evictions)."""
    cache_rows, batches = 40, _batches(n=4)
    kw = _cfg(cache_rows, layout)
    jm = jwd.WideDeepModel(jwd.WideDeepConfig(**kw))
    tm = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**kw))
    jo = (jopt.ftrl(loss_scale=1.0), jopt.lazy_adam(loss_scale=1.0))
    to = (optim.ftrl(loss_scale=1.0), optim.lazy_adam(loss_scale=1.0))
    js = jstep.init_train_state(jm, jax.random.PRNGKey(0), *jo)
    ts = convert.state_from_jax(*jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d)),
                                np.asarray(js.step), device="cpu")
    ja = jcached.CachedTrainingAdapter(
        jm, virtual_vocab=V, cache_rows=cache_rows, max_swap=B * F + 8,
        ram_bytes=300 * D * 4, spill_dir=str(tmp_path / "ref"))
    ta = cached.CachedTrainingAdapter(
        tm, virtual_vocab=V, cache_rows=cache_rows, max_swap=B * F + 8,
        ram_bytes=300 * D * 4, spill_dir=str(tmp_path / "port"))
    _same_init([ja, ta])
    j_fn = jstep.make_train_step(jm, *jo, jit=True, donate=False,
                                 use_pallas=True, matmul_dtype=jnp.float32)
    t_fn = make_train_step(tm, *to, matmul_dtype=torch.float32)
    for b in batches:
        jp, tp = ja.prepare(b), ta.prepare(b)
        for k in ("slots", "load_ids", "evict_ids"):
            np.testing.assert_array_equal(tp[k], jp[k])
        js = ja.apply_swap(js, jp)
        ja.writeback(jp)
        js, (_, jld) = j_fn(js, ja.transform(b, jp))
        ts = ta.apply_swap(ts, tp)
        ta.writeback(tp)
        ts, (_, tld) = t_fn(ts, ta.transform(b, tp))
        np.testing.assert_allclose(float(tld), float(jld), rtol=1e-5)
    ja.flush_all(js)
    ta.flush_all(ts)
    want, got = _touched_rows(ja, batches), _touched_rows(ta, batches)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-8,
                                   err_msg=str(k))
    ref = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d)))[0]
    port = jax.tree_util.tree_flatten(convert.state_to_jax(ts)[:3])[0]
    for (path, a), b in zip(ref, port):
        np.testing.assert_allclose(np.asarray(b, np.float32),
                                   np.asarray(a, np.float32), rtol=1e-4,
                                   atol=1e-8, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("layout", ["auto", "feature_major"])
def test_cache_size_invariance(layout, tmp_path):
    """A 40-row cache (constant evict / reload traffic through the RAM and
    SSD tiers) trains every id's row and optimizer state exactly as a
    cache that holds every id: rows and their state migrate losslessly
    (bit for bit: the same float32 operations on the same values)."""
    batches = _batches()
    small = _port_run(40, tmp_path / "a", batches, layout)
    big = _port_run(V, tmp_path / "b", batches, layout)
    assert small[0] == big[0]
    for k in small[1]:
        np.testing.assert_array_equal(small[1][k], big[1][k], err_msg=str(k))


def test_async_trainer_equals_serial_protocol(tmp_path):
    """The pipelined trainer gives the serial protocol's losses, tier rows
    and final state bit for bit."""
    batches = _batches(seed=9)
    serial = _port_run(40, tmp_path / "s", batches, seed_tiers=False)
    pipelined = _port_run(40, tmp_path / "p", batches, mode="async",
                          seed_tiers=False)
    assert serial[0] == pipelined[0]
    for k in serial[1]:
        np.testing.assert_array_equal(serial[1][k], pipelined[1][k])
    for a, b in zip(jax.tree_util.tree_leaves(convert.state_to_jax(serial[2])),
                    jax.tree_util.tree_leaves(convert.state_to_jax(pipelined[2]))):
        np.testing.assert_array_equal(a, b)


def test_async_trainer_dead_worker_raises_at_once(tmp_path):
    """When the worker dies (here a tier read fails on the second batch),
    the step that meets the error raises it and the next step raises at
    once instead of blocking (the reference's trainer hangs there); each
    call is held to a 10 s timeout."""
    model = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**_cfg(40, "auto")))
    opts = (optim.ftrl(loss_scale=1.0), optim.lazy_adam(loss_scale=1.0))
    state = init_train_state(model, 0, *opts, device="cpu")
    adapter = cached.CachedTrainingAdapter(
        model, virtual_vocab=V, cache_rows=40, max_swap=B * F + 8,
        )
    tier = adapter.tiers["deep"]["param"]
    calls = {"n": 0}
    real = tier.read

    def flaky(ids):
        calls["n"] += 1
        if calls["n"] > 1:
            raise OSError("disk gone")
        return real(ids)

    tier.read = flaky
    trainer = cached.AsyncCachedTrainer(adapter, make_train_step(model, *opts),
                                        state)
    batches = _batches(n=3)
    outcome = {}

    def call(name, fn):
        try:
            fn()
            outcome[name] = None
        except Exception as e:  # noqa: BLE001 - the outcome under test
            outcome[name] = e

    for name, fn in [("first", lambda: trainer.step(batches[0])),
                     ("second", lambda: trainer.step(batches[1])),
                     ("third", lambda: trainer.step(batches[2])),
                     ("finish", trainer.finish)]:
        th = threading.Thread(target=call, args=(name, fn), daemon=True)
        t0 = time.perf_counter()
        th.start()
        th.join(10.0)
        assert not th.is_alive(), f"{name} blocked"
        assert time.perf_counter() - t0 < 10.0
    assert outcome["first"] is None
    assert isinstance(outcome["second"], OSError)
    assert isinstance(outcome["third"], RuntimeError)
    assert isinstance(outcome["finish"], RuntimeError)


def test_cached_edges(tmp_path):
    """An id past the RAM cap lands in the spill file; a batch with more
    distinct ids than the cache raises; remote tiers connect to their
    servers when built, so a dead address raises there."""
    model = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**{
        **_cfg(64, "auto"), "deep_layer_dim": (16,)}))
    opts = (optim.ftrl(loss_scale=1.0), optim.lazy_adam(loss_scale=1.0))
    adapter = cached.CachedTrainingAdapter(
        model, virtual_vocab=10_000_000_000, cache_rows=64, max_swap=B * F + 8,
        ram_bytes=256 * D * 4, spill_dir=str(tmp_path))
    state = init_train_state(model, 0, *opts, device="cpu")
    b = {"ids": np.array([[5, 9_999_999_999, 12, 5]] * B, np.int64),
         "wts": np.ones((B, F), np.float32), "label": np.ones((B, 1), np.float32)}
    state, (lw, ld) = cached.cached_train_step(adapter, make_train_step(model, *opts),
                                               state, b)
    assert np.isfinite(float(lw)) and np.isfinite(float(ld))
    adapter.flush_all(state)
    assert 9_999_999_999 in adapter.tiers["deep"]["param"]._ssd_index
    small = cached.CachedTrainingAdapter(
        wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**_cfg(8, "auto"))),
        virtual_vocab=V, cache_rows=8, max_swap=64)
    with pytest.raises(RuntimeError, match="thrash"):
        small.prepare({"ids": np.arange(B * F, dtype=np.int64).reshape(B, F)})
    with pytest.raises(ConnectionRefusedError):
        cached.CachedTrainingAdapter(model, V, 64, 64,
                                     remote_addrs=[_dead_addr()])


def test_wide_deep_regimes_build():
    """The cache and dynamic regimes build the plain model (the adapters
    carry them); PS mode builds host tables without the cache and device
    tables with it."""
    kw = _cfg(64, "auto")
    for extra in ({"vocab_cache_size": 32}, {"dynamic_embedding": True},
                  {"vocab_cache_size": 32, "parameter_server": True}):
        m = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**{**kw, **extra}))
        assert m.deep_spec.vocab_size == 64 and m.deep_spec.target == "device"
    m = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**kw, parameter_server=True))
    assert m.deep_spec.target == m.wide_spec.target == "host"


def test_rec_model_drives_the_cache_regime(tmp_path):
    """RecModel with the reference example's wiring
    (``rm.train_step = partial(cached_train_step, adapter, rm.train_step)``
    and a wrapped eval): the wrapper gets host batches untouched, and the
    run equals the serial loop bit for bit; ``flush_all`` then a tier
    read returns the state's rows."""
    batches = _batches(seed=4)
    serial = _port_run(40, tmp_path / "s", batches, seed_tiers=False)
    model = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**_cfg(40, "auto")))
    rm = RecModel(model, optim.ftrl(loss_scale=1.0),
                  optim.lazy_adam(loss_scale=1.0), device="cpu")
    adapter = cached.CachedTrainingAdapter(
        model, virtual_vocab=V, cache_rows=40, max_swap=B * F + 8,
        ram_bytes=300 * D * 4, spill_dir=str(tmp_path / "r"))
    seen = []
    inner = rm.train_step

    def spy(state, batch):
        seen.append(type(batch["ids"]))
        return cached.cached_train_step(adapter, inner, state, batch)

    rm.train_step = spy
    orig_eval = rm.eval_step

    def cached_eval(params, batch):
        prep = adapter.prepare(batch)
        rm.state = adapter.apply_swap(rm.state, prep)
        adapter.writeback(prep)
        return orig_eval(rm.state.params, adapter.transform(batch, prep))

    rm.eval_step = cached_eval
    rm.train(1, batches, dataset_sink_mode=True)
    assert seen == [np.ndarray] * len(batches)
    adapter.flush_all(rm.state)
    got = _touched_rows(adapter, batches)
    for k in got:
        np.testing.assert_array_equal(got[k], serial[1][k], err_msg=str(k))
    res = rm.eval(_batches(seed=5, n=2))
    assert 0.0 <= res["auc"] <= 1.0
    rm.train_step = functools.partial(cached.cached_train_step, adapter, inner)
    rm.train(1, batches[:1], dataset_sink_mode=False)
    assert int(rm.state.step) == len(batches) + 1
