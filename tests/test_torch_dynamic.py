"""The port's hash-based dynamic embeddings against the JAX package: the
hash store (native, Python, and the reference's native store),
admission, eviction with re-initialisation, the incremental export and
import, ``HashEmbeddingLookup``, ``EvictionCallback`` inside
``RecModel.online_train`` and dynamic-embedding training as a whole.

State is made once in JAX and carried over by ``convert.state_from_jax``;
the JAX step runs its streamed Pallas path in interpret mode.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindrec_tpu.models import wide_deep as jwd
from mindrec_tpu.native import hashstore as jhs
from mindrec_tpu.ops import embedding as jemb
from mindrec_tpu.ops.pallas import stream_update
from mindrec_tpu.train import dynamic as jdyn
from mindrec_tpu.train import optim as jopt
from mindrec_tpu.train import step as jstep
from mindrec_tpu_torch import convert
from mindrec_tpu_torch.data.criteo import to_device
from mindrec_tpu_torch.models import wide_deep
from mindrec_tpu_torch.native import hashstore
from mindrec_tpu_torch.ops.embedding import (
    HashEmbeddingLookup, from_storage, read_rows, to_storage,
)
from mindrec_tpu_torch.train import optim
from mindrec_tpu_torch.train.callbacks import EvictionCallback
from mindrec_tpu_torch.train.dynamic import DynamicEmbeddingAdapter
from mindrec_tpu_torch.train.rec_model import RecModel
from mindrec_tpu_torch.train.step import (
    init_train_state, make_train_step, map_leaves,
)

CAP, F, B, D = 96, 4, 8, 8  # arena capacity, fields, batch, emb dim


@pytest.fixture(autouse=True)
def _interpret_kernels():
    stream_update.INTERPRET = True
    yield
    stream_update.INTERPRET = False


def _key_stream(n_steps, seed=0, space=400):
    """Raw int64 keys: a fixed 64-bit hash of a skewed draw, so some keys
    recur (admitted) and others go idle (evicted)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        z = np.minimum(rng.zipf(1.3, size=(B, F)), space).astype(np.uint64)
        out.append(((z * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(1))
                   .astype(np.int64))
    return out


# ---------------------------------------------------------------------------
# hash store
# ---------------------------------------------------------------------------


def test_hash_store_matches_reference():
    """A random workload (admission at 2 steps, eviction after 3 idle
    steps, forced inserts, erases, a full arena) over 60 distinct keys,
    which fill at most half of the reference's 128 buckets: the port's
    native store gives the reference's native store's slots, freed slots,
    items and size exactly; the port's Python store the reference's
    Python store's; native and Python agree on which keys hold a slot
    until the first erase (the native store's erase forgets a pending
    key's sightings, the Python store's keeps them, in the reference as
    in the port)."""
    kw = dict(capacity=40, permit_threshold=2, evict_threshold=3)
    ref_n, ref_p = jhs.NativeHashStore(**kw), jhs.PyHashStore(**kw)
    nat, py = hashstore.HashStore(**kw), hashstore.HashStore(**kw, prefer_native=False)
    assert isinstance(nat, hashstore.NativeHashStore)
    rng = np.random.default_rng(1)
    for step, keys in enumerate(_key_stream(40, seed=2, space=60)):
        flat = keys.reshape(-1)
        force = step % 9 == 4
        got_n = nat.lookup_or_insert(flat, force=force)
        got_p = py.lookup_or_insert(flat, force=force)
        np.testing.assert_array_equal(got_n, ref_n.lookup_or_insert(flat, force=force))
        np.testing.assert_array_equal(got_p, ref_p.lookup_or_insert(flat, force=force))
        if step < 3:  # before any eviction the free stacks agree too
            np.testing.assert_array_equal(got_n, got_p)
        if step <= 10:
            np.testing.assert_array_equal(got_n >= 0, got_p >= 0)
        if step % 4 == 3:
            fn, fp = nat.evict(), py.evict()
            np.testing.assert_array_equal(fn, ref_n.evict())
            np.testing.assert_array_equal(fp, ref_p.evict())
            assert step > 10 or fn.size == fp.size
        if step % 11 == 10:
            gone = flat[rng.integers(0, flat.size, 3)]
            for st in (nat, py, ref_n, ref_p):
                st.erase(gone)
        for a, b in ((nat, ref_n), (py, ref_p)):
            for x, y in zip(a.items(), b.items()):
                np.testing.assert_array_equal(x, y)
            assert len(a) == len(b)
        if step < 10:
            assert np.array_equal(np.sort(nat.items()[0]),
                                  np.sort(py.items()[0]))


def test_hash_store_grows_past_the_reference_table():
    """Reference fault 5: the reference's native store sizes its bucket
    table once (2 x capacity, at least 16) and keeps pending keys in it
    forever, so 16 pending keys fill an 8-slot store's table and a forced
    import is refused with every slot free.  The port's table grows:
    the import gets a slot, and over a stream of 4,000 distinct keys
    (admission at 2, eviction after 3 idle steps) the native store
    admits and evicts exactly the keys the Python store does."""
    ref = jhs.NativeHashStore(8, permit_threshold=2)
    nat = hashstore.HashStore(8, permit_threshold=2)
    for st in (ref, nat):
        assert (st.lookup_or_insert(np.arange(16)) == -1).all()
    assert ref.lookup_or_insert(np.array([100]), force=True)[0] == -1
    assert nat.lookup_or_insert(np.array([100]), force=True)[0] == 0
    kw = dict(capacity=64, permit_threshold=2, evict_threshold=3)
    nat = hashstore.HashStore(**kw)
    py = hashstore.HashStore(**kw, prefer_native=False)
    for step, keys in enumerate(_key_stream(60, seed=5, space=4000)):
        np.testing.assert_array_equal(nat.lookup_or_insert(keys.reshape(-1)) >= 0,
                                      py.lookup_or_insert(keys.reshape(-1)) >= 0)
        if step % 3 == 2:
            assert nat.evict().size == py.evict().size
        assert np.array_equal(np.sort(nat.items()[0]), np.sort(py.items()[0]))


@pytest.mark.parametrize("kind", ["native", "python"])
def test_admission_to_the_dummy_slot(kind):
    """A key seen in fewer than ``permit`` distinct steps (repeats within
    a step count once), or met with the arena full, maps to the dummy
    slot ``capacity``; a forced import admits at once."""
    store = hashstore.HashStore(2, permit_threshold=2,
                                prefer_native=kind == "native")
    ad = DynamicEmbeddingAdapter(2, permit_filter_value=2, store=store)
    first = ad.transform_batch({"ids": np.array([[11, 11, 12]])})["ids"]
    assert first.tolist() == [[2, 2, 2]] and first.dtype == np.int32
    second = ad.transform_batch({"ids": np.array([[11, 12, 13]])})["ids"]
    assert second[0, 0] < 2 and second[0, 1] < 2 and second[0, 2] == 2
    third = ad.transform_batch({"ids": np.array([[13, 14]])})["ids"]
    assert third.tolist() == [[2, 2]]  # 13 admitted, but the arena is full
    assert store.lookup_or_insert(np.array([99]), force=True)[0] == -1
    with pytest.raises(ValueError):
        DynamicEmbeddingAdapter(4, permit_filter_value=0)
    with socket.socket() as sock:  # the distributed store connects when built
        sock.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{sock.getsockname()[1]}"
    with pytest.raises(ConnectionRefusedError):
        DynamicEmbeddingAdapter(4, remote_addrs=[dead])


# ---------------------------------------------------------------------------
# eviction, export, import
# ---------------------------------------------------------------------------


def _pair(layout="auto", mixed=False, **extra):
    kw = dict(batch_size=B, field_size=F, vocab_size=CAP, emb_dim=D,
              deep_layer_dim=(16, 8), sparse=True, dynamic_embedding=True,
              loss_scale=1.0, use_mixed_precision=mixed, table_layout=layout,
              **extra)
    jm = jwd.WideDeepModel(jwd.WideDeepConfig(**kw))
    tm = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**kw))
    jo = (jopt.ftrl(loss_scale=1.0), jopt.lazy_adam(loss_scale=1.0))
    to = (optim.ftrl(loss_scale=1.0), optim.lazy_adam(loss_scale=1.0))
    js = jstep.init_train_state(jm, jax.random.PRNGKey(0), *jo)
    return jm, tm, jo, to, js


def _to_port(js):
    return convert.state_from_jax(
        *jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d)),
        np.asarray(js.step), device="cpu")


def _randomize_opt_state(js, seed=4):
    """Nonzero optimizer state, so that zeroing it shows."""
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if x.ndim < 2:
            return jnp.asarray(x)
        return jnp.asarray(np.abs(rng.normal(size=x.shape)).astype(x.dtype) + 0.5)

    return js._replace(opt_w=jax.tree.map(fill, js.opt_w),
                       opt_d=jax.tree.map(fill, js.opt_d))


def _assert_states_equal(js, ts):
    ref = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d)))[0]
    port = jax.tree_util.tree_flatten(convert.state_to_jax(ts)[:3])[0]
    for (path, a), b in zip(ref, port):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("layout", ["auto", "feature_major"])
def test_evict_reinit_matches_reference(layout):
    """Transform a key stream and evict every third step on both sides:
    freed slots re-drawn from the adapter's generator and their optimizer
    state zeroed give the reference's state bit for bit, in place (the
    port returns the same state and tensors)."""
    jm, tm, jo, to, js = _pair(layout)
    js = _randomize_opt_state(js)
    ts = _to_port(js)
    ja = jdyn.DynamicEmbeddingAdapter(CAP, permit_filter_value=2,
                                      evict_filter_value=3, seed=5)
    ta = DynamicEmbeddingAdapter(CAP, permit_filter_value=2,
                                 evict_filter_value=3, seed=5)
    ptrs = [t.data_ptr() for t in jax.tree_util.tree_leaves(ts.params)]
    total = 0
    for step, keys in enumerate(_key_stream(18, seed=3)):
        jb, tb = (a.transform_batch({"ids": keys}) for a in (ja, ta))
        np.testing.assert_array_equal(tb["ids"], jb["ids"])
        if step % 3 == 2:
            js, jn = ja.evict(js, jm.table_specs)
            ts2, tn = ta.evict(ts, tm.table_specs)
            assert ts2 is ts and tn == jn
            total += tn
            _assert_states_equal(js, ts)
    assert total > 0
    assert ptrs == [t.data_ptr() for t in jax.tree_util.tree_leaves(ts.params)]
    want = ja.export_tables(js.params, jm.table_specs)
    got = ta.export_tables(ts.params, tm.table_specs)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("layout", ["auto", "feature_major"])
def test_export_import_round_trip(layout):
    """Train three steps, export the live keys, import them into a fresh
    model (its dense parameters copied, as a checkpoint would carry
    them): ``predict`` on the live keys is equal bit for bit."""
    jm, tm, jo, to, js = _pair(layout)
    ts = _to_port(js)
    ta = DynamicEmbeddingAdapter(CAP, permit_filter_value=1, seed=5)
    step = make_train_step(tm, *to)
    rng = np.random.default_rng(8)
    for keys in _key_stream(3, seed=6):
        b = ta.transform_batch({"ids": keys,
                                "wts": rng.normal(size=(B, F)).astype(np.float32),
                                "label": rng.integers(0, 2, (B, 1)).astype(np.float32)})
        ts, _ = step(ts, to_device(b, "cpu"))
    blob = ta.export_tables(ts.params, tm.table_specs)
    keys = blob["__keys__"]
    assert keys.size > 0
    fresh = init_train_state(tm, 3, *to, device="cpu")
    table_keys = {"/".join(p) for p, _s in tm.table_specs.values()}
    params = map_leaves(
        lambda k, x: x if k in table_keys else
        _leaf(ts.params, k).clone(), fresh.params)
    tb = DynamicEmbeddingAdapter(CAP, seed=9)
    assert tb.import_tables(params, blob, tm.table_specs) is params
    ids_old = ta.store.lookup_or_insert(keys)
    ids_new = tb.store.lookup_or_insert(keys)
    n = keys.size - keys.size % F
    wts = torch.ones((n // F, F))
    got = tm.predict(params, torch.from_numpy(ids_new[:n].reshape(-1, F)), wts)
    want = tm.predict(ts.params, torch.from_numpy(ids_old[:n].reshape(-1, F)), wts)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _leaf(params, key):
    node = params
    for p in key.split("/"):
        node = node[int(p)] if isinstance(node, list) else node[p]
    return node


def test_hash_embedding_lookup_matches_reference():
    """map_ids, the gather with ``max_norm`` (rtol 1e-6: one norm and one
    scale per row, summed in another order) and the table export /
    import against the reference's ``HashEmbeddingLookup`` on one arena."""
    ref = jemb.HashEmbeddingLookup(6, capacity=50, permit_filter_value=2,
                                   max_norm=0.05)
    port = HashEmbeddingLookup(6, capacity=50, permit_filter_value=2,
                               max_norm=0.05)
    arena_j = ref.init(jax.random.PRNGKey(1))
    arena = torch.from_numpy(np.array(arena_j))
    assert tuple(arena.shape) == (51, 6)
    assert not port.init(torch.Generator().manual_seed(0), "cpu")[50].any()
    for keys in _key_stream(5, seed=4, space=80):
        s_j, s_t = ref.map_ids(keys), port.map_ids(keys)
        np.testing.assert_array_equal(s_t, s_j)
        want = np.asarray(ref(arena_j, jnp.asarray(s_j)))
        got = port(arena, torch.from_numpy(s_t)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    k_j, v_j = ref.export_table(arena_j)
    k_t, v_t = port.export_table(arena)
    np.testing.assert_array_equal(k_t, k_j)
    np.testing.assert_array_equal(v_t, v_j)
    np.testing.assert_array_equal(port.evict_step(), ref.evict_step())
    other = HashEmbeddingLookup(6, capacity=50)
    a2 = torch.zeros(51, 6)
    assert other.import_table(a2, k_t, v_t) is a2
    np.testing.assert_array_equal(a2[torch.from_numpy(other.map_ids(k_t))].numpy(), v_t)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_dynamic_training_matches_reference():
    """Six steps of the dynamic regime (admission at 2, eviction every
    other step after 2 idle steps), port against the reference's adapter
    and streamed step: losses within rtol 1e-5, state within rtol 1e-4 /
    atol 1e-8 (the MLP's sums in other orders, ~1e-7 relative, amplified
    a little by Adam's m/sqrt(v))."""
    jm, tm, jo, to, js = _pair()
    ts = _to_port(js)
    ja = jdyn.DynamicEmbeddingAdapter(CAP, permit_filter_value=2,
                                      evict_filter_value=2, seed=5)
    ta = DynamicEmbeddingAdapter(CAP, permit_filter_value=2,
                                 evict_filter_value=2, seed=5)
    j_fn = jstep.make_train_step(jm, *jo, jit=True, donate=False,
                                 use_pallas=True, matmul_dtype=jnp.float32)
    t_fn = make_train_step(tm, *to, matmul_dtype=torch.float32)
    rng = np.random.default_rng(2)
    for i, keys in enumerate(_key_stream(6, seed=7)):
        b = {"ids": keys, "wts": rng.normal(size=(B, F)).astype(np.float32),
             "label": rng.integers(0, 2, (B, 1)).astype(np.float32)}
        js, (_, jld) = j_fn(js, ja.transform_batch(b))
        ts, (_, tld) = t_fn(ts, to_device(ta.transform_batch(b), "cpu"))
        np.testing.assert_allclose(float(tld), float(jld), rtol=1e-5)
        if i % 2 == 1:
            js, jn = ja.evict(js, jm.table_specs)
            ts, tn = ta.evict(ts, tm.table_specs)
            assert tn == jn
    ref = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d)))[0]
    port = jax.tree_util.tree_flatten(convert.state_to_jax(ts)[:3])[0]
    for (path, a), b in zip(ref, port):
        np.testing.assert_allclose(np.asarray(b, np.float32),
                                   np.asarray(a, np.float32), rtol=1e-4,
                                   atol=1e-8, err_msg=jax.tree_util.keystr(path))


def test_eviction_callback_in_online_train(tmp_path):
    """``RecModel.online_train`` over ``adapter.transform_batch`` with an
    ``EvictionCallback`` every 2 steps: the evictions per call equal the
    reference adapter's on the same key stream, the tables are changed in
    place (the same tensors), and the export file (written atomically on
    the callback's thread) holds the live keys with the state's rows."""
    _jm, tm, _jo, to, _js = _pair()
    rm = RecModel(tm, *to, device="cpu")
    tables0 = [_leaf(rm.state.params, "/".join(p)) for p, _s in
               tm.table_specs.values()]
    ta = DynamicEmbeddingAdapter(CAP, permit_filter_value=2,
                                 evict_filter_value=3, seed=5)
    ja = jdyn.DynamicEmbeddingAdapter(CAP, permit_filter_value=2,
                                      evict_filter_value=3, seed=5)
    path = tmp_path / "incremental.npz"
    ev = EvictionCallback(ta, tm.table_specs, every_steps=2, export_path=path)
    rng = np.random.default_rng(3)
    stream = [{"ids": k, "wts": np.ones((B, F), np.float32),
               "label": rng.integers(0, 2, (B, 1)).astype(np.float32)}
              for k in _key_stream(12, seed=9)]
    counts = []
    real = ta.evict

    def counting(state, tables):
        out = real(state, tables)
        counts.append(out[1])
        return out

    ta.evict = counting
    rm.online_train((ta.transform_batch(b) for b in stream), callbacks=[ev],
                    dataset_sink_mode=False)
    want = []
    for i, b in enumerate(stream, start=1):
        ja.transform_batch(b)
        if i % 2 == 0:
            want.append(ja.store.evict().size)
    assert counts == want and sum(counts) > 0 and ev.evicted_total == sum(want)
    assert int(rm.state.step) == len(stream)
    assert all(_leaf(rm.state.params, "/".join(p)) is t for (p, _s), t in
               zip(tm.table_specs.values(), tables0))
    assert ev.exports == len(stream) // 2 and not list(tmp_path.glob("*.tmp*"))
    blob = np.load(path)
    keys, slots = ta.store.items()
    np.testing.assert_array_equal(blob["__keys__"], keys)
    for name, (p, spec) in tm.table_specs.items():
        np.testing.assert_array_equal(
            blob["/".join(p)], read_rows(spec, _leaf(rm.state.params, "/".join(p)),
                                         slots).numpy())


def test_dynamic_step_selection():
    """``make_train_step(sparse=None)`` takes ``dynamic_embedding`` as the
    sparse step; over non-sparse (plain row-major) specs that is the
    reference's generic path.  Through the adapter, two steps on plain
    specs equal the same model on row_packed tables (``sparse=True``) on
    the generic path, from one state: losses within rtol 1e-6, the
    logical tables within rtol 1e-5 / atol 1e-7 (per-id sums of the same
    gradients in another order).  The reference trains NaN here (section
    3, reference fault 9; ``tests/test_torch_generic.py``)."""
    _jm, tm, _jo, to, _js = _pair()
    assert make_train_step(tm, *to).__name__ == "step_rows"
    kw = dict(batch_size=B, field_size=F, vocab_size=CAP, emb_dim=D,
              deep_layer_dim=(16,), dynamic_embedding=True, loss_scale=1.0)
    plain = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**kw))
    packed = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**kw,
                                                              sparse=True))
    assert not plain.deep_spec.sparse and packed.deep_spec.row_packed
    step = make_train_step(plain, *to)
    assert step.__name__ == "step_generic"
    oracle = make_train_step(packed, *to, use_pallas=False)
    sp = init_train_state(plain, 0, *to, device="cpu")
    tables = {name: from_storage(spec, _leaf(sp.params, "/".join(path)))
              for name, (path, spec) in plain.table_specs.items()}
    so = init_train_state(packed, 0, *to, device="cpu")
    for name, (path, spec) in packed.table_specs.items():
        so.params[path[0]][path[1]].copy_(to_storage(spec, tables[name]))
    ada, adb = (DynamicEmbeddingAdapter(CAP, seed=5) for _ in range(2))
    rng = np.random.default_rng(2)
    for keys in _key_stream(2, seed=7):
        b = {"ids": keys, "wts": rng.normal(size=(B, F)).astype(np.float32),
             "label": rng.integers(0, 2, (B, 1)).astype(np.float32)}
        sp, (_, la) = step(sp, to_device(ada.transform_batch(b), "cpu"))
        so, (_, lb) = oracle(so, to_device(adb.transform_batch(b), "cpu"))
        assert np.isfinite(float(la))
        np.testing.assert_allclose(float(la), float(lb), rtol=1e-6)
    for name, (path, spec) in plain.table_specs.items():
        got = _leaf(sp.params, "/".join(path))
        want = from_storage(packed.table_specs[name][1],
                            _leaf(so.params, "/".join(path)))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
