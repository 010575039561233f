"""The port's distributed hash store (the dynamic regime's id -> slot map
on table servers) against the reference's ``RemoteHashStore`` and the
local store.

Both servers include a hash store whose bucket table the reference sizes
once (``ROADMAP.md`` section 3, reference fault 5; the port's grows), so
the parity streams stay below 3/4 of the buckets.  The streams give
every shard a key in every step: the reference advances a shard's step
clock only when it has a key (reference fault 8, held by its own test
here).
"""

import numpy as np
import pytest

from mindrec_tpu.ops import remote as jremote
from mindrec_tpu.train import dynamic as jdynamic
from mindrec_tpu_torch.native.hashstore import HashStore
from mindrec_tpu_torch.ops import remote
from mindrec_tpu_torch.train.dynamic import DynamicEmbeddingAdapter
from test_torch_remote import servers


@pytest.fixture(scope="module")
def port_servers(tmp_path_factory):
    with servers("port", 2, tmp_path_factory.mktemp("hs_port")) as addrs:
        yield addrs


@pytest.fixture(scope="module")
def ref_servers(tmp_path_factory):
    with servers("ref", 2, tmp_path_factory.mktemp("hs_ref")) as addrs:
        yield addrs


def test_slot_ranges_and_two_clients(port_servers):
    """Shard ``s`` hands out slots in ``[s * cap / S, (s + 1) * cap / S)``;
    a repeated key keeps its slot; two clients (two workers) resolve the
    same keys to the same slots, interleaved inserts included."""
    a = remote.RemoteHashStore(port_servers, "h1", capacity=128)
    b = remote.RemoteHashStore(port_servers, "h1", capacity=128)
    keys = np.array([5, 99, 12345, 5, -7, 2**62], np.int64)
    slots = a.lookup_or_insert(keys)
    assert slots[0] == slots[3] and len(np.unique(slots)) == 5
    shard = remote._shard(keys, 2)
    assert ((slots >= shard * 64) & (slots < shard * 64 + 64)).all()
    np.testing.assert_array_equal(b.lookup_or_insert(keys), slots)
    more = np.arange(2000, 2030, dtype=np.int64)
    np.testing.assert_array_equal(a.lookup_or_insert(more),
                                  b.lookup_or_insert(more))
    assert len(a) == len(b) == 35


def test_items_export_round_trip(port_servers):
    store = remote.RemoteHashStore(port_servers, "h2", capacity=64)
    keys = np.array([10, 20, 30, 40, -50], np.int64)
    slots = store.lookup_or_insert(keys)
    got_k, got_s = store.items()
    assert got_k.dtype == got_s.dtype == np.int64
    assert dict(zip(got_k.tolist(), got_s.tolist())) == dict(
        zip(keys.tolist(), slots.tolist()))
    store.erase(np.array([20, -50], np.int64))
    assert sorted(store.items()[0].tolist()) == [10, 30, 40]
    assert len(store) == 3


def _every_shard_stream(rng, steps, pool, n):
    """Batches of ``n`` keys from ``pool`` holding keys of both shards."""
    shard = remote._shard(pool, 2)
    out = []
    for _ in range(steps):
        b = rng.choice(pool, n)
        b[:2] = [rng.choice(pool[shard == 0]), rng.choice(pool[shard == 1])]
        out.append(b)
    return out


@pytest.mark.parametrize("permit,evict", [(1, 3), (2, 4)])
def test_admission_and_eviction_match_reference(port_servers, ref_servers,
                                                permit, evict):
    """On streams that give every shard a key in every step, below 3/4
    load: the same slots for every lookup, and the same freed slots in the
    same order at every eviction, as the reference's store on its own
    servers."""
    name = f"h3_{permit}_{evict}"
    port = remote.RemoteHashStore(port_servers, name, 256, permit, evict)
    ref = jremote.RemoteHashStore(ref_servers, name, 256, permit, evict)
    rng = np.random.default_rng(permit)
    pool = rng.integers(-(2**40), 2**40, 150, dtype=np.int64)
    n_freed = 0
    for step, keys in enumerate(_every_shard_stream(rng, 40, pool, 12)):
        force = step % 9 == 8
        np.testing.assert_array_equal(port.lookup_or_insert(keys, force),
                                      ref.lookup_or_insert(keys, force))
        if step % 5 == 4:
            freed = port.evict()
            np.testing.assert_array_equal(freed, ref.evict())
            n_freed += freed.size
    assert n_freed > 0
    for x, y in zip(port.items(), ref.items()):
        np.testing.assert_array_equal(x, y)


def test_idle_shard_keeps_the_clock_fault_8(port_servers, ref_servers):
    """Reference fault 8: a shard with no key in a batch is not called, so
    its step clock falls behind.  2 servers, capacity 64, permit 1, evict
    3: key 1 (shard 1) in step 1 only, keys 2, 4, 5 (shard 0) in steps
    1-5.  The local store then frees 1 slot, the port's remote store 1,
    the reference's 0."""
    assert remote._shard(np.array([1, 2, 4, 5]), 2).tolist() == [1, 0, 0, 0]
    local = HashStore(64, permit_threshold=1, evict_threshold=3)
    port = remote.RemoteHashStore(port_servers, "f8", 64, 1, 3)
    ref = jremote.RemoteHashStore(ref_servers, "f8", 64, 1, 3)
    for step in range(5):
        keys = np.array([1, 2, 4, 5] if step == 0 else [2, 4, 5], np.int64)
        for store in (local, port, ref):
            store.lookup_or_insert(keys)
    assert local.evict().size == 1
    assert port.evict().size == 1
    assert ref.evict().size == 0  # the fault


def test_dynamic_adapter_remote_matches_reference(port_servers, ref_servers):
    """``DynamicEmbeddingAdapter(remote_addrs=)`` maps raw batches to the
    same slot batches as the reference's adapter on its servers (two port
    adapters, two workers, agree too), and frees the same slots."""
    kw = dict(capacity=256, permit_filter_value=2, evict_filter_value=4,
              table_name="dyn5")
    ad1 = DynamicEmbeddingAdapter(**kw, remote_addrs=port_servers)
    ad2 = DynamicEmbeddingAdapter(**kw, remote_addrs=port_servers)
    ref = jdynamic.DynamicEmbeddingAdapter(**kw, remote_addrs=ref_servers)
    rng = np.random.default_rng(5)
    pool = rng.integers(0, 10**12, 120, dtype=np.int64)
    for keys in _every_shard_stream(rng, 12, pool, 32):
        raw = {"ids": keys.reshape(8, 4), "wts": np.ones((8, 4), np.float32)}
        got = ad1.transform_batch(dict(raw))["ids"]
        want = ref.transform_batch(dict(raw))["ids"]
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32 and got.max() <= 256
    freed = ad1.store.evict()
    assert freed.size > 0
    np.testing.assert_array_equal(freed, ref.store.evict())
    np.testing.assert_array_equal(ad1.store.lookup_or_insert(pool, force=True),
                                  ad2.store.lookup_or_insert(pool, force=True))
