"""The port's table server and its client (PS mode's remote tiers) against
the reference's server and client.

The port's server is built by g++ from ``mindrec_tpu_torch/native/
table_server.cc``; the reference's is its committed binary
(``mindrec_tpu/native/mindrec_table_server``), launched only here, as
the reference side of each check.  Servers listen on free ports (picked
by binding port 0, another tried on a clash), every socket has a
timeout, and each server is shut down, then killed if it has not exited
within 10 s, when its test ends.
"""

import contextlib
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindrec_tpu.ops import cache as jcache
from mindrec_tpu.ops import remote as jremote
from mindrec_tpu_torch.ops import cache, remote


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_ref(ram_mb, spill_dir):
    """The reference's server on a free port (retried on a clash)."""
    for _ in range(5):
        port = _free_port()
        try:
            proc = jremote.launch_table_server(port, ram_mb=ram_mb,
                                               spill_dir=str(spill_dir))
        except RuntimeError:
            continue
        proc.addr = f"127.0.0.1:{port}"
        return proc
    raise RuntimeError("no free port for the reference's table server")


@contextlib.contextmanager
def servers(kind, n, spill_root, ram_mb=None, shared_spill=False):
    """``n`` table servers of ``kind`` ("port" or "ref") -> their addrs."""
    procs = []
    try:
        for i in range(n):
            spill = spill_root if shared_spill else spill_root / f"{kind}{i}"
            spill.mkdir(parents=True, exist_ok=True)
            procs.append(remote.launch_table_server(ram_mb=ram_mb,
                                                    spill_dir=str(spill))
                         if kind == "port" else _launch_ref(ram_mb, spill))
        yield [p.addr for p in procs]
    finally:
        for p in procs:
            remote.stop_table_server(p.addr, p)


IDS = np.array([0, 1, 2, 77, -5, -(2**62), 2**40 + 3, 9_999_999_999, 77],
               np.int64)


@pytest.mark.parametrize("std,bias,dim", [(0.01, 0.0, 5), (0.0, 0.25, 16),
                                          (0.05, -1.5, 240)])
def test_initial_rows_bit_identical_with_reference_server(tmp_path, std, bias,
                                                         dim):
    """The same (table, dim, std, bias, seed, id) gives the same float32
    row bit for bit on either server, read by either client."""
    with servers("port", 1, tmp_path) as pa, servers("ref", 1, tmp_path) as ra:
        got = remote.RemoteTier(pa, "t", dim, init_std=std, seed=11,
                                init_bias=bias).read(IDS)
        want = jremote.RemoteTier(ra, "t", dim, init_std=std, seed=11,
                                  init_bias=bias).read(IDS)
        other = remote.RemoteTier(ra, "u", dim, init_std=std, seed=11,
                                  init_bias=bias).read(IDS)
    assert got.dtype == np.float32 and got.shape == (IDS.size, dim)
    assert got.tobytes() == want.tobytes() == other.tobytes()
    np.testing.assert_array_equal(got[3], got[-1])  # one id, one row
    if std == 0.0:
        assert (got == np.float32(bias)).all()


@pytest.mark.parametrize("client,server", [("port", "ref"), ("ref", "port")])
def test_each_client_against_the_other_server(tmp_path, client, server):
    """Reads, writes (over two shards), flush and stats across packages:
    the port's client against the reference's server and back."""
    mod = remote if client == "port" else jremote
    with servers(server, 2, tmp_path, ram_mb=1) as addrs:
        tier = mod.RemoteTier(addrs, "x", 256, init_std=0.01, seed=3)
        ids = np.arange(-50, 2950, dtype=np.int64)  # 3000 rows, past the caps
        rows = tier.read(ids)
        w = (rows * 3.0 + 1.0).astype(np.float32)
        tier.write(ids, w)
        tier.flush()
        back = tier.read(ids[::-1])
        stats = tier.stats()
        ref_rows = remote.RemoteTier(addrs, "y", 256, init_std=0.01,
                                     seed=3).read(ids)
    np.testing.assert_array_equal(back, w[::-1])
    np.testing.assert_array_equal(rows, ref_rows)  # the servers agree
    # 1 MiB of 1 KiB rows in RAM per table per server, the rest spilled
    counts = np.bincount(remote._shard(ids, 2), minlength=2)
    assert stats == [(min(c, 1024), max(c - 1024, 0)) for c in counts]
    assert min(counts) > 1024


def test_ram_cap_spills_and_reads_back(tmp_path):
    """``--ram-mb 1`` at dim 256 keeps 1,024 rows in RAM and spills the
    rest; spilled rows read back as written; the spill file is private to
    the process (unlinked once open), so nothing is left in the spill
    directory."""
    with servers("port", 1, tmp_path, ram_mb=1) as addrs:
        tier = remote.RemoteTier(addrs, "big", 256, init_std=0.01)
        ids = np.arange(2000, dtype=np.int64)
        rows = tier.read(ids)
        tier.write(ids, rows * 2.0)
        assert tier.stats() == [(1024, 976)]
        np.testing.assert_array_equal(tier.read(np.array([1500, 3])),
                                      rows[[1500, 3]] * 2.0)
        assert not any((tmp_path / "port0").iterdir())
    with pytest.raises(ValueError, match="32"):
        remote.RemoteTier(addrs, "n" * 33, 4)


def test_shard_matches_reference():
    """``splitmix64(id) % S`` of seeded ids (negatives and extremes
    included) equals the reference's, for its tier and its hash store."""
    rng = np.random.default_rng(0)
    ids = np.concatenate([
        rng.integers(-(2**63), 2**63 - 1, 5000, dtype=np.int64),
        rng.integers(-1000, 1000, 500), [np.iinfo(np.int64).min,
                                         np.iinfo(np.int64).max, 0, -1]
    ]).astype(np.int64)
    for n in (1, 2, 3, 5):
        tier = jremote.RemoteTier.__new__(jremote.RemoteTier)
        store = jremote.RemoteHashStore.__new__(jremote.RemoteHashStore)
        tier.conns = store.conns = [None] * n
        got = remote._shard(ids, n)
        np.testing.assert_array_equal(got, tier._shard(ids))
        np.testing.assert_array_equal(got, store._shard(ids))
        if n > 1:
            assert set(np.unique(got).tolist()) == set(range(n))


def test_cached_table_over_remote_matches_reference(tmp_path):
    """``CachedEmbeddingTable(remote_addrs=)`` against the reference's over
    the same batches, each on its own package's two servers: the same
    slots, swap lists and loaded rows (param and state) every step,
    evicted rows written back and reloaded, and ``flush_all`` leaving the
    same rows on the servers."""
    kw = dict(vocab_size=10_000_000_000, dim=4, cache_rows=8, max_swap=8,
              state_names=("m",), table_name="e2e")
    rng = np.random.default_rng(3)
    batches = [rng.choice([5, 7_000_000_000, 12, -3, 40, 41, 42, 43, 44, 45,
                           46, 47, 99], size=5, replace=False)
               for _ in range(10)]
    with servers("port", 2, tmp_path) as pa, servers("ref", 2, tmp_path) as ra:
        pt = cache.CachedEmbeddingTable(**kw, remote_addrs=pa)
        rt = jcache.CachedEmbeddingTable(**kw, remote_addrs=ra)
        arenas = {"port": (pt.init_arena("cpu"), pt.init_state_arena("m", "cpu")),
                  "ref": [np.zeros((9, 4), np.float32)] * 2}
        for step, ids in enumerate(batches):
            pp, rp = pt.prepare(ids), rt.prepare(ids)
            for k in ("slots", "load_slots", "evict_slots", "evict_ids"):
                np.testing.assert_array_equal(pp[k], rp[k], err_msg=k)
            for k in ("param", "m"):
                assert pp["load_rows"][k].tobytes() == rp["load_rows"][k].tobytes()
            ls, es = (torch.from_numpy(pp[k]).long()
                      for k in ("load_slots", "evict_slots"))
            ev = {name: cache.cache_swap(a, es, ls, torch.from_numpy(
                pp["load_rows"][name]))[1]
                for name, a in zip(("param", "m"), arenas["port"])}
            pt.writeback(pp["evict_ids"], ev)
            ref_new, ref_ev = [], {}
            for name, a in zip(("param", "m"), arenas["ref"]):
                a2, e = jcache.cache_swap(jnp.asarray(a), rp["evict_slots"],
                                          rp["load_slots"],
                                          jnp.asarray(rp["load_rows"][name]))
                ref_new.append(np.array(a2))
                ref_ev[name] = np.asarray(e)
            rt.writeback(rp["evict_ids"], ref_ev)
            # "train" the batch's rows the same way on both sides
            for a in arenas["port"]:
                a[torch.from_numpy(pp["slots"]).long()] += float(step + 1)
            for a in ref_new:
                a[rp["slots"]] += float(step + 1)
            arenas["ref"] = ref_new
        pt.flush_all(arenas["port"][0], {"m": arenas["port"][1]})
        rt.flush_all(arenas["ref"][0], {"m": arenas["ref"][1]})
        every = np.unique(np.concatenate(batches))
        got = (pt.param_tier.read(every), pt.state_tiers["m"].read(every))
        want = (rt.param_tier.read(every), rt.state_tiers["m"].read(every))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert np.abs(got[1]).max() > 0  # trained state reached the servers


def test_shared_spill_dir_fault_7(tmp_path):
    """Reference fault 7: servers sharing a spill directory overwrite each
    other's spilled rows (``mrec_spill_<table>.bin``).  With the cap at
    one RAM row, ids 1-8 of table ``emb`` written as 1.0 on server A and
    2.0 on server B, each flushed: the reference's A reads
    ``[1, 2, 2, 2, 2, 2, 2, 2]``, the port's A reads its own rows."""
    ids = np.arange(1, 9, dtype=np.int64)
    seen = {}
    for kind, mod in (("port", remote), ("ref", jremote)):
        shared = tmp_path / kind
        shared.mkdir()
        with servers(kind, 2, shared, ram_mb=0, shared_spill=True) as (a, b):
            ta, tb = (mod.RemoteTier(x, "emb", 4, init_std=0.0) for x in (a, b))
            ta.write(ids, np.ones((8, 4), np.float32))
            ta.flush()
            tb.write(ids, np.full((8, 4), 2.0, np.float32))
            tb.flush()
            seen[kind] = (ta.read(ids)[:, 0].tolist(), tb.read(ids)[:, 0].tolist())
    assert seen["ref"][0] == [1.0] + [2.0] * 7  # the fault
    assert seen["port"] == ([1.0] * 8, [2.0] * 8)
