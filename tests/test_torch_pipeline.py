"""The port's input pipeline (``data/pipeline.py``) against the JAX
package's: prep pool order and parity, overlap with the consumer, errors
in order, the adaptive bucket policy and a regrow, with
``SparseInputPipeline(device=False)`` held key by key against the JAX
one on the same raw batches.  The staging on the card
(``PrefetchToDevice``) is tested in ``tests/test_torch_cuda.py``."""

import time

import numpy as np
import pytest

from mindrec_tpu.data import pipeline as jpipeline
from mindrec_tpu_torch.data import pipeline as tpipeline
from mindrec_tpu_torch.data.pipeline import (
    AdaptiveBucket, HostPrepPool, SparseInputPipeline, round_bucket,
)
from mindrec_tpu_torch.train.step import make_batch_sort


def _batches(n, bs=64, fields=4, vocab=1000, seed=0):
    rng = np.random.default_rng(seed)
    return [{
        "ids": rng.integers(0, vocab, size=(bs, fields)).astype(np.int32),
        "wts": np.ones((bs, fields), np.float32),
        "label": rng.integers(0, 2, size=(bs, 1)).astype(np.float32),
    } for _ in range(n)]


def _regrow_batches():
    """Id diversity jumps mid-run: 4 batches over 500 ids, 4 over 200k."""
    rng = np.random.default_rng(0)
    return [{
        "ids": rng.integers(0, 500 if i < 4 else 200_000,
                            size=(700, 4)).astype(np.int32),
        "wts": np.ones((700, 4), np.float32),
    } for i in range(8)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_prep_pool_order_and_parity():
    batches = _batches(12)
    prep = make_batch_sort(4)
    got = list(HostPrepPool(iter(batches), prep, workers=2, depth=4))
    _assert_same(got, [prep(dict(b)) for b in batches])


def test_prep_pool_overlaps_consumer():
    """Prep (5 ms) faster than the consumer's 'step' (10 ms): one worker
    hides prep entirely and the consumer never waits for long."""
    steps, prep_ms, step_ms = 50, 5, 10

    def src():
        for _ in range(steps):
            yield {"i": np.zeros(4)}

    def prep(b):
        time.sleep(prep_ms / 1e3)  # releases the GIL like the native call
        return b

    it = iter(HostPrepPool(src(), prep, workers=1, depth=3))
    next(it)  # pipeline warm
    t0 = time.perf_counter()
    waits, n = [], 1
    while True:
        w0 = time.perf_counter()
        try:
            next(it)
        except StopIteration:
            break
        waits.append(time.perf_counter() - w0)
        n += 1
        time.sleep(step_ms / 1e3)  # the "device step"
    wall = time.perf_counter() - t0
    assert n == steps
    assert wall < steps * (prep_ms + step_ms) / 1e3 * 0.85
    assert np.median(waits) < prep_ms / 1e3 * 0.5


def test_prep_pool_propagates_errors_in_order():
    batches = _batches(6)
    batches[3]["ids"][0, 0] = -7

    def prep(b):
        if int(b["ids"][0, 0]) == -7:
            raise ValueError("boom")
        return b

    it = iter(HostPrepPool(iter(batches), prep, workers=2, depth=4))
    for i in range(3):
        assert next(it) is batches[i]
    with pytest.raises(ValueError, match="boom") as ei:
        next(it)
    assert ei.value.raw_batch is batches[3]


def test_adaptive_bucket_policy_matches_reference():
    logs, jlogs = [], []
    pol = AdaptiveBucket(2048, headroom=1.5, warn_frac=0.9,
                         log=lambda *a, **k: logs.append(a[0]))
    jpol = jpipeline.AdaptiveBucket(2048, headroom=1.5, warn_frac=0.9,
                                    log=lambda *a, **k: jlogs.append(a[0]))
    for p, out in ((pol, logs), (jpol, jlogs)):
        p.observe(100)
        assert not out
        p.observe(2000)  # > 90% of 2048
        p.grow(2100)
    assert logs == jlogs and len(logs) == 2 and "90%" in logs[0]
    assert pol.bucket == jpol.bucket == round_bucket(int(2100 * 1.5))
    assert pol.max_seen == jpol.max_seen == 2000
    sample = _batches(3, vocab=50_000)
    assert (AdaptiveBucket.from_sample(sample).bucket
            == jpipeline.AdaptiveBucket.from_sample(sample).bucket)


@pytest.mark.parametrize("policy", [False, True])
def test_pipeline_matches_reference(policy):
    """SparseInputPipeline(device=False) against the JAX one, key by key;
    with a policy the unique ids are trimmed to its bucket."""
    batches = _batches(6, bs=700, vocab=1000)

    def run(mod):
        pol = (mod.AdaptiveBucket(2048, log=lambda *a, **k: None)
               if policy else None)
        return list(mod.SparseInputPipeline(iter(batches), field_size=4,
                                            policy=pol, workers=2,
                                            device=False))

    got, want = run(tpipeline), run(jpipeline)
    _assert_same(got, want)
    assert got[0]["uq_ids"].shape == ((2048,) if policy else (2800,))


def test_pipeline_regrows_on_overflow():
    """Mid-run id diversity growth: the pipeline re-buckets, re-preps the
    offending batch and reports the new bucket via on_grow, as the JAX
    pipeline does on the same batches (one worker: a fixed order)."""
    batches = _regrow_batches()

    def run(mod):
        grows = []
        pol = mod.AdaptiveBucket(2048, log=lambda *a, **k: None)
        out = list(mod.SparseInputPipeline(iter(batches), field_size=4,
                                           policy=pol, workers=1,
                                           device=False, on_grow=grows.append))
        return out, grows, pol

    got, grows, pol = run(tpipeline)
    want, jgrows, jpol = run(jpipeline)
    _assert_same(got, want)
    assert grows == jgrows and grows and grows[-1] == pol.bucket == jpol.bucket
    assert pol.bucket >= max(np.unique(b["ids"]).size for b in batches)
    for raw, out in zip(batches, got):
        assert int(out["uidx_sorted"][-1]) + 1 == np.unique(raw["ids"]).size
        np.testing.assert_array_equal(np.sort(out["perm"]),
                                      np.arange(raw["ids"].size))


@pytest.mark.parametrize("kw", [
    {"sharding": object(), "wire": object()},
    {"sharding": object(), "host_prep": False},
    {"sharding": object(), "superbatch": 2},
    {"sharding": object(), "decode": False},
    {"sharding": object(), "unstack": False},
    {"sharding": object(), "pad_tail": True},
    {"sharding": object()},
])
def test_unported_pipeline_options_raise(kw):
    """Sharded staging (``sharding=`` a mesh) is ported: each rank gets
    its data slice of every prepped batch, the unique ids of the global
    batch included.  It raises with superbatch staging (the reference's
    guard: a per-batch slice would cut the group axis) and with the wire
    (it packs whole batches); ``unstack=False`` keeps its own rule."""
    from mindrec_tpu_torch.parallel.mesh import Mesh

    kw = {**kw, "sharding": Mesh(2, 1, rank=1)}
    errors = {"wire": "wire", "superbatch": "superbatch", "unstack": "unstack"}
    for key, match in errors.items():
        if key in kw:
            with pytest.raises(ValueError, match=match):
                SparseInputPipeline(iter([]), field_size=4, device=False, **kw)
            return
    rng = np.random.default_rng(0)
    raw = [{"ids": rng.integers(0, 50, (8, 4)).astype(np.int32),
            "label": np.arange(8, dtype=np.float32)[:, None]}]
    (got,) = list(SparseInputPipeline(iter(raw), field_size=4, device=False,
                                      **kw))
    np.testing.assert_array_equal(got["ids"], raw[0]["ids"][4:])
    np.testing.assert_array_equal(got["label"], raw[0]["label"][4:])
    if kw.get("host_prep", True):  # rank 1's half of the global unique ids
        want = make_batch_sort(4)(raw[0])["uq_ids"]
        np.testing.assert_array_equal(got["uq_ids"], want[16:])
