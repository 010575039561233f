"""The port's compact wire and device-prep pipeline against the JAX
package's, on the CPU.

``BatchWire.encode`` must write the reference's arena byte for byte and
the torch decode must give the reference's jax decode bit for bit, for
every codec kind (3-byte ids, sentinels, bf16 weights including negative
ones and the sign bit, bit labels, raw lanes, per-field widths), in
arena and per-key transport.  ``choose_prep`` must decide as the
reference over a grid; the device-prep pipeline (wire, audit, regrow)
and superbatch staging (stack, unstack, ``pad_tail``) must yield the
reference's batches."""

import itertools

import jax
import ml_dtypes
import numpy as np
import pytest

from mindrec_tpu.data import pipeline as jpipeline
from mindrec_tpu.data import wire as jwire
from mindrec_tpu_torch.data import pipeline, wire
from mindrec_tpu_torch.data.criteo import SyntheticCriteo, criteo_field_sizes
from mindrec_tpu_torch.train.step import make_batch_sort

B, F, V = 48, 39, 5_860_000


def _quiet(*a, **k):
    pass


def _batch(seed=0, b=B, f=F, vocab=V):
    rng = np.random.default_rng(seed)
    return {"ids": rng.integers(0, vocab, (b, f)).astype(np.int32),
            "wts": rng.normal(0, 3, (b, f)).astype(np.float32),
            "label": rng.integers(0, 2, (b, 1)).astype(np.float32)}


def _host(x):
    return x.numpy() if hasattr(x, "numpy") and not isinstance(
        x, np.ndarray) and not isinstance(x, jax.Array) else np.asarray(x)


def _same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = _host(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype)
        assert g.tobytes() == w.tobytes(), k


def _pair(make):
    return make(wire), make(jwire)


def test_bf16_bits_match_ml_dtypes():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(0, 10, 4000).astype(np.float32),
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-40, -1e-40,
                  3.4e38, -3.4e38, 1.00390625, 1.01171875], np.float32),
        rng.integers(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32)
        .view(np.float32),
    ])
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    assert wire.bf16_bits(x).tobytes() == want.tobytes()


@pytest.mark.parametrize("host_prep,lossy,arena",
                         list(itertools.product([False, True], repeat=3)))
def test_sparse_wire_matches_reference(host_prep, lossy, arena):
    b = _batch(1, vocab=1000)  # duplicates: the unique ids end in sentinels
    b["wts"][0, :4] = [-0.0, -1.5, -3e-39, 2.0]  # sign bit, subnormal
    if host_prep:
        b = make_batch_sort(F, minimal=True, native=False)(b)
        b["uq_ids"] = b["uq_ids"][:1200]  # a trimmed, sentinel-padded tail
    tw, jw = _pair(lambda m: m.BatchWire.for_sparse(
        V, B, F, host_prep=host_prep, lossy_wts=lossy, arena=arena))
    te, je = tw.encode(b), jw.encode(b)
    assert sorted(te) == sorted(je)
    for k in je:
        assert np.asarray(te[k]).tobytes() == np.asarray(je[k]).tobytes(), k
    assert tw.wire_bytes(b) == jw.wire_bytes(b)
    _same(tw.decoder()(te), jw.decoder(jit=False)(je))
    out = tw.decoder()(te)
    for k in b:  # lossless keys come back exactly
        if k != "wts" or not lossy:
            np.testing.assert_array_equal(_host(out[k]), b[k], err_msg=k)
    if host_prep:
        assert (_host(out["uq_ids"]) == wire.SENTINEL).sum() > 0


@pytest.mark.parametrize("lossy", [True, False])
def test_field_wire_matches_reference(lossy):
    sizes = criteo_field_sizes(V, F)
    data = SyntheticCriteo(B, F, V, seed=4, fields="criteo")
    b = data.get_batch(0)
    b["wts"][:, :13] = np.random.default_rng(2).normal(0, 2, (B, 13))
    tw, jw = _pair(lambda m: m.BatchWire.for_fields(
        sizes, B, wt_value_fields=range(13), lossy_wts=lossy))
    te, je = tw.encode(b), jw.encode(b)
    assert te[wire.ARENA_KEY].tobytes() == je[jwire.ARENA_KEY].tobytes()
    assert tw.wire_bytes(b) == jw.wire_bytes(b) == te[wire.ARENA_KEY].size
    _same(tw.decoder()(te), jw.decoder(jit=False)(je))
    bad = dict(b, ids=b["ids"].copy())
    bad["ids"][3, 5] = -1
    with pytest.raises(ValueError, match="out of its field range"):
        tw.encode(bad)


def test_raw_keys_sentinels_and_passthrough_match_reference():
    b = _batch(3, vocab=70_000)
    b["extra"] = np.arange(B, dtype=np.int64)
    b["uq"] = np.full(300, wire.SENTINEL, np.int32)
    b["uq"][:7] = [0, 1, 255, 256, 65535, 69_999, 12]
    b["small"] = np.random.default_rng(0).integers(0, 200, (B, 3)).astype(np.int32)
    for arena in (True, False):
        tw, jw = _pair(lambda m: m.BatchWire(
            {"ids": 70_000, "uq": 70_000, "small": 200},
            sentinel_keys=("uq",), lossy=(), raw=("wts",), arena=arena))
        te, je = tw.encode(b), jw.encode(b)
        for k in je:
            assert np.asarray(te[k]).tobytes() == np.asarray(je[k]).tobytes()
        _same(tw.decoder()(te), jw.decoder(jit=False)(je))
    with pytest.raises(ValueError, match="needs a bound"):
        wire.BatchWire({}, sentinel_keys=("uq",))
    tw = wire.BatchWire.for_sparse(V, B, F)
    tw.encode(_batch(0))
    with pytest.raises(ValueError, match="layout changed"):
        tw.encode(_batch(0, b=B + 1))


def test_choose_prep_matches_reference():
    grid = itertools.product([5.0, 22.4], [6.0, 29.4], [2.0, 11.2, 60.0],
                             [12_700_000], [3_200_000, 1_400_000],
                             [60e6, 1e9, 12e9], [1, 2, 4])
    seen = set()
    for args in grid:
        got = wire.choose_prep(*args)
        assert got == jwire.choose_prep(*args), args
        seen.add(got)
    assert seen == {"host", "device"}


def test_measure_link_needs_a_card():
    with pytest.raises((RuntimeError, ValueError)):
        wire.measure_link("cpu")


def _raw(n, vocab=4096, seed=7, b=64, f=8):
    rng = np.random.default_rng(seed)
    return [{"ids": rng.permutation(vocab)[: b * f].reshape(b, f)
             .astype(np.int32),
             "wts": rng.uniform(-1, 1, (b, f)).astype(np.float32),
             "label": rng.integers(0, 2, (b, 1)).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("use_wire", [False, True])
def test_device_prep_pipeline_and_audit_match_reference(use_wire):
    """Device prep: no sort on the host, the wire's encode + decode, and
    the audit that regrows an undersized bucket (as the reference's)."""
    data = _raw(5)
    runs = []
    for m, pm in ((wire, pipeline), (jwire, jpipeline)):
        grown = []
        pol = pm.AdaptiveBucket(64, quantum=64, log=_quiet)
        w = m.BatchWire.for_sparse(4096, 64, 8) if use_wire else None
        out = list(pm.SparseInputPipeline(
            iter(data), field_size=8, policy=pol, device=False, wire=w,
            host_prep=False, audit_every=2, on_grow=grown.append))
        runs.append((out, grown, pol.bucket))
    (got, g_grown, g_bucket), (want, w_grown, w_bucket) = runs
    assert g_grown == w_grown and g_bucket == w_bucket >= 512
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _same(g, w)
        assert "perm" not in g


@pytest.mark.parametrize("k,pad_tail", [(3, False), (3, True), (2, True)])
def test_superbatch_stack_and_unstack_match_reference(k, pad_tail):
    data = _raw(7)
    got = list(pipeline._stack_groups(iter(data), k, pad_tail))
    want = list(jpipeline._stack_groups(iter(data), k, pad_tail))
    assert len(got) == len(want) == -(-7 // k)
    for g, w in zip(got, want):
        _same(g, w)
    flat = list(pipeline._unstack_groups(iter(got)))
    assert len(flat) == 7
    for g, w in zip(flat, jpipeline._unstack_groups(iter(want))):
        _same(g, w)
    for g, w in zip(flat, data):
        _same(g, w)


@pytest.mark.parametrize("decode,unstack", [(True, True), (False, True),
                                            (False, False)])
def test_superbatch_pipeline_matches_reference(decode, unstack):
    data = _raw(7)
    outs = []
    for m, pm in ((wire, pipeline), (jwire, jpipeline)):
        outs.append(list(pm.SparseInputPipeline(
            iter(data), field_size=8, device=False,
            wire=m.BatchWire.for_sparse(4096, 64, 8), host_prep=False,
            superbatch=3, pad_tail=not unstack, decode=decode,
            unstack=unstack)))
    got, want = outs
    assert len(got) == len(want) == (7 if unstack else 3)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("kw", [
    {"unstack": False},
    {"unstack": False, "superbatch": 2},
    {"host_prep": False, "groups": {"g": {"keys": ("ids",)}}},
    {"groups": {"g": {"keys": ("ids",)}}, "policy": object()},
])
def test_pipeline_illegal_combinations_raise(kw):
    for pm in (pipeline, jpipeline):
        with pytest.raises(ValueError):
            pm.SparseInputPipeline(iter([]), field_size=4, device=False, **kw)
