"""The port's native batch prep (``native/batchprep.cc``, built by g++ at
first use) against its numpy path and the JAX package's numpy path, key
by key and exactly: the cases of ``tests/test_batchprep.py``, plus id
groups, the compaction of ``kept_budget`` and a build that fails."""

import numpy as np
import pytest

from mindrec_tpu.train import step as jstep
from mindrec_tpu_torch.data.outbrain import SyntheticOutbrain
from mindrec_tpu_torch.models import multitable
from mindrec_tpu_torch.native import batchprep as bp
from mindrec_tpu_torch.train.step import (
    BucketOverflow, make_batch_sort, prep_groups,
)

KEYS = ("sorted_ids", "perm", "inv", "uq_ids", "uidx", "uidx_sorted")


def _rand_batch(rng, bs, fields, vocab):
    return {"ids": rng.integers(0, vocab, size=(bs, fields)).astype(np.int32)}


def _same_three(batch, field_size, **kw):
    """Native, port numpy and JAX numpy prep of one batch are equal."""
    nat = make_batch_sort(field_size, **kw)(dict(batch))
    num = make_batch_sort(field_size, native=False, **kw)(dict(batch))
    ref = jstep.make_batch_sort(field_size, native=False, **kw)(dict(batch))
    assert sorted(nat) == sorted(num) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(nat[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(num[k], ref[k], err_msg=k)
        assert nat[k].dtype == ref[k].dtype, k
    return nat


@pytest.mark.parametrize("vocab", [7, 1000, 5_860_000, 2**31 - 16])
def test_native_matches_numpy_and_reference(vocab):
    rng = np.random.default_rng(0)
    out = _same_three(_rand_batch(rng, 512, 13, vocab), 13)
    assert all(k in out for k in KEYS)


@pytest.mark.parametrize("ids", [
    [5, 3, 5, 5, 3, 5, 1, 5],  # stable ties: perm keeps position order
    [-5, -1, 3, -5, 7, 3],  # negative ids (min-bias)
    [42] * 10,  # a constant batch
    list(range(10))[::-1],
])
def test_native_ties_negative_and_constant(ids):
    _same_three({"ids": np.asarray(ids, np.int32).reshape(1, -1)}, len(ids))


def test_minimal_mode_drops_unused_outputs():
    b = _rand_batch(np.random.default_rng(3), 256, 8, 4096)
    full = make_batch_sort(8)(dict(b))
    mini = _same_three(b, 8, minimal=True)
    assert "sorted_ids" not in mini and "inv" not in mini
    for k in ("perm", "uq_ids", "uidx", "uidx_sorted"):
        np.testing.assert_array_equal(full[k], mini[k], err_msg=k)


@pytest.mark.parametrize("native", [None, False])
def test_bucket_overflow_carries_count(native):
    b = _rand_batch(np.random.default_rng(4), 256, 8, 1_000_000)
    nu = np.unique(b["ids"]).size
    with pytest.raises(BucketOverflow) as ei:
        make_batch_sort(8, unique_bucket=nu - 1, native=native)(dict(b))
    assert ei.value.n_unique == nu
    _same_three(b, 8, unique_bucket=nu)


def test_batch_prep_direct_uq_len():
    ids = np.array([9, 1, 9, 4, 4, 2], np.int32)
    s, perm, inv, uq, uidx, uidx_s, nu = bp.batch_prep(ids, uq_len=3)
    assert nu == 4
    np.testing.assert_array_equal(uq, [1, 2, 4])  # the first 3 uniques
    np.testing.assert_array_equal(s, [1, 2, 4, 4, 9, 9])
    np.testing.assert_array_equal(perm, [1, 5, 3, 4, 0, 2])
    np.testing.assert_array_equal(uidx, [3, 0, 3, 2, 2, 1])
    _s, _p, _i, uq2, *_rest = bp.batch_prep(ids, uq_len=6, minimal=True)
    assert _s is None and _i is None
    np.testing.assert_array_equal(uq2, [1, 2, 4, 9, 2**31 - 2, 2**31 - 2])


@pytest.mark.parametrize("kept", [None, 512])
def test_groups_and_kept_budget(kept):
    """Per-group prep of the multitable model ({group}:-prefixed keys),
    with the multi group compacted to its masked-in positions."""
    cfg = multitable.MultiTableConfig(
        batch_size=32, continue_field_size=4, indicator_field_size=2,
        emb128_field_size=2, emb64_single_field_size=2,
        multi_hot_sizes=(3, 4, 3, 2, 2, 3), emb_128_size=3000,
        emb64_single_size=50, emb64_multi_size=2500, indicator_size=16,
        deep_layer_dim=(32, 16), sparse=True)
    model = multitable.MultiTableWideDeepModel(cfg)
    b = SyntheticOutbrain(cfg, 1, seed=2).get_batch(0)
    kw = dict(groups=prep_groups(model))
    if kept is not None:
        kw.update(minimal=True, kept_budget={"multi": kept})
    out = _same_three(b, 0, **kw)
    assert {"emb128:perm", "multi:uidx_sorted"} <= set(out)
    if kept is not None:
        assert out["multi:perm"].shape == (kept,)
        with pytest.raises(BucketOverflow):
            make_batch_sort(0, groups=prep_groups(model),
                            kept_budget={"multi": 8})(dict(b))


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "batchprep.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(bp, "SRC", bad)
    monkeypatch.setattr(bp, "BUILD_ROOT", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="failed to build batchprep.cc") as ei:
        bp.build()
    assert "error" in str(ei.value)
