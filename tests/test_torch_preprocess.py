"""The port's Criteo preprocessing and realistic generator against the JAX
package's, on the CPU.

``RealisticCriteo`` must give the same samples, batches and TSV text;
``collect_stats`` (one process, and a pool of two), ``transform_rows``
and ``preprocess`` the same stats, rows and shards; and a stats pickle
written by either package must load in the other.  Everything is exact
(the float weights come from the same float64 arithmetic)."""

import numpy as np
import pytest

from mindrec_tpu.data import preprocess as jpre
from mindrec_tpu.data import realistic as jreal
from mindrec_tpu_torch.data import preprocess, realistic

ROWS = 1200


@pytest.fixture(scope="module")
def tsv(tmp_path_factory):
    d = tmp_path_factory.mktemp("tsv")
    gen = realistic.RealisticCriteo(vocab_scale=0.0005, seed=3)
    return realistic.write_tsv(gen, d, ROWS, rows_per_file=ROWS // 2)


def _same_stats(a, b):
    assert a.vmin == b.vmin and a.vmax == b.vmax
    assert a.cat2id == b.cat2id
    assert a.per_col_base == b.per_col_base and a.vocab_size == b.vocab_size


@pytest.mark.parametrize("step", [0, 5])
def test_realistic_samples_match_reference(step):
    gen = realistic.RealisticCriteo(vocab_scale=0.01, seed=2)
    ref = jreal.RealisticCriteo(vocab_scale=0.01, seed=2)
    assert gen.vocab_size == ref.vocab_size
    for a, b in zip(gen.sample(300, step), ref.sample(300, step)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    got, want = gen.batch(300, step), ref.batch(300, step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_realistic_tsv_and_auc_match_reference(tmp_path, tsv):
    ref = jreal.write_tsv(jreal.RealisticCriteo(vocab_scale=0.0005, seed=3),
                          tmp_path, ROWS, rows_per_file=ROWS // 2)
    assert len(ref) == len(tsv) == 2
    for a, b in zip(tsv, ref):
        assert open(a).read() == open(b).read()
    gen = realistic.RealisticCriteo(vocab_scale=0.01, seed=2)
    want = jreal.RealisticCriteo(vocab_scale=0.01, seed=2)
    assert gen.bayes_auc(n=4000) == want.bayes_auc(n=4000)
    assert gen.positive_rate(n=4000) == want.positive_rate(n=4000)


@pytest.mark.parametrize("workers", [1, 2])
def test_collect_stats_matches_reference(tsv, workers):
    got = preprocess.collect_stats(tsv, workers=workers, threshold=2)
    _same_stats(got, jpre.collect_stats(tsv, workers=1, threshold=2))


def test_transform_rows_match_reference(tsv):
    stats = jpre.collect_stats(tsv, workers=1, threshold=2)
    lines = open(tsv[0]).read().splitlines(True)[:200]
    lines.append("1\t\t3\n")  # short row: missing columns
    got = list(preprocess.transform_rows(iter(lines), stats))
    want = list(jpre.transform_rows(iter(lines), stats))
    assert len(got) == len(want) == 201
    for (gi, gw, gl), (wi, ww, wl) in zip(got, want):
        assert gi.dtype == wi.dtype and gw.dtype == ww.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gw, ww)
        assert gl == wl


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_stats_pickles_cross_load(tmp_path, tsv, writer):
    stats = (preprocess if writer == "port" else jpre).collect_stats(
        tsv, workers=1)
    stats.save(tmp_path / "stats.pkl")
    for mod in (preprocess, jpre):
        back = mod.CriteoStats.load(tmp_path / "stats.pkl")
        assert type(back) is mod.CriteoStats
        _same_stats(back, stats)


def test_preprocess_outputs_match_reference(tmp_path, tsv):
    got = preprocess.preprocess(tsv, str(tmp_path / "port"), workers=1,
                                threshold=2, line_per_sample=100)
    want = jpre.preprocess(tsv, str(tmp_path / "ref"), workers=1,
                           threshold=2, line_per_sample=100)
    _same_stats(got, want)
    _same_stats(preprocess.CriteoStats.load(tmp_path / "port" / "stats.pkl"),
                want)
    for split in ("train", "test"):
        files = sorted((tmp_path / "ref" / split).iterdir())
        assert [f.name for f in files] == sorted(
            f.name for f in (tmp_path / "port" / split).iterdir())
        assert files
        for f in files:
            with np.load(f) as a, np.load(tmp_path / "port" / split /
                                          f.name) as b:
                assert a.files == b.files
                for k in a.files:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
