"""The port's dataset formats against the JAX package's, on the CPU.

TFRecord files (``data/formats.py``) must be byte-identical both ways and
either package's reader must give the same batches from either
package's files; the same for the packed ``.npz`` shards
(``data/criteo.py``), the H5 parts and the Outbrain TFRecords
(``data/outbrain.py``).  ``records2bin --data`` converts shards a test
wrote as the reference does.  Everything is exact (no tolerance)."""

from pathlib import Path

import numpy as np
import pytest

from mindrec_tpu.data import criteo as jcriteo
from mindrec_tpu.data import formats as jformats
from mindrec_tpu.data import outbrain as joutbrain
from mindrec_tpu.models import multitable as jmt
from mindrec_tpu.serving import records2bin as jr2b
from mindrec_tpu_torch.data import criteo, formats, outbrain
from mindrec_tpu_torch.models import multitable
from mindrec_tpu_torch.serving import records2bin

GOLDEN = Path(__file__).parent / "golden" / "criteo_golden.tfrecord"
MT = dict(batch_size=40, continue_field_size=3, indicator_field_size=2,
          emb128_field_size=2, emb64_single_field_size=2,
          multi_hot_sizes=(3, 2, 2, 1, 2, 3), emb_128_size=500,
          emb64_single_size=50, emb64_multi_size=300, indicator_size=16)


def _criteo(n_batches, bs=250, seed=0):
    return [criteo.SyntheticCriteo(bs, 39, 10_000, seed=seed,
                                   fields="criteo").get_batch(s)
            for s in range(n_batches)]


def _same_batches(got, want):
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("n", [0, 1, 7, 4096])
def test_crc32c_matches_reference(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert formats.crc32c(data) == jformats.crc32c(data)
    assert formats._masked_crc(data) == jformats._masked_crc(data)


def test_tfrecord_bytes_match_reference_and_golden(tmp_path):
    examples = [
        {"ids": np.array([5, -6, 1 << 40, 0], np.int64),
         "wts": np.array([0.5, -1.25, np.inf], np.float32),
         "tag": np.array([b"mindrec", b""], dtype=object)},
        {"ids": np.array([], np.int64), "wts": np.zeros(0, np.float32)},
    ]
    for ex in examples:
        assert formats.encode_example(ex) == jformats.encode_example(ex)
    assert formats.write_tfrecord(tmp_path / "p.tfrecord", iter(examples)) == 2
    jformats.write_tfrecord(tmp_path / "r.tfrecord", iter(examples))
    assert (tmp_path / "p.tfrecord").read_bytes() == \
        (tmp_path / "r.tfrecord").read_bytes()
    for path in (GOLDEN, tmp_path / "r.tfrecord"):
        got = list(formats.read_tfrecord(path, verify_crc=True))
        want = list(jformats.read_tfrecord(path, verify_crc=True))
        assert [sorted(g) for g in got] == [sorted(w) for w in want]
        for g, w in zip(got, want):
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    bad = bytearray(GOLDEN.read_bytes())
    bad[-5] ^= 0xFF
    (tmp_path / "bad.tfrecord").write_bytes(bytes(bad))
    with pytest.raises(IOError, match="crc mismatch"):
        list(formats.read_tfrecord(tmp_path / "bad.tfrecord", verify_crc=True))


@pytest.mark.parametrize("num_shards", [1, 2])
def test_criteo_tfrecords_cross_read(tmp_path, num_shards):
    data = _criteo(4)
    n_port = formats.write_criteo_tfrecords(tmp_path / "port", iter(data),
                                            records_per_file=1,
                                            line_per_sample=125)
    n_ref = jformats.write_criteo_tfrecords(tmp_path / "ref", iter(data),
                                            records_per_file=1,
                                            line_per_sample=125)
    assert n_port == n_ref == 8
    for f in sorted((tmp_path / "ref").iterdir()):
        assert (tmp_path / "port" / f.name).read_bytes() == f.read_bytes()
    for shard in range(num_shards):
        kw = dict(num_shards=num_shards, shard_id=shard, line_per_sample=125)
        want = list(jformats.TFRecordCriteoDataset(tmp_path / "ref", 250, **kw))
        for d in ("port", "ref"):
            _same_batches(list(formats.TFRecordCriteoDataset(
                tmp_path / d, 250, **kw)), want)
    _same_batches(list(formats.TFRecordCriteoDataset(
        tmp_path / "port", 250, line_per_sample=125)), data)
    with pytest.raises(ValueError, match="multiple"):
        formats.TFRecordCriteoDataset(tmp_path / "port", 300,
                                      line_per_sample=125)


@pytest.mark.parametrize("num_shards", [1, 3])
def test_packed_shards_cross_read(tmp_path, num_shards):
    data = _criteo(5)  # 10 rows of 125 samples in 4 shards: 3 + 3 + 3 + 1
    assert criteo.write_packed_shards(tmp_path / "port", iter(data),
                                      rows_per_shard=3,
                                      line_per_sample=125) == 4
    jcriteo.write_packed_shards(tmp_path / "ref", iter(data),
                                rows_per_shard=3, line_per_sample=125)
    for f in sorted((tmp_path / "ref").iterdir()):
        with np.load(f) as a, np.load(tmp_path / "port" / f.name) as b:
            assert a.files == b.files
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    for shard in range(num_shards):
        for drop in (True, False):
            kw = dict(num_shards=num_shards, shard_id=shard,
                      line_per_sample=125, drop_remainder=drop)
            want = list(jcriteo.PackedCriteoDataset(tmp_path / "ref", 250, **kw))
            for d in ("port", "ref"):
                _same_batches(list(criteo.PackedCriteoDataset(
                    tmp_path / d, 250, **kw)), want)


def test_h5_parts_cross_read(tmp_path):
    pytest.importorskip("h5py")
    data = _criteo(3, bs=100)
    assert formats.H5CriteoDataset.write_parts(tmp_path / "port", iter(data),
                                               samples_per_part=200) == 2
    jformats.H5CriteoDataset.write_parts(tmp_path / "ref", iter(data),
                                         samples_per_part=200)
    for d in ("port", "ref"):
        got = formats.H5CriteoDataset(tmp_path / d, 100, max_rounds=1)
        want = jformats.H5CriteoDataset(tmp_path / "ref", 100, max_rounds=1)
        _same_batches(list(got), list(want))
        _same_batches(list(got), data)
        shuf = dict(max_rounds=2, shuffle=True, seed=4)
        _same_batches(list(formats.H5CriteoDataset(tmp_path / d, 100, **shuf)),
                      list(jformats.H5CriteoDataset(tmp_path / "ref", 100,
                                                    **shuf)))
    endless = iter(formats.H5CriteoDataset(tmp_path / "port", 100))
    _same_batches([next(endless) for _ in range(4)], data + data[:1])


@pytest.mark.parametrize("kind", ["PACKED", "TFRECORD", "H5"])
def test_create_dataset_matches_reference(tmp_path, kind):
    data = _criteo(2)
    if kind == "PACKED":
        criteo.write_packed_shards(tmp_path, iter(data), line_per_sample=125)
    elif kind == "TFRECORD":
        formats.write_criteo_tfrecords(tmp_path, iter(data),
                                       line_per_sample=125)
    else:
        pytest.importorskip("h5py")
        formats.H5CriteoDataset.write_parts(tmp_path, iter(data), 250)
    ds = formats.create_dataset(tmp_path, 250, formats.DataType[kind],
                                line_per_sample=125)
    ref = jformats.create_dataset(tmp_path, 250, jformats.DataType[kind],
                                  line_per_sample=125)
    assert type(ds).__name__ == type(ref).__name__
    assert type(ds).__module__.startswith("mindrec_tpu_torch.")
    _same_batches(list(ds), list(ref))
    _same_batches(list(ds), data)


def _outbrain_rows(n_rows, lps, seed=0):
    """Packed rows over the 21-column schema from synthetic batches."""
    cfg = multitable.MultiTableConfig(**MT)
    out = []
    for b in outbrain.SyntheticOutbrain(cfg, n_rows * lps // cfg.batch_size,
                                        seed=seed):
        B = cfg.batch_size
        for r in range(0, B, lps):
            row = {}
            for col in outbrain.COLUMNS:
                key = outbrain._batch_key(col)
                if key in ("display_ad_and_is_leak", "ad_id", "is_leak"):
                    v = np.arange(r, r + lps, dtype=np.int32)
                else:
                    v = b[key][r:r + lps]
                row[col] = np.asarray(v).reshape(lps, -1)
            out.append(row)
    return out


def test_outbrain_tfrecords_cross_read(tmp_path):
    rows = _outbrain_rows(8, 10)
    paths = outbrain.write_outbrain_tfrecords(tmp_path / "port", iter(rows),
                                              rows_per_file=3)
    jpaths = joutbrain.write_outbrain_tfrecords(tmp_path / "ref", iter(rows),
                                                rows_per_file=3)
    assert [Path(p).name for p in paths] == [Path(p).name for p in jpaths]
    for p, q in zip(paths, jpaths):
        assert Path(p).read_bytes() == Path(q).read_bytes()
    assert (tmp_path / "port" / "dataformat" / "input_shape_dict.json"
            ).read_text() == (tmp_path / "ref" / "dataformat" /
                              "input_shape_dict.json").read_text()
    for kw in ({}, {"num_shards": 2, "shard_id": 1}):
        want = list(joutbrain.OutbrainTFRecordDataset(tmp_path / "ref", 20,
                                                      **kw))
        for d in ("port", "ref"):
            _same_batches(list(outbrain.OutbrainTFRecordDataset(
                tmp_path / d, 20, **kw)), want)
    batch = next(iter(outbrain.OutbrainTFRecordDataset(tmp_path / "port", 20)))
    assert set(multitable.MULTI_FIELDS) == set(jmt.MULTI_FIELDS)
    for name in multitable.MULTI_FIELDS:
        assert batch[f"multi_{name}_mask"].dtype == np.float32
    with pytest.raises(ValueError, match="multiple of 10"):
        outbrain.OutbrainTFRecordDataset(tmp_path / "port", 25)
    shapes = {"label": [10, 1], "emb_128_id": [10, 2], "continue_val": [10, 3]}
    assert outbrain.compute_emb_dim(shapes) == joutbrain.compute_emb_dim(shapes)


def test_records2bin_data_matches_reference(tmp_path):
    criteo.write_packed_shards(tmp_path / "shards", iter(_criteo(3, bs=1000)))
    args = ["--data", str(tmp_path / "shards"), "--batch-size", "1000",
            "--max-batches", "2"]
    records2bin.main(args + ["--out", str(tmp_path / "port")])
    jr2b.main(args + ["--out", str(tmp_path / "ref")])
    names = sorted(f.name for f in (tmp_path / "ref").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "port").iterdir())
    assert names == ["ids_0.bin", "ids_1.bin", "labels.txt", "wts_0.bin",
                     "wts_1.bin"]
    for f in names:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "ref" / f).read_bytes(), f
