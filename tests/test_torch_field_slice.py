"""The port's copy of field-slice partitioning
(``mindrec_tpu_torch/data/field_slice.py``) against the JAX package's
(``tests/test_field_slice.py``): manual shapes, padding, the equalized
layout, remapping, and a row-sliced lookup of remapped ids on a (1, 4)
mesh of gloo ranks, where each field part lands on its own model rank.
This module imports JAX's package only inside its tests (its rank-side
job runs in the spawned ranks).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mindrec_tpu_torch.data import field_slice as fs
from mindrec_tpu_torch.ops.embedding import EmbeddingLookup, from_storage
from mindrec_tpu_torch.parallel import launch
from mindrec_tpu_torch.parallel import mesh as pm

W = 4


def _ref():
    from mindrec_tpu.data import field_slice as ref

    return ref


@pytest.mark.parametrize("field_size,vocab,workers", [
    (39, 200_000, 1), (39, 200_000, 2), (39, 200_000, 4), (39, 250_000, 8),
    (26, 200_000, 3),
])
def test_manual_shape_reference_parity(field_size, vocab, workers):
    ref = _ref()
    got = fs.compute_manual_shape(field_size, vocab, workers)
    want = ref.compute_manual_shape(field_size, vocab, workers)
    assert (got.parts, got.target_column, got.field_size, got.vocab_total) == (
        want.parts, want.target_column, want.field_size, want.vocab_total)
    np.testing.assert_array_equal(got.filler_ids(), want.filler_ids())
    assert fs.equalized_layout(got, 1024) == ref.equalized_layout(want, 1024)


def test_manual_shape_rejects_small_vocab():
    with pytest.raises(ValueError, match="smaller"):
        fs.compute_manual_shape(39, 1000, 4)


def test_pad_and_remap_reference_parity():
    ref = _ref()
    ms = fs.compute_manual_shape(39, 200_000, W)
    rows, _ = fs.equalized_layout(ms, 1024)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 300_000, (16, 39))
    wts = rng.uniform(size=(16, 39)).astype(np.float32)
    got, want = fs.pad_fields(ids, wts, ms), ref.pad_fields(ids, wts, ms)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(fs.remap_ids(got[0], ms, rows),
                                  ref.remap_ids(want[0], ms, rows))
    spec, rows2 = fs.make_field_slice_spec(ms, emb_dim=8, row_alignment=1024)
    rspec, rrows = ref.make_field_slice_spec(ms, emb_dim=8, row_alignment=1024)
    assert rows2 == rrows == rows
    assert (spec.vocab_size, spec.padded_vocab, spec.slice_mode) == (
        rspec.vocab_size, rspec.padded_vocab, rspec.slice_mode)
    assert spec.partition_spec() == tuple(rspec.partition_spec())


def _ids_of_parts(ms, B=16, seed=1):
    rng = np.random.default_rng(seed)
    parts = [ms.part_of_field(f) for f in range(39)]
    return np.stack([rng.integers(ms.parts[p][1], ms.parts[p][1] + ms.parts[p][0],
                                  size=B) for p in parts], axis=1)


def lookup_job(args):
    """Rank side: this rank's block of the field-slice table and the
    lookup of every remapped id."""
    mesh = pm.make_mesh(1, W)
    ms = fs.compute_manual_shape(39, 200_000, W)
    spec, rows = fs.make_field_slice_spec(ms, emb_dim=8, row_alignment=1024)
    lk = EmbeddingLookup(spec, mesh)
    table = lk.init(torch.Generator().manual_seed(0), device="cpu")
    ids_p, _ = fs.pad_fields(_ids_of_parts(ms), np.ones((16, 39), np.float32), ms)
    new = torch.from_numpy(fs.remap_ids(ids_p, ms, rows))
    pm.reset_collectives()
    out = lk(table, new).numpy()
    m = mesh.axis_index("model")
    own = ((new >= m * rows) & (new < (m + 1) * rows)).numpy()
    return {"rows": out, "own": own, "block": table.shape,
            "log": list(pm.COLLECTIVES)}


def test_remap_locality_and_sharded_lookup():
    """Remapped ids of field part p fall in rank p's block (each rank owns
    exactly its part's fields), and the row-sliced lookup of 4 ranks
    returns the whole table's rows with one sum over model."""
    ms = fs.compute_manual_shape(39, 200_000, W)
    spec, rows = fs.make_field_slice_spec(ms, emb_dim=8, row_alignment=1024)
    full = spec.init_table(torch.Generator().manual_seed(0), "cpu")
    ids_p, wts_p = fs.pad_fields(_ids_of_parts(ms), np.ones((16, 39), np.float32),
                                 ms)
    new = fs.remap_ids(ids_p, ms, rows)
    want = from_storage(spec, full).numpy()[new]
    res, _ = launch.run_job(f"{__file__}:lookup_job", {"device": "cpu"}, W,
                            timeout=110)
    for m, o in enumerate(res):
        np.testing.assert_array_equal(o["rows"], want)
        # a dense row-major table: rows sliced on dim 0
        assert tuple(o["block"]) == (spec.storage_shape[0] // W,
                                     spec.storage_shape[1])
        fields = np.flatnonzero(o["own"].all(axis=0))
        assert [ms.part_of_field(f) for f in fields] == [m] * len(fields)
        assert o["own"].any(axis=0).sum() == len(fields) == ms.part_fields
        assert [(op, ax) for op, ax, _ in o["log"]] == [("all_reduce", "model")]
    assert (wts_p[:, 39] == 0).all()  # padded fields weigh nothing


def test_remap_clips_oov_into_part():
    ms = fs.compute_manual_shape(39, 200_000, W)
    _, rows = fs.make_field_slice_spec(ms, emb_dim=8, row_alignment=1024)
    ids = np.full((2, ms.target_column), 10**9, np.int64)
    new = fs.remap_ids(ids, ms, rows)
    for f in range(ms.target_column):
        p = ms.part_of_field(f)
        assert (new[:, f] >= p * rows).all() and (new[:, f] < (p + 1) * rows).all()
