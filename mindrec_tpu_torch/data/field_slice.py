"""Field-slice embedding partitioning (reference "split field mode").

The port's own copy of ``mindrec_tpu/data/field_slice.py`` (numpy only);
:func:`make_field_slice_spec` builds the port's
:class:`~mindrec_tpu_torch.ops.embedding.EmbeddingTableSpec`.  The
original text follows.

The reference exposes a ``field_slice`` config flag
(``models/wide_deep/default_config.yaml:35,64``) whose machinery lives in
the dataset layer (``models/wide_deep/src/datasets.py:329-446``:
``_get_vocab_size`` / ``compute_manual_shape``; ``datasets.py:182-218``:
``_padding_func``):

* the 39 criteo fields are grouped into ``worker_size`` contiguous
  *parts* (the field axis is padded to ``target_column`` so it divides
  evenly — ``datasets.py:434-436``);
* each worker owns one part's slice of the embedding table:
  ``manual_shape = ((rows_0, offset_0), ..., (rows_{W-1}, offset_{W-1}))``
  where ``offset_p`` is the cumulative vocab offset of part ``p`` and
  ``rows_p`` its row count (leftover vocab goes to the last part —
  ``datasets.py:409-416``);
* padded field positions get a *filler id* pointing at the last row of
  their part and a zero weight so they contribute nothing
  (``datasets.py:186-206``).

Realisation on a mesh
---------------------
Instead of MindSpore's FIELD_SLICE auto-parallel strategy, the parts are
laid out so that part ``p`` occupies exactly the ``p``-th equal shard of
a ``table_row_slice`` table over the mesh's ``model`` axis
(:func:`equalized_layout`).  After :func:`remap_ids`, every lookup for a
field in part ``p`` falls inside rank ``p``'s block, so the sharded
lookup reads it on its owner alone: the analog of the reference's "each
worker holds its fields' vocab" (SURVEY §5 "manual field slicing w/
per-worker vocab shards").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

# Per-field criteo vocabulary cardinalities used by the reference to size
# the field groups (``models/wide_deep/src/datasets.py:340-380``): the 13
# integer fields hash to single-row buckets; the 26 categorical fields
# carry the real vocab.
CRITEO_FIELD_VOCABS = (
    [1] * 13
    + [
        691, 540, 20855, 23639, 182, 15, 10091, 347, 4, 16366, 4494, 21293,
        3103, 27, 6944, 22366, 11, 3267, 1610, 5, 21762, 14, 15, 15030, 61,
        12220,
    ]
)


@dataclasses.dataclass(frozen=True)
class ManualShape:
    """``(rows, offset)`` per part + the padded field count."""

    parts: tuple  # ((rows_p, offset_p), ...)
    target_column: int
    field_size: int
    vocab_total: int

    @property
    def worker_size(self) -> int:
        return len(self.parts)

    @property
    def part_fields(self) -> int:
        return self.target_column // self.worker_size

    def part_of_field(self, f: int) -> int:
        return f // self.part_fields

    def filler_ids(self) -> np.ndarray:
        """Global filler id per padded field position
        (= part's last row, ``datasets.py:186-192``)."""
        return np.array(
            [
                self.parts[self.part_of_field(f)][0]
                + self.parts[self.part_of_field(f)][1]
                - 1
                for f in range(self.field_size, self.target_column)
            ],
            np.int64,
        )


def compute_manual_shape(
    field_size: int,
    vocab_size: int,
    worker_size: int,
    field_vocabs: Optional[Sequence[int]] = None,
) -> ManualShape:
    """Group fields into ``worker_size`` parts and size each part's vocab
    slice (reference ``compute_manual_shape`` + ``_get_vocab_size``,
    ``models/wide_deep/src/datasets.py:329-446``).

    Parity points: the field axis is padded to
    ``(field_size // worker_size + 1) * worker_size``; per-part row counts
    are the sum of the part's field cardinalities; offsets accumulate the
    *original* sums; the leftover of ``vocab_size`` is folded into the
    last part (raises if ``vocab_size`` is smaller than the field sums,
    like the reference's ValueError at ``datasets.py:413-416``).
    """
    if field_vocabs is None:
        field_vocabs = CRITEO_FIELD_VOCABS
    target_column = (field_size // worker_size + 1) * worker_size
    vocabs = list(field_vocabs[:field_size]) + [1] * (target_column - field_size)
    part_fields = target_column // worker_size
    sums = [
        sum(vocabs[i : i + part_fields])
        for i in range(0, target_column, part_fields)
    ]
    rows = list(sums)
    if vocab_size > sum(rows):
        rows[-1] = vocab_size - sum(rows[:-1])
    elif vocab_size < sum(rows):
        raise ValueError(
            f"vocab_size {vocab_size} smaller than per-field sums {sum(rows)}"
        )
    offsets = [0]
    for p in range(worker_size - 1):
        offsets.append(offsets[p] + sums[p])
    return ManualShape(
        parts=tuple(zip(rows, offsets)),
        target_column=target_column,
        field_size=field_size,
        vocab_total=sum(rows),
    )


def pad_fields(ids, wts, ms: ManualShape):
    """Pad ``[B, field_size]`` id/weight arrays to ``[B, target_column]``
    (reference ``_padding_func``, ``datasets.py:182-206``): filler ids at
    each part's last row, zero weights."""
    ids = np.asarray(ids)
    wts = np.asarray(wts)
    b, f = ids.shape
    if f != ms.field_size:
        raise ValueError(f"expected {ms.field_size} fields, got {f}")
    extra = ms.target_column - ms.field_size
    fill = np.broadcast_to(ms.filler_ids(), (b, extra)).astype(ids.dtype)
    ids_p = np.concatenate([ids, fill], axis=1)
    wts_p = np.concatenate([wts, np.zeros((b, extra), wts.dtype)], axis=1)
    return ids_p, wts_p


def equalized_layout(ms: ManualShape, row_alignment: int = 8192):
    """Equal-size per-part row blocks for a ``table_row_slice`` table.

    Returns ``(rows_per_part, vocab_size)`` such that an
    :class:`~mindrec_tpu_torch.ops.embedding.EmbeddingTableSpec` built with that
    ``vocab_size`` (and the same ``row_alignment``) has
    ``padded_vocab == worker_size * rows_per_part`` — i.e. mesh shard
    ``p`` of the row-sliced table holds exactly part ``p``.  The spec's 8
    reserved rows (dummy + spare) live at the end of the last part.
    """
    need = max(r for r, _ in ms.parts)
    rows = math.ceil((need + 8) / row_alignment) * row_alignment
    vocab_size = ms.worker_size * rows - 8
    return rows, vocab_size


def remap_ids(ids, ms: ManualShape, rows_per_part: int):
    """Global padded ids ``[B, target_column]`` -> equalized-layout ids.

    Field ``f``'s part is ``f // part_fields``; a global id ``g`` becomes
    ``part * rows_per_part + (g - offset_part)``, clipped into the part so
    out-of-range ids never leave their shard (OOV stays local, matching
    the reference's per-part OOV bucket intent)."""
    ids = np.asarray(ids)
    if ids.shape[1] != ms.target_column:
        raise ValueError(
            f"expected padded field dim {ms.target_column}, got {ids.shape[1]}"
        )
    part = np.arange(ms.target_column) // ms.part_fields
    sizes = np.array([r for r, _ in ms.parts], np.int64)[part]
    offs = np.array([o for _, o in ms.parts], np.int64)[part]
    local = np.clip(ids - offs, 0, sizes - 1)
    return (part * rows_per_part + local).astype(np.int64)


def make_field_slice_spec(ms: ManualShape, emb_dim: int, name: str = "embedding",
                          sparse: bool = False, row_alignment: int = 8192):
    """Build ``(EmbeddingTableSpec, rows_per_part)`` whose row-sliced
    shards line up with the field parts (see :func:`equalized_layout`)."""
    from mindrec_tpu_torch.ops.embedding import EmbeddingTableSpec

    rows, vocab_size = equalized_layout(ms, row_alignment)
    spec = EmbeddingTableSpec(
        vocab_size=vocab_size,
        emb_dim=emb_dim,
        name=name,
        slice_mode="table_row_slice",
        sparse=sparse,
        row_alignment=row_alignment,
    )
    assert spec.padded_vocab == ms.worker_size * rows, (
        spec.padded_vocab,
        ms.worker_size,
        rows,
    )
    return spec, rows
