"""Outbrain data for the multitable Wide&Deep model: TFRecords and a
synthetic generator.

Port of ``mindrec_tpu/data/outbrain.py`` (numpy only): the same seeds,
keys and values, and TFRecord files that either package reads.

* the 21-column TFRecord schema: ``label`` and ``continue_val`` are
  float32, everything else int32;
* files are found by walking ``data_dir`` for names holding the
  ``train`` / ``eval`` prefix and ``tfrecord``;
* rows hold ``line_per_sample`` samples and the batch size must be a
  multiple of it; ``num_shards`` / ``shard_id`` shard the files;
* :func:`compute_emb_dim` derives the per-column field sizes and the
  deep input's width from the shapes in the
  ``dataformat/input_shape_dict.json`` sidecar.

A decoded batch feeds
:class:`mindrec_tpu_torch.models.multitable.MultiTableWideDeepModel`:
the files' ``multi_<f>_id_mask`` columns become ``multi_<f>_mask``
keys.  ``to_device`` moves a batch dict to the card (pinned memory,
``non_blocking`` copies; ``data/criteo.py``).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

from mindrec_tpu_torch.data.criteo import to_device
from mindrec_tpu_torch.data.formats import read_tfrecord, write_tfrecord
from mindrec_tpu_torch.models.multitable import MULTI_FIELDS

__all__ = ["COLUMNS", "OutbrainTFRecordDataset", "SyntheticOutbrain",
           "compute_emb_dim", "to_device", "write_outbrain_tfrecords"]


FLOAT_COLUMNS = ("label", "continue_val")

# reference column order, datasets.py:186-196
COLUMNS = (
    "label", "continue_val", "indicator_id", "emb_128_id",
    "emb_64_single_id",
    "multi_doc_event_category_id", "multi_doc_event_category_id_mask",
    "multi_doc_ad_entity_id", "multi_doc_ad_entity_id_mask",
    "multi_doc_event_entity_id", "multi_doc_event_entity_id_mask",
    "multi_doc_ad_topic_id", "multi_doc_ad_topic_id_mask",
    "multi_doc_ad_category_id", "multi_doc_ad_category_id_mask",
    "multi_doc_event_topic_id", "multi_doc_event_topic_id_mask",
    "ad_id", "display_ad_and_is_leak", "display_id", "is_leak",
)


def _batch_key(col: str) -> str:
    """TFRecord column name -> model batch key (masks drop the ``_id``)."""
    if col.endswith("_id_mask"):
        return col[: -len("_id_mask")] + "_mask"
    return col


def compute_emb_dim(shape_dict: dict) -> dict:
    """Per-column field sizes + the flattened deep-input width.

    ``shape_dict`` maps column -> row shape (e.g. ``{"emb_128_id": [B, 3]}``
    or 1-D shapes for scalar columns).  Returns
    ``{"field_sizes": {col: n}, "input_emb_dim": int}`` using the
    reference's table widths: emb_128 columns count x128, indicator /
    emb_64 / multi-hot columns x64, continue_val x1."""
    field_sizes = {}
    for key, shape in shape_dict.items():
        shape = list(shape)
        field_sizes[key] = int(shape[1]) if len(shape) >= 2 else 1
    dim = (
        field_sizes.get("continue_val", 0)
        + field_sizes.get("indicator_id", 0) * 64
        + field_sizes.get("emb_128_id", 0) * 128
        + field_sizes.get("emb_64_single_id", 0) * 64
        + sum(1 for k in field_sizes if k.startswith("multi_") and k.endswith("_id"))
        * 64
    )
    return {"field_sizes": field_sizes, "input_emb_dim": dim}


def write_outbrain_tfrecords(
    data_dir: str | os.PathLike,
    rows: Iterator[dict[str, np.ndarray]],
    rows_per_file: int = 1024,
    prefix: str = "train",
) -> list[str]:
    """Write packed rows (each a dict over :data:`COLUMNS`) as TFRecord
    part files + the ``dataformat/input_shape_dict.json`` sidecar."""
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    paths: list[str] = []
    buf: list[dict] = []
    shape_dict: dict = {}

    def flush():
        if not buf:
            return
        p = data_dir / f"{prefix}_part{len(paths)}.tfrecord"
        write_tfrecord(p, iter(buf))
        paths.append(str(p))
        buf.clear()

    for row in rows:
        if not shape_dict:
            shape_dict = {k: list(np.asarray(v).shape) for k, v in row.items()}
        # schema parity (datasets.py:186-202): only label/continue_val are
        # float32 in the file; masks are stored int32 and floated on read
        buf.append(
            {
                k: np.asarray(v).reshape(-1).astype(
                    np.float32 if k in FLOAT_COLUMNS else np.int32
                )
                for k, v in row.items()
            }
        )
        if len(buf) >= rows_per_file:
            flush()
    flush()
    fmt = data_dir / "dataformat"
    fmt.mkdir(exist_ok=True)
    (fmt / "input_shape_dict.json").write_text(json.dumps(shape_dict))
    return paths


class SyntheticOutbrain:
    """Deterministic synthetic batches (model-ready dicts, the keys the
    reference's TFRecord path produces).  Labels follow a planted
    logistic model over a few ids so training has signal."""

    def __init__(self, cfg, steps: int, seed: int = 0):
        self.cfg = cfg
        self.steps = steps
        self.seed = seed

    def __len__(self):
        return self.steps

    def get_batch(self, s: int) -> dict[str, np.ndarray]:
        c = self.cfg
        B = c.batch_size
        rng = np.random.default_rng(self.seed * 100_003 + s)
        b = {
            "continue_val": rng.uniform(size=(B, c.continue_field_size)).astype(np.float32),
            "indicator_id": rng.integers(0, c.indicator_size, (B, c.indicator_field_size)).astype(np.int32),
            "emb_128_id": rng.integers(0, c.emb_128_size, (B, c.emb128_field_size)).astype(np.int32),
            "emb_64_single_id": rng.integers(0, c.emb64_single_size, (B, c.emb64_single_field_size)).astype(np.int32),
            "display_id": np.repeat(np.arange((B + 3) // 4, dtype=np.int32), 4)[:B],
        }
        for name, L in zip(MULTI_FIELDS, c.multi_hot_sizes):
            b[f"multi_{name}_id"] = rng.integers(0, c.emb64_multi_size, (B, L)).astype(np.int32)
            lens = rng.integers(1, L + 1, B)
            b[f"multi_{name}_mask"] = (
                np.arange(L)[None, :] < lens[:, None]
            ).astype(np.float32)
        z = (
            0.8 * np.sin(b["emb_128_id"][:, 0] * 0.37)
            + 0.6 * np.cos(b["emb_64_single_id"][:, 0] * 0.11)
            + 0.4 * (b["continue_val"][:, 0] - 0.5)
        )
        p = 1.0 / (1.0 + np.exp(-z))
        b["label"] = (rng.uniform(size=B) < p).astype(np.float32)[:, None]
        return b

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        for s in range(self.steps):
            yield self.get_batch(s)


class OutbrainTFRecordDataset:
    """Iterate the Outbrain TFRecords as model-ready batches.

    Yields dicts with arrays of shape ``[batch_size, field]`` (label
    ``[B,1]`` f32, display_id ``[B]`` i32), where ``batch_size`` is
    assembled from ``batch_size // line_per_sample`` packed rows
    (reference ``datasets.py:222-227``)."""

    def __init__(
        self,
        data_dir: str | os.PathLike,
        batch_size: int,
        train_mode: bool = True,
        line_per_sample: Optional[int] = None,
        num_shards: Optional[int] = None,
        shard_id: Optional[int] = None,
    ):
        self.data_dir = Path(data_dir)
        prefix = "train" if train_mode else "eval"
        files = []
        for dirpath, _, names in os.walk(self.data_dir):
            for n in sorted(names):
                if prefix in n and "tfrecord" in n:
                    files.append(os.path.join(dirpath, n))
        if not files:
            raise FileNotFoundError(f"no {prefix}*tfrecord under {data_dir}")
        files.sort()
        if num_shards is not None and shard_id is not None:
            files = files[shard_id::num_shards]
        self.files = files
        fmt = self.data_dir / "dataformat" / "input_shape_dict.json"
        self.shape_dict = json.loads(fmt.read_text()) if fmt.exists() else None
        if line_per_sample is None:
            line_per_sample = (
                int(self.shape_dict["label"][0]) if self.shape_dict else 1
            )
        if batch_size <= 0:
            raise ValueError(f"Batch size should be positive, got {batch_size}")
        if batch_size % line_per_sample != 0:
            raise ValueError(
                f"Batch size should be a multiple of {line_per_sample}, "
                f"but found {batch_size}"
            )
        self.batch_size = batch_size
        self.line_per_sample = line_per_sample
        self.rows_per_batch = batch_size // line_per_sample

    def _assemble(self, rows: Sequence[dict]) -> dict:
        out = {}
        lps = self.line_per_sample
        for col in rows[0]:
            parts = [np.asarray(r[col]).reshape(lps, -1) for r in rows]
            arr = np.concatenate(parts, axis=0)
            if col in FLOAT_COLUMNS or col.endswith("_mask"):
                arr = arr.astype(np.float32)
            else:
                arr = arr.astype(np.int32)
            key = _batch_key(col)
            if col == "display_id":
                out[key] = arr.reshape(-1)
            elif col == "label":
                out[key] = arr.reshape(-1, 1)
            else:
                out[key] = arr
        return out

    def __iter__(self) -> Iterator[dict]:
        rows: list[dict] = []
        for f in self.files:
            for ex in read_tfrecord(f):
                rows.append(ex)
                if len(rows) == self.rows_per_batch:
                    yield self._assemble(rows)
                    rows = []
        # drop_remainder=True parity: incomplete final batch is dropped
