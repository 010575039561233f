"""Criteo TSV preprocessing: 2-pass stats -> cat2id -> packed shards.

Port of ``mindrec_tpu/data/preprocess.py`` (numpy only); the same input
gives the same stats, ids and shards in both packages, and a stats file
written by either loads in the other (``CriteoStats.save`` pickles a
plain ``__dict__``).

* pass 1 (``collect_stats``): per-column min/max of the 13 integer
  columns and value counts of the 26 categorical columns, one file per
  worker process (a ``forkserver`` pool: workers fork from a clean
  server process, not from the caller and its threads);
* vocabulary: a categorical value seen more than ``threshold`` times
  (default 6) gets an id; every other value maps to its column's OOV
  bucket;
* pass 2 (``transform_rows``, ``preprocess``): min-max scaled dense
  values, categorical ids, ``line_per_sample`` samples per packed row,
  every ``1 / test_fraction``-th row to ``test/``.

Criteo row format: label \\t I1..I13 \\t C1..C26 (hex strings).  Output
ids are [13 dense slots + 26 categorical ids] = 39 fields: dense feature
f has id f with the scaled value as its weight, categorical fields have
weight 1.0.
"""

from __future__ import annotations

import collections
import math
import multiprocessing
import pickle
from pathlib import Path
from typing import Iterator

import numpy as np

N_DENSE = 13
N_CAT = 26
N_FIELDS = N_DENSE + N_CAT
CAT_COUNT_THRESHOLD = 6  # reference process_data.py:34
OOV_BUCKETS_PER_COL = 1


def _stats_one_file(path: str):
    vmin = [math.inf] * N_DENSE
    vmax = [-math.inf] * N_DENSE
    counts = [collections.Counter() for _ in range(N_CAT)]
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 1 + N_DENSE + N_CAT:
                parts = parts + [""] * (1 + N_DENSE + N_CAT - len(parts))
            for i in range(N_DENSE):
                v = parts[1 + i]
                if v:
                    x = float(v)
                    vmin[i] = min(vmin[i], x)
                    vmax[i] = max(vmax[i], x)
            for i in range(N_CAT):
                v = parts[1 + N_DENSE + i]
                counts[i][v or "<miss>"] += 1
    return vmin, vmax, counts


class CriteoStats:
    """Pass-1 output: per-column min/max + categorical vocabularies."""

    def __init__(self, vmin, vmax, cat2id, per_col_base, vocab_size):
        self.vmin = vmin
        self.vmax = vmax
        self.cat2id = cat2id  # list of dict value->id (col-local)
        self.per_col_base = per_col_base  # id offset per field (39 entries)
        self.vocab_size = vocab_size

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump(self.__dict__, f)

    @classmethod
    def load(cls, path):
        with open(path, "rb") as f:
            d = pickle.load(f)
        obj = cls.__new__(cls)
        obj.__dict__.update(d)
        return obj


def collect_stats(files: list[str], workers: int = 8, threshold: int = CAT_COUNT_THRESHOLD) -> CriteoStats:
    if len(files) == 1 or workers <= 1:
        results = [_stats_one_file(f) for f in files]
    else:
        ctx = multiprocessing.get_context("forkserver")
        with ctx.Pool(min(workers, len(files))) as pool:
            results = pool.map(_stats_one_file, files)
    vmin = [math.inf] * N_DENSE
    vmax = [-math.inf] * N_DENSE
    counts = [collections.Counter() for _ in range(N_CAT)]
    for fmin, fmax, fcounts in results:
        for i in range(N_DENSE):
            vmin[i] = min(vmin[i], fmin[i])
            vmax[i] = max(vmax[i], fmax[i])
        for i in range(N_CAT):
            counts[i].update(fcounts[i])

    # id space: 13 dense slots first (one id per dense column), then the
    # per-column categorical vocabularies with one OOV bucket each
    per_col_base = [0] * N_FIELDS
    next_id = N_DENSE
    cat2id = []
    for i in range(N_CAT):
        per_col_base[N_DENSE + i] = next_id
        col = {}
        for v, c in counts[i].items():
            if c > threshold:
                col[v] = next_id
                next_id += 1
        cat2id.append(col)
        next_id += OOV_BUCKETS_PER_COL  # OOV bucket at tail of each column
    for i in range(N_DENSE):
        per_col_base[i] = i
    return CriteoStats(vmin, vmax, cat2id, per_col_base, vocab_size=next_id)


def transform_rows(lines: Iterator[str], stats: CriteoStats):
    """Yield (ids[39], wts[39], label) per sample."""
    for line in lines:
        parts = line.rstrip("\n").split("\t")
        if len(parts) < 1 + N_DENSE + N_CAT:
            parts = parts + [""] * (1 + N_DENSE + N_CAT - len(parts))
        label = float(parts[0] or 0)
        ids = np.empty(N_FIELDS, np.int64)
        wts = np.empty(N_FIELDS, np.float32)
        for i in range(N_DENSE):
            v = parts[1 + i]
            lo, hi = stats.vmin[i], stats.vmax[i]
            if v and hi > lo:
                x = (float(v) - lo) / (hi - lo)
            else:
                x = 0.0
            ids[i] = i
            wts[i] = x
        for i in range(N_CAT):
            v = parts[1 + N_DENSE + i] or "<miss>"
            col = stats.cat2id[i]
            oov = (stats.per_col_base[N_DENSE + i] + len(col))
            ids[N_DENSE + i] = col.get(v, oov)
            wts[N_DENSE + i] = 1.0
        yield ids, wts, label


def preprocess(
    input_files: list[str],
    out_dir: str,
    workers: int = 8,
    threshold: int = CAT_COUNT_THRESHOLD,
    line_per_sample: int = 1000,
    test_fraction: float = 0.1,
    stats: CriteoStats | None = None,
):
    """Full 2-pass pipeline -> packed npz shards under out_dir/{train,test}."""
    from mindrec_tpu_torch.data.criteo import write_packed_shards

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if stats is None:
        stats = collect_stats(input_files, workers, threshold)
        stats.save(out / "stats.pkl")

    def batches(files, take_test: bool):
        buf_i, buf_w, buf_l = [], [], []
        n = 0
        for fp in files:
            with open(fp) as f:
                for ids, wts, label in transform_rows(f, stats):
                    is_test = (n % int(1 / test_fraction)) == 0 if test_fraction > 0 else False
                    n += 1
                    if is_test != take_test:
                        continue
                    buf_i.append(ids)
                    buf_w.append(wts)
                    buf_l.append(label)
                    if len(buf_i) == 4096:
                        yield {
                            "ids": np.stack(buf_i).astype(np.int32),
                            "wts": np.stack(buf_w),
                            "label": np.array(buf_l, np.float32)[:, None],
                        }
                        buf_i, buf_w, buf_l = [], [], []
        if buf_i:
            yield {
                "ids": np.stack(buf_i).astype(np.int32),
                "wts": np.stack(buf_w),
                "label": np.array(buf_l, np.float32)[:, None],
            }

    write_packed_shards(out / "train", batches(input_files, False), line_per_sample=line_per_sample)
    write_packed_shards(out / "test", batches(input_files, True), line_per_sample=line_per_sample)
    return stats
