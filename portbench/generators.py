"""The traffic generators, frozen.

Copies of the port's synthetic generators, so that a change to the
program cannot move the benchmark's inputs:

* :func:`criteo_field_sizes` and :class:`SyntheticCriteo`: copied from
  ``mindrec_tpu_torch/data/criteo.py:29-118``;
* :class:`SyntheticOutbrain`: copied from
  ``mindrec_tpu_torch/data/outbrain.py:131-173`` (the field names of
  ``mindrec_tpu_torch/models/multitable.py:41-48``).

Both are numpy only and deterministic in their seed: the same seed and
batch index give the same batch on every machine with the same numpy.
A traffic file (``portbench/traffic/<mix>.json``) names the generator
under ``"generator"`` and gives its parameters; :func:`make_source`
builds it.
"""

from __future__ import annotations

import numpy as np

# Criteo-Kaggle categorical cardinalities (C1..C26)
CRITEO_KAGGLE_CAT_CARDINALITIES = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18,
    15, 286181, 105, 142572,
)
N_DENSE_FIELDS = 13  # int columns, bucketized into small id ranges

MULTI_FIELDS = (
    "doc_ad_category",
    "doc_event_entity",
    "doc_ad_entity",
    "doc_event_topic",
    "doc_event_category",
    "doc_ad_topic",
)


def criteo_field_sizes(vocab_size: int, field_size: int = 39) -> np.ndarray:
    """Per-field id-range sizes proportional to the real criteo schema,
    scaled so they sum to ``vocab_size``."""
    dense = [64.0] * min(N_DENSE_FIELDS, field_size)
    n_cat = field_size - len(dense)
    cats = [
        float(CRITEO_KAGGLE_CAT_CARDINALITIES[i % 26]) for i in range(n_cat)
    ]
    base = np.array(dense + cats, np.float64)
    small = base < 10000
    fixed = base[small].sum()
    scale = max(vocab_size - fixed, 1) / max(base[~small].sum(), 1)
    sizes = np.where(small, base, np.maximum(base * scale, 4.0)).astype(np.int64)
    sizes[np.argmax(sizes)] += vocab_size - sizes.sum()
    return np.maximum(sizes, 1)


class SyntheticCriteo:
    """Synthetic criteo-like stream with a power-law id distribution;
    ``fields="criteo"`` sizes the field ranges like the real schema,
    ``fields="uniform"`` gives every field an equal slice.  Batch:
    ``{"ids": [B,F] int32, "wts": [B,F] f32, "label": [B,1] f32}``."""

    def __init__(self, batch_size: int, field_size: int = 39,
                 vocab_size: int = 200000, seed: int = 0,
                 zipf_a: float = 1.1, label_noise: float = 0.25,
                 model_seed: int = 777, fields: str = "uniform"):
        self.batch_size = batch_size
        self.field_size = field_size
        self.vocab_size = vocab_size
        self.seed = seed
        self.zipf_a = zipf_a
        self.label_noise = label_noise
        if fields == "criteo":
            sizes = criteo_field_sizes(vocab_size, field_size)
        elif fields == "uniform":
            per_field = max(vocab_size // field_size, 1)
            sizes = np.full(field_size, per_field, np.int64)
        else:
            raise ValueError(f"fields must be uniform|criteo, got {fields}")
        self._field_sizes = sizes
        self._field_offsets = np.concatenate(
            [[0], np.cumsum(sizes)[:-1]]
        ).astype(np.int64)
        rng = np.random.default_rng(model_seed)
        self._hidden_w = rng.normal(0, 1.0, size=vocab_size).astype(np.float32)

    def get_batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed + step)
        b, f = self.batch_size, self.field_size
        raw = rng.zipf(self.zipf_a, size=(b, f)).astype(np.int64)
        ids = (raw % self._field_sizes[None, :]) + self._field_offsets[None, :]
        ids = (ids % self.vocab_size).astype(np.int32)
        wts = np.ones((b, f), np.float32)
        logit = self._hidden_w[ids].mean(axis=1) * 3.0
        p = 1.0 / (1.0 + np.exp(-logit))
        noise = rng.uniform(size=b)
        label = ((1 - self.label_noise) * p + self.label_noise * noise > 0.5).astype(
            np.float32
        )[:, None]
        return {"ids": ids, "wts": wts, "label": label}


class SyntheticOutbrain:
    """Deterministic synthetic Outbrain batches (the keys of the
    reference's TFRecord path): ids uniform in each table's vocabulary,
    multi-hot fields of length 1..L with a prefix mask, labels from a
    planted logistic model over a few ids."""

    def __init__(self, cfg: dict, seed: int = 0):
        self.cfg = cfg
        self.seed = seed

    def get_batch(self, s: int) -> dict[str, np.ndarray]:
        c = self.cfg
        B = c["batch_size"]
        rng = np.random.default_rng(self.seed * 100_003 + s)
        b = {
            "continue_val": rng.uniform(size=(B, c["continue_field_size"])).astype(np.float32),
            "indicator_id": rng.integers(0, c["indicator_size"], (B, c["indicator_field_size"])).astype(np.int32),
            "emb_128_id": rng.integers(0, c["emb_128_size"], (B, c["emb128_field_size"])).astype(np.int32),
            "emb_64_single_id": rng.integers(0, c["emb64_single_size"], (B, c["emb64_single_field_size"])).astype(np.int32),
            "display_id": np.repeat(np.arange((B + 3) // 4, dtype=np.int32), 4)[:B],
        }
        for name, L in zip(MULTI_FIELDS, c["multi_hot_sizes"]):
            b[f"multi_{name}_id"] = rng.integers(0, c["emb64_multi_size"], (B, L)).astype(np.int32)
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


def make_source(config: dict, traffic: dict, seed: int):
    """The generator a traffic file names, at the configuration's
    sizes, seeded by the run's ``--seed``."""
    kind = traffic["generator"]
    if kind == "criteo":
        return SyntheticCriteo(
            config["batch_size"], config["field_size"], config["vocab_size"],
            seed=seed, zipf_a=traffic["zipf_a"],
            label_noise=traffic["label_noise"],
            model_seed=traffic["model_seed"], fields=traffic["fields"])
    if kind == "outbrain":
        return SyntheticOutbrain(config, seed=seed)
    raise ValueError(f"unknown generator {kind!r}")
