"""Synthetic Criteo-style batches (numpy) and staging them on the card.

``criteo_field_sizes`` and :class:`SyntheticCriteo` are copies of
``mindrec_tpu/data/criteo.py`` (numpy only), so the same seed gives the
same batches in both packages.  :func:`to_device` stages a host batch
through pinned memory with non-blocking copies.

Batch layout: ``{"ids": [B,F] int32, "wts": [B,F] f32, "label": [B,1] f32}``.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

# Criteo-Kaggle categorical cardinalities (C1..C26)
CRITEO_KAGGLE_CAT_CARDINALITIES = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18,
    15, 286181, 105, 142572,
)
N_DENSE_FIELDS = 13  # int columns, bucketized into small id ranges


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
    ``fields="uniform"`` gives every field an equal slice."""

    def __init__(
        self,
        batch_size: int,
        field_size: int = 39,
        vocab_size: int = 200000,
        steps: int = 100,
        seed: int = 0,
        zipf_a: float = 1.1,
        label_noise: float = 0.25,
        model_seed: int = 777,
        fields: str = "uniform",
    ):
        self.batch_size = batch_size
        self.field_size = field_size
        self.vocab_size = vocab_size
        self.steps = steps
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

    def __len__(self):
        return self.steps

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

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        for s in range(self.steps):
            yield self.get_batch(s)


def to_device(batch: dict, device="cuda") -> dict[str, torch.Tensor]:
    """Host numpy batch -> tensors on ``device``.  On a CUDA device the
    arrays go through pinned memory with ``non_blocking=True`` copies on
    the current stream (the caller's later kernels are ordered after
    them on that stream)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out
