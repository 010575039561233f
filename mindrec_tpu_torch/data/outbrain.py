"""Synthetic Outbrain-shaped batches for the multitable Wide&Deep model.

Port of ``SyntheticOutbrain`` from ``mindrec_tpu/data/outbrain.py``: the
same seeds, keys and values (numpy), so the two packages see identical
batches.  ``to_device`` moves a batch dict to the card (pinned memory,
``non_blocking`` copies; ``data/criteo.py``).  The TFRecord reader is
not ported yet.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from mindrec_tpu_torch.data.criteo import to_device
from mindrec_tpu_torch.models.multitable import MULTI_FIELDS

__all__ = ["SyntheticOutbrain", "to_device"]


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
