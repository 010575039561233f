"""The Outbrain multitable generator, frozen.

:class:`SyntheticOutbrain` is copied from
``mindrec_tpu_torch/data/outbrain.py:131-173`` (the field names of
``mindrec_tpu_torch/models/multitable.py:41-48``), so that a change to
the program cannot move the benchmark's inputs.  Numpy only,
deterministic in its seed.  Its sizes all come from the configuration
file; a traffic file with ``"generator": "outbrain"`` gives none.
"""

from __future__ import annotations

import numpy as np

MULTI_FIELDS = (
    "doc_ad_category",
    "doc_event_entity",
    "doc_ad_entity",
    "doc_event_topic",
    "doc_event_category",
    "doc_ad_topic",
)


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


def make_source(config: dict, traffic: dict, seed: int) -> SyntheticOutbrain:
    return SyntheticOutbrain(config, seed=seed)
