"""Unique-id bucket policy of the input pipeline.

Port of ``round_bucket`` and ``AdaptiveBucket.from_sample`` from
``mindrec_tpu/data/pipeline.py``: the static bound on distinct ids per
batch that sizes the step's unique buffer, derived from sample batches
with the benchmark's x1.2 headroom.  The rest of the pipeline (prep
pool, overflow growth, prefetch) is not ported yet.
"""

from __future__ import annotations

import numpy as np


def round_bucket(n: int, quantum: int = 2048) -> int:
    """Round a distinct-id bound up to the 2048-row quantum that the
    step rounds ``unique_bucket`` to."""
    return max(quantum, (int(n) + quantum - 1) // quantum * quantum)


class AdaptiveBucket:
    """``unique_bucket`` policy: ``bucket`` is the rounded bound."""

    def __init__(self, bucket: int, headroom: float = 1.2,
                 quantum: int = 2048):
        self.bucket = round_bucket(bucket, quantum)
        self.headroom = headroom
        self.quantum = quantum

    @classmethod
    def from_sample(cls, batches, headroom: float = 1.2,
                    quantum: int = 2048) -> "AdaptiveBucket":
        """Bucket = most distinct ids in the sample batches x headroom."""
        mx = max(int(np.unique(np.asarray(b["ids"])).size) for b in batches)
        return cls(int(mx * headroom), headroom=headroom, quantum=quantum)
