"""The kernel calls of one Wide&Deep step, and their bound.

The layout is the sparse step's (``row_layout=True``), copied from
``mindrec_tpu_torch/train/step.py:503-608`` and
``mindrec_tpu_torch/ops/embedding.py:86-167``: one id group whose
unique slots are the trimmed ``uq_ids`` rounded to 2048, both tables
row_packed in one buffer of 128 lanes; the sorted segment-sum, LazyAdam
and FTRL on the rows.
"""

from __future__ import annotations

from portbench.yardstick.kernel_bytes import (
    adam_rows, ftrl_rows, round_up, segsum_sorted,
)


def step_bound_ms(config: dict, batch: dict) -> float:
    """Bound of one step's kernel calls on a staged batch."""
    c = config
    n = c["batch_size"] * c["field_size"]
    uq = batch["uq_ids"].reshape(-1).long()
    slots = round_up(uq.numel())
    valid = int((uq < c["vocab_size"]).sum())
    m_elt = 2 if c["optimizers"]["deep"].get("state_dtype") == "bfloat16" else 4
    width = max(128, round_up(1 + c["emb_dim"], 128))
    return (segsum_sorted(n, width, slots)
            + adam_rows(slots, valid, c["emb_dim"], 4, m_elt, m_elt)
            + ftrl_rows(slots, valid, 1))
