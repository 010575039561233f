"""The kernel calls of one multitable step, and their bound.

The layout is the sparse step's (``row_layout=True``), copied from
``mindrec_tpu_torch/train/step.py:503-608`` and
``mindrec_tpu_torch/ops/embedding.py:86-167``: four id groups; a
group's slots its lossless positions rounded to 2048 (the tiny indicator
group: its whole id space, unsorted sums and presence counts); each
deep table feature-major fold 1, each wide table folded 8 rows to a
column; the gathers into the group's buffer, the sums, LazyAdam and
FTRL on the columns, which read the sums in place (a wide table's
with its fold sub-rows; the tiny group's with its presence gate).
"""

from __future__ import annotations

import torch

from portbench.yardstick.kernel_bytes import (
    adam_cols, ftrl_cols, gather_rows, round_up, segsum_sorted,
    segsum_unsorted,
)


def _padded_vocab(vocab: int) -> int:
    return round_up(vocab + 8, 8192)


def _live(cols: torch.Tensor, vc: int) -> tuple[int, int]:
    """(live slots, distinct live columns) of a call's columns."""
    live = cols[(cols >= 0) & (cols < vc)]
    return int(live.numel()), int(torch.unique(live).numel())


def step_bound_ms(config: dict, batch: dict) -> float:
    """Bound of one step's kernel calls on a staged batch."""
    c = config
    B = c["batch_size"]
    groups = {  # group: (positions, vocab, deep dim, sorted)
        "indicator": (B * c["indicator_field_size"], c["indicator_size"],
                      64, False),
        "emb128": (B * c["emb128_field_size"], c["emb_128_size"], 128, True),
        "emb64_single": (B * c["emb64_single_field_size"],
                         c["emb64_single_size"], 64, True),
        "multi": (B * sum(c["multi_hot_sizes"]), c["emb64_multi_size"], 64,
                  True),
    }
    total = 0.0
    for g, (n, vocab, dim, srt) in groups.items():
        width = max(128, round_up(dim + 8, 128))
        if srt:
            uq = batch[f"{g}:uq_ids"].reshape(-1).long()
            slots = round_up(uq.numel())
            total += segsum_sorted(n, width, slots)
            present = None
        else:  # tiny: the whole id space is the unique set, unsorted sums
            slots = round_up(vocab + 9)
            uq = torch.arange(slots, device=batch["label"].device)
            total += segsum_unsorted(n, width, slots)
            total += segsum_unsorted(n, 1, slots)  # presence counts
            present = int(torch.unique(batch["indicator_id"]).numel())
        vp = _padded_vocab(vocab)
        # deep table: fold 1, [dim, vp]; wide table: fold 8, [8, vp / 8]
        valid, distinct = _live(uq, vp)
        total += gather_rows(slots, distinct, valid, dim)
        gated = present is not None
        total += adam_cols(slots, valid,
                           (distinct if present is None else present) * dim,
                           dim, gate=gated)
        valid_w, distinct_w = _live(torch.div(uq, 8, rounding_mode="floor"),
                                    vp // 8)
        total += gather_rows(slots, distinct_w, valid_w, 8)
        total += ftrl_cols(slots, valid_w,
                           valid if present is None else present, 8,
                           sub=True, gate=gated)
    return total
