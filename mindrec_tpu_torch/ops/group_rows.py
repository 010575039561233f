"""An id group's rows in batch order, as the sparse step
(``train/step.py``) hands them to a model.

The step gathers each id group's unique rows into one buffer whose lanes
hold the group's tables side by side (:class:`GroupLayout`, built by the
step's ``_group_layouts``) and expands it to batch order.  A model with
``apply_groups_batch`` (the multitable model) takes each group's rows
whole (:class:`GroupRows`); any other takes each table's slice
(:func:`table_rows`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GroupLayout(NamedTuple):
    """Static layout of one id group's unique-row buffer."""

    keys: tuple
    tables: tuple  # table names, row_packed first (the lane order)
    offs: dict  # table name -> first lane
    lanes: dict  # table name -> lanes (emb_dim, or Dp if feature-major)
    width: int  # buffer lanes, a multiple of 128
    tiny: bool  # sort-free path: the whole id space is the unique set
    id_bound: int


class GroupRows(NamedTuple):
    """One id group's rows in batch order."""

    rows: torch.Tensor  # [B * F_g, width] matmul_dtype: the differentiated leaf
    ids: torch.Tensor  # [B * F_g] flat ids (a folded table's sub-row: id % fold)
    shape: tuple  # (B, F_g)
    layout: GroupLayout  # each table's first lane and lanes in ``rows``


def fold_mask_rows(dp: int, dim: int, sub, dtype):
    """[N, Dp] one-hot: 1 where lane p belongs to fold sub-row sub[n]."""
    lane = torch.arange(dp, device=sub.device) // dim
    return (lane[None, :] == sub[:, None]).to(dtype)


def table_rows(table_specs, groups: dict) -> dict:
    """Each table's rows in batch order ``[B, F_g, lanes]``: its lanes of
    its group's rows (:class:`GroupRows`), folded tables masked to the
    owning sublane, sublane padding dropped."""
    rows = {}
    for gr in groups.values():
        lay = gr.layout
        for name in lay.tables:
            spec = table_specs[name][1]
            o, dpf = lay.offs[name], lay.lanes[name]
            r = gr.rows[:, o: o + dpf]
            if spec.fold > 1:
                sub = torch.remainder(gr.ids, spec.fold)
                r = r * fold_mask_rows(dpf, spec.emb_dim, sub, r.dtype)
            else:
                r = r[:, : spec.emb_dim]  # drop sublane padding
            rows[name] = r.reshape(*gr.shape, -1)
    return rows
