"""Evaluation metrics: AUC and grouped MAP@K (numpy only).

Port of ``mindrec_tpu/train/metrics.py``:

* :class:`AUCMetric`: the exact Mann-Whitney rank statistic with
  midrank ties, as ``sklearn.roc_auc_score`` (no sklearn or scipy
  dependency); :func:`roc_auc` assigns the midranks with array
  operations where the reference loops over the samples, with equal
  results.
* :class:`GroupedMapMetric`: MAP@12 grouped by ``display_id`` for the
  Outbrain multitable model.
"""

from __future__ import annotations

import numpy as np


class Metric:
    def clear(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Exact ROC AUC via the rank-sum (Mann-Whitney U) statistic with
    midrank tie correction, equivalent to sklearn.roc_auc_score."""
    labels = np.asarray(labels).reshape(-1)
    scores = np.asarray(scores).reshape(-1).astype(np.float64)
    pos = labels > 0.5
    n_pos = int(pos.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc needs both positive and negative samples")
    n = labels.size
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    # runs of equal scores [first, last] share the midrank (first+last)/2+1
    new = np.empty(n, bool)
    new[0] = True
    np.not_equal(sorted_scores[1:], sorted_scores[:-1], out=new[1:])
    first = np.flatnonzero(new)
    last = np.append(first[1:], n) - 1
    ranks = np.empty(n, dtype=np.float64)
    ranks[order] = (0.5 * (first + last) + 1.0)[np.cumsum(new) - 1]
    rank_sum_pos = ranks[pos].sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


class AUCMetric(Metric):
    """Accumulating exact AUC."""

    def __init__(self):
        self.clear()

    def clear(self):
        self._scores: list[np.ndarray] = []
        self._labels: list[np.ndarray] = []

    def update(self, probs, labels):
        self._scores.append(np.asarray(probs).reshape(-1))
        self._labels.append(np.asarray(labels).reshape(-1))

    def eval(self) -> float:
        if not self._scores:
            raise RuntimeError("AUCMetric.eval called before update")
        return roc_auc(np.concatenate(self._labels), np.concatenate(self._scores))


class GroupedMapMetric(Metric):
    """MAP@K grouped by a display/group id.

    ``needs`` declares the extra batch columns ``RecModel.eval`` must
    pass to :meth:`update` after (probs, labels)."""

    needs = ("display_id",)

    def __init__(self, k: int = 12):
        self.k = k
        self.clear()

    def clear(self):
        self._scores = []
        self._labels = []
        self._groups = []

    def update(self, probs, labels, group_ids):
        self._scores.append(np.asarray(probs).reshape(-1))
        self._labels.append(np.asarray(labels).reshape(-1))
        self._groups.append(np.asarray(group_ids).reshape(-1))

    def eval(self) -> float:
        """One lexsort by (group, -score) and segment cumsums.  lexsort is
        stable, so rows of equal (group, score) keep insertion order, as
        a per-group ``argsort(-s, kind="mergesort")[:k]`` would."""
        scores = np.concatenate(self._scores).astype(np.float64)
        labels = np.concatenate(self._labels).astype(np.float64)
        groups = np.concatenate(self._groups)
        n = scores.size
        if n == 0:
            return 0.0
        order = np.lexsort((-scores, groups))
        g_sorted = groups[order]
        l_sorted = labels[order]
        new = np.empty(n, bool)
        new[0] = True
        np.not_equal(g_sorted[1:], g_sorted[:-1], out=new[1:])
        gidx = np.cumsum(new) - 1  # 0..G-1 per row
        starts = np.flatnonzero(new)  # first row of each group
        # rank of each row within its group (0-based, score-descending)
        rank = np.arange(n) - starts[gidx]
        # within-group cumulative hit count at each rank
        cum = np.cumsum(l_sorted)
        base = np.where(starts > 0, cum[starts - 1], 0.0)
        seg_cum = cum - base[gidx]
        # AP numerator terms: precision@r * rel_r for the top-k ranks
        topk = rank < self.k
        contrib = np.where(topk, seg_cum / (rank + 1.0) * l_sorted, 0.0)
        ap_num = np.bincount(gidx, weights=contrib)
        totals = np.bincount(gidx, weights=l_sorted)
        denom = np.minimum(totals, float(self.k))
        valid = denom > 0
        if not valid.any():
            return 0.0
        return float((ap_num[valid] / denom[valid]).mean())
