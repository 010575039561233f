"""Statistics-faithful synthetic Criteo with a planted CTR model.

Port of ``mindrec_tpu/data/realistic.py`` (numpy only): the same seed
gives the same rows, batches and TSV text in both packages.  The stream
matches the published statistics of the Criteo-Kaggle set (13 integer +
26 categorical columns, per-column cardinalities from the published
schema, scaled; zipf id frequencies per column) and its labels follow a
planted logistic model (per-id linear effects, pairwise latent-factor
interactions, the scaled integer features) whose per-id parameters are
hash-derived (splitmix64), so the generator needs O(1) memory at any
vocabulary and train / eval streams share one ground truth.

:meth:`RealisticCriteo.bayes_auc` is the planted model's own AUC, the
ceiling no learner can beat.  :func:`write_tsv` emits the raw TSV
format (label, 13 ints, 26 hex cats) so ``data/preprocess.py`` runs its
2-pass path on this data.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)
_C1 = np.uint64(0xBF58476D1CE4E5B9)
_C2 = np.uint64(0x94D049BB133111EB)
_GOLD = np.uint64(0x9E3779B97F4A7C15)


def _splitmix(x: np.ndarray, salt: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = (x.astype(np.uint64) + np.uint64(salt) * _GOLD) & _MASK
        x = ((x ^ (x >> np.uint64(30))) * _C1) & _MASK
        x = ((x ^ (x >> np.uint64(27))) * _C2) & _MASK
        return x ^ (x >> np.uint64(31))


def _unit_normal(x: np.ndarray, salt: int) -> np.ndarray:
    """Deterministic standard-normal-ish value per key (Box-Muller on two
    hash-derived uniforms)."""
    u1 = (_splitmix(x, salt).astype(np.float64) + 1.0) / 2.0**64
    u2 = (_splitmix(x, salt + 101).astype(np.float64) + 1.0) / 2.0**64
    return (np.sqrt(-2.0 * np.log(u1)) * np.cos(2 * np.pi * u2)).astype(np.float32)


class RealisticCriteo:
    """Planted-model Criteo-Kaggle-like sample stream.

    Yields raw (dense_vals [B,13] f32-ish ints, cat_ids [B,26] i64
    per-column ids, label [B]) via :meth:`sample`; :meth:`batch` returns
    the model-ready dict (global ids + weights) without the preprocess
    round trip, for in-memory runs.
    """

    N_DENSE = 13
    N_CAT = 26

    def __init__(
        self,
        vocab_scale: float = 0.03,
        zipf_a: float = 1.15,
        k_latent: int = 4,
        w_lin: float = 3.0,
        w_pair: float = 1.5,
        w_dense: float = 1.0,
        bias: float = -2.3,
        seed: int = 0,
    ):
        from mindrec_tpu_torch.data.criteo import CRITEO_KAGGLE_CAT_CARDINALITIES

        self.card = np.maximum(
            (np.array(CRITEO_KAGGLE_CAT_CARDINALITIES, np.float64) * vocab_scale)
            .astype(np.int64),
            3,
        )
        self.k = k_latent
        self.w_lin = w_lin
        self.w_pair = w_pair
        self.w_dense = w_dense
        self.bias = bias
        self.seed = seed
        # global id layout: 13 dense columns own ids 0..12 (weights carry
        # the value, matching transform_rows), cats follow
        self.cat_offsets = self.N_DENSE + np.concatenate(
            [[0], np.cumsum(self.card)[:-1]]
        ).astype(np.int64)
        self.vocab_size = int(self.N_DENSE + self.card.sum())

    # -- planted model --------------------------------------------------

    def _logits(self, gids: np.ndarray, dense: np.ndarray) -> np.ndarray:
        """gids [B, 26] global cat ids, dense [B, 13] scaled 0..1."""
        b = gids.shape[0]
        lin = _unit_normal(gids.reshape(-1), 1).reshape(b, self.N_CAT)
        z = self.w_lin * lin.mean(axis=1)
        # pairwise latent interactions: sum-square trick over k factors
        acc = np.zeros(b, np.float32)
        for j in range(self.k):
            u = _unit_normal(gids.reshape(-1), 10 + j).reshape(b, self.N_CAT)
            s = u.sum(axis=1)
            acc += 0.5 * (s * s - (u * u).sum(axis=1))
        # normalize: ~C(26,2) pairs of unit-variance products
        n_pairs = self.N_CAT * (self.N_CAT - 1) / 2
        z = z + self.w_pair * acc / np.sqrt(n_pairs * self.k)
        dw = _unit_normal(np.arange(self.N_DENSE), 31)
        z = z + self.w_dense * (dense - 0.5) @ (dw / np.sqrt(self.N_DENSE))
        return (z + self.bias).astype(np.float32)

    def sample(self, n: int, step: int = 0):
        """Raw columns: (dense [n,13] int64>=0, cat_local [n,26] i64,
        labels [n] f32, p_true [n] f32)."""
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        raw = rng.zipf(1.15, size=(n, self.N_CAT)).astype(np.int64)
        # per-column shuffle so each column's hot ids differ: hash-permute
        cat_local = np.empty_like(raw)
        for c in range(self.N_CAT):
            cat_local[:, c] = (
                _splitmix(raw[:, c] % self.card[c], 500 + c)
                % np.uint64(self.card[c])
            ).astype(np.int64)
        # integers: skewed counts correlated with a per-row latent
        latent = rng.normal(size=(n, 1)).astype(np.float32)
        dense_f = np.clip(
            latent * 0.35 + rng.normal(size=(n, self.N_DENSE)) * 0.35 + 0.5,
            0, 1,
        )
        dense_int = np.floor(np.expm1(dense_f * 8.0)).astype(np.int64)
        gids = cat_local + self.cat_offsets[None, :]
        z = self._logits(gids, dense_f) + 0.6 * latent[:, 0]
        p = 1.0 / (1.0 + np.exp(-z))
        labels = (rng.uniform(size=n) < p).astype(np.float32)
        return dense_int, cat_local, labels, p

    def batch(self, n: int, step: int = 0) -> dict:
        """Model-ready batch (bypasses the TSV/preprocess round trip)."""
        dense_int, cat_local, labels, _ = self.sample(n, step)
        dense_f = np.log1p(dense_int.astype(np.float64))
        dense_f = (dense_f / max(np.log1p(np.expm1(8.0)), 1e-9)).astype(np.float32)
        ids = np.concatenate(
            [
                np.broadcast_to(
                    np.arange(self.N_DENSE, dtype=np.int64)[None, :],
                    dense_int.shape,
                ),
                cat_local + self.cat_offsets[None, :],
            ],
            axis=1,
        ).astype(np.int32)
        wts = np.concatenate(
            [dense_f, np.ones_like(cat_local, np.float32)], axis=1
        )
        return {"ids": ids, "wts": wts, "label": labels[:, None]}

    def bayes_auc(self, n: int = 200_000, step: int = 10**6) -> float:
        """AUC of the planted model's own p (the learnability ceiling)."""
        from mindrec_tpu_torch.train.metrics import AUCMetric

        _, _, labels, p = self.sample(n, step)
        m = AUCMetric()
        m.update(p[:, None], labels[:, None])
        return m.eval()

    def positive_rate(self, n: int = 100_000) -> float:
        _, _, labels, _ = self.sample(n, step=10**6 + 1)
        return float(labels.mean())


def write_tsv(
    gen: RealisticCriteo,
    out_dir: str | os.PathLike,
    n_rows: int,
    rows_per_file: int = 500_000,
    start_step: int = 0,
) -> list[str]:
    """Emit reference-format raw TSV (label \\t 13 ints \\t 26 hex cats)
    so ``data/preprocess.py`` runs its real 2-pass path on this data."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    left = n_rows
    step = start_step
    fi = 0
    while left > 0:
        take = min(rows_per_file, left)
        dense_int, cat_local, labels, _ = gen.sample(take, step=step)
        p = out / f"day_{fi}.txt"
        with open(p, "w") as f:
            for r in range(take):
                cats = "\t".join(
                    f"{cat_local[r, c] + gen.cat_offsets[c]:x}"
                    for c in range(gen.N_CAT)
                )
                ints = "\t".join(str(v) for v in dense_int[r])
                f.write(f"{int(labels[r])}\t{ints}\t{cats}\n")
        paths.append(str(p))
        left -= take
        step += 1
        fi += 1
    return paths
