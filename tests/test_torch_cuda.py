"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Needs an NVIDIA GPU (sm_90a) and nvcc; skips without a card.
Imports no JAX, so it runs where only the port is installed::

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The edge-case lists of ``segsum_unsorted``, ``segsum_cols``,
``segsum_sorted`` and ``adam_cols`` (and the functions that make their
numpy inputs) live here; ``tests/test_torch_edge_cases.py`` and
``tests/test_torch_segsum_perm.py`` run the same lists on the CPU, plain
version against the JAX kernel or the float64 sum.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mindrec_tpu_torch.ops import kernels
from mindrec_tpu_torch.ops.kernels.fused import (
    fused_adam_gather, fused_adam_gather_plain, fused_ftrl_gather,
    fused_ftrl_gather_plain,
)
from mindrec_tpu_torch.ops.kernels.gather import (
    gather_cols, gather_cols_plain, gather_rows, gather_rows_plain,
)
from mindrec_tpu_torch.ops.kernels.segsum import (
    segsum_cols, segsum_cols_plain, segsum_sorted, segsum_sorted_plain,
    segsum_unsorted, segsum_unsorted_plain,
)
from mindrec_tpu_torch.ops.kernels.update_cols import (
    adam_cols, adam_cols_plain, ftrl_cols, ftrl_cols_plain, make_aug_grads,
)
from mindrec_tpu_torch.ops.kernels.update_rows import (
    adam_rows, adam_rows_plain, ftrl_rows, ftrl_rows_plain,
)
from mindrec_tpu_torch.train.step import CapturedStep, _state_tensors

SENT = 2**31 - 2
N_ROWS = 256


def _t(a):
    return torch.from_numpy(np.array(a))


def _uidx(rng, n, max_run):
    reps = rng.integers(1, max_run + 1, size=n)
    return np.repeat(np.arange(n), reps)[:n].astype(np.int32)


def _slots(rng, pack, n_uq, n_sent):
    uq = np.sort(rng.choice(N_ROWS * pack, size=n_uq, replace=False))
    uq = np.concatenate([uq, np.full(n_sent, SENT)]).astype(np.int32)
    n = uq.size
    present = (rng.uniform(size=n) > 0.2).astype(np.int32)
    return uq // pack, uq % pack, present, n


def _grads(rng, n, dim):
    g = (rng.normal(size=(n, dim)) * 10.0).astype(np.float32)
    g[::5] = 0.0
    return g


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device):
    rng = np.random.default_rng(0)
    uidx = _uidx(rng, 5000, 7)
    uidx[:700] = 0  # one hot id spanning several 256-row chunks
    _, uidx = np.unique(uidx, return_inverse=True)  # unit steps (contract)
    uidx = uidx.astype(np.int32)
    g = _t(rng.normal(size=(5000, 128)).astype(np.float32)).to(cuda_device)
    u = _t(uidx).to(cuda_device)
    for dt in (torch.float32, torch.bfloat16):
        got = segsum_sorted(g.to(dt), u, 4096)
        want = segsum_sorted_plain(g.to(dt), u, 4096)
        # the plain version adds the hot id's 700 rows with atomics in an
        # order that changes from run to run: both sides are held to the
        # float32 tolerance of a float64 sum
        ref, tol = segsum_float64(g.to(dt).float().cpu().numpy(), uidx, 4096)
        for x in (got, want):
            assert (np.abs(x.cpu().numpy() - ref) <= tol).all()
    pack, dim = 8, 16
    rows, sub, present, n = _slots(rng, pack, n_uq=500, n_sent=9)
    gs = _t(_grads(rng, n, dim)).to(cuda_device)
    idx = [_t(x).to(cuda_device) for x in (rows, sub, present)]
    base = [_t(rng.normal(size=(N_ROWS, 128)).astype(np.float32) * s)
            .to(cuda_device) for s in (1e-2, 1e-3, 1e-3)]
    base[2] = base[2].abs()
    lr = torch.tensor(1e-3, device=cuda_device)
    for sd in (torch.float32, torch.bfloat16):
        a = [base[0].clone(), base[1].to(sd), base[2].to(sd)]
        b = [x.clone() for x in a]
        adam_rows(*a, *idx[:2], gs, lr, dim=dim, pack=pack, present=idx[2])
        adam_rows_plain(*b, *idx[:2], gs, lr, dim=dim, pack=pack,
                        present=idx[2])
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
    a = [base[0].clone(), base[2] + 1.0, base[1].clone()]
    b = [x.clone() for x in a]
    ftrl_rows(*a, *idx[:2], gs, dim=dim, pack=pack, present=idx[2])
    ftrl_rows_plain(*b, *idx[:2], gs, dim=dim, pack=pack, present=idx[2])
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)


def _col_slots(rng, fold, vc, n_uq, n_sent):
    ids = np.sort(rng.choice(vc * fold, size=n_uq, replace=False))
    ids = np.concatenate([ids, np.full(n_sent, SENT)]).astype(np.int32)
    return ids // fold, ids % fold


@pytest.mark.cuda
def test_feature_major_kernels_match_plain_on_card(cuda_device):
    """gather_rows, segsum_unsorted, adam_cols and ftrl_cols against their
    plain versions: gather exact; the unsorted sum within float32
    reordering (the plain version adds with atomics); the updates equal
    to rounding (same float32 operations in the same order)."""
    rng = np.random.default_rng(1)
    dev = cuda_device
    kernels.reset_launches()
    # gather: dp 128 at lane 0, a folded dp 8 at lane 128; sentinels
    vc = 4096
    for dp, fold, off in ((128, 1, 0), (8, 8, 128)):
        cols, _ = _col_slots(rng, fold, vc, n_uq=1500, n_sent=548)
        table = _t(rng.normal(size=(dp, vc)).astype(np.float32)).to(dev)
        base = _t(rng.normal(size=(cols.size, 256)).astype(np.float32)).to(dev)
        c = _t(cols).to(dev)
        got = gather_rows(table, c, base.clone(), off)
        want = gather_rows_plain(table, c, base.clone(), off)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # unsorted segment-sum: hot ids, -1 and out-of-range ids
    seg = rng.integers(-1, 2100, size=70_000).astype(np.int32)
    seg[:30_000] = rng.integers(0, 16, size=30_000)
    s = _t(seg).to(dev)
    g = _t(rng.normal(size=(seg.size, 72)).astype(np.float32)).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        got = segsum_unsorted(g.to(dt), s, 2048)
        want = segsum_unsorted_plain(g.to(dt), s, 2048)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
        again = segsum_unsorted(g.to(dt), s, 2048)
        assert torch.equal(got, again)  # deterministic
    ref = torch.bincount(s[(s >= 0) & (s < 2048)].long(), minlength=2048)
    for lanes in (1, 8):  # the step's presence input, and every lane of 8
        ones = torch.ones((seg.size, lanes), dtype=torch.bfloat16, device=dev)
        counts = segsum_unsorted(ones, s, 2048)
        torch.testing.assert_close(counts, ref.float()[None].expand(lanes, -1),
                                   rtol=0, atol=0)
    # column updates, fold 1 (bf16 and f32 moments) and fold 8
    lr = torch.tensor(1e-3, device=dev)
    for fold, dim, dp in ((1, 64, 64), (8, 1, 8)):
        cols, sub = _col_slots(rng, fold, vc, n_uq=2000, n_sent=48)
        gr = (rng.normal(size=(dp, cols.size)) * 10.0).astype(np.float32)
        if fold > 1:
            gr *= np.arange(dp)[:, None] // dim == sub[None, :]
        gr[:, ::5] = 0.0
        aug = make_aug_grads(_t(gr), _t(sub) if fold > 1 else None)
        aug[dp:, 3::7] = 0.0  # zeroed touch rows: no update
        aug, c = aug.contiguous().to(dev), _t(cols).to(dev)
        base = [_t(rng.normal(size=(dp, vc)).astype(np.float32) * sc).to(dev)
                for sc in (1e-2, 1e-3, 1e-3)]
        base[2] = base[2].abs()
        for sd in (torch.float32, torch.bfloat16):
            a = [base[0].clone(), base[1].to(sd), base[2].to(sd)]
            b = [x.clone() for x in a]
            adam_cols(*a, c, aug, lr, dim=dim, fold=fold, eps=1e-6,
                      loss_scale=1000.0)
            adam_cols_plain(*b, c, aug, lr, dim=dim, fold=fold, eps=1e-6,
                            loss_scale=1000.0)
            for x, y in zip(a, b):
                torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
        a = [base[0].clone(), base[2] + 0.1, base[1].clone()]
        b = [x.clone() for x in a]
        kw = dict(dim=dim, fold=fold, l1=5e-4, l2=5e-4, loss_scale=1000.0)
        ftrl_cols(*a, c, aug, **kw)
        ftrl_cols_plain(*b, c, aug, **kw)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
    torch.cuda.synchronize()
    assert all(kernels.LAUNCHES[k] > 0 for k in (
        "gather_rows", "segsum_unsorted", "adam_cols", "ftrl_cols"))


@pytest.mark.cuda
def test_column_path_kernels_match_plain_on_card(cuda_device):
    """gather_cols, segsum_cols and the fused update + gather kernels
    against their plain versions: the gathers exact; the segment-sum
    (given the step's layout, the transposed view of a contiguous [N, D])
    within float32 reordering (sums in tile order in the kernel, atomics
    in the plain version) and deterministic; the fused updates equal to rounding
    (same float32 operations in the same order) with rows that are
    exactly the updated table's columns."""
    rng = np.random.default_rng(2)
    dev = cuda_device
    kernels.reset_launches()
    vc = 4096
    # gather: ragged sizes, duplicates (fold 8), negative and sentinel cols
    for dp, fold, dt in ((80, 1, torch.float32), (8, 8, torch.float32),
                         (13, 1, torch.bfloat16)):
        cols, _ = _col_slots(rng, fold, vc, n_uq=1500, n_sent=549)
        cols[:3] = -1
        table = _t(rng.normal(size=(dp, vc)).astype(np.float32)).to(dev).to(dt)
        c = _t(cols).to(dev)
        torch.testing.assert_close(gather_cols(table, c),
                                   gather_cols_plain(table, c), rtol=0, atol=0)
    # column-major segment-sum: a hot id over many tiles, runs that end
    # at multiples of 256 positions, a ragged last tile, a tail
    uidx = _uidx(rng, 5003, 7)
    uidx[:700] = 0
    uidx[700:1024] = 1   # ends at a chunk edge
    uidx[1024:1280] = 2  # exactly one whole chunk
    uidx[1280:] = np.maximum(uidx[1280:], 3)
    uidx = np.maximum.accumulate(uidx)
    _, uidx = np.unique(uidx, return_inverse=True)  # unit steps
    u = _t(uidx.astype(np.int32)).to(dev)
    # the step's layout: the transposed view of a contiguous [N, 27]
    g = _t(rng.normal(size=(uidx.size, 27)).astype(np.float32)).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        for n_out in (5003, 5632, 1000):
            got = segsum_cols(g.to(dt).T, u, n_out)
            want = segsum_cols_plain(g.to(dt).T, u, n_out)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
            assert torch.equal(got, segsum_cols(g.to(dt).T, u, n_out))
    # fused update + gather: fold 1 and 8, both optimizers, sentinel pads,
    # column ranges with only gradients, only next ids, and neither
    lr = torch.tensor(1e-3, device=dev)
    for fold, dim, dp in ((1, 24, 24), (8, 1, 8)):
        cols_u, sub = _col_slots(rng, fold, vc // 4, n_uq=900, n_sent=100)
        cols_g, _ = _col_slots(rng, fold, vc // 8, n_uq=300, n_sent=77)
        far, _ = _col_slots(rng, fold, vc // 4, n_uq=300, n_sent=0)
        cols_g = np.sort(np.concatenate([cols_g[:300], far + vc // 2]))
        cols_g = np.concatenate([cols_g, np.full(77, SENT // fold)])
        gr = (rng.normal(size=(dp, cols_u.size)) * 10.0).astype(np.float32)
        if fold > 1:
            gr *= np.arange(dp)[:, None] // dim == sub[None, :]
        aug = make_aug_grads(_t(gr), _t(sub) if fold > 1 else None)
        aug[dp:, 3::7] = 0.0  # zeroed touch rows: no update
        aug = aug.contiguous().to(dev)
        cu, cg = _t(cols_u).to(dev), _t(cols_g.astype(np.int32)).to(dev)
        base = [_t(rng.normal(size=(dp, vc)).astype(np.float32) * sc).to(dev)
                for sc in (1e-2, 1e-3, 1e-3)]
        base[2] = base[2].abs()
        for sd in (torch.float32, torch.bfloat16):
            a = [base[0].clone(), base[1].to(sd), base[2].to(sd)]
            b = [x.clone() for x in a]
            kw = dict(dim=dim, fold=fold, eps=1e-6, loss_scale=1000.0)
            ra = fused_adam_gather(*a, cu, aug, lr, cg, **kw)[3]
            rb = fused_adam_gather_plain(*b, cu, aug, lr, cg, **kw)[3]
            for x, y in [*zip(a, b), (ra, rb)]:
                torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
            assert torch.equal(ra, gather_cols_plain(a[0], cg))
        a = [base[0].clone(), base[2] + 0.1, base[1].clone()]
        b = [x.clone() for x in a]
        kw = dict(dim=dim, fold=fold, l1=5e-4, l2=5e-4, loss_scale=1000.0)
        ra = fused_ftrl_gather(*a, cu, aug, cg, **kw)[3]
        rb = fused_ftrl_gather_plain(*b, cu, aug, cg, **kw)[3]
        for x, y in [*zip(a, b), (ra, rb)]:
            torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
        assert torch.equal(ra, gather_cols_plain(a[0], cg))
    torch.cuda.synchronize()
    assert all(kernels.LAUNCHES[k] > 0 for k in (
        "gather_cols", "segsum_cols", "fused_adam_gather",
        "fused_ftrl_gather"))


# ---------------------------------------------------------------------------
# shared edge cases: segsum_unsorted, segsum_cols and adam_cols
# ---------------------------------------------------------------------------

# (case id, N, D, n_out, id pattern)
SEGSUM_UNSORTED_CASES = [
    ("counts-d1-hot16", 9001, 1, 16, "hot"),
    ("d5-spread-2048", 4999, 5, 2048, "outside"),
    ("d128-hot16", 9001, 128, 16, "hot"),
    ("d128-spread-2048", 5003, 128, 2048, "outside"),
    ("d5-one-id", 4999, 5, 16, "one"),
    ("d128-one-id-2048", 9001, 128, 2048, "one"),
    ("d5-outside-16", 4999, 5, 16, "outside"),
]
SEGSUM_IDS = [c[0] for c in SEGSUM_UNSORTED_CASES]


def segsum_unsorted_case(n, d, n_out, pattern):
    """(g [N, D] float32 of bf16-exact values, seg [N] int32).  N is a
    multiple of no chunk size; ``hot``: every id of the range, unequal
    counts; ``one``: every position on one id; ``outside``: ids from
    below 0 to past ``n_out`` mixed in."""
    rng = np.random.default_rng(n * 131 + d * 7 + n_out)
    if pattern == "one":
        seg = np.full(n, n_out - 3)
    elif pattern == "hot":
        seg = np.minimum(rng.geometric(0.25, size=n) - 1, n_out - 1)
    else:
        seg = rng.integers(-n_out // 8 - 2, n_out + n_out // 8 + 2, size=n)
    g = rng.normal(size=(n, d)).astype(np.float32)
    g = _t(g).to(torch.bfloat16).float().numpy()  # exact in both types
    return g, seg.astype(np.int32)


def segsum_float64(g, seg, n_out):
    """(float64 sum [D, n_out], tolerance of a float32 sum in any order:
    8 * 2**-24 * sqrt(n_s) * sqrt(sum g**2) per cell)."""
    keep = (seg >= 0) & (seg < n_out)
    ref = np.zeros((n_out, g.shape[1]))
    sq = np.zeros_like(ref)
    np.add.at(ref, seg[keep], g[keep].astype(np.float64))
    np.add.at(sq, seg[keep], g[keep].astype(np.float64) ** 2)
    cnt = np.bincount(seg[keep], minlength=n_out)[:n_out]
    return ref.T, (8.0 * 2.0**-24 * np.sqrt(cnt)[:, None] * np.sqrt(sq)).T


# (case id, N, D, n_out, run pattern); N is a multiple of no tile size
SEGSUM_COLS_CASES = [
    ("d1-hot", 9001, 1, 9001, "hot"),  # one id over several tiles
    ("d5-distinct", 4999, 5, 4999, "distinct"),
    ("d24-edges", 6001, 24, 6144, "edges"),  # runs that end at tile edges
    ("d88-mixed", 5003, 88, 5003, "mixed"),
    ("d88-past-n-out", 5003, 88, 700, "mixed"),  # segments past n_out
    ("d24-hot-tail", 3001, 24, 4096, "hot"),  # an empty tail
]
SEGSUM_COLS_IDS = [c[0] for c in SEGSUM_COLS_CASES]


def segsum_cols_case(n, d, pattern):
    """(g [N, D] float32, uidx_sorted [N] int32, non-decreasing with unit
    steps).  The values are multiples of 1/8 below 64 in magnitude: exact
    in bf16, and every float32 partial sum of them is exact, so any order
    of summation gives the float64 sum.  Runs: ``distinct`` one position
    each; ``hot`` 45% of the positions on the first id, then 1-9 each;
    ``mixed`` 1-9 each with a run of 1500 a third of the way in; ``edges``
    32 positions each over the first half, then multiples of 32 up to 160,
    so every run ends on a multiple of 32 (a tile size is one)."""
    rng = np.random.default_rng(n * 7 + d)
    if pattern == "distinct":
        runs = np.ones(n, np.int64)
    elif pattern == "edges":
        runs = np.concatenate([np.full(n // 64, 32),
                               32 * rng.integers(1, 6, size=n // 32)])
    else:
        runs = rng.integers(1, 10, size=n)
        if pattern == "hot":
            runs[0] = int(0.45 * n)
        else:
            runs = np.concatenate([runs[:n // 15], [1500], runs[n // 15:]])
    uidx = np.repeat(np.arange(runs.size), runs)[:n].astype(np.int32)
    g = np.clip(np.round(rng.normal(size=(n, d)) * 8.0), -511, 511) / 8.0
    return g.astype(np.float32), uidx


# (case id, N, D, n_out, run pattern, id shift, perm kind); the patterns
# are segsum_cols_case's, N a multiple of no chunk size
SEGSUM_SORTED_CASES = [
    ("empty", 0, 128, 1000, "distinct", 0, "identity"),
    ("d1-hot-105-chunks", 60001, 1, 60001, "hot", 0, "random"),
    ("d13-distinct-reversed", 5003, 13, 5003, "distinct", 0, "reversed"),
    ("d256-mixed-compacted", 9001, 256, 9001, "mixed", 0, "compacted"),
    ("d128-outside-random", 5003, 128, 700, "mixed", -5, "random"),
    ("d128-edges-identity", 6001, 128, 6144, "edges", 0, "identity"),
    ("d256-distinct-random", 4999, 256, 5120, "distinct", 0, "random"),
    ("d17-gaps-random", 5003, 17, 20000, "gaps", 0, "random"),
    ("d128-gaps-outside-identity", 5003, 128, 2000, "gaps", -7, "identity"),
]
SEGSUM_SORTED_IDS = [c[0] for c in SEGSUM_SORTED_CASES]


def segsum_sorted_case(n, d, pattern, shift, kind):
    """(g [R, D] float32 in batch order, uidx_sorted [N] int32, perm [N])
    with ``g[perm]`` the sorted rows of :func:`segsum_cols_case` (whose
    float32 sums are exact; pattern ``gaps``: its ``mixed`` runs, the ids
    stepping by 1-4 and now and then by 50, as a mesh's data rank sums
    its positions in the global unique order: ``gaps=True``) and ids
    shifted by ``shift`` (below 0 when negative).  ``perm``: ``identity`` (int64), ``reversed`` and
    ``random`` (int32), ``compacted`` (int64: N of R = N + N // 3 + 1
    rows, in random order, the other rows never read)."""
    g_sorted, uidx = segsum_cols_case(n, d, "mixed" if pattern == "gaps"
                                      else pattern)
    rng = np.random.default_rng(n * 11 + d)
    if pattern == "gaps":
        steps = rng.integers(1, 5, size=int(uidx[-1]) + 1)
        steps[rng.random(steps.size) < 0.02] = 50
        uidx = (np.cumsum(steps) - steps[0])[uidx]
    rows = n + n // 3 + 1 if kind == "compacted" else n
    if kind == "identity":
        perm = np.arange(n, dtype=np.int64)
    elif kind == "reversed":
        perm = np.arange(n - 1, -1, -1, dtype=np.int32)
    elif kind == "random":
        perm = rng.permutation(n).astype(np.int32)
    else:
        perm = rng.permutation(rows)[:n].astype(np.int64)
    g = (np.clip(np.round(rng.normal(size=(rows, d)) * 8.0), -511, 511)
         / 8.0).astype(np.float32)
    g[perm] = g_sorted
    return g, (uidx + shift).astype(np.int32), perm


ADAM_COLS_VC = 1024
ADAM_COLS_CASES = ["long-run", "run-across-255-256", "all-sentinel",
                   "sentinels-from-mid-block", "n-below-32"]


def adam_cols_case(kind, fold):
    """Numpy inputs of one column update on a [dp, 1024] table: sorted
    sentinel-padded ``cols``, touch-augmented ``aug`` [dp + 8, n] of
    bf16-exact values (every fifth slot a zero gradient, every seventh
    slot's touch rows zeroed),
    ``table``, ``m``, ``v`` float32, and ``dim``."""
    rng = np.random.default_rng(len(kind) * 10 + fold)
    dim, dp = (1, 8) if fold > 1 else (16, 16)
    space = ADAM_COLS_VC * fold

    def distinct(lo, hi, k):
        return np.sort(rng.choice(np.arange(lo, hi), size=k, replace=False))

    def run(col, k):  # k slots of one storage column
        return col * fold + np.arange(k) % fold

    if kind == "long-run":  # 300 slots of one column, longer than a block
        ids = np.sort(np.concatenate([distinct(0, space, 150), run(500, 300)]))
        n_sent = 30
    elif kind == "run-across-255-256":  # slots 250..260 share a column
        ids = np.concatenate([distinct(0, 600 * fold, 250), run(600, 11),
                              distinct(601 * fold, space, 100)])
        n_sent = 23
    elif kind == "all-sentinel":
        ids, n_sent = np.zeros(0, np.int64), 300
    elif kind == "sentinels-from-mid-block":  # live 0..399, pads 400..699
        ids, n_sent = distinct(0, space, 400), 300
    else:  # n-below-32
        ids, n_sent = distinct(0, space, 17), 3
    ids = np.concatenate([ids, np.full(n_sent, SENT)]).astype(np.int32)
    cols, sub = ids // fold, ids % fold
    n = cols.size
    g = (rng.normal(size=(dp, n)) * 10.0).astype(np.float32)
    # bf16-exact gradients: the reference places them with a one-hot dot,
    # which XLA's CPU backend may run at reduced internal precision (down
    # to bf16 products on some hosts, under load); 0/1 times such a value
    # is exact at any precision
    g = _t(g).to(torch.bfloat16).float().numpy()
    if fold > 1:
        g *= np.arange(dp)[:, None] // dim == sub[None, :]
    g[:, ::5] = 0.0
    aug = make_aug_grads(_t(g), _t(sub) if fold > 1 else None).numpy().copy()
    aug[dp:, 3::7] = 0.0
    shape = (dp, ADAM_COLS_VC)
    return dict(
        cols=cols, aug=aug, dim=dim,
        table=(rng.normal(size=shape) * 0.01).astype(np.float32),
        m=(rng.normal(size=shape) * 1e-3).astype(np.float32),
        v=np.abs(rng.normal(size=shape) * 1e-6).astype(np.float32),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SEGSUM_UNSORTED_CASES, ids=SEGSUM_IDS)
def test_segsum_unsorted_edge_cases_on_card(cuda_device, case, dtype):
    """Kernel and plain version within the float32 tolerance of a float64
    sum; the kernel deterministic, and exact on small integers."""
    _id, n, d, n_out, pattern = case
    g, seg = segsum_unsorted_case(n, d, n_out, pattern)
    ref, tol = segsum_float64(g, seg, n_out)
    gt = _t(g).to(getattr(torch, dtype)).to(cuda_device)
    st = _t(seg).to(cuda_device)
    got = segsum_unsorted(gt, st, n_out)
    assert got.shape == (d, n_out) and got.dtype == torch.float32
    assert torch.equal(got, segsum_unsorted(gt, st, n_out))
    for x in (got, segsum_unsorted_plain(gt, st, n_out)):
        assert (np.abs(x.cpu().numpy() - ref) <= tol).all()
    gi = np.round(g * 3.0)  # |values| < 20: every float32 partial is exact
    exact, _ = segsum_float64(gi, seg, n_out)
    got = segsum_unsorted(_t(gi).to(getattr(torch, dtype)).to(cuda_device), st,
                          n_out)
    np.testing.assert_array_equal(got.cpu().numpy(), exact)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SEGSUM_COLS_CASES, ids=SEGSUM_COLS_IDS)
def test_segsum_cols_edge_cases_on_card(cuda_device, case, dtype):
    """``g`` as the transposed view of a contiguous [N, D] (the step's
    layout).  On the case's values, whose float32 sums are exact, kernel
    and plain version equal the float64 sum; on normal values both are
    within the float32 tolerance of the float64 sum, the kernel is
    deterministic and its columns past the last segment are zero."""
    _id, n, d, n_out, pattern = case
    g, uidx = segsum_cols_case(n, d, pattern)
    dt = getattr(torch, dtype)
    u = _t(uidx).to(cuda_device)
    exact, _ = segsum_float64(g, uidx, n_out)
    rows = _t(g).to(dt).to(cuda_device)
    got = segsum_cols(rows.T, u, n_out)
    assert got.shape == (d, n_out) and got.dtype == torch.float32
    for x in (got, segsum_cols_plain(rows.T, u, n_out)):
        np.testing.assert_array_equal(x.cpu().numpy(), exact)
    rng = np.random.default_rng(n + d)
    rows = _t(rng.normal(size=(n, d)).astype(np.float32)).to(dt)
    ref, tol = segsum_float64(rows.float().numpy(), uidx, n_out)
    rows = rows.to(cuda_device)
    got = segsum_cols(rows.T, u, n_out)
    assert torch.equal(got, segsum_cols(rows.T, u, n_out))
    for x in (got, segsum_cols_plain(rows.T, u, n_out)):
        assert (np.abs(x.cpu().numpy() - ref) <= tol).all()
    assert not got[:, int(uidx[-1]) + 1:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fold", [1, 8])
@pytest.mark.parametrize("kind", ADAM_COLS_CASES)
def test_adam_cols_edge_cases_on_card(cuda_device, kind, fold, state_dtype):
    """Kernel against plain version: the same float32 operations in the
    same order, so equal to rounding (rtol 1e-6)."""
    c = adam_cols_case(kind, fold)
    sd = getattr(torch, state_dtype)
    dev = cuda_device
    a = [_t(c["table"]).to(dev), _t(c["m"]).to(sd).to(dev),
         _t(c["v"]).to(sd).to(dev)]
    b = [x.clone() for x in a]
    cols, aug = _t(c["cols"]).to(dev), _t(c["aug"]).to(dev)
    lr = torch.tensor(1e-3, device=dev)
    kw = dict(dim=c["dim"], fold=fold, eps=1e-6, loss_scale=1000.0)
    adam_cols(*a, cols, aug, lr, **kw)
    adam_cols_plain(*b, cols, aug, lr, **kw)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
    if state_dtype == "float32":  # FTRL shares the thread layout
        a = [_t(c["table"]).to(dev), _t(c["v"] + 0.1).to(dev),
             _t(c["m"]).to(dev)]
        b = [x.clone() for x in a]
        kw = dict(dim=c["dim"], fold=fold, l1=5e-4, l2=5e-4, loss_scale=1000.0)
        ftrl_cols(*a, cols, aug, **kw)
        ftrl_cols_plain(*b, cols, aug, **kw)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SEGSUM_SORTED_CASES, ids=SEGSUM_SORTED_IDS)
def test_segsum_sorted_edge_cases_on_card(cuda_device, case, dtype):
    """``g`` in batch order, read through ``perm`` as the step passes it.
    On the case's values, whose float32 sums are exact, kernel and plain
    version equal the float64 sum; on normal values both are within the
    float32 tolerance of the float64 sum, the kernel is deterministic and
    its columns past the last segment are zero."""
    _id, n, d, n_out, pattern, shift, kind = case
    g, uidx, perm = segsum_sorted_case(n, d, pattern, shift, kind)
    dt = getattr(torch, dtype)
    u, p = _t(uidx).to(cuda_device), _t(perm).to(cuda_device)
    exact, _ = segsum_float64(g[perm], uidx, n_out)
    rows = _t(g).to(dt).to(cuda_device)
    gaps = pattern == "gaps"
    got = segsum_sorted(rows, u, n_out, perm=p, gaps=gaps)
    assert got.shape == (d, n_out) and got.dtype == torch.float32
    for x in (got, segsum_sorted_plain(rows, u, n_out, p)):
        np.testing.assert_array_equal(x.cpu().numpy(), exact)
    rng = np.random.default_rng(n + d)
    rows = _t(rng.normal(size=g.shape).astype(np.float32)).to(dt)
    ref, tol = segsum_float64(rows.float().numpy()[perm], uidx, n_out)
    rows = rows.to(cuda_device)
    got = segsum_sorted(rows, u, n_out, perm=p, gaps=gaps)
    assert torch.equal(got, segsum_sorted(rows, u, n_out, perm=p, gaps=gaps))
    for x in (got, segsum_sorted_plain(rows, u, n_out, p)):
        assert (np.abs(x.cpu().numpy() - ref) <= tol).all()
    if n:
        assert not got[:, max(int(uidx[-1]) + 1, 0):].any()


# ---------------------------------------------------------------------------
# shared edge cases: gather_rows and ftrl_cols
# ---------------------------------------------------------------------------

# (case id, dp, fold, lane offset, buffer width, N, column pattern); the
# narrow path takes dp <= 8, the wide one the rest; N is a multiple of
# no block size
GATHER_ROWS_CASES = [
    ("d1-fold8-off3", 1, 8, 3, 16, 1001, "tail"),
    ("d3-width130-off5", 3, 1, 5, 130, 777, "tail"),
    ("d8-fold8-off128", 8, 8, 128, 256, 2000, "tail"),
    ("d8-fold8-off130", 8, 8, 130, 256, 1537, "tail"),  # unaligned lanes
    ("d8-tiny-arange", 8, 8, 64, 128, 2048, "tiny"),
    ("d13-off0", 13, 1, 0, 128, 1003, "tail"),
    ("d64-all-sentinel", 64, 1, 0, 128, 700, "all-sentinel"),
    ("d64-off64", 64, 1, 64, 128, 3001, "tail"),
    ("d80-off8", 80, 1, 8, 128, 2049, "tail"),
    ("d128-off2", 128, 1, 2, 256, 999, "tail"),  # unaligned lanes
    ("d128-off0", 128, 1, 0, 256, 4097, "tail"),
    ("d256-dense", 256, 1, 0, 256, 1500, "dense"),
]
GATHER_ROWS_IDS = [c[0] for c in GATHER_ROWS_CASES]


def gather_rows_case(dp, fold, width, n, pattern):
    """(table [dp, vc] float32 of bf16-exact values, cols [N] int32
    sorted, buffer [N, width] float32).  vc is a multiple of 128.
    ``tail``: two columns below 0, then the columns of distinct sorted ids
    (// fold: folded tables repeat columns), then a sentinel tail;
    ``tiny``: the tiny group's arange(N) // fold over a table of N // 16
    columns, so the upper half of the columns lies past it; ``dense``:
    sorted columns drawn with repeats, no sentinel; ``all-sentinel``."""
    rng = np.random.default_rng(dp * 1000 + n + fold)
    vc = -(-max(2 * n // fold, 256) // 128) * 128
    if pattern == "tiny":
        vc = n // fold // 2
        cols = np.arange(n) // fold
    elif pattern == "dense":
        cols = np.sort(rng.integers(0, vc, size=n))
    elif pattern == "all-sentinel":
        cols = np.full(n, SENT // fold)
    else:
        live = int(0.75 * n)
        ids = np.sort(rng.choice(vc * fold, size=live, replace=False))
        cols = np.concatenate([[-1, -1], ids[: live - 2] // fold,
                               np.full(n - live, SENT // fold)])
    table = _t(rng.normal(size=(dp, vc)).astype(np.float32))
    table = table.to(torch.bfloat16).float().numpy()
    buf = rng.normal(size=(n, width)).astype(np.float32)
    return table, cols.astype(np.int32), buf


# (case id, fold, dp, N, kind); N is a multiple of no block size
FTRL_COLS_CASES = [
    ("fold8-step", 8, 8, 3001, "step"),
    ("fold8-runs-at-edges", 8, 8, 1030, "edges"),
    ("fold8-long-runs", 8, 8, 700, "long"),
    ("fold8-run-to-end", 8, 8, 1001, "end-run"),
    ("fold8-all-sentinel", 8, 8, 300, "all-sentinel"),
    ("fold8-tiny-gate", 8, 8, 2048, "gate"),
    ("fold8-non-owner-grads", 8, 8, 1500, "non-owner"),
    ("fold1-d13", 1, 13, 777, "step"),
]
FTRL_COLS_IDS = [c[0] for c in FTRL_COLS_CASES]
FTRL_COLS_VC = 4096
# runs (first slot, length) joined by each kind: across a warp's edge
# (slot 32), a block's (256) and a run longer than a warp and a block
_FTRL_JOINS = {
    "edges": [(28, 8), (60, 5), (252, 8), (510, 5), (766, 4)],
    "long": [(17, 40), (96, 33), (200, 300)],
    "end-run": [(990, 11)],
}


def ftrl_cols_case(kind, fold, dp, n):
    """Numpy inputs of one column FTRL update on a [dp, 4096] table:
    sorted ``cols`` (runs of equal columns; ``step`` and ``non-owner``
    runs of 1-8 slots, 80% live, then a sentinel tail; ``edges``,
    ``long`` and ``end-run`` distinct columns joined into the runs of
    ``_FTRL_JOINS``, the last ending at slot N - 1 with no tail; ``gate``
    the tiny group's arange(N) // fold, with the touch rows of every
    third column's slots zeroed, as a presence gate does; ``all-sentinel``),
    ``aug`` [dp + 8, N] (gradients multiples of 1/8 below 32 in magnitude,
    so every float32 sum of them is exact in any order; at fold > 1
    masked to the slot's sublane except for ``non-owner``; every seventh
    slot's touch rows zeroed), ``table``, ``accum``, ``linear`` float32
    and ``dim``."""
    rng = np.random.default_rng(len(kind) * 100 + fold * 10 + dp)
    if kind == "all-sentinel":
        cols = np.full(n, SENT // fold)
    elif kind == "gate":
        cols = np.arange(n) // fold
    elif kind in _FTRL_JOINS:
        start = np.ones(n, bool)
        for first, length in _FTRL_JOINS[kind]:
            start[first + 1: first + length] = False
        col_of = np.sort(rng.choice(FTRL_COLS_VC, size=int(start.sum()),
                                    replace=False))
        cols = col_of[np.cumsum(start) - 1]
        if kind != "end-run":
            cols[int(0.9 * n):] = SENT // fold
    else:
        live = int(0.8 * n)
        runs = rng.integers(1, 9, size=live)
        col_of = np.sort(rng.choice(FTRL_COLS_VC, size=live, replace=False))
        cols = np.concatenate([np.repeat(col_of, runs)[:live],
                               np.full(n - live, SENT // fold)])
    # a slot's sublane: its place in its run, as distinct ids of a column
    first = np.r_[0, np.flatnonzero(np.diff(cols)) + 1]
    sub = (np.arange(n) - np.repeat(first, np.diff(np.r_[first, n]))) % fold
    g = np.clip(np.round(rng.normal(size=(dp, n)) * 40.0), -255, 255) / 8.0
    if fold > 1 and kind != "non-owner":
        g *= np.arange(dp)[:, None] == sub[None, :]
    g = g.astype(np.float32)
    g[:, ::5] = 0.0
    aug = make_aug_grads(_t(g), _t(sub) if fold > 1 else None).numpy().copy()
    aug[dp:, 3::7] = 0.0
    if kind == "gate":
        aug[dp:, (cols % 3) == 1] = 0.0
    shape = (dp, FTRL_COLS_VC)
    return dict(
        cols=cols.astype(np.int32), aug=aug, dim=1 if fold > 1 else dp,
        table=(rng.normal(size=shape) * 0.01).astype(np.float32),
        accum=(0.1 + rng.uniform(size=shape)).astype(np.float32),
        linear=(rng.normal(size=shape) * 0.1).astype(np.float32),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GATHER_ROWS_CASES, ids=GATHER_ROWS_IDS)
def test_gather_rows_edge_cases_on_card(cuda_device, case, dtype):
    """Kernel equal to its plain version: an exact copy of the live
    columns into their lanes, every other element of the buffer kept."""
    _id, dp, fold, off, width, n, pattern = case
    table, cols, buf = gather_rows_case(dp, fold, width, n, pattern)
    tt = _t(table).to(getattr(torch, dtype)).to(cuda_device)
    c = _t(cols).to(cuda_device)
    got = gather_rows(tt, c, _t(buf).to(cuda_device), off)
    want = gather_rows_plain(tt, c, _t(buf).to(cuda_device), off)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FTRL_COLS_CASES, ids=FTRL_COLS_IDS)
def test_ftrl_cols_edge_cases_on_card(cuda_device, case, dtype):
    """Kernel against plain version: the same float32 operations in the
    same order, run sums in slot order, so equal to rounding (rtol 1e-6,
    the tolerance of the other update kernels); untouched elements keep
    their values."""
    _id, fold, dp, n, kind = case
    c = ftrl_cols_case(kind, fold, dp, n)
    dev = cuda_device
    a = [_t(c["table"]).to(getattr(torch, dtype)).to(dev),
         _t(c["accum"]).to(dev), _t(c["linear"]).to(dev)]
    b = [x.clone() for x in a]
    before = [x.clone() for x in a]
    cols, aug = _t(c["cols"]).to(dev), _t(c["aug"]).to(dev)
    kw = dict(dim=c["dim"], fold=fold, l1=5e-4, l2=5e-4, loss_scale=1000.0)
    ftrl_cols(*a, cols, aug, **kw)
    ftrl_cols_plain(*b, cols, aug, **kw)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
    changed = any(not torch.equal(x, y) for x, y in zip(a, before))
    assert changed == (kind != "all-sentinel")


# ---------------------------------------------------------------------------
# shared edge cases: the fused update + gather
# ---------------------------------------------------------------------------

FUSED_KINDS = ["all-shared", "none-shared", "repeated-next", "sparse-sublanes",
               "zero-touch-shared", "run-of-8", "update-all-sentinel",
               "next-all-sentinel", "next-outside"]
# (case id, kind, fold): every kind at fold 1 and fold 8
FUSED_EDGE_CASES = [(f"{k}-fold{f}", k, f) for k in FUSED_KINDS for f in (1, 8)]
FUSED_EDGE_IDS = [c[0] for c in FUSED_EDGE_CASES]
FUSED_VC = 512


def fused_edge_case(kind, fold):
    """Numpy inputs of one fused update + gather on a [dp, 512] table (dp
    16 at fold 1, 8 at fold 8, emb_dim 1): the update's sorted ``cols``
    (ids // fold, 37 sentinel pads), ``aug`` [dp + 8, n] (gradients
    multiples of 1/8 below 32 in magnitude, so every float32 sum of them
    is exact in any order; at fold 8 masked to the slot's sublane; every
    fifth slot's gradient zero, every seventh slot's touch rows zeroed),
    the sorted next columns ``nxt`` (29 sentinel pads), ``table``, ``m``,
    ``v`` float32 and ``dim``.  Kinds: every next column an update column
    (``all-shared``); none (``none-shared``); next columns repeated on
    update columns (fold 8: all 8 ids of a column; fold 1: each column
    three times); one id per update column and all ``fold`` ids of half
    of them next (``sparse-sublanes``: at fold 8, 7 untouched sublanes
    of each shared column); the touch rows of half the shared columns'
    slots zeroed (``zero-touch-shared``); runs of 8 equal update columns,
    shared (``run-of-8``: a tiny group's ids at fold 8, duplicate ids at
    fold 1); an all-sentinel update list with live next ids, and the
    reverse; next ids below 0 and at or past vc (``next-outside``)."""
    rng = np.random.default_rng(sum(map(ord, kind)) * 10 + fold)
    dp, dim = (16, 16) if fold == 1 else (8, 1)
    space = FUSED_VC * fold

    def ids_of(cols_):  # every id of the given columns
        return (np.asarray(cols_)[:, None] * fold + np.arange(fold)).ravel()

    ids_u = np.sort(rng.choice(space, size=150, replace=False))
    if kind == "sparse-sublanes":
        col_u = np.sort(rng.choice(FUSED_VC, size=100, replace=False))
        ids_u = col_u * fold + rng.integers(0, fold, size=100)
        ids_g = ids_of(col_u[::2])
    elif kind == "run-of-8":
        runs = rng.choice(np.setdiff1d(np.arange(FUSED_VC), ids_u // fold), 3,
                          replace=False)
        run_ids = ids_of(runs) if fold > 1 else np.repeat(runs, 8)
        ids_u = np.sort(np.concatenate([ids_u, run_ids]))
        ids_g = np.concatenate([ids_of(runs), ids_u[::3]])
    else:
        ids_g = ids_u[::2]
    if kind == "none-shared":
        free = np.setdiff1d(np.arange(FUSED_VC), ids_u // fold)
        ids_g = ids_of(rng.choice(free, size=60, replace=False))
    elif kind == "repeated-next":
        rep = np.unique(ids_u // fold)[::4]
        ids_g = ids_of(rep) if fold > 1 else np.repeat(rep, 3)
        ids_g = np.concatenate([ids_g, ids_u[1::5]])
    elif kind == "all-shared":
        ids_g = ids_u
    if kind == "update-all-sentinel":
        ids_u = np.zeros(0, np.int64)
    if kind == "next-all-sentinel":
        ids_g = np.zeros(0, np.int64)
    ids = np.concatenate([ids_u, np.full(37, SENT)])
    cols, sub = ids // fold, ids % fold
    outside = [-7, -1, FUSED_VC, FUSED_VC + 1, FUSED_VC + 9]
    nxt = np.sort(np.concatenate([ids_g // fold, outside if kind ==
                                  "next-outside" else []])).astype(np.int64)
    nxt = np.concatenate([nxt, np.full(29, SENT // fold)]).astype(np.int32)
    n = cols.size
    g = np.clip(np.round(rng.normal(size=(dp, n)) * 40.0), -255, 255) / 8.0
    if fold > 1:
        g *= np.arange(dp)[:, None] == sub[None, :]
    g = g.astype(np.float32)
    g[:, ::5] = 0.0
    aug = make_aug_grads(_t(g), _t(sub) if fold > 1 else None).numpy().copy()
    aug[dp:, 3::7] = 0.0
    if kind == "zero-touch-shared":
        gone = np.isin(cols, np.unique(nxt)[::2])
        aug[dp:, gone] = 0.0
    shape = (dp, FUSED_VC)
    return dict(
        cols=cols.astype(np.int32), aug=aug, nxt=nxt, dim=dim,
        table=(rng.normal(size=shape) * 0.01).astype(np.float32),
        m=(rng.normal(size=shape) * 1e-3).astype(np.float32),
        v=np.abs(rng.normal(size=shape) * 1e-6).astype(np.float32),
    )


def fused_edge_state(c, opt, table_dtype, device="cpu"):
    """(state tensors, hyper-parameters, lr_t or None) of a fused edge
    case: LazyAdam with float32 m, v; FTRL with accum v + 0.1, linear m."""
    table = _t(c["table"]).to(getattr(torch, table_dtype)).to(device)
    if opt == "adam":
        return ([table, _t(c["m"]).to(device), _t(c["v"]).to(device)],
                dict(dim=c["dim"], eps=1e-6, loss_scale=1000.0),
                torch.tensor(1e-3, device=device))
    return ([table, _t(c["v"] + 0.1).to(device), _t(c["m"]).to(device)],
            dict(dim=c["dim"], learning_rate=5e-2, l1=5e-4, l2=5e-4,
                 loss_scale=1000.0), None)


def fused_call(opt, lr_t, plain=False):
    """f(state, cols, aug, nxt, **hyper) -> (table, s1, s2, rows)."""
    if opt == "adam":
        fn = fused_adam_gather_plain if plain else fused_adam_gather
        return lambda st, c, a, nx, **h: fn(*st, c, a, lr_t, nx, **h)
    fn = fused_ftrl_gather_plain if plain else fused_ftrl_gather
    return lambda st, c, a, nx, **h: fn(*st, c, a, nx, **h)


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["adam", "ftrl"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FUSED_EDGE_CASES, ids=FUSED_EDGE_IDS)
def test_fused_edge_cases_on_card(cuda_device, case, dtype, opt):
    """Kernel against plain version: the state equal to rounding (rtol
    1e-6, the same float32 operations in the same order); the rows
    exactly the updated table's columns (zeros outside the table); the
    state unchanged when the update list is all sentinels."""
    _id, kind, fold = case
    c = fused_edge_case(kind, fold)
    dev = cuda_device
    a, hyper, lr_t = fused_edge_state(c, opt, dtype, dev)
    b = [x.clone() for x in a]
    before = [x.clone() for x in a]
    cols, aug, nxt = (_t(c[k]).to(dev) for k in ("cols", "aug", "nxt"))
    rows = fused_call(opt, lr_t)(a, cols, aug, nxt, fold=fold, **hyper)[3]
    want = fused_call(opt, lr_t, plain=True)(b, cols, aug, nxt, fold=fold,
                                             **hyper)[3]
    for x, y in [*zip(a, b), (rows, want)]:
        torch.testing.assert_close(x.float(), y.float(), rtol=1e-6, atol=1e-9)
    assert torch.equal(rows, gather_cols(a[0], nxt))
    changed = any(not torch.equal(x, y) for x, y in zip(a, before))
    assert changed == (kind != "update-all-sentinel")


# ---------------------------------------------------------------------------
# the captured step, the prefetch stream and the guard on the card
# ---------------------------------------------------------------------------


def _small_recipe(kind, dev):
    """(model, optimizers, host-prepared device batches) of a small W&D
    (row_packed, one group; batches 3-5 in a larger bucket: a regrow) or
    multitable model (two tiny and two sorted groups, feature-major)."""
    from mindrec_tpu_torch.data.criteo import SyntheticCriteo, to_device
    from mindrec_tpu_torch.data.outbrain import SyntheticOutbrain
    from mindrec_tpu_torch.models import multitable, wide_deep
    from mindrec_tpu_torch.train import optim
    from mindrec_tpu_torch.train.step import make_batch_sort, prep_groups

    if kind == "wd":
        cfg = wide_deep.WideDeepConfig(
            batch_size=512, field_size=39, vocab_size=100_000, emb_dim=16,
            deep_layer_dim=(256, 256), use_mixed_precision=True, sparse=True,
            loss_scale=1024.0)
        opts = (optim.ftrl(loss_scale=1024.0),
                optim.lazy_adam(loss_scale=1024.0, state_dtype=torch.bfloat16))
        data = SyntheticCriteo(512, 39, 100_000, seed=5, fields="criteo")
        prep = make_batch_sort(39, minimal=True)
        batches = []
        for i in range(6):
            hb = prep(data.get_batch(i))
            hb["uq_ids"] = hb["uq_ids"][: 6144 if i < 3 else 8192]
            batches.append(to_device(hb, dev))
        return wide_deep.WideDeepModel(cfg), opts, batches
    cfg = multitable.MultiTableConfig(
        batch_size=1024, continue_field_size=4, indicator_field_size=2,
        emb128_field_size=1, emb64_single_field_size=2,
        multi_hot_sizes=(3, 4, 3, 2, 2, 3), emb_128_size=3000,
        emb64_single_size=50, emb64_multi_size=2500, indicator_size=16,
        deep_layer_dim=(256, 256), sparse=True)
    model = multitable.MultiTableWideDeepModel(cfg)
    opts = (optim.ftrl(l1=5e-4, l2=5e-4, initial_accum=0.1, loss_scale=1000.0),
            optim.lazy_adam(learning_rate=1e-3, eps=1e-6, loss_scale=1000.0))
    prep = make_batch_sort(0, groups=prep_groups(model), minimal=True)
    batches = [to_device(prep(b), dev)
               for b in SyntheticOutbrain(cfg, 5, seed=11)]
    return model, opts, batches


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["wd", "multitable"])
def test_captured_step_equals_eager_on_card(cuda_device, kind):
    """The step captured in a CUDA graph gives the eager step's losses and
    state bit for bit, through a regrow (a new signature: one more
    capture); the state object stays the caller's, updated in place."""
    from mindrec_tpu_torch.train.step import init_train_state, make_train_step

    model, opts, batches = _small_recipe(kind, cuda_device)
    se = init_train_state(model, 3, *opts, device=cuda_device)
    sc = init_train_state(model, 3, *opts, device=cuda_device)
    eager = make_train_step(model, *opts)
    cap = make_train_step(model, *opts, jit=True)
    for b in batches:
        se, le = eager(se, b)
        out, lc = cap(sc, b)
        assert out is sc
        for x, y in zip(le, lc):
            assert torch.equal(x, y)
    torch.cuda.synchronize()
    for x, y in zip(_state_tensors(se), _state_tensors(sc)):
        assert torch.equal(x, y)
    assert cap.captures == (2 if kind == "wd" else 1)
    assert cap.replays == len(batches) - cap.captures
    assert cap.replayed and all(n > 0 for n in cap.replayed.values())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["wd", "multitable", "plain", "no-donate"])
def test_generic_captured_step_equals_eager_on_card(cuda_device, kind):
    """The generic path (``use_pallas=False``) captured in a CUDA graph
    gives the eager step's losses and state bit for bit: row_packed W&D
    (through a regrow of the prep keys it ignores: a new signature), the
    multitable model's feature-major groups, plain row-major specs
    (``dynamic_embedding`` without ``sparse``) and ``donate=False``, which
    leaves the caller's state as it was."""
    from mindrec_tpu_torch.models import wide_deep
    from mindrec_tpu_torch.train.step import init_train_state, make_train_step

    model, opts, batches = _small_recipe(
        "multitable" if kind == "multitable" else "wd", cuda_device)
    if kind == "plain":
        model = wide_deep.WideDeepModel(dataclasses.replace(
            model.config, sparse=False, dynamic_embedding=True))
        assert not model.deep_spec.sparse
    donate = kind != "no-donate"
    se = init_train_state(model, 3, *opts, device=cuda_device)
    sc = init_train_state(model, 3, *opts, device=cuda_device)
    eager = make_train_step(model, *opts, use_pallas=False)
    cap = make_train_step(model, *opts, use_pallas=False, jit=True,
                          donate=donate)
    assert cap.step.__name__ == "step_generic"
    orig, keep = sc, [x.clone() for x in _state_tensors(sc)]
    for b in batches:
        se, le = eager(se, b)
        out, lc = cap(sc, b)
        assert (out is sc) == donate
        sc = out
        for x, y in zip(le, lc):
            assert torch.equal(x, y) and torch.isfinite(x).all()
    torch.cuda.synchronize()
    for x, y in zip(_state_tensors(se), _state_tensors(sc)):
        assert torch.equal(x, y)
    if not donate:  # the first state passed in is as it was
        for x, y in zip(keep, _state_tensors(orig)):
            assert torch.equal(x, y)
    assert cap.captures == (1 if kind == "multitable" else 2)
    assert cap.replays == len(batches) - cap.captures


@pytest.mark.cuda
def test_prefetch_matches_host_batches_with_busy_consumer(cuda_device):
    """Batches staged on the side stream equal the host batches, in
    order, while the consumer's stream is busy; a source error surfaces
    in the consumer after the batches before it."""
    from mindrec_tpu_torch.data.criteo import PrefetchToDevice

    rng = np.random.default_rng(0)
    host = [{"ids": rng.integers(0, 1 << 30, (4096, 39)).astype(np.int32),
             "wts": rng.normal(size=(4096, 39)).astype(np.float32)}
            for _ in range(8)]
    it = PrefetchToDevice(iter(host), depth=2, device=cuda_device)
    for want in host:
        torch.cuda._sleep(20_000_000)  # the consumer's stream is busy
        got = next(it)
        for k, v in want.items():
            assert got[k].device.type == "cuda"
            np.testing.assert_array_equal(got[k].cpu().numpy(), v)
    with pytest.raises(StopIteration):
        next(it)

    def failing():
        yield host[0]
        raise ValueError("source failed")

    it = PrefetchToDevice(failing(), device=cuda_device)
    next(it)
    with pytest.raises(ValueError, match="source failed"):
        next(it)


@pytest.mark.cuda
@pytest.mark.parametrize("jit", [False, True])
def test_guarded_step_on_card_equals_plain(cuda_device, jit):
    """check_overflow on the card: an inf batch keeps every leaf, and the
    kernel step (eager or captured) equals the plain guarded step within
    the kernel-vs-plain tolerances (the plain segment sums add with
    atomics)."""
    from mindrec_tpu_torch.train.step import init_train_state, make_train_step

    model, opts, batches = _small_recipe("wd", cuda_device)
    batches = batches[:3]
    bad = dict(batches[1])
    bad["wts"] = bad["wts"].clone()
    bad["wts"][0, 0] = float("inf")
    batches[1] = bad
    sa = init_train_state(model, 4, *opts, device=cuda_device)
    sb = init_train_state(model, 4, *opts, device=cuda_device)
    fa = make_train_step(model, *opts, check_overflow=True, jit=jit)
    fb = make_train_step(model, *opts, check_overflow=True, use_kernels=False)
    for i, b in enumerate(batches):
        before = [x.clone() for x in _state_tensors(sa)]
        sa, _ = fa(sa, b)
        sb, _ = fb(sb, b)
        if i == 1:
            after = _state_tensors(sa)
            # all but state.rng and state.step, which advance
            for x, y in zip(before[:-2], after[:-2]):
                assert torch.equal(x, y)
    assert int(sa.step) == int(sb.step) == 3
    for x, y in zip(_state_tensors(sa), _state_tensors(sb)):
        rtol = 2.0**-7 if x.dtype == torch.bfloat16 else 1e-4
        torch.testing.assert_close(x.float(), y.float(), rtol=rtol, atol=1e-6)


@pytest.mark.cuda
def test_rec_model_captures_beside_staging_on_card(cuda_device):
    """RecModel.train (jit=True) over raw batches: the step is captured
    while the pipeline's staging thread pins and copies the next batches
    on its own stream; a regrow mid-stream gives one more capture, and
    the state equals the eager step's over the same pipeline."""
    from mindrec_tpu_torch import RecModel
    from mindrec_tpu_torch.data.criteo import SyntheticCriteo
    from mindrec_tpu_torch.data.pipeline import (
        AdaptiveBucket, SparseInputPipeline,
    )
    from mindrec_tpu_torch.models import wide_deep
    from mindrec_tpu_torch.train import optim
    from mindrec_tpu_torch.train.step import init_train_state, make_train_step

    cfg = wide_deep.WideDeepConfig(
        batch_size=2048, field_size=39, vocab_size=1_000_000, emb_dim=16,
        deep_layer_dim=(256, 256), use_mixed_precision=True, sparse=True,
        loss_scale=1024.0)
    model = wide_deep.WideDeepModel(cfg)
    opts = (optim.ftrl(loss_scale=1024.0),
            optim.lazy_adam(loss_scale=1024.0, state_dtype=torch.bfloat16))
    lo = SyntheticCriteo(2048, 39, 1_000_000, steps=3, seed=50,
                         fields="criteo")
    hi = SyntheticCriteo(2048, 39, 1_000_000, steps=3, seed=60,
                         fields="criteo", zipf_a=1.05)
    raw = [lo.get_batch(i) for i in range(3)] + [hi.get_batch(i)
                                                 for i in range(3)]
    start = max(int(np.unique(b["ids"]).size) for b in raw[:3])
    quiet = lambda *a, **k: None  # noqa: E731
    rm = RecModel(model, *opts, seed=5, prep_workers=1, device=cuda_device,
                  unique_bucket=AdaptiveBucket(start, log=quiet))
    rm.train(1, raw, dataset_sink_mode=True)
    assert rm.train_step.captures == 2 and rm.train_step.replays == 4
    st = init_train_state(model, 5, *opts, device=cuda_device)
    step = make_train_step(model, *opts)
    pol = AdaptiveBucket(start, log=quiet)
    for b in SparseInputPipeline(raw, 39, policy=pol, workers=1):
        st, _ = step(st, b)
    assert pol.bucket == rm.bucket_policy.bucket > start
    for x, y in zip(_state_tensors(st), _state_tensors(rm.state)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the dense step, dropout and replaced states on the card
# ---------------------------------------------------------------------------


def _dense_recipe(dev, n=6, **cfg_kw):
    """(model, optimizers, device batches) of a small dense W&D: bf16 MLP,
    FTRL + dense Adam, the l2 term over the deep table."""
    from mindrec_tpu_torch.data.criteo import SyntheticCriteo, to_device
    from mindrec_tpu_torch.models import wide_deep
    from mindrec_tpu_torch.train import optim

    cfg = wide_deep.WideDeepConfig(
        batch_size=512, field_size=39, vocab_size=100_000, emb_dim=16,
        deep_layer_dim=(256, 256), **cfg_kw)
    opts = (optim.ftrl(loss_scale=1024.0), optim.adam(loss_scale=1024.0))
    data = SyntheticCriteo(512, 39, 100_000, seed=7, fields="criteo")
    batches = [to_device(data.get_batch(i), dev) for i in range(n)]
    return wide_deep.WideDeepModel(cfg), opts, batches


def _replace(state):
    """A new state holding the same values in new tensors, as a callback
    that replaces the train state (``EvictionCallback``) hands one over."""
    from mindrec_tpu_torch.train.step import TrainState, map_leaves

    def copy(node):
        return map_leaves(lambda _k, t: t.clone(), node)

    return TrainState(copy(state.params), copy(state.opt_w),
                      copy(state.opt_d), state.step.clone(),
                      state.rng.clone())


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [False, True], ids=["plain", "dropout"])
def test_dense_captured_step_equals_eager_on_card(cuda_device, dropout):
    """The dense step captured in a CUDA graph gives the eager step's
    losses and state bit for bit (the table gradient's index-put adds in
    a fixed order on the card), with dropout off and with dropout drawn
    from the state's key; the captured step's launches run no kernel of
    the port."""
    from mindrec_tpu_torch.train.step import init_train_state, make_train_step

    kw = dict(dropout_flag=True, keep_prob=0.9) if dropout else {}
    model, opts, batches = _dense_recipe(cuda_device, **kw)
    se = init_train_state(model, 3, *opts, device=cuda_device)
    sc = init_train_state(model, 3, *opts, device=cuda_device)
    eager = make_train_step(model, *opts)
    cap = make_train_step(model, *opts, jit=True)
    for b in batches:
        se, le = eager(se, b)
        out, lc = cap(sc, b)
        assert out is sc
        for x, y in zip(le, lc):
            assert torch.equal(x, y)
    torch.cuda.synchronize()
    for x, y in zip(_state_tensors(se), _state_tensors(sc)):
        assert torch.equal(x, y)
    assert cap.captures == 1 and cap.replays == len(batches) - 1
    assert cap.recorded == {} and cap.replayed == {}


@pytest.mark.cuda
def test_dropout_masks_differ_across_replays_on_card(cuda_device,
                                                     monkeypatch):
    """Each replay of the captured dense step draws new masks from the
    key the state holds then: two replays' masks differ at every layer,
    and each keeps its share within 0.5% of keep_prob."""
    from mindrec_tpu_torch.ops import prng
    from mindrec_tpu_torch.train.step import init_train_state, make_train_step

    model, opts, batches = _dense_recipe(cuda_device, n=3, dropout_flag=True,
                                         keep_prob=0.9)
    drawn, real = [], prng.bernoulli
    monkeypatch.setattr(prng, "bernoulli",
                        lambda k, p, shape: drawn.append(real(k, p, shape))
                        or drawn[-1])
    state = init_train_state(model, 4, *opts, device=cuda_device)
    cap = make_train_step(model, *opts, jit=True)
    state, _ = cap(state, batches[0])  # eager warm-up, then the capture
    masks = drawn[-len(model.mlp_dims):]  # the graph's outputs
    seen = []
    for b in batches[1:]:
        state, _ = cap(state, b)
        seen.append([m.clone() for m in masks])
    assert cap.captures == 1 and cap.replays == 2
    for a, b in zip(*seen):
        assert not torch.equal(a, b)
        for m in (a, b):
            assert abs(m.float().mean().item() / 0.9 - 1) < 0.005


@pytest.mark.cuda
def test_captured_step_drops_replaced_states_graphs_on_card(cuda_device):
    """A callback replaces the state twice: each replacement gives exactly
    one new capture, the step holds graphs only for the live state's
    batch signatures, and the run equals an eager run with the same
    replacements bit for bit."""
    from mindrec_tpu_torch.train.step import init_train_state, make_train_step

    model, opts, batches = _small_recipe("wd", cuda_device)  # 2 signatures
    se = init_train_state(model, 6, *opts, device=cuda_device)
    sc = init_train_state(model, 6, *opts, device=cuda_device)
    eager = make_train_step(model, *opts)
    cap = make_train_step(model, *opts, jit=True)

    def run(i):
        nonlocal se, sc
        se, le = eager(se, batches[i])
        sc, lc = cap(sc, batches[i])
        for x, y in zip(le, lc):
            assert torch.equal(x, y)

    run(0)
    run(3)  # the other signature
    assert (cap.captures, cap.graphs) == (2, 2)
    for i, j in ((1, 4), (2, 5)):
        se, sc = _replace(se), _replace(sc)
        run(i)
        assert (cap.captures, cap.graphs) == (3 if i == 1 else 5, 1)
        run(j)
        assert cap.graphs == 2
    assert cap.captures == 6 and cap.replays == 0
    run(1)
    assert (cap.captures, cap.replays, cap.graphs) == (6, 1, 2)
    torch.cuda.synchronize()
    for x, y in zip(_state_tensors(se), _state_tensors(sc)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_async_save_keeps_the_pre_step_state_on_card(cuda_device, tmp_path):
    """An async save followed at once by a captured step, which updates
    every leaf in place: the file holds the state before that step."""
    from mindrec_tpu_torch.io import checkpoint
    from mindrec_tpu_torch.train.step import init_train_state, make_train_step

    model, opts, batches = _small_recipe("wd", cuda_device)
    state = init_train_state(model, 8, *opts, device=cuda_device)
    cap = make_train_step(model, *opts, jit=True)
    state, _ = cap(state, batches[0])
    state, _ = cap(state, batches[1])  # captured from here on
    want = [t.cpu().clone() for t in _state_tensors(state)]
    with checkpoint.AsyncCheckpointer() as ac:
        ac.save(tmp_path, state, step=2)
        for b in batches[1:3]:
            state, _ = cap(state, b)
        path = ac.wait_until_finished()
    assert cap.replays == 3
    back = checkpoint.restore_checkpoint(path, state)
    for x, y in zip(_state_tensors(back), want):
        assert torch.equal(x.cpu(), y)
    assert not torch.equal(_state_tensors(state)[0].cpu(), want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sparse", "dense_dropout"])
def test_captured_resume_is_bit_identical_on_card(cuda_device, tmp_path,
                                                  kind):
    """4 captured steps straight == 2 steps, a checkpoint, a fresh state
    restored from it and 2 more steps with a new captured step."""
    from mindrec_tpu_torch.io import checkpoint
    from mindrec_tpu_torch.train.step import init_train_state, make_train_step

    if kind == "sparse":
        model, opts, batches = _small_recipe("wd", cuda_device)
        batches = batches[:3] + batches[:1]  # one batch signature
    else:
        model, opts, batches = _dense_recipe(cuda_device, n=4,
                                             dropout_flag=True, keep_prob=0.9)
    straight = init_train_state(model, 9, *opts, device=cuda_device)
    cap = make_train_step(model, *opts, jit=True)
    for b in batches:
        straight, _ = cap(straight, b)
    first = init_train_state(model, 9, *opts, device=cuda_device)
    cap1 = make_train_step(model, *opts, jit=True)
    for b in batches[:2]:
        first, _ = cap1(first, b)
    path = checkpoint.save_checkpoint(tmp_path, first, step=2)
    resumed = checkpoint.restore_checkpoint(
        path, init_train_state(model, 1, *opts, device=cuda_device))
    cap2 = make_train_step(model, *opts, jit=True)
    for b in batches[2:]:
        resumed, _ = cap2(resumed, b)
    torch.cuda.synchronize()
    assert cap2.captures == 1
    for x, y in zip(_state_tensors(resumed), _state_tensors(straight)):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["wide_deep", "deepfm", "dcn"])
def test_run_onnx_on_card_agrees_with_predict(cuda_device, tmp_path, kind):
    """The exported graph run on the card by ``serving/onnx_ref.py``
    against ``predict`` on the card (float32 model, no TF32)."""
    from mindrec_tpu_torch.data.criteo import SyntheticCriteo, to_device
    from mindrec_tpu_torch.io.onnx import export_onnx
    from mindrec_tpu_torch.models import dcn, deepfm, wide_deep
    from mindrec_tpu_torch.serving.onnx_ref import run_onnx
    from mindrec_tpu_torch.train.step import init_train_state
    from mindrec_tpu_torch.train import optim

    kw = dict(batch_size=256, field_size=39, vocab_size=50_000,
              deep_layer_dim=(64, 32), use_mixed_precision=False)
    model = {"wide_deep": lambda: wide_deep.WideDeepModel(
                 wide_deep.WideDeepConfig(emb_dim=16, sparse=True, **kw)),
             "deepfm": lambda: deepfm.DeepFMModel(deepfm.DeepFMConfig(
                 emb_dim=8, sparse=True, table_layout="feature_major", **kw)),
             "dcn": lambda: dcn.DCNModel(dcn.DCNConfig(emb_dim=8, **kw))}[kind]()
    state = init_train_state(model, 2, optim.ftrl(), optim.adam(),
                             device=cuda_device)
    b = to_device(SyntheticCriteo(256, 39, 50_000, seed=1).get_batch(0),
                  cuda_device)
    want = model.predict(state.params, b["ids"], b["wts"])
    data = open(export_onnx(tmp_path / "m.onnx", kind, model, state.params),
                "rb").read()
    got = run_onnx(data, {"ids": b["ids"], "wts": b["wts"]})["prob"]
    assert got.device.type == "cuda"
    assert float((got - want).abs().max()) < 1e-5


# ---------------------------------------------------------------------------
# cache mode and dynamic embeddings on the card
# ---------------------------------------------------------------------------


def _table_tensors(model, state):
    """Each table and its row-aligned optimizer state's tensors."""
    out = []
    for _n, (path, _spec) in model.table_specs.items():
        key = "/".join(path)
        out.append(state.params[path[0]][path[1]])
        st = (state.opt_w if key in state.opt_w else state.opt_d)[key]
        out += [t for t in st.values() if t.dim() == 2]
    return out


def _cache_recipe(dev, tmp_path, cache_rows=300, layout="feature_major"):
    """(model, opts, adapter, state, batches) of a small cache-mode W&D on
    ``dev``: ids over a 4000-row virtual vocab, a 300-row cache, RAM tiers
    capped at 1000 rows (the rest spills)."""
    from mindrec_tpu_torch.models import wide_deep
    from mindrec_tpu_torch.train import optim
    from mindrec_tpu_torch.train.cached import CachedTrainingAdapter
    from mindrec_tpu_torch.train.step import init_train_state

    B, F, D = 64, 8, 16
    model = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(
        batch_size=B, field_size=F, vocab_size=cache_rows, emb_dim=D,
        deep_layer_dim=(64, 32), sparse=True, table_layout=layout))
    opts = (optim.ftrl(loss_scale=1024.0), optim.lazy_adam(loss_scale=1024.0))
    adapter = CachedTrainingAdapter(
        model, virtual_vocab=4000, cache_rows=cache_rows, max_swap=B * F + 8,
        ram_bytes=1000 * D * 4, spill_dir=str(tmp_path))
    rng = np.random.default_rng(5)
    batches = [{"ids": ((rng.zipf(1.3, (B, F)) - 1) % 4000).astype(np.int64),
                "wts": np.ones((B, F), np.float32),
                "label": rng.integers(0, 2, (B, 1)).astype(np.float32)}
               for _ in range(12)]
    return model, opts, adapter, init_train_state(model, 0, *opts, device=dev), batches


@pytest.mark.cuda
def test_cached_swap_in_place_under_captured_step(cuda_device, tmp_path):
    """The in-place swap keeps the captured step's graph: 12 cached steps
    make one capture, every leaf keeps its address (the eager step
    replaces the dense leaves; the tables keep theirs), and the run
    equals the eager step's bit for bit (loss and tier rows); the dummy
    slot's rows stay zero in every table."""
    from mindrec_tpu_torch.ops.embedding import read_rows
    from mindrec_tpu_torch.train.cached import cached_train_step
    from mindrec_tpu_torch.train.step import make_train_step

    runs = {}
    for jit in (True, False):
        model, opts, adapter, state, batches = _cache_recipe(
            cuda_device, tmp_path / str(jit))
        step = make_train_step(model, *opts, jit=jit)
        leaves = (lambda _m, st: _state_tensors(st)) if jit else _table_tensors
        ptrs = [t.data_ptr() for t in leaves(model, state)]
        losses = []
        for b in batches:
            state, (_, ld) = cached_train_step(adapter, step, state, b)
            losses.append(float(ld))
        assert ptrs == [t.data_ptr() for t in leaves(model, state)]
        if jit:
            assert step.captures == 1 and step.replays == len(batches) - 1
        for _n, (path, spec) in model.table_specs.items():
            leaf = state.params[path[0]][path[1]]
            assert not read_rows(spec, leaf, [adapter.cache_rows]).any()
        adapter.flush_all(state)
        touched = np.unique(np.concatenate([b["ids"].ravel() for b in batches]))
        runs[jit] = (losses, {(n, t): adapter.tiers[n][t].read(touched)
                              for n in adapter.tiers for t in adapter.tiers[n]})
    assert runs[True][0] == runs[False][0]
    for k in runs[True][1]:
        np.testing.assert_array_equal(runs[True][1][k], runs[False][1][k])


@pytest.mark.cuda
def test_cached_writeback_waits_for_its_event_only(cuda_device, tmp_path,
                                                   monkeypatch):
    """The evicted rows reach the host through a pinned buffer and an
    event: ``writeback`` never synchronises the device, and the pipelined
    trainer equals the serial protocol bit for bit."""
    from mindrec_tpu_torch.train.cached import (
        AsyncCachedTrainer, cached_train_step,
    )
    from mindrec_tpu_torch.train.step import make_train_step

    results = []
    for mode in ("serial", "async"):
        model, opts, adapter, state, batches = _cache_recipe(
            cuda_device, tmp_path / mode, cache_rows=200)
        step = make_train_step(model, *opts, jit=True)
        state, _ = cached_train_step(adapter, step, state, batches[0])  # capture
        syncs = []
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda *a, **k: syncs.append(1))
        if mode == "serial":
            for b in batches[1:]:
                prep = adapter.prepare(b)
                state = adapter.apply_swap(state, prep)
                if prep["evict_ids"].size:
                    assert prep["evicted"]["deep"].is_pinned()
                adapter.writeback(prep)
                state, _ = step(state, adapter.transform(b, prep))
        else:
            tr = AsyncCachedTrainer(adapter, step, state)
            for b in batches[1:]:
                tr.step(b)
            state = tr.finish()
        assert not syncs
        monkeypatch.undo()
        adapter.flush_all(state)
        touched = np.unique(np.concatenate([b["ids"].ravel() for b in batches]))
        results.append(({(n, t): adapter.tiers[n][t].read(touched)
                         for n in adapter.tiers for t in adapter.tiers[n]},
                        [t.clone() for t in _state_tensors(state)]))
    for k in results[0][0]:
        np.testing.assert_array_equal(results[0][0][k], results[1][0][k])
    for x, y in zip(results[0][1], results[1][1]):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_dynamic_eviction_in_place_under_captured_step(cuda_device):
    """Eviction between replays writes the freed rows in place: one
    capture over 12 steps with an eviction every 3, the freed rows equal
    the adapter's draws, their optimizer state zero."""
    from mindrec_tpu_torch.data.criteo import to_device
    from mindrec_tpu_torch.models import wide_deep
    from mindrec_tpu_torch.ops.embedding import read_rows
    from mindrec_tpu_torch.train import optim
    from mindrec_tpu_torch.train.dynamic import DynamicEmbeddingAdapter
    from mindrec_tpu_torch.train.step import init_train_state, make_train_step

    B, F = 64, 8
    model = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(
        batch_size=B, field_size=F, vocab_size=500, emb_dim=16,
        deep_layer_dim=(32,), sparse=True, dynamic_embedding=True))
    opts = (optim.ftrl(), optim.lazy_adam())
    state = init_train_state(model, 0, *opts, device=cuda_device)
    ad = DynamicEmbeddingAdapter(500, permit_filter_value=2,
                                 evict_filter_value=3, seed=1)
    step = make_train_step(model, *opts, jit=True)
    rng = np.random.default_rng(2)
    freed_total = 0
    for i in range(12):
        b = {"ids": rng.zipf(1.3, (B, F)).astype(np.int64) * 7919,
             "wts": np.ones((B, F), np.float32),
             "label": rng.integers(0, 2, (B, 1)).astype(np.float32)}
        state, _ = step(state, to_device(ad.transform_batch(b), cuda_device))
        if i % 3 == 2:
            probe = np.random.default_rng(0)
            probe.bit_generator.state = ad._rng.bit_generator.state
            freed = ad.store.evict()
            ad.store = _Replay(ad.store, freed)
            _state, n = ad.evict(state, model.table_specs)
            assert _state is state and n == freed.size
            freed_total += n
            for _name, (path, spec) in model.table_specs.items():
                want = probe.normal(0, 0.01, (freed.size, spec.emb_dim))
                got = read_rows(spec, state.params[path[0]][path[1]], freed)
                np.testing.assert_array_equal(
                    got.cpu().numpy(), want.astype(np.float32))
                for leaf in (state.opt_w if "wide" in path else state.opt_d)[
                        "/".join(path)].values():
                    if leaf.shape == state.params[path[0]][path[1]].shape:
                        assert not read_rows(spec, leaf, freed).any()
            ad.store = ad.store.store
    assert step.captures == 1 and freed_total > 0


class _Replay:
    """A hash store whose next ``evict`` returns slots already taken."""

    def __init__(self, store, freed):
        self.store, self._freed = store, freed

    def evict(self):
        return self._freed


# ---------------------------------------------------------------------------
# the compact wire and device prep on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["sparse", "sparse_prep", "fields", "keys"])
def test_wire_decode_on_card_equals_cpu(cuda_device, plan):
    """The wire's decode of a staged arena (and of per-key arrays) on the
    card equals its decode on the CPU bit for bit, sentinels, negative
    bf16 weights and 3-byte ids included."""
    from mindrec_tpu_torch.data.criteo import (
        SyntheticCriteo, criteo_field_sizes, to_device,
    )
    from mindrec_tpu_torch.data.wire import BatchWire
    from mindrec_tpu_torch.train.step import make_batch_sort

    B, F, V = 4096, 39, 5_860_000
    b = SyntheticCriteo(B, F, V, seed=3, fields="criteo").get_batch(0)
    b["wts"] = np.random.default_rng(1).normal(0, 3, (B, F)).astype(np.float32)
    if plan == "fields":
        b["wts"][:, 13:] = 1.0
        w = BatchWire.for_fields(criteo_field_sizes(V, F), B,
                                 wt_value_fields=range(13))
    else:
        if plan == "sparse_prep":
            b = make_batch_sort(F, minimal=True)(b)
            b["uq_ids"] = b["uq_ids"][:65536]
        w = BatchWire.for_sparse(V, B, F, host_prep=plan == "sparse_prep",
                                 arena=plan != "keys")
    packed = w.encode(b)
    dec = w.decoder()
    cpu = dec(packed)
    card = dec(to_device(packed, cuda_device))
    assert sorted(cpu) == sorted(card)
    for k in cpu:
        assert card[k].device.type == "cuda"
        assert torch.equal(card[k].cpu(), torch.as_tensor(cpu[k])), k


@pytest.mark.cuda
def test_device_prep_captured_step_equals_host_prep_on_card(cuda_device):
    """One W&D batch at a small vocab: the captured step fed the staged
    wire arena and sorting on the card (device prep) equals the captured
    step fed host-prepped metadata, bit for bit (both stable sorts give
    one perm; the bucket is the same)."""
    from mindrec_tpu_torch.data.criteo import SyntheticCriteo, to_device
    from mindrec_tpu_torch.data.wire import BatchWire
    from mindrec_tpu_torch.models import wide_deep
    from mindrec_tpu_torch.train import optim
    from mindrec_tpu_torch.train.step import (
        init_train_state, make_batch_sort, make_train_step,
    )

    B, F, V = 2048, 39, 100_000
    cfg = wide_deep.WideDeepConfig(
        batch_size=B, field_size=F, vocab_size=V, emb_dim=16,
        deep_layer_dim=(256, 256), use_mixed_precision=True, sparse=True,
        loss_scale=1024.0)
    model = wide_deep.WideDeepModel(cfg)
    opts = (optim.ftrl(loss_scale=1024.0),
            optim.lazy_adam(loss_scale=1024.0, state_dtype=torch.bfloat16))
    raw = SyntheticCriteo(B, F, V, seed=9, fields="criteo").get_batch(0)
    bucket = 32768
    host = make_batch_sort(F, unique_bucket=bucket, minimal=True)(dict(raw))
    host["uq_ids"] = host["uq_ids"][:bucket]
    w = BatchWire.for_sparse(V, B, F)
    arena = to_device(w.encode(raw), cuda_device)
    dec = w.decoder()
    sh = init_train_state(model, 2, *opts, device=cuda_device)
    sd = init_train_state(model, 2, *opts, device=cuda_device)
    step_h = make_train_step(model, *opts, jit=True)
    raw_d = make_train_step(model, *opts, unique_bucket=bucket)
    step_d = CapturedStep(lambda st, b: raw_d(st, dec(b)))
    for _ in range(3):  # capture, then two replays
        sh, lh = step_h(sh, to_device(host, cuda_device))
        sd, ld = step_d(sd, arena)
        for x, y in zip(lh, ld):
            assert torch.equal(x, y)
    assert step_d.captures == 1 and step_d.replays == 2
    torch.cuda.synchronize()
    for x, y in zip(_state_tensors(sh), _state_tensors(sd)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# PS mode on the card: the host-target regime and remote tiers
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_host_target_kernel_equals_plain_on_card(cuda_device, tmp_path,
                                                 monkeypatch):
    """The host-target step (``parameter_server=True``) with its
    expansion's backward through ``segsum_sorted`` against the same steps
    with the plain version, from one dense state and the same tier rows:
    losses rtol 1e-5, every touched tier row and dense parameter rtol
    1e-4, atol 1e-6; one kernel launch per step."""
    from mindrec_tpu_torch.data.criteo import SyntheticCriteo
    from mindrec_tpu_torch.models import wide_deep
    from mindrec_tpu_torch.train import host_target, optim
    from mindrec_tpu_torch.train.step import flatten_params

    B, F, V = 1024, 39, 50_000
    model = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(
        batch_size=B, field_size=F, vocab_size=V, emb_dim=16,
        deep_layer_dim=(256, 256), sparse=True, parameter_server=True))
    opts = (optim.ftrl(loss_scale=1024.0), optim.lazy_adam(loss_scale=1024.0))
    data = SyntheticCriteo(B, F, V, seed=4, fields="criteo")
    batches = [data.get_batch(s) for s in range(4)]
    rng = np.random.default_rng(0)
    init = {"wide": rng.normal(0, 0.01, (V, 1)).astype(np.float32),
            "deep": rng.normal(0, 0.01, (V, 16)).astype(np.float32)}
    runs = {}
    for use in ("kernel", "plain"):
        if use == "plain":
            monkeypatch.setattr(host_target, "segsum_sorted", segsum_sorted_plain)
        ad = host_target.HostTargetAdapter(model, V, 32768, *opts,
                                           spill_dir=str(tmp_path / use))
        for n, rows in init.items():
            ad.tiers[n]["param"].write(np.arange(V), rows)
        state = host_target.init_dense_state(model, 0, *opts,
                                              device=cuda_device)
        kernels.reset_launches()
        losses = []
        for b in batches:
            state, (_lw, ld) = ad.train_step(state, b)
            losses.append(float(ld))
        launches = kernels.LAUNCHES["segsum_sorted"]
        touched = np.unique(np.concatenate([b["ids"].ravel() for b in batches]))
        runs[use] = (losses, launches, {
            (n, t): tier.read(touched) for n, tiers in ad.tiers.items()
            for t, tier in tiers.items()},
            [t.float().cpu() for _k, t in flatten_params(state.params)])
    (lk, nk, rk, dk), (lp, np_, rp, dp) = runs["kernel"], runs["plain"]
    assert nk == len(batches) and np_ == 0
    np.testing.assert_allclose(lk, lp, rtol=1e-5)
    for k in rk:
        np.testing.assert_allclose(rk[k], rp[k], rtol=1e-4, atol=1e-6,
                                   err_msg=str(k))
    for x, y in zip(dk, dp):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_cached_remote_serial_equals_pipelined_on_card(cuda_device, tmp_path):
    """A small cache-mode W&D over one table server: the serial protocol
    and ``AsyncCachedTrainer`` from one state give the same state and the
    same rows on the server, bit for bit (each run on its own server)."""
    from mindrec_tpu_torch.ops import remote
    from mindrec_tpu_torch.train.cached import (
        AsyncCachedTrainer, CachedTrainingAdapter, cached_train_step,
    )
    from mindrec_tpu_torch.train.step import make_train_step

    results = []
    for mode in ("serial", "async"):
        model, opts, _, state, batches = _cache_recipe(
            cuda_device, tmp_path / mode, cache_rows=200)
        proc = remote.launch_table_server(ram_mb=0, spill_dir=str(tmp_path))
        try:
            adapter = CachedTrainingAdapter(
                model, virtual_vocab=4000, cache_rows=200,
                max_swap=64 * 8 + 8, remote_addrs=[proc.addr])
            step = make_train_step(model, *opts, jit=True)
            if mode == "serial":
                for b in batches:
                    state, _ = cached_train_step(adapter, step, state, b)
            else:
                tr = AsyncCachedTrainer(adapter, step, state)
                for b in batches:
                    tr.step(b)
                state = tr.finish()
            adapter.flush_all(state)
            touched = np.unique(np.concatenate([b["ids"].ravel() for b in batches]))
            rows = {(n, t): adapter.tiers[n][t].read(touched)
                    for n in adapter.tiers for t in adapter.tiers[n]}
            ssd = sum(s for t in adapter.tiers["deep"].values()
                      for _r, s in t.stats())
        finally:
            remote.stop_table_server(proc.addr, proc)
        assert ssd > 0 and step.captures == 1
        results.append((rows, [t.clone() for t in _state_tensors(state)]))
    for k in results[0][0]:
        np.testing.assert_array_equal(results[0][0][k], results[1][0][k])
    for x, y in zip(results[0][1], results[1][1]):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the kernels at the per-shard inputs of a mesh (ops/sharded_stream.py)
# ---------------------------------------------------------------------------


def _shard_uq(rng, vc_global, n_uq, n_sent):
    uq = np.sort(rng.choice(vc_global, size=n_uq, replace=False))
    return np.concatenate([uq, np.full(n_sent, SENT)]).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_shard_kernels_match_plain_on_card(cuda_device, dtype):
    """Each model rank's inputs: the global sorted unique columns clipped
    to -1 below its block and past ``Vc_local`` above it (gather_rows,
    adam_cols, ftrl_cols), gather_rows at a lane offset chosen at run
    time (the column slice's ``off + m * Dp/M``), and segsum_sorted of a
    data rank's own sorted ids at their places in the global unique
    order (``local_segments``: steps with gaps, the skipped rows zero)."""
    from mindrec_tpu_torch.ops import sharded_stream as ss
    from mindrec_tpu_torch.parallel.mesh import Mesh

    rng = np.random.default_rng(5)
    dt = getattr(torch, dtype)
    dp, vc, shards = 16, 4096, 4
    vl = vc // shards
    uq = _t(_shard_uq(rng, vc, 700, 90)).to(cuda_device)
    for m in range(shards):
        cols = ss.owned_cols(uq, vl, m)
        assert (cols[:1] == -1).any() or m == 0
        table = _t(rng.normal(size=(dp, vl)).astype(np.float32)).to(cuda_device, dt)
        off = int(rng.integers(0, 64))
        bufs = [torch.zeros((uq.numel(), 128), device=cuda_device)
                for _ in range(2)]
        gather_rows(table, cols, bufs[0], off)
        gather_rows_plain(table, cols, bufs[1], off)
        assert torch.equal(bufs[0], bufs[1])
        # the owned columns are distinct: each sum is one gradient
        g = rng.normal(size=(dp, uq.numel())) * 5.0
        aug = make_aug_grads(_t(g.astype(np.float32)).to(cuda_device),
                             None).contiguous()
        lr = torch.tensor(1e-3, device=cuda_device)
        st = [table.clone(), (table.float() * 0.1).to(dt),
              (table.float().abs() * 0.01).to(dt)]
        a, b = [x.clone() for x in st], [x.clone() for x in st]
        adam_cols(*a, cols, aug, lr, dim=dp, fold=1)
        adam_cols_plain(*b, cols, aug, lr, dim=dp, fold=1)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
        # the weights at the table's scale (100x the recipe's) and at the
        # recipe's, as ftrl_cols_case makes them
        accum = _t(0.1 + rng.uniform(size=(dp, vl)).astype(np.float32))
        for scale in (1.0, 0.01):
            a = [table.float() * scale, accum.to(cuda_device),
                 table.float() * (10.0 * scale)]
            b = [x.clone() for x in a]
            ftrl_cols(*a, cols, aug, dim=dp, fold=1)
            ftrl_cols_plain(*b, cols, aug, dim=dp, fold=1)
            for x, y in zip(a, b):
                torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
    one = Mesh(1, 1)  # no data group: the local partial sum alone
    n_l = 3000
    ids = _t(rng.choice(_shard_uq(rng, vc, 700, 0), size=n_l)).to(cuda_device)
    uq_g = torch.unique(ids)
    uq_b = torch.cat([uq_g, uq_g.new_full((1024 - uq_g.numel(),), SENT)]).int()
    gpos = _t(rng.normal(size=(n_l, 17)).astype(np.float32)).to(cuda_device, dt)
    got = ss.partial_segsum_sharded(one, gpos, ids, uq_b, 1024)
    want = ss.partial_segsum_sharded(one, gpos, ids, uq_b, 1024,
                                     use_kernels=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert (got[:, uq_g.numel():] == 0).all()
    # half the positions against the whole unique vector: the segments
    # the half does not touch are skipped, and their rows stay zero
    half = ids[: n_l // 2]
    uidx, perm = ss.local_segments(half, uq_b)
    assert (torch.diff(uidx) > 1).any()
    absent = ~torch.isin(uq_g, half)
    assert absent.any()
    got = segsum_sorted(gpos, uidx, 1024, perm=perm, gaps=True)
    torch.testing.assert_close(
        got, segsum_sorted_plain(gpos, uidx, 1024, perm), rtol=1e-5, atol=1e-5)
    assert (got[:, :uq_g.numel()][:, absent] == 0).all()


@pytest.mark.cuda
def test_gloo_staging_round_trips_cuda_tensors(cuda_device):
    """Under gloo a CUDA tensor travels through pinned host memory: a
    one-rank group gives back every dtype bit for bit, on the card."""
    import torch.distributed as tdist

    from mindrec_tpu_torch.parallel import mesh as pm
    from mindrec_tpu_torch.parallel.launch import free_port

    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                             world_size=1, rank=0)
    try:
        mesh = pm.Mesh(1, 1, groups={"data": tdist.group.WORLD,
                                     "model": tdist.group.WORLD})
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        for dt in (torch.float32, torch.bfloat16, torch.int32):
            x = torch.randn((1000, 7), generator=gen, device=cuda_device)
            x = (x * 1000).to(dt)
            for out in (pm.all_reduce(x, "data", mesh),
                        pm.all_gather(x, "model", mesh),
                        pm.all_to_all(x, "model", mesh)):
                assert out.device == x.device and out.dtype == dt
                assert torch.equal(out, x)
    finally:
        tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# the captured step on a mesh: 2 gloo ranks sharing the card
# ---------------------------------------------------------------------------

MESH_CAPTURE_STEPS = 5
MESH_INF_STEP = 3  # this batch has an inf in data rank 0's slice


def _mesh_recipe(args):
    """A small W&D (the deep table row-sliced when the mesh has a model
    axis) on this rank's (data, model) mesh, the rank's block of one
    state, and the global host batches."""
    from mindrec_tpu_torch.data.criteo import SyntheticCriteo
    from mindrec_tpu_torch.models.wide_deep import WideDeepConfig, WideDeepModel
    from mindrec_tpu_torch.parallel import mesh as pm
    from mindrec_tpu_torch.parallel.dist import rank_device
    from mindrec_tpu_torch.train import optim
    from mindrec_tpu_torch.train.step import init_train_state

    mesh = pm.make_mesh(args["data"], args["model"])
    dev = rank_device("cuda")
    cfg = WideDeepConfig(
        batch_size=64, field_size=8, vocab_size=4096, emb_dim=16,
        deep_layer_dim=(64, 32), sparse=True, loss_scale=1024.0,
        use_mixed_precision=True,
        deep_table_slice_mode=("table_row_slice" if args["model"] > 1
                               else "none"))
    model = WideDeepModel(cfg, mesh=mesh)
    opts = (optim.ftrl(loss_scale=1024.0), optim.lazy_adam(loss_scale=1024.0))
    state = pm.shard_train_state(
        init_train_state(model, 0, *opts, device=dev), model, mesh)
    data = SyntheticCriteo(64, 8, 4096, steps=MESH_CAPTURE_STEPS, seed=2,
                           fields="criteo")
    batches = [data.get_batch(i) for i in range(MESH_CAPTURE_STEPS)]
    batches[MESH_INF_STEP]["wts"][1, 2] = np.inf
    return mesh, dev, model, opts, state, batches


def mesh_capture_job(args):
    """Rank side of :func:`test_captured_mesh_step_equals_eager_on_card`:
    from two copies of the rank's block, the eager guarded step on the
    rank's slices and the captured one on whole batches (``FullBatch``,
    sliced by the step); -> what the test checks."""
    from mindrec_tpu_torch.data.criteo import to_device
    from mindrec_tpu_torch.ops.kernels import reset_launches
    from mindrec_tpu_torch.parallel import mesh as pm
    from mindrec_tpu_torch.train.step import (
        _clone_state, make_train_step, real_launches,
    )

    mesh, dev, model, opts, state, batches = _mesh_recipe(args)
    out = {}
    for kind in ("eager", "captured"):
        st = _clone_state(state)
        step = make_train_step(model, *opts, check_overflow=True,
                               jit=kind == "captured")
        rec = out[kind] = {"losses": [], "collectives": [], "launches": [],
                           "kept_on_inf": None, "captures": 0}
        for i, b in enumerate(batches):
            part = (pm.FullBatch(to_device(b, dev)) if kind == "captured"
                    else to_device(pm.shard_batch(b, mesh), dev))
            before = [x.clone() for x in _state_tensors(st)]
            pm.reset_collectives()
            reset_launches()
            if kind == "captured":
                step.reset_counts()
            st, (lw, ld) = step(st, part)
            rec["losses"].append((float(lw), float(ld)))
            rec["collectives"].append(list(pm.COLLECTIVES))
            rec["launches"].append(
                {k: v for k, v in real_launches(step).items() if v})
            if kind == "captured":
                rec["captures"] += step.captures
            if i == MESH_INF_STEP:  # all but state.rng and state.step
                rec["kept_on_inf"] = all(
                    torch.equal(x, y) for x, y in
                    zip(before[:-2], _state_tensors(st)[:-2]))
        if kind == "captured":
            rec["segments"] = step.segments
            rec["equal_leaves"] = [
                torch.equal(x, y) for x, y in
                zip(_state_tensors(out["eager"]["state"]), _state_tensors(st))]
        else:
            rec["state"] = st
    del out["eager"]["state"]
    return out


def mesh_capture_fails_job(args):
    """Rank side of :func:`test_failed_mesh_capture_fails_the_spawn`: a
    host read inside the step breaks its capture, which raises."""
    from mindrec_tpu_torch.data.criteo import to_device
    from mindrec_tpu_torch.parallel import mesh as pm
    from mindrec_tpu_torch.train.step import CapturedStep, make_train_step

    mesh, dev, model, opts, state, batches = _mesh_recipe(args)
    inner = make_train_step(model, *opts)

    def step_reading_the_host(st, batch):
        st, losses = inner(st, batch)
        float(losses[0])  # not allowed while a graph is captured
        return st, losses

    step = CapturedStep(step_reading_the_host)
    for b in batches:
        state, _ = step(state, to_device(pm.shard_batch(b, mesh), dev))
    return {"captures": step.captures}


@pytest.mark.cuda
@pytest.mark.parametrize("data,model", [(1, 2), (2, 1)], ids=["1x2", "2x1"])
def test_captured_mesh_step_equals_eager_on_card(cuda_device, data, model):
    """2 gloo ranks on the card: the captured step (graphs cut at every
    collective) equals the eager one bit for bit, losses and every leaf;
    each replay makes the eager step's collectives and launches its
    kernels; the inf batch is dropped on every rank as in eager; a
    ``FullBatch`` is sliced by the captured step."""
    from mindrec_tpu_torch.parallel import launch

    res, _ = launch.run_job(f"{__file__}:mesh_capture_job",
                            {"device": "cuda", "data": data, "model": model},
                            2, timeout=240)
    for r, o in enumerate(res):
        e, c = o["eager"], o["captured"]
        # the inf batch's losses are not finite: equal as arrays
        np.testing.assert_array_equal(c["losses"], e["losses"], err_msg=str(r))
        assert all(c["equal_leaves"]), (r, c["equal_leaves"])
        assert c["collectives"] == e["collectives"], r
        assert c["captures"] == 1 and c["segments"][0] > 1, (r, c["segments"])
        for la in (*e["launches"], *c["launches"]):
            assert {"segsum_sorted", "ftrl_rows"} <= set(la), (r, la)
        assert c["launches"] == e["launches"], r
        assert e["kept_on_inf"] and c["kept_on_inf"], r
    np.testing.assert_array_equal(res[0]["captured"]["losses"],
                                  res[1]["captured"]["losses"])


@pytest.mark.cuda
def test_failed_mesh_capture_fails_the_spawn(cuda_device):
    """A capture that breaks raises on its rank (no eager step in its
    place), and the launcher takes the group down."""
    from mindrec_tpu_torch.parallel import launch

    with pytest.raises(launch.RanksFailed, match="exited with"):
        launch.run_job(f"{__file__}:mesh_capture_fails_job",
                       {"device": "cuda", "data": 2, "model": 1}, 2,
                       timeout=240)
