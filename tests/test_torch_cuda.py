"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Needs an NVIDIA GPU (sm_90a) and nvcc; skips without a card.
Imports no JAX, so it runs where only the port is installed::

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The edge-case lists of ``segsum_unsorted``, ``segsum_cols`` and
``adam_cols`` (and the functions that make their numpy inputs) live
here; ``tests/test_torch_edge_cases.py`` runs the same lists on the CPU,
plain version against the JAX kernel.
"""

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
    uidx[:700] = 0  # one hot id spanning many 64-row chunks
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
