"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Needs an NVIDIA GPU (sm_90a) and nvcc; skips without a card.
Imports no JAX, so it runs where only the port is installed::

    python -m pytest tests/test_torch_cuda.py -q
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
    g = _t(rng.normal(size=(5000, 128)).astype(np.float32)).to(cuda_device)
    u = _t(uidx).to(cuda_device)
    for dt in (torch.float32, torch.bfloat16):
        got = segsum_sorted(g.to(dt), u, 4096)
        want = segsum_sorted_plain(g.to(dt), u, 4096)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
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
    within float32 reordering (a scan inside the kernel, atomics in the
    plain version) and deterministic; the fused updates equal to rounding
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
    # column-major segment-sum: a hot id over many 256-position chunks,
    # runs that end exactly at chunk edges, a ragged last chunk, a tail
    uidx = _uidx(rng, 5003, 7)
    uidx[:700] = 0
    uidx[700:1024] = 1   # ends at a chunk edge
    uidx[1024:1280] = 2  # exactly one whole chunk
    uidx[1280:] = np.maximum(uidx[1280:], 3)
    uidx = np.maximum.accumulate(uidx)
    _, uidx = np.unique(uidx, return_inverse=True)  # unit steps
    u = _t(uidx.astype(np.int32)).to(dev)
    g = _t(rng.normal(size=(27, uidx.size)).astype(np.float32)).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        for n_out in (5003, 5632, 1000):
            got = segsum_cols(g.to(dt), u, n_out)
            want = segsum_cols_plain(g.to(dt), u, n_out)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
            assert torch.equal(got, segsum_cols(g.to(dt), u, n_out))
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
