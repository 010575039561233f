"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Needs an NVIDIA GPU (sm_90a) and nvcc; skips without a card.
Imports no JAX, so it runs where only the port is installed::

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from mindrec_tpu_torch.ops.kernels.segsum import segsum_sorted, segsum_sorted_plain
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
