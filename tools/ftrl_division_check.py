#!/usr/bin/env python3
"""Where the FTRL column kernel and its plain version part on the card::

    python3 tools/ftrl_division_check.py

Runs ``ftrl_cols_from_sums`` and ``ftrl_cols_plain`` on the inputs of
``tests/test_torch_cuda.py::test_per_shard_kernels_match_plain_on_card``
at the table's scale (weights ~N(0, 1), accumulators in [0.1, 1.1),
distinct columns, gradients ~N(0, 25)), and a plain version that divides
by the Python number ``learning_rate``, as ``train/optim.py:ftrl_math``
did before it took a tensor divisor.  On the card PyTorch turns a
division by a Python number into a product with its float32 reciprocal;
the kernel divides.  Prints the card's name and power limit and, for
each plain version, the largest absolute and relative difference from
the kernel and the number of elements that differ.  Exits non-zero
without a card.
"""

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mindrec_tpu_torch.ops.kernels import update_cols as uc  # noqa: E402
from mindrec_tpu_torch.ops.sharded_stream import owned_cols  # noqa: E402
from mindrec_tpu_torch.train import optim  # noqa: E402

SENT = 2**31 - 2


def ftrl_math_scalar(g, accum, linear, w, *, learning_rate, l1, l2,
                     inv_scale, lr_power=-0.5):
    """``ftrl_math`` dividing by the Python number (the old form)."""
    g = g.float() * inv_scale
    w32 = w.float()
    accum_new = accum.float() + g * g
    sq_new, sq_old = torch.sqrt(accum_new), torch.sqrt(accum.float())
    sigma = (sq_new - sq_old) / learning_rate
    linear_new = linear.float() + g - sigma * w32
    quadratic = sq_new / learning_rate + 2.0 * l2
    w_new = torch.where(torch.abs(linear_new) > l1,
                        (torch.sign(linear_new) * l1 - linear_new) / quadratic,
                        torch.zeros_like(linear_new))
    return w_new, accum_new, linear_new


def diff(a, b) -> dict:
    d = (a - b).abs()
    return {"max_abs": d.max().item(),
            "max_rel": (d / b.abs().clamp_min(1e-30)).max().item(),
            "n_differ": int((d > 0).sum())}


def main() -> int:
    if not torch.cuda.is_available():
        print("ftrl_division_check: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    rng = np.random.default_rng(5)
    dp, vc, shards = 16, 4096, 4
    vl = vc // shards
    uq = np.sort(rng.choice(vc, size=700, replace=False))
    uq = torch.from_numpy(
        np.concatenate([uq, np.full(90, SENT)]).astype(np.int32)).to(dev)
    for m in range(shards):
        cols = owned_cols(uq, vl, m)
        table = torch.from_numpy(
            rng.normal(size=(dp, vl)).astype(np.float32)).to(dev)
        g = rng.normal(size=(dp, uq.numel())) * 5.0
        gs = torch.from_numpy(g.astype(np.float32)).to(dev)
        aug = uc.make_aug_grads(gs, None).contiguous()
        accum = torch.from_numpy(
            0.1 + rng.uniform(size=(dp, vl)).astype(np.float32)).to(dev)
        base = [table.clone(), accum, table * 10.0]
        k = [x.clone() for x in base]
        uc.ftrl_cols_from_sums(*k, cols, gs, None, None, dim=dp, fold=1)
        out = {}
        for name, fn in (("tensor divisor", optim.ftrl_math),
                         ("python divisor", ftrl_math_scalar)):
            uc.ftrl_math = fn  # what ftrl_cols_plain calls
            p = [x.clone() for x in base]
            uc.ftrl_cols_plain(*p, cols, aug, dim=dp, fold=1)
            out[name] = {t: diff(x, y) for t, x, y in
                         zip(("w", "accum", "linear"), k, p)}
        uc.ftrl_math = optim.ftrl_math
        print(f"model rank {m} of {shards}, [{dp}, {vl}]:", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
