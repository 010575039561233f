#!/usr/bin/env python3
"""Device time by operator of the generic sparse step
(``make_train_step(use_pallas=False)``) at the W&D bench recipe
(``chip_smoke.py:wd_recipe``: batch 16000 x 39, vocab 5.86M, emb 16,
7x1024 bf16, FTRL + LazyAdam with bf16 m/v, row_packed), on one card::

    python3 tools/profile_generic.py [--steps 3] [--top 25]

Runs 2 eager warm-up steps, then ``--steps`` eager steps under
``torch.profiler`` (CPU and CUDA), and prints the card's name and power
limit, the device ms per step, and the operators with the most device
time (``key_averages``, sorted by device time).  Exits non-zero without
a card.
"""

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_generic: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    model, opts = cs.wd_recipe()
    data = cs.SyntheticCriteo(cs.BATCH, cs.FIELDS, cs.VOCAB, steps=4, seed=27,
                              fields="criteo")
    batches = [cs.to_device(data.get_batch(s), dev) for s in range(4)]
    state = cs.init_train_state(model, 0, *opts, device=dev)
    step = cs.make_train_step(model, *opts, use_pallas=False)
    for b in batches[:2]:
        state, _ = step(state, b)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(args.steps):
            state, _ = step(state, batches[(2 + i) % len(batches)])
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_time_total > 0]
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / args.steps
    print(f"device ms per step (sum of kernel time): {total:.3f}")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[: args.top]:
        print(f"{e.self_device_time_total / 1e3 / args.steps:9.3f} ms  "
              f"{e.count // args.steps:5d} calls  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
