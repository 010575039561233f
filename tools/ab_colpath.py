#!/usr/bin/env python3
"""Time the column path of two trees of this repository in turns, in one
run on one GPU: ``segsum_cols`` at the DeepFM and W&D feature-major shapes
and the DeepFM recipe's ``row_layout=False`` step.

    python3 tools/ab_colpath.py OLD_TREE NEW_TREE [--turns 2] [--steps 20]

A tree is a checkout of the repository, e.g. a parent commit unpacked
with ``git archive`` under the git-ignored ``_cmp/``.  The trees run one
process each, in turns (OLD, NEW, NEW, OLD for two turns).  A process
imports its tree's ``chip_smoke.py`` and package, builds that tree's
kernels, times ``segsum_cols`` with the tree's own ``check_segsum_cols``
(each tree's kernel takes the layout its step gives it), then runs 3
warm-up and ``--steps`` timed steps (three times, keeping the least
ms/step) of the DeepFM recipe with
``table_layout="feature_major"`` and ``row_layout=False`` (phase 10 of
``chip_smoke.py``) and 5 more under ``torch.profiler`` for the device
time per step (the sum of its kernels' times: the step is bound by the
host's launches, whose time varies between processes), and prints one
JSON line.  The card's name and power limit come first, a ``[compare]``
line per measure last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def one(tree: str, steps: int) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    import chip_smoke as cs
    from mindrec_tpu_torch.data.criteo import SyntheticCriteo, to_device
    from mindrec_tpu_torch.train.step import (
        init_train_state, make_batch_sort, make_train_step,
    )

    dev = torch.device("cuda", 0)
    cs.phase_build()
    gen = torch.Generator(device=dev).manual_seed(0)
    fm_host = cs.criteo_host_batches(cs.FM_VOCAB, 4)
    wd = SyntheticCriteo(cs.BATCH, cs.FIELDS, cs.VOCAB, steps=1, seed=0,
                         fields="criteo").get_batch(0)
    wd_uidx = make_batch_sort(cs.FIELDS, minimal=True)(wd)["uidx_sorted"]
    res = {"tree": tree}
    for tag, d, uidx in (("DeepFM", 88, fm_host[0]["uidx_sorted"]),
                         ("W&D", 24, wd_uidx)):
        u = torch.from_numpy(uidx).to(dev)
        res[f"segsum_cols_{tag}_ms"] = cs.check_segsum_cols(
            tag, dev, gen, d, u)["ms"]
    torch.cuda.empty_cache()
    model, opts = cs.deepfm_recipe("feature_major")
    batches = [to_device(hb, dev) for hb in fm_host]
    state = init_train_state(model, 0, *opts, device=dev)
    step = make_train_step(model, *opts, row_layout=False)
    windows = []  # the least of three windows: transient host load drops out
    for _ in range(3):
        out = cs.timed_steps("deepfm-col", step, state, batches, cs.BATCH,
                             cs.FM_COL_PER_STEP, warmup=3, steps=steps)
        windows.append(out["ms_per_step"])
    res["deepfm_col_ms_per_step"] = min(windows)
    res["deepfm_col_windows"] = windows
    res["last_loss"] = out["last_loss"]
    # device time: the sum of the step's kernel times (torch.profiler), which
    # the host's launch overhead does not blur
    state = init_train_state(model, 0, *opts, device=dev)
    res["deepfm_col_device_ms_per_step"] = cs.profile_steps(step, state,
                                                            batches)
    print("AB " + json.dumps(res), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(args.one, args.steps)
        return 0
    if len(args.trees) != 2:
        ap.error("give two trees: OLD NEW")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    runs = []
    for t in range(args.turns):
        for tree in (args.trees if t % 2 == 0 else args.trees[::-1]):
            p = subprocess.run(
                [sys.executable, __file__, "--one", tree, "--steps",
                 str(args.steps)],
                capture_output=True, text=True, timeout=900)
            sys.stdout.write(p.stdout)
            sys.stderr.write(p.stderr[-4000:])
            if p.returncode != 0:
                print(f"ab_colpath: {tree} failed (rc {p.returncode})")
                return 1
            line = [x for x in p.stdout.splitlines() if x.startswith("AB ")][-1]
            runs.append(json.loads(line[3:]))
    for key in ("segsum_cols_DeepFM_ms", "segsum_cols_W&D_ms",
                "deepfm_col_ms_per_step", "deepfm_col_device_ms_per_step"):
        cols = [f"{tree}: " + ", ".join(f"{r[key]:.4f}" for r in runs
                                         if r["tree"] == tree)
                for tree in args.trees]
        print(f"[compare] {key} in turns: " + "; ".join(cols), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
