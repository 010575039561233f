#!/usr/bin/env python3
"""Time the column path, the sorted-sum path or the column gather and
updates of two trees of this repository in turns, in one run on one GPU.

    python3 tools/ab_colpath.py OLD_TREE NEW_TREE
        [--what colpath|sorted|cols_update|fused] [--turns 2] [--steps 20]

A tree is a checkout of the repository, e.g. a parent commit unpacked
with ``git archive`` under the git-ignored ``_cmp/``.  The trees run one
process each, in turns (OLD, NEW, NEW, OLD for two turns).  A process
imports its tree's ``chip_smoke.py`` and package, builds that tree's
kernels and prints one JSON line; the card's name and power limit come
first, a ``[compare]`` line per measure last.

``--what colpath`` (the default): ``segsum_cols`` timed with the tree's
own ``check_segsum_cols`` at the DeepFM and W&D feature-major shapes
(each tree's kernel takes the layout its step gives it), then 3 warm-up
and ``--steps`` timed steps (three times, keeping the least ms/step) of
the DeepFM recipe with ``table_layout="feature_major"`` and
``row_layout=False`` (phase 10 of ``chip_smoke.py``) and 5 more under
``torch.profiler`` for the device time per step (the sum of its kernels'
times: the step is bound by the host's launches, whose time varies
between processes).

``--what sorted``: the sorted segment-sum as each tree's step runs it, on
random bf16 batch-order gradients at the W&D ``[624000, 128]`` and the
multitable emb128 ``[393216, 256]``, emb64_single and multi ``[N, 128]``
shapes with host-prepared ``perm`` and ``uidx_sorted``: ``segsum_sorted(g,
uidx, n_out, perm=perm)`` where the tree's wrapper takes ``perm``, else
the gather ``g[perm.long()]`` and ``segsum_sorted`` of the sorted rows
(device time of the whole, by CUDA-graph replay); then the multitable
recipe's step (phase 6 of ``chip_smoke.py``) from a fresh state, 3
warm-up and ``--steps`` timed steps (ms/step and the last loss) and 5
steps under ``torch.profiler`` from another fresh state (device time per
step).

``--what cols_update``: ``gather_rows`` at every launch shape of the
multitable step (the 4 deep tables and the 4 folded wide tables, from
host batch 0's ids) and of the DeepFM ``row_layout=True`` step (fm and
the folded linear table), ``ftrl_cols`` at the 4 folded wide tables,
``adam_cols`` at its ``chip_smoke.py`` shapes (multitable emb128 with
float32 m/v, DeepFM fm and linear with bf16 m/v), each checked against
its plain version and timed by CUDA-graph replay (the updates with a
digest of their state); then the multitable
step as under ``--what sorted``.

``--what fused``: ``fused_adam_gather`` and ``fused_ftrl_gather`` at the
five launch shapes of ``chip_smoke.py`` (``fused_shapes``: W&D deep Adam,
W&D wide FTRL, DeepFM fm Adam, DeepFM linear Adam and FTRL; update from
batch 0's ids, gather of batch 1's), each checked against its plain
version and timed by CUDA-graph replay beside the separate update +
``gather_cols`` pair and each of the two alone, with a digest of the
updated state and rows (equal digests: bit-identical results).
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


def tree_modules(tree: str):
    """(the tree's chip_smoke, the chip_smoke.py beside this tool, device,
    generator), the tree's kernels built.  The data and the cases come
    from the chip_smoke.py beside this tool, so that both trees (also one
    older than its helpers) get the same shapes; its functions call the
    kernels and the step of the tree, whose package is imported first."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import importlib.util

    import torch

    import chip_smoke as cs

    spec = importlib.util.spec_from_file_location(
        "smoke_cases", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    dev = torch.device("cuda", 0)
    cs.phase_build()
    return cs, here, dev, torch.Generator(device=dev).manual_seed(0)


def mt_step(cs, res, model, opts, host, steps) -> None:
    """The tree's multitable step from a fresh state: 3 warm-up and
    ``steps`` timed steps (ms/step, last loss), then 5 steps under
    ``torch.profiler`` from another fresh state (device time per step)."""
    import torch

    from mindrec_tpu_torch.data.criteo import to_device
    from mindrec_tpu_torch.train.step import init_train_state, make_train_step

    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    batches = [to_device(hb, dev) for hb in host]
    step = make_train_step(model, *opts)
    state = init_train_state(model, 0, *opts, device=dev)
    out = cs.timed_steps("mt-main", step, state, batches, cs.MT_BATCH,
                         cs.MT_PER_STEP, warmup=3, steps=steps)
    res["mt_ms_per_step"] = out["ms_per_step"]
    res["last_loss"] = out["last_loss"]
    state = init_train_state(model, 0, *opts, device=dev)
    res["mt_device_ms_per_step"] = cs.profile_steps(step, state, batches)


def one_sorted(tree: str, steps: int) -> None:
    import inspect

    import torch

    cs, here, dev, gen = tree_modules(tree)
    takes_perm = "perm" in inspect.signature(cs.segsum_sorted).parameters
    model, opts, host, buckets = here.mt_setup()
    _data, bucket, wd_host = here.wd_setup()
    res = {"tree": tree, "takes_perm": takes_perm}
    for tag, u, p, rows, d, n_out in here.sorted_cases(
            dev, wd=(wd_host, bucket), mt=(host[0], buckets)):
        g = torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16)
        if takes_perm:
            res[f"sorted_{tag}_ms"] = cs.graph_ms(
                lambda: cs.segsum_sorted(g, u, n_out, perm=p))
        else:
            res[f"sorted_{tag}_ms"] = cs.graph_ms(
                lambda: cs.segsum_sorted(g[p.long()], u, n_out))
        del g
    mt_step(cs, res, model, opts, host, steps)
    print("AB " + json.dumps(res), flush=True)


def one_fused(tree: str, steps: int) -> None:
    import torch

    cs, here, dev, gen = tree_modules(tree)
    wd_host = here.criteo_host_batches(here.VOCAB, 2)
    fm_host = here.criteo_host_batches(here.FM_VOCAB, 2)
    res = {"tree": tree}
    for tag, kind, shape, fold, ids_u, ids_g in here.fused_shapes(fm_host,
                                                                 wd_host):
        torch.cuda.empty_cache()
        out = here.check_fused(tag, dev, gen, kind, shape, fold, ids_u, ids_g)
        for f in ("ms", "separate_kernels_ms", "update_kernel_ms",
                  "gather_kernel_ms", "digest"):
            res[f"{kind} {tag} {f}"] = out[f]
    print("AB " + json.dumps(res), flush=True)


def one_cols_update(tree: str, steps: int) -> None:
    import torch

    cs, here, dev, gen = tree_modules(tree)
    model, opts, host, buckets = here.mt_setup()
    res = {"tree": tree}
    for case in here.table_launches(dev, model, host[0]):
        name = case["name"]
        res[f"gather_{name}_ms"] = here.check_gather_launch(
            dev, gen, "multitable", case)["ms"]
        if case["fold"] > 1:
            out = here.check_ftrl_launch(dev, gen, "multitable", case)
            res[f"ftrl_{name}_ms"] = out["ms"]
            res[f"ftrl_{name}_digest"] = out["digest"]
        torch.cuda.empty_cache()
    fm_model, _ = here.deepfm_recipe("feature_major")
    fm_host = here.criteo_host_batches(here.FM_VOCAB, 1)[0]
    fm_rows = {**fm_host, "uq_ids": fm_host["uq_ids"][:here.FM_BUCKET]}
    for case in here.table_launches(dev, fm_model, fm_rows):
        res[f"gather_fm_{case['name']}_ms"] = here.check_gather_launch(
            dev, gen, "DeepFM row_layout=True", case)["ms"]
    ub = buckets["emb128"]
    uq = torch.full((ub,), here.SENTINEL, dtype=torch.int32, device=dev)
    ids = host[0]["emb128:uq_ids"][:ub]
    uq[:ids.size] = torch.from_numpy(ids).to(dev)
    out = here.check_adam_cols(
        "emb128, f32 m/v", dev, gen, model.specs["emb128"].storage_shape, 1,
        uq, None, torch.float32, eps=1e-6, loss_scale=1000.0)
    res["adam_emb128_ms"], res["adam_emb128_digest"] = out["ms"], out["digest"]
    for tag, spec, fold in (("fm", fm_model.v_spec, 1),
                            ("linear", fm_model.w_spec, 8)):
        out = here.check_adam_cols(
            f"DeepFM {tag}, bf16 m/v", dev, gen, spec.storage_shape, fold,
            *here.padded_cols(fm_host["uq_ids"], fold, dev), torch.bfloat16,
            eps=5e-8, loss_scale=1024.0)
        res[f"adam_{tag}_ms"], res[f"adam_{tag}_digest"] = (out["ms"],
                                                          out["digest"])
    mt_step(cs, res, model, opts, host, steps)
    print("AB " + json.dumps(res), flush=True)


KEYS = {
    "colpath": ("segsum_cols_DeepFM_ms", "segsum_cols_W&D_ms",
                "deepfm_col_ms_per_step", "deepfm_col_device_ms_per_step"),
    "sorted": ("sorted_W&D_ms", "sorted_emb128_ms", "sorted_emb64_single_ms",
               "sorted_multi_ms", "mt_ms_per_step", "mt_device_ms_per_step",
               "last_loss"),
    "cols_update": None,  # every measure the runs print
    "fused": None,
}
ONE = {"colpath": one, "sorted": one_sorted, "cols_update": one_cols_update,
       "fused": one_fused}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--what", choices=sorted(KEYS), default="colpath")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        ONE[args.what](args.one, args.steps)
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
                 str(args.steps), "--what", args.what],
                capture_output=True, text=True, timeout=900)
            sys.stdout.write(p.stdout)
            sys.stderr.write(p.stderr[-4000:])
            if p.returncode != 0:
                print(f"ab_colpath: {tree} failed (rc {p.returncode})")
                return 1
            line = [x for x in p.stdout.splitlines() if x.startswith("AB ")][-1]
            runs.append(json.loads(line[3:]))
    for key in KEYS[args.what] or [k for k in runs[0] if k != "tree"]:
        cols = [f"{tree}: " + ", ".join(f"{r[key]!r}" for r in runs
                                         if r["tree"] == tree)
                for tree in args.trees]
        print(f"[compare] {key} in turns: " + "; ".join(cols), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
