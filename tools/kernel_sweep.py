#!/usr/bin/env python3
"""Time ``adam_cols_from_sums``, ``segsum_unsorted``, ``segsum_cols``,
``segsum_sorted``, ``gather_rows``, ``ftrl_cols`` or the fused update +
gather at the recipes' shapes with the kernels' code changed, on one GPU.

Run from the repository root::

    python3 tools/kernel_sweep.py cols base t128:'kSlots = 256;=>kSlots = 128;'
    python3 tools/kernel_sweep.py seg base c512:'kUChunk = 256;=>kUChunk = 512;'
    python3 tools/kernel_sweep.py colsum base l4:'kCLoads = 8;=>kCLoads = 4;'
    python3 tools/kernel_sweep.py sorted base r16:'kSRows = 8;=>kSRows = 16;'
    python3 tools/kernel_sweep.py gather base n4:'kNarrowSlots = 2;=>kNarrowSlots = 4;'
    python3 tools/kernel_sweep.py gather base q2:'kQuads = 4;=>kQuads = 2;'
    python3 tools/kernel_sweep.py ftrl base b1k:'kFoldBlocks = 2048;=>kFoldBlocks = 1024;'
    python3 tools/kernel_sweep.py fused base g128:'kGat = 256;=>kGat = 128;'
    python3 tools/kernel_sweep.py assemble base f4:'kFwdBlocks = 5=>kFwdBlocks = 4'
    python3 tools/kernel_sweep.py fused --time-only base \
        nogather:'gather_round(opt.table,=>if (0) gather_round(opt.table,;;gather_round(table, vc,=>if (0) gather_round(table, vc,'

Each variant ``name[:old=>new[;;old=>new...]]`` is a copy of the package
under the git-ignored ``_cmp/sweep_<name>/`` with the plain-text
replacements made in ``csrc/*``; it is built and measured in a process
of its own by ``chip_smoke.py``'s functions: ``cols`` - ``check_adam_cols``
(kernel against plain version, device time by CUDA-graph replay) at the
multitable emb128, both DeepFM and both W&D feature-major shapes;
``seg`` - ``segsum_unsorted`` at the indicator group's [N, 128] bf16 and
[N, 1] shapes, with the device time of each of its passes
(``torch.profiler``); ``colsum`` - ``segsum_cols`` at the DeepFM [88, N]
and W&D [24, N] feature-major shapes (bf16, as the view of [N, D]), with
the device time of each pass; ``sorted`` - ``segsum_sorted`` through
``perm`` at the W&D [N, 128] and the multitable emb128 [N, 256],
emb64_single and multi [N, 128] shapes (bf16, batch-order rows, with
``chip_smoke.check_sorted``), with the device time of each pass;
``gather`` - ``gather_rows`` at every launch shape of the multitable step
and of the DeepFM ``row_layout=True`` step (``check_gather_launch``:
kernel against plain version, device time, bounds); ``ftrl`` -
``ftrl_cols_from_sums`` at the multitable step's four folded wide tables
(``check_ftrl_launch``); ``fused`` - ``fused_adam_gather`` and
``fused_ftrl_gather`` at the five launch shapes of ``chip_smoke.py``
(``check_fused``: kernel against plain version, device time beside the
separate update + ``gather_cols`` pair and each alone); ``assemble`` -
the feature assembly's forward and backward kernels on the groups one
multitable recipe step hands the model (``check_assemble``: against the
plain version, device time beside the byte bounds).  ``--time-only``
(``gather``, ``ftrl`` and ``fused``) times the launches without holding
them to the plain versions, for variants that leave a pass out, to
account for a kernel's time by pass.
Compare variants only within one run.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def time_launch(cs, dev, gen, what, case) -> None:
    """Device time of ``gather_rows`` or (folded tables) ``ftrl_cols`` at
    one launch shape, unchecked: for variants that leave out a pass."""
    import torch

    dp, vc = case["shape"]
    cols, fold = case["cols"], case["fold"]
    if what == "gather":
        table = torch.randn((dp, vc), generator=gen, device=dev)
        buf = torch.zeros((cols.numel(), case["width"]), device=dev)
        ms = cs.graph_ms(lambda: cs.gather_rows(table, cols, buf, case["off"]))
    elif fold > 1:
        sub = case["sub"]
        grads = cs.step_sums(dev, gen, dp, fold, cols, sub, case["off"],
                             case["width"], case["rows"])
        gate = None if case["gate"] is None else case["gate"].reshape(-1)
        st = [torch.rand((dp, vc), generator=gen, device=dev) for _ in range(3)]
        ms = cs.graph_ms(lambda: cs.ftrl_cols_from_sums(
            *st, cols, grads, sub, gate, dim=1, fold=fold))
    else:
        return
    cs.log(f"[sweep] {what} {case['name']} [{dp}, {vc}] n {cols.numel()}, "
           f"unchecked: {ms:.5f} ms")


def time_fused(cs, dev, gen, tag, kind, shape, fold, ids_u, ids_g) -> None:
    """Device time of a fused update + gather at one launch shape,
    unchecked: for variants that leave out a pass."""
    import torch

    cols_u, sub_u = cs.padded_cols(ids_u, fold, dev)
    cols_g, _ = cs.padded_cols(ids_g, fold, dev)
    state, hyper, lr_t = cs.fused_case(dev, gen, kind, shape, fold,
                                       torch.bfloat16)
    aug = cs.slot_grads(dev, gen, shape[0], fold, cols_u, sub_u)
    fused = cs.fused_calls(kind, lr_t)[0]
    ms = cs.graph_ms(lambda: fused(state, cols_u, aug, cols_g, **hyper))
    cs.log(f"[sweep] fused_{kind}_gather {tag} {list(shape)} fold {fold}, "
           f"unchecked: {ms:.5f} ms")


def measure(what: str, time_only: bool = False) -> None:
    """Runs in a variant's directory (its chip_smoke.py and package)."""
    sys.path.insert(0, ".")
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cs._build.library()

    def passes(tag, call):
        cs.log(f"[sweep] {tag}: {cs.graph_ms(call):.4f} ms")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
                cs.log(f"[sweep] {us / 10:9.2f} us  {e.key[:90]}")

    if what == "assemble":
        cs.check_assemble(dev)
        return
    if what == "colsum":
        data = cs.SyntheticCriteo(cs.BATCH, cs.FIELDS, cs.VOCAB, steps=1,
                                  seed=0, fields="criteo")
        for tag, d, host in (
                ("DeepFM", 88, cs.criteo_host_batches(cs.FM_VOCAB, 1)[0]),
                ("W&D", 24, cs.make_batch_sort(cs.FIELDS, minimal=True)(
                    data.get_batch(0)))):
            uidx = torch.from_numpy(host["uidx_sorted"]).to(dev)
            n = uidx.numel()
            rows = torch.randn((n, d), generator=gen,
                               device=dev).to(torch.bfloat16)
            cs.check_segsum_cols(tag, dev, gen, d, uidx)  # checked, timed
            passes(f"segsum_cols {tag} [{d}, {n}] bf16",
                   lambda: cs.segsum_cols(rows.T, uidx, n))
        return
    if what == "fused":
        wd_host = cs.criteo_host_batches(cs.VOCAB, 2)
        fm_host = cs.criteo_host_batches(cs.FM_VOCAB, 2)
        for case in cs.fused_shapes(fm_host, wd_host):
            torch.cuda.empty_cache()
            if time_only:
                time_fused(cs, dev, gen, *case)
            else:
                cs.check_fused(case[0], dev, gen, *case[1:])
        return
    model, _opts, host, buckets = cs.mt_setup(steps=1)
    if what in ("gather", "ftrl"):
        for case in cs.table_launches(dev, model, host[0]):
            if time_only:
                time_launch(cs, dev, gen, what, case)
            elif what == "gather":
                cs.check_gather_launch(dev, gen, "multitable", case)
            elif case["fold"] > 1:
                cs.check_ftrl_launch(dev, gen, "multitable", case)
        if what == "gather" and not time_only:
            fm, _ = cs.deepfm_recipe("feature_major")
            fm_uq = cs.criteo_host_batches(cs.FM_VOCAB, 1)[0]
            fm_uq = {**fm_uq, "uq_ids": fm_uq["uq_ids"][:cs.FM_BUCKET]}
            for case in cs.table_launches(dev, fm, fm_uq):
                cs.check_gather_launch(dev, gen, "DeepFM row_layout=True",
                                       case)
        return
    if what == "sorted":
        _data, bucket, wd_host = cs.wd_setup()
        for case in cs.sorted_cases(dev, wd=(wd_host, bucket),
                                    mt=(host[0], buckets)):
            tag, u, p, rows, d, n_out = case
            cs.check_sorted(dev, gen, case)  # checked, timed
            g = torch.randn((rows, d), generator=gen,
                            device=dev).to(torch.bfloat16)
            passes(f"segsum_sorted {tag} [{rows}, {d}] bf16 -> [{d}, {n_out}]",
                   lambda: cs.segsum_sorted(g, u, n_out, perm=p))
            del g
            torch.cuda.empty_cache()
        return
    if what == "cols":
        ub = buckets["emb128"]
        uq = torch.from_numpy(host[0]["emb128:uq_ids"][:ub]).to(dev)
        uq = torch.cat([uq, uq.new_full((ub - uq.numel(),), cs.SENTINEL)])
        fm = cs.DeepFMModel(cs.DeepFMConfig(
            vocab_size=cs.FM_VOCAB, sparse=True, table_layout="feature_major"))
        wd = cs.WideDeepModel(cs.WideDeepConfig(
            vocab_size=cs.VOCAB, emb_dim=cs.EMB, sparse=True,
            table_layout="feature_major"))
        fm_uq = cs.criteo_host_batches(cs.FM_VOCAB, 1)[0]["uq_ids"]
        data = cs.SyntheticCriteo(cs.BATCH, cs.FIELDS, cs.VOCAB, steps=1,
                                  seed=0, fields="criteo")
        wd_uq = cs.make_batch_sort(cs.FIELDS, minimal=True)(
            data.get_batch(0))["uq_ids"]
        cases = [("emb128, f32 m/v", model.specs["emb128"].storage_shape, 1,
                  (uq, None), torch.float32, 1e-6, 1000.0)]
        for tag, spec, fold, ids in (("DeepFM fm", fm.v_spec, 1, fm_uq),
                                     ("DeepFM linear", fm.w_spec, 8, fm_uq),
                                     ("W&D deep", wd.deep_spec, 1, wd_uq),
                                     ("W&D wide", wd.wide_spec, 8, wd_uq)):
            cases.append((tag + ", bf16 m/v", spec.storage_shape, fold,
                          cs.padded_cols(ids, fold, dev), torch.bfloat16,
                          5e-8, 1024.0))
        for tag, shape, fold, cols_sub, sd, eps, scale in cases:
            for _ in range(2):  # the second reading is the warm one
                cs.check_adam_cols(tag, dev, gen, shape, fold, *cols_sub, sd,
                                   eps=eps, loss_scale=scale)
        return
    seg = torch.from_numpy(np.ascontiguousarray(
        host[0]["indicator_id"].reshape(-1))).to(dev)
    for d in (128, 1):
        g = torch.randn((seg.numel(), d), generator=gen,
                        device=dev).to(torch.bfloat16)
        passes(f"segsum_unsorted [{seg.numel()}, {d}] bf16",
               lambda: cs.segsum_unsorted(g, seg, 2048))


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--measure":
        measure(sys.argv[2], "--time-only" in sys.argv)
        return 0
    time_only = "--time-only" in sys.argv
    if time_only:
        sys.argv.remove("--time-only")
    if len(sys.argv) < 3 or sys.argv[1] not in ("cols", "seg", "colsum",
                                                   "sorted", "gather", "ftrl",
                                                   "fused", "assemble"):
        print(__doc__, file=sys.stderr)
        return 2
    sources = "".join(f.read_text()
                      for f in (ROOT / "mindrec_tpu_torch" / "csrc").iterdir())
    for variant in sys.argv[2:]:  # every edit must apply before any run
        for edit in filter(None, variant.partition(":")[2].split(";;")):
            if edit.partition("=>")[0] not in sources:
                print(f"variant {variant.partition(':')[0]}: "
                      f"{edit.partition('=>')[0]!r} not found", file=sys.stderr)
                return 2
    for variant in sys.argv[2:]:
        name, _, edits = variant.partition(":")
        work = ROOT / "_cmp" / f"sweep_{name}"
        shutil.rmtree(work, ignore_errors=True)
        shutil.copytree(ROOT / "mindrec_tpu_torch", work / "mindrec_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", work)
        for edit in filter(None, edits.split(";;")):
            old, _, new = edit.partition("=>")
            for src in (work / "mindrec_tpu_torch" / "csrc").iterdir():
                src.write_text(src.read_text().replace(old, new))
        print(f"=== variant {name} ({edits or 'as committed'})", flush=True)
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--measure", sys.argv[1]]
                       + ["--time-only"] * time_only, cwd=work, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
