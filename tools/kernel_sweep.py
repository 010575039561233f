#!/usr/bin/env python3
"""Time ``adam_cols``, ``segsum_unsorted``, ``segsum_cols`` or
``segsum_sorted`` at the recipes' shapes with the kernels' constants
changed, on one GPU.

Run from the repository root::

    python3 tools/kernel_sweep.py cols base sub4:'kSub = 2;=>kSub = 4;'
    python3 tools/kernel_sweep.py seg base c512:'kUChunk = 256;=>kUChunk = 512;'
    python3 tools/kernel_sweep.py colsum base l4:'kCLoads = 8;=>kCLoads = 4;'
    python3 tools/kernel_sweep.py sorted base r16:'kSRows = 8;=>kSRows = 16;'

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
``chip_smoke.check_sorted``), with the device time of each pass.
Compare variants only within one run.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(what: str) -> None:
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
    model, _opts, host, buckets = cs.mt_setup(steps=1)
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
        measure(sys.argv[2])
        return 0
    if len(sys.argv) < 3 or sys.argv[1] not in ("cols", "seg", "colsum",
                                                   "sorted"):
        print(__doc__, file=sys.stderr)
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
            hits = 0
            for src in (work / "mindrec_tpu_torch" / "csrc").iterdir():
                text = src.read_text()
                hits += text.count(old)
                src.write_text(text.replace(old, new))
            if hits == 0:
                print(f"variant {name}: {old!r} not found", file=sys.stderr)
                return 2
        print(f"=== variant {name} ({edits or 'as committed'})", flush=True)
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--measure", sys.argv[1]], cwd=work, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
