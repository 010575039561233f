#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mindrec_tpu_torch``) on one GPU.

Run from the repository root on a machine with one NVIDIA H100 (the
kernels are built for ``sm_90a``)::

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card's name and power limit, build the CUDA kernels from
   ``mindrec_tpu_torch/csrc`` and print the build time;
2. hold each kernel against its plain PyTorch version on the card at the
   benchmark recipe's shapes (the segment-sum on a real synthetic Criteo
   batch's ``uidx_sorted``, LazyAdam on the full deep table with bf16
   m/v, FTRL on the full wide table), and time kernel, plain version and,
   where one exists, a single PyTorch call computing the same function;
3. drive the train step at the recipe's full width (batch 16000 x 39,
   vocab 5.86M, emb 16, 7x1024 bf16 MLP, FTRL + LazyAdam with bf16 m/v,
   host-prepared batches, the x1.2 unique bucket): 3 warm-up and 10 timed
   steps, with the launch counters set to 0 just before and read just
   after; every kernel must have launched at least once per step and
   every loss must be finite;
4. take 3 steps of a small model with the kernels and 3 with the plain
   versions from one state and compare losses, tables and optimizer
   state.

``--profile`` adds the device time by kernel over 5 more steps of
phase 3.  It prints a ``{"kernels": [...]}`` JSON line before the last line and
ends with ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from mindrec_tpu_torch.data.criteo import SyntheticCriteo, to_device
from mindrec_tpu_torch.data.pipeline import AdaptiveBucket
from mindrec_tpu_torch.models.wide_deep import WideDeepConfig, WideDeepModel
from mindrec_tpu_torch.ops import kernels
from mindrec_tpu_torch.ops.kernels import _build
from mindrec_tpu_torch.ops.kernels.segsum import segsum_sorted, segsum_sorted_plain
from mindrec_tpu_torch.ops.kernels.update_rows import (
    adam_rows, adam_rows_plain, ftrl_rows, ftrl_rows_plain,
)
from mindrec_tpu_torch.train import optim
from mindrec_tpu_torch.train.step import (
    SENTINEL, init_train_state, make_batch_sort, make_train_step,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BATCH, FIELDS, VOCAB, EMB = 16000, 39, 5_860_000, 16
REPLACES = {
    "segsum_sorted": "mindrec_tpu/ops/pallas/stream_segsum.py:222",
    "adam_rows": "mindrec_tpu/ops/pallas/stream_update_rows.py:285",
    "ftrl_rows": "mindrec_tpu/ops/pallas/stream_update_rows.py:338",
}
SOURCES = {
    "segsum_sorted": "mindrec_tpu_torch/csrc/segsum.cu",
    "adam_rows": "mindrec_tpu_torch/csrc/update_rows.cu",
    "ftrl_rows": "mindrec_tpu_torch/csrc/update_rows.cu",
}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_errs(pairs) -> tuple[float, float]:
    """Max absolute and relative difference over (kernel, plain) pairs."""
    ab = rel = 0.0
    for x, y in pairs:
        d = (x.float() - y.float()).abs()
        ab = max(ab, d.max().item())
        rel = max(rel, (d / y.float().abs().clamp_min(1e-30)).max().item())
    return ab, rel


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def phase_build() -> None:
    t0 = time.perf_counter()
    path = _build.build()
    log(f"[build] {path} in {time.perf_counter() - t0:.1f} s")
    for line in (path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("[build]", line.strip())
    _build.library()


def phase_kernels(dev, gen, host_batch, bucket) -> dict:
    """Each kernel against its plain version at the recipe's shapes."""
    res = {}
    uidx = torch.from_numpy(host_batch["uidx_sorted"]).to(dev)
    n = uidx.numel()
    n_out = bucket

    # -- segsum: g [N, 128] bf16, the step's per-position gradients ------
    g = torch.randn((n, 128), generator=gen, device=dev).to(torch.bfloat16)
    got = segsum_sorted(g, uidx, n_out)
    want = segsum_sorted_plain(g, uidx, n_out)
    # two float32 sums of the same n_u terms differ by at most
    # 2 * n_u * 2**-24 * sum|g| (the plain version sums with atomics)
    counts = torch.bincount(uidx.long(), minlength=n_out)[:n_out].float()
    absum = segsum_sorted_plain(g.abs(), uidx, n_out)
    tol = 2.0 * counts[None, :] * 2.0**-24 * absum
    err = (got - want).abs()
    if not bool((err <= tol).all()):
        fail(f"segsum_sorted disagrees: max err {err.max().item()}")
    ui_long = uidx.long()
    lib_out = torch.zeros((n_out, 128), device=dev)
    gf = g.float()
    t_b, by = bound(n * 128 * 2 + n * 4 + 128 * n_out * 4, n * 128)
    res["segsum_sorted"] = dict(
        max_abs_err=err.max().item(),
        max_rel_err=(err / want.abs().clamp_min(1e-30)).max().item(),
        ms=cuda_ms(lambda: segsum_sorted(g, uidx, n_out), 20),
        plain_ms=cuda_ms(lambda: segsum_sorted_plain(g, uidx, n_out), 5),
        bound_ms=t_b, bound_by=by,
        library_ms=cuda_ms(lambda: lib_out.index_add_(0, ui_long, gf), 10),
    )
    log("[kernel] segsum_sorted", json.dumps(res["segsum_sorted"]))
    del g, gf, absum, got, want, err, tol, lib_out

    # -- the unique slots of this batch, padded to the bucket -----------
    uq = torch.from_numpy(host_batch["uq_ids"][:bucket]).to(dev)
    if uq.numel() < bucket:
        uq = torch.cat([uq, uq.new_full((bucket - uq.numel(),), SENTINEL)])

    def slots(pack, n_rows):
        rows = torch.div(uq, pack, rounding_mode="floor")
        return rows, torch.remainder(uq, pack), int((rows < n_rows).sum())

    # -- LazyAdam on the full deep table, bf16 m/v ----------------------
    pack, dim, n_rows = 8, EMB, 733184
    rows, sub, valid = slots(pack, n_rows)
    table = 0.01 * torch.randn((n_rows, 128), generator=gen, device=dev)
    m = (1e-3 * torch.randn((n_rows, 128), generator=gen, device=dev)).to(torch.bfloat16)
    v = (1e-6 * torch.rand((n_rows, 128), generator=gen, device=dev)).to(torch.bfloat16)
    gs = 10.0 * torch.randn((bucket, dim), generator=gen, device=dev)
    lr_t = torch.tensor(1e-3, device=dev)
    hyper = dict(dim=dim, pack=pack, loss_scale=1024.0)
    a = [table.clone(), m.clone(), v.clone()]
    b = [table.clone(), m.clone(), v.clone()]
    adam_rows(*a, rows, sub, gs, lr_t, **hyper)
    adam_rows_plain(*b, rows, sub, gs, lr_t, **hyper)
    err, rel = max_errs(zip(a, b))
    # same float32 operations, no contraction: equal to rounding
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
    t_b, by = bound(bucket * (8 + dim * 4) + valid * dim * 2 * (4 + 2 + 2),
                    valid * dim * 12)
    res["adam_rows"] = dict(
        max_abs_err=err, max_rel_err=rel,
        ms=cuda_ms(lambda: adam_rows(*a, rows, sub, gs, lr_t, **hyper), 20),
        plain_ms=cuda_ms(lambda: adam_rows_plain(*b, rows, sub, gs, lr_t, **hyper), 5),
        bound_ms=t_b, bound_by=by, library_ms=None,
    )
    log("[kernel] adam_rows", json.dumps(res["adam_rows"]))
    del table, m, v, a, b

    # -- FTRL on the full wide table ------------------------------------
    pack, dim, n_rows = 128, 1, 47104
    rows, sub, valid = slots(pack, n_rows)
    table = 0.01 * torch.randn((n_rows, 128), generator=gen, device=dev)
    accum = 1.0 + torch.rand((n_rows, 128), generator=gen, device=dev)
    linear = 0.1 * torch.randn((n_rows, 128), generator=gen, device=dev)
    gs = 10.0 * torch.randn((bucket, dim), generator=gen, device=dev)
    hyper = dict(dim=dim, pack=pack, loss_scale=1024.0)
    a = [table.clone(), accum.clone(), linear.clone()]
    b = [table.clone(), accum.clone(), linear.clone()]
    ftrl_rows(*a, rows, sub, gs, **hyper)
    ftrl_rows_plain(*b, rows, sub, gs, **hyper)
    err, rel = max_errs(zip(a, b))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
    t_b, by = bound(bucket * (8 + dim * 4) + valid * dim * 2 * 12,
                    valid * dim * 16)
    res["ftrl_rows"] = dict(
        max_abs_err=err, max_rel_err=rel,
        ms=cuda_ms(lambda: ftrl_rows(*a, rows, sub, gs, **hyper), 20),
        plain_ms=cuda_ms(lambda: ftrl_rows_plain(*b, rows, sub, gs, **hyper), 5),
        bound_ms=t_b, bound_by=by, library_ms=None,
    )
    log("[kernel] ftrl_rows", json.dumps(res["ftrl_rows"]))
    torch.cuda.synchronize()
    return res


def profile_steps(step, state, batches, n=5):
    """Device time by CUDA kernel over ``n`` steps (torch.profiler), per
    step.  The profiler slows the host, so the busy share is read against
    the unprofiled step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            state, _ = step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        rows.append((dev_us / 1e3 / n, e.count / n, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[profile] {n} steps: kernels {busy:.4f} ms/step in "
        f"{sum(r[1] for r in rows):.0f} launches/step")
    for ms, cnt, name in rows[:20]:
        log(f"[profile] {ms:9.4f} ms/step  x{cnt:<5.1f} {name[:90]}")
    return busy


def phase_main_path(dev, data, bucket, warmup=3, steps=10,
                    profile=False) -> dict:
    """The train step at the benchmark recipe's full width."""
    cfg = WideDeepConfig(
        batch_size=BATCH, field_size=FIELDS, vocab_size=VOCAB, emb_dim=EMB,
        deep_layer_dim=(1024,) * 7, use_mixed_precision=True, sparse=True,
        loss_scale=1024.0,
    )
    model = WideDeepModel(cfg)
    opt_w = optim.ftrl(loss_scale=cfg.loss_scale)
    opt_d = optim.lazy_adam(loss_scale=cfg.loss_scale,
                            state_dtype=torch.bfloat16)
    state = init_train_state(model, 0, opt_w, opt_d, device=dev)
    prep = make_batch_sort(FIELDS, unique_bucket=bucket, minimal=True)
    host = []
    for s in range(len(data)):
        hb = prep(data.get_batch(s))
        hb["uq_ids"] = hb["uq_ids"][:bucket]  # the step's static bucket
        host.append(hb)
    batches = [to_device(hb, dev) for hb in host]
    step = make_train_step(model, opt_w, opt_d)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses = []
    kernels.reset_launches()
    for i in range(warmup):
        state, (_lw, ld) = step(state, batches[i % len(batches)])
        losses.append(ld)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        state, (_lw, ld) = step(state, batches[(warmup + i) % len(batches)])
        losses.append(ld)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    losses = torch.stack(losses).float().cpu().numpy()
    out = dict(
        samples_per_s=steps * BATCH / dt, ms_per_step=dt / steps * 1e3,
        steps=warmup + steps, bucket=bucket,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        launches=launches, first_loss=float(losses[0]),
        last_loss=float(losses[-1]),
    )
    log("[main]", json.dumps(out))
    if not np.isfinite(losses).all():
        fail(f"non-finite losses {losses}")
    for k, n in launches.items():
        if n < warmup + steps:
            fail(f"kernel {k} launched {n} times in {warmup + steps} steps")
    if profile:
        busy = profile_steps(step, state, batches)
        log(f"[profile] device busy share {busy / out['ms_per_step']:.3f} "
            f"of the unprofiled {out['ms_per_step']:.3f} ms/step")
    return out


def phase_kernel_vs_plain_step(dev) -> None:
    """3 steps with the kernels and 3 with the plain versions, one state."""
    cfg = WideDeepConfig(
        batch_size=512, field_size=FIELDS, vocab_size=100_000, emb_dim=EMB,
        deep_layer_dim=(256, 256), use_mixed_precision=True, sparse=True,
        loss_scale=1024.0,
    )
    model = WideDeepModel(cfg)
    opt_w = optim.ftrl(loss_scale=1024.0)
    opt_d = optim.lazy_adam(loss_scale=1024.0, state_dtype=torch.bfloat16)
    sa = init_train_state(model, 1, opt_w, opt_d, device=dev)
    sb = init_train_state(model, 1, opt_w, opt_d, device=dev)
    fa = make_train_step(model, opt_w, opt_d)
    fb = make_train_step(model, opt_w, opt_d, use_kernels=False)
    data = SyntheticCriteo(512, FIELDS, 100_000, seed=11, fields="criteo")
    for i in range(3):
        batch = to_device(data.get_batch(i), dev)
        sa, (_, la) = fa(sa, batch)
        sb, (_, lb) = fb(sb, batch)
        torch.testing.assert_close(la, lb, rtol=1e-5, atol=0)
    # only the segment sums differ (the plain one adds with atomics), by
    # float32 rounding; a bf16 moment may round to its neighbour
    pairs = [("deep table", sa.params["deep"]["table"], sb.params["deep"]["table"]),
             ("wide table", sa.params["wide"]["table"], sb.params["wide"]["table"]),
             ("accum", sa.opt_w["wide/table"]["accum"], sb.opt_w["wide/table"]["accum"]),
             ("linear", sa.opt_w["wide/table"]["linear"], sb.opt_w["wide/table"]["linear"])]
    for name, x, y in pairs:
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-6, msg=name)
    for k in ("m", "v"):
        x, y = sa.opt_d["deep/table"][k], sb.opt_d["deep/table"][k]
        torch.testing.assert_close(x.float(), y.float(), rtol=2.0**-7,
                                   atol=1e-6, msg=k)
    log("[check] kernel step == plain step over 3 steps")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the timed steps, print the device time by "
                    "kernel over 5 more steps (torch.profiler)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    phase_build()

    data = SyntheticCriteo(BATCH, FIELDS, VOCAB, steps=8, seed=0,
                           fields="criteo")
    bucket = AdaptiveBucket.from_sample(
        [data.get_batch(s) for s in range(len(data))]).bucket
    host0 = make_batch_sort(FIELDS)(data.get_batch(0))
    log(f"[data] bucket {bucket}, batch 0 has "
        f"{int(host0['uidx_sorted'][-1]) + 1} distinct ids")
    gen = torch.Generator(device=dev).manual_seed(0)
    res = phase_kernels(dev, gen, host0, bucket)
    torch.cuda.empty_cache()
    main_path = phase_main_path(dev, data, bucket, profile=args.profile)
    torch.cuda.empty_cache()
    phase_kernel_vs_plain_step(dev)

    rows = [
        {"name": k, "route": "cuda", "source": SOURCES[k],
         "replaces": REPLACES[k], "launches": main_path["launches"][k],
         **{f: res[k][f] for f in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}}
        for k in ("segsum_sorted", "adam_rows", "ftrl_rows")
    ]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
