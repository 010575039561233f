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
   then both updates again on bf16 tables (the bf16-table bench extra);
3. drive the train step at the recipe's full width (batch 16000 x 39,
   vocab 5.86M, emb 16, 7x1024 bf16 MLP, FTRL + LazyAdam with bf16 m/v,
   host-prepared batches, the x1.2 unique bucket): 3 warm-up and 10 timed
   steps, with the launch counters set to 0 just before the timed steps
   and read just after; every kernel must have launched at least once per
   step and every loss must be finite;
4. take 3 steps of a small model with the kernels and 3 with the plain
   versions from one state and compare losses, tables and optimizer
   state;
5. the multitable (Outbrain) recipe's kernels against their plain
   versions on a real synthetic batch after host prep: the gather of the
   emb128 group's feature-major tables into its [ub, 256] buffer (timed
   beside its sector bound and the time of reading the table whole and
   writing the valid lanes; the folded w128 launch timed too), the
   unsorted segment-sum of the indicator group's [1.7M, 128] bf16
   gradient and its [1.7M, 1] presence counts, the sorted segment-sum of
   the emb128 group's [N, 256] and the multi group's [N, 128] gradients
   (segment sums held against a float64 sum), LazyAdam on emb128 with
   f32 m/v and FTRL on the folded w128; the unsorted segment-sum again at
   D = 1, D = 13 (bf16), D = 20 and D = 128 (f32) with ids outside
   [0, n_out) mixed in, against the float64 sum and the exact sum of
   small integers;
6. drive the multitable step at the recipe's full width (batch 131072,
   the eight feature-major tables at reference vocab and width, 5x1024
   bf16 MLP, FTRL + LazyAdam, host prep with multi-group compaction and
   x1.2 buckets): 3 warm-up and 10 timed steps, the launch counters set
   to 0 just before the timed steps and read just after; every kernel of
   the path must have launched its per-step count every step and every
   loss must be finite; the same step with the plain versions is timed
   beside it, in turns (the ``[compare]`` line);
7. take 3 steps of a small multitable model (two tiny and two sorted id
   groups) with the kernels and 3 with the plain versions from one state
   and compare losses, the eight tables and their optimizer state;
8. the feature-major path's kernels against their plain versions at the
   DeepFM recipe's feature-major shapes (fm [80, 188416], linear
   [8, 23552] fold 8, N = 624,000 positions, 88 feature rows) and at the
   W&D recipe's ([16, 5.86M], [8, 733k] fold 8, 24 feature rows):
   the column gather (exact), the column Adam as the DeepFM steps launch
   it (bf16 m/v over the sentinel-padded N slots, fold 1 and fold 8), the
   column-major segment-sum on the transposed view of a contiguous
   [N, D] gradient, as the step passes it (against a float64 sum, at
   these shapes and at edge shapes: D 1, 5, 24, 88, hot ids over several
   tiles, runs ending at tile edges, segments past n_out), and the fused
   LazyAdam / FTRL update + next-batch
   gather (state to rounding, rows exact), each timed beside its plain
   version, a single PyTorch call where one exists, and for the fused
   kernels the separate update and gather kernels;
9. the fused pump at the W&D shapes: batch k's update fused with batch
   k+1's gather over 4 batches, rows and state held against
   ``adam_cols`` / ``ftrl_cols`` followed by ``gather_cols`` from the
   same state, the launch counters set to 0 just before and read just
   after;
10. drive the DeepFM recipe (batch 16000 x 39, vocab 184,965, emb 80, MLP
    1024/512/256/128 bf16, one Adam lr 5e-4 eps 5e-8 with bf16 m/v, loss
    scale 1024, host-prepared metadata) with feature-major tables and
    ``row_layout=False``: 3 warm-up and 10 timed steps, the counters set
    to 0 just before the timed steps; the column gather must have
    launched twice, the column-major segment-sum once and the column
    Adam twice per step; the same model with ``row_layout=True`` and the
    131,072 bucket is timed beside it, in turns; then 3 steps of a small
    DeepFM on this path with the kernels against 3 with the plain
    versions;
11. drive DeepFM and DCN at their bench recipes on the default path
    (row_packed tables, ``row_layout=True``, bucket 131,072): 3 warm-up
    and 10 timed steps each.

Every kernel and every library call is timed by replaying a CUDA graph
of 10 calls (device time, no host work between the launches); the plain
versions, which synchronise, by an eager loop.

``--profile`` adds the device time by kernel over 5 more steps of
phases 3, 6 and 10.  It prints a ``{"kernels": [...]}`` JSON line before the
last line and ends with ``{"ok": true, "device": {...}}``.
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
from mindrec_tpu_torch.data.outbrain import SyntheticOutbrain
from mindrec_tpu_torch.data.pipeline import AdaptiveBucket, round_bucket
from mindrec_tpu_torch.models.dcn import DCNConfig, DCNModel
from mindrec_tpu_torch.models.deepfm import DeepFMConfig, DeepFMModel
from mindrec_tpu_torch.models.multitable import (
    MULTI_FIELDS, MultiTableConfig, MultiTableWideDeepModel,
)
from mindrec_tpu_torch.models.wide_deep import WideDeepConfig, WideDeepModel
from mindrec_tpu_torch.ops import kernels
from mindrec_tpu_torch.ops.kernels import _build
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
from mindrec_tpu_torch.train import optim
from mindrec_tpu_torch.train.step import (
    SENTINEL, init_train_state, make_batch_sort, make_train_step, prep_groups,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BATCH, FIELDS, VOCAB, EMB = 16000, 39, 5_860_000, 16
MT_BATCH = 131072  # multitable recipe, benchmarks/bench_multitable.py
REPLACES = {
    "segsum_sorted": "mindrec_tpu/ops/pallas/stream_segsum.py:222",
    "adam_rows": "mindrec_tpu/ops/pallas/stream_update_rows.py:285",
    "ftrl_rows": "mindrec_tpu/ops/pallas/stream_update_rows.py:338",
    "segsum_unsorted": "mindrec_tpu/ops/pallas/stream_segsum.py:158",
    "adam_cols": "mindrec_tpu/ops/pallas/stream_update.py:380",
    "ftrl_cols": "mindrec_tpu/ops/pallas/stream_update.py:463",
    "gather_rows": "mindrec_tpu/ops/pallas/stream_gather.py:257",
    "segsum_cols": "mindrec_tpu/ops/pallas/stream_segsum.py:222",
    "gather_cols": "mindrec_tpu/ops/pallas/stream_gather.py:311",
    "fused_adam_gather": "mindrec_tpu/ops/pallas/stream_fused.py:308",
    "fused_ftrl_gather": "mindrec_tpu/ops/pallas/stream_fused.py:308",
}
SOURCES = {
    "segsum_sorted": "mindrec_tpu_torch/csrc/segsum.cu",
    "adam_rows": "mindrec_tpu_torch/csrc/update_rows.cu",
    "ftrl_rows": "mindrec_tpu_torch/csrc/update_rows.cu",
    "segsum_unsorted": "mindrec_tpu_torch/csrc/segsum.cu",
    "adam_cols": "mindrec_tpu_torch/csrc/update_cols.cu",
    "ftrl_cols": "mindrec_tpu_torch/csrc/update_cols.cu",
    "gather_rows": "mindrec_tpu_torch/csrc/gather_rows.cu",
    "segsum_cols": "mindrec_tpu_torch/csrc/segsum.cu",
    "gather_cols": "mindrec_tpu_torch/csrc/gather_cols.cu",
    "fused_adam_gather": "mindrec_tpu_torch/csrc/fused_cols.cu",
    "fused_ftrl_gather": "mindrec_tpu_torch/csrc/fused_cols.cu",
}
# launches per step of each kernel on each driven path
WD_PER_STEP = {"segsum_sorted": 1, "adam_rows": 1, "ftrl_rows": 1}
MT_PER_STEP = {"gather_rows": 8, "segsum_unsorted": 2, "adam_cols": 4,
               "ftrl_cols": 4, "segsum_sorted": 3}
FM_COL_PER_STEP = {"gather_cols": 2, "segsum_cols": 1, "adam_cols": 2}
FM_ROW_PER_STEP = {"gather_rows": 2, "segsum_sorted": 1, "adam_cols": 2}
FM_PACKED_PER_STEP = {"segsum_sorted": 1, "adam_rows": 2}
DCN_PER_STEP = {"segsum_sorted": 1, "adam_rows": 1}
FM_VOCAB, DCN_VOCAB, FM_BUCKET = 184_965, 200_000, 131_072  # bench.py
PUMP_BATCHES = 4


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of ``fn()`` over ``iters`` back-to-back eager calls,
    between two CUDA events.  Host work between the launches counts where
    the device outruns it, so this times the plain versions only."""
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


def graph_ms(fn, calls: int = 10, replays: int = 4) -> float:
    """Device time of one ``fn()``: ``calls`` calls are captured once in a
    CUDA graph and the graph is replayed, so no Python or launch overhead
    of the host sits between the kernels (an eager loop is host-bound
    below ~0.1 ms per call).  Times every kernel and every library call;
    ``fn`` must not synchronise."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


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


def check_segsum(name, got, plain, g, ids, n_out) -> tuple[float, float]:
    """Hold a segment-sum ``[D, n_out]`` (kernel and plain version) against
    a float64 ``index_add_`` of the same ``g``.  A float32 sum of n_s terms
    in any order is off by about 2**-24 * sqrt(n_s) * sqrt(sum g**2) (the
    rounding errors add like a random walk, ~0.4 of that unit when summed
    in one sequence); the tolerance is 8 units, which a wrong sum (zeros,
    a wrong column block, a lost partial) exceeds by orders of magnitude.
    Returns the max abs and rel difference of the kernel from the plain
    version."""
    keep = (ids >= 0) & (ids < n_out)
    idx, g64 = ids[keep].long(), g[keep].double()
    ref = torch.zeros((n_out, g.shape[1]), dtype=torch.float64, device=g.device)
    sq = torch.zeros_like(ref)
    ref = ref.index_add_(0, idx, g64).T
    sq = sq.index_add_(0, idx, g64 * g64).T
    cnt = torch.bincount(idx, minlength=n_out)[:n_out].double()
    tol = 8.0 * 2.0**-24 * cnt.sqrt()[None, :] * sq.sqrt()
    del g64, sq
    for who, x in (("kernel", got), ("plain version", plain)):
        err = (x.double() - ref).abs()
        if not bool((err <= tol).all()):
            worst = int(torch.argmax(err - tol))
            fail(f"{name} ({who}) disagrees with a float64 sum: max err "
                 f"{err.max().item()}, worst cell err "
                 f"{err.flatten()[worst].item()} > tol "
                 f"{tol.flatten()[worst].item()}")
    err = (got - plain).abs()
    return err.max().item(), (err / plain.abs().clamp_min(1e-30)).max().item()


def check_unsorted(dev, gen, seg, n_out, d, dtype):
    """segsum_unsorted on a random [N, d] gradient of ``dtype``: within
    the float32 tolerance of the float64 sum, deterministic, and equal
    bit for bit to the exact sum of small integers (every float32 partial
    sum of those is exact, whatever the order).  Returns the gradient and
    the kernel's max abs and rel difference from the plain version."""
    n = seg.numel()
    tag = f"segsum_unsorted [{n}, {d}] {str(dtype).split('.')[-1]}"
    g = torch.randn((n, d), generator=gen, device=dev).to(dtype)
    got = segsum_unsorted(g, seg, n_out)
    err, rel = check_segsum(tag, got, segsum_unsorted_plain(g, seg, n_out),
                            g, seg, n_out)
    if not torch.equal(segsum_unsorted(g, seg, n_out), got):
        fail(f"{tag} is not deterministic")
    gi = torch.randint(-4, 5, (n, d), generator=gen, device=dev).to(dtype)
    keep = (seg >= 0) & (seg < n_out)
    exact = torch.zeros((n_out, d), dtype=torch.float64, device=dev)
    exact = exact.index_add_(0, seg[keep].long(), gi[keep].double()).T.float()
    if not torch.equal(segsum_unsorted(gi, seg, n_out), exact):
        fail(f"{tag} differs from the exact sum of small integers")
    log(f"[check] {tag}, {int(keep.sum())} of {n} ids in [0, {n_out}): "
        f"float64 tolerance, deterministic, exact on integers; max abs "
        f"diff from the plain version {err:.3e}")
    return g, err, rel


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
    err, rel = check_segsum("segsum_sorted", segsum_sorted(g, uidx, n_out),
                            segsum_sorted_plain(g, uidx, n_out), g, uidx, n_out)
    ui_long = uidx.long()
    lib_out = torch.zeros((n_out, 128), device=dev)
    gf = g.float()
    t_b, by = bound(n * 128 * 2 + n * 4 + 128 * n_out * 4, n * 128)
    res["segsum_sorted"] = dict(
        max_abs_err=err, max_rel_err=rel,
        ms=graph_ms(lambda: segsum_sorted(g, uidx, n_out)),
        plain_ms=cuda_ms(lambda: segsum_sorted_plain(g, uidx, n_out), 5),
        bound_ms=t_b, bound_by=by,
        library_ms=graph_ms(lambda: lib_out.index_add_(0, ui_long, gf)),
    )
    log("[kernel] segsum_sorted", json.dumps(res["segsum_sorted"]))
    del g, gf, lib_out

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
    # ids of every slot; gradient and state of the live slots only
    t_b, by = bound(bucket * 8 + valid * dim * (4 + 2 * (4 + 2 + 2)),
                    valid * dim * 12)
    res["adam_rows"] = dict(
        max_abs_err=err, max_rel_err=rel,
        ms=graph_ms(lambda: adam_rows(*a, rows, sub, gs, lr_t, **hyper)),
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
    t_b, by = bound(bucket * 8 + valid * dim * (4 + 2 * 12),
                    valid * dim * 16)
    res["ftrl_rows"] = dict(
        max_abs_err=err, max_rel_err=rel,
        ms=graph_ms(lambda: ftrl_rows(*a, rows, sub, gs, **hyper)),
        plain_ms=cuda_ms(lambda: ftrl_rows_plain(*b, rows, sub, gs, **hyper), 5),
        bound_ms=t_b, bound_by=by, library_ms=None,
    )
    log("[kernel] ftrl_rows", json.dumps(res["ftrl_rows"]))
    del table, accum, linear, a, b

    # -- both again on bf16 tables (the bf16-table bench extra): the
    #    kernels' bf16-table branches against their plain versions
    bf16 = torch.bfloat16
    pack, dim, n_rows = 8, EMB, 733184
    rows, sub, _ = slots(pack, n_rows)
    state = [(0.01 * torch.randn((n_rows, 128), generator=gen, device=dev)).to(bf16),
             (1e-3 * torch.randn((n_rows, 128), generator=gen, device=dev)).to(bf16),
             (1e-6 * torch.rand((n_rows, 128), generator=gen, device=dev)).to(bf16)]
    gs = 10.0 * torch.randn((bucket, dim), generator=gen, device=dev)
    hyper = dict(dim=dim, pack=pack, loss_scale=1024.0)
    a, b = [x.clone() for x in state], [x.clone() for x in state]
    adam_rows(*a, rows, sub, gs, lr_t, **hyper)
    adam_rows_plain(*b, rows, sub, gs, lr_t, **hyper)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
    adam_ms = graph_ms(lambda: adam_rows(*a, rows, sub, gs, lr_t, **hyper))
    del state, a, b
    pack, dim, n_rows = 128, 1, 47104
    rows, sub, _ = slots(pack, n_rows)
    state = [(0.01 * torch.randn((n_rows, 128), generator=gen, device=dev)).to(bf16),
             1.0 + torch.rand((n_rows, 128), generator=gen, device=dev),
             0.1 * torch.randn((n_rows, 128), generator=gen, device=dev)]
    gs = 10.0 * torch.randn((bucket, dim), generator=gen, device=dev)
    hyper = dict(dim=dim, pack=pack, loss_scale=1024.0)
    a, b = [x.clone() for x in state], [x.clone() for x in state]
    ftrl_rows(*a, rows, sub, gs, **hyper)
    ftrl_rows_plain(*b, rows, sub, gs, **hyper)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
    ftrl_ms = graph_ms(lambda: ftrl_rows(*a, rows, sub, gs, **hyper))
    log(f"[check] adam_rows (bf16 table and m/v) and ftrl_rows (bf16 table) "
        f"== plain versions at the W&D shapes; ms {adam_ms:.4f}, "
        f"{ftrl_ms:.4f}")
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
    out = timed_steps("main", step, state, batches, BATCH, WD_PER_STEP,
                      warmup, steps, profile)
    out["bucket"] = bucket
    return out


def timed_steps(tag, step, state, batches, batch_size, per_step,
                warmup=3, steps=10, profile=False) -> dict:
    """``warmup`` steps, then ``steps`` timed steps (host clock between
    ``torch.cuda.synchronize()`` fences) with the launch counters set to 0
    just before them and read just after.  Fails unless every loss is
    finite and each kernel of ``per_step`` launched at least its count
    per step times ``steps``."""
    dev = batches[0]["label"].device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses = []
    for i in range(warmup):
        state, (_lw, ld) = step(state, batches[i % len(batches)])
        losses.append(ld)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for i in range(steps):
        state, (_lw, ld) = step(state, batches[(warmup + i) % len(batches)])
        losses.append(ld)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    losses = torch.stack(losses).float().cpu().numpy()
    out = dict(
        samples_per_s=steps * batch_size / dt, ms_per_step=dt / steps * 1e3,
        warmup_steps=warmup, timed_steps=steps,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        launches=launches, first_loss=float(losses[0]),
        last_loss=float(losses[-1]),
    )
    log(f"[{tag}]", json.dumps(out))
    if not np.isfinite(losses).all():
        fail(f"{tag}: non-finite losses {losses}")
    for k, per in per_step.items():
        if launches[k] < per * steps:
            fail(f"{tag}: kernel {k} launched {launches[k]} times in {steps} "
                 f"timed steps (expected {per} per step)")
    if profile:
        busy = profile_steps(step, state, batches)
        log(f"[profile] {tag} device busy share "
            f"{busy / out['ms_per_step']:.3f} of the unprofiled "
            f"{out['ms_per_step']:.3f} ms/step")
    return out


def kernel_vs_plain(tag, dev, model, opts, batches, **step_kw) -> None:
    """Steps with the kernels and with the plain versions from one state,
    one per batch: losses, every table and its optimizer state compared.
    Only the segment sums differ (the plain versions add with atomics), by
    float32 rounding; a bf16 moment may round to its neighbour."""
    opt_w, opt_d = opts
    sa = init_train_state(model, 1, opt_w, opt_d, device=dev)
    sb = init_train_state(model, 1, opt_w, opt_d, device=dev)
    fa = make_train_step(model, opt_w, opt_d, **step_kw)
    fb = make_train_step(model, opt_w, opt_d, use_kernels=False, **step_kw)
    for batch in batches:
        sa, (_, la) = fa(sa, batch)
        sb, (_, lb) = fb(sb, batch)
        torch.testing.assert_close(la, lb, rtol=1e-5, atol=0)
    for name, (path, _spec) in model.table_specs.items():
        key = "/".join(path)
        leaves = [(name, sa.params[path[0]][path[1]], sb.params[path[0]][path[1]])]
        st_a = (sa.opt_w if path[0] == "wide" else sa.opt_d)[key]
        st_b = (sb.opt_w if path[0] == "wide" else sb.opt_d)[key]
        leaves += [(f"{name} {k}", st_a[k], st_b[k]) for k in st_a]
        for what, x, y in leaves:
            rtol = 2.0**-7 if x.dtype == torch.bfloat16 else 1e-4
            torch.testing.assert_close(x.float(), y.float(), rtol=rtol,
                                       atol=1e-6, msg=what)
    log(f"[check] {tag} kernel step == plain step over {len(batches)} steps")


def phase_kernel_vs_plain_step(dev) -> None:
    """3 W&D steps with the kernels and 3 with the plain versions."""
    cfg = WideDeepConfig(
        batch_size=512, field_size=FIELDS, vocab_size=100_000, emb_dim=EMB,
        deep_layer_dim=(256, 256), use_mixed_precision=True, sparse=True,
        loss_scale=1024.0,
    )
    opts = (optim.ftrl(loss_scale=1024.0),
            optim.lazy_adam(loss_scale=1024.0, state_dtype=torch.bfloat16))
    data = SyntheticCriteo(512, FIELDS, 100_000, seed=11, fields="criteo")
    kernel_vs_plain("W&D", dev, WideDeepModel(cfg), opts,
                    [to_device(data.get_batch(i), dev) for i in range(3)])


def mt_setup(batch=MT_BATCH, steps=2):
    """The multitable recipe (benchmarks/bench_multitable.py): model,
    optimizers, and ``steps`` host-prepared SyntheticOutbrain batches:
    the sorted groups prepped with the multi group compacted to its
    masked-in positions (kept budget x1.05) and each sorted group's
    unique ids trimmed to a shared x1.2 bucket."""
    cfg = MultiTableConfig(batch_size=batch, sparse=True)
    model = MultiTableWideDeepModel(cfg)
    opt_w = optim.ftrl(learning_rate=cfg.ftrl_lr, l1=5e-4, l2=5e-4,
                       initial_accum=0.1, loss_scale=cfg.loss_scale)
    opt_d = optim.lazy_adam(learning_rate=cfg.adam_lr, eps=1e-6,
                            loss_scale=cfg.loss_scale)
    data = SyntheticOutbrain(cfg, steps, seed=0)
    raw = [data.get_batch(i) for i in range(steps)]
    groups = prep_groups(model)
    kept = max(int(sum(b[f"multi_{f}_mask"].sum() for f in MULTI_FIELDS))
               for b in raw)
    budget = (int(kept * 1.05) + 511) // 512 * 512
    prep = make_batch_sort(0, groups=groups, minimal=True,
                           kept_budget={"multi": budget})
    t0 = time.perf_counter()
    host = [prep(b) for b in raw]
    prep_ms = (time.perf_counter() - t0) / steps * 1e3
    buckets = {}
    for g in groups:
        nu = max(int(b[f"{g}:uidx_sorted"][-1]) + 1 for b in host)
        buckets[g] = round_bucket(int(nu * 1.2))
        for b in host:
            b[f"{g}:uq_ids"] = b[f"{g}:uq_ids"][: buckets[g]]
    log(f"[mt-data] groups {sorted(groups)}, buckets {buckets}, multi kept "
        f"{kept} of {batch * sum(cfg.multi_hot_sizes)} (budget {budget}), "
        f"numpy prep {prep_ms:.1f} ms/batch")
    return model, (opt_w, opt_d), host, buckets


def phase_mt_kernels(dev, gen, model, host0, buckets) -> dict:
    """Kernels 5-8 against their plain versions at the multitable
    recipe's shapes, on host batch 0's ids."""
    res = {}
    ub = buckets["emb128"]
    uq = torch.from_numpy(host0["emb128:uq_ids"][:ub]).to(dev)
    if uq.numel() < ub:
        uq = torch.cat([uq, uq.new_full((ub - uq.numel(),), SENTINEL)])
    valid = int((uq < model.config.emb_128_size).sum())

    def rnd(shape, scale):
        return scale * torch.randn(shape, generator=gen, device=dev)

    # -- gather: emb128 into lanes 0..127, w128 (fold 8) into 128..135 --
    t128 = rnd(model.specs["emb128"].storage_shape, 0.01)
    tw = rnd(model.specs["w128"].storage_shape, 0.01)
    cols_w = torch.div(uq, 8, rounding_mode="floor")
    a = torch.zeros((ub, 256), device=dev)
    b = torch.zeros((ub, 256), device=dev)
    for fn, buf in ((gather_rows, a), (gather_rows_plain, b)):
        fn(t128, uq, buf, 0)
        fn(tw, cols_w, buf, 128)
    err, rel = max_errs([(a, b)])
    if err != 0.0:
        fail(f"gather_rows disagrees: max err {err}")
    t_b, by = bound(ub * 4 + valid * 128 * 4 * 2, 0)
    live = uq[:valid].long()
    # every 32-byte sector (8 columns of a row) that holds a live column
    sectors = int(torch.unique(torch.div(live, 8, rounding_mode="floor")).numel())
    col_max = torch.empty(t128.shape[1], device=dev)

    def select_into_lanes():
        # no single call computes it: the selected columns [128, valid]
        # still have to be transposed into the row-major buffer's lanes
        b[:valid, 0:128] = torch.index_select(t128, 1, live).T

    def whole_table():
        # the yardstick: read the table whole, write the valid lanes
        torch.amax(t128, 0, out=col_max)
        b[:valid, 0:128].fill_(0.0)

    res["gather_rows"] = dict(
        max_abs_err=err, max_rel_err=rel,
        ms=graph_ms(lambda: gather_rows(t128, uq, a, 0)),
        plain_ms=cuda_ms(lambda: gather_rows_plain(t128, uq, b, 0), 5),
        bound_ms=t_b, bound_by=by, library_ms=None,
        sector_bound_ms=bound(ub * 4 + sectors * 128 * 32 + valid * 128 * 4,
                              0)[0],
        whole_table_ms=graph_ms(whole_table),
        select_transpose_ms=graph_ms(select_into_lanes),
        live_slots=valid, live_sectors_per_row=sectors,
    )
    log("[kernel] gather_rows (emb128 [128, 655360] -> [ub, 256] lanes 0..127)",
        json.dumps(res["gather_rows"]))
    live_w = torch.unique(cols_w[:valid])
    w128 = dict(ms=graph_ms(lambda: gather_rows(tw, cols_w, a, 128)),
                bound_ms=bound(ub * 4 + int(live_w.numel()) * 8 * 4
                               + valid * 8 * 4, 0)[0])
    log("[kernel] gather_rows (w128 [8, 81920] fold 8 -> lanes 128..135)",
        json.dumps(w128))
    del t128, tw, a, b, col_max

    # -- unsorted segsum: the indicator group's [1.7M, 128] bf16 grads --
    seg = torch.from_numpy(np.ascontiguousarray(
        host0["indicator_id"].reshape(-1))).to(dev)
    n, n_out = seg.numel(), 2048
    g, err, rel = check_unsorted(dev, gen, seg, n_out, 128, torch.bfloat16)
    # the same checks where the kernel's vector width, column groups and
    # id filter change: D = 1, D not a multiple of 8, float32, and ids
    # below 0, past n_out and spread over the whole range mixed in
    seg_x = seg.clone()
    seg_x[5::13] = torch.randint(0, n_out, seg_x[5::13].shape, generator=gen,
                                 device=dev, dtype=torch.int32)
    seg_x[::7] = -1
    seg_x[3::11] = n_out + 5
    for d_x, dt in ((1, torch.float32), (13, torch.bfloat16),
                    (20, torch.float32), (128, torch.float32)):
        check_unsorted(dev, gen, seg_x, n_out, d_x, dt)
    del seg_x
    # presence counts, as the step takes them: ones [N, 1]
    ones = torch.ones((n, 1), dtype=torch.bfloat16, device=dev)
    counts = torch.bincount(seg.long(), minlength=n_out)[:n_out].float()
    if not torch.equal(segsum_unsorted(ones, seg, n_out)[0], counts):
        fail("segsum_unsorted presence counts disagree with bincount")
    t_b, by = bound(n * 128 * 2 + n * 4 + 128 * n_out * 4, n * 128)
    lib_out = torch.zeros((n_out, 128), device=dev)
    gf, seg_l = g.float(), seg.long()
    res["segsum_unsorted"] = dict(
        max_abs_err=err, max_rel_err=rel,
        ms=graph_ms(lambda: segsum_unsorted(g, seg, n_out)),
        plain_ms=cuda_ms(lambda: segsum_unsorted_plain(g, seg, n_out), 5),
        bound_ms=t_b, bound_by=by,
        library_ms=graph_ms(lambda: lib_out.index_add_(0, seg_l, gf)),
    )
    res["segsum_unsorted"]["presence_ms"] = graph_ms(
        lambda: segsum_unsorted(ones, seg, n_out))
    log("[kernel] segsum_unsorted ([1.7M, 128] bf16 -> [128, 2048])",
        json.dumps(res["segsum_unsorted"]))
    del g, gf, lib_out, ones

    # -- sorted segsum at the two sorted groups' widest shapes ----------
    for grp, d in (("emb128", 256), ("multi", 128)):
        uidx = torch.from_numpy(host0[f"{grp}:uidx_sorted"]).to(dev)
        n, n_out = uidx.numel(), buckets[grp]
        g = torch.randn((n, d), generator=gen, device=dev).to(torch.bfloat16)
        err, rel = check_segsum(f"segsum_sorted ({grp})",
                                segsum_sorted(g, uidx, n_out),
                                segsum_sorted_plain(g, uidx, n_out), g, uidx,
                                n_out)
        t_b, _by = bound(n * d * 2 + n * 4 + d * n_out * 4, n * d)
        lib_out = torch.zeros((n_out, d), device=dev)
        gf, ui_long = g.float(), uidx.long()
        log(f"[kernel] segsum_sorted ({grp} [{n}, {d}] bf16 -> [{d}, {n_out}])",
            json.dumps(dict(
                max_abs_err=err, max_rel_err=rel,
                ms=graph_ms(lambda: segsum_sorted(g, uidx, n_out)),
                plain_ms=cuda_ms(lambda: segsum_sorted_plain(g, uidx, n_out), 5),
                bound_ms=t_b,
                library_ms=graph_ms(lambda: lib_out.index_add_(0, ui_long, gf)))))
        del g, gf, lib_out

    # -- LazyAdam on emb128 [128, 655360], f32 m/v ----------------------
    res["adam_cols"] = check_adam_cols(
        "emb128, f32 m/v", dev, gen, model.specs["emb128"].storage_shape, 1,
        uq, None, torch.float32, eps=1e-6, loss_scale=1000.0)

    # -- FTRL on w128 [8, 81920], fold 8 ------------------------------
    shape = model.specs["w128"].storage_shape
    sub = torch.remainder(uq, 8)
    gw = rnd((8, ub), 10.0) * (torch.arange(8, device=dev)[:, None] == sub[None, :])
    aug = make_aug_grads(gw, sub).contiguous()
    base = [rnd(shape, 0.01), 0.1 + torch.rand(shape, generator=gen, device=dev),
            rnd(shape, 0.1)]
    a = [x.clone() for x in base]
    b = [x.clone() for x in base]
    hyper = dict(dim=1, fold=8, learning_rate=5e-2, l1=5e-4, l2=5e-4,
                 loss_scale=1000.0)
    ftrl_cols(*a, cols_w, aug, **hyper)
    ftrl_cols_plain(*b, cols_w, aug, **hyper)
    err, rel = max_errs(zip(a, b))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
    io = ub * 4 + 16 * valid * 4  # a sentinel slot's gradient is not read
    wsec = int(torch.unique(torch.div(live, 64, rounding_mode="floor")).numel())
    t_b, by = bound(io + valid * 3 * 4 * 2, valid * 16)
    res["ftrl_cols"] = dict(
        max_abs_err=err, max_rel_err=rel,
        ms=graph_ms(lambda: ftrl_cols(*a, cols_w, aug, **hyper)),
        plain_ms=cuda_ms(lambda: ftrl_cols_plain(*b, cols_w, aug, **hyper), 5),
        bound_ms=t_b, bound_by=by, library_ms=None,
        sector_bound_ms=bound(io + wsec * 8 * 3 * 2 * 32, 0)[0],
    )
    log("[kernel] ftrl_cols (w128, fold 8)", json.dumps(res["ftrl_cols"]))
    torch.cuda.synchronize()
    return res


def phase_mt_main_path(dev, model, opts, host, warmup=3, steps=10,
                       profile=False) -> dict:
    """The multitable step at the recipe's full width."""
    opt_w, opt_d = opts
    state = init_train_state(model, 0, opt_w, opt_d, device=dev)
    batches = [to_device(hb, dev) for hb in host]
    step = make_train_step(model, opt_w, opt_d)
    out = timed_steps("mt-main", step, state, batches, MT_BATCH, MT_PER_STEP,
                      warmup, steps, profile)
    del state
    plain_step = make_train_step(model, opt_w, opt_d, use_kernels=False)

    def run(tag, fn, per_step, n):
        st = init_train_state(model, 0, opt_w, opt_d, device=dev)
        return timed_steps(tag, fn, st, batches, MT_BATCH, per_step, 2, n)

    plain = [run("mt-plain", plain_step, {}, 4) for _ in range(2)]
    again = run("mt-main", step, MT_PER_STEP, steps)
    log(f"[compare] multitable, ms/step: kernels {out['ms_per_step']:.3f}, "
        f"{again['ms_per_step']:.3f}; plain versions "
        f"{plain[0]['ms_per_step']:.3f}, {plain[1]['ms_per_step']:.3f}")
    return out


def phase_mt_kernel_vs_plain_step(dev) -> None:
    """3 multitable steps with the kernels and 3 with the plain versions
    from one state: two tiny groups (indicator, emb64_single) and two
    sorted ones (emb128, multi)."""
    cfg = MultiTableConfig(
        batch_size=1024, continue_field_size=4, indicator_field_size=2,
        emb128_field_size=1, emb64_single_field_size=2,
        multi_hot_sizes=(3, 4, 3, 2, 2, 3), emb_128_size=3000,
        emb64_single_size=50, emb64_multi_size=2500, indicator_size=16,
        deep_layer_dim=(256, 256), sparse=True,
    )
    opts = (optim.ftrl(l1=5e-4, l2=5e-4, initial_accum=0.1, loss_scale=1000.0),
            optim.lazy_adam(learning_rate=1e-3, eps=1e-6, loss_scale=1000.0))
    data = SyntheticOutbrain(cfg, 3, seed=11)
    kernel_vs_plain("multitable", dev, MultiTableWideDeepModel(cfg), opts,
                    [to_device(data.get_batch(i), dev) for i in range(3)])


def check_adam_cols(tag, dev, gen, shape, fold, cols, sub, state_dtype, *,
                    eps, loss_scale) -> dict:
    """adam_cols against its plain version on clones of one random state
    (the same float32 operations: equal to rounding), timed beside it.
    ``cols`` [n] sorted storage columns, sentinel-padded; ``sub`` their
    fold sub-rows or None.  Bound: every slot's column id, the gradient and
    touch rows of the live slots (a sentinel slot returns before it reads
    them) and each touched element's weight and moments, read and
    written.  ``whole_table_ms`` is a yardstick for dense batches: the
    time of reading and writing the three arrays whole (``mul_(1.0)``),
    what the sector bound comes to when every sector holds a live column."""
    dp, vc = shape
    n = cols.numel()

    def rnd(scale):
        return scale * torch.randn(shape, generator=gen, device=dev)

    state = [rnd(0.01), rnd(1e-3).to(state_dtype),
             rnd(1e-6).abs().to(state_dtype)]
    aug = slot_grads(dev, gen, dp, fold, cols, sub)
    lr_t = torch.tensor(1e-3, device=dev)
    hyper = dict(dim=1 if fold > 1 else dp, fold=fold, eps=eps,
                 loss_scale=loss_scale)
    a, b = [x.clone() for x in state], [x.clone() for x in state]
    del state
    adam_cols(*a, cols, aug, lr_t, **hyper)
    adam_cols_plain(*b, cols, aug, lr_t, **hyper)
    err, rel = max_errs(zip(a, b))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
    live = cols[(cols >= 0) & (cols < vc)]
    n_live = int(live.numel())
    distinct = torch.unique(live)
    touched = int(distinct.numel()) * dp if fold == 1 else n_live
    el_b = a[0].element_size() + 2 * a[1].element_size()
    io = n * 4 + (dp + 8) * n_live * 4
    t_b, by = bound(io + touched * el_b * 2, touched * 12)
    # whole 32-byte sectors of each array's touched columns, in and out
    sec_bytes = sum(
        int(torch.unique(torch.div(distinct, 32 // x.element_size(),
                                   rounding_mode="floor")).numel()) * dp * 32 * 2
        for x in a)
    out = dict(
        max_abs_err=err, max_rel_err=rel,
        ms=graph_ms(lambda: adam_cols(*a, cols, aug, lr_t, **hyper)),
        plain_ms=cuda_ms(lambda: adam_cols_plain(*b, cols, aug, lr_t, **hyper), 5),
        bound_ms=t_b, bound_by=by, library_ms=None,
        sector_bound_ms=bound(io + sec_bytes, 0)[0],
        whole_table_ms=graph_ms(lambda: [x.mul_(1.0) for x in b]),
        slots=n, live_slots=n_live,
    )
    log(f"[kernel] adam_cols ({tag} [{dp}, {vc}] fold {fold}, n {n})",
        json.dumps(out))
    return out


def padded_cols(uq_ids, fold, dev):
    """Sorted storage columns and fold sub-rows of a batch's unique ids at
    their full length (sentinel-padded), as the feature-major path builds
    them."""
    uq = torch.from_numpy(np.ascontiguousarray(uq_ids)).to(dev)
    cols = torch.div(uq, fold, rounding_mode="floor") if fold > 1 else uq
    return cols.contiguous(), (torch.remainder(uq, fold) if fold > 1 else None)


def check_gather_cols(tag, dev, gen, shape, cols, dtype=torch.float32) -> dict:
    """gather_cols against its plain version (exact), timed beside it and
    beside ``index_select`` over the columns clamped into the table."""
    dp, vc = shape
    table = (0.01 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
    got, want = gather_cols(table, cols), gather_cols_plain(table, cols)
    err, rel = max_errs([(got, want)])
    if not torch.equal(got, want):
        fail(f"gather_cols ({tag}) disagrees: max err {err}")
    del got, want
    n = cols.numel()
    live = cols[(cols >= 0) & (cols < vc)]
    distinct = int(torch.unique(live).numel())
    t_b, by = bound(n * 4 + distinct * dp * table.element_size() + dp * n * 4, 0)
    clamped = cols.clamp(0, vc - 1).long()
    out = dict(
        max_abs_err=err, max_rel_err=rel,
        ms=graph_ms(lambda: gather_cols(table, cols)),
        plain_ms=cuda_ms(lambda: gather_cols_plain(table, cols), 5),
        bound_ms=t_b, bound_by=by,
        library_ms=graph_ms(lambda: torch.index_select(table, 1, clamped)),
        live=int(live.numel()), distinct=distinct,
    )
    log(f"[kernel] gather_cols ({tag} [{dp}, {vc}] -> [{dp}, {n}])",
        json.dumps(out))
    return out


def check_segsum_cols(tag, dev, gen, d, uidx, n_out=None,
                      dtype=torch.bfloat16, timed=True) -> dict:
    """segsum_cols on the transposed view of a contiguous [N, d] gradient
    (the step's layout) against a float64 sum and its plain version:
    deterministic, every column past the last segment zero; timed beside
    ``index_add_`` along dim 1 in float32 on the same view.  ``n_out``
    defaults to N, as the step passes it."""
    n = uidx.numel()
    n_out = n if n_out is None else n_out
    rows = torch.randn((n, d), generator=gen, device=dev).to(dtype)
    g = rows.T
    got = segsum_cols(g, uidx, n_out)
    err, rel = check_segsum(f"segsum_cols ({tag})", got,
                            segsum_cols_plain(g, uidx, n_out), rows, uidx,
                            n_out)
    if not torch.equal(segsum_cols(g, uidx, n_out), got):
        fail(f"segsum_cols ({tag}) is not deterministic")
    last = int(uidx[-1])
    if bool((got[:, last + 1:] != 0).any()):
        fail(f"segsum_cols ({tag}) left its tail unwritten")
    del got
    if not timed:
        return dict(max_abs_err=err, max_rel_err=rel)
    t_b, by = bound(n * d * rows.element_size() + n * 4 + d * n_out * 4, n * d)
    lib_out = torch.zeros((d, n_out), device=dev)
    gf, ui_long = g.float(), uidx.long()  # gf keeps the view's strides
    tail = lib_out[:, last + 1:]
    out = dict(
        max_abs_err=err, max_rel_err=rel,
        ms=graph_ms(lambda: segsum_cols(g, uidx, n_out)),
        plain_ms=cuda_ms(lambda: segsum_cols_plain(g, uidx, n_out), 5),
        bound_ms=t_b, bound_by=by,
        library_ms=graph_ms(lambda: lib_out.index_add_(1, ui_long, gf)),
        segments=last + 1,
        # yardstick: PyTorch's fill of the same zero columns alone
        zero_tail_ms=graph_ms(lambda: tail.zero_()),
    )
    log(f"[kernel] segsum_cols ({tag} [{d}, {n}] {str(dtype)[6:]} as the "
        f"view of [{n}, {d}] -> [{d}, {n_out}])", json.dumps(out))
    return out


def edge_uidx(n, pattern, gen, dev):
    """Sorted segment ids with unit steps for the edge shapes: ``hot`` 45%
    of the positions on the first id (several tiles), then runs of 1-9;
    ``distinct`` one position each; ``edges`` runs of 32-160 positions in
    steps of 32, so runs end on tile edges; ``mixed`` runs of 1-9 with a
    run of 1500."""
    if pattern == "distinct":
        runs = torch.ones(n, dtype=torch.long, device=dev)
    elif pattern == "edges":
        runs = 32 * torch.randint(1, 6, (n // 32,), generator=gen, device=dev)
    else:
        runs = torch.randint(1, 10, (n,), generator=gen, device=dev)
        runs[0 if pattern == "hot" else n // 15] = (
            int(0.45 * n) if pattern == "hot" else 1500)
    ids = torch.arange(runs.numel(), device=dev)
    return torch.repeat_interleave(ids, runs)[:n].to(torch.int32).contiguous()


# (N, D, n_out, run pattern): D 1, 5, 24, 88; N a multiple of no tile
# size; a hot id over several tiles, all positions distinct, runs ending
# at tile edges, segments past n_out (700), an empty tail
SEGSUM_COLS_EDGES = [(9001, 1, 9001, "hot"), (4999, 5, 4999, "distinct"),
                     (6001, 24, 6144, "edges"), (5003, 88, 5003, "mixed"),
                     (5003, 88, 700, "mixed"), (3001, 24, 4096, "hot")]


def check_segsum_cols_edges(dev, gen) -> None:
    """segsum_cols at the edge shapes, bf16 and float32, held as at the
    step's shapes."""
    for n, d, n_out, pattern in SEGSUM_COLS_EDGES:
        uidx = edge_uidx(n, pattern, gen, dev)
        for dt in (torch.float32, torch.bfloat16):
            check_segsum_cols(f"{pattern}, n_out {n_out}", dev, gen, d, uidx,
                              n_out, dt, timed=False)
    log(f"[check] segsum_cols at {len(SEGSUM_COLS_EDGES)} edge shapes x "
        f"(f32, bf16): float64 tolerance, plain version, deterministic, "
        f"zero tail")


def slot_grads(dev, gen, dp, fold, cols, sub):
    """Touch-augmented random gradients [dp + 8, n] of one batch's slots,
    folded slots masked to their sublane as the step builds them."""
    g = 10.0 * torch.randn((dp, cols.numel()), generator=gen, device=dev)
    if fold > 1:
        g = g * (torch.arange(dp, device=dev)[:, None] == sub[None, :])
    return make_aug_grads(g, sub).contiguous()


def fused_case(dev, gen, kind, shape, fold, state_dtype):
    """State and hyper-parameters of a fused update at a table shape:
    (state list, hyper, lr_t or None)."""
    def rnd(scale):
        return scale * torch.randn(shape, generator=gen, device=dev)

    dim = 1 if fold > 1 else shape[0]
    if kind == "adam":
        state = [rnd(0.01), rnd(1e-3).to(state_dtype),
                 rnd(1e-6).abs().to(state_dtype)]
        hyper = dict(dim=dim, fold=fold, eps=5e-8, loss_scale=1024.0)
        return state, hyper, torch.tensor(1e-3, device=dev)
    state = [rnd(0.01), 0.1 + torch.rand(shape, generator=gen, device=dev),
             rnd(0.1)]
    hyper = dict(dim=dim, fold=fold, learning_rate=5e-2, l1=1e-8, l2=1e-8,
                 loss_scale=1024.0)
    return state, hyper, None


def fused_calls(kind, lr_t):
    """(fused kernel, its plain version, separate update kernel) with one
    call signature: f(state, cols, aug[, next_cols], **hyper)."""
    if kind == "adam":
        return (
            lambda st, c, a, nx, **h: fused_adam_gather(*st, c, a, lr_t, nx, **h),
            lambda st, c, a, nx, **h: fused_adam_gather_plain(*st, c, a, lr_t,
                                                              nx, **h),
            lambda st, c, a, **h: adam_cols(*st, c, a, lr_t, **h),
        )
    return (
        lambda st, c, a, nx, **h: fused_ftrl_gather(*st, c, a, nx, **h),
        lambda st, c, a, nx, **h: fused_ftrl_gather_plain(*st, c, a, nx, **h),
        lambda st, c, a, **h: ftrl_cols(*st, c, a, **h),
    )


def check_fused(tag, dev, gen, kind, shape, fold, ids_u, ids_g,
                state_dtype=torch.bfloat16) -> dict:
    """One fused update + gather against its plain version (state to
    rounding: the same float32 operations; rows exact from the updated
    table), timed beside the plain version and beside the separate update
    and gather kernels run one after the other."""
    name = f"fused_{kind}_gather"
    dp, vc = shape
    cols_u, sub_u = padded_cols(ids_u, fold, dev)
    cols_g, _ = padded_cols(ids_g, fold, dev)
    state, hyper, lr_t = fused_case(dev, gen, kind, shape, fold, state_dtype)
    aug = slot_grads(dev, gen, dp, fold, cols_u, sub_u)
    fused, plain, update = fused_calls(kind, lr_t)
    a, b = [x.clone() for x in state], [x.clone() for x in state]
    rows_a = fused(a, cols_u, aug, cols_g, **hyper)[3]
    rows_b = plain(b, cols_u, aug, cols_g, **hyper)[3]
    err, rel = max_errs([*zip(a, b), (rows_a, rows_b)])
    for x, y in [*zip(a, b), (rows_a, rows_b)]:
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
    if not torch.equal(rows_a, gather_cols(a[0], cols_g)):
        fail(f"{name} ({tag}): rows are not the updated table's columns")
    del rows_a, rows_b, b
    live_u = cols_u[(cols_u >= 0) & (cols_u < vc)]
    live_g = cols_g[(cols_g >= 0) & (cols_g < vc)]
    upd_cols, next_cols = torch.unique(live_u), torch.unique(live_g)
    shared = int(torch.isin(next_cols, upd_cols).sum())
    touched = int(upd_cols.numel()) * dp if fold == 1 else int(live_u.numel())
    w_b = state[0].element_size()
    st_b = state[1].element_size() + state[2].element_size()
    n_u, n_g = cols_u.numel(), cols_g.numel()
    # a sentinel slot returns before it reads its gradient: live slots only
    nbytes = (n_u * 4 + (dp + 8) * int(live_u.numel()) * 4
              + touched * (w_b + st_b) * 2
              + n_g * 4 + dp * n_g * 4
              + (int(next_cols.numel()) - shared) * dp * w_b)
    t_b, by = bound(nbytes, touched * 16)
    c = [x.clone() for x in state]

    def separate():
        update(c, cols_u, aug, **hyper)
        gather_cols(c[0], cols_g)

    out = dict(
        max_abs_err=err, max_rel_err=rel,
        ms=graph_ms(lambda: fused(a, cols_u, aug, cols_g, **hyper)),
        plain_ms=cuda_ms(lambda: plain(c, cols_u, aug, cols_g, **hyper), 3),
        bound_ms=t_b, bound_by=by, library_ms=None,
        separate_kernels_ms=graph_ms(separate),
        live_update_slots=int(live_u.numel()), live_next=int(live_g.numel()),
        shared_columns=shared,
    )
    log(f"[kernel] {name} ({tag} [{dp}, {vc}] fold {fold}, n_u {n_u}, "
        f"n_g {n_g})", json.dumps(out))
    return out


def phase_col_kernels(dev, gen, fm_host, wd_host) -> dict:
    """Kernels 4, 9, 10, 11 against their plain versions at the DeepFM
    feature-major shapes (reported in the kernels line) and at the W&D
    bench shapes.  ``fm_host`` / ``wd_host``: two host-prepared batches
    each (unique ids at full length)."""
    fm = DeepFMModel(DeepFMConfig(vocab_size=FM_VOCAB, sparse=True,
                                  table_layout="feature_major"))
    wd = WideDeepModel(WideDeepConfig(vocab_size=VOCAB, emb_dim=EMB,
                                      sparse=True,
                                      table_layout="feature_major"))
    fm_v, fm_w = fm.v_spec.storage_shape, fm.w_spec.storage_shape
    wd_d, wd_w = wd.deep_spec.storage_shape, wd.wide_spec.storage_shape
    res = {}
    uq0, uq1 = fm_host[0]["uq_ids"], fm_host[1]["uq_ids"]
    res["gather_cols"] = check_gather_cols(
        "DeepFM fm", dev, gen, fm_v, padded_cols(uq0, 1, dev)[0])
    check_gather_cols("DeepFM linear", dev, gen, fm_w,
                      padded_cols(uq0, 8, dev)[0])
    check_gather_cols("W&D deep", dev, gen, wd_d,
                      padded_cols(wd_host[0]["uq_ids"], 1, dev)[0])
    check_gather_cols("W&D deep bf16", dev, gen, wd_d,
                      padded_cols(wd_host[0]["uq_ids"], 1, dev)[0],
                      dtype=torch.bfloat16)
    # kernel 6 as the DeepFM steps launch it: bf16 m/v, N slots, 91% pads
    for tag, shape, fold in (("DeepFM fm, bf16 m/v", fm_v, 1),
                             ("DeepFM linear, bf16 m/v", fm_w, 8)):
        check_adam_cols(tag, dev, gen, shape, fold, *padded_cols(uq0, fold, dev),
                        torch.bfloat16, eps=5e-8, loss_scale=1024.0)
    torch.cuda.empty_cache()
    uidx = torch.from_numpy(fm_host[0]["uidx_sorted"]).to(dev)
    res["segsum_cols"] = check_segsum_cols("DeepFM", dev, gen,
                                           fm_v[0] + fm_w[0], uidx)
    check_segsum_cols("W&D", dev, gen, wd_d[0] + wd_w[0],
                      torch.from_numpy(wd_host[0]["uidx_sorted"]).to(dev))
    check_segsum_cols_edges(dev, gen)
    torch.cuda.empty_cache()
    w0, w1 = wd_host[0]["uq_ids"], wd_host[1]["uq_ids"]
    res["fused_adam_gather"] = check_fused("W&D deep", dev, gen, "adam", wd_d,
                                           1, w0, w1)
    torch.cuda.empty_cache()
    res["fused_ftrl_gather"] = check_fused("W&D wide", dev, gen, "ftrl", wd_w,
                                           8, w0, w1)
    check_fused("DeepFM fm", dev, gen, "adam", fm_v, 1, uq0, uq1)
    check_fused("DeepFM linear", dev, gen, "adam", fm_w, 8, uq0, uq1)
    check_fused("DeepFM linear", dev, gen, "ftrl", fm_w, 8, uq0, uq1)
    torch.cuda.synchronize()
    return res


def phase_fused_pump(dev, gen, wd_host) -> dict:
    """The fused pump at the W&D shapes: batch k's update fused with
    batch k+1's gather.  Beside it the separate kernels (update, then
    gather) run from the same state; the rows must be equal and the
    states equal to rounding after every batch, and the first batch's rows
    come from a plain gather as a pipeline would start.  Returns the
    launch counts of the pump."""
    wd = WideDeepModel(WideDeepConfig(vocab_size=VOCAB, emb_dim=EMB,
                                      sparse=True,
                                      table_layout="feature_major"))
    pumps = []
    for kind, spec, fold in (("adam", wd.deep_spec, 1),
                             ("ftrl", wd.wide_spec, 8)):
        cols = [padded_cols(hb["uq_ids"], fold, dev) for hb in wd_host]
        state, hyper, lr_t = fused_case(dev, gen, kind, spec.storage_shape,
                                        fold, torch.bfloat16)
        augs = [slot_grads(dev, gen, spec.storage_shape[0], fold, c, sub)
                for c, sub in cols[:-1]]
        pumps.append((kind, cols, state, augs, hyper, lr_t))
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    fused_rows = []
    for kind, cols, state, augs, hyper, lr_t in pumps:
        fused, _plain, _update = fused_calls(kind, lr_t)
        a = [x.clone() for x in state]
        fused_rows.append((a, [fused(a, cols[k][0], augs[k], cols[k + 1][0],
                                     **hyper)[3] for k in range(len(augs))]))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k]
                for k in ("fused_adam_gather", "fused_ftrl_gather")}
    for (kind, cols, state, augs, hyper, lr_t), (a, rows) in zip(pumps,
                                                                 fused_rows):
        _fused, _plain, update = fused_calls(kind, lr_t)
        b = [x.clone() for x in state]
        for k in range(len(augs)):
            update(b, cols[k][0], augs[k], **hyper)
            if not torch.equal(rows[k], gather_cols(b[0], cols[k + 1][0])):
                fail(f"fused {kind} pump: rows of batch {k + 1} differ from "
                     f"gather-after-update")
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
    log(f"[pump] {len(wd_host) - 1} fused updates + gathers per table "
        f"(deep [16, Vc] LazyAdam bf16 m/v, wide [8, Vc/8] FTRL) in "
        f"{dt * 1e3:.3f} ms: rows == gather-after-update, state == separate "
        f"kernels; launches {json.dumps(launches)}")
    for k, v in launches.items():
        if v < len(wd_host) - 1:
            fail(f"pump: {k} launched {v} times")
    return launches


def criteo_host_batches(vocab, steps, bucket=None):
    """``steps`` host-prepared SyntheticCriteo batches at the bench
    recipes' batch size; ``bucket`` trims the unique ids for the
    row-layout path (the feature-major path takes them at full length)."""
    data = SyntheticCriteo(BATCH, FIELDS, vocab, steps=steps, seed=0,
                           fields="criteo")
    prep = make_batch_sort(FIELDS, unique_bucket=bucket, minimal=True)
    host = [prep(data.get_batch(s)) for s in range(steps)]
    if bucket is not None:
        for hb in host:
            hb["uq_ids"] = hb["uq_ids"][:bucket]
    return host


def deepfm_recipe(layout):
    """bench.py's DeepFM recipe: model and its one Adam (lr 5e-4, eps
    5e-8, bf16 m/v, loss scale 1024)."""
    cfg = DeepFMConfig(
        batch_size=BATCH, field_size=FIELDS, vocab_size=FM_VOCAB, emb_dim=80,
        deep_layer_dim=(1024, 512, 256, 128), use_mixed_precision=True,
        sparse=True, loss_scale=1024.0, table_layout=layout,
    )

    def opt():
        return optim.adam(learning_rate=5e-4, eps=5e-8, loss_scale=1024.0,
                          state_dtype=torch.bfloat16)

    return DeepFMModel(cfg), (opt(), opt())


def phase_deepfm_colpath(dev, fm_host, profile=False) -> dict:
    """The DeepFM recipe on feature-major tables: ``row_layout=False``
    (the path of kernels 9, 4 and 6) and, in turns beside it,
    ``row_layout=True`` with the 131,072 bucket."""
    model, opts = deepfm_recipe("feature_major")
    full = [to_device(hb, dev) for hb in fm_host]
    trimmed = [{**b, "uq_ids": b["uq_ids"][:FM_BUCKET]} for b in full]

    def run(tag, row_layout, per_step, prof=False):
        state = init_train_state(model, 0, *opts, device=dev)
        step = make_train_step(model, *opts, row_layout=row_layout)
        return timed_steps(tag, step, state, full if not row_layout else trimmed,
                           BATCH, per_step, profile=prof)

    out = run("deepfm-col", False, FM_COL_PER_STEP, profile)
    row = [run("deepfm-fm-row", True, FM_ROW_PER_STEP) for _ in range(2)]
    col2 = run("deepfm-col", False, FM_COL_PER_STEP)
    log(f"[compare] DeepFM feature-major, ms/step: row_layout=False "
        f"{out['ms_per_step']:.3f}, {col2['ms_per_step']:.3f}; row_layout=True "
        f"(bucket {FM_BUCKET}) {row[0]['ms_per_step']:.3f}, "
        f"{row[1]['ms_per_step']:.3f}")
    return out


def phase_deepfm_kernel_vs_plain_step(dev) -> None:
    """3 DeepFM steps on the feature-major path with the kernels and 3
    with the plain versions from one state."""
    cfg = DeepFMConfig(
        batch_size=512, field_size=FIELDS, vocab_size=100_000, emb_dim=20,
        deep_layer_dim=(256, 256), use_mixed_precision=True, sparse=True,
        loss_scale=1024.0, table_layout="feature_major",
    )
    opts = tuple(optim.adam(learning_rate=5e-4, eps=5e-8, loss_scale=1024.0,
                            state_dtype=torch.bfloat16) for _ in range(2))
    data = SyntheticCriteo(512, FIELDS, 100_000, seed=11, fields="criteo")
    kernel_vs_plain("DeepFM row_layout=False", dev, DeepFMModel(cfg), opts,
                    [to_device(data.get_batch(i), dev) for i in range(3)],
                    row_layout=False)


def phase_default_paths(dev, fm_host) -> None:
    """DeepFM and DCN at their bench recipes on the default row_packed
    path (bucket 131,072)."""
    model, opts = deepfm_recipe("auto")
    batches = [to_device({**hb, "uq_ids": hb["uq_ids"][:FM_BUCKET]}, dev)
               for hb in fm_host]
    state = init_train_state(model, 0, *opts, device=dev)
    timed_steps("deepfm-packed", make_train_step(model, *opts), state, batches,
                BATCH, FM_PACKED_PER_STEP)
    del state, batches
    torch.cuda.empty_cache()
    cfg = DCNConfig(
        batch_size=BATCH, field_size=FIELDS, vocab_size=DCN_VOCAB, emb_dim=27,
        deep_layer_dim=(1024, 1024), cross_layer_num=6,
        use_mixed_precision=True, sparse=True, loss_scale=1024.0,
    )
    model = DCNModel(cfg)
    opts = tuple(optim.adam(learning_rate=cfg.learning_rate,
                            loss_scale=cfg.loss_scale,
                            state_dtype=torch.bfloat16) for _ in range(2))
    batches = [to_device(hb, dev)
               for hb in criteo_host_batches(DCN_VOCAB, 4, bucket=FM_BUCKET)]
    state = init_train_state(model, 0, *opts, device=dev)
    timed_steps("dcn-packed", make_train_step(model, *opts), state, batches,
                BATCH, DCN_PER_STEP)


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
    torch.cuda.empty_cache()

    model, opts, host, buckets = mt_setup()
    res.update(phase_mt_kernels(dev, gen, model, host[0], buckets))
    torch.cuda.empty_cache()
    mt_path = phase_mt_main_path(dev, model, opts, host, profile=args.profile)
    del host
    torch.cuda.empty_cache()
    phase_mt_kernel_vs_plain_step(dev)
    torch.cuda.empty_cache()

    fm_host = criteo_host_batches(FM_VOCAB, 4)
    prep_full = make_batch_sort(FIELDS, minimal=True)
    wd_host = [prep_full(data.get_batch(s)) for s in range(PUMP_BATCHES)]
    res.update(phase_col_kernels(dev, gen, fm_host, wd_host))
    torch.cuda.empty_cache()
    pump = phase_fused_pump(dev, gen, wd_host)
    del wd_host
    torch.cuda.empty_cache()
    fm_path = phase_deepfm_colpath(dev, fm_host, profile=args.profile)
    torch.cuda.empty_cache()
    phase_deepfm_kernel_vs_plain_step(dev)
    phase_default_paths(dev, fm_host)

    launches = {**main_path["launches"],
                **{k: mt_path["launches"][k] for k in MT_PER_STEP
                   if k != "segsum_sorted"},
                **{k: fm_path["launches"][k]
                   for k in ("gather_cols", "segsum_cols")},
                **pump}
    rows = [
        {"name": k, "route": "cuda", "source": SOURCES[k],
         "replaces": REPLACES[k], "launches": launches[k],
         **{f: res[k][f] for f in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}}
        for k in SOURCES
    ]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
