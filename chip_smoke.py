#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mindrec_tpu_torch``) on one GPU.

Run from the repository root on a machine with one NVIDIA H100 (the
kernels are built for ``sm_90a``)::

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card's name and power limit, build the CUDA kernels from
   ``mindrec_tpu_torch/csrc`` and print the build time;
2. hold each kernel against its plain PyTorch version on the card at the
   benchmark recipe's shapes (the segment-sum of batch-order gradients
   through a real synthetic Criteo batch's ``perm`` and ``uidx_sorted``,
   LazyAdam on the full deep table with bf16 m/v, FTRL on the full wide
   table), and time kernel, plain version and, where one exists, a
   single PyTorch call computing the same function, beside each bound
   (bytes, and whole 32-byte sectors of the touched rows);
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
   emb128 table into its group's [ub, 256] buffer (timed beside its
   sector bound and the time of reading the table whole and writing the
   valid lanes), then the gather of each of the eight feature-major
   tables and FTRL on each of the four folded wide tables at the
   launch shapes the step gives them (``[launch]`` lines: time, bound,
   sector bound, ms lost over 10 steps; a tiny group's touch rows gated
   by its presence), the
   unsorted segment-sum of the indicator group's [1.7M, 128] bf16
   gradient and its [1.7M, 1] presence counts, the sorted segment-sum of
   the emb128 group's [N, 256], the emb64_single group's and the
   compacted multi group's [N, 128] batch-order gradients through their
   ``perm`` (timed beside the ``g[perm]`` gather it replaces; segment sums
   held against a float64 sum) and at the edge cases of
   ``tests/test_torch_cuda.py`` (no positions, a hot id
   over 105 chunks, all distinct, ids below 0 and past n_out, D 1, 13,
   128, 256, identity, reversed, random and compacted ``perm``, bf16 and
   float32), LazyAdam on emb128 with
   f32 m/v; the unsorted segment-sum again at
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
   the column gather (exact), the row gather as the DeepFM
   ``row_layout=True`` step launches it (fm and the folded linear table,
   bucket 131,072), the column Adam as the DeepFM steps launch
   it (bf16 m/v over the sentinel-padded N slots, fold 1 and fold 8), the
   column-major segment-sum on the transposed view of a contiguous
   [N, D] gradient, as the step passes it (against a float64 sum, at
   these shapes and at edge shapes: D 1, 5, 24, 88, hot ids over several
   tiles, runs ending at tile edges, segments past n_out), and the fused
   LazyAdam / FTRL update + next-batch
   gather at its five launch shapes (``fused_shapes``: state to rounding,
   rows exact), each timed beside its plain version, a single PyTorch
   call where one exists, and for the fused kernels the separate update
   and gather kernels, together and each alone, and the sector bound;
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
    and 10 timed steps each;
12. train through ``RecModel`` (``jit=True``: the step captured in a
    CUDA graph per batch signature and replayed) over raw host batches:
    the W&D bench recipe with ``unique_bucket=AdaptiveBucket.from_sample``
    of 2 raw batches and 2 prep workers (native prep, the prep pool,
    staging on a side stream, the captured step), 3 warm-up and 20 timed
    steps end to end (samples/s, host prep included; launches counted per
    replay x replays); native prep ms per batch beside numpy's on the
    same batch; the eager and the captured step on staged batches in
    turns (eager, captured, captured, eager), with the device busy share
    of each; captured == eager bit for bit over 5 batches from one state;
    a bucket below what later batches need (one regrow, one new capture,
    the state equal to an eager run with the same regrow); ``eval`` on 4
    held-out batches against ``make_eval_step`` + ``roc_auc``; then the
    multitable recipe through ``RecModel(host_prep=True)`` (per-group
    lossless native prep), 3 warm-up and 5 timed steps, prep ms, the
    steps in turns and captured == eager; and the DeepFM (feature-major
    with ``row_layout=False``, and the default path) and DCN steps
    captured (ms/step, busy share).  Every phase-12 line carries the
    card's name and power limit;
13. the dense step (``sparse=False``, every model config's default; no
    kernel of the port runs on it, as no Pallas kernel runs on the
    reference's), captured: the W&D reference accuracy recipe
    (``WideDeepConfig()``: batch 16000 x 39, vocab 200,000, emb 80,
    1024-512-256-128 bf16, FTRL + dense Adam) through ``RecModel.train``
    over raw batches (``PrefetchToDevice``), 3 warm-up and 20 timed steps
    end to end; eager and captured in turns with busy shares; captured
    with dropout (keep_prob 0.9); captured == eager bit for bit over 5
    batches with dropout off and on; two replays' masks differ, each
    keeping its share within 0.5% of 0.9; an inf batch under
    ``check_overflow`` keeps the state; two state replacements, one
    capture each and one graph held; then the W&D bench recipe dense
    (vocab 5.86M, emb 16, 7x1024, bf16 m/v; ``--profile`` adds the
    device time of its parts), DeepFM, DCN and the multitable recipe at
    their default configs dense (ms/step, busy share; the multitable
    step captured == eager too), and DCN's one-hot
    lookup against its gather lookup at vocab 1,000, batch 4,096
    (logits, loss, table gradient; each step timed).  Its lines carry
    the card's name and power limit too.

Every kernel and every library call is timed by replaying a CUDA graph
of 10 calls (device time, no host work between the launches); the plain
versions, which synchronise, by an eager loop.

``--profile`` adds the device time by kernel over 5 more steps of
phases 3, 6, 10 and 13's bench recipe, and that step's parts.  It prints a ``{"kernels": [...]}`` JSON line before the
last line and ends with ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mindrec_tpu_torch import RecModel
from mindrec_tpu_torch.data.criteo import (
    PrefetchToDevice, SyntheticCriteo, to_device,
)
from mindrec_tpu_torch.data.outbrain import SyntheticOutbrain
from mindrec_tpu_torch.data.pipeline import (
    AdaptiveBucket, SparseInputPipeline, round_bucket,
)
from mindrec_tpu_torch.models.dcn import DCNConfig, DCNModel
from mindrec_tpu_torch.models.deepfm import DeepFMConfig, DeepFMModel
from mindrec_tpu_torch.models.multitable import (
    MULTI_FIELDS, MultiTableConfig, MultiTableWideDeepModel,
)
from mindrec_tpu_torch.models.wide_deep import WideDeepConfig, WideDeepModel
from mindrec_tpu_torch.ops import kernels, prng
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
from mindrec_tpu_torch.train.callbacks import Callback
from mindrec_tpu_torch.train.metrics import roc_auc
from mindrec_tpu_torch.train.step import (
    SENTINEL, CapturedStep, TrainState, _group_layouts, _state_tensors,
    init_train_state, make_batch_sort, make_eval_step, make_train_step,
    map_leaves, prep_groups,
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
SMI = ""  # the card's name and power limit (nvidia-smi), set by main()


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
    The random walk needs rounding errors of either sign: a segment of
    many equal terms (the compacted multi group's pads all read row 0)
    rounds the same way at every add of a long sequential sum, which the
    plain version's atomics take.  So the plain version is held to the
    larger of that and the worst case of a sequential float32 sum,
    n_s * 2**-24 * sum |g|; the kernel, whose sums run over chunks of at
    most 256 terms and then over their partials, to the random walk.
    Returns the max abs and rel difference of the kernel from the plain
    version."""
    keep = (ids >= 0) & (ids < n_out)
    idx, g64 = ids[keep].long(), g[keep].double()
    ref = torch.zeros((n_out, g.shape[1]), dtype=torch.float64, device=g.device)
    sq = torch.zeros_like(ref)
    mass = torch.zeros_like(ref)
    ref = ref.index_add_(0, idx, g64).T
    sq = sq.index_add_(0, idx, g64 * g64).T
    mass = mass.index_add_(0, idx, g64.abs()).T
    cnt = torch.bincount(idx, minlength=n_out)[:n_out].double()
    tol = 8.0 * 2.0**-24 * cnt.sqrt()[None, :] * sq.sqrt()
    tol_seq = torch.maximum(tol, 2.0**-24 * cnt[None, :] * mass)
    del g64, sq, mass
    for who, x, t in (("kernel", got, tol), ("plain version", plain, tol_seq)):
        err = (x.double() - ref).abs()
        if not bool((err <= t).all()):
            worst = int(torch.argmax(err - t))
            fail(f"{name} ({who}) disagrees with a float64 sum: max err "
                 f"{err.max().item()}, worst cell err "
                 f"{err.flatten()[worst].item()} > tol "
                 f"{t.flatten()[worst].item()}")
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


def sorted_cases(dev, wd=None, mt=None) -> list:
    """The sorted segment-sums as the steps call them, each a case
    ``(tag, uidx_sorted, perm, rows of g, D, n_out)`` on ``dev``: ``wd``
    = (host batch, bucket) of the W&D recipe gives its [N, 128] sum,
    ``mt`` = (host batch, buckets) of the multitable recipe those of its
    emb128 [N, 256], emb64_single and multi [N, 128] groups."""
    spec = [] if wd is None else [("W&D", "", 128, *wd)]
    if mt is not None:
        host, buckets = mt
        spec += [(grp, f"{grp}:", d, host, buckets[grp]) for grp, d in
                 (("emb128", 256), ("emb64_single", 128), ("multi", 128))]
    return [(tag, torch.from_numpy(h[f"{k}uidx_sorted"]).to(dev),
             torch.from_numpy(h[f"{k}perm"]).to(dev), h[f"{k}uidx"].size, d,
             n_out) for tag, k, d, h, n_out in spec]


def check_sorted(dev, gen, case, dtype=torch.bfloat16, timed=True) -> dict:
    """segsum_sorted on random [rows, d] batch-order gradients read
    through ``perm``, as the step passes them (``case`` as
    :func:`sorted_cases` gives it), against a float64 sum of ``g[perm]``
    and its plain version (the gather, then ``index_add_``);
    deterministic.  Timed beside the plain version, the ``g[perm.long()]``
    gather the step ran in front of the sum before it took ``perm`` (the
    cast included), and ``index_add_`` of the rows ``perm`` reads, in
    batch order, at their segment: one PyTorch call of the same sum, save
    that a row ``perm`` repeats (the compacted stream's pads repeat row
    0) is added once.
    Bound: each row of ``g`` that ``perm`` reads once (the pads' row 0
    once), ``perm`` and ``uidx`` once, ``out`` once."""
    tag, uidx, perm, rows, d, n_out = case
    g = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
    got = segsum_sorted(g, uidx, n_out, perm=perm)
    g_sorted = g[perm.long()]
    err, rel = check_segsum(f"segsum_sorted ({tag})", got,
                            segsum_sorted_plain(g, uidx, n_out, perm),
                            g_sorted, uidx, n_out)
    if not torch.equal(segsum_sorted(g, uidx, n_out, perm=perm), got):
        fail(f"segsum_sorted ({tag}) is not deterministic")
    del got, g_sorted
    runs = torch.unique_consecutive(uidx, return_counts=True)[1]
    n = uidx.numel()
    out = dict(max_abs_err=err, max_rel_err=rel, positions=n, rows=rows,
               perm_dtype=str(perm.dtype)[6:], segments=int(runs.numel()),
               longest_run=int(runs.max()) if n else 0)
    if not timed:
        return out
    p = perm.long()
    read = torch.unique(p)  # the rows the sum reads, in batch order
    t_b, by = bound(read.numel() * d * g.element_size()
                    + n * perm.element_size() + n * 4 + d * n_out * 4, n * d)
    seg = torch.empty(rows, dtype=torch.long, device=dev)
    seg[p] = uidx.long()
    seg = seg[read]
    keep = (seg >= 0) & (seg < n_out)
    g_lib, seg = g[read[keep]].float(), seg[keep]
    lib_out = torch.zeros((n_out, d), device=dev)
    out.update(
        rows_read=int(read.numel()),
        ms=graph_ms(lambda: segsum_sorted(g, uidx, n_out, perm=perm)),
        plain_ms=cuda_ms(lambda: segsum_sorted_plain(g, uidx, n_out, perm), 5),
        bound_ms=t_b, bound_by=by,
        library_ms=graph_ms(lambda: lib_out.index_add_(0, seg, g_lib)),
        gather_ms=graph_ms(lambda: g[perm.long()]),
    )
    log(f"[kernel] segsum_sorted ({tag} [{rows}, {d}] {str(dtype)[6:]} "
        f"through perm [{n}] -> [{d}, {n_out}])", json.dumps(out))
    return out


def check_sorted_edges(dev, gen) -> None:
    """segsum_sorted at the edge cases of ``tests/test_torch_cuda.py``
    (no positions; a hot id over more than 100 chunks of 256; all
    distinct; ids below 0 and past n_out; D 1, 13, 128, 256; identity,
    reversed, random and compacted ``perm``), bf16 and float32, held as
    at the step's shapes."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_cuda import SEGSUM_SORTED_CASES, segsum_sorted_case

    for case_id, n, d, n_out, pattern, shift, kind in SEGSUM_SORTED_CASES:
        g, uidx, perm = segsum_sorted_case(n, d, pattern, shift, kind)
        case = (case_id, torch.from_numpy(uidx).to(dev),
                torch.from_numpy(perm).to(dev), g.shape[0], d, n_out)
        for dt in (torch.float32, torch.bfloat16):
            check_sorted(dev, gen, case, dt, timed=False)
    log(f"[check] segsum_sorted at {len(SEGSUM_SORTED_CASES)} edge cases x "
        f"(f32, bf16): float64 tolerance, plain version, deterministic")


def phase_build() -> None:
    t0 = time.perf_counter()
    path = _build.build()
    log(f"[build] {path} in {time.perf_counter() - t0:.1f} s")
    for line in (path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("[build]", line.strip())
    _build.library()


def wd_setup():
    """The W&D bench recipe's data: 8 SyntheticCriteo batches, the x1.2
    unique bucket sized from them, and batch 0 host-prepared."""
    data = SyntheticCriteo(BATCH, FIELDS, VOCAB, steps=8, seed=0,
                           fields="criteo")
    bucket = AdaptiveBucket.from_sample(
        [data.get_batch(s) for s in range(len(data))]).bucket
    host0 = make_batch_sort(FIELDS)(data.get_batch(0))
    log(f"[data] bucket {bucket}, batch 0 has "
        f"{int(host0['uidx_sorted'][-1]) + 1} distinct ids")
    return data, bucket, host0


def phase_kernels(dev, gen, host_batch, bucket) -> dict:
    """Each kernel against its plain version at the recipe's shapes."""
    res = {}

    # -- segsum: g [N, 128] bf16, the step's per-position gradients in
    #    batch order, read through the batch's perm -----------------------
    res["segsum_sorted"] = check_sorted(
        dev, gen, sorted_cases(dev, wd=(host_batch, bucket))[0])

    # -- the unique slots of this batch, padded to the bucket -----------
    uq = torch.from_numpy(host_batch["uq_ids"][:bucket]).to(dev)
    if uq.numel() < bucket:
        uq = torch.cat([uq, uq.new_full((bucket - uq.numel(),), SENTINEL)])

    def slots(pack, n_rows):
        rows = torch.div(uq, pack, rounding_mode="floor")
        return rows, torch.remainder(uq, pack), int((rows < n_rows).sum())

    def slice_sectors(rows, sub, n_rows, dim, elts):
        """Whole 32-byte sectors of the [n_rows, 128] arrays that the live
        slots' dim-wide slices touch, summed over arrays of element sizes
        ``elts``."""
        live = rows < n_rows
        off = (rows[live].long() * 128 + sub[live].long() * dim)[:, None] \
            + torch.arange(dim, device=dev)
        return sum(sectors(off.flatten(), e) for e in elts)

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
    sec = slice_sectors(rows, sub, n_rows, dim, (4, 2, 2))
    res["adam_rows"] = dict(
        max_abs_err=err, max_rel_err=rel,
        ms=graph_ms(lambda: adam_rows(*a, rows, sub, gs, lr_t, **hyper)),
        plain_ms=cuda_ms(lambda: adam_rows_plain(*b, rows, sub, gs, lr_t, **hyper), 5),
        bound_ms=t_b, bound_by=by, library_ms=None,
        sector_bound_ms=bound(bucket * 8 + valid * dim * 4 + sec * 32 * 2,
                              0)[0],
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
    sec = slice_sectors(rows, sub, n_rows, dim, (4, 4, 4))
    res["ftrl_rows"] = dict(
        max_abs_err=err, max_rel_err=rel,
        ms=graph_ms(lambda: ftrl_rows(*a, rows, sub, gs, **hyper)),
        plain_ms=cuda_ms(lambda: ftrl_rows_plain(*b, rows, sub, gs, **hyper), 5),
        bound_ms=t_b, bound_by=by, library_ms=None,
        sector_bound_ms=bound(bucket * 8 + valid * dim * 4 + sec * 32 * 2,
                              0)[0],
    )
    log("[kernel] ftrl_rows", json.dumps(res["ftrl_rows"]))
    del table, accum, linear, a, b

    # -- both again on bf16 tables (the bf16-table bench extra): the
    #    kernels' bf16-table branches against their plain versions
    bf16 = torch.bfloat16
    pack, dim, n_rows = 8, EMB, 733184
    rows, sub, valid = slots(pack, n_rows)
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
    # as row 2's bound, with 2-byte weight and moments
    adam_b = bound(bucket * 8 + valid * dim * (4 + 2 * (2 + 2 + 2)),
                   valid * dim * 12)[0]
    del state, a, b
    pack, dim, n_rows = 128, 1, 47104
    rows, sub, valid = slots(pack, n_rows)
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
    ftrl_b = bound(bucket * 8 + valid * dim * (4 + 2 * (2 + 4 + 4)),
                   valid * dim * 16)[0]
    log(f"[check] adam_rows (bf16 table and m/v) and ftrl_rows (bf16 table) "
        f"== plain versions at the W&D shapes", json.dumps(dict(
            adam_ms=adam_ms, adam_bound_ms=adam_b, ftrl_ms=ftrl_ms,
            ftrl_bound_ms=ftrl_b)))
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


def wd_recipe():
    """The W&D bench recipe's model and optimizers (bench.py:86-119)."""
    cfg = WideDeepConfig(
        batch_size=BATCH, field_size=FIELDS, vocab_size=VOCAB, emb_dim=EMB,
        deep_layer_dim=(1024,) * 7, use_mixed_precision=True, sparse=True,
        loss_scale=1024.0,
    )
    opt_w = optim.ftrl(loss_scale=cfg.loss_scale)
    opt_d = optim.lazy_adam(loss_scale=cfg.loss_scale,
                            state_dtype=torch.bfloat16)
    return WideDeepModel(cfg), (opt_w, opt_d)


def phase_main_path(dev, data, bucket, warmup=3, steps=10,
                    profile=False) -> dict:
    """The train step at the benchmark recipe's full width."""
    model, (opt_w, opt_d) = wd_recipe()
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
    if isinstance(step, CapturedStep):
        step.reset_counts()
    t0 = time.perf_counter()
    for i in range(steps):
        state, (_lw, ld) = step(state, batches[(warmup + i) % len(batches)])
        losses.append(ld)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = real_launches(step)
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
        out["busy_share"] = busy / out["ms_per_step"]
        log(f"[profile] {tag} device busy share "
            f"{busy / out['ms_per_step']:.3f} of the unprofiled "
            f"{out['ms_per_step']:.3f} ms/step")
    return out


def real_launches(step) -> dict:
    """Kernel launches since the counters were set to 0.  A captured
    step's wrappers count their launches when a graph is captured, so its
    recorded launches are taken out and its replays' launches added."""
    out = dict(kernels.LAUNCHES)
    if isinstance(step, CapturedStep):
        for k in out:
            out[k] += step.replayed.get(k, 0) - step.recorded.get(k, 0)
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


def mt_recipe(batch=MT_BATCH, sparse=True):
    """The multitable recipe's model and optimizers
    (benchmarks/bench_multitable.py:63-97)."""
    cfg = MultiTableConfig(batch_size=batch, sparse=sparse)
    opt_w = optim.ftrl(learning_rate=cfg.ftrl_lr, l1=5e-4, l2=5e-4,
                       initial_accum=0.1, loss_scale=cfg.loss_scale)
    opt_d = optim.lazy_adam(learning_rate=cfg.adam_lr, eps=1e-6,
                            loss_scale=cfg.loss_scale)
    return MultiTableWideDeepModel(cfg), (opt_w, opt_d)


def mt_setup(batch=MT_BATCH, steps=2):
    """The multitable recipe (benchmarks/bench_multitable.py): model,
    optimizers, and ``steps`` host-prepared SyntheticOutbrain batches:
    the sorted groups prepped with the multi group compacted to its
    masked-in positions (kept budget x1.05) and each sorted group's
    unique ids trimmed to a shared x1.2 bucket."""
    model, (opt_w, opt_d) = mt_recipe(batch)
    cfg = model.config
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
    recipe's shapes, on host batch 0's ids; ``gather_rows`` and
    ``ftrl_cols`` at every launch shape of the step."""
    res = {}
    ub = buckets["emb128"]
    uq = torch.from_numpy(host0["emb128:uq_ids"][:ub]).to(dev)
    if uq.numel() < ub:
        uq = torch.cat([uq, uq.new_full((ub - uq.numel(),), SENTINEL)])
    valid = int((uq < model.config.emb_128_size).sum())

    def rnd(shape, scale):
        return scale * torch.randn(shape, generator=gen, device=dev)

    # -- gather: emb128 into lanes 0..127 of the [ub, 256] buffer, held
    #    against the yardsticks; every launch shape of the step follows ---
    t128 = rnd(model.specs["emb128"].storage_shape, 0.01)
    a = torch.zeros((ub, 256), device=dev)
    b = torch.zeros((ub, 256), device=dev)
    gather_rows(t128, uq, a, 0)
    gather_rows_plain(t128, uq, b, 0)
    err, rel = max_errs([(a, b)])
    if err != 0.0:
        fail(f"gather_rows disagrees: max err {err}")
    t_b, by, sec_b = gather_rows_bounds(t128, uq, 0, 256)
    live = uq[:valid].long()
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
        bound_ms=t_b, bound_by=by, library_ms=None, sector_bound_ms=sec_b,
        whole_table_ms=graph_ms(whole_table),
        select_transpose_ms=graph_ms(select_into_lanes),
        live_slots=valid,
    )
    log("[kernel] gather_rows (emb128 [128, 655360] -> [ub, 256] lanes 0..127)",
        json.dumps(res["gather_rows"]))
    del t128, a, b, col_max
    launches = table_launches(dev, model, host0)
    for case in launches:
        check_gather_launch(dev, gen, "multitable", case)
    torch.cuda.empty_cache()

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
    # the ones and ids read once, the [1, n_out] counts written once
    res["segsum_unsorted"]["presence_bound_ms"] = bound(
        n * 2 + n * 4 + n_out * 4, n)[0]
    log("[kernel] segsum_unsorted ([1.7M, 128] bf16 -> [128, 2048])",
        json.dumps(res["segsum_unsorted"]))
    del g, gf, lib_out, ones

    # -- sorted segsum of the three sorted groups, through their perm ----
    for case in sorted_cases(dev, mt=(host0, buckets)):
        check_sorted(dev, gen, case)
    check_sorted_edges(dev, gen)
    torch.cuda.empty_cache()

    # -- LazyAdam on emb128 [128, 655360], f32 m/v ----------------------
    res["adam_cols"] = check_adam_cols(
        "emb128, f32 m/v", dev, gen, model.specs["emb128"].storage_shape, 1,
        uq, None, torch.float32, eps=1e-6, loss_scale=1000.0)

    # -- FTRL on the four folded wide tables, as the step launches it ----
    for case in launches:
        if case["fold"] > 1:
            out = check_ftrl_launch(dev, gen, "multitable", case,
                                    plain=case["name"] == "w128")
            if case["name"] == "w128":
                res["ftrl_cols"] = out
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


def table_launches(dev, model, host, tiny_vocab=2048) -> list:
    """The gather and update launches of a row-layout step's feature-major
    tables, from one host-prepared batch, as ``train/step.py`` builds
    them: per table its name, group, storage shape, fold, the sorted
    storage columns (the group's unique ids, sentinel-padded to the bucket
    that the batch's ``uq_ids`` length rounds to, // fold; a tiny group's
    whole id space), their fold sub-rows (or None), the table's lane offset
    and the buffer's width, and for a tiny group the presence gate [1, ub]
    of the batch's ids, which multiplies the touch rows."""
    groups = getattr(model, "table_groups", None) or {
        "_default": {"keys": ("ids",), "tables": tuple(model.table_specs)}}
    out = []
    for g, lay in _group_layouts(model.table_specs, groups, tiny_vocab).items():
        gate = None
        if lay.tiny:
            ub = lay.id_bound
            uq = torch.arange(ub, dtype=torch.int32, device=dev)
            flat = np.concatenate([np.asarray(host[k]).reshape(-1)
                                   for k in lay.keys])
            seen = np.bincount(flat, minlength=ub)[:ub] > 0
            gate = torch.from_numpy(seen.astype(np.float32)).to(dev)[None]
        else:
            ids = host["uq_ids" if g == "_default" else f"{g}:uq_ids"]
            ub = round_bucket(ids.size)
            uq = torch.full((ub,), SENTINEL, dtype=torch.int32, device=dev)
            uq[:ids.size] = torch.from_numpy(np.ascontiguousarray(ids)).to(dev)
        for name in lay.tables:
            spec = model.table_specs[name][1]
            if spec.row_packed:
                continue
            fold = spec.fold
            out.append(dict(
                name=name, group=g, shape=spec.storage_shape, fold=fold,
                cols=torch.div(uq, fold, rounding_mode="floor").contiguous(),
                sub=torch.remainder(uq, fold) if fold > 1 else None,
                off=lay.offs[name], width=lay.width, gate=gate))
    return out


def live_cols(cols, vc):
    return cols[(cols >= 0) & (cols < vc)]


def sectors(cols, elt) -> int:
    """32-byte sectors of a table row that hold one of ``cols`` (or of a
    flat array that hold one of the element offsets ``cols``)."""
    return int(torch.unique(torch.div(cols, 32 // elt,
                                      rounding_mode="floor")).numel())


def digest(tensors) -> str:
    """Fingerprint of tensors' bytes: two trees' kernels, fed the same
    inputs, agree bit for bit when their digests do."""
    return hashlib.sha256(b"".join(
        x.contiguous().view(torch.uint8).cpu().numpy().tobytes()
        for x in tensors)).hexdigest()[:16]


def gather_rows_bounds(table, cols, off, width):
    """(bound ms, its kind, sector bound ms) of ``gather_rows``: every
    slot's column (4 B), each distinct live column's dp values and the dp
    lanes of each live slot written once; the sector bound moves whole
    32-byte sectors: those of each table row that hold a live column, and
    the sectors that each live slot's lanes [off, off + dp) touch."""
    dp, vc = table.shape
    live = live_cols(cols, vc)
    elt, n, valid = table.element_size(), cols.numel(), live.numel()
    t_b, by = bound(n * 4 + int(torch.unique(live).numel()) * dp * elt
                    + valid * dp * 4, 0)
    first = off * 4 // 32 if width * 4 % 32 == 0 else 0
    row_sec = -(-((off + dp) * 4) // 32) - first if width * 4 % 32 == 0 \
        else -(-(dp * 4) // 32)
    sec = bound(n * 4 + sectors(live, elt) * dp * 32 + valid * row_sec * 32,
                0)[0]
    return t_b, by, sec


def check_gather_launch(dev, gen, path, case, per_10=10) -> dict:
    """gather_rows at one launch shape of a step (``case`` as
    :func:`table_launches` gives it) on a random float32 table and buffer:
    equal to its plain version, timed beside its bound and sector bound;
    ``ms_lost`` = ``per_10`` launches (per 10 steps) x (ms - bound)."""
    dp, vc = case["shape"]
    cols, off, width = case["cols"], case["off"], case["width"]
    table = 0.01 * torch.randn((dp, vc), generator=gen, device=dev)
    a = torch.randn((cols.numel(), width), generator=gen, device=dev)
    b = a.clone()
    gather_rows(table, cols, a, off)
    gather_rows_plain(table, cols, b, off)
    if not torch.equal(a, b):
        fail(f"gather_rows ({path} {case['name']}) disagrees with its plain "
             f"version")
    t_b, _by, sec = gather_rows_bounds(table, cols, off, width)
    ms = graph_ms(lambda: gather_rows(table, cols, a, off))
    lanes = a[:, off:off + dp]
    out = dict(ms=ms, bound_ms=t_b, sector_bound_ms=sec, launches=per_10,
               ms_lost=per_10 * (ms - t_b), slots=cols.numel(),
               live_slots=int(live_cols(cols, vc).numel()),
               # yardstick: PyTorch's fill of the same lanes of every slot,
               # the writes alone
               lanes_fill_ms=graph_ms(lambda: lanes.fill_(0.0)))
    log(f"[launch] gather_rows ({path} {case['name']} [{dp}, {vc}] fold "
        f"{case['fold']} -> lanes {off}..{off + dp - 1} of "
        f"[{cols.numel()}, {width}])", json.dumps(out))
    return out


def ftrl_cols_bounds(table, cols, fold):
    """(bound ms, its kind, sector bound ms) of ``ftrl_cols``: every slot's
    column, the gradient and touch rows of the live slots (a sentinel
    slot's are not needed), and each touched element's weight and two
    state values read and written once (fold > 1: one element per live
    slot; fold 1: the dp sublanes of each distinct column); the sector
    bound moves whole 32-byte sectors of the three arrays' touched
    columns over all dp rows."""
    dp, vc = table.shape
    live = live_cols(cols, vc)
    valid = int(live.numel())
    touched = valid if fold > 1 else int(torch.unique(live).numel()) * dp
    io = cols.numel() * 4 + (dp + 8) * valid * 4
    t_b, by = bound(io + touched * (table.element_size() + 8) * 2,
                    touched * 16)
    sec = sum(sectors(live, e) for e in (table.element_size(), 4, 4))
    return t_b, by, bound(io + sec * dp * 32 * 2, 0)[0]


def check_ftrl_launch(dev, gen, path, case, per_10=10, plain=False) -> dict:
    """ftrl_cols at one launch shape of a step (``case`` as
    :func:`table_launches` gives it; a tiny group's touch rows gated by
    its presence) on random state: held to its plain version within rtol
    1e-6 (the same float32 operations in the same order, sums in slot
    order; ``bit_equal`` says whether it is exact), timed beside its
    bounds; ``plain`` also times the plain version."""
    dp, vc = case["shape"]
    cols, fold = case["cols"], case["fold"]
    aug = slot_grads(dev, gen, dp, fold, cols, case["sub"])
    if case["gate"] is not None:  # absent ids of a tiny group: no touch
        aug[dp:] *= case["gate"]
    shape = (dp, vc)
    base = [0.01 * torch.randn(shape, generator=gen, device=dev),
            0.1 + torch.rand(shape, generator=gen, device=dev),
            0.1 * torch.randn(shape, generator=gen, device=dev)]
    a = [x.clone() for x in base]
    b = [x.clone() for x in base]
    hyper = dict(dim=1 if fold > 1 else dp, fold=fold, learning_rate=5e-2,
                 l1=5e-4, l2=5e-4, loss_scale=1000.0)
    ftrl_cols(*a, cols, aug, **hyper)
    ftrl_cols_plain(*b, cols, aug, **hyper)
    err, rel = max_errs(zip(a, b))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
    bit_equal = all(torch.equal(x, y) for x, y in zip(a, b))
    t_b, by, sec = ftrl_cols_bounds(a[0], cols, fold)
    ms = graph_ms(lambda: ftrl_cols(*a, cols, aug, **hyper))
    out = dict(
        max_abs_err=err, max_rel_err=rel, bit_equal=bit_equal,
        digest=digest(a),
        ms=ms, bound_ms=t_b, bound_by=by, library_ms=None,
        sector_bound_ms=sec, launches=per_10, ms_lost=per_10 * (ms - t_b),
        slots=cols.numel(), live_slots=int(live_cols(cols, vc).numel()))
    if plain:
        out["plain_ms"] = cuda_ms(
            lambda: ftrl_cols_plain(*b, cols, aug, **hyper), 5)
    log(f"[launch] ftrl_cols ({path} {case['name']} [{dp}, {vc}] fold {fold}, "
        f"n {cols.numel()})", json.dumps(out))
    return out


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
    state_digest = digest(a)
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
        slots=n, live_slots=n_live, digest=state_digest,
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
    # whole 32-byte sectors of the live columns in each table row
    sec = bound(n * 4 + sectors(live, table.element_size()) * dp * 32
                + dp * n * 4, 0)[0]
    clamped = cols.clamp(0, vc - 1).long()
    out = dict(
        max_abs_err=err, max_rel_err=rel,
        ms=graph_ms(lambda: gather_cols(table, cols)),
        plain_ms=cuda_ms(lambda: gather_cols_plain(table, cols), 5),
        bound_ms=t_b, bound_by=by,
        library_ms=graph_ms(lambda: torch.index_select(table, 1, clamped)),
        sector_bound_ms=sec, live=int(live.numel()), distinct=distinct,
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


def fused_bounds(state, cols_u, aug, cols_g, fold):
    """(bound ms, its kind, sector bound ms, shared columns) of a fused
    update + gather: every update slot's and next id's column (4 B), the
    gradient and touch rows of the live update slots (a sentinel slot
    reads none), each touched element (its sublane's summed touch row,
    fold 1: touch row 0, above 0) of the weight and two state arrays read
    and written, every other element of the next columns' weights read
    (their untouched sublanes and the gather-only columns), and the rows
    written once.  The sector bound moves the whole 32-byte sectors of
    those elements instead."""
    dp, vc = state[0].shape
    ok = (cols_u >= 0) & (cols_u < vc)
    upd_cols, inv = torch.unique(cols_u[ok], return_inverse=True)
    touch = torch.zeros((8, upd_cols.numel()), device=aug.device)
    touch.index_add_(1, inv, aug[dp:][:, ok])
    gate = touch[:1].expand(dp, -1) if fold == 1 else touch[:dp]
    sub, at = torch.nonzero(gate > 0, as_tuple=True)
    touched = sub * vc + upd_cols[at].long()  # flat element offsets
    next_cols = torch.unique(cols_g[(cols_g >= 0) & (cols_g < vc)]).long()
    read = torch.unique(torch.cat([
        touched, (torch.arange(dp, device=aug.device)[:, None] * vc
                  + next_cols[None, :]).flatten()]))
    io = ((cols_u.numel() + cols_g.numel()) * 4
          + (dp + 8) * int(ok.sum()) * 4 + dp * cols_g.numel() * 4)
    w_e = state[0].element_size()
    st_e = sum(x.element_size() for x in state[1:])
    t_b, by = bound(io + read.numel() * w_e + touched.numel() * w_e
                    + touched.numel() * st_e * 2, touched.numel() * 16)
    sec = (sectors(read, w_e) + sectors(touched, w_e)
           + 2 * sum(sectors(touched, x.element_size()) for x in state[1:]))
    shared = int(torch.isin(next_cols, upd_cols.long()).sum())
    return t_b, by, bound(io + sec * 32, 0)[0], shared


def check_fused(tag, dev, gen, kind, shape, fold, ids_u, ids_g,
                state_dtype=torch.bfloat16) -> dict:
    """One fused update + gather against its plain version (state to
    rounding: the same float32 operations; rows exact from the updated
    table), timed beside the plain version, the separate update and
    gather kernels run one after the other, and each of the two alone.
    ``digest`` fingerprints the updated state and the rows."""
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
    state_digest = digest([*a, rows_a])
    del rows_a, rows_b, b
    t_b, by, sec, shared = fused_bounds(state, cols_u, aug, cols_g, fold)
    c = [x.clone() for x in state]

    def separate():
        update(c, cols_u, aug, **hyper)
        gather_cols(c[0], cols_g)

    out = dict(
        max_abs_err=err, max_rel_err=rel,
        ms=graph_ms(lambda: fused(a, cols_u, aug, cols_g, **hyper)),
        plain_ms=cuda_ms(lambda: plain(c, cols_u, aug, cols_g, **hyper), 3),
        bound_ms=t_b, bound_by=by, library_ms=None, sector_bound_ms=sec,
        separate_kernels_ms=graph_ms(separate),
        update_kernel_ms=graph_ms(lambda: update(c, cols_u, aug, **hyper)),
        gather_kernel_ms=graph_ms(lambda: gather_cols(c[0], cols_g)),
        live_update_slots=int(((cols_u >= 0) & (cols_u < vc)).sum()),
        live_next=int(((cols_g >= 0) & (cols_g < vc)).sum()),
        shared_columns=shared, digest=state_digest,
    )
    log(f"[kernel] {name} ({tag} [{dp}, {vc}] fold {fold}, n_u "
        f"{cols_u.numel()}, n_g {cols_g.numel()})", json.dumps(out))
    return out


def fused_shapes(fm_host, wd_host) -> list:
    """The five launch shapes of the fused kernels, from two host-prepared
    batches of each recipe (update batch 0, gather batch 1): (tag,
    optimizer, storage shape, fold, update ids, next ids)."""
    fm = DeepFMModel(DeepFMConfig(vocab_size=FM_VOCAB, sparse=True,
                                  table_layout="feature_major"))
    wd = WideDeepModel(WideDeepConfig(vocab_size=VOCAB, emb_dim=EMB,
                                      sparse=True,
                                      table_layout="feature_major"))
    w0, w1 = wd_host[0]["uq_ids"], wd_host[1]["uq_ids"]
    f0, f1 = fm_host[0]["uq_ids"], fm_host[1]["uq_ids"]
    return [
        ("W&D deep", "adam", wd.deep_spec.storage_shape, 1, w0, w1),
        ("W&D wide", "ftrl", wd.wide_spec.storage_shape, 8, w0, w1),
        ("DeepFM fm", "adam", fm.v_spec.storage_shape, 1, f0, f1),
        ("DeepFM linear", "adam", fm.w_spec.storage_shape, 8, f0, f1),
        ("DeepFM linear", "ftrl", fm.w_spec.storage_shape, 8, f0, f1),
    ]


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
    uq0 = fm_host[0]["uq_ids"]
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
    # gather_rows as the DeepFM row_layout=True step launches it (the
    # feature-major fm and folded linear tables, bucket 131,072)
    fm_rows = {**fm_host[0], "uq_ids": fm_host[0]["uq_ids"][:FM_BUCKET]}
    for case in table_launches(dev, fm, fm_rows):
        check_gather_launch(dev, gen, "DeepFM row_layout=True", case)
    torch.cuda.empty_cache()
    uidx = torch.from_numpy(fm_host[0]["uidx_sorted"]).to(dev)
    res["segsum_cols"] = check_segsum_cols("DeepFM", dev, gen,
                                           fm_v[0] + fm_w[0], uidx)
    check_segsum_cols("W&D", dev, gen, wd_d[0] + wd_w[0],
                      torch.from_numpy(wd_host[0]["uidx_sorted"]).to(dev))
    check_segsum_cols_edges(dev, gen)
    # the fused kernels: the W&D shapes are reported in the kernels line
    for tag, kind, shape, fold, ids_u, ids_g in fused_shapes(fm_host,
                                                            wd_host):
        torch.cuda.empty_cache()
        out = check_fused(tag, dev, gen, kind, shape, fold, ids_u, ids_g)
        res.setdefault(f"fused_{kind}_gather", out)
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


def dcn_recipe():
    """bench.py's DCN recipe: model and its two Adams (bf16 m/v)."""
    cfg = DCNConfig(
        batch_size=BATCH, field_size=FIELDS, vocab_size=DCN_VOCAB, emb_dim=27,
        deep_layer_dim=(1024, 1024), cross_layer_num=6,
        use_mixed_precision=True, sparse=True, loss_scale=1024.0,
    )
    opts = tuple(optim.adam(learning_rate=cfg.learning_rate,
                            loss_scale=cfg.loss_scale,
                            state_dtype=torch.bfloat16) for _ in range(2))
    return DCNModel(cfg), opts


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
    model, opts = dcn_recipe()
    batches = [to_device(hb, dev)
               for hb in criteo_host_batches(DCN_VOCAB, 4, bucket=FM_BUCKET)]
    state = init_train_state(model, 0, *opts, device=dev)
    timed_steps("dcn-packed", make_train_step(model, *opts), state, batches,
                BATCH, DCN_PER_STEP)


# ---------------------------------------------------------------------------
# phase 12: RecModel over the native-prep pipeline, the step captured
# ---------------------------------------------------------------------------


class DeviceLosses(Callback):
    """Keeps each step's deep loss on the card (no host read per step)."""

    def __init__(self):
        self.losses = []

    def on_train_step_end(self, ctx):
        self.losses.append(ctx.net_outputs[1])


def rec_log(tag: str, msg: str) -> None:
    log(f"[{tag}] ({SMI}) {msg}")


def rec_train(tag, rm, raw, batch_size, per_step) -> dict:
    """``RecModel.train`` over raw host batches, timed end to end (native
    prep, staging, captured step; host clock to a synchronize) with the
    launch counters set to 0 just before and read just after."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    rm.train_step.reset_counts()
    rec = DeviceLosses()
    t0 = time.perf_counter()
    rm.train(1, raw, callbacks=[rec], dataset_sink_mode=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = real_launches(rm.train_step)
    losses = torch.stack(rec.losses).float().cpu().numpy()
    out = dict(samples_per_s=len(raw) * batch_size / dt,
               ms_per_step=dt / len(raw) * 1e3, steps=len(raw),
               captures=rm.train_step.captures, replays=rm.train_step.replays,
               launches=launches, last_loss=float(losses[-1]))
    rec_log(tag, json.dumps(out))
    if len(losses) != len(raw) or not np.isfinite(losses).all():
        fail(f"{tag}: {len(losses)} steps for {len(raw)} batches, losses "
             f"{losses}")
    for k, per in per_step.items():
        if launches[k] < per * len(raw):
            fail(f"{tag}: kernel {k} launched {launches[k]} times in "
                 f"{len(raw)} steps (expected {per} per step)")
    return out


def pace(tag, dev, raw, pipe_kw, step_ms, e2e_ms) -> dict:
    """Which stage sets the end-to-end pace: the prep pool alone (1, 2
    and 4 workers, no consumer) and the staging alone (pinned copy and
    side-stream transfer of prepped batches, no step), in ms per batch,
    beside the captured step and the end-to-end time."""
    out = {}
    for workers in (1, 2, 4):
        t0 = time.perf_counter()
        prepped = list(SparseInputPipeline(raw, workers=workers, device=False,
                                           **pipe_kw()))
        out[f"prep_pool_{workers}w_ms"] = (time.perf_counter() - t0) / len(raw) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = list(PrefetchToDevice(iter(prepped), depth=2, device=dev))
    torch.cuda.synchronize()
    out["staging_ms"] = (time.perf_counter() - t0) / len(raw) * 1e3
    out["staged_mb_per_batch"] = sum(t.numel() * t.element_size()
                                     for t in staged[0].values()) / 1e6
    out.update(captured_step_ms=step_ms, end_to_end_ms=e2e_ms)
    stages = {"prep (2 workers)": out["prep_pool_2w_ms"],
              "staging": out["staging_ms"], "captured step": step_ms}
    out["set_by"] = max(stages, key=stages.get)
    rec_log(tag, json.dumps(out))
    return out


def prep_ms(prep, raw, reps) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        prep(dict(raw))
    return (time.perf_counter() - t0) / reps * 1e3


def captured_vs_eager_turns(tag, dev, model, opts, batches, batch_size,
                            per_step, warmup, steps) -> dict:
    """ms/step of the eager and the captured step on staged batches, in
    turns (eager, captured, captured, eager), device busy share of the
    first of each by torch.profiler."""
    ms = {"eager": [], "captured": []}
    busy = {}
    for kind in ("eager", "captured", "captured", "eager"):
        state = init_train_state(model, 0, *opts, device=dev)
        step = make_train_step(model, *opts, jit=kind == "captured")
        prof = kind not in busy
        out = timed_steps(f"{tag}-{kind}", step, state, batches, batch_size,
                          per_step, warmup, steps, profile=prof)
        ms[kind].append(out["ms_per_step"])
        if prof:
            busy[kind] = out["busy_share"]
        del state, step
        torch.cuda.empty_cache()
    rec_log(f"{tag}-compare", f"ms/step in turns: eager {ms['eager'][0]:.3f}, "
            f"captured {ms['captured'][0]:.3f}, {ms['captured'][1]:.3f}, "
            f"eager {ms['eager'][1]:.3f}; device busy share: eager "
            f"{busy['eager']:.3f}, captured {busy['captured']:.3f}")
    return {"ms": ms, "busy_share": busy}


def state_diffs(a, b) -> list:
    """(leaf, max abs difference) of the leaves of two states that are
    not bit-equal."""
    out = []
    for i, (x, y) in enumerate(zip(_state_tensors(a), _state_tensors(b))):
        if not torch.equal(x, y):
            out.append((i, float((x.float() - y.float()).abs().max())))
    return out


def check_captured_equals_eager(tag, dev, model, opts, batches) -> None:
    """From one state (two copies), the captured and the eager step over
    the same batches: losses and every leaf bit-equal."""
    se = init_train_state(model, 1, *opts, device=dev)
    sc = init_train_state(model, 1, *opts, device=dev)
    eager = make_train_step(model, *opts)
    cap = make_train_step(model, *opts, jit=True)
    for i, b in enumerate(batches):
        se, le = eager(se, b)
        sc, lc = cap(sc, b)
        if not all(torch.equal(x, y) for x, y in zip(le, lc)):
            fail(f"{tag}: step {i} losses eager {le} captured {lc}")
    diffs = state_diffs(se, sc)
    if diffs:
        fail(f"{tag}: captured state differs from eager in leaves "
             f"(index, max abs diff) {diffs}")
    rec_log(tag, f"captured == eager, bit for bit, over {len(batches)} steps "
            f"({len(_state_tensors(se))} leaves, {cap.captures} capture, "
            f"{cap.replays} replays)")
    del se, sc
    torch.cuda.empty_cache()


def phase_rec_wd(dev, model, opts, steps=20, warmup=3) -> dict:
    """12.1-12.4: the W&D bench recipe through ``RecModel.train``."""
    data = SyntheticCriteo(BATCH, FIELDS, VOCAB, steps=warmup + steps + 4,
                           seed=0, fields="criteo")
    t0 = time.perf_counter()
    raw = [data.get_batch(s) for s in range(len(data))]
    log(f"[rec-data] {len(raw)} raw batches in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    bucket = AdaptiveBucket.from_sample(raw[:2])
    native = make_batch_sort(FIELDS, unique_bucket=bucket.bucket, minimal=True)
    numpy_ = make_batch_sort(FIELDS, unique_bucket=bucket.bucket,
                             minimal=True, native=False)
    nat_ms, np_ms = prep_ms(native, raw[0], 10), prep_ms(numpy_, raw[0], 3)
    rec_log("rec-prep", f"W&D batch {BATCH}x{FIELDS}: native prep "
            f"{nat_ms:.2f} ms/batch, numpy {np_ms:.2f} ms/batch (one thread)")

    rm = RecModel(model, *opts, unique_bucket=bucket, prep_workers=2,
                  jit=True, device=dev)
    warm = rec_train("rec-wd-warmup", rm, raw[:warmup], BATCH, WD_PER_STEP)
    if warm["captures"] != 1:
        fail(f"rec-wd: {warm['captures']} captures in the warm-up")
    out = rec_train("rec-wd", rm, raw[warmup:warmup + steps], BATCH,
                    WD_PER_STEP)
    if out["captures"] or out["replays"] != steps:
        fail(f"rec-wd: {out['captures']} captures, {out['replays']} replays")

    held = raw[warmup + steps:]
    auc = rm.eval(held)["auc"]
    ev = make_eval_step(model)
    probs, labels = [], []
    for b in held:
        p, y = ev(rm.state.params, to_device(b, dev))
        probs.append(p.float().cpu().numpy())
        labels.append(y.float().cpu().numpy())
    want = roc_auc(np.concatenate(labels), np.concatenate(probs))
    if auc != want or not 0.0 < auc < 1.0:
        fail(f"rec-wd eval: RecModel.eval AUC {auc} != make_eval_step + "
             f"roc_auc {want}")
    rec_log("rec-eval", f"RecModel.eval AUC {auc:.6f} on {len(held)} held-out "
            f"batches == make_eval_step + roc_auc")
    del rm
    torch.cuda.empty_cache()

    staged = []
    for b in raw[:8]:
        hb = native(b)
        hb["uq_ids"] = hb["uq_ids"][: bucket.bucket]
        staged.append(to_device(hb, dev))
    out["turns"] = captured_vs_eager_turns("rec-wd", dev, model, opts, staged,
                                           BATCH, WD_PER_STEP, 3, 10)
    out["pace"] = pace(
        "rec-wd-pace", dev, raw[warmup:warmup + steps],
        lambda: dict(field_size=FIELDS, policy=AdaptiveBucket(
            bucket.bucket, log=lambda *a, **k: None)),
        min(out["turns"]["ms"]["captured"]), out["ms_per_step"])
    check_captured_equals_eager("rec-wd-equal", dev, model, opts, staged[:5])
    out.update(native_prep_ms=nat_ms, numpy_prep_ms=np_ms,
               bucket=bucket.bucket, auc=auc)
    return out


def phase_rec_regrow(dev, model, opts) -> None:
    """12.3: a bucket below what later batches need: one regrow, one new
    capture, and the state equal to an eager run with the same regrow."""
    lo = SyntheticCriteo(BATCH, FIELDS, VOCAB, steps=3, seed=50,
                         fields="criteo")
    hi = SyntheticCriteo(BATCH, FIELDS, VOCAB, steps=3, seed=60,
                         fields="criteo", zipf_a=1.05)
    raw = [lo.get_batch(i) for i in range(3)] + [hi.get_batch(i)
                                                 for i in range(3)]
    nus = [int(np.unique(b["ids"]).size) for b in raw]
    start = max(nus[:3])
    if min(nus[3:]) <= round_bucket(start):
        fail(f"rec-regrow: distinct ids {nus} need no regrow from {start}")
    grows = []
    rm = RecModel(model, *opts, seed=2, prep_workers=1, jit=True, device=dev,
                  unique_bucket=AdaptiveBucket(start, log=lambda *a, **k:
                                               grows.append(a[0])))
    rm.train(1, raw, dataset_sink_mode=True)
    cap = rm.train_step
    grew = [g for g in grows if "overflow:" in g]
    if len(grew) != 1 or cap.captures != 2 or cap.replays != 4:
        fail(f"rec-regrow: {len(grew)} regrows, {cap.captures} captures, "
             f"{cap.replays} replays (expected 1, 2, 4): {grows}")
    st = init_train_state(model, 2, *opts, device=dev)
    step = make_train_step(model, *opts)
    pol = AdaptiveBucket(start, log=lambda *a, **k: None)
    for b in SparseInputPipeline(raw, FIELDS, policy=pol, workers=1):
        st, _ = step(st, b)
    diffs = state_diffs(st, rm.state)
    if diffs or pol.bucket != rm.bucket_policy.bucket:
        fail(f"rec-regrow: captured run differs from the eager run "
             f"(buckets {rm.bucket_policy.bucket}, {pol.bucket}): {diffs}")
    rec_log("rec-regrow", f"distinct ids {nus}: bucket "
            f"{round_bucket(start)} -> {pol.bucket}, 1 regrow, 2 captures, 4 "
            f"replays; state == the eager run's, bit for bit")
    del rm, st
    torch.cuda.empty_cache()


def phase_captured_others(dev, fm_host) -> dict:
    """12.6: the DeepFM (feature-major with ``row_layout=False``, and the
    default path) and DCN steps captured, on the staged batches of phases
    10-11: ms/step and device busy share (their eager runs are above)."""
    out = {}
    model, opts = deepfm_recipe("feature_major")
    full = [to_device(hb, dev) for hb in fm_host]
    state = init_train_state(model, 0, *opts, device=dev)
    out["deepfm-col"] = timed_steps(
        "rec-deepfm-col-captured", make_train_step(model, *opts, jit=True,
                                                   row_layout=False),
        state, full, BATCH, FM_COL_PER_STEP, profile=True)
    del state, full
    model, opts = deepfm_recipe("auto")
    trimmed = [to_device({**hb, "uq_ids": hb["uq_ids"][:FM_BUCKET]}, dev)
               for hb in fm_host]
    state = init_train_state(model, 0, *opts, device=dev)
    out["deepfm-packed"] = timed_steps(
        "rec-deepfm-packed-captured", make_train_step(model, *opts, jit=True),
        state, trimmed, BATCH, FM_PACKED_PER_STEP, profile=True)
    del state, trimmed
    torch.cuda.empty_cache()
    model, opts = dcn_recipe()
    batches = [to_device(hb, dev)
               for hb in criteo_host_batches(DCN_VOCAB, 4, bucket=FM_BUCKET)]
    state = init_train_state(model, 0, *opts, device=dev)
    out["dcn-packed"] = timed_steps(
        "rec-dcn-packed-captured", make_train_step(model, *opts, jit=True),
        state, batches, BATCH, DCN_PER_STEP, profile=True)
    del state, batches
    torch.cuda.empty_cache()
    rec_log("rec-captured-others", json.dumps(
        {k: {"ms_per_step": v["ms_per_step"], "busy_share": v["busy_share"]}
         for k, v in out.items()}))
    return out


def phase_rec_mt(dev, warmup=3, steps=5) -> dict:
    """12.5: the multitable recipe through ``RecModel(host_prep=True)``:
    per-group lossless native prep."""
    model, opts = mt_recipe()
    data = SyntheticOutbrain(model.config, warmup + steps, seed=0)
    t0 = time.perf_counter()
    raw = [data.get_batch(i) for i in range(warmup + steps)]
    log(f"[rec-data] {len(raw)} raw multitable batches in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    groups = prep_groups(model)
    native = make_batch_sort(0, groups=groups, minimal=True)
    numpy_ = make_batch_sort(0, groups=groups, minimal=True, native=False)
    nat_ms, np_ms = prep_ms(native, raw[0], 3), prep_ms(numpy_, raw[0], 1)
    rec_log("rec-prep", f"multitable batch {MT_BATCH}, groups "
            f"{sorted(groups)}: native prep {nat_ms:.2f} ms/batch, numpy "
            f"{np_ms:.2f} ms/batch (one thread)")
    rm = RecModel(model, *opts, host_prep=True, prep_workers=2, jit=True,
                  device=dev)
    rec_train("rec-mt-warmup", rm, raw[:warmup], MT_BATCH, MT_PER_STEP)
    out = rec_train("rec-mt", rm, raw[warmup:], MT_BATCH, MT_PER_STEP)
    if out["captures"] or out["replays"] != steps:
        fail(f"rec-mt: {out['captures']} captures, {out['replays']} replays")
    del rm
    torch.cuda.empty_cache()
    staged = [to_device(native(b), dev) for b in raw[:5]]
    out["turns"] = captured_vs_eager_turns("rec-mt", dev, model, opts,
                                           staged[:4], MT_BATCH, MT_PER_STEP,
                                           2, 5)
    out["pace"] = pace("rec-mt-pace", dev, raw[warmup:],
                       lambda: dict(field_size=0, groups=groups),
                       min(out["turns"]["ms"]["captured"]), out["ms_per_step"])
    check_captured_equals_eager("rec-mt-equal", dev, model, opts, staged)
    out.update(native_prep_ms=nat_ms, numpy_prep_ms=np_ms)
    return out


# ---------------------------------------------------------------------------
# phase 13: the dense step (every model config's default), dropout, one-hot
# ---------------------------------------------------------------------------

ACC_VOCAB = 200_000  # WideDeepConfig() = examples/wide_deep_config.yaml


def dense_wd_recipe(**kw):
    """The W&D reference accuracy recipe: ``WideDeepConfig()`` defaults
    (batch 16000 x 39, vocab 200,000, emb 80, 1024-512-256-128 bf16 MLP,
    dense tables, l2 8e-5, loss scale 1024) with FTRL + dense Adam, as
    ``examples/train_criteo.py:93-112`` and ``RecModel`` build them."""
    model = WideDeepModel(WideDeepConfig(**kw))
    sens = model.config.loss_scale
    return model, (optim.ftrl(loss_scale=sens), optim.adam(loss_scale=sens))


def replace_state(state):
    """A new state holding the same values in new tensors, as a callback
    that replaces the train state hands one over."""
    def copy(node):
        return map_leaves(lambda _k, t: t.clone(), node)

    return TrainState(copy(state.params), copy(state.opt_w),
                      copy(state.opt_d), state.step.clone(), state.rng.clone())


def check_dropout_masks(tag, dev, model, opts, batches, keep_prob) -> None:
    """The captured dense step with dropout: two replays draw different
    masks at every layer, each keeping its share within 0.5% of
    ``keep_prob``.  The masks are the graph's own outputs, taken by
    wrapping ``prng.bernoulli`` while the step is captured."""
    drawn, real = [], prng.bernoulli

    def record(key, p, shape):
        drawn.append(real(key, p, shape))
        return drawn[-1]

    state = init_train_state(model, 2, *opts, device=dev)
    cap = make_train_step(model, *opts, jit=True)
    prng.bernoulli = record
    try:
        state, _ = cap(state, batches[0])  # eager warm-up, then the capture
    finally:
        prng.bernoulli = real
    masks = drawn[-len(model.mlp_dims):]
    seen = []
    for b in batches[1:3]:
        state, _ = cap(state, b)
        seen.append([m.clone() for m in masks])
    shares = [[round(m.float().mean().item(), 6) for m in ms] for ms in seen]
    same = [torch.equal(a, b) for a, b in zip(*seen)]
    off = [x for row in shares for x in row if abs(x / keep_prob - 1) > 0.005]
    rec_log(tag, f"kept share per layer in replays 1 and 2: {shares}; "
            f"masks equal across the replays, per layer: {same}")
    if any(same) or off or (cap.captures, cap.replays) != (1, 2):
        fail(f"{tag}: shares {shares}, equal {same}, captures "
             f"{cap.captures}, replays {cap.replays}")
    del state, cap, drawn, masks, seen
    torch.cuda.empty_cache()


def check_dense_guard(tag, dev, model, opts, batches) -> None:
    """``check_overflow`` on the captured dense step: a batch with an inf
    keeps every parameter and optimizer leaf and advances the step and
    the key; the next batch trains."""
    state = init_train_state(model, 3, *opts, device=dev)
    step = make_train_step(model, *opts, check_overflow=True, jit=True)
    state, _ = step(state, batches[0])
    bad = dict(batches[1])
    bad["wts"] = bad["wts"].clone()
    bad["wts"][0, 0] = float("inf")
    before = [t.clone() for t in _state_tensors(state)]
    state, _ = step(state, bad)
    after = _state_tensors(state)  # ... rng, step last
    kept = all(torch.equal(x, y) for x, y in zip(before[:-2], after[:-2]))
    moved = (not torch.equal(before[-2], after[-2])
             and int(after[-1]) == int(before[-1]) + 1)
    state, (_, ld) = step(state, batches[2])
    ok = kept and moved and np.isfinite(float(ld))
    rec_log(tag, f"inf batch: {len(after) - 2} leaves kept {kept}, step and "
            f"key advanced {moved}; next loss {float(ld):.6f}")
    if not ok or (step.captures, step.replays) != (1, 2):
        fail(f"{tag}: kept {kept}, advanced {moved}, loss {float(ld)}")
    del state, step, before
    torch.cuda.empty_cache()


def check_graph_cache(tag, dev, model, opts, batches) -> None:
    """A callback replaces the state twice: each replacement gives one new
    capture and leaves the step one graph (the live state's one batch
    signature), and the run equals an eager run with the same
    replacements, bit for bit.  Device memory reserved (after
    ``empty_cache``) is printed beside each state: graphs of replaced
    states and their pools are gone."""
    se = init_train_state(model, 5, *opts, device=dev)
    sc = init_train_state(model, 5, *opts, device=dev)
    eager = make_train_step(model, *opts)
    cap = make_train_step(model, *opts, jit=True)
    held, reserved = [], []
    for i, b in enumerate(batches[:3]):
        if i:
            se, sc = replace_state(se), replace_state(sc)
        se, le = eager(se, b)
        sc, lc = cap(sc, b)
        if not all(torch.equal(x, y) for x, y in zip(le, lc)):
            fail(f"{tag}: state {i} losses eager {le} captured {lc}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held.append((cap.captures, cap.graphs))
        reserved.append(torch.cuda.memory_reserved(dev))
    diffs = state_diffs(se, sc)
    rec_log(tag, f"(captures, graphs held) after each of 3 states: {held}; "
            f"memory reserved {reserved} bytes; captured == eager: "
            f"{not diffs}")
    if held != [(1, 1), (2, 1), (3, 1)] or diffs:
        fail(f"{tag}: {held}, diffs {diffs}")
    del se, sc, eager, cap
    torch.cuda.empty_cache()


def dense_parts(tag, dev, model, opts, state, batch) -> dict:
    """Device time (CUDA-graph replay) of the dense W&D step's parts at
    its shapes: the two lookups, their backward into full-table gradients
    (zero fill and the sorted chunked sum of ``embedding``), the deep
    table's l2 term (forward and backward), the dense Adam and FTRL over
    the full tables, and the MLP forward and backward (cuBLAS and its
    elementwise work).  Beside them, not in the sum: the same gradients
    by the backward of ``table[ids]`` (a zero fill and an accumulating
    index-put)."""
    c = model.config
    idx = batch["ids"].reshape(-1).long()
    deep, wide = state.params["deep"]["table"], state.params["wide"]["table"]
    gen = torch.Generator(device=dev).manual_seed(9)
    g_rows = torch.randn((idx.numel(), c.emb_dim), generator=gen, device=dev)
    g_wide = torch.randn((idx.numel(), 1), generator=gen, device=dev)
    g_deep = torch.randn(deep.shape, generator=gen, device=dev)
    g_wtab = torch.randn(wide.shape, generator=gen, device=dev)
    x = torch.randn((idx.numel() // c.field_size, c.field_size * c.emb_dim),
                    generator=gen, device=dev)

    def lookups():
        torch.nn.functional.embedding(idx, deep)
        torch.nn.functional.embedding(idx, wide)

    def table_grads():
        for t, g in ((deep, g_rows), (wide, g_wide)):
            torch.ops.aten.embedding_dense_backward(g, idx, t.shape[0], -1,
                                                    False)

    def index_put():
        torch.zeros_like(deep).index_put_((idx,), g_rows, accumulate=True)
        torch.zeros_like(wide).index_put_((idx,), g_wide, accumulate=True)

    def l2():
        t = deep.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = c.l2_coef * 0.5 * torch.sum(torch.square(t.float()))
            torch.autograd.grad(loss, t)

    def updates():
        opts[1].update_leaf(g_deep, state.opt_d["deep/table"], deep)
        opts[0].update_leaf(g_wtab, state.opt_w["wide/table"], wide)

    def mlp():
        p = [{k: v.detach().requires_grad_(True) for k, v in layer.items()}
             for layer in state.params["deep"]["mlp"]]
        xg = x.detach().requires_grad_(True)
        with torch.enable_grad():
            out = model._mlp(p, xg)
            torch.autograd.grad(out.sum(), [xg, *(t for lay in p
                                                   for t in lay.values())])

    out = {}
    for name, fn in (("lookups", lookups), ("table_grads", table_grads),
                     ("l2", l2), ("updates", updates), ("mlp", mlp)):
        out[name] = graph_ms(fn, calls=4, replays=3)
        torch.cuda.empty_cache()
    out["sum"] = sum(out.values())
    out["table_grads_index_put"] = graph_ms(index_put, calls=4, replays=3)
    rec_log(tag, json.dumps(out))
    return out


def phase_dense_wd(dev, steps=20, warmup=3) -> dict:
    """13.1: the W&D reference accuracy recipe through ``RecModel.train``
    (raw host batches, ``PrefetchToDevice``, the captured dense step) end
    to end; eager and captured in turns on staged batches; captured with
    dropout (keep_prob 0.9); captured == eager bit for bit with dropout
    off and on; the dropout masks across replays; the guard; replaced
    states."""
    model, opts = dense_wd_recipe()
    data = SyntheticCriteo(BATCH, FIELDS, ACC_VOCAB, steps=warmup + steps,
                           seed=0, fields="criteo")
    raw = [data.get_batch(s) for s in range(len(data))]
    rm = RecModel(model, *opts, jit=True, device=dev)
    warm = rec_train("dense-wd-warmup", rm, raw[:warmup], BATCH, {})
    out = rec_train("dense-wd", rm, raw[warmup:], BATCH, {})
    if warm["captures"] != 1 or out["captures"] or out["replays"] != steps:
        fail(f"dense-wd: captures {warm['captures']}, {out['captures']}, "
             f"replays {out['replays']}")
    del rm
    torch.cuda.empty_cache()
    staged = [to_device(b, dev) for b in raw[:6]]
    out["turns"] = captured_vs_eager_turns("dense-wd", dev, model, opts,
                                           staged, BATCH, {}, 3, 10)
    check_captured_equals_eager("dense-wd-equal", dev, model, opts, staged[:5])
    dmodel, dopts = dense_wd_recipe(dropout_flag=True, keep_prob=0.9)
    state = init_train_state(dmodel, 0, *dopts, device=dev)
    out["dropout"] = timed_steps(
        "dense-wd-dropout-captured", make_train_step(dmodel, *dopts, jit=True),
        state, staged, BATCH, {})
    del state
    torch.cuda.empty_cache()
    check_captured_equals_eager("dense-wd-dropout-equal", dev, dmodel, dopts,
                                staged[:5])
    check_dropout_masks("dense-wd-dropout-masks", dev, dmodel, dopts, staged,
                        0.9)
    check_dense_guard("dense-wd-guard", dev, model, opts, staged)
    check_graph_cache("dense-graphs", dev, model, opts, staged)
    return out


def phase_dense_bench(dev, profile=False) -> dict:
    """13.2: the W&D bench recipe dense (``bench.py --dense``,
    ``bench.py:86-101``): vocab 5.86M (deep table [5865472, 16] f32), 7 x
    1024 bf16 MLP, FTRL + Adam with bf16 m/v, captured; ``--profile``
    adds the device time by kernel and by part of the step."""
    cfg = WideDeepConfig(
        batch_size=BATCH, field_size=FIELDS, vocab_size=VOCAB, emb_dim=EMB,
        deep_layer_dim=(1024,) * 7, use_mixed_precision=True, sparse=False,
        loss_scale=1024.0)
    model = WideDeepModel(cfg)
    opts = (optim.ftrl(loss_scale=1024.0),
            optim.lazy_adam(loss_scale=1024.0, state_dtype=torch.bfloat16))
    data = SyntheticCriteo(BATCH, FIELDS, VOCAB, steps=4, seed=0,
                           fields="criteo")
    batches = [to_device(data.get_batch(s), dev) for s in range(4)]
    state = init_train_state(model, 0, *opts, device=dev)
    out = timed_steps("dense-bench-captured",
                      make_train_step(model, *opts, jit=True), state, batches,
                      BATCH, {}, profile=profile)
    if profile:
        out["parts"] = dense_parts("dense-bench-parts", dev, model, opts,
                                   state, batches[0])
    del state, batches
    torch.cuda.empty_cache()
    return out


def phase_dense_others(dev) -> dict:
    """13.3: DeepFM and DCN at their default configs and the multitable
    recipe (batch 131,072) with ``sparse=False``, captured, with the
    optimizers ``examples/train_criteo.py`` and
    ``benchmarks/bench_multitable.py`` give them; the multitable step
    also captured == eager over 3 batches."""
    out = {}
    fm = DeepFMModel(DeepFMConfig())
    c = fm.config
    fm_opts = (optim.ftrl(loss_scale=c.loss_scale),
               optim.adam(learning_rate=c.learning_rate, eps=c.epsilon,
                          loss_scale=c.loss_scale))
    dc = DCNModel(DCNConfig())
    dc_opts = (optim.ftrl(), optim.adam(learning_rate=dc.config.learning_rate,
                                        loss_scale=dc.config.loss_scale))
    mt, mt_opts = mt_recipe(sparse=False)
    for tag, model, opts in (("dense-deepfm", fm, fm_opts),
                             ("dense-dcn", dc, dc_opts),
                             ("dense-mt", mt, mt_opts)):
        if model is mt:
            data = SyntheticOutbrain(mt.config, 4, seed=0)
            batch_size = MT_BATCH
        else:
            data = SyntheticCriteo(BATCH, FIELDS, model.config.vocab_size,
                                   steps=4, seed=0, fields="criteo")
            batch_size = BATCH
        batches = [to_device(data.get_batch(s), dev) for s in range(4)]
        state = init_train_state(model, 0, *opts, device=dev)
        out[tag] = timed_steps(f"{tag}-captured",
                               make_train_step(model, *opts, jit=True), state,
                               batches, batch_size, {}, profile=True)
        del state
        if model is mt:  # 4M multi-hot lookups a batch, hot ids included
            check_captured_equals_eager(f"{tag}-equal", dev, model, opts,
                                        batches[:3])
        del batches
        torch.cuda.empty_cache()
    return out


def dcn_table_grad(model, state, batch):
    """(logits, loss, gradient of the loss by the table) of one batch."""
    t = state.params["emb"]["table"].detach().requires_grad_(True)
    params = {**state.params, "emb": {"table": t}}
    with torch.enable_grad():
        logits = model.apply_batch(params, batch)
        loss = model.loss(params, logits, batch["label"])[1]
        (g,) = torch.autograd.grad(loss, t)
    return logits.detach(), loss.detach(), g


def phase_one_hot(dev, batch=4096, vocab=1000) -> dict:
    """13.4: DCN's one-hot lookup against its gather lookup at vocab 1,000
    (padded 8,192), batch 4,096 (a [159744, 8192] f32 one-hot, 5.2 GB):
    from one state, equal logits and loss (an f32 product with a one-hot
    row is exact) and the table's gradient (the one-hot's transposed
    product against the sorted index-put: other summation orders) within
    1e-5 of its largest element; then each step captured, timed."""
    kw = dict(batch_size=batch, vocab_size=vocab)
    oh = DCNModel(DCNConfig(use_one_hot_embeddings=True, **kw))
    gm = DCNModel(DCNConfig(**kw))
    opts = (optim.ftrl(), optim.adam(learning_rate=oh.config.learning_rate,
                                     loss_scale=oh.config.loss_scale))
    data = SyntheticCriteo(batch, FIELDS, vocab, steps=4, seed=0,
                           fields="criteo")
    batches = [to_device(data.get_batch(s), dev) for s in range(4)]
    state = init_train_state(gm, 0, *opts, device=dev)
    la, lossa, ga = dcn_table_grad(oh, state, batches[0])
    lb, lossb, gb = dcn_table_grad(gm, state, batches[0])
    err = float((ga - gb).abs().max() / gb.abs().max())
    rec_log("dcn-one-hot", f"logits equal {torch.equal(la, lb)}, losses "
            f"{float(lossa)} {float(lossb)}, table gradient max abs diff "
            f"{err:.3g} of its largest element")
    if not torch.equal(la, lb) or not torch.equal(lossa, lossb) or err > 1e-5:
        fail(f"dcn-one-hot: logits or loss differ, or gradient off by {err}")
    del state, ga, gb
    torch.cuda.empty_cache()
    out = {}
    for tag, model in (("dcn-one-hot", oh), ("dcn-gather", gm)):
        state = init_train_state(model, 0, *opts, device=dev)
        out[tag] = timed_steps(f"{tag}-captured",
                               make_train_step(model, *opts, jit=True), state,
                               batches, batch, {}, warmup=2, steps=5)
        del state
        torch.cuda.empty_cache()
    return out


def phase_dense(dev, profile=False) -> dict:
    """Phase 13, each part with the card's name and power limit."""
    out = {"wd_accuracy": phase_dense_wd(dev),
           "wd_bench": phase_dense_bench(dev, profile)}
    out.update(phase_dense_others(dev))
    out.update(phase_one_hot(dev))
    rec_log("dense-summary", json.dumps({
        k: {"ms_per_step": v["ms_per_step"],
            "samples_per_s": v["samples_per_s"],
            "busy_share": v.get("busy_share")} for k, v in out.items()}))
    return out


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
    global SMI
    SMI = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(SMI)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    phase_build()

    data, bucket, host0 = wd_setup()
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
    others = phase_captured_others(dev, fm_host)
    del fm_host
    torch.cuda.empty_cache()

    wd_model, wd_opts = wd_recipe()
    rec_wd = phase_rec_wd(dev, wd_model, wd_opts)
    phase_rec_regrow(dev, wd_model, wd_opts)
    rec_mt = phase_rec_mt(dev)
    rec_log("rec-summary", json.dumps({"wd": rec_wd, "multitable": rec_mt,
                                       "captured_others": others}))
    phase_dense(dev, profile=args.profile)

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
