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
    the card's name and power limit too;
14. checkpoints and the serving hand-off (``io/``, ``serving/``):
    ``[ckpt-wd]`` trains the W&D bench recipe through ``RecModel.train``
    (captured, native prep, kernels 1-3 with the counters set to 0 just
    before the straight run and read just after) 10 steps straight, and
    5 steps with an async ``CheckpointCallback`` followed by a fresh
    ``RecModel`` restored from the latest file taking the other 5: every
    leaf equal bit for bit (digests printed), the file's MB, the
    snapshot's host wait, the write, the restore and the captures after
    it; ``[ckpt-dense]`` the same on the dense W&D accuracy recipe with
    dropout (keep 0.9), so the key survives the round trip;
    ``[profile]``: ``profile()`` around 3 captured steps of the restored
    model, each under ``step_annotation``, the Chrome trace naming the
    annotations and ``segsum_sorted``'s kernel; ``[export-wd]``,
    ``[export-fm]``, ``[export-dcn]``: the trained W&D bench state and
    ``DeepFMConfig()`` / ``DCNConfig()`` after 3 default steps exported
    by ``ExportCallback`` (MREC1, sidecar, ONNX), 2 batches of 1,000
    written by ``records2bin`` and served by the C++ client (built by
    g++, host CPU), by the ONNX graph on the card and by ``predict`` on
    the card, client and ONNX within 1e-5 of float32 ``predict``;
    ``[export-mt]``: the multitable recipe, ONNX only; ``[floor]``:
    ``sparse_step_floor`` of the W&D and multitable recipes with the
    card's constants beside the captured ms/step of phase 12, and the
    ``TimeMonitor(speed_of_light=model)`` line of ``[ckpt-wd]``'s
    straight run.  Temporary files live under ``tempfile.mkdtemp()`` and
    are removed;
15. the cache regime (``train/cached.py``) at the reference's cache
    recipe (benchmarks/bench_cached.py: virtual vocab 100M behind a
    4.6M-row cache, batch 16000 x 39 zipf(1.3) ids, emb 16, 7x1024 bf16,
    FTRL + LazyAdam, feature-major tables, host tiers capped at 1 GiB of
    RAM each with SSD spill, ``max_swap`` the largest distinct count + 8,
    the captured step): ``[cache-wd]`` 8 warm-up and 24 timed steps by
    the serial protocol and again by ``AsyncCachedTrainer`` from one
    state, final states and the tiers' touched rows equal bit for bit,
    one capture each (samples/s, hit rates, loads and evictions per
    step, prepare / writeback / swap + step ms, SSD rows, arena MB, host
    MB touched; the counters set to 0 just before the serial timed steps
    and read just after); ``[cache-evict]`` the same pair with a
    200,000-row cache over 16 steps, so rows are evicted and written
    back every step; ``[cache-kernels]`` 3 cached steps with the kernels
    against 3 with the plain versions; ``[cache-rec]`` the model through
    ``RecModel`` as examples/train_criteo.py:189-225 wires it (wrapped
    train and eval steps), 10 steps, ``eval`` over 2 batches, and
    ``flush_all`` then a tier read equal to the card's rows;
16. the dynamic-embedding regime (``train/dynamic.py``), ``[dyn-wd]``:
    ``WideDeepConfig()`` with ``dynamic_embedding=True, sparse=True``
    (capacity 200,000, emb 80, 1024-512-256-128) over raw int64 keys (a
    64-bit hash of zipf(1.3) ids over 10M) through
    ``RecModel.online_train`` for 40 steps, admission at 2, eviction
    after 20 idle steps by ``EvictionCallback`` every 10 steps with an
    incremental export: freed rows equal the adapter's draws, their
    optimizer state zero, one capture, and the export imported into a
    fresh model predicts as the trained one on the live keys;
17. ``[files-wd]``: 24 seeded bench-recipe batches written as packed
    shards (``data/criteo.py``, 121 MB) and trained through
    ``RecModel.train`` over ``PackedCriteoDataset`` three ways, each
    captured (3 steps that capture, then one timed epoch of 24 with the
    counters set to 0 just before and read just after): (a) host prep
    (native, 2 workers, the bucket), (b) ``prep_placement="device"`` with
    ``BatchWire.for_sparse(host_prep=False)``, (c) (b) with the fused
    superbatch driver forced at k = 8; for each end-to-end samples/s, the
    captured step's ms, host prep or encode + audit ms, bytes staged per
    batch, decode ms, graphs captured and a digest of the final state;
    (b) == (c) bit for bit, (a) against (b) within the kernel-vs-plain
    tolerance (the largest differences printed);
18. ``[files-tfrecord]``: 2 of those batches as TFRecord (32 records)
    and, where h5py is installed, as H5, read through ``create_dataset``
    (write and read ms per batch), equal to the packed path's batches
    array for array, 2 steps each;
19. ``[wire-card]``: decode of encode on the card equals the batch bit
    for bit for ``for_sparse`` with host prep off and on and for
    ``for_fields`` (lossless weights), and with lossy bf16 weights equals
    their rounding in numpy; decode µs per batch;
20. ``[auto]``: ``input_recipe="auto"`` on the card (the measured link:
    fixed ms per put, GB/s, and the decision), then with ``measure_link``
    replaced by the reference's simulated tunnel (80 ms per put, 60
    MB/s), which must choose device prep, the wire and k = 16: 32
    batches, one capture;
21. ``[outbrain-files]``: Outbrain TFRecords (``write_outbrain_tfrecords``,
    ``OutbrainTFRecordDataset``) of 2 batches of 4,096 (the cut from
    131,072) at the multitable recipe's widths, read back equal and
    trained 2 steps through ``RecModel`` with host prep;
22. ``[online-kafka]``: 200,000 ``RealisticCriteo(vocab_scale=0.03)``
    rows as TSV and their ``collect_stats`` (2 worker processes); a
    ``StubKafkaBroker`` in this process, a topic of 2 partitions, 2
    producer threads sending 40,000 rows as JSON messages of 1,000 rows;
    ``KafkaSource`` -> ``CriteoFeatureEngineer`` -> ``Channel`` ->
    ``StreamingDataset`` -> ``RecModel.online_train`` at the online
    recipe (batch 1,000, emb 16, 1024-512-256-128, FTRL + LazyAdam,
    captured) with a ``CheckpointCallback`` every 10 steps keeping 2:
    steps, samples/s, the vocabulary, freshness (send to the mtime of
    the first checkpoint covering a batch: median, worst), restore ms;
23. PS mode (``ops/remote.py``, the port's table server built by g++,
    every server on a free port with its own spill directory, shut down
    at the end and killed after 10 s; a dead server fails the run):
    ``[ps-cache]`` phase 15's ``[cache-wd]`` and ``[cache-evict]`` pairs
    with every tier a ``RemoteTier`` on 2 servers (serial == pipelined
    bit for bit; with evictions every evicted row read back from the
    servers equals the arena's row before the swap), each part's ms
    beside phase 15's host tiers;
24. ``[ps-host]``: the W&D bench recipe with ``parameter_server=True``
    (``train/host_target.py``: the tables never on the card) over its 8
    batches, on host tiers and on 2 servers from the same seeded rows:
    losses, rows and dense parameters equal bit for bit; ``segsum_sorted``
    at its [624000, 17] shape against its plain version; 1 launch a step;
25. ``[ps-tb]``: the TB-scale point (BASELINE.md:14,
    examples/train_terabyte.py): virtual vocab 900M x emb 240 behind a
    4.6M-row cache (feature-major, FTRL + LazyAdam, 1024-512-256-128),
    batch 16,000 x 39 zipf(1.1) ids, tiers on 2 servers at 512 MB of RAM
    per table (cut from 10 GB so that they spill within 8 steps):
    gather_rows, segsum_sorted, adam_cols and ftrl_cols at this width on
    batch 0 against their plain versions, then 2 warm-up and 6 timed
    serial steps, the servers' RAM and SSD rows, loopback rows and MB/s,
    and after ``flush_all`` the rows of 10,000 resident ids read back
    equal to the arena's;
26. ``[ps-dyn]``: phase 16's recipe over the distributed hash store on 2
    servers, 20 steps, eviction after 8 idle steps every 5 (so that 20
    steps evict), the admitted and evicted key sets equal to a local
    ``NativeHashStore`` fed the same keys at every eviction;
27. ``[generic-wd]``: the W&D bench recipe on the generic path
    (``use_pallas=False``, captured; it launches no kernel) for 3 steps
    beside the streamed step from one state, both fed float32 rows: the
    first losses equal, later ones within rtol 1e-4, the touched rows
    within the optimizers' drift bounds (``adam_drift_bound``,
    ``ftrl_drift_bound``); ms/step of the generic and the streamed step
    at the recipe in turns; DeepFM's ``row_layout=False`` on row_packed
    tables warns and takes the generic path (1 + 3 steps);
28. ``[generic-dyn]``: the yaml recipe (batch 16000, vocab 200,000, emb
    80) with ``dynamic_embedding=True, sparse=False`` (plain specs,
    reference fault 9) through the hash adapter for 5 captured steps
    against the same model on feature-major tables on the generic path:
    first losses equal, later within rtol 1e-4, rows within the drift
    bounds, some rows changed;
29. ``[drivers]``: every driver of ``mindrec_tpu_torch/examples`` as a
    subprocess on the card (the standalone and dynamic-embedding
    launchers, the latter with ``--save_graphs``, ``train_criteo
    --sparse 1`` with checkpoints and its launches counted,
    ``eval_criteo`` on its checkpoint, ``train_outbrain``, ``train_terabyte``, ``online_train``,
    ``accuracy_run``): each exits 0; loss, AUC and wall time printed;
30. ranks of a (data, model) mesh sharing the card over gloo
    (``parallel/launch.py`` spawns ``parallel/jobs.py``; a failed or
    late rank fails the phase), each run held against the one-rank run
    of the same 3 global batches of the W&D bench recipe (eager, the
    recipe's bucket): losses within rtol 1e-5 at every step, the largest
    difference of the merged deep table, m, v, wide table and MLP, each
    rank's ms/step (gloo's host copies, no speed of multi-GPU training),
    every collective's bytes per step below a quarter of the deep
    table's, the path's kernels launched on every rank at every step:
    ``[sharded-wd]`` (4 ranks, 2 x 2, deep table row-sliced
    ``[16, 5.86M/2]`` per rank), ``[sharded-ckpt]`` (its sliced files
    restored onto one rank, merged, and onto a (1, 2) mesh, bit for bit
    against the whole state rank 0 gathered), ``[dp-wd]`` (2 x 1,
    row_packed) and ``[sharded-col]`` (1 x 2, column slice) in one spawn,
    ``[sharded-driver]`` (``run_distribute_train.sh 2 --mesh_model 2`` at
    the yaml's width, both ranks' final AUC equal), and
    ``[shard-kernels]``: kernels 1, 3, 6 and 8 against their plain
    versions at a rank's shapes (clipped ids, a run-time lane offset,
    injected unique ids); beside each mesh run's eager steps each rank
    runs the captured step (CUDA graphs cut at every collective) from a
    copy of its block, in turns (eager, captured, captured, eager), and
    ``[*-captured]`` holds it to the eager run bit for bit (losses,
    every leaf), with the same collectives per step, the path's kernels
    launched at every step (``real_launches``), graphs per capture and
    ms/step captured and eager per rank; ``[mesh-dense-captured]``
    (1 x 2, the deep table row-sliced) and ``[mesh-generic-captured]``
    (2 x 1, ``use_pallas=False``) do the same at the yaml's width, and
    ``[sharded-driver]``'s ranks run captured through ``RecModel``;
31. several workers, their ranks sharing the card over gloo (no time
    here is a speed of several cards): ``[ps-workers]`` (2 table servers
    and 2 PS workers, ``parallel/jobs.py:ps_worker``, in the cache
    regime at the cache recipe with the global batch of 16,000 x 39
    split over the workers, each over the ids it owns, 5 eager steps:
    each worker's losses, row loads and every touched row the servers
    hold equal its one-process run on host tiers bit for bit; ms/step,
    ``prepare`` ms, rows and MB moved per step, kernels 1, 6, 7 and 8
    launched on each worker at each step), ``[dist-online]``
    (``run_dist_online_train.sh 2`` at ``dist_online_train.py``'s
    default width over a spool written first, the MLP in float32, 6
    steps: the final parameters within rtol 1e-5 / atol 1e-7 of one
    rank's run of the global stream, per-rank checkpoints, kernels 1-3
    launched every step on each rank) and ``[elastic]`` (``run_elastic_train.sh 2`` at the
    yaml's width, a crash at step 3: exit 0 after one restart from the
    step-2 checkpoint, the last global step past the crash).

Every kernel and every library call is timed by replaying a CUDA graph
of 10 calls (device time, no host work between the launches); the plain
versions, which synchronise, by an eager loop.

``--profile`` adds the device time by kernel over 5 more steps of
phases 3, 6, 10 and 13's bench recipe, and that step's parts.  It prints a ``{"kernels": [...]}`` JSON line before the
last line and ends with ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import os
import re
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from mindrec_tpu_torch import RecModel
from mindrec_tpu_torch.data.criteo import (
    PrefetchToDevice, SyntheticCriteo, to_device,
)
from mindrec_tpu_torch.data import criteo, formats, kafka_stub, kafka_wire
from mindrec_tpu_torch.data import outbrain as ob_data
from mindrec_tpu_torch.data import preprocess, realistic, streaming
from mindrec_tpu_torch.data import wire as wire_mod
from mindrec_tpu_torch.data.criteo import N_DENSE_FIELDS, criteo_field_sizes
from mindrec_tpu_torch.data.outbrain import SyntheticOutbrain
from mindrec_tpu_torch.data.wire import ARENA_KEY, BatchWire, bf16_bits
from mindrec_tpu_torch.data.pipeline import (
    AdaptiveBucket, SparseInputPipeline, round_bucket,
)
from mindrec_tpu_torch.models.dcn import DCNConfig, DCNModel
from mindrec_tpu_torch.models.deepfm import DeepFMConfig, DeepFMModel
from mindrec_tpu_torch.models.multitable import (
    MULTI_FIELDS, MultiTableConfig, MultiTableWideDeepModel,
)
from mindrec_tpu_torch.models.wide_deep import WideDeepConfig, WideDeepModel
from mindrec_tpu_torch.native.hashstore import HashStore
from mindrec_tpu_torch.ops import kernels, prng, remote
from mindrec_tpu_torch.ops.cache import LruCache
from mindrec_tpu_torch.ops.embedding import from_storage, read_rows, to_storage
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
from mindrec_tpu_torch.io import checkpoint
from mindrec_tpu_torch.io.onnx import export_onnx
from mindrec_tpu_torch.ops import sharded_stream
from mindrec_tpu_torch.parallel import jobs, launch
from mindrec_tpu_torch.parallel import mesh as pmesh
from mindrec_tpu_torch.serving import client, records2bin
from mindrec_tpu_torch.serving.onnx_ref import OnnxModel
from mindrec_tpu_torch.train import optim
from mindrec_tpu_torch.train.cached import (
    AsyncCachedTrainer, CachedTrainingAdapter, cached_train_step,
)
from mindrec_tpu_torch.train.callbacks import (
    Callback, CheckpointCallback, EvictionCallback, ExportCallback,
    RunContext, TimeMonitor,
)
from mindrec_tpu_torch.train.dynamic import DynamicEmbeddingAdapter
from mindrec_tpu_torch.train.host_target import (
    HostTargetAdapter, init_dense_state, sort_ids,
)
from mindrec_tpu_torch.train.metrics import roc_auc
from mindrec_tpu_torch.utils.profiling import (
    profile, sparse_step_floor, step_annotation,
)
from mindrec_tpu_torch.train.step import (
    SENTINEL, CapturedStep, TrainState, _group_layouts, _state_tensors,
    flatten_params, init_train_state, make_batch_sort, make_eval_step,
    make_train_step, map_leaves, prep_groups, real_launches,
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


def check_sorted(dev, gen, case, dtype=torch.bfloat16, timed=True,
                 gaps=False) -> dict:
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
    once), ``perm`` and ``uidx`` once, ``out`` once.  ``gaps``: ``uidx``
    skips ids (``segsum_sorted(gaps=True)`` zeroes ``out`` first)."""
    tag, uidx, perm, rows, d, n_out = case
    g = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
    got = segsum_sorted(g, uidx, n_out, perm=perm, gaps=gaps)
    g_sorted = g[perm.long()]
    err, rel = check_segsum(f"segsum_sorted ({tag})", got,
                            segsum_sorted_plain(g, uidx, n_out, perm),
                            g_sorted, uidx, n_out)
    if not torch.equal(segsum_sorted(g, uidx, n_out, perm=perm, gaps=gaps),
                       got):
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
        ms=graph_ms(lambda: segsum_sorted(g, uidx, n_out, perm=perm,
                                          gaps=gaps)),
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
    distinct; ids below 0 and past n_out; ids that skip, with
    ``gaps=True``; D 1, 13, 17, 128, 256; identity, reversed, random and
    compacted ``perm``), bf16 and float32, held as at the step's shapes."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_cuda import SEGSUM_SORTED_CASES, segsum_sorted_case

    for case_id, n, d, n_out, pattern, shift, kind in SEGSUM_SORTED_CASES:
        g, uidx, perm = segsum_sorted_case(n, d, pattern, shift, kind)
        case = (case_id, torch.from_numpy(uidx).to(dev),
                torch.from_numpy(perm).to(dev), g.shape[0], d, n_out)
        for dt in (torch.float32, torch.bfloat16):
            check_sorted(dev, gen, case, dt, timed=False,
                         gaps=pattern == "gaps")
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
    # one library call for the counts: index_add_ of float32 ones
    # (torch.bincount reads its size on the host, so no graph takes it)
    ones_f, lib_counts = torch.ones(n, device=dev), torch.zeros(n_out, device=dev)
    res["segsum_unsorted"]["presence_library_ms"] = graph_ms(
        lambda: lib_counts.index_add_(0, seg_l, ones_f))
    # the ones and ids read once, the [1, n_out] counts written once
    res["segsum_unsorted"]["presence_bound_ms"] = bound(
        n * 2 + n * 4 + n_out * 4, n)[0]
    log("[kernel] segsum_unsorted ([1.7M, 128] bf16 -> [128, 2048])",
        json.dumps(res["segsum_unsorted"]))
    del g, gf, lib_out, ones, ones_f, lib_counts

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
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.reshape(-1).contiguous().view(torch.uint8).cpu().numpy())
    return h.hexdigest()[:16]


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


# ---------------------------------------------------------------------------
# phase 14: checkpoint and resume, the serving hand-off, the floor, a profile
# ---------------------------------------------------------------------------

CKPT_STEPS, SERVE_BATCH, SERVE_BATCHES = 10, 1000, 2
SERVE_TOL = 1e-5  # float32 serving forwards against float32 predict


class TimedCheckpoint(CheckpointCallback):
    """``CheckpointCallback`` whose save is timed as the trainer sees it:
    the step is waited for first, so the time is the snapshot (the host
    copy) and the hand-off to the writer thread."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.snapshot_ms, self.handed_off = [], None

    def on_train_step_end(self, ctx):
        if ctx.cur_step_num % self.save_steps:
            return
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        super().on_train_step_end(ctx)
        self.handed_off = time.perf_counter()
        self.snapshot_ms.append((self.handed_off - t0) * 1e3)


def ckpt_resume(tag, make_rm, raw, per_step, monitor=None) -> tuple:
    """Run A: ``len(raw)`` steps straight through ``RecModel.train``
    (launch counters set to 0 just before, read just after).  Run B: the
    first half with an async ``CheckpointCallback``, then a fresh
    ``RecModel`` restored from the latest checkpoint takes the second
    half.  Every leaf of A and B must be equal bit for bit.  Returns the
    numbers and the resumed ``RecModel``."""
    half = len(raw) // 2
    tmp = tempfile.mkdtemp(prefix="mrec-ckpt-")
    try:
        rm_a = make_rm()
        torch.cuda.synchronize()
        kernels.reset_launches()
        rm_a.train_step.reset_counts()
        rm_a.train(1, raw, callbacks=[monitor] if monitor else None)
        torch.cuda.synchronize()
        launches = real_launches(rm_a.train_step)
        for k, per in per_step.items():
            if launches[k] < per * len(raw):
                fail(f"{tag}: kernel {k} launched {launches[k]} times in "
                     f"{len(raw)} steps")
        rm_b = make_rm()
        cb = TimedCheckpoint(tmp, save_steps=half, async_save=True)
        rm_b.train(1, raw[:half], callbacks=[cb])
        write_ms = (time.perf_counter() - cb.handed_off) * 1e3
        path, step = checkpoint.latest_checkpoint(tmp)
        if step != half or cb.saved != [path]:
            fail(f"{tag}: latest checkpoint {path} at step {step}, saved "
                 f"{cb.saved}")
        del rm_b
        rm_c = make_rm()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rm_c.state = checkpoint.restore_checkpoint(path, rm_c.state)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        rm_c.train_step.reset_counts()
        rm_c.train(1, raw[half:])
        torch.cuda.synchronize()
        diffs = state_diffs(rm_a.state, rm_c.state)
        out = dict(steps=len(raw), resumed_at=half,
                   checkpoint_mb=os.path.getsize(path) / 1e6,
                   snapshot_ms=cb.snapshot_ms[0], write_ms=write_ms,
                   restore_ms=restore_ms,
                   captures_after_restore=rm_c.train_step.captures,
                   leaves=len(_state_tensors(rm_a.state)),
                   digest_straight=digest(_state_tensors(rm_a.state)),
                   digest_resumed=digest(_state_tensors(rm_c.state)),
                   launches_straight=launches, bit_identical=not diffs)
        rec_log(tag, json.dumps(out))
        if diffs or out["digest_straight"] != out["digest_resumed"]:
            fail(f"{tag}: resumed state differs from the straight run in "
                 f"leaves (index, max abs diff) {diffs}")
        if rm_c.train_step.captures != 1:
            fail(f"{tag}: {rm_c.train_step.captures} captures after restore")
        return out, rm_c
    finally:
        shutil.rmtree(tmp)


def serving_model(model):
    """The same model at float32 (the serving precision of MREC1 and
    ONNX): ``predict`` of the same parameters without the bf16 MLP."""
    return type(model)(dataclasses.replace(model.config,
                                           use_mixed_precision=False))


def serve_check(tag, kind, model, state, dev) -> dict:
    """Export with ``ExportCallback`` (MREC1, its sidecar and ONNX),
    write ``SERVE_BATCHES`` batches of ``SERVE_BATCH`` with
    ``records2bin``, and serve them three ways: the C++ client (host
    CPU), the ONNX graph run on the card, and ``predict`` on the card.
    Client and ONNX are held to ``SERVE_TOL`` of float32 ``predict``."""
    tmp = tempfile.mkdtemp(prefix="mrec-export-")
    try:
        cb = ExportCallback(tmp, kind, export_steps=1, keep_max=1,
                            onnx_model=model)
        params = state.params
        ctx = RunContext(cur_step_num=1, train_state=state)
        t0 = time.perf_counter()
        cb.on_train_step_end(ctx)
        export_ms = (time.perf_counter() - t0) * 1e3
        mrec = Path(cb.exported[-1])
        onnx_path = mrec.with_suffix(".onnx")
        t0 = time.perf_counter()
        export_onnx(onnx_path, kind, model, params)
        onnx_ms = (time.perf_counter() - t0) * 1e3
        bins = Path(tmp) / "bins"
        records2bin.convert(SyntheticCriteo(
            SERVE_BATCH, FIELDS, model.config.vocab_size, steps=SERVE_BATCHES,
            seed=999, fields="criteo"), bins)
        t0 = time.perf_counter()
        runner = OnnxModel(onnx_path.read_bytes(), dev)
        torch.cuda.synchronize()
        onnx_load_ms = (time.perf_counter() - t0) * 1e3
        f32 = serving_model(model)
        err = {"client": 0.0, "onnx_card": 0.0, "bf16_predict": 0.0}
        client_ms, onnx_batch_ms = [], []
        for i in range(SERVE_BATCHES):
            ids = np.fromfile(bins / f"ids_{i}.bin", np.int32).reshape(
                SERVE_BATCH, FIELDS)
            wts = np.fromfile(bins / f"wts_{i}.bin", np.float32).reshape(
                SERVE_BATCH, FIELDS)
            probs, ms = client.run_files(mrec, bins / f"ids_{i}.bin",
                                         bins / f"wts_{i}.bin", SERVE_BATCH,
                                         FIELDS, Path(tmp) / f"out_{i}.txt")
            client_ms.append(ms)
            t_ids = torch.from_numpy(ids).to(dev)
            t_wts = torch.from_numpy(wts).to(dev)
            feeds = {"ids": t_ids, "wts": t_wts}
            runner(feeds)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = runner(feeds)["prob"].reshape(-1)
            torch.cuda.synchronize()
            onnx_batch_ms.append((time.perf_counter() - t0) * 1e3)
            with torch.no_grad():
                want = f32.predict(params, t_ids, t_wts).reshape(-1)
                own = model.predict(params, t_ids, t_wts).reshape(-1)
            want_np = want.double().cpu().numpy()
            err["client"] = max(err["client"],
                                float(np.abs(probs - want_np).max()))
            err["onnx_card"] = max(err["onnx_card"],
                                   float((got - want).abs().max()))
            err["bf16_predict"] = max(err["bf16_predict"],
                                      float((own.float() - want).abs().max()))
        out = dict(
            mrec_mb=mrec.stat().st_size / 1e6,
            sidecar_mb=Path(str(mrec) + ".npz").stat().st_size / 1e6,
            onnx_mb=onnx_path.stat().st_size / 1e6,
            export_ms=export_ms, onnx_build_ms=onnx_ms,
            onnx_load_to_card_ms=onnx_load_ms,
            client_us_per_sample_host=[m * 1e3 / SERVE_BATCH
                                       for m in client_ms],
            onnx_card_ms_per_batch=onnx_batch_ms,
            max_abs_err_vs_f32_predict=err, tolerance=SERVE_TOL,
            batches=SERVE_BATCHES, batch=SERVE_BATCH)
        rec_log(tag, json.dumps(out))
        if max(err["client"], err["onnx_card"]) > SERVE_TOL:
            fail(f"{tag}: client or ONNX off predict by {err}")
        return out
    finally:
        shutil.rmtree(tmp)


def serve_multitable(dev) -> dict:
    """The multitable recipe's model exported to ONNX only (the client has
    no multitable kind), run on the card against float32 ``predict`` on
    the first ``SERVE_BATCH`` rows of a synthetic batch."""
    model, opts = mt_recipe()
    state = init_train_state(model, 0, *opts, device=dev)
    tmp = tempfile.mkdtemp(prefix="mrec-export-")
    try:
        t0 = time.perf_counter()
        path = export_onnx(Path(tmp) / "mt.onnx", "multitable", model,
                           state.params)
        onnx_ms = (time.perf_counter() - t0) * 1e3
        runner = OnnxModel(Path(path).read_bytes(), dev)
        raw = SyntheticOutbrain(model.config, 1, seed=0).get_batch(0)
        feeds = {k: torch.from_numpy(v[:SERVE_BATCH]).to(dev)
                 for k, v in raw.items()}
        runner(feeds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = runner(feeds)["prob"].reshape(-1)
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            want = serving_model(model).predict(state.params,
                                                feeds).reshape(-1)
        err = float((got - want).abs().max())
        out = dict(onnx_mb=Path(path).stat().st_size / 1e6,
                   onnx_build_ms=onnx_ms, onnx_card_ms_per_batch=batch_ms,
                   max_abs_err_vs_f32_predict=err, tolerance=SERVE_TOL)
        rec_log("export-mt", json.dumps(out))
        if err > SERVE_TOL:
            fail(f"export-mt: ONNX off predict by {err}")
        return out
    finally:
        shutil.rmtree(tmp)
        del state
        torch.cuda.empty_cache()


class Annotate(Callback):
    """Each train step under ``step_annotation("train_step", n)``."""

    def on_train_step_begin(self, ctx):
        self._range = step_annotation("train_step", ctx.cur_step_num)
        self._range.__enter__()

    def on_train_step_end(self, ctx):
        self._range.__exit__(None, None, None)


def profile_check(rm, raw) -> dict:
    """``profile()`` around 3 captured W&D steps through ``RecModel.train``
    (they replay the graph the restore captured): the Chrome trace must
    exist and name the annotations and ``segsum_sorted``'s kernels."""
    tmp = tempfile.mkdtemp(prefix="mrec-prof-")
    try:
        torch.cuda.synchronize()
        with profile(tmp) as p:
            rm.train(1, raw[:3], callbacks=[Annotate()])
            torch.cuda.synchronize()
        text = Path(p.trace_path).read_text()
        names = ["train_step#1", "train_step#3", "sorted_chunk_sum"]
        found = {n: n in text for n in names}
        out = dict(trace_mb=len(text) / 1e6, found=found,
                   replays=rm.train_step.replays)
        rec_log("profile", json.dumps(out))
        if not all(found.values()):
            fail(f"profile: the trace lacks {found}")
        return out
    finally:
        shutil.rmtree(tmp)


def phase_serving(dev, wd_model, wd_opts, rec_wd, rec_mt) -> dict:
    """Phase 14, each line with the card's name and power limit."""
    out = {}
    data = SyntheticCriteo(BATCH, FIELDS, VOCAB, steps=CKPT_STEPS, seed=70,
                           fields="criteo")
    raw = [data.get_batch(s) for s in range(CKPT_STEPS)]
    monitor = TimeMonitor(speed_of_light=wd_model)
    lines = io.StringIO()
    with contextlib.redirect_stdout(lines):
        out["ckpt_wd"], rm = ckpt_resume(
            "ckpt-wd", lambda: RecModel(
                wd_model, *wd_opts, prep_workers=2, jit=True, device=dev,
                unique_bucket=AdaptiveBucket.from_sample(
                    raw[:2], log=lambda *a, **k: None)),
            raw, WD_PER_STEP, monitor)
    print(lines.getvalue(), end="", flush=True)
    tm_line = [x for x in lines.getvalue().splitlines()
               if x.startswith("epoch time")][0]
    out["profile"] = profile_check(rm, raw)
    out["export_wd"] = serve_check("export-wd", "wide_deep", wd_model,
                                   rm.state, dev)
    del rm
    torch.cuda.empty_cache()

    dmodel, dopts = dense_wd_recipe(dropout_flag=True, keep_prob=0.9)
    draw = [SyntheticCriteo(BATCH, FIELDS, ACC_VOCAB, steps=CKPT_STEPS,
                            seed=80, fields="criteo").get_batch(s)
            for s in range(CKPT_STEPS)]
    out["ckpt_dense"], rm = ckpt_resume(
        "ckpt-dense", lambda: RecModel(dmodel, *dopts, jit=True, device=dev),
        draw, {})
    del rm
    torch.cuda.empty_cache()

    for tag, kind, model in (
            ("export-fm", "deepfm", DeepFMModel(DeepFMConfig())),
            ("export-dcn", "dcn", DCNModel(DCNConfig()))):
        rm = RecModel(model, jit=True, device=dev)
        rm.train(1, [SyntheticCriteo(BATCH, FIELDS, model.config.vocab_size,
                                     steps=3, seed=90, fields="criteo"
                                     ).get_batch(s) for s in range(3)])
        out[tag] = serve_check(tag, kind, model, rm.state, dev)
        del rm
        torch.cuda.empty_cache()
    out["export_mt"] = serve_multitable(dev)

    mt_model, _ = mt_recipe()
    floors = {}
    for name, model, bs, ms in (
            ("wd", wd_model, BATCH, min(rec_wd["turns"]["ms"]["captured"])),
            ("multitable", mt_model, MT_BATCH,
             min(rec_mt["turns"]["ms"]["captured"]))):
        f = sparse_step_floor(model, bs)
        floors[name] = dict(f, captured_ms_per_step=ms,
                            share_of_floor=f["floor_ms"] / ms)
    rec_log("floor", json.dumps(floors))
    rec_log("floor", f"TimeMonitor(speed_of_light=model) over [ckpt-wd]'s "
            f"straight run: {tm_line}")
    out["floor"] = floors
    return out


# ---------------------------------------------------------------------------
# phases 15-16: the cache regime and the dynamic-embedding regime
# ---------------------------------------------------------------------------

# benchmarks/bench_cached.py:33-48, 60-75: virtual vocab, cache rows, RAM
# cap per tier; warm-up and timed steps of its run
CACHE_VIRTUAL, CACHE_ROWS, CACHE_RAM = 100_000_000, 4_600_000, 1 << 30
CACHE_WARMUP, CACHE_STEPS = 8, 24
CACHE_EVICT_ROWS, CACHE_EVICT_STEPS = 200_000, 16
CACHE_PER_STEP = {"gather_rows": 2, "segsum_sorted": 1, "adam_cols": 1,
                  "ftrl_cols": 1}
DYN_STEPS, DYN_KEYS = 40, 10_000_000


def cache_recipe(cache_rows=CACHE_ROWS):
    """The cache recipe's model (built with vocab = the cache's rows,
    feature-major tables) and optimizers (benchmarks/bench_cached.py:
    60-75)."""
    cfg = WideDeepConfig(
        batch_size=BATCH, field_size=FIELDS, vocab_size=cache_rows,
        emb_dim=EMB, deep_layer_dim=(1024,) * 7, use_mixed_precision=True,
        sparse=True, loss_scale=1024.0, table_layout="feature_major")
    return WideDeepModel(cfg), (optim.ftrl(loss_scale=cfg.loss_scale),
                                optim.lazy_adam(loss_scale=cfg.loss_scale))


def cache_batches(n, seed=0) -> list:
    """zipf(1.3) ids over the virtual vocab (benchmarks/bench_cached.py:
    51-57, 97-100), with each batch's distinct-id count."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = (rng.zipf(1.3, size=(BATCH, FIELDS)).astype(np.int64) - 1
               ) % CACHE_VIRTUAL
        out.append({"ids": ids, "wts": np.ones((BATCH, FIELDS), np.float32),
                    "label": rng.integers(0, 2, (BATCH, 1)).astype(np.float32)})
    return out


def cache_adapter(model, spill, max_swap):
    return CachedTrainingAdapter(
        model, virtual_vocab=CACHE_VIRTUAL,
        cache_rows=model.config.vocab_size, max_swap=max_swap,
        ram_bytes=CACHE_RAM, spill_dir=tempfile.mkdtemp(dir=spill))


def tier_rows(adapter, ids) -> dict:
    return {(n, t): tier.read(ids) for n, tiers in adapter.tiers.items()
            for t, tier in tiers.items()}


def tier_rows_stored(tier) -> tuple[int, int]:
    """(RAM rows, SSD rows) a tier holds: a host tier's own, a remote
    tier's summed over its servers' ``STATS``."""
    if isinstance(tier, remote.RemoteTier):
        st = tier.stats()
        return sum(r for r, _ in st), sum(d for _, d in st)
    return tier.ram_rows_touched, tier.ssd_rows_used


def arena_mb(model, state) -> float:
    """MB of the tables and their optimizer state on the card."""
    n = 0
    for _name, (path, _spec) in model.table_specs.items():
        key = "/".join(path)
        n += state.params[path[0]][path[1]].nbytes
        st = (state.opt_w if key in state.opt_w else state.opt_d)[key]
        n += sum(t.nbytes for t in st.values() if t.dim() == 2)
    return n / 1e6


def evicted_rows(model, state, prep) -> dict:
    """The arena's rows (table and optimizer state) at this batch's evict
    slots, read before its swap: ``{(table, tier): [n, D]}``."""
    slots = prep["evict_slots"][: prep["evict_ids"].size]
    out = {}
    for name, (path, spec) in model.table_specs.items():
        key = "/".join(path)
        st = (state.opt_w if key in state.opt_w else state.opt_d)[key]
        leaves = {"param": state.params[path[0]][path[1]],
                  **{t: x for t, x in st.items() if x.dim() == 2}}
        for t, leaf in leaves.items():
            out[name, t] = read_rows(spec, leaf, slots).float().cpu().numpy()
    return out


def cache_serial(tag, model, opts, state, batches, adapter, uniques,
                 warmup, check_evicted=False) -> tuple:
    """The serial protocol (``cached_train_step``'s parts, timed each) over
    the captured step: ``warmup`` steps, then the rest timed with the
    launch counters set to 0 just before and read just after.
    ``check_evicted``: every timed step's evicted rows, read back from the
    tiers after ``writeback``, must equal the arena's rows before the swap
    (the check's time is left out of every figure)."""
    step = make_train_step(model, *opts, jit=True)
    for b in batches[:warmup]:
        state, _ = cached_train_step(adapter, step, state, b)
    torch.cuda.synchronize()
    captures = step.captures  # the warm-up's
    kernels.reset_launches()
    step.reset_counts()
    parts = {"prepare": [], "swap": [], "writeback": [], "step": []}
    # inside prepare: the LRU lookup, and the tier reads (summed over the
    # io threads, which run them side by side)
    inner = {"lru": [], "tier_reads": []}
    lookup = adapter.lru.lookup

    def timed_lookup(ids):
        t = time.perf_counter()
        res = lookup(ids)
        inner["lru"].append((time.perf_counter() - t) * 1e3)
        return res

    def timed_read(read):
        def run(ids):
            t = time.perf_counter()
            res = read(ids)
            inner["tier_reads"].append((time.perf_counter() - t) * 1e3)
            return res
        return run

    adapter.lru.lookup = timed_lookup
    for tiers in adapter.tiers.values():
        for tier in tiers.values():
            tier.read = timed_read(tier.read)
    events, traffic, losses = [], [], []
    checked, check_s = 0, 0.0
    t_start = time.perf_counter()
    for b, nu in zip(batches[warmup:], uniques[warmup:]):
        t0 = time.perf_counter()
        prep = adapter.prepare(b)
        t1 = tv = time.perf_counter()
        if check_evicted:
            before = evicted_rows(model, state, prep)
            tv = time.perf_counter()
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state = adapter.apply_swap(state, prep)
        t2 = time.perf_counter()
        adapter.writeback(prep)
        t3 = time.perf_counter()
        state, (_lw, ld) = step(state, adapter.transform(b, prep))
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record()
        t4 = time.perf_counter()
        if check_evicted:
            for (name, t), rows in before.items():
                if not np.array_equal(adapter.tiers[name][t].read(
                        prep["evict_ids"]), rows):
                    fail(f"{tag}: evicted {name}/{t} rows read back from "
                         f"the tiers differ from the arena's")
            checked += prep["evict_ids"].size
            check_s += (tv - t1) + (time.perf_counter() - t4)
        for k, (a, z) in zip(parts, ((t0, t1), (tv, t2), (t2, t3), (t3, t4))):
            parts[k].append((z - a) * 1e3)
        events.append((e0, e1))
        losses.append(ld)
        traffic.append((prep["load_ids"].size, prep["evict_ids"].size, nu))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_start - check_s
    n = len(batches) - warmup
    loads, evicts, nus = (np.array(x, np.float64) for x in zip(*traffic))
    out = dict(
        samples_per_s=n * BATCH / dt, ms_per_step=dt / n * 1e3,
        prepare_ms=float(np.mean(parts["prepare"])),
        lru_lookup_ms=float(np.mean(inner["lru"])),
        tier_reads_thread_ms=float(np.sum(inner["tier_reads"]) / n),
        swap_dispatch_ms=float(np.mean(parts["swap"])),
        writeback_ms=float(np.mean(parts["writeback"])),
        step_dispatch_ms=float(np.mean(parts["step"])),
        swap_plus_step_stream_ms=float(np.mean(
            [a.elapsed_time(z) for a, z in events])),
        loads_per_step=float(loads.mean()), evictions_per_step=float(evicts.mean()),
        hit_rate_distinct=float(np.mean(1 - loads / nus)),
        hit_rate_position=float(np.mean(1 - loads / (BATCH * FIELDS))),
        captures=captures + step.captures, launches=real_launches(step),
        last_loss=float(torch.stack(losses)[-1]))
    if check_evicted:
        out["evicted_rows_checked"] = checked
    if not torch.isfinite(torch.stack(losses)).all():
        fail(f"{tag}: non-finite losses")
    return state, out


def cache_async(model, opts, state, batches, adapter, warmup) -> tuple:
    """``AsyncCachedTrainer`` over the same batches: ``warmup`` steps, then
    the rest timed (to the final writeback and a synchronize)."""
    step = make_train_step(model, *opts, jit=True)
    trainer = AsyncCachedTrainer(adapter, step, state)
    for b in batches[:warmup]:
        trainer.step(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[warmup:]:
        trainer.step(b)
    state = trainer.finish()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = len(batches) - warmup
    return state, dict(samples_per_s=n * BATCH / dt, ms_per_step=dt / n * 1e3,
                       captures=step.captures)


def cache_pair(tag, dev, cache_rows, batches, warmup, spill,
               make_adapter=cache_adapter, check_evicted=False) -> dict:
    """Serial protocol and ``AsyncCachedTrainer`` from one state over the
    same batches: the final states and the tiers' touched rows must be
    equal bit for bit, each run one capture, the dummy slot zero.
    ``make_adapter(model, spill, max_swap)`` builds each run's adapter
    (host tiers by default)."""
    uniques = [np.unique(b["ids"]).size for b in batches]
    max_swap = max(uniques) + 8
    model, opts = cache_recipe(cache_rows)
    state0 = init_train_state(model, 0, *opts, device=dev)
    ad_s = make_adapter(model, spill, max_swap)
    s_state, serial = cache_serial(tag, model, opts, replace_state(state0),
                                   batches, ad_s, uniques, warmup,
                                   check_evicted)
    ad_a = make_adapter(model, spill, max_swap)
    a_state, pipelined = cache_async(model, opts, state0, batches, ad_a, warmup)
    touched = np.unique(np.concatenate([b["ids"].ravel() for b in batches]))
    t0 = time.perf_counter()
    ad_s.flush_all(s_state)
    flush_ms = (time.perf_counter() - t0) * 1e3
    ad_a.flush_all(a_state)
    rows_s, rows_a = tier_rows(ad_s, touched), tier_rows(ad_a, touched)
    same_tiers = all(np.array_equal(rows_s[k], rows_a[k]) for k in rows_s)
    same_state = all(torch.equal(x, y) for x, y in
                     zip(_state_tensors(s_state), _state_tensors(a_state)))
    dummy = max(float(read_rows(spec, s_state.params[p[0]][p[1]],
                                [cache_rows]).abs().max())
                for _n, (p, spec) in model.table_specs.items())
    tiers = [t for ad in (ad_s,) for ts in ad.tiers.values() for t in ts.values()]
    ram_ssd = [tier_rows_stored(t) for t in tiers]
    out = dict(
        cache_rows=cache_rows, virtual_vocab=CACHE_VIRTUAL, max_swap=max_swap,
        warmup_steps=warmup, timed_steps=len(batches) - warmup,
        serial=serial, pipelined=pipelined,
        pipelined_over_serial=pipelined["samples_per_s"] / serial["samples_per_s"],
        bit_identical_state=same_state, bit_identical_tiers=same_tiers,
        touched_ids=int(touched.size), flush_all_ms=flush_ms,
        ssd_rows=sum(x[1] for x in ram_ssd),
        tier_mb_stored=sum((r + d) * t.dim * 4 for (r, d), t in
                           zip(ram_ssd, tiers)) / 1e6,
        max_rss_mb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e3,
        arena_mb=arena_mb(model, s_state), dummy_max_abs=dummy)
    rec_log(tag, json.dumps(out))
    if not (same_state and same_tiers):
        fail(f"{tag}: the pipelined run differs from the serial protocol "
             f"(state {same_state}, tiers {same_tiers})")
    if serial["captures"] != 1 or pipelined["captures"] != 1:
        fail(f"{tag}: captures {serial['captures']}, {pipelined['captures']}"
             f" (expected 1 each: the swap writes the state in place)")
    if dummy != 0.0:
        fail(f"{tag}: the dummy slot's rows are {dummy}, not zero")
    for k, per in CACHE_PER_STEP.items():
        if serial["launches"][k] < per * (len(batches) - warmup):
            fail(f"{tag}: kernel {k} launched {serial['launches'][k]} times")
    return out


def phase_cache_kernels(dev, batches, spill) -> None:
    """3 cached steps with the kernels and 3 with the plain versions from
    one state at the cache recipe's shapes: losses (rtol 1e-5), the
    state and the tiers' touched rows (rtol 1e-4, atol 1e-6, a bf16
    value to its neighbour), as ``kernel_vs_plain``; the kernel run
    launches kernels 1, 6, 7 and 8."""
    model, opts = cache_recipe()
    max_swap = max(np.unique(b["ids"]).size for b in batches) + 8
    state_k = init_train_state(model, 2, *opts, device=dev)
    state_p = replace_state(state_k)
    runs = {}
    for name, state, use in (("kernels", state_k, True),
                             ("plain", state_p, False)):
        ad = cache_adapter(model, spill, max_swap)
        step = make_train_step(model, *opts, use_kernels=use)
        torch.cuda.synchronize()
        kernels.reset_launches()
        losses = []
        for b in batches:
            state, (_lw, ld) = cached_train_step(ad, step, state, b)
            losses.append(ld)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        ad.flush_all(state)
        runs[name] = (torch.stack(losses), state, ad, launches)
    lk, sk, adk, launches = runs["kernels"]
    lp, sp, adp, _ = runs["plain"]
    torch.testing.assert_close(lk, lp, rtol=1e-5, atol=0)
    for x, y in zip(_state_tensors(sk), _state_tensors(sp)):
        rtol = 2.0**-7 if x.dtype == torch.bfloat16 else 1e-4
        torch.testing.assert_close(x.float(), y.float(), rtol=rtol, atol=1e-6)
    touched = np.unique(np.concatenate([b["ids"].ravel() for b in batches]))
    rk, rp = tier_rows(adk, touched), tier_rows(adp, touched)
    worst = 0.0
    for k in rk:
        np.testing.assert_allclose(rk[k], rp[k], rtol=1e-4, atol=1e-6,
                                   err_msg=str(k))
        worst = max(worst, float(np.abs(rk[k] - rp[k]).max()))
    rec_log("cache-kernels", json.dumps(dict(
        steps=len(batches), losses_kernels=lk.float().tolist(),
        losses_plain=lp.float().tolist(), tier_max_abs_diff=worst,
        launches={k: launches[k] for k in CACHE_PER_STEP})))
    for k, per in CACHE_PER_STEP.items():
        if launches[k] < per * len(batches):
            fail(f"cache-kernels: kernel {k} launched {launches[k]} times")


def phase_cache_rec(dev, spill) -> dict:
    """The cache recipe through ``RecModel`` as the reference's example
    wires it (examples/train_criteo.py:189-225): the wrapped train step
    over raw batches for 10 steps, then ``eval`` over 2 batches through
    the wrapped eval; ``flush_all`` then a tier read gives the card's
    rows."""
    model, opts = cache_recipe()
    raw, held = cache_batches(10, seed=3), cache_batches(2, seed=4)
    max_swap = max(np.unique(b["ids"]).size for b in raw + held) + 8
    rm = RecModel(model, *opts, jit=True, device=dev)
    adapter = cache_adapter(model, spill, max_swap)
    inner, orig_eval = rm.train_step, rm.eval_step
    rm.train_step = functools.partial(cached_train_step, adapter, inner)

    def cached_eval(params, batch):
        prep = adapter.prepare(batch)
        rm.state = adapter.apply_swap(rm.state, prep)
        adapter.writeback(prep)
        return orig_eval(rm.state.params, adapter.transform(batch, prep))

    rm.eval_step = cached_eval
    torch.cuda.synchronize()
    kernels.reset_launches()
    inner.reset_counts()
    t0 = time.perf_counter()
    rm.train(1, raw, dataset_sink_mode=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = real_launches(inner)
    res = rm.eval(held)
    adapter.flush_all(rm.state)
    items = list(adapter._shadow.items())[:: max(1, len(adapter._shadow) // 4096)]
    ids = np.array([i for i, _ in items], np.int64)
    slots = np.array([s for _, s in items], np.int64)
    same = True
    for name, (path, spec) in model.table_specs.items():
        key = "/".join(path)
        st = rm.state.opt_w if key in rm.state.opt_w else rm.state.opt_d
        for tname, tier in adapter.tiers[name].items():
            leaf = rm.state.params[path[0]][path[1]] if tname == "param" else st[key][tname]
            same &= np.array_equal(tier.read(ids),
                                   read_rows(spec, leaf, slots).float().cpu().numpy())
    out = dict(steps=len(raw), samples_per_s=len(raw) * BATCH / dt,
               ms_per_step=dt / len(raw) * 1e3, auc=res["auc"],
               eval_batches=len(held), captures=inner.captures,
               flush_then_read_equals_card=bool(same), ids_checked=int(ids.size),
               launches={k: launches[k] for k in CACHE_PER_STEP})
    rec_log("cache-rec", json.dumps(out))
    if not same:
        fail("cache-rec: flush_all then a tier read differs from the card")
    if inner.captures != 1 or not np.isfinite(res["auc"]):
        fail(f"cache-rec: captures {inner.captures}, auc {res['auc']}")
    return out


def phase_cache(dev) -> dict:
    """Phase 15: ``[cache-wd]``, ``[cache-evict]``, ``[cache-kernels]``,
    ``[cache-rec]``."""
    spill = tempfile.mkdtemp(prefix="mrec_cache_")
    try:
        batches = cache_batches(CACHE_WARMUP + CACHE_STEPS)
        out = {"wd": cache_pair("cache-wd", dev, CACHE_ROWS, batches,
                                CACHE_WARMUP, spill)}
        torch.cuda.empty_cache()
        out["evict"] = cache_pair("cache-evict", dev, CACHE_EVICT_ROWS,
                                  batches[:CACHE_EVICT_STEPS], 4, spill)
        torch.cuda.empty_cache()
        phase_cache_kernels(dev, batches[:3], spill)
        torch.cuda.empty_cache()
        out["rec"] = phase_cache_rec(dev, spill)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    return out


def hashed_keys(rng, n_ids=DYN_KEYS) -> np.ndarray:
    """Raw int64 keys: the splitmix64 finalizer of zipf(1.3) feature ids
    over ``n_ids``."""
    x = ((rng.zipf(1.3, size=(BATCH, FIELDS)) - 1) % n_ids).astype(np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x.view(np.int64)


def phase_dynamic(dev) -> dict:
    """Phase 16, ``[dyn-wd]``: the W&D accuracy recipe
    (``WideDeepConfig()``) with ``dynamic_embedding=True, sparse=True``
    through ``RecModel.online_train`` over ``adapter.transform_batch`` (as
    benchmarks/online_freshness.py:104-118), admission at 2, eviction
    after 20 idle steps, ``EvictionCallback`` every 10 steps with an
    incremental export; the counters set to 0 just before the run and
    read just after."""
    cfg = WideDeepConfig(dynamic_embedding=True, sparse=True)
    model = WideDeepModel(cfg)
    opts = (optim.ftrl(loss_scale=cfg.loss_scale),
            optim.lazy_adam(loss_scale=cfg.loss_scale))
    rm = RecModel(model, *opts, jit=True, device=dev)
    adapter = DynamicEmbeddingAdapter(cfg.vocab_size, permit_filter_value=2,
                                      evict_filter_value=20, seed=0)
    rng = np.random.default_rng(21)
    raw = [{"ids": hashed_keys(rng), "wts": np.ones((BATCH, FIELDS), np.float32),
            "label": rng.integers(0, 2, (BATCH, 1)).astype(np.float32)}
           for _ in range(DYN_STEPS)]
    out_dir = Path(tempfile.mkdtemp(prefix="mrec_dyn_"))
    freed_log, evict_ms, counts, export = [], [], [], []
    store_evict, real_evict = adapter.store.evict, adapter.evict
    real_export = adapter.export_tables

    def logged_store_evict():
        freed_log.append(store_evict())
        return freed_log[-1]

    def checked_evict(state, tables):
        probe = np.random.default_rng()
        probe.bit_generator.state = adapter._rng.bit_generator.state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_evict(state, tables)
        torch.cuda.synchronize()
        evict_ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(res[1])
        if res[0] is not state:
            fail("dyn-wd: evict replaced the state")
        freed = freed_log[-1]
        for _n, (path, spec) in tables.items():
            want = probe.normal(0, 0.01, (freed.size, spec.emb_dim)).astype(np.float32)
            leaf = state.params[path[0]][path[1]]
            if freed.size and not np.array_equal(
                    read_rows(spec, leaf, freed).cpu().numpy(), want):
                fail(f"dyn-wd: freed rows of {path} differ from the draws")
            key = "/".join(path)
            st = state.opt_w if key in state.opt_w else state.opt_d
            for t in st[key].values():
                if t.shape == leaf.shape and freed.size and \
                        read_rows(spec, t, freed).any():
                    fail(f"dyn-wd: freed optimizer state of {path} not zero")
        return res

    def timed_export(params, tables):
        t0 = time.perf_counter()
        blob = real_export(params, tables)
        export.append(((time.perf_counter() - t0) * 1e3,
                       sum(v.nbytes for v in blob.values()) / 1e6))
        return blob

    adapter.store.evict = logged_store_evict
    adapter.evict = checked_evict
    adapter.export_tables = timed_export
    path = out_dir / "incremental.npz"
    ev = EvictionCallback(adapter, model.table_specs, every_steps=10,
                          export_path=path)
    dummy = [0]

    def stream():
        for b in raw:
            t = adapter.transform_batch(b)
            dummy[0] += int((t["ids"] == adapter.dummy_slot).sum())
            yield t

    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        rm.train_step.reset_counts()
        t0 = time.perf_counter()
        rm.online_train(stream(), callbacks=[ev], dataset_sink_mode=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = real_launches(rm.train_step)
        t1 = time.perf_counter()
        blob = dict(np.load(path))
        load_ms = (time.perf_counter() - t1) * 1e3
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    keys = blob["__keys__"]
    # import into a fresh model with the trained dense parameters (a
    # checkpoint would carry them): predict on the live keys
    fresh = RecModel(model, *opts, seed=1, jit=True, device=dev)
    tables = {"/".join(p) for p, _s in model.table_specs.values()}
    flat_old = dict(flatten_params(rm.state.params))
    for k, t in flatten_params(fresh.state.params):
        if k not in tables:
            t.copy_(flat_old[k])
    ad2 = DynamicEmbeddingAdapter(cfg.vocab_size, seed=1)
    ad2.import_tables(fresh.state.params, blob, model.table_specs)
    n = min(keys.size, BATCH * FIELDS) // FIELDS * FIELDS
    live = keys[:n]
    slots_old = adapter.store.lookup_or_insert(live).reshape(-1, FIELDS)
    slots_new = ad2.store.lookup_or_insert(live).reshape(-1, FIELDS)
    wts = torch.ones(slots_old.shape, device=dev)
    p_old = model.predict(rm.state.params, torch.from_numpy(slots_old).to(dev), wts)
    p_new = model.predict(fresh.state.params, torch.from_numpy(slots_new).to(dev), wts)
    diff = float((p_old - p_new).abs().max())
    out = dict(
        steps=DYN_STEPS, samples_per_s=DYN_STEPS * BATCH / dt,
        ms_per_step=dt / DYN_STEPS * 1e3, capacity=cfg.vocab_size,
        admitted_keys=len(adapter.store),
        dummy_share=dummy[0] / (DYN_STEPS * BATCH * FIELDS),
        evictions_per_call=counts, evict_ms=evict_ms,
        export_ms=[e[0] for e in export], export_mb=[e[1] for e in export],
        export_load_ms=load_ms, exported_keys=int(keys.size),
        import_predict_max_abs_diff=diff, predict_rows=int(slots_old.shape[0]),
        captures=rm.train_step.captures,
        launches={k: launches[k] for k in WD_PER_STEP})
    rec_log("dyn-wd", json.dumps(out))
    if rm.train_step.captures != 1:
        fail(f"dyn-wd: {rm.train_step.captures} captures (expected 1: "
             f"eviction writes the state in place)")
    if not sum(counts) or diff > 1e-6:
        fail(f"dyn-wd: evictions {counts}, import predict diff {diff}")
    for k, per in WD_PER_STEP.items():
        if launches[k] < per * DYN_STEPS:
            fail(f"dyn-wd: kernel {k} launched {launches[k]} times")
    return out



# ---------------------------------------------------------------------------
# phases 17-22: training from files and from a stream (data/, the wire,
# device prep, the auto recipe, Outbrain TFRecords, Kafka)
# ---------------------------------------------------------------------------

FILES_BATCHES, FILES_K, AUTO_BATCHES = 24, 8, 32
# the reference's tunnel figures (its SKILL.md, benchmarks/PROFILE_r04.md),
# quoted only as the simulated link they are
TUNNEL_LINK = (80.0, 60e6)
OB_BATCH, OB_LPS = 4096, 1024  # the Outbrain cut: batch 4,096 of 131,072
ONLINE_ROWS, ONLINE_SENT, ONLINE_BATCH, ONLINE_MSG = 200_000, 40_000, 1000, 1000
# host prep against device prep: the kernel-vs-plain step tolerances
# (losses rtol 1e-5; leaves rtol 2^-7 in bf16, 1e-4 in f32, atol 1e-6)
LOSS_RTOL = 1e-5


def quiet(*a, **k):
    pass


class StopAfter(Callback):
    def __init__(self, n):
        self.n = n

    def on_train_step_end(self, ctx):
        if ctx.cur_step_num >= self.n:
            ctx.request_stop()


def replay_ms(step, state, batch, n=10) -> float:
    """ms per call of a captured step on one staged batch (host clock
    between synchronizes); the state is trained further."""
    step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def files_run(tag, dev, model, opts, ds, n, bucket, fused=0, **kw) -> tuple:
    """``RecModel.train`` over the packed shards: 3 steps that capture,
    then one timed epoch of ``n`` batches (end to end: reading, prep,
    staging, the captured step) with the counters set to 0 just before
    and read just after."""
    rm = RecModel(model, *opts, unique_bucket=AdaptiveBucket(bucket, log=quiet),
                  prep_workers=2, jit=True, device=dev, **kw)
    if fused:
        rm._superbatch = fused
        rm._build_fused(rm.bucket_policy.bucket)
    rm.train(1, ds, callbacks=[StopAfter(3)], dataset_sink_mode=True)
    step = rm._fused[0] if fused else rm.train_step
    warm_captures = step.captures
    torch.cuda.synchronize()
    kernels.reset_launches()
    step.reset_counts()
    rec = DeviceLosses()
    t0 = time.perf_counter()
    rm.train(1, ds, callbacks=[rec], dataset_sink_mode=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = real_launches(step)
    losses = torch.stack(rec.losses).float().cpu().numpy()
    out = dict(samples_per_s=n * BATCH / dt, ms_per_batch=dt / n * 1e3,
               steps=len(losses), graphs_captured=warm_captures + step.captures,
               replays=step.replays, launches=launches,
               last_loss=float(losses[-1]), digest=digest(_state_tensors(rm.state)))
    if len(losses) != n or not np.isfinite(losses).all():
        fail(f"{tag}: {len(losses)} steps for {n} batches, losses {losses}")
    if out["graphs_captured"] != 1 or step.replays != n:
        fail(f"{tag}: {out['graphs_captured']} captures, {step.replays} "
             f"replays for {n} batches")
    for k, per in WD_PER_STEP.items():
        if launches[k] < per * n:
            fail(f"{tag}: kernel {k} launched {launches[k]} times in {n} steps")
    return rm, losses, out


def state_compare(sa, sb) -> dict:
    """Largest difference of each kind of leaf between two states, and
    whether every leaf is within the kernel-vs-plain tolerance."""
    worst, ok = {"bf16": 0.0, "f32": 0.0}, True
    for x, y in zip(_state_tensors(sa), _state_tensors(sb)):
        if x.dtype not in (torch.float32, torch.bfloat16):
            ok &= torch.equal(x, y)
            continue
        kind = "bf16" if x.dtype == torch.bfloat16 else "f32"
        d = (x.float() - y.float()).abs()
        worst[kind] = max(worst[kind], float(d.max()) if d.numel() else 0.0)
        rtol = 2.0**-7 if kind == "bf16" else 1e-4
        ok &= bool((d <= 1e-6 + rtol * y.float().abs()).all())
    return {"max_abs_diff": worst, "within_tol": ok}


def phase_files_wd(dev, model, opts, raw, root) -> dict:
    """Phase 17, ``[files-wd]``: the W&D bench recipe from packed shards,
    three ways: (a) host prep (native, 2 workers, the bucket), (b) device
    prep with ``BatchWire.for_sparse(host_prep=False)``, (c) (b) with the
    fused superbatch step forced at k = 8."""
    t0 = time.perf_counter()
    shards = criteo.write_packed_shards(root / "packed", iter(raw))
    write_s = time.perf_counter() - t0
    mb = sum(f.stat().st_size for f in (root / "packed").iterdir()) / 1e6
    ds = criteo.PackedCriteoDataset(root / "packed", BATCH)
    t0 = time.perf_counter()
    n = sum(1 for _ in ds)
    read_ms = (time.perf_counter() - t0) / n * 1e3
    rec_log("files-data", f"{n} batches of {BATCH}x{FIELDS} in {shards} "
            f"packed shards, {mb:.1f} MB: write {write_s:.2f} s, read "
            f"{read_ms:.2f} ms/batch")
    bucket = AdaptiveBucket.from_sample(raw, log=quiet).bucket
    native = make_batch_sort(FIELDS, unique_bucket=bucket, minimal=True)
    host0 = native(dict(raw[0]))
    host0["uq_ids"] = host0["uq_ids"][:bucket]
    wire_ = BatchWire.for_sparse(VOCAB, BATCH, FIELDS, host_prep=False)
    arena0 = wire_.encode(raw[0])
    t0 = time.perf_counter()
    for _ in range(5):
        wire_.encode(raw[0])
    encode_ms = (time.perf_counter() - t0) / 5 * 1e3
    t0 = time.perf_counter()
    for _ in range(5):
        np.unique(raw[0]["ids"])
    audit_ms = (time.perf_counter() - t0) / 5 * 1e3
    staged_arena = to_device(arena0, dev)
    dec = wire_.decoder()
    dec(staged_arena)
    decode_ms = cuda_ms(lambda: dec(staged_arena), 20)

    runs = {}
    rm_a, la, runs["host"] = files_run("files-wd-host", dev, model, opts, ds,
                                       n, bucket)
    runs["host"].update(prep_ms_per_batch=prep_ms(native, raw[0], 10),
                        staged_bytes_per_batch=sum(
                            v.nbytes for v in host0.values()))
    rm_b, lb, runs["device"] = files_run(
        "files-wd-device", dev, model, opts, ds, n, bucket,
        prep_placement="device", wire=wire_)
    wire_c = BatchWire.for_sparse(VOCAB, BATCH, FIELDS, host_prep=False)
    rm_c, lc, runs["fused"] = files_run(
        "files-wd-fused", dev, model, opts, ds, n, bucket, fused=FILES_K,
        prep_placement="device", wire=wire_c)
    for k in ("device", "fused"):
        runs[k].update(encode_ms_per_batch=encode_ms,
                       audit_ms_per_16_batches=audit_ms,
                       staged_bytes_per_batch=int(arena0[ARENA_KEY].nbytes),
                       decode_ms=decode_ms)
    runs["fused"]["staged_bytes_per_copy"] = FILES_K * int(arena0[ARENA_KEY].nbytes)
    same_bc = bool(np.array_equal(lb, lc)) and all(
        torch.equal(x, y) for x, y in zip(_state_tensors(rm_b.state),
                                          _state_tensors(rm_c.state)))
    cmp_ab = state_compare(rm_a.state, rm_b.state)
    loss_diff = float(np.abs(la - lb).max())
    loss_ok = bool(np.allclose(lb, la, rtol=LOSS_RTOL, atol=0))
    runs["host"]["captured_step_ms"] = replay_ms(rm_a.train_step, rm_a.state,
                                                 to_device(host0, dev))
    runs["device"]["captured_step_ms"] = replay_ms(
        rm_b.train_step, rm_b.state, dec(staged_arena))
    runs["fused"]["captured_step_ms"] = replay_ms(
        rm_c._fused[0], rm_c.state, staged_arena)
    for k, v in runs.items():
        rec_log(f"files-wd-{k}", json.dumps(v))
    rec_log("files-wd-compare", json.dumps(dict(
        device_equals_fused_bit_for_bit=same_bc,
        host_vs_device_max_loss_diff=loss_diff,
        host_vs_device_state=cmp_ab, losses_within_rtol=loss_ok,
        tolerance="losses rtol 1e-5; leaves rtol 2^-7 (bf16), 1e-4 (f32), "
                  "atol 1e-6",
        device_prep_beats_host_prep_end_to_end=runs["device"]["samples_per_s"]
        > runs["host"]["samples_per_s"])))
    if not same_bc or runs["device"]["digest"] != runs["fused"]["digest"]:
        fail("files-wd: the fused step differs from per-batch device prep")
    if not (cmp_ab["within_tol"] and loss_ok):
        fail(f"files-wd: host prep vs device prep outside the tolerance: "
             f"{cmp_ab}, loss diff {loss_diff}")
    del rm_a, rm_b, rm_c
    torch.cuda.empty_cache()
    return {"runs": runs, "bucket": bucket, "launches": runs["host"]["launches"]}


def same_arrays(tag, got, want) -> None:
    if len(got) != len(want):
        fail(f"{tag}: {len(got)} batches, expected {len(want)}")
    for g, w in zip(got, want):
        for k in w:
            if g[k].dtype != w[k].dtype or not np.array_equal(g[k], w[k]):
                fail(f"{tag}: key {k} differs from the packed path's batch")


def phase_files_tfrecord(dev, model, opts, raw, bucket, root) -> dict:
    """Phase 18, ``[files-tfrecord]``: 2 bench-recipe batches (32
    records) as TFRecord, and as H5 where h5py is installed, read through
    ``create_dataset``, equal to the packed path's batches, 2 steps each."""
    packed = list(criteo.PackedCriteoDataset(root / "packed", BATCH))[:2]
    out = {}
    t0 = time.perf_counter()
    formats.write_criteo_tfrecords(root / "tfr", iter(raw[:2]))
    out["tfrecord_write_ms_per_batch"] = (time.perf_counter() - t0) / 2 * 1e3
    ds = formats.create_dataset(root / "tfr", BATCH, formats.DataType.TFRECORD)
    t0 = time.perf_counter()
    got = list(ds)
    out["tfrecord_read_ms_per_batch"] = (time.perf_counter() - t0) / 2 * 1e3
    same_arrays("files-tfrecord", got, packed)
    sources = {"tfrecord": ds}
    try:
        import h5py  # noqa: F401  (optional, as in the reference)
    except ImportError:
        rec_log("files-h5", "h5py is not installed on this machine: the H5 "
                "reader is not run here (not a failure)")
    else:
        t0 = time.perf_counter()
        formats.H5CriteoDataset.write_parts(root / "h5", iter(raw[:2]),
                                            samples_per_part=2 * BATCH)
        out["h5_write_ms_per_batch"] = (time.perf_counter() - t0) / 2 * 1e3
        h5 = formats.create_dataset(root / "h5", BATCH, formats.DataType.H5)
        t0 = time.perf_counter()
        same_arrays("files-h5", list(h5), packed)
        out["h5_read_ms_per_batch"] = (time.perf_counter() - t0) / 2 * 1e3
        sources["h5"] = h5
    rm = RecModel(model, *opts, unique_bucket=AdaptiveBucket(bucket, log=quiet),
                  prep_workers=2, jit=True, device=dev)
    for name, src in sources.items():
        rec = DeviceLosses()
        rm.train(1, src, callbacks=[rec], dataset_sink_mode=True)
        losses = torch.stack(rec.losses).float().cpu().numpy()
        if len(losses) != 2 or not np.isfinite(losses).all():
            fail(f"files-{name}: losses {losses}")
        out[f"{name}_losses"] = losses.tolist()
    rec_log("files-tfrecord", json.dumps(out))
    del rm
    torch.cuda.empty_cache()
    return out


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 -> its bf16 value as float32 (the reference's rounding;
    ``wire.bf16_bits`` is held to ``ml_dtypes`` in the CPU tests)."""
    return (bf16_bits(x).astype(np.uint32) << 16).view(np.float32)


def phase_wire_card(dev, raw0) -> dict:
    """Phase 19, ``[wire-card]``: decode of encode on the card equals the
    batch bit for bit (``lossy=()``: ``for_sparse`` with host prep off
    and on, ``for_fields``); with lossy bf16 weights it equals the
    reference's rounding of them; decode µs per batch."""
    rng = np.random.default_rng(3)
    b = dict(raw0, wts=rng.normal(0, 3, (BATCH, FIELDS)).astype(np.float32))
    prep = make_batch_sort(FIELDS, minimal=True)(dict(b))
    fb = dict(b, wts=b["wts"].copy())
    fb["wts"][:, N_DENSE_FIELDS:] = 1.0
    plans = {
        "sparse": (BatchWire.for_sparse(VOCAB, BATCH, FIELDS, lossy_wts=False), b),
        "sparse_host_prep": (BatchWire.for_sparse(
            VOCAB, BATCH, FIELDS, host_prep=True, lossy_wts=False), prep),
        "fields": (BatchWire.for_fields(
            criteo_field_sizes(VOCAB, FIELDS), BATCH,
            wt_value_fields=range(N_DENSE_FIELDS), lossy_wts=False), fb),
        "sparse_lossy_bf16": (BatchWire.for_sparse(VOCAB, BATCH, FIELDS), b),
    }
    out = {}
    for name, (w, batch) in plans.items():
        packed = w.encode(batch)
        staged = to_device(packed, dev)
        dec = w.decoder()
        got = dec(staged)
        want = dict(batch)
        if name == "sparse_lossy_bf16":
            want["wts"] = bf16_round(batch["wts"])
        for k, v in want.items():
            if not torch.equal(got[k].cpu(), torch.from_numpy(np.asarray(v))):
                fail(f"wire-card {name}: key {k} not bit-equal after decode")
        out[name] = dict(decode_us=cuda_ms(lambda: dec(staged), 20) * 1e3,
                         bytes=int(packed[ARENA_KEY].nbytes),
                         unpacked_bytes=int(sum(np.asarray(v).nbytes
                                                for v in batch.values())))
    rec_log("wire-card", json.dumps(out))
    return out


def phase_auto(dev, model, opts, raw, bucket) -> dict:
    """Phase 20, ``[auto]``: ``input_recipe="auto"`` on the card (the
    measured link and the decision), then with ``measure_link`` replaced
    by the reference's tunnel figures: device prep, the wire and k = 16,
    32 batches, one capture."""
    rm = RecModel(model, *opts, unique_bucket=AdaptiveBucket(bucket, log=quiet),
                  prep_workers=2, input_recipe="auto", device=dev)
    rm.train(1, raw[:2], dataset_sink_mode=True)
    fixed_ms, bw = rm.link
    out = {"measured": dict(fixed_ms_per_put=fixed_ms, gb_per_s=bw / 1e9,
                            decision=rm.prep_placement, wire=rm.wire is not None,
                            superbatch=rm._superbatch)}
    del rm
    torch.cuda.empty_cache()
    real = wire_mod.measure_link
    wire_mod.measure_link = lambda *a, **k: TUNNEL_LINK
    try:
        rm = RecModel(model, *opts,
                      unique_bucket=AdaptiveBucket(bucket, log=quiet),
                      prep_workers=2, input_recipe="auto", device=dev)
        torch.cuda.synchronize()
        kernels.reset_launches()
        rec = DeviceLosses()
        t0 = time.perf_counter()
        rm.train(1, raw[:AUTO_BATCHES], callbacks=[rec], dataset_sink_mode=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        wire_mod.measure_link = real
    step = rm._fused[0] if rm._fused is not None else rm.train_step
    launches = real_launches(step)
    losses = torch.stack(rec.losses).float().cpu().numpy()
    out["tunnel"] = dict(
        link=TUNNEL_LINK, decision=rm.prep_placement, superbatch=rm._superbatch,
        fused=rm._fused is not None, steps=len(losses),
        samples_per_s=AUTO_BATCHES * BATCH / dt, captures=step.captures,
        replays=step.replays, launches={k: launches[k] for k in WD_PER_STEP},
        last_loss=float(losses[-1]))
    rec_log("auto", json.dumps(out))
    if (rm.prep_placement != "device" or rm._superbatch != 16
            or rm._fused is None or rm.wire is None):
        fail(f"auto: the tunnel link chose {out['tunnel']}")
    if step.captures != 1 or step.replays != AUTO_BATCHES - 1 or \
            len(losses) != AUTO_BATCHES or not np.isfinite(losses).all():
        fail(f"auto: {step.captures} captures, {step.replays} replays, "
             f"losses {losses}")
    for k, per in WD_PER_STEP.items():
        if launches[k] < per * AUTO_BATCHES:
            fail(f"auto: kernel {k} launched {launches[k]} times")
    del rm
    torch.cuda.empty_cache()
    return out


def phase_files(dev) -> dict:
    """Phases 17-20 over one set of bench-recipe batches written to a
    temporary directory."""
    model, opts = wd_recipe()
    data = SyntheticCriteo(BATCH, FIELDS, VOCAB, steps=AUTO_BATCHES, seed=31,
                           fields="criteo")
    t0 = time.perf_counter()
    raw = [data.get_batch(s) for s in range(AUTO_BATCHES)]
    log(f"[files-data] {len(raw)} raw batches in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    root = Path(tempfile.mkdtemp(prefix="mrec_files_"))
    try:
        out = phase_files_wd(dev, model, opts, raw[:FILES_BATCHES], root)
        out["tfrecord"] = phase_files_tfrecord(dev, model, opts, raw,
                                               out["bucket"], root)
        out["wire"] = phase_wire_card(dev, raw[0])
        out["auto"] = phase_auto(dev, model, opts, raw, out["bucket"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def outbrain_rows(batch, lps) -> list:
    """A batch as packed rows of the 21-column TFRecord schema (the
    columns no model reads hold the sample's index)."""
    B = batch["label"].shape[0]
    rows = []
    for r in range(0, B, lps):
        row = {}
        for col in ob_data.COLUMNS:
            key = ob_data._batch_key(col)
            v = batch[key][r:r + lps] if key in batch else \
                np.arange(r, r + lps, dtype=np.int32)
            row[col] = np.asarray(v).reshape(lps, -1)
        rows.append(row)
    return rows


def phase_outbrain_files(dev) -> dict:
    """Phase 21, ``[outbrain-files]``: Outbrain TFRecords written by
    ``write_outbrain_tfrecords`` and read by ``OutbrainTFRecordDataset``,
    the multitable recipe's widths trained through ``RecModel`` with host
    prep (batch 4,096, 2 steps: the cut)."""
    model, opts = mt_recipe(batch=OB_BATCH)
    batches = list(SyntheticOutbrain(model.config, 2, seed=5))
    root = Path(tempfile.mkdtemp(prefix="mrec_ob_"))
    try:
        rows = [r for b in batches for r in outbrain_rows(b, OB_LPS)]
        t0 = time.perf_counter()
        ob_data.write_outbrain_tfrecords(root, iter(rows), rows_per_file=4)
        write_ms = (time.perf_counter() - t0) / 2 * 1e3
        ds = ob_data.OutbrainTFRecordDataset(root, OB_BATCH)
        t0 = time.perf_counter()
        got = list(ds)
        read_ms = (time.perf_counter() - t0) / 2 * 1e3
        for g, w in zip(got, batches):
            for k, v in w.items():
                if not np.array_equal(g[k], v) or g[k].dtype != v.dtype:
                    fail(f"outbrain-files: key {k} differs after the round trip")
        if len(got) != 2:
            fail(f"outbrain-files: {len(got)} batches read, expected 2")
        rm = RecModel(model, *opts, host_prep=True, prep_workers=2, jit=True,
                      device=dev)
        torch.cuda.synchronize()
        kernels.reset_launches()
        rm.train_step.reset_counts()
        rec = DeviceLosses()
        t0 = time.perf_counter()
        rm.train(1, ds, callbacks=[rec], dataset_sink_mode=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = real_launches(rm.train_step)
    losses = torch.stack(rec.losses).float().cpu().numpy()
    out = dict(batch=OB_BATCH, write_ms_per_batch=write_ms,
               read_ms_per_batch=read_ms, steps=len(losses),
               samples_per_s=len(losses) * OB_BATCH / dt,
               captures=rm.train_step.captures, launches=launches,
               losses=losses.tolist())
    rec_log("outbrain-files", json.dumps(out))
    if len(losses) != 2 or not np.isfinite(losses).all():
        fail(f"outbrain-files: losses {losses}")
    for k, per in MT_PER_STEP.items():
        if launches[k] < per * 2:
            fail(f"outbrain-files: kernel {k} launched {launches[k]} times")
    del rm
    torch.cuda.empty_cache()
    return out


class StepClock(Callback):
    """Host time at each step's end."""

    def __init__(self):
        self.ends = []

    def on_train_step_end(self, ctx):
        self.ends.append(time.perf_counter())


class MtimeProbe(Callback):
    """After ``CheckpointCallback`` (sync saves): each new file's mtime,
    by step, before retention deletes it."""

    def __init__(self, ck):
        self.ck, self.mtimes = ck, {}

    def on_train_step_end(self, ctx):
        if ctx.cur_step_num % self.ck.save_steps == 0 and self.ck.saved:
            self.mtimes[ctx.cur_step_num] = os.stat(self.ck.saved[-1]).st_mtime


def phase_online_kafka(dev) -> dict:
    """Phase 22, ``[online-kafka]``: RealisticCriteo rows as TSV, their
    stats, a stub Kafka broker with 2 partitions fed by 2 producer
    threads (JSON messages of 1,000 rows), KafkaSource ->
    CriteoFeatureEngineer -> Channel -> StreamingDataset ->
    ``RecModel.online_train`` at the online recipe, checkpoints every 10
    steps keeping 2; freshness as benchmarks/online_freshness.py."""
    root = Path(tempfile.mkdtemp(prefix="mrec_online_"))
    broker = None
    try:
        t0 = time.perf_counter()
        files = realistic.write_tsv(realistic.RealisticCriteo(
            vocab_scale=0.03, seed=0), root / "tsv", ONLINE_ROWS,
            rows_per_file=ONLINE_ROWS // 2)
        tsv_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats = preprocess.collect_stats(files, workers=2)
        stats_s = time.perf_counter() - t0
        with open(files[0]) as f:
            lines = [next(f).rstrip("\n").split("\t") for _ in range(ONLINE_SENT)]
        cfg = WideDeepConfig(batch_size=ONLINE_BATCH, field_size=FIELDS,
                             vocab_size=stats.vocab_size, emb_dim=EMB,
                             deep_layer_dim=(1024, 512, 256, 128), sparse=True)
        model = WideDeepModel(cfg)
        rm = RecModel(model, optim.ftrl(loss_scale=cfg.loss_scale),
                      optim.lazy_adam(loss_scale=cfg.loss_scale), jit=True,
                      device=dev)
        broker = kafka_stub.StubKafkaBroker()
        bootstrap = broker.start()
        streaming.create_topic("criteo_stream", 2, bootstrap_servers=bootstrap)
        sent, order = {}, []
        src = streaming.KafkaSource("criteo_stream", [0, 1],
                                    bootstrap_servers=bootstrap, count=1,
                                    idle_timeout_ms=3000,
                                    auto_offset_reset="earliest")
        fe = streaming.CriteoFeatureEngineer(stats)

        def batches():
            for msgs in src:
                order.append(hashlib.sha1(msgs[0]).digest())
                yield fe(json.loads(msgs[0]))

        def produce(part):
            prod = kafka_wire.MiniKafkaProducer(bootstrap)
            mine = lines[part::2]
            for i in range(0, len(mine), ONLINE_MSG):
                value = json.dumps(mine[i:i + ONLINE_MSG]).encode()
                sent[hashlib.sha1(value).digest()] = time.time()
                prod.send("criteo_stream", value=value, partition=part)
            prod.close()

        channel = streaming.Channel(num_shards=1)
        ck = CheckpointCallback(str(root / "ckpt"), save_steps=10, keep_max=2)
        probe = MtimeProbe(ck)
        rec, clock = DeviceLosses(), StepClock()
        torch.cuda.synchronize()
        kernels.reset_launches()
        rm.train_step.reset_counts()
        t0 = time.perf_counter()
        feeder = streaming.feed_channel_from_iterator(batches(), channel)
        producers = [threading.Thread(target=produce, args=(p,), daemon=True)
                     for p in (0, 1)]
        for t in producers:
            t.start()
        rm.online_train(streaming.StreamingDataset(channel.receiver(0)),
                        callbacks=[rec, ck, probe, clock])
        torch.cuda.synchronize()
        # to the last step: the stream then idles until the consumer's
        # idle timeout ends it
        dt = clock.ends[-1] - t0
        for t in producers + [feeder]:
            t.join(timeout=60)
            if t.is_alive():
                fail("online-kafka: a producer or the feeder did not end")
        launches = real_launches(rm.train_step)
        losses = torch.stack(rec.losses).float().cpu().numpy()
        fresh = []
        for b, h in enumerate(order):
            cover = -(-(b + 1) // 10) * 10
            if cover in probe.mtimes:
                fresh.append(probe.mtimes[cover] - sent[h])
        t1 = time.perf_counter()
        restored = checkpoint.restore_checkpoint(ck.saved[-1], rm.state)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t1) * 1e3
        same = all(torch.equal(x, y) for x, y in zip(
            _state_tensors(restored), _state_tensors(rm.state)))
        kept = len(list((root / "ckpt").iterdir()))
    finally:
        if broker is not None:
            broker.stop()
        shutil.rmtree(root, ignore_errors=True)
    steps = ONLINE_SENT // ONLINE_BATCH
    out = dict(rows_written=ONLINE_ROWS, tsv_write_s=tsv_s,
               collect_stats_s=stats_s, vocab_size=stats.vocab_size,
               rows_sent=ONLINE_SENT, steps=len(losses),
               samples_per_s=len(losses) * ONLINE_BATCH / dt,
               freshness_median_s=float(np.median(fresh)) if fresh else None,
               freshness_worst_s=max(fresh) if fresh else None,
               covered=len(fresh), checkpoints_kept=kept,
               restore_ms=restore_ms, restored_equals_live=same,
               all_losses_finite=bool(np.isfinite(losses).all()),
               captures=rm.train_step.captures,
               launches={k: launches[k] for k in WD_PER_STEP})
    rec_log("online-kafka", json.dumps(out))
    if len(losses) != steps or not np.isfinite(losses).all():
        fail(f"online-kafka: {len(losses)} steps for {steps}, losses {losses}")
    if len(fresh) != steps or not same or rm.train_step.captures != 1:
        fail(f"online-kafka: {len(fresh)} batches covered, restore equal "
             f"{same}, {rm.train_step.captures} captures")
    for k, per in WD_PER_STEP.items():
        if launches[k] < per * steps:
            fail(f"online-kafka: kernel {k} launched {launches[k]} times")
    out["launches_all"] = launches
    del rm
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 23-26: PS mode (table servers, remote tiers under the cache, the
# host-target regime, the distributed hash store, the TB-scale point)
# ---------------------------------------------------------------------------

PS_SERVERS = 2
PS_HOST_WARMUP, PS_HOST_STEPS = 2, 6
# BASELINE.md:14 and examples/train_terabyte.py: virtual vocab, width,
# cache rows, MLP, id skew; the servers' RAM cap per table (cut from 10 GB)
TB_VIRTUAL, TB_EMB, TB_CACHE_ROWS = 900_000_000, 240, 4_600_000
TB_LAYERS, TB_ZIPF, TB_RAM_MB = (1024, 512, 256, 128), 1.1, 512
TB_WARMUP, TB_STEPS, TB_CHECK_IDS = 2, 6, 10_000
# [dyn-wd]'s recipe; eviction after 8 idle steps every 5 steps, so that
# 20 steps evict (after 20 idle steps every 10, as [dyn-wd], none would)
PS_DYN_STEPS, PS_DYN_EVICT, PS_DYN_EVERY = 20, 8, 5
HOST_PER_STEP = {"segsum_sorted": 1}


@contextlib.contextmanager
def table_servers(n, root, ram_mb=None):
    """``n`` of the port's table servers (built by g++ at first use) on
    free ports, each spilling into its own directory under ``root``;
    yields their addresses.  Each is shut down at the end, and killed if
    it has not exited within 10 s; a server found dead fails the run."""
    procs = []
    try:
        for _ in range(n):
            procs.append(remote.launch_table_server(
                ram_mb=ram_mb, spill_dir=tempfile.mkdtemp(dir=root)))
        yield [p.addr for p in procs]
        dead = [(p.addr, p.returncode) for p in procs if p.poll() is not None]
        if dead:
            fail(f"table servers died during the phase: {dead}")
    finally:
        for p in procs:
            remote.stop_table_server(p.addr, p)


SERIAL_PARTS = ("ms_per_step", "prepare_ms", "lru_lookup_ms",
                "tier_reads_thread_ms", "swap_dispatch_ms",
                "swap_plus_step_stream_ms", "writeback_ms", "step_dispatch_ms")


def phase_ps_cache(dev, host_cache) -> dict:
    """Phase 23, ``[ps-cache]``: ``[cache-wd]``'s and ``[cache-evict]``'s
    pairs (serial protocol and ``AsyncCachedTrainer`` from one state, bit
    for bit) with every tier a ``RemoteTier`` on 2 table servers (each
    run its own 2, so both start from the servers' initial rows); with
    evictions every evicted row, read back from the servers, equals the
    arena's row before the swap.  Each part's ms beside ``[cache-wd]``'s
    and ``[cache-evict]``'s host tiers from this run."""
    root = tempfile.mkdtemp(prefix="mrec_ps_cache_")
    try:
        with contextlib.ExitStack() as stack:
            def remote_adapter(model, _spill, max_swap):
                addrs = stack.enter_context(table_servers(PS_SERVERS, root))
                return CachedTrainingAdapter(
                    model, virtual_vocab=CACHE_VIRTUAL,
                    cache_rows=model.config.vocab_size, max_swap=max_swap,
                    remote_addrs=addrs)

            batches = cache_batches(CACHE_WARMUP + CACHE_STEPS)
            out = {"wd": cache_pair("ps-cache", dev, CACHE_ROWS, batches,
                                    CACHE_WARMUP, root, remote_adapter)}
            torch.cuda.empty_cache()
            out["evict"] = cache_pair(
                "ps-cache-evict", dev, CACHE_EVICT_ROWS,
                batches[:CACHE_EVICT_STEPS], 4, root, remote_adapter,
                check_evicted=True)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not out["evict"]["serial"]["evicted_rows_checked"]:
        fail("ps-cache-evict: no row was evicted")
    for k in ("wd", "evict"):
        rec_log(f"ps-cache-{k}-vs-host", json.dumps({
            p: {"servers": out[k]["serial"][p], "host": host_cache[k]["serial"][p]}
            for p in SERIAL_PARTS}))
    return out


def ps_host_run(tag, dev, model, opts, batches, bucket, union, rows0,
                root, remote_addrs=None) -> dict:
    """The host-target regime over ``batches`` (``PS_HOST_WARMUP``, then
    the rest timed with the counters set to 0 just before and read just
    after), its param tiers holding ``rows0`` for ``union`` first."""
    ad = HostTargetAdapter(model, VOCAB, bucket, *opts, spill_dir=root,
                           remote_addrs=remote_addrs)
    for n, rows in rows0.items():
        ad.tiers[n]["param"].write(union, rows)
    state = init_dense_state(model, 0, *opts, device=dev)
    tables = [k for k, _ in flatten_params(state.params) if "table" in k]
    if tables:
        fail(f"{tag}: the dense state holds tables {tables}")
    io = {"read": [], "write": []}

    def timed(kind, fn):
        def run(*a):
            t = time.perf_counter()
            res = fn(*a)
            io[kind].append((time.perf_counter() - t) * 1e3)
            return res
        return run

    for tiers in ad.tiers.values():
        for tier in tiers.values():
            tier.read, tier.write = timed("read", tier.read), timed("write", tier.write)
    losses = []
    for b in batches[:PS_HOST_WARMUP]:
        state, (_lw, ld) = ad.train_step(state, b)
        losses.append(ld)
    torch.cuda.synchronize()
    kernels.reset_launches()
    io["read"].clear()
    io["write"].clear()
    t0 = time.perf_counter()
    for b in batches[PS_HOST_WARMUP:]:
        state, (_lw, ld) = ad.train_step(state, b)
        losses.append(ld)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n = len(batches) - PS_HOST_WARMUP
    rows = {(name, t): tier.read(union) for name, tiers in ad.tiers.items()
            for t, tier in tiers.items()}
    losses = torch.stack(losses).float().cpu().numpy()
    if not np.isfinite(losses).all():
        fail(f"{tag}: non-finite losses {losses}")
    for k, per in HOST_PER_STEP.items():
        if launches[k] < per * n:
            fail(f"{tag}: kernel {k} launched {launches[k]} times in {n} steps")
    return dict(state=state, losses=losses, rows=rows, metrics=dict(
        samples_per_s=n * BATCH / dt, ms_per_step=dt / n * 1e3,
        tier_reads_thread_ms=float(np.sum(io["read"]) / n),
        tier_writes_thread_ms=float(np.sum(io["write"]) / n),
        warmup_steps=PS_HOST_WARMUP, timed_steps=n,
        launches={k: launches[k] for k in HOST_PER_STEP},
        last_loss=float(losses[-1])))


def phase_ps_host(dev, data, bucket) -> dict:
    """Phase 24, ``[ps-host]``: the W&D bench recipe with
    ``parameter_server=True, vocab_cache_size=0`` (the host-target regime:
    tables never on the card) over its 8 batches, once on host tiers and
    once on 2 table servers, both tiers holding the same seeded rows of
    the run's ids before step 0: losses, every tier's rows and the dense
    parameters equal bit for bit.  ``segsum_sorted`` at this path's shape
    (batch 0's [624000, 17] bf16 gradient through its ``perm``) against
    its plain version and a float64 sum."""
    wd_model, opts = wd_recipe()
    model = WideDeepModel(dataclasses.replace(wd_model.config,
                                              parameter_server=True))
    batches = [data.get_batch(s) for s in range(len(data))]
    union = np.unique(np.concatenate([b["ids"].ravel() for b in batches])
                      ).astype(np.int64)
    rng = np.random.default_rng(24)
    rows0 = {n: rng.normal(0, 0.01, (union.size, spec.emb_dim)).astype(np.float32)
             for n, (_p, spec) in model.table_specs.items()}
    _uq, _uidx, perm, uidx_sorted = sort_ids(batches[0]["ids"].reshape(-1)
                                             .astype(np.int64))
    d = sum(spec.emb_dim for _p, spec in model.table_specs.values())
    gen = torch.Generator(device=dev).manual_seed(24)
    kern = check_sorted(dev, gen, ("ps-host", torch.from_numpy(uidx_sorted).to(dev),
                                   torch.from_numpy(perm).to(dev), perm.size, d,
                                   bucket))
    root = tempfile.mkdtemp(prefix="mrec_ps_host_")
    try:
        host = ps_host_run("ps-host", dev, model, opts, batches, bucket, union,
                           rows0, root)
        with table_servers(PS_SERVERS, root) as addrs:
            srv = ps_host_run("ps-host", dev, model, opts, batches, bucket,
                              union, rows0, root, remote_addrs=addrs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    same_losses = np.array_equal(host["losses"], srv["losses"])
    same_rows = all(np.array_equal(host["rows"][k], srv["rows"][k])
                    for k in host["rows"])
    same_dense = all(torch.equal(x, y) for (_a, x), (_b, y) in zip(
        flatten_params(host["state"].params), flatten_params(srv["state"].params)))
    out = dict(host_tiers=host["metrics"], servers=srv["metrics"],
               bucket=bucket, union_ids=int(union.size), segsum_sorted=kern,
               bit_identical_losses=same_losses, bit_identical_rows=same_rows,
               bit_identical_dense=same_dense,
               launches=srv["metrics"]["launches"])
    rec_log("ps-host", json.dumps(out))
    if not (same_losses and same_rows and same_dense):
        fail(f"ps-host: servers differ from host tiers (losses {same_losses}, "
             f"rows {same_rows}, dense {same_dense})")
    return out


def tb_recipe():
    """The TB-scale point's model (built with vocab = the cache's rows,
    feature-major tables) and optimizers (examples/train_terabyte.py)."""
    cfg = WideDeepConfig(
        batch_size=BATCH, field_size=FIELDS, vocab_size=TB_CACHE_ROWS,
        emb_dim=TB_EMB, deep_layer_dim=TB_LAYERS, sparse=True,
        table_layout="feature_major")
    return WideDeepModel(cfg), (optim.ftrl(loss_scale=cfg.loss_scale),
                                optim.lazy_adam(loss_scale=cfg.loss_scale))


def tb_batches(n, seed=25) -> list:
    """zipf(1.1) ids over the 900M virtual vocab, weights uniform in
    [0.5, 1.5) (examples/train_terabyte.py:92-100)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = (rng.zipf(TB_ZIPF, (BATCH, FIELDS)).astype(np.int64) - 1) % TB_VIRTUAL
        out.append({"ids": ids,
                    "wts": rng.uniform(0.5, 1.5, ids.shape).astype(np.float32),
                    "label": rng.integers(0, 2, (BATCH, 1)).astype(np.float32)})
    return out


def tb_kernels(dev, model, batch0) -> dict:
    """gather_rows, segsum_sorted, adam_cols and ftrl_cols at the TB
    point's launch shapes on batch 0 (its slots from a fresh LRU, as the
    adapter's first step gives them), each against its plain version."""
    slots = LruCache(TB_CACHE_ROWS).lookup(batch0["ids"].reshape(-1))[0]
    host = make_batch_sort(FIELDS, minimal=True)(
        {"ids": slots.reshape(BATCH, FIELDS).astype(np.int32)})
    gen = torch.Generator(device=dev).manual_seed(25)
    cases = {c["name"]: c for c in table_launches(dev, model, host)}
    deep, wide = cases["deep"], cases["wide"]
    res = {f"gather_rows_{n}": check_gather_launch(dev, gen, "ps-tb", c, 0)
           for n, c in cases.items()}
    res["ftrl_cols"] = check_ftrl_launch(dev, gen, "ps-tb", wide, 0, plain=True)
    res["adam_cols"] = check_adam_cols(
        "ps-tb deep", dev, gen, deep["shape"], deep["fold"], deep["cols"],
        deep["sub"], torch.float32, eps=1e-8, loss_scale=1024.0)
    torch.cuda.empty_cache()
    res["segsum_sorted"] = check_sorted(
        dev, gen, ("ps-tb", torch.from_numpy(host["uidx_sorted"]).to(dev),
                   torch.from_numpy(host["perm"]).to(dev), BATCH * FIELDS,
                   deep["width"], deep["cols"].numel()))
    torch.cuda.empty_cache()
    return res


def phase_ps_tb(dev) -> dict:
    """Phase 25, ``[ps-tb]``: the TB-scale capability point (BASELINE.md:14,
    examples/train_terabyte.py): W&D, virtual vocab 900M x emb 240 behind
    a 4.6M-row cache on the card (feature-major tables, FTRL + LazyAdam,
    1024-512-256-128), batch 16,000 x 39 zipf(1.1) ids, its tiers on 2
    table servers capped at 512 MB of RAM per table: first the four cache
    kernels at this width on batch 0, then 2 warm-up and 6 timed serial
    steps (counters set to 0 just before the timed ones), ``flush_all``,
    and the rows of 10,000 resident ids read back from the servers equal
    to the arena's in every tier."""
    model, opts = tb_recipe()
    batches = tb_batches(TB_WARMUP + TB_STEPS)
    uniques = [np.unique(b["ids"]).size for b in batches]
    kern = tb_kernels(dev, model, batches[0])
    root = tempfile.mkdtemp(prefix="mrec_ps_tb_")
    try:
        with table_servers(PS_SERVERS, root, ram_mb=TB_RAM_MB) as addrs:
            adapter = CachedTrainingAdapter(
                model, virtual_vocab=TB_VIRTUAL, cache_rows=TB_CACHE_ROWS,
                max_swap=max(uniques) + 8, remote_addrs=addrs)
            state = init_train_state(model, 0, *opts, device=dev)
            arena_gb = arena_mb(model, state) / 1e3
            state, serial = cache_serial("ps-tb", model, opts, state, batches,
                                         adapter, uniques, TB_WARMUP)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            adapter.flush_all(state)
            flush_ms = (time.perf_counter() - t0) * 1e3
            items = list(adapter._shadow.items())
            pick = np.random.default_rng(25).choice(len(items), TB_CHECK_IDS,
                                                    replace=False)
            ids = np.array([items[i][0] for i in pick], np.int64)
            slots = np.array([items[i][1] for i in pick], np.int64)
            same = True
            for name, (path, spec) in model.table_specs.items():
                key = "/".join(path)
                st = state.opt_w if key in state.opt_w else state.opt_d
                for tname, tier in adapter.tiers[name].items():
                    leaf = (state.params[path[0]][path[1]] if tname == "param"
                            else st[key][tname])
                    same &= np.array_equal(tier.read(ids), read_rows(
                        spec, leaf, slots).float().cpu().numpy())
            stats = {f"{n}.{t}": tier.stats() for n, tiers in adapter.tiers.items()
                     for t, tier in tiers.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row_bytes = sum(t.dim * 4 for tiers in adapter.tiers.values()
                    for t in tiers.values())
    read_s = (serial["prepare_ms"] - serial["lru_lookup_ms"]) / 1e3
    ssd = sum(s for _r, s in stats["deep.param"])
    out = dict(
        virtual_table_gb=TB_VIRTUAL * TB_EMB * 4 / 1e9, arena_gb=arena_gb,
        cache_rows=TB_CACHE_ROWS, servers=PS_SERVERS, ram_mb_per_table=TB_RAM_MB,
        distinct_ids_per_step=uniques, serial=serial, flush_all_ms=flush_ms,
        loopback_rows_per_s=serial["loads_per_step"] / read_s,
        loopback_mb_per_step=serial["loads_per_step"] * row_bytes / 1e6,
        loopback_mb_per_s=serial["loads_per_step"] * row_bytes / 1e6 / read_s,
        server_stats_ram_ssd=stats, flush_then_read_equals_card=bool(same),
        ids_checked=TB_CHECK_IDS, kernels=kern,
        reduced=(f"RAM cap {TB_RAM_MB} MB per table per server, not 10 GB, "
                 f"so that the spill runs within {TB_WARMUP + TB_STEPS} "
                 f"steps; {TB_WARMUP + TB_STEPS} steps, not an epoch"))
    rec_log("ps-tb", json.dumps(out))
    if not same:
        fail("ps-tb: rows read back from the servers differ from the arena's")
    if ssd <= 0 or arena_gb < 13.0:
        fail(f"ps-tb: SSD rows {ssd}, arenas {arena_gb:.2f} GB")
    return out


def phase_ps_dyn(dev, dyn) -> dict:
    """Phase 26, ``[ps-dyn]``: ``[dyn-wd]``'s recipe (``WideDeepConfig()``
    dynamic, capacity 200,000, admission at 2, the same keys) with the
    distributed hash store on 2 table servers, 20 steps through
    ``RecModel.online_train`` with ``EvictionCallback`` every 5 steps
    (eviction after 8 idle steps) and an incremental export; a local
    ``NativeHashStore`` fed the same keys at the same points: equal
    admitted and evicted key sets at every eviction and at the end."""
    cfg = WideDeepConfig(dynamic_embedding=True, sparse=True)
    model = WideDeepModel(cfg)
    opts = (optim.ftrl(loss_scale=cfg.loss_scale),
            optim.lazy_adam(loss_scale=cfg.loss_scale))
    rm = RecModel(model, *opts, jit=True, device=dev)
    rng = np.random.default_rng(21)
    raw = [{"ids": hashed_keys(rng), "wts": np.ones((BATCH, FIELDS), np.float32),
            "label": rng.integers(0, 2, (BATCH, 1)).astype(np.float32)}
           for _ in range(PS_DYN_STEPS)]
    local = HashStore(cfg.vocab_size, permit_threshold=2,
                      evict_threshold=PS_DYN_EVICT)
    root = Path(tempfile.mkdtemp(prefix="mrec_ps_dyn_"))
    evictions, lookup_ms = [], []
    try:
        with table_servers(PS_SERVERS, root) as addrs:
            adapter = DynamicEmbeddingAdapter(
                cfg.vocab_size, permit_filter_value=2,
                evict_filter_value=PS_DYN_EVICT, seed=0, remote_addrs=addrs)
            store = adapter.store
            store_evict = store.evict

            def keys_of(s):
                return set(s.items()[0].tolist())

            def checked_evict():
                kr, kl = keys_of(store), keys_of(local)
                freed = store_evict()
                local.evict()
                ar, al = keys_of(store), keys_of(local)
                if kr != kl or ar != al or kr - ar != kl - al:
                    fail("ps-dyn: admitted or evicted keys differ from the "
                         "local store's")
                evictions.append(len(kr - ar))
                return freed

            store.evict = checked_evict

            def stream():
                for b in raw:
                    local.lookup_or_insert(b["ids"].reshape(-1))
                    t = time.perf_counter()
                    out = adapter.transform_batch(b)
                    lookup_ms.append((time.perf_counter() - t) * 1e3)
                    yield out

            ev = EvictionCallback(adapter, model.table_specs,
                                  every_steps=PS_DYN_EVERY,
                                  export_path=root / "incremental.npz")
            torch.cuda.synchronize()
            kernels.reset_launches()
            rm.train_step.reset_counts()
            t0 = time.perf_counter()
            rm.online_train(stream(), callbacks=[ev], dataset_sink_mode=False)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = real_launches(rm.train_step)
            admitted = keys_of(store)
            same_end = admitted == keys_of(local)
            exported = int(np.load(root / "incremental.npz")["__keys__"].size)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = dict(
        steps=PS_DYN_STEPS, samples_per_s=PS_DYN_STEPS * BATCH / dt,
        ms_per_step=dt / PS_DYN_STEPS * 1e3,
        dyn_wd_ms_per_step=dyn["ms_per_step"],
        remote_lookup_ms=float(np.mean(lookup_ms)), admitted_keys=len(admitted),
        evicted_keys_per_call=evictions, exported_keys=exported,
        same_keys_as_local_store=bool(same_end), captures=rm.train_step.captures,
        launches={k: launches[k] for k in WD_PER_STEP},
        cut=f"evict after {PS_DYN_EVICT} idle steps every {PS_DYN_EVERY} "
            f"steps ([dyn-wd]: 20 and 10), so that {PS_DYN_STEPS} steps evict")
    rec_log("ps-dyn", json.dumps(out))
    if not same_end or not sum(evictions):
        fail(f"ps-dyn: final keys equal {same_end}, evictions {evictions}")
    if rm.train_step.captures != 1:
        fail(f"ps-dyn: {rm.train_step.captures} captures (expected 1)")
    for k, per in WD_PER_STEP.items():
        if launches[k] < per * PS_DYN_STEPS:
            fail(f"ps-dyn: kernel {k} launched {launches[k]} times")
    return out


def phase_ps(dev, host_cache, dyn) -> dict:
    """Phases 23-26: ``[ps-cache]``, ``[ps-host]``, ``[ps-tb]``,
    ``[ps-dyn]`` (PS mode)."""
    t0 = time.perf_counter()
    path = remote.server_binary_path()
    log(f"[ps-build] {path} in {time.perf_counter() - t0:.1f} s (g++)")
    out = {"cache": phase_ps_cache(dev, host_cache)}
    data, bucket, _host0 = wd_setup()
    out["host"] = phase_ps_host(dev, data, bucket)
    torch.cuda.empty_cache()
    out["tb"] = phase_ps_tb(dev)
    torch.cuda.empty_cache()
    out["dyn"] = phase_ps_dyn(dev, dyn)
    torch.cuda.empty_cache()
    log(f"[ps-time] phases 23-26 in {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phases 27-29: the generic sparse path and the drivers
# ---------------------------------------------------------------------------

GENERIC_STEPS = 3
DYN_GENERIC_STEPS = 5
YAML_WIDTH = ["--batch_size", "16000", "--vocab_size", "200000",
              "--emb_dim", "80", "--deep_layer_dim", "[1024, 512, 256, 128]"]


def adam_drift_bound(opt, steps) -> float:
    """Most two LazyAdam runs from one weight can differ after ``steps``
    steps, whatever their gradients: at step t, v_t >= (1-b2) b2^(t-k)
    g_k^2 for every k, so |m_t| / sqrt(v_t) <= t (1-b1) / sqrt((1-b2)
    b2^t), and each run moves a weight by at most lr_t times that per
    step (x 1.01 for bf16 moments, rounded to 2**-8).  Two runs whose
    per-id gradient sums differ only by rounding agree far closer where a
    sum is not itself at rounding level; where it is, the sign of Adam's
    step may flip, which this bound covers."""
    h = opt.hyper
    b1, b2, lr = h["b1"], h["b2"], h["learning_rate"]
    total = 0.0
    for t in range(1, steps + 1):
        lr_t = lr * (1 - b2**t) ** 0.5 / (1 - b1**t)
        total += lr_t * t * (1 - b1) / ((1 - b2) * b2**t) ** 0.5
    return 2.0 * total * 1.01


def ftrl_drift_bound(opt, steps, w0_max) -> float:
    """Most two FTRL runs from one weight can differ after ``steps``
    steps: with linear 0 and accumulator n0 at the start, the first step
    gives w1 = ((sqrt(n1) - sqrt(n0)) w0 - lr g) / sqrt(n1), within
    |w0| + lr of w0, and each later step moves w by lr g_t / sqrt(n_t)
    <= lr (n_t >= g_t^2), or sets it to 0 (|linear| <= l1) from at most
    |w0| + t lr; l2 only shrinks |w|."""
    lr = opt.hyper["learning_rate"]
    return 2.0 * (w0_max + steps * lr) * 1.0001


def touched_rows(model, state, before) -> dict:
    """Per table: the logical rows whose weights changed against
    ``before`` (bool [padded_vocab])."""
    out = {}
    for name, (path, spec) in model.table_specs.items():
        a = from_storage(spec, state.params[path[0]][path[1]]).float()
        b = from_storage(spec, before[name]).float()
        out[name] = (a != b).any(dim=1)
    return out


def table_errs(model, sa, sb, rows) -> dict:
    """Per table: max |a - b| over the given logical rows, and how many
    elements differ by more than 1e-6."""
    out = {}
    for name, (path, spec) in model.table_specs.items():
        a = from_storage(spec, sa.params[path[0]][path[1]]).float()[rows[name]]
        b = from_storage(spec, sb.params[path[0]][path[1]]).float()[rows[name]]
        d = (a - b).abs()
        out[name] = dict(max_abs_err=float(d.max()) if d.numel() else 0.0,
                         above_1e6=int((d > 1e-6).sum()), elements=d.numel())
    return out


def turns_ms(tag, dev, model, opts, batches, kinds, warmup=2, steps=5) -> dict:
    """ms/step of each (name, step_kw) of ``kinds``, captured, in turns
    (a, b, b, a), each from a fresh state, host clock between fences."""
    ms = {name: [] for name, _kw in kinds}
    order = [kinds[0], kinds[1], kinds[1], kinds[0]]
    for name, kw in order:
        state = init_train_state(model, 0, *opts, device=dev)
        step = make_train_step(model, *opts, jit=True, **kw)
        for i in range(warmup):
            state, _l = step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            state, (_lw, ld) = step(state, batches[(warmup + i) % len(batches)])
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) / steps * 1e3)
        if not bool(torch.isfinite(ld)):
            fail(f"{tag}: {name} loss {float(ld)}")
        del state, step
        torch.cuda.empty_cache()
    log(f"[{tag}-turns] captured ms/step in turns ({SMI}): " + ", ".join(
        f"{name} {v:.3f}" for name, _kw in order for v in [ms[name].pop(0)]))
    return ms


def phase_generic_wd(dev) -> dict:
    """Phase 27, ``[generic-wd]``: the W&D bench recipe on the generic
    path (``use_pallas=False``), captured, beside the streamed step from
    one state for 3 steps on raw batches (both sort on the card).  The
    streamed step runs with ``matmul_dtype=float32`` here, so both feed
    the model the same float32 rows: the first losses are equal, later
    ones differ by the update's rounding (rtol 1e-4), and the touched
    rows stay within the optimizers' drift bounds (``adam_drift_bound``,
    ``ftrl_drift_bound``).  Then ms/step of the generic and the streamed
    step at the recipe (bf16 rows) in turns, the counters set to 0
    around the generic steps (it launches no kernel), and DeepFM's
    ``row_layout=False`` on row_packed tables: the reference's warning
    and fallback to the generic path."""
    model, opts = wd_recipe()
    data = SyntheticCriteo(BATCH, FIELDS, VOCAB, steps=GENERIC_STEPS + 4,
                           seed=27, fields="criteo")
    batches = [to_device(data.get_batch(s), dev) for s in range(len(data))]
    sg = init_train_state(model, 0, *opts, device=dev)
    ss = init_train_state(model, 0, *opts, device=dev)
    before = {name: sg.params[p[0]][p[1]].clone()
              for name, (p, _s) in model.table_specs.items()}
    gen = make_train_step(model, *opts, use_pallas=False, jit=True)
    streamed = make_train_step(model, *opts, jit=True,
                               matmul_dtype=torch.float32)
    kernels.reset_launches()
    gen.reset_counts()
    lg = []
    for b in batches[:GENERIC_STEPS]:
        sg, (_w, ld) = gen(sg, b)
        lg.append(float(ld))
    torch.cuda.synchronize()
    launches = real_launches(gen)
    ls = []
    for b in batches[:GENERIC_STEPS]:
        ss, (_w, ld) = streamed(ss, b)
        ls.append(float(ld))
    rows = touched_rows(model, sg, before)
    rows_s = touched_rows(model, ss, before)
    errs = table_errs(model, sg, ss, {n: rows[n] | rows_s[n] for n in rows})
    w0 = float(from_storage(model.wide_spec, before["wide"]).abs().max())
    bounds = {"deep": adam_drift_bound(opts[1], GENERIC_STEPS),
              "wide": ftrl_drift_bound(opts[0], GENERIC_STEPS, w0)}
    out = dict(losses_generic=lg, losses_streamed_f32=ls, table_errs=errs,
               bounds=bounds, touched_rows={n: int(r.sum()) for n, r in rows.items()},
               same_touched={n: bool(torch.equal(rows[n], rows_s[n]))
                             for n in rows},
               generic_launches={k: v for k, v in launches.items() if v})
    log("[generic-wd]", json.dumps(out))
    if not (np.isfinite(lg).all() and lg[0] == ls[0]):
        fail(f"generic-wd: first losses differ or not finite: {lg} {ls}")
    if not np.allclose(lg, ls, rtol=1e-4, atol=0):
        fail(f"generic-wd: losses {lg} against the streamed step's {ls}")
    for name, e in errs.items():
        if e["max_abs_err"] > bounds[name]:
            fail(f"generic-wd: {name} touched rows differ by "
                 f"{e['max_abs_err']} > {bounds[name]}")
    if any(launches.values()):
        fail(f"generic-wd: the generic path launched kernels {launches}")
    del sg, ss, gen, streamed
    torch.cuda.empty_cache()
    out["ms"] = turns_ms("generic-wd", dev, model, opts, batches,
                         [("generic", {"use_pallas": False}),
                          ("streamed", {})])

    fm_model, fm_opts = deepfm_recipe("auto")
    import warnings as _w

    with _w.catch_warnings(record=True) as caught:
        _w.simplefilter("always")
        fm_step = make_train_step(fm_model, *fm_opts, row_layout=False,
                                  jit=True)
    warned = any("falling back to the generic path" in str(c.message)
                 for c in caught)
    state = init_train_state(fm_model, 0, *fm_opts, device=dev)
    fm_batches = [to_device(SyntheticCriteo(BATCH, FIELDS, FM_VOCAB, seed=28,
                                            fields="criteo").get_batch(i), dev)
                  for i in range(4)]
    fm = timed_steps("generic-deepfm-row_layout=False", fm_step, state,
                     fm_batches, BATCH, {}, warmup=1, steps=3)
    fm["warned"] = warned
    out["deepfm_fallback"] = fm
    if not warned or fm_step.step.__name__ != "step_generic":
        fail("generic-wd: DeepFM row_layout=False on row_packed tables did "
             "not warn and fall back to the generic path")
    del state, fm_step
    torch.cuda.empty_cache()
    return out


def phase_generic_dyn(dev) -> dict:
    """Phase 28, ``[generic-dyn]``: the yaml recipe (batch 16000, vocab
    200,000, emb 80, 1024-512-256-128) with ``dynamic_embedding=True,
    sparse=False``: plain row-major specs, which the sparse step trains
    on the generic path (the reference trains NaN here: section 3,
    reference fault 9), 5 captured steps through the hash adapter,
    against the oracle: the same model on feature-major tables
    (``sparse=True``), the same generic path, its tables carried over by
    the layout helpers.  Both take the same float32 rows: the first
    losses are equal, the later ones within rtol 1e-4 (the updates' per-id
    sums in another order), the touched rows within the drift bounds."""
    cfg = WideDeepConfig(dynamic_embedding=True)
    plain = WideDeepModel(cfg)
    fm = WideDeepModel(dataclasses.replace(cfg, sparse=True,
                                           table_layout="feature_major"))
    opts = (optim.ftrl(loss_scale=cfg.loss_scale),
            optim.lazy_adam(loss_scale=cfg.loss_scale))
    sp = init_train_state(plain, 0, *opts, device=dev)
    so = init_train_state(fm, 0, *opts, device=dev)
    for name, (path, spec) in plain.table_specs.items():
        key, fspec = "/".join(path), fm.table_specs[name][1]
        conv = lambda x: to_storage(fspec, from_storage(spec, x))  # noqa: E731
        so.params[path[0]][path[1]].copy_(conv(sp.params[path[0]][path[1]]))
        st_p = sp.opt_w if key in sp.opt_w else sp.opt_d
        st_o = so.opt_w if key in so.opt_w else so.opt_d
        for k, v in st_p[key].items():
            if v.dim() == 2:
                st_o[key][k].copy_(conv(v))
    tables = {"/".join(p) for p, _s in plain.table_specs.values()}
    for (k, a), (_k, b) in zip(flatten_params(sp.params),
                               flatten_params(so.params)):
        if k not in tables:
            b.copy_(a)  # the dense parameters: one start for both
    before = {name: sp.params[p[0]][p[1]].clone()
              for name, (p, _s) in plain.table_specs.items()}
    step_p = make_train_step(plain, *opts, jit=True)
    step_o = make_train_step(fm, *opts, use_pallas=False, jit=True)
    if step_p.step.__name__ != "step_generic":
        fail(f"generic-dyn: plain specs took {step_p.step.__name__}")
    ad_p, ad_o = (DynamicEmbeddingAdapter(cfg.vocab_size, seed=0)
                  for _ in range(2))
    rng = np.random.default_rng(28)
    raw = [{"ids": hashed_keys(rng), "wts": np.ones((BATCH, FIELDS), np.float32),
            "label": rng.integers(0, 2, (BATCH, 1)).astype(np.float32)}
           for _ in range(DYN_GENERIC_STEPS)]
    lp, lo, ms_p, ms_o = [], [], [], []
    kernels.reset_launches()
    step_p.reset_counts()
    for b in raw:
        bp = to_device(ad_p.transform_batch(b), dev)
        bo = to_device(ad_o.transform_batch(b), dev)
        for step, st, bb, losses, ms in ((step_p, "p", bp, lp, ms_p),
                                         (step_o, "o", bo, lo, ms_o)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if st == "p":
                sp, (_w, ld) = step(sp, bb)
            else:
                so, (_w, ld) = step(so, bb)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(ld))
    launches = real_launches(step_p)
    rows = touched_rows(plain, sp, before)
    errs = {}
    for name, (path, spec) in plain.table_specs.items():
        a = from_storage(spec, sp.params[path[0]][path[1]]).float()[rows[name]]
        b = from_storage(fm.table_specs[name][1],
                         so.params[path[0]][path[1]]).float()[rows[name]]
        d = (a - b).abs()
        errs[name] = dict(max_abs_err=float(d.max()) if d.numel() else 0.0,
                          above_1e6=int((d > 1e-6).sum()), elements=d.numel())
    w0 = float(from_storage(plain.wide_spec, before["wide"]).abs().max())
    bounds = {"deep": adam_drift_bound(opts[1], DYN_GENERIC_STEPS),
              "wide": ftrl_drift_bound(opts[0], DYN_GENERIC_STEPS, w0)}
    out = dict(losses_plain=lp, losses_feature_major=lo, table_errs=errs,
               bounds=bounds, touched_rows={n: int(r.sum()) for n, r in rows.items()},
               ms_plain=ms_p, ms_feature_major=ms_o, smi=SMI,
               launches={k: v for k, v in launches.items() if v})
    log("[generic-dyn]", json.dumps(out))
    if not (np.isfinite(lp).all() and lp[0] == lo[0]):
        fail(f"generic-dyn: losses {lp} against the oracle's {lo}")
    if not np.allclose(lp, lo, rtol=1e-4, atol=0):
        fail(f"generic-dyn: losses {lp} against the oracle's {lo}")
    if min(int(r.sum()) for r in rows.values()) == 0:
        fail("generic-dyn: no table row changed (reference fault 9)")
    for name, e in errs.items():
        if e["max_abs_err"] > bounds[name]:
            fail(f"generic-dyn: {name} rows differ by {e['max_abs_err']} > "
                 f"{bounds[name]}")
    del sp, so, step_p, step_o
    torch.cuda.empty_cache()
    return out


# train_criteo in a subprocess that prints its kernels' real launches:
# every CapturedStep made is kept, and its recorded launches (counted at
# capture) are taken out and its replays' added, as real_launches does
DRIVER_LAUNCHES = (
    "import json, sys\n"
    "from mindrec_tpu_torch.examples import train_criteo\n"
    "from mindrec_tpu_torch.ops import kernels\n"
    "from mindrec_tpu_torch.train import step\n"
    "made, init = [], step.CapturedStep.__init__\n"
    "def keep(self, *a, **k):\n"
    "    init(self, *a, **k)\n"
    "    made.append(self)\n"
    "step.CapturedStep.__init__ = keep\n"
    "kernels.reset_launches()\n"
    "train_criteo.main(sys.argv[1:])\n"
    "real = dict(kernels.LAUNCHES)\n"
    "for c in made:\n"
    "    for k in real:\n"
    "        real[k] += c.replayed.get(k, 0) - c.recorded.get(k, 0)\n"
    "print('[launches] ' + json.dumps(real), flush=True)\n"
)


def run_driver(tag, cmd, cwd, env, timeout=300) -> dict:
    """Run one driver as a subprocess on the card; -> its exit code, wall
    time, the last loss and the AUC it printed, and its output's tail."""
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=timeout)
    wall = time.perf_counter() - t0
    out = r.stdout + r.stderr
    loss = auc = launches = None
    for line in out.splitlines():
        m = re.search(r'(?:deep_loss is|loss_d=|"loss": )\s*([-+0-9.eE]+)', line)
        if m:
            loss = float(m.group(1))
        if "'auc': " in line:
            auc = float(line.split("'auc': ")[1].split(",")[0].split("}")[0])
        if '"auc": ' in line:
            auc = float(line.split('"auc": ')[1].split(",")[0].split("}")[0])
        if line.startswith("[launches] "):
            launches = json.loads(line[len("[launches] "):])
    res = dict(rc=r.returncode, wall_s=wall, last_loss_printed=loss, auc=auc,
               launches=launches)
    log(f"[drivers] {tag} rc {r.returncode} wall {wall:.1f} s loss {loss} "
        f"auc {auc} ({SMI})")
    for line in out.splitlines():
        if line.startswith(("dumped IR", "final metrics", "EvalCallBack",
                            "[mindrec]", "dynamic-embedding regime",
                            "online stream", "flushed")):
            log(f"[drivers] {tag}: {line[:300]}")
    if r.returncode != 0:
        log(out[-3000:])
        fail(f"drivers: {tag} exited {r.returncode}")
    return res


def phase_drivers(dev) -> dict:
    """Phase 29, ``[drivers]``: each driver of ``mindrec_tpu_torch/examples``
    as a subprocess on the card, at the yaml's width for the Criteo
    drivers (batch 16000, vocab 200,000, emb 80, 1024-512-256-128), 10
    steps (the drivers print the loss every 10) and 10 eval batches:
    the standalone launcher (dense), ``train_criteo --sparse 1`` (kernels
    1-3; its real launches counted in the subprocess, with checkpoints),
    the dynamic-embedding launcher (plain specs, the generic path) with
    ``--save_graphs`` (the CUDA graph as DOT), ``eval_criteo`` on the
    sparse run's checkpoint,
    ``train_outbrain --synthetic``, ``train_terabyte`` at its small
    default, ``online_train`` with its in-process producer and a short
    ``accuracy_run``.  Each must exit 0; its loss, AUC and wall time are
    printed."""
    root = Path(tempfile.mkdtemp(prefix="mrec_drivers_"))
    env = {k: v for k, v in os.environ.items() if not k.startswith("MR_")}
    repo = str(Path(__file__).resolve().parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["PYTHON"] = sys.executable
    py = [sys.executable, "-m"]
    ex = Path(repo) / "mindrec_tpu_torch" / "examples"
    short = ["--epochs", "1", "--steps_per_epoch", "10"]
    out = {}
    try:
        out["standalone"] = run_driver(
            "run_standalone_train.sh", ["bash", str(ex / "run_standalone_train.sh"),
                                        *YAML_WIDTH, *short], root, env)
        out["sparse"] = run_driver(
            "train_criteo --sparse 1",
            [sys.executable, "-c", DRIVER_LAUNCHES, "--sparse", "1",
             *YAML_WIDTH, *short, "--ckpt_interval", "10"], root, env)
        for k, per in WD_PER_STEP.items():
            if (out["sparse"]["launches"] or {}).get(k, 0) < per * 10:
                fail(f"drivers: train_criteo --sparse 1 launched {k} "
                     f"{(out['sparse']['launches'] or {}).get(k)} times")
        out["dynamic"] = run_driver(
            "run_dynamic_embedding_train.sh --save_graphs",
            ["bash", str(ex / "run_dynamic_embedding_train.sh"), *YAML_WIDTH,
             *short, "--save_graphs"], root, env)
        dot = root / "graphs" / "train_step.cuda_graph.dot"
        out["dynamic"]["cuda_graph_dot_bytes"] = (dot.stat().st_size
                                                  if dot.exists() else 0)
        if not out["dynamic"]["cuda_graph_dot_bytes"]:
            fail("drivers: --save_graphs wrote no CUDA graph")
        out["eval"] = run_driver(
            "eval_criteo", [*py, "mindrec_tpu_torch.examples.eval_criteo",
                            "--ckpt", "ckpt", "--sparse", "1", *YAML_WIDTH,
                            *short], root, env)
        if out["eval"]["auc"] != out["sparse"]["auc"]:
            fail(f"drivers: eval_criteo AUC {out['eval']['auc']} differs from "
                 f"the training run's final {out['sparse']['auc']}")
        out["outbrain"] = run_driver(
            "train_outbrain --synthetic",
            [*py, "mindrec_tpu_torch.examples.train_outbrain", "--synthetic",
             "--steps_per_epoch", "10"], root, env)
        out["terabyte"] = run_driver(
            "train_terabyte", [*py, "mindrec_tpu_torch.examples.train_terabyte"],
            root, env)
        out["online"] = run_driver(
            "online_train", [*py, "mindrec_tpu_torch.examples.online_train",
                             "--batch-size", "16000", "--emb-dim", "80",
                             "--steps", "10"], root, env)
        out["accuracy"] = run_driver(
            "accuracy_run", [*py, "mindrec_tpu_torch.examples.accuracy_run",
                             "--train-batches", "4", "--eval-batches", "2",
                             "--epochs", "2", "--eval-every", "1"], root, env)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec_log("drivers-summary", json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 30: ranks of a (data, model) mesh sharing the card over gloo
# ---------------------------------------------------------------------------

SHARD_STEPS = 3
SHARD_JOBS = "mindrec_tpu_torch.parallel.jobs:train_on_mesh"
# what each path must launch on every rank at every step
SHARD_KERNELS = {
    "sharded-wd": ("segsum_sorted", "ftrl_rows", "adam_cols", "gather_rows"),
    "dp-wd": ("segsum_sorted", "adam_rows", "ftrl_rows"),
    "sharded-col": ("segsum_sorted", "ftrl_rows", "adam_cols", "gather_rows"),
}


def shard_spec(mode, data, model, bucket, root, tag) -> dict:
    """The W&D bench recipe (``wd_recipe``) as a ``parallel/jobs.py``
    spec: the deep table sliced per ``mode`` over a ``data x model``
    mesh, eager steps at the recipe's bucket on SyntheticCriteo batches
    0-2 (the ranks make them from the seed), the sliced checkpoint under
    ``root``."""
    cfg = dict(batch_size=BATCH, field_size=FIELDS, vocab_size=VOCAB,
               emb_dim=EMB, deep_layer_dim=[1024] * 7,
               use_mixed_precision=True, sparse=True, loss_scale=1024.0,
               deep_table_slice_mode=mode)
    return {"data": data, "model": model, "device": "cuda",
            "net": {"name": "wide_deep", "config": cfg},
            "opt_w": {"kind": "ftrl", "loss_scale": 1024.0},
            "opt_d": {"kind": "lazy_adam", "loss_scale": 1024.0,
                      "state_dtype": "bfloat16"},
            "seed": 0, "step": {"unique_bucket": bucket},
            "batches": {"synthetic": {"vocab": VOCAB, "fields": FIELDS,
                                      "batch": BATCH, "steps": SHARD_STEPS,
                                      "kind": "criteo", "seed": 0}},
            "out": str(root / tag)}


def shard_turns(spec, first: int, later=(True, True, False)) -> list:
    """``spec``'s eager run (index ``first`` of the spawn's runs), then
    one run per entry of ``later`` (captured if True) from a fresh copy
    of the rank's block, each held on the rank to the first run's final
    state (``equal_to``): by default eager, captured, captured, eager."""
    return [spec] + [{**spec, "step": {**spec["step"], "jit": jit},
                      "out": None, "unsliced": None, "equal_to": first}
                     for jit in later]


def yaml_mesh_spec(kind) -> dict:
    """The yaml's width (batch 16000 x 39, vocab 200,000, emb 80,
    1024-512-256-128, bf16) on 2 ranks: ``dense`` the dense step over the
    deep table row-sliced on a 1 x 2 mesh, ``generic`` the generic sparse
    path (``use_pallas=False``) data-parallel on 2 x 1."""
    dense = kind == "dense"
    cfg = dict(batch_size=BATCH, field_size=FIELDS, vocab_size=200_000,
               emb_dim=80, deep_layer_dim=[1024, 512, 256, 128],
               use_mixed_precision=True, sparse=not dense, loss_scale=1024.0,
               deep_table_slice_mode="table_row_slice" if dense else "none")
    return {"data": 1 if dense else 2, "model": 2 if dense else 1,
            "device": "cuda", "net": {"name": "wide_deep", "config": cfg},
            "opt_w": {"kind": "ftrl", "loss_scale": 1024.0},
            "opt_d": {"kind": "lazy_adam", "loss_scale": 1024.0},
            "seed": 0, "step": {} if dense else {"use_pallas": False},
            "batches": {"synthetic": {"vocab": 200_000, "fields": FIELDS,
                                      "batch": BATCH, "steps": SHARD_STEPS,
                                      "kind": "criteo", "seed": 0}}}


def shard_captured(tag, turns, kernels_=()) -> dict:
    """``turns[r]``: rank r's records of :func:`shard_turns`.  Every later
    turn equals the first bit for bit on its rank (final state leaf by
    leaf, losses), makes the same collectives and launches the same
    kernels at every step; a captured turn captures once and replays
    every later step; ``kernels_`` launch on every rank at every step.
    -> graphs per capture, ms of each step per rank by turn (steps 2 on,
    the first replay included; eager and captured in turns) and the
    first captured turn's launches."""
    ms, segments, launches = {}, {}, {}
    for r, recs in enumerate(turns):
        first = recs[0]
        for i, rec in enumerate(recs):
            if i and rec["differs"]:
                fail(f"[{tag}-captured] rank {r} turn {i}: leaves differ "
                     f"from the eager run's: {rec['differs']}")
            for key in ("losses", "collectives", "launches"):
                if rec[key] != first[key]:
                    fail(f"[{tag}-captured] rank {r} turn {i}: {key} "
                         f"{rec[key]} differ from the eager run's {first[key]}")
            for j, la in enumerate(rec["launches"]):
                missing = [k for k in kernels_ if not la.get(k)]
                if missing:
                    fail(f"[{tag}-captured] rank {r} turn {i} step {j} "
                         f"launched no {missing}")
            captured = "segments" in rec
            if captured and (rec["captures"], rec["replays"]) != (
                    1, SHARD_STEPS - 1):
                fail(f"[{tag}-captured] rank {r} turn {i}: {rec['captures']} "
                     f"captures, {rec['replays']} replays")
            ms.setdefault(r, []).append(
                ("captured" if captured else "eager", rec["ms"][1:]))
        cap = next(rec for rec in recs if "segments" in rec)
        segments[r] = cap["segments"]
        for la in cap["launches"]:
            for k, n in la.items():
                launches[k] = launches.get(k, 0) + n
    out = dict(equal="bit for bit", ms_per_step_turns=ms,
               graphs_per_capture=segments, launches=launches)
    log(f"[{tag}-captured] {json.dumps(out)} ({SMI}; gloo host copies on one "
        f"card: no speed of multi-GPU training)")
    return out


def shard_reference(dev, spec) -> tuple:
    """The spec's model on one rank (no mesh: the sliced table whole, in
    the same layout), the same eager step on the same global batches;
    -> (state, losses, ms per step)."""
    model = jobs.build_net(spec["net"])
    ow, od = jobs.build_opt(spec["opt_w"]), jobs.build_opt(spec["opt_d"])
    state = init_train_state(model, spec["seed"], ow, od, device=dev)
    step = make_train_step(model, ow, od, **spec["step"])
    losses, ms = [], []
    for b in jobs.load_batches(spec["batches"]):
        b = to_device(b, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, (lw, ld) = step(state, b)
        losses.append((float(lw), float(ld)))
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, losses, ms


# The largest difference each part of the merged mesh state may show
# against the one-rank state after SHARD_STEPS steps, from the readings
# on the card (difference; largest value): the tables take the CPU
# tests' atol (deep 2.0e-7; 0.058, wide 0; 0.053); m and v about 3.5x
# theirs (2.9e-11; 1.0e-8 and 2.7e-20; 4.4e-18), 1-2% of their largest
# values; the bf16 MLP about twice its reading (4.6e-5; 0.051).
SHARD_DIFF_LIMITS = {"deep_table": 1e-6, "m": 1e-10, "v": 1e-19,
                     "wide_table": 1e-6, "mlp": 1e-4}


def shard_compare(tag, spec, recs, ref) -> dict:
    """Hold a mesh run (every rank's record) against its one-rank run:
    losses within rtol 1e-5 at every step (alike on every rank), the
    merged sliced checkpoint's tables, moments and MLP beside the
    one-rank state within ``SHARD_DIFF_LIMITS`` (largest differences and
    magnitudes printed), every collective of every step below a quarter
    of the deep table's bytes, and the path's kernels launched on every
    rank at every step."""
    state, losses, ref_ms = ref
    for r in recs:
        if r["losses"] != recs[0]["losses"]:
            fail(f"[{tag}] rank {r['rank']} losses {r['losses']} differ from "
                 f"rank 0's {recs[0]['losses']}")
    got = np.asarray(recs[0]["losses"])
    if not np.allclose(got, np.asarray(losses), rtol=1e-5, atol=0):
        fail(f"[{tag}] losses {got.tolist()} differ from the one-rank run's "
             f"{losses} beyond rtol 1e-5")
    model = jobs.build_net(spec["net"])
    deep = model.deep_spec
    table_bytes = int(np.prod(deep.storage_shape)) * 4
    colls = [max(b for *_, b in step) for r in recs for step in r["collectives"]]
    if max(colls) >= table_bytes / 4:
        fail(f"[{tag}] a collective moved {max(colls)} bytes, >= a quarter "
             f"of the deep table's {table_bytes}")
    for r in recs:
        for i, la in enumerate(r["launches"]):
            missing = [k for k in SHARD_KERNELS[tag] if not la.get(k)]
            if missing:
                fail(f"[{tag}] rank {r['rank']} step {i} launched no {missing}")
    merged = checkpoint.merge_sliced([r["path"] for r in recs], state)
    a, b = dict(checkpoint.flatten_state(merged)), dict(
        checkpoint.flatten_state(state))
    diff, size = {}, {}
    for name, keys in (("deep_table", [".params/deep/table"]),
                       ("m", [".opt_d/deep/table/m"]),
                       ("v", [".opt_d/deep/table/v"]),
                       ("wide_table", [".params/wide/table"]),
                       ("mlp", [k for k in b if k.startswith(".params/deep/mlp")])):
        diff[name] = max((a[k].float() - b[k].float()).abs().max().item()
                         for k in keys)
        size[name] = max(b[k].float().abs().max().item() for k in keys)
    del merged, a, b
    over = {k: (d, SHARD_DIFF_LIMITS[k]) for k, d in diff.items()
            if not d <= SHARD_DIFF_LIMITS[k]}
    if over:
        fail(f"[{tag}] the merged state differs from the one-rank state "
             f"beyond its limits (difference, limit): {over}")
    launches = {}
    for r in recs:
        for la in r["launches"]:
            for k, n in la.items():
                launches[k] = launches.get(k, 0) + n
    out = dict(
        mesh=[spec["data"], spec["model"]], losses=recs[0]["losses"],
        one_rank_losses=losses, max_abs_diff=diff,
        diff_limits=SHARD_DIFF_LIMITS, max_abs_value=size,
        ms_per_step_by_rank={r["rank"]: r["ms"] for r in recs},
        one_rank_ms_per_step=ref_ms,
        collective_bytes_per_step={
            r["rank"]: [[(op, ax, nb) for op, ax, nb in st]
                        for st in r["collectives"]] for r in recs[:1]},
        max_collective_bytes=max(colls), quarter_table_bytes=table_bytes / 4,
        launches_by_rank={r["rank"]: r["launches"] for r in recs},
        launches=launches)
    log(f"[{tag}] {json.dumps(out)} ({SMI}; gloo host copies on one card: "
        f"no speed of multi-GPU training)")
    return out


def shard_ckpt(recs, like) -> dict:
    """``[sharded-ckpt]``: the 4 ranks' sliced files restored onto one
    rank (``restore_checkpoint`` of every file) and merged
    (``merge_sliced``), each bit for bit equal to the whole state rank 0
    gathered and saved unsliced; and restored onto the blocks of a
    (1, 2) mesh, bit for bit the whole state's slices."""
    paths = [r["path"] for r in recs]
    t0 = time.perf_counter()
    whole = checkpoint.restore_checkpoint(recs[0]["unsliced"], like)
    want = dict(checkpoint.flatten_state(whole))
    out = {}
    for how, fn in (("restore_one_rank", checkpoint.restore_checkpoint),
                    ("merge_sliced", checkpoint.merge_sliced)):
        got = dict(checkpoint.flatten_state(fn(paths, like)))
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        if bad:
            fail(f"[sharded-ckpt] {how} differs from the unsliced state at {bad}")
        out[how] = "bit for bit"
        del got
    model = jobs.build_net(shard_spec("table_row_slice", 1, 2, 0, Path("."), "")["net"])
    for r in range(2):
        mesh = pmesh.Mesh(1, 2, rank=r)
        model.mesh = mesh
        pls = pmesh.state_placements(whole, model, mesh)
        got = checkpoint.restore_checkpoint(
            paths, pmesh.shard_train_state(whole, model, mesh), shardings=pls)
        blk = pls.params["deep"]["table"].index
        if not (torch.equal(got.params["deep"]["table"],
                            whole.params["deep"]["table"][blk])
                and torch.equal(got.opt_d["deep/table"]["m"],
                                whole.opt_d["deep/table"]["m"][blk])):
            fail(f"[sharded-ckpt] restore onto rank {r} of (1, 2) differs")
        del got
    out["restore_onto_1x2"] = "bit for bit"
    out["files_mb"] = sum(os.path.getsize(p) for p in paths) / 1e6
    out["s"] = time.perf_counter() - t0
    log(f"[sharded-ckpt] {json.dumps(out)} ({SMI})")
    return out


def shard_kernels(dev, gen, bucket, data) -> None:
    """Kernels 1, 3, 6 and 8 against their plain versions at a rank's
    shapes of ``[sharded-wd]`` / ``[sharded-col]`` on batch 0: the
    global unique columns clipped to model rank 1's block of the
    row-sliced deep table (-1 below, past ``Vc/2`` above; ``gather_rows``
    into lanes 1..16, ``adam_cols`` with bf16 m/v), ``gather_rows`` of
    the column-sliced block ``[8, Vc]`` at the run-time lane offset
    ``1 + 8`` of model rank 1, ``segsum_sorted`` of data rank 1's own
    sorted positions at their places in the global unique order
    (``sharded_stream.local_segments``, steps with gaps), and
    ``ftrl_rows`` of the replicated wide table at the global unique
    slots; each timed beside its bound."""
    b0 = data.get_batch(0)
    ids = torch.from_numpy(b0["ids"]).to(dev).reshape(-1)
    uq = torch.unique(ids).int()
    if uq.numel() > bucket:
        fail(f"[shard-kernels] {uq.numel()} distinct ids > bucket {bucket}")
    uq = torch.cat([uq, uq.new_full((bucket - uq.numel(),), SENTINEL)])
    spec = WideDeepModel(WideDeepConfig(
        vocab_size=VOCAB, emb_dim=EMB, sparse=True,
        deep_table_slice_mode="table_row_slice")).deep_spec
    dp, vc = spec.storage_shape
    cols = sharded_stream.owned_cols(uq, vc // 2, 1)
    res = {}
    res["gather_rows"] = check_gather_launch(
        dev, gen, "sharded-wd", dict(name="deep, model rank 1 of 2",
                                     shape=(dp, vc // 2), cols=cols, off=1,
                                     width=128, fold=1), per_10=10)
    res["gather_rows_col"] = check_gather_launch(
        dev, gen, "sharded-col", dict(name="deep sublanes 8..15",
                                      shape=(dp // 2, vc), cols=uq, off=1 + 8,
                                      width=128, fold=1), per_10=10)
    res["adam_cols"] = check_adam_cols(
        "sharded-wd deep, model rank 1 of 2", dev, gen, (dp, vc // 2), 1,
        cols, None, torch.bfloat16, eps=1e-8, loss_scale=1024.0)
    n_l = ids.numel() // 2  # data rank 1's positions
    uidx, perm = sharded_stream.local_segments(ids[n_l:], uq)
    res["segsum_sorted"] = check_sorted(
        dev, gen, ("sharded-wd data rank 1, global order", uidx, perm, n_l,
                   17, bucket), gaps=True)
    # the replicated wide table: rows of the global unique slots
    pack, n_rows = 128, 47104
    rows = torch.div(uq, pack, rounding_mode="floor")
    sub = torch.remainder(uq, pack)
    base = [0.01 * torch.randn((n_rows, 128), generator=gen, device=dev),
            1.0 + torch.rand((n_rows, 128), generator=gen, device=dev),
            0.1 * torch.randn((n_rows, 128), generator=gen, device=dev)]
    gs = 10.0 * torch.randn((bucket, 1), generator=gen, device=dev)
    a, b = [x.clone() for x in base], [x.clone() for x in base]
    hyper = dict(dim=1, pack=pack, loss_scale=1024.0)
    ftrl_rows(*a, rows, sub, gs, **hyper)
    ftrl_rows_plain(*b, rows, sub, gs, **hyper)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
    valid = int((rows < n_rows).sum())
    t_b, by = bound(bucket * 8 + valid * (4 + 2 * 12), valid * 16)
    res["ftrl_rows"] = dict(max_abs_err=max_errs(zip(a, b))[0],
                            ms=graph_ms(lambda: ftrl_rows(*a, rows, sub, gs, **hyper)),
                            bound_ms=t_b, bound_by=by)
    log("[shard-kernels]", json.dumps(res), f"({SMI})")


def phase_sharded(dev, gen, data, bucket) -> dict:
    """Phase 30: training on a (data, model) mesh of ranks that share the
    card over gloo (``parallel/jobs.py`` spawned by ``parallel/launch.py``;
    each rank a process with a hard time limit, a rank's failure fails
    the phase), each mesh run held against the one-rank run of the same
    global batches: ``[sharded-wd]`` (4 ranks, 2 x 2, the deep table
    row-sliced, then ``[sharded-ckpt]`` on its sliced checkpoint),
    ``[dp-wd]`` (2 x 1, row_packed tables) and ``[sharded-col]`` (1 x 2,
    column slice) in one spawn of 2 ranks, ``[sharded-driver]``
    (``run_distribute_train.sh 2`` at the yaml's width with
    ``--mesh_model 2``), and the kernels at the ranks' shapes."""
    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="mrec_sharded_"))
    out = {}
    try:
        specs = {"sharded-wd": shard_spec("table_row_slice", 2, 2, bucket,
                                          root, "wd"),
                 "dp-wd": shard_spec("none", 2, 1, bucket, root, "dp"),
                 "sharded-col": shard_spec("table_column_slice", 1, 2, bucket,
                                           root, "col")}
        specs["sharded-wd"]["unsliced"] = str(root / "whole")
        refs = {}
        for tag, spec in specs.items():
            refs[tag] = shard_reference(dev, spec)
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        res4, _ = launch.run_job(
            SHARD_JOBS, {"runs": shard_turns(specs["sharded-wd"], 0)}, 4,
            timeout=240)
        t2 = time.perf_counter()
        # dp-wd and sharded-col in turns, then the yaml-width dense and
        # generic steps, eager then captured
        runs2, span = [], {}
        for tag in ("dp-wd", "sharded-col", "mesh-dense", "mesh-generic"):
            if tag in specs:
                turns = shard_turns(specs[tag], len(runs2))
            else:
                turns = shard_turns(yaml_mesh_spec(tag.split("-")[1]),
                                    len(runs2), (True,))
            span[tag] = slice(len(runs2), len(runs2) + len(turns))
            runs2 += turns
        res2, _ = launch.run_job(SHARD_JOBS, {"runs": runs2}, 2, timeout=240)
        t3 = time.perf_counter()
        log(f"[time] spawns: 4 ranks {t2 - t1:.1f} s, 2 ranks {t3 - t2:.1f} s")
        out["sharded-wd"] = shard_compare(
            "sharded-wd", specs["sharded-wd"], [r[0] for r in res4],
            refs["sharded-wd"])
        out["sharded-wd"]["captured"] = shard_captured(
            "sharded-wd", res4, SHARD_KERNELS["sharded-wd"])
        out["sharded-ckpt"] = shard_ckpt([r[0] for r in res4],
                                         refs["sharded-wd"][0])
        for tag, sl in span.items():
            turns = [r[sl] for r in res2]
            if tag in specs:
                out[tag] = shard_compare(tag, specs[tag], [t[0] for t in turns],
                                         refs[tag])
                out[tag]["captured"] = shard_captured(tag, turns,
                                                      SHARD_KERNELS[tag])
            else:
                out[tag] = shard_captured(tag, turns)
        del refs
        torch.cuda.empty_cache()
        env = {k: v for k, v in os.environ.items() if not k.startswith("MR_")}
        repo = str(Path(__file__).resolve().parent)
        env.update(PYTHONPATH=repo + os.pathsep + env.get("PYTHONPATH", ""),
                   PYTHON=sys.executable,
                   MR_SCHED_PORT=str(launch.free_port()))
        ex = Path(repo) / "mindrec_tpu_torch" / "examples"
        drv = run_driver(
            "run_distribute_train.sh 2 --mesh_model 2",
            ["bash", str(ex / "run_distribute_train.sh"), "2", *YAML_WIDTH,
             "--sparse", "1", "--mesh_model", "2", "--deep_table_slice_mode",
             "table_row_slice", "--epochs", "1", "--steps_per_epoch", "3"],
            root, env, timeout=150)
        logs = [(root / "dp_logs" / f"worker_{i}.log").read_text()
                for i in range(2)]
        finals = [line for t in logs for line in t.splitlines()
                  if line.startswith("final metrics")]
        if len(finals) != 2 or finals[0] != finals[1]:
            fail(f"[sharded-driver] ranks' final metrics {finals}")
        drv["final"] = finals[0]
        caps = [line for t in logs for line in t.splitlines()
                if line.startswith("captured step: ")]
        if len(caps) != 2 or not all("1 captures, 2 replays" in c for c in caps):
            fail(f"[sharded-driver] ranks' captured steps {caps}")
        drv["captured"] = caps
        log(f"[sharded-driver] {json.dumps(drv)} ({SMI})")
        out["sharded-driver"] = drv
        shard_kernels(dev, gen, bucket, data)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[time] phase 30 {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 31: several workers (PS workers over shared table servers,
# distributed online training, the elastic wrapper); ranks share the card
# over gloo
# ---------------------------------------------------------------------------

WORKERS, WORKER_STEPS = 2, 5
PS_WORKER_JOB = "mindrec_tpu_torch.parallel.jobs:ps_worker"
# what each path must launch on every worker at every step: the cache
# regime's feature-major step (rows 1, 6, 7, 8), the row_packed data-
# parallel step of the online path (rows 1-3)
WORKER_KERNELS = {
    "ps-workers": ("segsum_sorted", "adam_cols", "ftrl_cols", "gather_rows"),
    "dist-online": ("segsum_sorted", "adam_rows", "ftrl_rows"),
}
# examples/dist_online_train.py's defaults: per-rank batch, fields, vocab,
# width, MLP (bfloat16).
ONLINE_BATCH, ONLINE_VOCAB, ONLINE_EMB = 1000, 200_000, 16
ONLINE_LAYERS, ONLINE_STEPS = (1024, 512, 256, 128), 6
# The float32 run's final parameters against one rank, every element:
# the CPU test's rtol, atol 1e-7 (its 1e-8 one deep-table element of 3.2M
# missed on the card, 3.0e-8 in 2 runs; the MLP 3.7e-9).
ONLINE_F32_TOL = (1e-5, 1e-7)
# The default run (bfloat16 MLP: each rank rounds its half of a weight
# gradient to bf16 before the sum) against one rank, by part: the largest
# difference, and the difference's norm over the norm of what training
# moved (final - initial).  Each limit is the geometric mean, to one
# digit, of the run's reading and a fault control's, one rank trained on
# rank 0's half twice at every step (the other rank's gradient lost),
# which must exceed a limit of every part.  Readings on the card (run;
# control): deep table 2.0e-6, 0.030; 2.5e-5, 0.92.  Wide 4.7e-9,
# 1.1e-9; 0.041, 0.49.  MLP 3.7e-4, 0.026; 2.4e-3, 1.47.
ONLINE_BF16_LIMITS = {"deep_table": (7e-6, 0.2), "wide": (1e-5, 2e-5),
                      "mlp": (9e-4, 0.2)}
ELASTIC_CRASH, ELASTIC_STEPS = 3, 6


def ps_workers_spec(dev, spill) -> dict:
    """The cache recipe (``benchmarks/bench_cached.py:33-75``: 100M ids
    behind 4.6M card rows, emb 16, 7x1024 bf16 MLP, zipf(1.3) ids,
    feature-major tables) with its global batch of 16,000 x 39 split over
    the workers, each drawing the quotients of the ids it owns
    (``parallel/jobs.py:owned_batches``); eager steps."""
    return {"vocab": CACHE_VIRTUAL, "cache_rows": CACHE_ROWS,
            "batch": BATCH // WORKERS, "fields": FIELDS, "emb": EMB,
            "layers": [1024] * 7, "steps": WORKER_STEPS, "workers": WORKERS,
            "loss_scale": 1024.0, "mixed": True, "layout": "feature_major",
            "traffic": "zipf", "zipf_a": 1.3, "seed": 100, "device": dev.type,
            "ram_bytes": CACHE_RAM, "spill_dir": spill}


def phase_ps_workers(dev, root) -> dict:
    """``[ps-workers]``: 2 table servers and 2 workers (``launch.run_job``
    of ``parallel/jobs.py:ps_worker``) in the cache regime; then each
    worker's batches again in this process on host tiers: the losses, the
    rows loaded and every touched row the servers hold (params and
    optimizer state) must be equal, bit for bit; the path's kernels must
    have launched on each worker at each step.  A third run of each
    worker's batches with the plain versions (``use_kernels=False``)
    holds rows 1, 6, 7 and 8 at these shapes, as ``phase_cache_kernels``
    does: losses within rtol 1e-5, every touched tier row within rtol
    1e-4 / atol 1e-6."""
    t0 = time.perf_counter()
    spec = ps_workers_spec(dev, None)
    out = {"launches": {}}
    with table_servers(PS_SERVERS, root) as addrs:
        recs, _ = launch.run_job(PS_WORKER_JOB, {**spec, "servers": addrs},
                                 WORKERS, timeout=240)
        t1 = time.perf_counter()
        for w, rec in enumerate(recs):
            for s, got in enumerate(rec["launches"]):
                miss = [k for k in WORKER_KERNELS["ps-workers"] if not got.get(k)]
                if miss:
                    fail(f"[ps-workers] worker {w} step {s + 1}: no launch of {miss}")
                for k, v in got.items():
                    out["launches"][k] = out["launches"].get(k, 0) + v
            spill = tempfile.mkdtemp(dir=root)
            oracle, touched, orec = jobs.build_and_train_ps(
                {**spec, "spill_dir": spill}, w)
            if rec["losses"] != orec["losses"] or rec["loaded"] != orec["loaded"]:
                fail(f"[ps-workers] worker {w}: losses {rec['losses']} / loads "
                     f"{rec['loaded']} against one process {orec['losses']} / "
                     f"{orec['loaded']}")
            rows = {}
            for name, tiers in oracle.tiers.items():
                for tname, tier in tiers.items():
                    rt = remote.RemoteTier(addrs, name if tname == "param"
                                           else f"{name}.{tname}", tier.dim,
                                           init_std=0.0)
                    got, want = rt.read(touched), tier.read(touched)
                    rt.close()
                    if not np.array_equal(got, want):
                        fail(f"[ps-workers] worker {w} {name}.{tname}: server "
                             f"rows differ from one process's (max "
                             f"{float(np.abs(got - want).max()):.3g})")
                    rows[name, tname] = want
            del oracle
            shutil.rmtree(spill, ignore_errors=True)
            spill = tempfile.mkdtemp(dir=root)
            plain, _touched, prec = jobs.build_and_train_ps(
                {**spec, "spill_dir": spill, "use_kernels": False}, w)
            if any(la.get(k) for la in prec["launches"]
                   for k in WORKER_KERNELS["ps-workers"]):
                fail(f"[ps-workers] worker {w}: the plain run launched "
                     f"{prec['launches']}")
            np.testing.assert_allclose(
                np.asarray(prec["losses"]), np.asarray(orec["losses"]),
                rtol=1e-5, atol=0, err_msg=f"[ps-workers] worker {w} losses, "
                "plain versions against the kernels")
            plain_diff = 0.0
            for (name, tname), want in rows.items():
                got = plain.tiers[name][tname].read(touched)
                np.testing.assert_allclose(
                    got, want, rtol=1e-4, atol=1e-6,
                    err_msg=f"[ps-workers] worker {w} {name}.{tname}, plain "
                    "versions against the kernels")
                plain_diff = max(plain_diff, float(np.abs(got - want).max()))
            del plain
            moved = [(a + b) * rec["row_bytes"] / 1e6
                     for a, b in zip(rec["loaded"], rec["evicted"])]
            line = {"worker": w, "ms_per_step": rec["ms"],
                    "prepare_ms": rec["prepare_ms"], "rows_loaded": rec["loaded"],
                    "rows_evicted": rec["evicted"], "mb_moved": moved,
                    "flush_ms": rec["flush_ms"], "touched_ids": rec["touched"],
                    "one_process_ms": orec["ms"], "launches": rec["launches"],
                    "losses_last": rec["losses"][-1], "server_rows": "equal",
                    "plain_losses_last": prec["losses"][-1],
                    "plain_tier_max_abs_diff": plain_diff}
            log(f"[ps-workers] ({SMI}) {json.dumps(line)}")
            out[f"worker{w}"] = line
            shutil.rmtree(spill, ignore_errors=True)
        t2 = time.perf_counter()
    log(f"[ps-workers] spawn {t1 - t0:.1f} s, one-process runs (kernels, "
        f"plain) {t2 - t1:.1f} s")
    return out


def online_stream(spool) -> list:
    """Each rank's batches at the script's width, sent into a
    ``FileChannel`` spool of one shard per rank; -> the global batches
    (rank slices in rank order)."""
    sender = streaming.FileChannel(spool, num_shards=WORKERS).sender()
    rng = np.random.default_rng(31)
    per_rank = [[] for _ in range(WORKERS)]
    for _ in range(ONLINE_STEPS):
        for r in range(WORKERS):
            b = {"ids": rng.integers(0, ONLINE_VOCAB, (ONLINE_BATCH, FIELDS)
                                     ).astype(np.int32),
                 "wts": rng.uniform(0.5, 1.5, (ONLINE_BATCH, FIELDS)
                                    ).astype(np.float32),
                 "label": rng.integers(0, 2, (ONLINE_BATCH, 1)
                                       ).astype(np.float32)}
            per_rank[r].append(b)
            sender.send(b, shard_id=r)
    sender.close()
    return [{k: np.concatenate([per_rank[r][i][k] for r in range(WORKERS)])
             for k in per_rank[0][i]} for i in range(ONLINE_STEPS)]


def online_params(state) -> dict:
    """A copy of the parameters (the steps update them in place)."""
    return {k: v.detach().float().cpu().numpy().copy()
            for k, v in flatten_params(state.params)}


def online_one_rank(dev, root, globals_, mixed: bool):
    """One rank's run of the global stream from a state it saves first,
    the MLP in bfloat16 (``mixed``) or float32.  -> (the saved state's
    path, the initial and the final parameters, ms per step, and with
    ``mixed`` the fault control's final parameters: the same state
    trained on rank 0's half twice at every step, as if the other rank's
    gradient were lost)."""
    cfg = WideDeepConfig(batch_size=ONLINE_BATCH * WORKERS, field_size=FIELDS,
                         vocab_size=ONLINE_VOCAB, emb_dim=ONLINE_EMB,
                         deep_layer_dim=ONLINE_LAYERS, sparse=True,
                         use_mixed_precision=mixed)
    rm = RecModel(WideDeepModel(cfg), optim.ftrl(loss_scale=cfg.loss_scale),
                  optim.lazy_adam(loss_scale=cfg.loss_scale), jit=False,
                  device=dev)
    init = checkpoint.save_checkpoint(root / f"init_{int(mixed)}", rm.state,
                                      step=0)
    first = online_params(rm.state)
    lost = replace_state(rm.state) if mixed else None
    ms = []
    for gb in globals_:
        torch.cuda.synchronize()
        t = time.perf_counter()
        rm.state, (_lw, ld) = rm.train_step(rm.state, rm._tensors(gb))
        float(ld)
        ms.append((time.perf_counter() - t) * 1e3)
        if lost is not None:
            half = {k: np.concatenate([v[:ONLINE_BATCH]] * WORKERS)
                    for k, v in gb.items()}
            lost, _ = rm.train_step(lost, rm._tensors(half))
    return (init, first, online_params(rm.state), ms,
            None if lost is None else online_params(lost))


def online_part(key: str) -> str:
    return ("mlp" if key.startswith("deep/mlp") else
            "deep_table" if key.startswith("deep/") else "wide")


def online_diff(got, want, first) -> dict:
    """By part: [largest difference of ``got`` from ``want``, the norm of
    that difference over the norm of ``want - first``]."""
    out, sq, moved = {}, {}, {}
    for k, w in want.items():
        p = online_part(k)
        d = got[k].astype(np.float64) - w
        out[p] = max(out.get(p, 0.0), float(np.abs(d).max()))
        sq[p] = sq.get(p, 0.0) + float((d * d).sum())
        m = w.astype(np.float64) - first[k]
        moved[p] = moved.get(p, 0.0) + float((m * m).sum())
    return {p: [out[p], (sq[p] / moved[p]) ** 0.5 if moved[p] else float("inf")]
            for p in out}


def online_rank_checks(tag, root, logs, ckpt_dir) -> dict:
    """Each rank drained the stream, launched rows 1-3 at every step and
    kept checkpoints at steps 3 and 6; -> the launches summed over ranks."""
    launches = {}
    for i, text in enumerate(logs):
        if f"({ONLINE_STEPS} steps)" not in text:
            fail(f"[dist-online] {tag} rank {i} did not drain {ONLINE_STEPS} steps")
        got = json.loads(text.split(f"rank {i}: kernel launches ")[1].splitlines()[0])
        miss = [k for k in WORKER_KERNELS["dist-online"]
                if got.get(k, 0) < ONLINE_STEPS]
        if miss:
            fail(f"[dist-online] {tag} rank {i} launched {got}: under one a "
                 f"step of {miss}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        ckpts = sorted(p.name for p in (root / ckpt_dir / f"rank_{i}").iterdir())
        if ckpts != [f"ckpt-{s:010d}-r{i}.npz" for s in (3, 6)]:
            fail(f"[dist-online] {tag} rank {i} checkpoints {ckpts}")
    return launches


def online_kernels(dev, globals_) -> dict:
    """Rows 1-3 at the online path's shapes against their plain versions:
    ``kernel_vs_plain`` at the script's width on 3 global batches (each
    rank's updates see the global unique ids) and on 3 rank halves (each
    rank's positions), and ``segsum_sorted`` of rank 1's own positions at
    their places in the global unique order (with gaps) as the data-
    parallel step sums them (``sharded_stream.local_segments``)."""
    opts = (optim.ftrl(loss_scale=1024.0), optim.lazy_adam(loss_scale=1024.0))
    for n, tag in ((ONLINE_BATCH * WORKERS, "global batch"),
                   (ONLINE_BATCH, "rank half")):
        model = WideDeepModel(WideDeepConfig(
            batch_size=n, field_size=FIELDS, vocab_size=ONLINE_VOCAB,
            emb_dim=ONLINE_EMB, deep_layer_dim=ONLINE_LAYERS, sparse=True,
            use_mixed_precision=True, loss_scale=1024.0))
        kernels.reset_launches()
        kernel_vs_plain(f"dist-online {tag}", dev, model, opts,
                        [to_device({k: v[:n] for k, v in gb.items()}, dev)
                         for gb in globals_[:3]])
        miss = [k for k in WORKER_KERNELS["dist-online"]
                if kernels.LAUNCHES[k] < 3]
        if miss:
            fail(f"[dist-online] kernel_vs_plain ({tag}) launched no {miss}")
    ids = torch.from_numpy(globals_[0]["ids"]).to(dev).reshape(-1)
    uq = torch.unique(ids).int()
    n_l = ids.numel() // WORKERS
    uidx, perm = sharded_stream.local_segments(ids[n_l:], uq)
    gen = torch.Generator(device=dev).manual_seed(31)
    res = check_sorted(dev, gen, ("dist-online rank 1, global order", uidx,
                                  perm, n_l, ONLINE_EMB + 1, uq.numel()),
                       gaps=True)
    log(f"[dist-online] segsum_sorted at rank 1's shape: {json.dumps(res)} ({SMI})")
    return res


def phase_dist_online(dev, root, env) -> dict:
    """``[dist-online]``: ``run_dist_online_train.sh 2`` at the script's
    defaults (the MLP in bfloat16) over a spool written first, both ranks
    from one saved state; the final parameters against one rank's run of
    the global stream from that state within ``ONLINE_BF16_LIMITS``,
    which a fault control must exceed.  Then the same stream through the
    script's ``main`` with a float32 MLP (``parallel/jobs.py:online_rank``)
    within ``ONLINE_F32_TOL`` of one rank, and rows 1-3 at the path's
    shapes against their plain versions (:func:`online_kernels`)."""
    t0 = time.perf_counter()
    globals_ = online_stream(root / "spool")
    online_stream(root / "spool_f32")  # the same batches, read once each
    init, first, want, ms, lost = online_one_rank(dev, root, globals_, True)
    init32, _first, want32, ms32, _ = online_one_rank(dev, root, globals_,
                                                      False)
    ex = Path(__file__).resolve().parent / "mindrec_tpu_torch" / "examples"
    width = ["--device", dev.type, "--batch-size", str(ONLINE_BATCH),
             "--vocab", str(ONLINE_VOCAB), "--emb-dim", str(ONLINE_EMB),
             "--deep-layers", *map(str, ONLINE_LAYERS), "--ckpt-interval", "3"]
    t1 = time.perf_counter()
    r = subprocess.run(
        ["bash", str(ex / "run_dist_online_train.sh"), str(WORKERS),
         str(root / "spool"), *width, "--init-state", init,
         "--final-params", str(root / "final.npz")],
        cwd=root, env={**env, "MR_SCHED_PORT": str(launch.free_port())},
        capture_output=True, text=True, timeout=240)
    wall = time.perf_counter() - t1
    if r.returncode != 0:
        log(r.stdout[-3000:])
        fail(f"[dist-online] run_dist_online_train.sh exited {r.returncode}")
    logs = [(root / "online_logs" / f"rank_{i}.log").read_text()
            for i in range(WORKERS)]
    launches = online_rank_checks("bf16", root, logs, "online_ckpt")
    diff = online_diff(np.load(root / "final.npz"), want, first)
    control = online_diff(lost, want, first)
    t2 = time.perf_counter()
    recs, outs = launch.run_job(
        "mindrec_tpu_torch.parallel.jobs:online_rank",
        {"device": dev.type, "config": {"use_mixed_precision": False},
         "argv": ["--spool", str(root / "spool_f32"), *width,
                  "--ckpt-dir", str(root / "online_ckpt_f32"),
                  "--init-state", init32,
                  "--final-params", str(root / "final_f32.npz")]},
        WORKERS, timeout=240, env=env, cwd=root)
    wall32 = time.perf_counter() - t2
    launches32 = online_rank_checks("float32", root, outs, "online_ckpt_f32")
    got32 = np.load(root / "final_f32.npz")
    rtol, atol = ONLINE_F32_TOL
    worst32, beyond32 = {}, {}
    for k, w in want32.items():
        worst32[k] = float(np.abs(got32[k] - w).max())
        n = int((~np.isclose(got32[k], w, rtol=rtol, atol=atol)).sum())
        if n:
            beyond32[k] = n
    res = {"launches": launches,  # the default run's, through the launcher
           "bf16": {"wall_s": wall, "max_abs_diff_and_rel_norm": diff,
                    "fault_control": control, "limits": ONLINE_BF16_LIMITS,
                    "one_rank_ms": ms},
           "float32": {"wall_s": wall32, "max_abs_diff": worst32,
                       "beyond_tolerance": beyond32, "rtol": rtol,
                       "atol": atol, "one_rank_ms": ms32,
                       "launches": launches32, "steps": recs},
           "drained": [line for t in logs + outs for line in t.splitlines()
                       if "stream drained" in line]}
    log(f"[dist-online] ({SMI}) {json.dumps(res)}")
    res["kernels"] = online_kernels(dev, globals_)
    log(f"[dist-online] {time.perf_counter() - t0:.1f} s")
    over = {k: (d, ONLINE_BF16_LIMITS[k]) for k, d in diff.items()
            if d[0] > ONLINE_BF16_LIMITS[k][0] or d[1] > ONLINE_BF16_LIMITS[k][1]}
    if over:
        fail(f"[dist-online] bfloat16 MLP: parts beyond their limits "
             f"(largest difference and relative norm, limits): {over}")
    blind = [k for k, d in control.items()
             if d[0] <= ONLINE_BF16_LIMITS[k][0] and d[1] <= ONLINE_BF16_LIMITS[k][1]]
    if blind:
        fail(f"[dist-online] the fault control stays within the limits of "
             f"{blind}: {control}")
    if beyond32:
        fail(f"[dist-online] float32 MLP: elements beyond rtol {rtol} / "
             f"atol {atol} of one rank: {beyond32}")
    return res


def phase_elastic(dev, root, env) -> dict:
    """``[elastic]``: ``run_elastic_train.sh 2`` at the yaml's width with a
    crash at step 3 (once), checkpoints every 2 steps: the wrapper must
    restart the trainer from the step-2 checkpoint and exit 0 at a global
    step past the crash."""
    ex = Path(__file__).resolve().parent / "mindrec_tpu_torch" / "examples"
    t0 = time.perf_counter()
    r = subprocess.run(
        ["bash", str(ex / "run_elastic_train.sh"), "2", *YAML_WIDTH,
         "--device", dev.type, "--epochs", "1", "--steps_per_epoch", str(ELASTIC_STEPS),
         "--ckpt_dir", str(root / "ckpt")],
        cwd=root, env={**env, "MINDREC_CRASH_AT_STEP": str(ELASTIC_CRASH),
                       "MINDREC_CRASH_MARKER": str(root / "crashed_once"),
                       "MR_CKPT_INTERVAL": "2"},
        capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    steps = sorted(int(p.name.split("-")[1]) for p in (root / "ckpt").glob("ckpt-*.npz"))
    resumed = re.search(r"resumed from .*\(step (\d+)\)", r.stdout)
    restarts = re.findall(r"restart \d+/\d+", r.stderr)
    if r.returncode != 0 or not resumed or not steps or steps[-1] <= ELASTIC_CRASH:
        log(r.stdout[-2000:] + r.stderr[-2000:])
        fail(f"[elastic] rc {r.returncode}, restarts {restarts}, checkpoints "
             f"at {steps}")
    auc = re.findall(r"final metrics: \{'auc': ([0-9.eE+-]+)", r.stdout)
    res = {"rc": r.returncode, "wall_s": wall, "restarts": restarts,
           "resumed_step": int(resumed.group(1)), "last_global_step": steps[-1],
           "final_auc": float(auc[-1]) if auc else None}
    log(f"[elastic] ({SMI}) {json.dumps(res)}")
    return res


def phase_workers(dev, parts=("ps-workers", "dist-online", "elastic")) -> dict:
    """Phase 31: ``[ps-workers]``, ``[dist-online]``, ``[elastic]``;
    ``parts`` picks some of them."""
    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="mrec_workers_"))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MR_", "MINDREC_CRASH"))}
    repo = str(Path(__file__).resolve().parent)
    env.update(PYTHONPATH=repo + os.pathsep + env.get("PYTHONPATH", ""),
               PYTHON=sys.executable)
    out = {}
    try:
        for tag, fn in (
                ("ps-workers", lambda d: phase_ps_workers(dev, d)),
                ("dist-online", lambda d: phase_dist_online(dev, d, env)),
                ("elastic", lambda d: phase_elastic(dev, d, env))):
            if tag not in parts:
                continue
            t = time.perf_counter()
            (root / tag).mkdir()
            out[tag] = fn(root / tag)
            log(f"[time] [{tag}] {time.perf_counter() - t:.1f} s")
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[time] phase 31 {time.perf_counter() - t0:.1f} s")
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
    phase_serving(dev, wd_model, wd_opts, rec_wd, rec_mt)
    torch.cuda.empty_cache()
    cache = phase_cache(dev)
    dyn = phase_dynamic(dev)
    files = phase_files(dev)
    ob = phase_outbrain_files(dev)
    online = phase_online_kafka(dev)
    ps = phase_ps(dev, cache, dyn)
    torch.cuda.empty_cache()
    t_gen = time.perf_counter()
    generic = phase_generic_wd(dev)
    gdyn = phase_generic_dyn(dev)
    drivers = phase_drivers(dev)
    log(f"[time] phases 27-29 {time.perf_counter() - t_gen:.1f} s")
    torch.cuda.empty_cache()
    sharded = phase_sharded(dev, gen, data, bucket)
    torch.cuda.empty_cache()
    workers = phase_workers(dev)
    by_path = {"cache": cache["wd"]["serial"]["launches"],
               "dynamic": dyn["launches"], "files": files["launches"],
               "online": online["launches_all"],
               "outbrain-files": ob["launches"],
               "ps-cache": ps["cache"]["wd"]["serial"]["launches"],
               "ps-host": ps["host"]["launches"],
               "ps-tb": ps["tb"]["serial"]["launches"],
               "ps-dyn": ps["dyn"]["launches"],
               "generic-wd": generic["generic_launches"],
               "generic-dyn": gdyn["launches"],
               "drivers-sparse": drivers["sparse"]["launches"],
               **{p: sharded[p]["launches"] for p in SHARD_KERNELS},
               **{f"{p}-captured": sharded[p]["captured"]["launches"]
                  for p in SHARD_KERNELS},
               **{p: workers[p]["launches"] for p in WORKER_KERNELS}}

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
                                   "bound_ms", "bound_by", "library_ms")},
         "launches_by_path": {p: by_path[p].get(k, 0) for p in by_path}}
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
