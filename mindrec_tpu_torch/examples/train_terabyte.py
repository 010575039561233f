"""TB-scale capability demo: train Wide&Deep with a virtual embedding
table far larger than the card's memory.  The port's counterpart of
``examples/train_terabyte.py``.

The reference's point: vocab 900,000,000 x emb 240 (a ~864 GB float32
table) trained on one device behind a 4.6M-row device cache, a RAM cap
and SSD spill.  Here the captured step trains on ``[cache_rows, 240]``
arenas on the card; the native LRU maps ids to slots; missed rows come
from a host RAM tier capped at ``--ram-gb`` that spills to
``--spill-dir`` (or from table servers with ``--servers``).

Usage::

  python -m mindrec_tpu_torch.examples.train_terabyte            # quick
  python -m mindrec_tpu_torch.examples.train_terabyte --vocab 900000000 \\
      --emb-dim 240 --cache-rows 4600000 --ram-gb 10           # the point
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import numpy as np


def main(argv=None):
    """Run the steps; returns the last (loss_w, loss_d) as floats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--vocab", type=int, default=900_000_000)
    ap.add_argument("--emb-dim", type=int, default=240)
    ap.add_argument("--cache-rows", type=int, default=200_000)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--field-size", type=int, default=39)
    ap.add_argument("--deep-layers", type=int, nargs="*",
                    default=[1024, 512, 256, 128])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--ram-gb", type=float, default=10.0)
    ap.add_argument("--spill-dir", default=None,
                    help="SSD spill directory (default: a new temporary "
                    "directory, removed at the end)")
    ap.add_argument("--servers", default="",
                    help="comma list of table-server host:port (remote tier)")
    ap.add_argument("--zipf", type=float, default=1.1,
                    help="id skew (power law, like production traffic)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from mindrec_tpu_torch.models.wide_deep import WideDeepConfig, WideDeepModel
    from mindrec_tpu_torch.train import optim
    from mindrec_tpu_torch.train.cached import (
        CachedTrainingAdapter, cached_train_step,
    )
    from mindrec_tpu_torch.train.step import init_train_state, make_train_step

    table_gb = args.vocab * args.emb_dim * 4 / 2**30
    arena_gb = args.cache_rows * args.emb_dim * 4 * 3 / 2**30  # param, m, v
    spill = args.spill_dir or tempfile.mkdtemp(prefix="mrec_tb_spill_")
    print(f"virtual table: {args.vocab:,} x {args.emb_dim} = {table_gb:,.0f} "
          f"GB fp32 | card arenas: {arena_gb:.2f} GB ({args.cache_rows:,} rows)"
          f" | host RAM cap {args.ram_gb} GB -> SSD {spill}", flush=True)

    cfg = WideDeepConfig(
        batch_size=args.batch_size, field_size=args.field_size,
        vocab_size=args.cache_rows, emb_dim=args.emb_dim,
        deep_layer_dim=tuple(args.deep_layers), sparse=True,
        # the swap is a contiguous column scatter on feature-major storage
        table_layout="feature_major",
    )
    model = WideDeepModel(cfg)
    opt_w = optim.ftrl(loss_scale=cfg.loss_scale)
    opt_d = optim.lazy_adam(loss_scale=cfg.loss_scale)
    state = init_train_state(model, 0, opt_w, opt_d, device=args.device)
    step = make_train_step(model, opt_w, opt_d, jit=True)
    adapter = CachedTrainingAdapter(
        model, virtual_vocab=args.vocab, cache_rows=args.cache_rows,
        max_swap=args.batch_size * args.field_size + 8,
        ram_bytes=int(args.ram_gb * 2**30), spill_dir=spill,
        remote_addrs=[s for s in args.servers.split(",") if s] or None,
    )
    rng = np.random.default_rng(0)

    def batch():
        # zipf-distributed ids over the whole vocab, production-like skew
        ids = (rng.zipf(args.zipf, (args.batch_size, args.field_size)) - 1) \
            % args.vocab
        return {
            "ids": ids.astype(np.int64),
            "wts": rng.uniform(0.5, 1.5, ids.shape).astype(np.float32),
            "label": rng.integers(0, 2, (args.batch_size, 1)).astype(np.float32),
        }

    losses = (float("nan"), float("nan"))
    try:
        for i in range(args.steps):
            b = batch()
            t0 = time.perf_counter()
            state, (lw, ld) = cached_train_step(adapter, step, state, b)
            losses = (float(lw), float(ld))  # a fence
            dt = time.perf_counter() - t0
            print(f"step {i}: loss_w={losses[0]:.4f} loss_d={losses[1]:.4f} "
                  f"distinct_ids={len(np.unique(b['ids']))} "
                  f"resident={len(adapter.lru)} {dt * 1e3:.0f} ms", flush=True)
        adapter.flush_all(state)
        print("flushed resident rows to tiers; demo complete", flush=True)
    finally:
        if args.spill_dir is None:
            shutil.rmtree(spill, ignore_errors=True)
    return losses


if __name__ == "__main__":
    main()
