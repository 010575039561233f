"""Distributed online (streaming) training: the port's counterpart of
``examples/dist_online_train.py``.  One trainer process per rank, the
stream sharded by rank, data-parallel gradients over the ranks, a
checkpoint directory per rank.

Every rank joins one process group through the ``MR_*`` bootstrap
(``parallel/dist.py``; gloo on the CPU or when ranks share a card,
``MR_BACKEND`` picks) and trains on the data mesh
(``make_mesh(data=world, model=1)``).  The stream arrives through a
:class:`~mindrec_tpu_torch.data.streaming.FileChannel` spool with
``num_shards == world``: rank ``r`` tails shard ``r``, and each batch it
receives is its slice of the global batch (``mesh.LocalBatch``), so the
global batch is the ranks' batches in rank order.  Training runs through
``RecModel.online_train`` until every shard's end-of-stream marker;
``--final-params`` is written by rank 0.

Launch (2 ranks, one host; ``run_dist_online_train.sh`` does this)::

  for i in 0 1; do
    MR_SCHED_HOST=127.0.0.1 MR_SCHED_PORT=12411 MR_WORKER_NUM=2 \\
    MR_WORKER_ID=$i python -m mindrec_tpu_torch.examples.dist_online_train \\
        --spool /tmp/spool &
  done

(a producer fills the spool: ``FileChannel(spool, num_shards=2).sender()``,
as ``tests/test_torch_dist_online.py`` does).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--spool", required=True, help="FileChannel directory")
    ap.add_argument("--batch-size", type=int, default=1000,
                    help="per-rank batch size")
    ap.add_argument("--field-size", type=int, default=39)
    ap.add_argument("--vocab", type=int, default=200_000)
    ap.add_argument("--emb-dim", type=int, default=16)
    ap.add_argument("--deep-layers", type=int, nargs="*",
                    default=[1024, 512, 256, 128])
    ap.add_argument("--ckpt-dir", default="./online_ckpt")
    ap.add_argument("--ckpt-interval", type=int, default=100)
    ap.add_argument("--ckpt-keep", type=int, default=5)
    ap.add_argument("--recv-timeout", type=float, default=60.0)
    ap.add_argument("--final-params", default="",
                    help="npz path for the final parameters (rank 0)")
    ap.add_argument("--init-state", default="",
                    help="a checkpoint file to start from (default: the "
                    "state made from seed 0)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, **config):
    """Train until every shard of the stream ends; -> the final state.
    ``config`` replaces fields of the model's ``WideDeepConfig`` (a
    check's float32 MLP: ``use_mixed_precision=False``)."""
    args = parse_args(argv)

    from mindrec_tpu_torch import RecModel
    from mindrec_tpu_torch.data.streaming import FileChannel
    from mindrec_tpu_torch.io.checkpoint import restore_checkpoint
    from mindrec_tpu_torch.models.wide_deep import WideDeepConfig, WideDeepModel
    from mindrec_tpu_torch.ops.kernels import LAUNCHES
    from mindrec_tpu_torch.parallel.dist import (
        initialize_from_env, rank_device, shutdown,
    )
    from mindrec_tpu_torch.parallel.mesh import LocalBatch, make_mesh
    from mindrec_tpu_torch.train import optim
    from mindrec_tpu_torch.train.callbacks import (
        CheckpointCallback, LossCallback, TimeMonitor,
    )
    from mindrec_tpu_torch.train.step import flatten_params

    topo = initialize_from_env(device=args.device)
    world, rank = topo["process_count"], topo["process_index"]
    print(f"dist_online rank {rank}/{world}: {topo}", flush=True)

    cfg = WideDeepConfig(
        batch_size=args.batch_size * world, field_size=args.field_size,
        vocab_size=args.vocab, emb_dim=args.emb_dim,
        deep_layer_dim=tuple(args.deep_layers), sparse=True,
        **config,
    )
    mesh = make_mesh(data=world, model=1)
    model = WideDeepModel(cfg, mesh=mesh)
    rm = RecModel(model, optim.ftrl(loss_scale=cfg.loss_scale),
                  optim.lazy_adam(loss_scale=cfg.loss_scale),
                  device=rank_device(args.device))
    if args.init_state:
        rm.state = restore_checkpoint(args.init_state, rm.state,
                                      shardings=rm.shardings)

    recv = FileChannel(args.spool, num_shards=world).receiver(rank)

    def stream():
        while True:
            try:
                yield LocalBatch(recv.recv(timeout=args.recv_timeout))
            except StopIteration:
                return

    t0 = time.perf_counter()
    rm.online_train(
        stream(),
        callbacks=[
            LossCallback(f"online_loss_rank{rank}.log", per_print_times=10),
            TimeMonitor(),
            CheckpointCallback(f"{args.ckpt_dir}/rank_{rank}",
                               save_steps=args.ckpt_interval,
                               keep_max=args.ckpt_keep),
        ],
        dataset_sink_mode=False,
    )
    print(f"rank {rank}: stream drained in {time.perf_counter() - t0:.1f}s "
          f"({int(rm.state.step)} steps)", flush=True)
    # the steps on a mesh are eager: each launch of a kernel is counted
    print(f"rank {rank}: kernel launches "
          f"{json.dumps({k: v for k, v in LAUNCHES.items() if v})}", flush=True)
    if args.final_params and rank == 0:
        np.savez(args.final_params, **{
            k: v.detach().float().cpu().numpy()
            for k, v in flatten_params(rm.state.params)})
    state = rm.state
    shutdown()
    return state


if __name__ == "__main__":
    main()
