"""Online (streaming) training: the port's counterpart of
``examples/online_train.py``.

Pipeline, in-process by default::

    producer thread -> sharded Channel -> StreamingDataset
        -> RecModel.online_train (unbounded) -> checkpoints

With ``--kafka`` the producer is a Kafka consumer (``KafkaSource``, the
in-repo client when kafka-python is absent; ``data/kafka_stub.py`` is a
broker for it) whose JSON messages of TSV rows go through
``CriteoFeatureEngineer``.  Each message is decoded before the feature
engineer sees it (the reference hands it the raw message values:
ROADMAP.md section 3, reference fault 6).  Checkpoints every
``--ckpt-interval`` steps keep ``--ckpt-keep``.

Usage::

  python -m mindrec_tpu_torch.examples.online_train --steps 30
  python -m mindrec_tpu_torch.examples.online_train --kafka \\
      --topic criteo --stats stats.pkl --bootstrap host:port
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np


def synthetic_stream(batch_size, field_size, vocab, steps, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        yield {
            "ids": rng.integers(0, vocab, (batch_size, field_size)).astype(np.int32),
            "wts": rng.uniform(0.5, 1.5, (batch_size, field_size)).astype(np.float32),
            "label": rng.integers(0, 2, (batch_size, 1)).astype(np.float32),
        }


def main(argv=None):
    """Train until the stream ends; returns the final train state."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=1000)
    ap.add_argument("--field-size", type=int, default=39)
    ap.add_argument("--vocab", type=int, default=200_000)
    ap.add_argument("--emb-dim", type=int, default=16)
    ap.add_argument("--deep-layers", type=int, nargs="*",
                    default=[1024, 512, 256, 128])
    ap.add_argument("--steps", type=int, default=30,
                    help="synthetic stream length")
    ap.add_argument("--shards", type=int, default=1, help="channel shards")
    ap.add_argument("--shard-id", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="./online_ckpt")
    ap.add_argument("--ckpt-interval", type=int, default=100)
    ap.add_argument("--ckpt-keep", type=int, default=5)
    ap.add_argument("--sink", action="store_true", help="dataset sink mode")
    ap.add_argument("--kafka", action="store_true")
    ap.add_argument("--topic", default="criteo")
    ap.add_argument("--bootstrap", default="localhost:9092")
    ap.add_argument("--stats", default="", help="CriteoStats pickle for --kafka")
    ap.add_argument("--idle-timeout-ms", type=int, default=0,
                    help="with --kafka: stop after this long without a "
                    "message (0: consume for ever, as the reference)")
    ap.add_argument("--earliest", action="store_true",
                    help="with --kafka: replay the retained log (the "
                    "consumer's auto_offset_reset='earliest'), not only new "
                    "messages")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from mindrec_tpu_torch import RecModel
    from mindrec_tpu_torch.data.streaming import (
        Channel, DataReceiver, StreamingDataset, feed_channel_from_iterator,
    )
    from mindrec_tpu_torch.models.wide_deep import WideDeepConfig, WideDeepModel
    from mindrec_tpu_torch.train import optim
    from mindrec_tpu_torch.train.callbacks import (
        CheckpointCallback, LossCallback, TimeMonitor,
    )

    channel = Channel(num_shards=args.shards)
    vocab = args.vocab
    if args.kafka:
        import pickle

        from mindrec_tpu_torch.data.streaming import (
            CriteoFeatureEngineer, KafkaSource,
        )

        stats = pickle.loads(Path(args.stats).read_bytes())
        vocab = stats.vocab_size
        fe = CriteoFeatureEngineer(stats)
        source = KafkaSource(args.topic, range(args.shards), args.bootstrap,
                             count=1,
                             idle_timeout_ms=args.idle_timeout_ms or None,
                             auto_offset_reset=("earliest" if args.earliest
                                                else "latest"))
        src = (fe(json.loads(msgs[0])) for msgs in source)
    else:
        src = synthetic_stream(args.batch_size, args.field_size, vocab,
                               args.steps)
    feed_channel_from_iterator(src, channel)

    cfg = WideDeepConfig(
        batch_size=args.batch_size, field_size=args.field_size,
        vocab_size=vocab, emb_dim=args.emb_dim,
        deep_layer_dim=tuple(args.deep_layers), sparse=True,
    )
    rm = RecModel(WideDeepModel(cfg), optim.ftrl(loss_scale=cfg.loss_scale),
                  optim.lazy_adam(loss_scale=cfg.loss_scale),
                  device=args.device)
    ds = StreamingDataset(DataReceiver(channel, args.shard_id))
    t0 = time.perf_counter()
    state = rm.online_train(
        ds,
        callbacks=[
            LossCallback("online_loss.log", per_print_times=10),
            TimeMonitor(),
            CheckpointCallback(args.ckpt_dir, save_steps=args.ckpt_interval,
                               keep_max=args.ckpt_keep),
        ],
        dataset_sink_mode=args.sink,
    )
    print(f"online stream drained in {time.perf_counter() - t0:.1f}s "
          f"({int(state.step)} steps)", flush=True)
    return state


if __name__ == "__main__":
    main()
