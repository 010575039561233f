"""Stream Criteo TSV rows into Kafka: the port's counterpart of
``examples/kafka_producer.py``.  N producer processes each feed one topic
partition with JSON messages of rows (the reference's
``online_learning/producer.py``).

Usage::

  python -m mindrec_tpu_torch.examples.kafka_producer --file day_0 \\
      --topic criteo_stream --partitions 2 [--bootstrap host:port] \\
      [--rows-per-msg 1000]

Pairs with ``mindrec_tpu_torch.data.streaming.KafkaSource``; create the
topic first with ``streaming.create_topic``.  With no broker at hand,
``data/kafka_stub.py:StubKafkaBroker`` serves the same wire protocol.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp


def _make_producer(bootstrap: str):
    """kafka-python when installed, else the in-repo wire client
    (``data/kafka_wire.py``), with the same send/flush surface."""
    try:
        from kafka import KafkaProducer  # type: ignore
    except ImportError:
        from mindrec_tpu_torch.data.kafka_wire import MiniKafkaProducer

        return MiniKafkaProducer(
            bootstrap_servers=bootstrap,
            value_serializer=lambda v: json.dumps(v).encode(),
        )
    return KafkaProducer(
        bootstrap_servers=bootstrap,
        value_serializer=lambda v: json.dumps(v).encode(),
    )


def produce(path: str, topic: str, partition: int, num_partitions: int,
            bootstrap: str, rows_per_msg: int) -> int:
    """Send every ``num_partitions``-th row from ``partition`` on; returns
    the messages sent."""
    producer = _make_producer(bootstrap)
    buf, sent = [], 0
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            if i % num_partitions != partition:
                continue
            buf.append(line.rstrip("\n").split("\t"))
            if len(buf) >= rows_per_msg:
                producer.send(topic, value=buf, partition=partition)
                buf, sent = [], sent + 1
    if buf:
        producer.send(topic, value=buf, partition=partition)
        sent += 1
    producer.flush()
    return sent


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--file", required=True, help="Criteo TSV day file")
    ap.add_argument("--topic", default="criteo_stream")
    ap.add_argument("--partitions", type=int, default=2)
    ap.add_argument("--bootstrap", default="localhost:9092")
    ap.add_argument("--rows-per-msg", type=int, default=1000)
    args = ap.parse_args(argv)

    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=produce,
                    args=(args.file, args.topic, p, args.partitions,
                          args.bootstrap, args.rows_per_msg))
        for p in range(args.partitions)
    ]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise SystemExit(f"producer processes failed: exit codes {bad}")
    print(f"streamed {args.file} into {args.topic} over "
          f"{args.partitions} partitions", flush=True)


if __name__ == "__main__":
    main()
