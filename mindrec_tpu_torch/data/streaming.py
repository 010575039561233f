"""Online-learning streaming pipeline.

Port of ``mindrec_tpu/data/streaming.py`` (no torch): the Kafka ->
channel -> dataset chain that feeds ``RecModel.online_train``.

* :class:`Channel` / :class:`DataSender` / :class:`DataReceiver`: an
  in-process sharded channel (the sender shards batches round-robin,
  each receiver pulls its shard);
* :class:`FileChannel`: the same across processes, over a spool of
  ``.npz`` files that either package writes and reads;
* :class:`StreamingDataset`: a receiver as an unbounded batch iterator
  (a fake length of ``2**20 - 1``);
* :class:`KafkaSource` and :func:`create_topic`: a topic's partitions
  read as lists of ``count`` message values, through ``kafka-python``
  where it is installed and the in-repo client (``data/kafka_wire.py``)
  otherwise;
* :class:`CriteoFeatureEngineer`: raw Criteo rows -> a model batch
  (min-max scaled dense columns, cat2id with per-column OOV buckets;
  ``data/preprocess.py:transform_rows``).
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Iterator, Optional

import numpy as np


class Channel:
    """N-shard in-process channel (MindPandas ``channel`` equivalent)."""

    def __init__(self, num_shards: int = 1, capacity: int = 64):
        self.num_shards = num_shards
        self.queues = [queue_mod.Queue(maxsize=capacity) for _ in range(num_shards)]

    def sender(self) -> "DataSender":
        return DataSender(self)

    def receiver(self, shard_id: int) -> "DataReceiver":
        return DataReceiver(self, shard_id)


class DataSender:
    """Sends batches round-robin (or explicitly) to channel shards
    (reference ``DataSender.send`` sharded by device count)."""

    def __init__(self, channel: Channel):
        self.channel = channel
        self._rr = 0

    def send(self, item, shard_id: Optional[int] = None):
        if shard_id is None:
            shard_id = self._rr % self.channel.num_shards
            self._rr += 1
        self.channel.queues[shard_id].put(item)

    def close(self):
        for q in self.channel.queues:
            q.put(_EOS)


_EOS = object()


class DataReceiver:
    """Receives this shard's stream (reference ``DataReceiver.recv``)."""

    def __init__(self, channel: Channel, shard_id: int):
        self.channel = channel
        self.shard_id = shard_id

    def recv(self, timeout: Optional[float] = None):
        item = self.channel.queues[self.shard_id].get(timeout=timeout)
        if item is _EOS:
            raise StopIteration
        return item


class StreamingDataset:
    """Unbounded dataset over a receiver (reference ``StreamingDataset``,
    ``online_train.py:30-45``: fake huge len, per-item recv)."""

    FAKE_LEN = 2**20 - 1  # reference parity

    def __init__(self, receiver: DataReceiver):
        self.receiver = receiver

    def __len__(self):
        return self.FAKE_LEN

    def __iter__(self) -> Iterator:
        while True:
            try:
                yield self.receiver.recv()
            except StopIteration:
                return
            except queue_mod.Empty:
                return


class FileChannel:
    """Cross-PROCESS sharded channel over a spool directory.

    The reference's distributed online training shards the MindPandas
    channel receiver by rank across trainer processes
    (``examples/online_learning/dist_online_train.py:63-97``).  The
    in-process :class:`Channel` can't cross process boundaries, so this
    variant spools batches as atomically-renamed ``.npz`` files under
    ``dir/shard_<k>/``: any process can send, any process can tail its
    shard — including across hosts on a shared filesystem (the log-like
    durability is also Kafka-parity in spirit).

    Wire format: ``seq_<n>.npz`` holding the batch dict; ``_EOS`` marker
    file ends a shard's stream.

    Contract: ONE sender per shard (sequence numbers are sender-local,
    like one Kafka producer per partition — the reference's producer
    maps processes to partitions the same way, ``producer.py:35-78``);
    any number of senders may cover disjoint shards.
    """

    def __init__(self, root, num_shards: int = 1, poll_s: float = 0.05):
        from pathlib import Path

        self.root = Path(root)
        self.num_shards = num_shards
        self.poll_s = poll_s
        for k in range(num_shards):
            (self.root / f"shard_{k}").mkdir(parents=True, exist_ok=True)

    def sender(self) -> "FileSender":
        return FileSender(self)

    def receiver(self, shard_id: int) -> "FileReceiver":
        return FileReceiver(self, shard_id)


class FileSender:
    def __init__(self, channel: FileChannel):
        self.channel = channel
        self._rr = 0
        self._seq = [0] * channel.num_shards

    def send(self, batch: dict, shard_id: Optional[int] = None):
        import os

        if shard_id is None:
            shard_id = self._rr % self.channel.num_shards
            self._rr += 1
        d = self.channel.root / f"shard_{shard_id}"
        n = self._seq[shard_id]
        tmp = d / f".tmp_{n}.npz"
        with open(tmp, "wb") as f:
            np.savez(f, **{k: np.asarray(v) for k, v in batch.items()})
        os.replace(tmp, d / f"seq_{n:08d}.npz")  # atomic publish
        self._seq[shard_id] = n + 1

    def close(self):
        for k in range(self.channel.num_shards):
            (self.channel.root / f"shard_{k}" / "_EOS").touch()


class FileReceiver:
    """Tails one shard directory; ``recv`` blocks until the next batch
    (or raises StopIteration at the EOS marker)."""

    def __init__(self, channel: FileChannel, shard_id: int):
        self.channel = channel
        self.dir = channel.root / f"shard_{shard_id}"
        self.next_seq = 0

    def recv(self, timeout: Optional[float] = None):
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        path = self.dir / f"seq_{self.next_seq:08d}.npz"
        while True:
            if path.exists():
                with np.load(path) as z:
                    batch = {k: z[k] for k in z.files}
                self.next_seq += 1
                return batch
            if (self.dir / "_EOS").exists():
                raise StopIteration
            if deadline is not None and _time.monotonic() > deadline:
                raise queue_mod.Empty
            _time.sleep(self.channel.poll_s)


class CriteoFeatureEngineer:
    """Streaming feature engineering (reference consumer ``get_weight`` /
    ``get_id``, ``examples/online_learning/consumer.py:9-31``): min-max
    scale the 13 dense columns, map the 26 categorical columns through
    cat2id with per-column OOV buckets."""

    def __init__(self, stats):
        # stats: mindrec_tpu_torch.data.preprocess.CriteoStats
        self.stats = stats

    def __call__(self, raw_rows: list[list[str]]) -> dict[str, np.ndarray]:
        from mindrec_tpu_torch.data.preprocess import transform_rows

        lines = ["\t".join(r) for r in raw_rows]
        ids, wts, labels = [], [], []
        for i, w, l in transform_rows(iter(lines), self.stats):
            ids.append(i)
            wts.append(w)
            labels.append(l)
        return {
            "ids": np.stack(ids).astype(np.int32),
            "wts": np.stack(wts).astype(np.float32),
            "label": np.array(labels, np.float32)[:, None],
        }


def create_topic(topic: str, num_partitions: int = 2,
                 bootstrap_servers: str = "localhost:9092",
                 replication_factor: int = 1):
    """Create a Kafka topic (reference admin helper,
    ``examples/online_learning/kafka_client.py:1-10``).  Uses
    kafka-python when installed, else the in-repo wire-protocol client
    (``data/kafka_wire.py``)."""
    try:
        from kafka.admin import KafkaAdminClient, NewTopic  # type: ignore
    except ImportError:
        from mindrec_tpu_torch.data.kafka_wire import MiniKafkaClient

        client = MiniKafkaClient(bootstrap_servers)
        try:
            err = client.create_topic(topic, num_partitions,
                                      replication_factor)
            if err not in (0, 36):  # 36 = topic already exists
                raise RuntimeError(f"create_topic error code {err}")
        finally:
            client.close()
        return
    admin = KafkaAdminClient(bootstrap_servers=bootstrap_servers)
    admin.create_topics(
        [NewTopic(name=topic, num_partitions=num_partitions,
                  replication_factor=replication_factor)]
    )
    admin.close()


class KafkaSource:
    """Kafka topic-partition reader (reference ``read_kafka.py:5-41``):
    yields lists of messages, one list per ``count`` consumed.  Uses
    kafka-python when installed, else the in-repo wire-protocol client
    (tested end-to-end against ``kafka_stub.StubKafkaBroker``).

    ``idle_timeout_ms``: stop iterating after that long with no new
    records (None = consume forever, the reference behavior).
    ``auto_offset_reset``: "latest" (default, consume new records only
    — both backends) or "earliest" (replay the retained log)."""

    def __init__(self, topic: str, partitions,
                 bootstrap_servers="localhost:9092", count: int = 1000,
                 idle_timeout_ms: int | None = None,
                 auto_offset_reset: str = "latest"):
        try:
            from kafka import KafkaConsumer, TopicPartition  # type: ignore

            self._consumer = KafkaConsumer(
                bootstrap_servers=bootstrap_servers,
                auto_offset_reset=auto_offset_reset,
                consumer_timeout_ms=(
                    idle_timeout_ms if idle_timeout_ms is not None
                    else float("inf")
                ),
            )
            self._consumer.assign(
                [TopicPartition(topic, p) for p in partitions]
            )
            if auto_offset_reset == "earliest":
                self._consumer.seek_to_beginning()
        except ImportError:
            from mindrec_tpu_torch.data.kafka_wire import MiniKafkaConsumer

            self._consumer = MiniKafkaConsumer(
                bootstrap_servers=bootstrap_servers,
                consumer_timeout_ms=idle_timeout_ms,
                auto_offset_reset=auto_offset_reset,
            )
            self._consumer.assign([(topic, p) for p in partitions])
        self.count = count

    def __iter__(self):
        buf = []
        for msg in self._consumer:
            buf.append(msg.value)
            if len(buf) >= self.count:
                yield buf
                buf = []
        if buf:
            yield buf


def feed_channel_from_iterator(it, channel: Channel, num_shards: Optional[int] = None, daemon: bool = True) -> threading.Thread:
    """Producer thread: round-robin an iterator's batches into a channel
    (the reference's producer/consumer split, in-process)."""
    sender = channel.sender()

    def work():
        try:
            for item in it:
                sender.send(item)
        finally:
            sender.close()

    t = threading.Thread(target=work, daemon=daemon)
    t.start()
    return t
