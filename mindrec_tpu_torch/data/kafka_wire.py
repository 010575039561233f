"""Minimal Kafka wire-protocol client (protocol v0 subset).

Port of ``mindrec_tpu/data/kafka_wire.py``: its requests and message
sets are the reference's, byte for byte.  It speaks the Kafka binary
protocol directly (Metadata v0, Produce v0, Fetch v0, CreateTopics v0,
v0 message sets with CRC), so the online-learning sources
(``data/streaming.py``: ``KafkaSource``, ``create_topic``) work with no
third-party package, against ``data/kafka_stub.py:StubKafkaBroker`` or a
real broker.  ``kafka-python`` takes its place where it is installed.

Protocol framing: every request is ``int32 size | int16 api_key | int16
api_version | int32 correlation_id | string client_id | body``; strings
are int16-length-prefixed, byte blobs int32-length-prefixed (-1 = null);
all integers big-endian.  Every socket operation has a timeout
(``MiniKafkaClient(timeout=)``).
"""

from __future__ import annotations

import socket
import struct
import threading
import zlib

API_PRODUCE, API_FETCH, API_METADATA, API_CREATE_TOPICS = 0, 1, 3, 19


# --------------------------------------------------------------------------
# primitive encoding
# --------------------------------------------------------------------------


def enc_str(s: str | None) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def enc_bytes(b: bytes | None) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


class Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def i8(self):
        (v,) = struct.unpack_from(">b", self.d, self.o)
        self.o += 1
        return v

    def i16(self):
        (v,) = struct.unpack_from(">h", self.d, self.o)
        self.o += 2
        return v

    def i32(self):
        (v,) = struct.unpack_from(">i", self.d, self.o)
        self.o += 4
        return v

    def i64(self):
        (v,) = struct.unpack_from(">q", self.d, self.o)
        self.o += 8
        return v

    def string(self):
        n = self.i16()
        if n < 0:
            return None
        s = self.d[self.o : self.o + n].decode()
        self.o += n
        return s

    def bytes_(self):
        n = self.i32()
        if n < 0:
            return None
        b = self.d[self.o : self.o + n]
        self.o += n
        return b

    def raw(self, n):
        b = self.d[self.o : self.o + n]
        self.o += n
        return b

    def remaining(self) -> int:
        return len(self.d) - self.o


# --------------------------------------------------------------------------
# v0 message sets
# --------------------------------------------------------------------------


def encode_message(value: bytes, key: bytes | None = None) -> bytes:
    """One v0 message: crc | magic=0 | attrs=0 | key | value."""
    body = struct.pack(">bb", 0, 0) + enc_bytes(key) + enc_bytes(value)
    return struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF) + body


def encode_message_set(values, base_offset: int = 0) -> bytes:
    parts = []
    for i, v in enumerate(values):
        msg = encode_message(v)
        parts.append(struct.pack(">qi", base_offset + i, len(msg)) + msg)
    return b"".join(parts)


def decode_message_set(data: bytes):
    """-> list of (offset, value bytes); tolerates a truncated tail
    (Kafka fetch responses may cut the last message)."""
    out = []
    r = Reader(data)
    while r.remaining() >= 12:
        off = r.i64()
        size = r.i32()
        if r.remaining() < size:
            break  # truncated trailing message
        msg = Reader(r.raw(size))
        crc = struct.unpack(">I", msg.raw(4))[0]
        body = msg.d[msg.o :]
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise ValueError(f"message CRC mismatch at offset {off}")
        msg.i8()  # magic
        msg.i8()  # attributes
        msg.bytes_()  # key
        value = msg.bytes_()
        out.append((off, value))
    return out


# --------------------------------------------------------------------------
# client
# --------------------------------------------------------------------------


class MiniKafkaClient:
    """Blocking single-connection client for the v0 API subset."""

    def __init__(self, bootstrap: str = "localhost:9092",
                 client_id: str = "mindrec", timeout: float = 10.0):
        host, port = bootstrap.rsplit(":", 1)
        self.sock = socket.create_connection((host, int(port)), timeout)
        self.client_id = client_id
        self._corr = 0
        self._lock = threading.Lock()

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass

    def _recv_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("broker closed connection")
            out += chunk
        return out

    def request(self, api_key: int, body: bytes, api_version: int = 0) -> Reader:
        with self._lock:
            self._corr += 1
            corr = self._corr
            head = struct.pack(">hhi", api_key, api_version, corr)
            head += enc_str(self.client_id)
            payload = head + body
            self.sock.sendall(struct.pack(">i", len(payload)) + payload)
            (size,) = struct.unpack(">i", self._recv_exact(4))
            resp = Reader(self._recv_exact(size))
            got = resp.i32()
            if got != corr:
                raise ValueError(f"correlation id mismatch {got} != {corr}")
            return resp

    # -- apis ----------------------------------------------------------

    def metadata(self, topics=()) -> dict:
        body = struct.pack(">i", len(topics))
        for t in topics:
            body += enc_str(t)
        r = self.request(API_METADATA, body)
        brokers = {}
        for _ in range(r.i32()):
            nid = r.i32()
            host = r.string()
            port = r.i32()
            brokers[nid] = (host, port)
        out = {}
        for _ in range(r.i32()):
            terr = r.i16()
            name = r.string()
            parts = {}
            for _ in range(r.i32()):
                perr = r.i16()
                pid = r.i32()
                leader = r.i32()
                for _ in range(r.i32()):
                    r.i32()  # replicas
                for _ in range(r.i32()):
                    r.i32()  # isr
                parts[pid] = {"error": perr, "leader": leader}
            out[name] = {"error": terr, "partitions": parts}
        return out

    def create_topic(self, topic: str, num_partitions: int = 1,
                     replication: int = 1, timeout_ms: int = 5000) -> int:
        body = struct.pack(">i", 1)
        body += enc_str(topic)
        body += struct.pack(">ih", num_partitions, replication)
        body += struct.pack(">i", 0)  # replica assignments
        body += struct.pack(">i", 0)  # configs
        body += struct.pack(">i", timeout_ms)
        r = self.request(API_CREATE_TOPICS, body)
        n = r.i32()
        err = 0
        for _ in range(n):
            r.string()
            err = r.i16()
        return err

    def produce(self, topic: str, partition: int, values,
                acks: int = 1, timeout_ms: int = 5000) -> int:
        """Append values (list of bytes) to one partition; returns the
        base offset assigned."""
        msgset = encode_message_set(list(values))
        body = struct.pack(">hi", acks, timeout_ms)
        body += struct.pack(">i", 1) + enc_str(topic)
        body += struct.pack(">i", 1)
        body += struct.pack(">i", partition) + enc_bytes(msgset)
        r = self.request(API_PRODUCE, body)
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()  # partition
                err = r.i16()
                off = r.i64()
                if err:
                    raise RuntimeError(f"produce error code {err}")
                return off
        raise RuntimeError("empty produce response")

    def fetch(self, topic: str, partition: int, offset: int,
              max_bytes: int = 1 << 20, max_wait_ms: int = 100,
              min_bytes: int = 1):
        """-> (highwater, [(offset, value)]) from one partition."""
        body = struct.pack(">iii", -1, max_wait_ms, min_bytes)
        body += struct.pack(">i", 1) + enc_str(topic)
        body += struct.pack(">i", 1)
        body += struct.pack(">iqi", partition, offset, max_bytes)
        r = self.request(API_FETCH, body)
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()  # partition
                err = r.i16()
                hw = r.i64()
                msgset = r.bytes_() or b""
                if err:
                    raise RuntimeError(f"fetch error code {err}")
                return hw, decode_message_set(msgset)
        return 0, []


class MiniKafkaProducer:
    """kafka-python-shaped producer over :class:`MiniKafkaClient`."""

    def __init__(self, bootstrap_servers="localhost:9092",
                 value_serializer=None, linger_values: int = 1):
        self._client = MiniKafkaClient(bootstrap_servers)
        self._ser = value_serializer or (lambda v: v)

    def send(self, topic: str, value, partition: int = 0):
        self._client.produce(topic, partition, [self._ser(value)])

    def flush(self):
        pass  # sends are synchronous

    def close(self):
        self._client.close()


class _Record:
    __slots__ = ("topic", "partition", "offset", "value")

    def __init__(self, topic, partition, offset, value):
        self.topic = topic
        self.partition = partition
        self.offset = offset
        self.value = value


class MiniKafkaConsumer:
    """kafka-python-shaped consumer (assign + iterate) over
    :class:`MiniKafkaClient`.  ``consumer_timeout_ms`` stops iteration
    after that long with no new records; ``auto_offset_reset`` matches
    kafka-python's default "latest" (start at the log end, consume new
    records only) so the fallback does not silently re-train on a
    topic's whole retained history — pass "earliest" to replay."""

    def __init__(self, bootstrap_servers="localhost:9092",
                 consumer_timeout_ms: int | None = None,
                 auto_offset_reset: str = "latest"):
        self._client = MiniKafkaClient(bootstrap_servers)
        self._assign: list[tuple[str, int]] = []
        self._offsets: dict[tuple[str, int], int] = {}
        self._timeout_ms = consumer_timeout_ms
        self._reset = auto_offset_reset

    def assign(self, partitions):
        """partitions: iterable of (topic, partition) pairs or objects
        with .topic/.partition."""
        for tp in partitions:
            if isinstance(tp, tuple):
                t, p = tp
            else:
                t, p = tp.topic, tp.partition
            self._assign.append((t, p))
            if (t, p) not in self._offsets:
                if self._reset == "earliest":
                    self._offsets[(t, p)] = 0
                else:
                    # current log end = the fetch response's highwater
                    hw, _ = self._client.fetch(t, p, 0, max_bytes=0,
                                               max_wait_ms=0)
                    self._offsets[(t, p)] = hw

    def __iter__(self):
        import time

        idle_ms = 0.0
        while True:
            got = False
            for t, p in self._assign:
                off = self._offsets[(t, p)]
                _, recs = self._client.fetch(t, p, off, max_wait_ms=50)
                for o, v in recs:
                    self._offsets[(t, p)] = o + 1
                    got = True
                    yield _Record(t, p, o, v)
            if got:
                idle_ms = 0.0
                continue
            if self._timeout_ms is not None:
                idle_ms += 60.0
                if idle_ms >= self._timeout_ms:
                    return
            time.sleep(0.06)

    def close(self):
        self._client.close()
