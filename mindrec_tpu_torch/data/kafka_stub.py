"""In-repo Kafka protocol-stub broker (v0 API subset).

Port of ``mindrec_tpu/data/kafka_stub.py``: a threaded TCP server that
speaks enough of the Kafka wire protocol (Metadata v0, Produce v0, Fetch
v0, CreateTopics v0, v0 message sets) for the online-learning sources
(``data/streaming.py``) to run end to end with no broker installed.  It
serves the reference's client as well as the port's.

Not a real broker: in-memory logs, one node, no replication, no
consumer groups (the consumers use ``assign``).  Every accept and read
has a timeout (``poll_s``), so :meth:`StubKafkaBroker.stop` ends the
accept thread and every connection thread.
"""

from __future__ import annotations

import socket
import struct
import threading

from mindrec_tpu_torch.data.kafka_wire import (
    API_CREATE_TOPICS,
    API_FETCH,
    API_METADATA,
    API_PRODUCE,
    Reader,
    decode_message_set,
    enc_bytes,
    enc_str,
    encode_message_set,
)

_SEND_TIMEOUT_S = 30.0  # one whole response to a slow reader


class StubKafkaBroker:
    """``with StubKafkaBroker() as bootstrap: ...`` — bootstrap is a
    ``host:port`` string."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 poll_s: float = 0.2):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self._srv.settimeout(poll_s)
        self.poll_s = poll_s
        self.host, self.port = self._srv.getsockname()
        self._logs: dict[tuple[str, int], list[bytes]] = {}
        self._topics: dict[str, int] = {}  # name -> partition count
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._accept_thread: threading.Thread | None = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> str:
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="kafka-stub-accept"
        )
        self._accept_thread.start()
        return f"{self.host}:{self.port}"

    def stop(self, timeout: float = 5.0):
        """Stop serving and join the threads (each wakes within
        ``poll_s``)."""
        self._stop.set()
        for t in [self._accept_thread, *self._threads]:
            if t is not None:
                t.join(timeout)
        try:
            self._srv.close()
        except OSError:
            pass

    def __enter__(self) -> str:
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- helpers for tests -------------------------------------------------

    def log(self, topic: str, partition: int) -> list[bytes]:
        with self._lock:
            return list(self._logs.get((topic, partition), ()))

    # -- server loop -------------------------------------------------------

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(self.poll_s)
            t = threading.Thread(
                target=self._serve, args=(conn,), daemon=True,
                name="kafka-stub-conn",
            )
            t.start()
            self._threads.append(t)

    def _recv_exact(self, conn, n: int) -> bytes | None:
        """``n`` bytes, or None when the peer closed or the broker
        stopped."""
        out = b""
        while len(out) < n:
            try:
                chunk = conn.recv(n - len(out))
            except socket.timeout:
                if self._stop.is_set():
                    return None
                continue
            except OSError:
                return None
            if not chunk:
                return None
            out += chunk
        return out

    def _serve(self, conn: socket.socket):
        with conn:
            while not self._stop.is_set():
                head = self._recv_exact(conn, 4)
                if head is None:
                    return
                (size,) = struct.unpack(">i", head)
                payload = self._recv_exact(conn, size)
                if payload is None:
                    return
                r = Reader(payload)
                api_key = r.i16()
                r.i16()  # api_version (v0 assumed)
                corr = r.i32()
                r.string()  # client_id
                try:
                    body = self._dispatch(api_key, r)
                except Exception:
                    return  # drop connection on malformed requests
                resp = struct.pack(">i", corr) + body
                try:
                    # a whole response may take longer than a poll
                    conn.settimeout(_SEND_TIMEOUT_S)
                    conn.sendall(struct.pack(">i", len(resp)) + resp)
                    conn.settimeout(self.poll_s)
                except OSError:
                    return

    def _dispatch(self, api_key: int, r: Reader) -> bytes:
        if api_key == API_METADATA:
            return self._metadata(r)
        if api_key == API_PRODUCE:
            return self._produce(r)
        if api_key == API_FETCH:
            return self._fetch(r)
        if api_key == API_CREATE_TOPICS:
            return self._create_topics(r)
        raise ValueError(f"unsupported api key {api_key}")

    # -- apis --------------------------------------------------------------

    def _metadata(self, r: Reader) -> bytes:
        n = r.i32()
        names = [r.string() for _ in range(n)]
        with self._lock:
            if not names:
                names = sorted(self._topics)
            out = struct.pack(">i", 1)  # one broker
            out += struct.pack(">i", 0) + enc_str(self.host) + struct.pack(
                ">i", self.port
            )
            out += struct.pack(">i", len(names))
            for name in names:
                known = name in self._topics
                out += struct.pack(">h", 0 if known else 3)  # 3 = unknown
                out += enc_str(name)
                parts = self._topics.get(name, 0)
                out += struct.pack(">i", parts)
                for p in range(parts):
                    out += struct.pack(">hii", 0, p, 0)  # err, id, leader
                    out += struct.pack(">ii", 1, 0)  # replicas [0]
                    out += struct.pack(">ii", 1, 0)  # isr [0]
            return out

    def _create_topics(self, r: Reader) -> bytes:
        n = r.i32()
        resp = struct.pack(">i", n)
        for _ in range(n):
            name = r.string()
            parts = r.i32()
            r.i16()  # replication
            for _ in range(r.i32()):  # replica assignments
                r.i32()
                for _ in range(r.i32()):
                    r.i32()
            for _ in range(r.i32()):  # configs
                r.string()
                r.string()
            with self._lock:
                if name in self._topics:
                    resp += enc_str(name) + struct.pack(">h", 36)  # exists
                else:
                    self._topics[name] = parts
                    for p in range(parts):
                        self._logs[(name, p)] = []
                    resp += enc_str(name) + struct.pack(">h", 0)
        r.i32()  # timeout
        return resp

    def _produce(self, r: Reader) -> bytes:
        r.i16()  # acks
        r.i32()  # timeout
        n_topics = r.i32()
        resp = struct.pack(">i", n_topics)
        for _ in range(n_topics):
            topic = r.string()
            n_parts = r.i32()
            resp += enc_str(topic) + struct.pack(">i", n_parts)
            for _ in range(n_parts):
                partition = r.i32()
                msgset = r.bytes_() or b""
                values = [v for _, v in decode_message_set(msgset)]
                with self._lock:
                    if (topic, partition) not in self._logs:
                        self._topics.setdefault(topic, partition + 1)
                        self._topics[topic] = max(
                            self._topics[topic], partition + 1
                        )
                        self._logs[(topic, partition)] = []
                    log = self._logs[(topic, partition)]
                    base = len(log)
                    log.extend(values)
                resp += struct.pack(">ihq", partition, 0, base)
        return resp

    def _fetch(self, r: Reader) -> bytes:
        r.i32()  # replica id
        r.i32()  # max wait
        r.i32()  # min bytes
        n_topics = r.i32()
        resp = struct.pack(">i", n_topics)
        for _ in range(n_topics):
            topic = r.string()
            n_parts = r.i32()
            resp += enc_str(topic) + struct.pack(">i", n_parts)
            for _ in range(n_parts):
                partition = r.i32()
                offset = r.i64()
                max_bytes = r.i32()
                with self._lock:
                    log = self._logs.get((topic, partition), [])
                    hw = len(log)
                    vals = log[offset:]
                msgset = encode_message_set(vals, base_offset=offset)
                if len(msgset) > max_bytes:
                    msgset = msgset[:max_bytes]  # Kafka truncates; the
                    # client's decoder drops the partial tail
                resp += struct.pack(">ihq", partition, 0, hw)
                resp += enc_bytes(msgset)
        return resp
