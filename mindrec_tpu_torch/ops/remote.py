"""Remote embedding tiers: the worker's client of the table server.

Port of ``mindrec_tpu/ops/remote.py``, the worker side of PS mode (the
reference spawns parameter-server processes holding table shards with a
RAM cap and SSD spill).  The server is this package's
``native/table_server.cc``, built by g++ at first use into
``mindrec_tpu_torch/_build/table_server-<hash>/`` (a failed build raises);
it speaks the reference server's wire byte for byte, so either client
works against either server.

* :class:`RemoteTier` has :class:`~mindrec_tpu_torch.ops.cache.HostTier`'s
  ``read`` / ``write`` / ``flush``, so the cache and host-target regimes
  take either: the hierarchy becomes device arena <-> (server RAM <->
  server SSD), sharded over any number of servers by
  ``splitmix64(id) % n_servers``;
* :class:`RemoteHashStore` is the dynamic regime's id -> slot map, sharded
  the same way; server ``s`` hands out global slots in
  ``[s * capacity / S, (s + 1) * capacity / S)``.

Against the reference: a request goes to every shard before any reply is
read, so the servers work side by side (each reads its whole request
before it answers, so this cannot deadlock); replies are read straight
into their arrays (``recv_into``); a table name longer than the wire's 32
bytes raises (the reference truncates it, so two tables could share
storage); and ``RemoteHashStore.lookup_or_insert`` sends every shard a
lookup, an empty one where the shard has no key, so every shard's step
clock advances on every call (the reference calls only the shards with a
key, so an idle shard's keys age more slowly than the local store's).
Every socket has a timeout.
"""

from __future__ import annotations

import socket
import struct
import subprocess
import time
from pathlib import Path

import numpy as np

from mindrec_tpu_torch.native import build as native_build

SRC = Path(__file__).resolve().parents[1] / "native" / "table_server.cc"
HEADER = SRC.with_name("hashstore_impl.h")
NAME_BYTES = 32  # table names on the wire
TIMEOUT_S = 60.0  # every socket's
STOP_S = 10.0  # a stopped server is killed after this long
PORT_TRIES = 5  # free ports tried when the picked one is taken
BIND_TAKEN_RC = 98  # the server's exit code when its port is taken

_SPLITMIX_C1 = 0xBF58476D1CE4E5B9
_SPLITMIX_C2 = 0x94D049BB133111EB


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorised splitmix64 (``table_server.cc``'s ``Splitmix64``)."""
    with np.errstate(over="ignore"):
        x = x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(_SPLITMIX_C1)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(_SPLITMIX_C2)
        return x ^ (x >> np.uint64(31))


def _shard(ids: np.ndarray, n: int) -> np.ndarray:
    """``splitmix64(id) % n`` of int64 ids (two's complement for negatives)."""
    if n == 1:
        return np.zeros(ids.shape[0], np.int64)
    return (_splitmix64(ids.view(np.uint64)) % np.uint64(n)).astype(np.int64)


def _wire_name(name: str) -> bytes:
    raw = name.encode()
    if len(raw) > NAME_BYTES:
        raise ValueError(f"table name {name!r} is {len(raw)} bytes; the wire "
                         f"holds {NAME_BYTES} (a truncated name could share "
                         f"another table's storage)")
    return raw.ljust(NAME_BYTES, b"\0")


def _connect(addr: str, timeout_s: float) -> socket.socket:
    host, port = addr.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)), timeout=timeout_s)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


class _Conn:
    """One table on one server."""

    def __init__(self, addr: str, table: str, dim: int, init_std: float,
                 seed: int, init_bias: float = 0.0, timeout_s: float = TIMEOUT_S):
        self.addr = addr
        self.dim = dim
        name = _wire_name(table)
        self.sock = _connect(addr, timeout_s)
        self.sock.sendall(b"MREC" + struct.pack("<I", dim) + name
                          + struct.pack("<ffQ", init_std, init_bias, seed))
        magic = self._recv(8)
        if magic[:4] != b"MRSV" or struct.unpack("<I", magic[4:])[0] != dim:
            self.close()
            raise ConnectionError(f"table server handshake failed for "
                                  f"{table}@{addr}")

    def _recv_into(self, buf) -> None:
        """Fill the writable buffer ``buf`` from the socket."""
        view = memoryview(buf).cast("B")
        got = 0
        while got < view.nbytes:
            k = self.sock.recv_into(view[got:])
            if not k:
                raise ConnectionError(f"table server {self.addr} closed the "
                                      f"connection")
            got += k

    def _recv(self, n: int) -> bytes:
        buf = bytearray(n)
        self._recv_into(buf)
        return bytes(buf)

    def send_read(self, ids: np.ndarray) -> None:
        self.sock.sendall(struct.pack("<BI", 1, ids.shape[0])
                          + ids.astype("<i8").tobytes())

    def recv_rows(self, n: int) -> np.ndarray:
        out = np.empty((n, self.dim), "<f4")
        self._recv_into(out)
        return out

    def send_write(self, ids: np.ndarray, rows: np.ndarray) -> None:
        self.sock.sendall(struct.pack("<BI", 2, ids.shape[0])
                          + ids.astype("<i8").tobytes())
        self.sock.sendall(np.ascontiguousarray(rows, "<f4"))

    def flush(self) -> None:
        self.sock.sendall(struct.pack("<BI", 3, 0))
        self._recv(1)

    def stats(self) -> tuple[int, int]:
        """(RAM rows, SSD rows) of this table on this server."""
        self.sock.sendall(struct.pack("<BI", 4, 0))
        return struct.unpack("<QQ", self._recv(16))

    def shutdown_server(self) -> None:
        self.sock.sendall(struct.pack("<BI", 5, 0))
        try:
            self._recv(1)
        except (ConnectionError, OSError):
            pass

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class RemoteTier:
    """``HostTier``-compatible tier held by ``len(addrs)`` table servers.

    ``addrs``: "host:port" endpoints (or one string); ids go to shard
    ``splitmix64(id) % len(addrs)``, which balances power-law ids.  Rows
    an unseen id reads are ``init_bias + init_std * N(0, 1)`` from the
    server's per-id initialiser (``seed``)."""

    def __init__(self, addrs, table: str, dim: int, init_std: float = 0.01,
                 seed: int = 0, init_bias: float = 0.0):
        if isinstance(addrs, str):
            addrs = [addrs]
        self.dim = dim
        self.conns = []
        try:
            for a in addrs:
                self.conns.append(_Conn(a, table, dim, init_std, seed,
                                        init_bias))
        except BaseException:
            self.close()
            raise

    def _split(self, ids: np.ndarray):
        """[(conn, positions)] of the shards that hold some of ``ids``."""
        if len(self.conns) == 1:
            return [(self.conns[0], None)]
        shard = _shard(ids, len(self.conns))
        return [(c, np.nonzero(shard == s)[0]) for s, c in enumerate(self.conns)
                if (shard == s).any()]

    def read(self, ids: np.ndarray) -> np.ndarray:
        ids = np.ascontiguousarray(np.asarray(ids, np.int64).reshape(-1))
        if ids.shape[0] == 0:
            return np.zeros((0, self.dim), np.float32)
        parts = self._split(ids)
        for c, pos in parts:
            c.send_read(ids if pos is None else ids[pos])
        if parts[0][1] is None:
            return parts[0][0].recv_rows(ids.shape[0])
        out = np.empty((ids.shape[0], self.dim), np.float32)
        for c, pos in parts:
            out[pos] = c.recv_rows(pos.shape[0])
        return out

    def write(self, ids: np.ndarray, rows: np.ndarray) -> None:
        ids = np.ascontiguousarray(np.asarray(ids, np.int64).reshape(-1))
        if ids.shape[0] == 0:
            return
        rows = np.asarray(rows, np.float32).reshape(ids.shape[0], self.dim)
        parts = self._split(ids)
        for c, pos in parts:
            if pos is None:
                c.send_write(ids, rows)
            else:
                c.send_write(ids[pos], rows[pos])
        for c, _pos in parts:
            c._recv(1)

    def flush(self) -> None:
        for c in self.conns:
            c.flush()

    def stats(self) -> list[tuple[int, int]]:
        """(RAM rows, SSD rows) per server."""
        return [c.stats() for c in self.conns]

    def close(self):
        for c in self.conns:
            c.close()


class _HashConn(_Conn):
    """One hash-store shard on one server (the ``MRHS`` handshake)."""

    def __init__(self, addr: str, name: str, capacity: int, slot_base: int,
                 permit: int, evict: int):
        self.addr = addr
        nm = _wire_name(name)
        self.sock = _connect(addr, TIMEOUT_S)
        self.sock.sendall(b"MRHS" + nm + struct.pack(
            "<qqqq", capacity, slot_base, permit, evict))
        if self._recv(8)[:4] != b"MRSV":
            self.close()
            raise ConnectionError(f"hash-store handshake failed for "
                                  f"{name}@{addr}")

    def _recv_i64(self, n: int) -> np.ndarray:
        out = np.empty(n, "<i8")
        self._recv_into(out)
        return out

    def send_lookup(self, keys: np.ndarray, force: bool) -> None:
        self.sock.sendall(struct.pack("<BIB", 10, keys.shape[0], int(force))
                          + keys.astype("<i8").tobytes())

    def evict(self) -> np.ndarray:
        self.sock.sendall(struct.pack("<BI", 11, 0))
        (m,) = struct.unpack("<I", self._recv(4))
        return self._recv_i64(m)

    def items(self):
        self.sock.sendall(struct.pack("<BI", 12, 0))
        (m,) = struct.unpack("<I", self._recv(4))
        return self._recv_i64(m), self._recv_i64(m)

    def erase(self, keys: np.ndarray):
        self.sock.sendall(struct.pack("<BI", 13, keys.shape[0])
                          + keys.astype("<i8").tobytes())
        self._recv(1)

    def size(self) -> int:
        self.sock.sendall(struct.pack("<BI", 14, 0))
        return struct.unpack("<Q", self._recv(8))[0]


class RemoteHashStore:
    """The dynamic regime's id -> slot map held by table servers: a
    drop-in for :class:`mindrec_tpu_torch.native.hashstore.HashStore`
    (``lookup_or_insert`` / ``evict`` / ``items`` / ``erase`` / ``len``).

    Server ``s`` owns the keys with ``splitmix64(key) % S == s`` and hands
    out slots in ``[s * (capacity // S), (s + 1) * (capacity // S))``, so
    every data-parallel worker sees one mapping.  Every call of
    ``lookup_or_insert`` advances every shard's step clock once, so one
    worker gets the local store's admission and eviction; with several
    workers each one's lookups advance the shared clocks, and thresholds
    count cluster steps (the reference's server-side clock)."""

    def __init__(self, addrs, name: str, capacity: int,
                 permit_threshold: int = 1, evict_threshold: int = 0x7FFFFFFF):
        if isinstance(addrs, str):
            addrs = [addrs]
        self.capacity = capacity
        cap_per = capacity // len(addrs)
        self.conns = []
        try:
            for s, a in enumerate(addrs):
                self.conns.append(_HashConn(a, name, cap_per, s * cap_per,
                                            permit_threshold, evict_threshold))
        except BaseException:
            self.close()
            raise

    def __len__(self):
        return sum(c.size() for c in self.conns)

    def lookup_or_insert(self, keys: np.ndarray, force: bool = False) -> np.ndarray:
        keys = np.ascontiguousarray(np.asarray(keys, np.int64).reshape(-1))
        shard = _shard(keys, len(self.conns))
        pos = [np.nonzero(shard == s)[0] for s in range(len(self.conns))]
        for c, p in zip(self.conns, pos):
            c.send_lookup(keys[p], force)  # empty where the shard has none
        out = np.empty(keys.shape[0], np.int64)
        for c, p in zip(self.conns, pos):
            out[p] = c._recv_i64(p.shape[0])
        return out

    def evict(self) -> np.ndarray:
        return np.concatenate([c.evict() for c in self.conns]).astype(np.int64)

    def items(self):
        ks, ss = zip(*[c.items() for c in self.conns])
        return (np.concatenate(ks).astype(np.int64),
                np.concatenate(ss).astype(np.int64))

    def erase(self, keys: np.ndarray):
        keys = np.ascontiguousarray(np.asarray(keys, np.int64).reshape(-1))
        shard = _shard(keys, len(self.conns))
        for s, c in enumerate(self.conns):
            m = shard == s
            if m.any():
                c.erase(keys[m])

    def close(self):
        for c in self.conns:
            c.close()


# ---------------------------------------------------------------------------
# server processes
# ---------------------------------------------------------------------------


def server_binary_path() -> Path:
    """The port's table server, built by g++ at first use (raises with the
    compiler's output on failure)."""
    return native_build.build_program("table_server", SRC, "table_server",
                                      headers=(HEADER,))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_table_server(port: int | None = None, ram_mb: int | None = None,
                        spill_dir: str | None = None,
                        wait_s: float = 10.0) -> subprocess.Popen:
    """Start a table server on localhost and wait until it accepts.

    ``port`` None (or 0) picks a free port, and another when the server
    finds it taken before it binds; the process's ``addr`` attribute is
    its "127.0.0.1:port".  ``ram_mb`` caps each table's RAM (else the
    env var ``MR_EMBEDDING_REMOTE_CACHE_MEMORY_SIZE``, in GB, else none);
    ``spill_dir`` holds the spill files (default ``$TMPDIR``).  Raises if
    the server exits or does not accept within ``wait_s``."""
    binary = server_binary_path()
    pick = not port
    for _ in range(PORT_TRIES if pick else 1):
        p = _free_port() if pick else port
        cmd = [str(binary), "--port", str(p)]
        if ram_mb is not None:
            cmd += ["--ram-mb", str(ram_mb)]
        if spill_dir is not None:
            cmd += ["--spill-dir", spill_dir]
        proc = subprocess.Popen(cmd)
        proc.addr = f"127.0.0.1:{p}"
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            try:
                socket.create_connection(("127.0.0.1", p), timeout=0.2).close()
                return proc
            except OSError:
                if proc.poll() is not None:
                    break
                time.sleep(0.02)
        if proc.poll() is None:
            proc.kill()
            proc.wait()
            raise TimeoutError(f"table server on :{p} did not come up")
        if proc.returncode != BIND_TAKEN_RC or not pick:
            raise RuntimeError(f"table server on :{p} exited rc={proc.returncode}")
    raise RuntimeError(f"no free port for a table server after {PORT_TRIES} "
                       f"tries")


def stop_table_server(addr: str, proc: subprocess.Popen | None = None) -> None:
    """Shut a server down through the protocol; with ``proc``, wait for it
    to exit and kill it if it has not within ``STOP_S``."""
    try:
        c = _Conn(addr, "__ctl__", 1, 0.0, 0, timeout_s=STOP_S)
        c.shutdown_server()
        c.close()
    except (OSError, ConnectionError):
        pass
    if proc is not None:
        try:
            proc.wait(timeout=STOP_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()

