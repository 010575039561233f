"""On-disk dataset formats: TFRecord and H5.

Port of ``mindrec_tpu/data/formats.py`` (numpy only), so the files one
package writes the other reads, byte for byte.  The reference's three
formats (``DataType`` PACKED / TFRECORD / H5) share one record schema:
``feat_ids`` (int), ``feat_vals`` (float), ``label`` (float), packed
1000 samples per record.

* ``write_tfrecord`` / ``read_tfrecord``: the TFRecord framing (u64
  length + masked crc32c, payload + masked crc32c) and a minimal
  ``tf.train.Example`` protobuf codec for int64 / float / bytes lists.
* ``TFRecordCriteoDataset``: a batch of B samples is B / line_per_sample
  packed records; files are sharded by ``(num_shards, shard_id)``.
* ``H5CriteoDataset``: file pairs ``{prefix}_input_part_{p}.h5`` /
  ``{prefix}_output_part_{p}.h5``, iterated as an endless stream of
  blocks unless ``max_rounds`` bounds it.  ``h5py`` is imported at use.
* ``DataType`` + ``create_dataset``: the dispatch of the reference's
  entry point.

``crc32c`` is a table-driven software CRC; the ``crc32c`` package takes
its place where it is installed.
"""

from __future__ import annotations

import enum
import os
import struct
from pathlib import Path
from typing import Iterator

import numpy as np

# ---------------------------------------------------------------------------
# crc32c (software, table-driven) + TFRecord masking
# ---------------------------------------------------------------------------

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78  # Castagnoli, reflected
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = np.array(table, dtype=np.uint32)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = np.uint32(0xFFFFFFFF)
    arr = np.frombuffer(data, dtype=np.uint8)
    # chunked python loop over a numpy table: fast enough for metadata +
    # tests; bulk payloads go through _crc32c_bulk below
    for b in arr:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> np.uint32(8))
    return int(crc ^ np.uint32(0xFFFFFFFF))


try:  # zlib-style accelerated crc32c if present (python >= 3.12: zlib.crc32 is crc32, not c)
    from crc32c import crc32c as _fast_crc32c  # type: ignore

    def crc32c(data: bytes) -> int:  # noqa: F811
        return _fast_crc32c(data)
except Exception:
    pass


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal tf.train.Example wire codec
#
# Example          : field 1 (features)  -> Features
# Features         : field 1 (feature)   -> map<string, Feature> entries
# map entry        : field 1 key (string), field 2 value (Feature)
# Feature          : field 1 BytesList | 2 FloatList | 3 Int64List
# BytesList        : repeated field 1 (bytes)
# FloatList        : repeated field 1 (float)  [packed]
# Int64List        : repeated field 1 (varint) [packed]
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _len_delim(field_no: int, payload: bytes) -> bytes:
    return _varint(field_no << 3 | 2) + _varint(len(payload)) + payload


def _encode_feature(value) -> bytes:
    """numpy array / list -> Feature message bytes."""
    arr = np.asarray(value)
    if arr.dtype.kind in ("i", "u"):
        ints = arr.reshape(-1).astype(np.int64)
        body = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in ints)
        inner = _len_delim(1, body)  # packed varints
        return _len_delim(3, inner)  # Int64List
    if arr.dtype.kind == "f":
        body = arr.reshape(-1).astype("<f4").tobytes()
        inner = _len_delim(1, body)  # packed floats
        return _len_delim(2, inner)  # FloatList
    if arr.dtype.kind in ("S", "O", "U"):
        items = [
            v if isinstance(v, bytes) else str(v).encode() for v in arr.reshape(-1)
        ]
        inner = b"".join(_len_delim(1, it) for it in items)
        return _len_delim(1, inner)  # BytesList
    raise TypeError(f"unsupported feature dtype {arr.dtype}")


def encode_example(features: dict[str, np.ndarray]) -> bytes:
    entries = b""
    for key, value in features.items():
        entry = _len_delim(1, key.encode()) + _len_delim(2, _encode_feature(value))
        entries += _len_delim(1, entry)  # map entry in Features.feature
    return _len_delim(1, entries)  # Example.features


def _decode_feature(buf: bytes):
    """Feature message bytes -> np array."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        assert wire == 2, (field, wire)
        ln, pos = _read_varint(buf, pos)
        payload = buf[pos : pos + ln]
        pos += ln
        if field == 3:  # Int64List
            return _decode_scalar_list(payload, kind="int")
        if field == 2:  # FloatList
            return _decode_scalar_list(payload, kind="float")
        if field == 1:  # BytesList
            out = []
            p2 = 0
            while p2 < len(payload):
                t2, p2 = _read_varint(payload, p2)
                assert t2 >> 3 == 1
                l2, p2 = _read_varint(payload, p2)
                out.append(payload[p2 : p2 + l2])
                p2 += l2
            return np.array(out, dtype=object)
    return np.array([])


def _decode_scalar_list(payload: bytes, kind: str):
    """Int64List/FloatList body: packed or repeated field-1 entries."""
    vals = []
    pos = 0
    while pos < len(payload):
        tag, pos = _read_varint(payload, pos)
        field, wire = tag >> 3, tag & 7
        assert field == 1, field
        if wire == 2:  # packed
            ln, pos = _read_varint(payload, pos)
            end = pos + ln
            if kind == "float":
                vals.extend(np.frombuffer(payload[pos:end], dtype="<f4"))
                pos = end
            else:
                while pos < end:
                    v, pos = _read_varint(payload, pos)
                    vals.append(v - (1 << 64) if v >= 1 << 63 else v)
        elif wire == 5 and kind == "float":  # unpacked float
            vals.append(struct.unpack("<f", payload[pos : pos + 4])[0])
            pos += 4
        elif wire == 0 and kind == "int":  # unpacked varint
            v, pos = _read_varint(payload, pos)
            vals.append(v - (1 << 64) if v >= 1 << 63 else v)
        else:
            raise ValueError(f"bad wire type {wire} for {kind}")
    dtype = np.float32 if kind == "float" else np.int64
    return np.asarray(vals, dtype=dtype)


def decode_example(buf: bytes) -> dict[str, np.ndarray]:
    pos = 0
    out: dict[str, np.ndarray] = {}
    tag, pos = _read_varint(buf, pos)
    assert tag >> 3 == 1 and tag & 7 == 2, "not an Example"
    ln, pos = _read_varint(buf, pos)
    feats = buf[pos : pos + ln]
    pos = 0
    while pos < len(feats):
        tag, pos = _read_varint(feats, pos)
        assert tag >> 3 == 1 and tag & 7 == 2
        ln, pos = _read_varint(feats, pos)
        entry = feats[pos : pos + ln]
        pos += ln
        # map entry: key (field 1), value (field 2)
        p2 = 0
        key = None
        val = None
        while p2 < len(entry):
            t2, p2 = _read_varint(entry, p2)
            l2, p2 = _read_varint(entry, p2)
            body = entry[p2 : p2 + l2]
            p2 += l2
            if t2 >> 3 == 1:
                key = body.decode()
            else:
                val = _decode_feature(body)
        if key is not None:
            out[key] = val
    return out


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------


def write_tfrecord(path: str | os.PathLike, examples: Iterator[dict[str, np.ndarray]]):
    """Write dicts of arrays as tf.train.Example records."""
    n = 0
    with open(path, "wb") as f:
        for ex in examples:
            payload = encode_example(ex)
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(payload)
            f.write(struct.pack("<I", _masked_crc(payload)))
            n += 1
    return n


def read_tfrecord(
    path: str | os.PathLike, verify_crc: bool = False
) -> Iterator[dict[str, np.ndarray]]:
    """Iterate decoded Examples from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            hcrc = f.read(4)
            payload = f.read(length)
            pcrc = f.read(4)
            if len(payload) < length:
                raise EOFError(f"truncated record in {path}")
            if verify_crc:
                if struct.unpack("<I", hcrc)[0] != _masked_crc(header):
                    raise IOError(f"header crc mismatch in {path}")
                if struct.unpack("<I", pcrc)[0] != _masked_crc(payload):
                    raise IOError(f"payload crc mismatch in {path}")
            yield decode_example(payload)


# ---------------------------------------------------------------------------
# criteo-schema datasets over the two formats
# ---------------------------------------------------------------------------

LINE_PER_SAMPLE = 1000  # reference packing factor (datasets.py:262)


def write_criteo_tfrecords(
    out_dir: str | os.PathLike,
    batches: Iterator[dict[str, np.ndarray]],
    records_per_file: int = 64,
    line_per_sample: int = LINE_PER_SAMPLE,
) -> int:
    """Pack a sample stream into part-*.tfrecord files with the reference
    schema: one record = ``line_per_sample`` samples, features
    ``feat_ids``/``feat_vals``/``label`` (``datasets.py:242-244``)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    buf_i: list[np.ndarray] = []
    buf_w: list[np.ndarray] = []
    buf_l: list[np.ndarray] = []
    pending: list[dict[str, np.ndarray]] = []
    nfile = 0

    def flush_file():
        nonlocal nfile, pending
        if pending:
            write_tfrecord(out / f"part-{nfile:05d}.tfrecord", iter(pending))
            nfile += 1
            pending = []

    for batch in batches:
        for i in range(batch["ids"].shape[0]):
            buf_i.append(batch["ids"][i])
            buf_w.append(batch["wts"][i])
            buf_l.append(batch["label"][i])
            if len(buf_i) == line_per_sample:
                pending.append(
                    {
                        "feat_ids": np.stack(buf_i).astype(np.int64),
                        "feat_vals": np.stack(buf_w).astype(np.float32),
                        "label": np.stack(buf_l).astype(np.float32),
                    }
                )
                buf_i, buf_w, buf_l = [], [], []
                if len(pending) == records_per_file:
                    flush_file()
    flush_file()
    return nfile


class TFRecordCriteoDataset:
    """Batches from part-*.tfrecord shards, reference semantics: a batch
    of B samples = B / line_per_sample packed records, files sharded by
    (num_shards, shard_id) (``datasets.py:304-320``)."""

    def __init__(
        self,
        data_dir: str | os.PathLike,
        batch_size: int,
        field_size: int = 39,
        num_shards: int = 1,
        shard_id: int = 0,
        line_per_sample: int = LINE_PER_SAMPLE,
    ):
        if batch_size % line_per_sample != 0:
            raise ValueError(
                f"batch_size ({batch_size}) must be a multiple of "
                f"line_per_sample ({line_per_sample})"
            )
        self.files = sorted(Path(data_dir).glob("part-*.tfrecord"))
        if not self.files:
            raise FileNotFoundError(f"no part-*.tfrecord under {data_dir}")
        self.batch_size = batch_size
        self.field_size = field_size
        self.rows_per_batch = batch_size // line_per_sample
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.line_per_sample = line_per_sample

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        pend: list[dict[str, np.ndarray]] = []
        f = self.field_size
        for fi, path in enumerate(self.files):
            if fi % self.num_shards != self.shard_id:
                continue
            for rec in read_tfrecord(path):
                pend.append(rec)
                if len(pend) == self.rows_per_batch:
                    yield {
                        "ids": np.concatenate(
                            [r["feat_ids"].reshape(-1, f) for r in pend]
                        ).astype(np.int32),
                        "wts": np.concatenate(
                            [r["feat_vals"].reshape(-1, f) for r in pend]
                        ).astype(np.float32),
                        "label": np.concatenate(
                            [r["label"].reshape(-1, 1) for r in pend]
                        ).astype(np.float32),
                    }
                    pend = []


class H5CriteoDataset:
    """The reference's H5 layout: pairs ``{prefix}_input_part_{p}.h5``
    (X: ids columns then vals columns) / ``{prefix}_output_part_{p}.h5``
    (y), iterated as an **endless** stream of blocks that restarts when
    the parts are exhausted (``datasets.py:74-98``).  Set
    ``max_rounds=1`` for a bounded (eval) pass."""

    def __init__(
        self,
        data_dir: str | os.PathLike,
        batch_size: int,
        field_size: int = 39,
        train_mode: bool = True,
        num_parts: int | None = None,
        max_rounds: int | None = None,
        shuffle: bool = False,
        seed: int = 0,
    ):
        import h5py  # deferred: optional dependency

        self._h5py = h5py
        self.data_dir = Path(data_dir)
        self.prefix = "train" if train_mode else "test"
        self.batch_size = batch_size
        self.field_size = field_size
        self.max_rounds = max_rounds
        self.shuffle = shuffle
        self.seed = seed
        if num_parts is None:
            num_parts = len(list(self.data_dir.glob(f"{self.prefix}_input_part_*.h5")))
        if num_parts == 0:
            raise FileNotFoundError(
                f"no {self.prefix}_input_part_*.h5 under {data_dir}"
            )
        self.num_parts = num_parts

    @staticmethod
    def write_parts(
        out_dir: str | os.PathLike,
        batches: Iterator[dict[str, np.ndarray]],
        samples_per_part: int,
        prefix: str = "train",
    ) -> int:
        """Materialize a sample stream as H5 part pairs."""
        import h5py

        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        xs, ys, part, acc = [], [], 0, 0

        def flush():
            nonlocal xs, ys, part, acc
            if not xs:
                return
            X = np.concatenate(xs)
            Y = np.concatenate(ys)
            with h5py.File(out / f"{prefix}_input_part_{part}.h5", "w") as f:
                f.create_dataset("X", data=X)
            with h5py.File(out / f"{prefix}_output_part_{part}.h5", "w") as f:
                f.create_dataset("y", data=Y)
            xs, ys, part, acc = [], [], part + 1, 0

        for batch in batches:
            x = np.concatenate(
                [batch["ids"].astype(np.float64), batch["wts"].astype(np.float64)],
                axis=1,
            )
            xs.append(x)
            ys.append(batch["label"].reshape(-1, 1).astype(np.float64))
            acc += x.shape[0]
            if acc >= samples_per_part:
                flush()
        flush()
        return part

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        f = self.field_size
        rng = np.random.default_rng(self.seed)
        rounds = 0
        while self.max_rounds is None or rounds < self.max_rounds:
            parts = np.arange(self.num_parts)
            if self.shuffle:
                rng.shuffle(parts)
            for p in parts:
                with self._h5py.File(
                    self.data_dir / f"{self.prefix}_input_part_{p}.h5", "r"
                ) as fx:
                    X = np.asarray(fx["X"])
                with self._h5py.File(
                    self.data_dir / f"{self.prefix}_output_part_{p}.h5", "r"
                ) as fy:
                    Y = np.asarray(fy["y"])
                order = np.arange(X.shape[0])
                if self.shuffle:
                    rng.shuffle(order)
                for s in range(0, X.shape[0] - self.batch_size + 1, self.batch_size):
                    sel = order[s : s + self.batch_size]
                    yield {
                        "ids": X[sel, :f].astype(np.int32),
                        "wts": X[sel, f:].astype(np.float32),
                        "label": Y[sel].reshape(-1, 1).astype(np.float32),
                    }
            rounds += 1


# ---------------------------------------------------------------------------
# dispatch (reference datasets.py:28-35,449)
# ---------------------------------------------------------------------------


class DataType(enum.Enum):
    PACKED = 1  # native packed .npz (the reference's MINDRECORD slot)
    TFRECORD = 2
    H5 = 3


def create_dataset(
    data_dir: str | os.PathLike,
    batch_size: int,
    data_type: DataType = DataType.PACKED,
    field_size: int = 39,
    num_shards: int = 1,
    shard_id: int = 0,
    line_per_sample: int = LINE_PER_SAMPLE,
    train_mode: bool = True,
):
    """Reference-parity dataset factory (``datasets.py:449-488``)."""
    if data_type == DataType.PACKED:
        from mindrec_tpu_torch.data.criteo import PackedCriteoDataset

        return PackedCriteoDataset(
            data_dir, batch_size, num_shards=num_shards, shard_id=shard_id,
            line_per_sample=line_per_sample,
        )
    if data_type == DataType.TFRECORD:
        return TFRecordCriteoDataset(
            data_dir, batch_size, field_size=field_size, num_shards=num_shards,
            shard_id=shard_id, line_per_sample=line_per_sample,
        )
    if data_type == DataType.H5:
        return H5CriteoDataset(
            data_dir, batch_size, field_size=field_size, train_mode=train_mode,
            max_rounds=1,
        )
    raise ValueError(f"unknown data_type {data_type}")
