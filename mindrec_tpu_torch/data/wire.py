"""Compact host->device wire format for transfer-bound links.

Port of ``mindrec_tpu/data/wire.py``.  A sparse-training batch is mostly
narrow integers dressed as wide ones: Criteo ids fit 23 bits but travel
as int32, sort metadata is bounded by ``B*F``, labels are one bit, and
feature weights tolerate bfloat16.  :class:`BatchWire` packs a batch on
the host (numpy, inside the prep pool; its bytes are the reference's,
byte for byte) and decodes it on the card with plain torch elementwise
ops, so the bytes staged per batch shrink and the decoded batch has the
layout, dtypes and shapes of the unpacked one (ids, labels and metadata
exactly; ``wts`` rounds to bf16 unless ``lossy=()``).

Codecs (per key, planned once from static bounds):

* ``int(bound)``: values in ``[0, bound)`` plus, for ``sentinel_keys``,
  the shared sentinel ``2**31 - 2``, which travels as code ``bound``;
  1, 2, 3 (little-endian bytes on a trailing axis) or 4 bytes;
* ``bf16``: floats rounded to bfloat16 (round to nearest even);
* ``bit``: {0, 1} floats as uint8;
* ``raw``: float32 / int32 bytes, bit-exact;
* ``fids`` / ``fwts`` (:meth:`BatchWire.for_fields`): ids stored relative
  to their field, each field at its own width, and only the weights of
  the columns whose weight varies;
* any other key passes through untouched.

Arena transport (the default) packs every planned key into ONE flat
uint8 buffer under :data:`ARENA_KEY`, so each batch is one staged copy.
A segment's offset in the arena need not be a multiple of 4, so the
decoder combines little-endian bytes (``_combine_le``) instead of
viewing a slice as a wider type.

:func:`measure_link` times the path the port's staging takes
(``data/criteo.py:stage_batch``: a pinned copy and an async copy on a
side stream, fenced by a synchronize); :func:`choose_prep` picks the
prep placement from it.
"""

from __future__ import annotations

import numpy as np
import torch

SENTINEL = np.int32(2**31 - 2)  # shared padding sentinel (train/step.py)
ARENA_KEY = "__wire__"


def _int_nbytes(n_codes: int) -> int:
    """Bytes per value to hold codes ``[0, n_codes]`` (inclusive: the
    sentinel code equals ``bound``)."""
    if n_codes < (1 << 8):
        return 1
    if n_codes < (1 << 16):
        return 2
    if n_codes < (1 << 24):
        return 3
    return 4


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16), rounded to nearest
    even; NaN becomes the quiet NaN of its sign (``ml_dtypes``' cast)."""
    f = np.ascontiguousarray(x, np.float32)
    u = f.view(np.uint32)
    # no overflow but for NaN inputs (u + 0x8000 <= 0xFF808000 otherwise),
    # which are replaced below
    with np.errstate(over="ignore"):
        out = ((u + np.uint32(0x7FFF) + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    nan = np.isnan(f)
    if nan.any():
        out[nan] = ((u[nan] >> 16) & 0x8000).astype(np.uint16) | 0x7FC0
    return out


class BatchWire:
    """Plan + host encoder + device decoder for one batch layout.

    ``bounds``: {key: exclusive int upper bound}.  Keys listed in
    ``sentinel_keys`` may also hold :data:`SENTINEL` (e.g. the padded
    ``uq_ids``).  ``lossy``: float keys sent as bf16.  ``bit``: {0,1}
    float keys sent as uint8.  ``raw``: keys carried bit-exactly
    (f32/i32) but still packed into the arena.  ``arena``: pack all
    planned keys into one u8 buffer (one staged copy per batch);
    unplanned keys always pass through as separate arrays.
    """

    def __init__(self, bounds: dict[str, int] | None = None,
                 sentinel_keys: tuple[str, ...] = (),
                 lossy: tuple[str, ...] = ("wts",),
                 bit: tuple[str, ...] = ("label",),
                 raw: tuple[str, ...] = (),
                 arena: bool = True):
        self.bounds = dict(bounds or {})
        self.sentinel_keys = tuple(sentinel_keys)
        self.lossy = tuple(lossy)
        self.bit = tuple(bit)
        self.raw = tuple(raw)
        self.arena = arena
        self.fids: dict = {}
        self.fwts: dict = {}
        self._layout = None  # [(key, kind, param, shape, dtype, off, nbytes)]
        self._sig = None
        for k in self.sentinel_keys:
            if k not in self.bounds:
                raise ValueError(f"sentinel key {k!r} needs a bound")

    def _kind(self, key: str):
        """-> (kind, param) or None for passthrough."""
        if key in self.fids:
            return ("fids", self.fids[key])
        if key in self.fwts:
            return ("fwts", self.fwts[key])
        if key in self.bounds:
            return ("int", self.bounds[key])
        if key in self.lossy:
            return ("bf16", None)
        if key in self.bit:
            return ("bit", None)
        if key in self.raw:
            return ("raw", None)
        return None

    # -- plan construction ------------------------------------------------

    @classmethod
    def for_sparse(cls, vocab_size: int, batch_size: int, field_size: int,
                   host_prep: bool = False, lossy_wts: bool = True,
                   arena: bool = True) -> "BatchWire":
        """Plan for the single-group Criteo sparse batch.

        ``host_prep=False``: raw batches (ids/wts/label), the device-prep
        mode.  ``host_prep=True``: also the minimal prep metadata
        (``perm``/``uidx``/``uidx_sorted`` bounded by ``B*F``; ``uq_ids``
        bounded by the vocab and sentinel-padded).
        """
        n = batch_size * field_size
        bounds = {"ids": int(vocab_size)}
        sent = ()
        if host_prep:
            bounds.update(perm=n, uidx=n, uidx_sorted=n,
                          uq_ids=int(vocab_size))
            sent = ("uq_ids",)
        return cls(bounds, sentinel_keys=sent,
                   lossy=("wts",) if lossy_wts else (),
                   raw=() if lossy_wts else ("wts",), arena=arena)

    @classmethod
    def for_fields(cls, field_sizes, batch_size: int,
                   wt_value_fields=(), lossy_wts: bool = True,
                   validate: bool = True) -> "BatchWire":
        """Schema-aware plan: per-FIELD id widths + value-only weights.

        ``field_sizes``: per-field id-range sizes (the preprocessing
        stats, or :func:`~mindrec_tpu_torch.data.criteo.criteo_field_sizes`);
        ids travel field-relative, so a 64-bucket dense column costs one
        byte.  ``wt_value_fields``: columns whose weight varies; the
        others decode as the constant 1.0.  Arena transport only."""
        del batch_size
        sizes = np.asarray(field_sizes, np.int64)
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        widths = np.array([_int_nbytes(int(s)) for s in sizes], np.int64)
        w = cls({}, lossy=(), bit=("label",), arena=True)
        w.fids = {"ids": (offsets, sizes, widths, bool(validate))}
        w.fwts = {"wts": (tuple(int(c) for c in wt_value_fields),
                          int(sizes.size), bool(lossy_wts))}
        w.field_sizes = sizes
        return w

    # -- host side --------------------------------------------------------

    def encode(self, batch: dict) -> dict:
        """numpy batch -> packed numpy batch (a new dict; passthrough
        keys share their arrays).  Arena mode returns the planned keys
        as one flat uint8 buffer under :data:`ARENA_KEY`."""
        if not self.arena:
            out = {}
            for k, v in batch.items():
                kp = self._kind(k)
                if kp is None or kp[0] == "raw":
                    out[k] = v
                elif kp[0] == "int":
                    out[k] = self._encode_int(k, np.asarray(v))
                elif kp[0] == "bf16":
                    out[k] = bf16_bits(np.asarray(v))
                else:  # bit
                    out[k] = np.asarray(v).astype(np.uint8)
            return out
        out, segs, layout, off = {}, [], [], 0
        for k in sorted(batch):
            v = np.asarray(batch[k])
            kp = self._kind(k)
            if kp is None:
                out[k] = batch[k]
                continue
            b = self._encode_bytes(k, v, kp)
            layout.append((k, kp[0], kp[1], v.shape, str(v.dtype), off, b.size))
            segs.append(b)
            off += b.size
        sig = tuple((l[0], l[3], l[4]) for l in layout)
        if self._layout is None:
            self._layout, self._sig = layout, sig
        elif sig != self._sig:
            raise ValueError(
                "arena layout changed between batches (key/shape/dtype "
                "drift); the wire plans a static layout"
            )
        out[ARENA_KEY] = (
            np.concatenate(segs) if segs else np.zeros(0, np.uint8)
        )
        return out

    def _encode_bytes(self, key: str, v: np.ndarray, kp) -> np.ndarray:
        """One planned key -> flat little-endian uint8 segment."""
        kind, param = kp
        if kind == "fids":
            offsets, sizes, widths, validate = param
            rel = v.astype(np.int64) - offsets[None, :]
            if validate and (
                (rel < 0).any() or (rel >= sizes[None, :]).any()
            ):
                bad = np.argwhere((rel < 0) | (rel >= sizes[None, :]))[0]
                raise ValueError(
                    f"id out of its field range at (row, field)="
                    f"{tuple(bad)}: field sizes say "
                    f"[{offsets[bad[1]]}, {offsets[bad[1]] + sizes[bad[1]]})"
                )
            segs = []
            for w in (1, 2, 3, 4):
                cols = np.flatnonzero(widths == w)
                if cols.size == 0:
                    continue
                sub = np.ascontiguousarray(rel[:, cols])
                segs.append(_le_bytes(sub, w))
            return np.concatenate(segs)
        if kind == "fwts":
            value_cols, _F, lossy_wts = param
            sub = np.ascontiguousarray(v[:, list(value_cols)])
            if lossy_wts:
                return bf16_bits(sub).view(np.uint8).reshape(-1)
            return sub.astype(np.float32).view(np.uint8).reshape(-1)
        if kind == "int":
            e = self._encode_int(key, v)
            if e.dtype == np.uint8 and e.ndim == v.ndim + 1:
                return e.reshape(-1)  # 3-byte lane, already bytes
            return np.ascontiguousarray(e).view(np.uint8).reshape(-1)
        if kind == "bf16":
            return bf16_bits(v).view(np.uint8).reshape(-1)
        if kind == "bit":
            return v.astype(np.uint8).reshape(-1)
        # raw: bit-exact bytes
        if v.dtype not in (np.float32, np.int32):
            raise ValueError(f"raw wire key {key!r} must be f32/i32, "
                             f"got {v.dtype}")
        return np.ascontiguousarray(v).view(np.uint8).reshape(-1)

    def _encode_int(self, key: str, v: np.ndarray) -> np.ndarray:
        bound = self.bounds[key]
        if key in self.sentinel_keys:
            v = np.where(v == SENTINEL, np.int32(bound), v.astype(np.int32))
        nb = _int_nbytes(bound)
        if nb == 1:
            return v.astype(np.uint8)
        if nb == 2:
            return v.astype(np.uint16)
        if nb == 3:
            # little-endian 3-byte split on a new trailing axis
            b = np.ascontiguousarray(v.astype("<i4")).view(np.uint8)
            return b.reshape(v.shape + (4,))[..., :3].copy()
        return v.astype(np.int32)

    def wire_bytes(self, batch: dict) -> int:
        """Payload size of ``encode(batch)`` without encoding it."""
        total = 0
        for k, v in batch.items():
            a = np.asarray(v)
            kp = self._kind(k)
            if kp is None or kp[0] == "raw":
                total += a.nbytes
            elif kp[0] == "int":
                total += a.size * _int_nbytes(kp[1])
            elif kp[0] == "bf16":
                total += a.size * 2
            elif kp[0] == "fids":
                total += a.shape[0] * int(kp[1][2].sum())
            elif kp[0] == "fwts":
                total += a.shape[0] * len(kp[1][0]) * (2 if kp[1][2] else 4)
            else:
                total += a.size
        return total

    # -- device side ------------------------------------------------------

    def decoder(self):
        """-> ``decode(packed_batch) -> batch`` restoring the int32 / f32
        layouts with torch ops on the tensors' device (numpy inputs are
        taken as CPU tensors).  The decode reads nothing back to the
        host, so it can run inside a captured CUDA graph (the fused
        superbatch step, ``train/rec_model.py``); the constants it
        needs are made on each device's first call, outside a capture.
        In arena mode the layout is planned by the first :meth:`encode`,
        which must come first (the pipeline decodes what it encoded)."""
        bounds, sent = self.bounds, set(self.sentinel_keys)
        lossy, bit = set(self.lossy), set(self.bit)
        consts: dict = {}  # (device, name) -> constant tensor

        def const(dev, name, make):
            key = (str(dev), name)
            if key not in consts:
                consts[key] = torch.as_tensor(make(), device=dev)
            return consts[key]

        def restore_sentinel(k, v):
            if k in sent:
                v = torch.where(v == int(bounds[k]),
                                torch.full_like(v, int(SENTINEL)), v)
            return v

        def dec_fids(seg, param, shape, key):
            offsets, _sizes, widths, _validate = param
            B = shape[0]
            parts, perm, o = [], [], 0
            for w in (1, 2, 3, 4):
                cols = np.flatnonzero(widths == w)
                if cols.size == 0:
                    continue
                nb = B * cols.size * w
                sub = seg[o:o + nb]
                o += nb
                if w == 1:
                    v = sub.to(torch.int32)
                else:
                    v = _int32_bits(_combine_le(sub.reshape(-1, w), w))
                off = const(seg.device, (key, "off", w), lambda: offsets[cols]
                            .astype(np.int32)[None, :])
                parts.append(v.reshape(B, cols.size) + off)
                perm.extend(cols.tolist())
            inv = const(seg.device, (key, "inv"),
                        lambda: np.argsort(np.asarray(perm)))
            return torch.cat(parts, dim=1).index_select(1, inv)

        def dec_fwts(seg, param, shape, key):
            value_cols, F, lossy_wts = param
            B = shape[0]
            if value_cols:
                if lossy_wts:
                    vals = _bf16_from_bits(_combine_le(seg.reshape(-1, 2), 2))
                else:
                    vals = _int32_bits(_combine_le(seg.reshape(-1, 4), 4)).view(
                        torch.float32)
                vals = vals.reshape(B, len(value_cols))
            else:
                vals = torch.zeros((B, 0), dtype=torch.float32,
                                   device=seg.device)
            const_cols = [c for c in range(F) if c not in set(value_cols)]
            ones = torch.ones((B, len(const_cols)), dtype=torch.float32,
                              device=seg.device)
            inv = const(seg.device, (key, "inv"), lambda: np.argsort(
                np.asarray(list(value_cols) + const_cols)))
            return torch.cat([vals, ones], dim=1).index_select(1, inv)

        def decode_arena(batch: dict) -> dict:
            out = {k: v for k, v in batch.items() if k != ARENA_KEY}
            buf = _tensor(batch[ARENA_KEY])
            for k, kind, param, shape, dtype, off, nb in self._layout:
                seg = buf[off:off + nb]
                if kind == "fids":
                    out[k] = dec_fids(seg, param, shape, k)
                elif kind == "fwts":
                    out[k] = dec_fwts(seg, param, shape, k)
                elif kind == "int":
                    w = _int_nbytes(param)
                    if w == 1:
                        v = seg.to(torch.int32)
                    else:
                        v = _int32_bits(_combine_le(seg.reshape(-1, w), w))
                    out[k] = restore_sentinel(k, v).reshape(shape)
                elif kind == "bf16":
                    v = _bf16_from_bits(_combine_le(seg.reshape(-1, 2), 2))
                    out[k] = v.reshape(shape)
                elif kind == "bit":
                    out[k] = seg.to(torch.float32).reshape(shape)
                else:  # raw f32/i32 (little-endian 4-byte lanes)
                    v = _int32_bits(_combine_le(seg.reshape(-1, 4), 4))
                    if dtype == "float32":
                        v = v.view(torch.float32)
                    out[k] = v.reshape(shape)
            return out

        def decode(batch: dict) -> dict:
            if ARENA_KEY in batch:
                return decode_arena(batch)
            out = {}
            for k, v in batch.items():
                if k in bounds:
                    v = _tensor(v)
                    if _int_nbytes(bounds[k]) == 3:
                        shp = v.shape[:-1]
                        v = _int32_bits(_combine_le(v.reshape(-1, 3), 3))
                        v = v.reshape(shp)
                    else:
                        v = _widen(v)
                    out[k] = restore_sentinel(k, v)
                elif k in lossy:
                    v = _tensor(v)
                    if v.dtype == torch.uint16:  # bf16 bit patterns
                        v = v.view(torch.int16).view(torch.bfloat16)
                    out[k] = v.to(torch.float32)
                elif k in bit:
                    out[k] = _tensor(v).to(torch.float32)
                else:
                    out[k] = v
            return out

        return decode


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def _le_bytes(sub: np.ndarray, w: int) -> np.ndarray:
    """Field-relative ids -> their ``w`` little-endian bytes, flat."""
    if w == 1:
        return sub.astype(np.uint8).reshape(-1)
    if w == 2:
        return sub.astype(np.uint16).view(np.uint8).reshape(-1)
    if w == 3:
        b = np.ascontiguousarray(sub.astype("<i4")).view(np.uint8)
        return b.reshape(sub.shape + (4,))[..., :3].copy().reshape(-1)
    return sub.astype(np.int32).view(np.uint8).reshape(-1)


def _combine_le(b: torch.Tensor, n: int) -> torch.Tensor:
    """[N, n] uint8 -> [N] int64, little-endian (an unsigned value)."""
    v = b[:, 0].to(torch.int64)
    for i in range(1, n):
        v = v | (b[:, i].to(torch.int64) << (8 * i))
    return v


def _int32_bits(v: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values held in int64 -> the int32 of those bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _bf16_from_bits(v: torch.Tensor) -> torch.Tensor:
    """bfloat16 bit patterns held in int64 -> float32.  torch has few
    ops on uint16, so the patterns are narrowed to int16 and viewed."""
    v = torch.where(v >= 2**15, v - 2**16, v).to(torch.int16)
    return v.view(torch.bfloat16).to(torch.float32)


def _widen(v: torch.Tensor) -> torch.Tensor:
    """A 1-, 2- or 4-byte code tensor -> int32 codes."""
    if v.dtype == torch.uint16:
        return v.view(torch.int16).to(torch.int32) & 0xFFFF
    return v.to(torch.int32)


# ---------------------------------------------------------------------------
# prep placement policy
# ---------------------------------------------------------------------------


def _cuda_device(device) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("measuring the host->device link needs a CUDA "
                           "device")
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())
    if dev.type != "cuda":
        raise ValueError(f"the link is measured to a CUDA device, got {dev}")
    return dev


def _put_s(buf: np.ndarray, dev, stream, reps: int) -> float:
    """Seconds per staged copy of ``buf`` (``stage_batch``, fenced by a
    synchronize)."""
    import time

    from mindrec_tpu_torch.data.criteo import stage_batch

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        stage_batch({"x": buf}, dev, stream)
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / reps


def measure_bandwidth(nbytes: int = 8 << 20, device=None, warm: int = 1,
                      reps: int = 2) -> float:
    """Host->device bandwidth in bytes/s of the port's staging path."""
    dev = _cuda_device(device)
    stream = torch.cuda.Stream(dev)
    buf = np.random.default_rng(0).integers(0, 255, size=nbytes,
                                            dtype=np.uint8)
    for _ in range(warm):
        _put_s(buf[: 1 << 20], dev, stream, 1)
    return nbytes / max(_put_s(buf, dev, stream, reps), 1e-9)


def measure_link(device=None, small: int = 256 << 10, big: int = 8 << 20,
                 reps: int = 2) -> tuple[float, float]:
    """Measure the host->device link as (fixed_ms_per_put, bytes_per_s).

    Two fenced staged copies (``data/criteo.py:stage_batch``, the path
    ``PrefetchToDevice`` takes) at two sizes solve the affine model
    ``t = fixed + size / bw``; drives ``RecModel(input_recipe="auto")``."""
    dev = _cuda_device(device)
    stream = torch.cuda.Stream(dev)
    buf = np.random.default_rng(0).integers(0, 255, size=big, dtype=np.uint8)
    _put_s(buf[: 1 << 16], dev, stream, 1)  # warm the path
    t1 = _put_s(buf[:small], dev, stream, reps)
    t2 = _put_s(buf, dev, stream, reps)
    bw = (big - small) / max(t2 - t1, 1e-6)
    fixed_ms = max(0.0, (t1 - small / bw) * 1e3)
    return fixed_ms, bw


def choose_prep(host_step_ms: float, device_step_ms: float, prep_ms: float,
                host_payload: int, device_payload: int, bandwidth: float,
                workers: int = 1) -> str:
    """Pick the prep placement that maximizes sustained batches/s.

    ``host``: prep on the host: the smaller step (``host_step_ms``), but
    the sort metadata rides the link (``host_payload`` bytes/batch).
    ``device``: ship only raw / encoded batches (``device_payload``) and
    sort inside the step (``device_step_ms``).  Each mode's sustained
    time per batch is max(step, prep / workers, copy).  Returns
    ``"host"`` or ``"device"``.
    """
    host_t = max(host_step_ms, prep_ms / max(workers, 1),
                 host_payload / bandwidth * 1e3)
    dev_t = max(device_step_ms, device_payload / bandwidth * 1e3)
    return "host" if host_t <= dev_t else "device"
