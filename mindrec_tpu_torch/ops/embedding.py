"""Embedding table specs and storage helpers.

Port of the parts of ``mindrec_tpu/ops/embedding.py`` that the steps
need: :class:`EmbeddingTableSpec` (layout arithmetic), ``_init_rows``,
``to_storage`` / ``from_storage``, the row_packed ``packed_gather`` /
``packed_expand``, the lookup of every layout with the ``max_norm``
clip (:func:`lookup`, the reference's ``EmbeddingLookup.__call__``),
logical row reads and in-place writes in every layout (:func:`read_rows`,
:func:`write_rows`) and the dynamic-vocabulary lookup
(:class:`HashEmbeddingLookup`).  Storage
layouts are bit-identical to the reference, so tables convert between
the two packages by a plain copy (``convert.py``).

* row_packed storage is ``[packed_rows, 128]``: logical row ``i`` lives
  in lanes ``[(i % pack) * emb_dim, (i % pack + 1) * emb_dim)`` of
  storage row ``i // pack``.
* feature_major storage is ``[padded_dim, padded_vocab // fold]``: the
  vocab axis is minor-most; ``fold`` (8 for ``emb_dim == 1``, else 1)
  logical rows share a storage column, logical row ``i`` living at
  sublanes ``[(i % fold) * emb_dim, (i % fold + 1) * emb_dim)`` of
  column ``i // fold``; sublanes past ``emb_dim`` (``fold == 1``) are
  zero padding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """Storage dtype name of a spec or config -> torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def _init_rows(generator: torch.Generator, shape, method: str, init_args,
               device) -> torch.Tensor:
    if method == "normal":
        return 0.01 * torch.randn(shape, generator=generator,
                                  dtype=torch.float32, device=device)
    if method == "uniform":
        lo, hi = init_args
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=device)
        return lo + (hi - lo) * u
    if method == "zero":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if method == "one":
        return torch.ones(shape, dtype=torch.float32, device=device)
    raise ValueError(f"unknown init method: {method}")


@dataclasses.dataclass(frozen=True)
class EmbeddingTableSpec:
    """Static description of one embedding table (reference field names
    and defaults).  See ``mindrec_tpu/ops/embedding.py`` for the layout
    rationale; the arithmetic here is a copy of it."""

    vocab_size: int
    emb_dim: int
    name: str = "embedding"
    slice_mode: str = "none"
    target: str = "device"
    sparse: bool = False
    init: str = "normal"
    init_args: tuple = (-0.01, 0.01)
    max_norm: Optional[float] = None
    dtype: str = "float32"
    layout: str = "auto"
    row_alignment: int = 8192

    @property
    def padded_vocab(self) -> int:
        """Logical rows: +1 dummy row, +7 spare, rounded to the alignment."""
        n = self.vocab_size + 8
        a = self.row_alignment
        return (n + a - 1) // a * a

    @property
    def dummy_id(self) -> int:
        return self.vocab_size

    @property
    def row_packed(self) -> bool:
        if not self.sparse or self.emb_dim > 128:
            return False
        if self.layout == "row_packed":
            return True
        if self.layout == "feature_major":
            return False
        return self.slice_mode == "none" and self.target == "device"

    @property
    def feature_major(self) -> bool:
        return self.sparse and not self.row_packed

    @property
    def pack(self) -> int:
        """Logical rows per 128-lane storage row (a power of two)."""
        if not self.row_packed:
            return 1
        p = 1
        while p * 2 * self.emb_dim <= 128 and p * 2 <= 128:
            p *= 2
        return p

    @property
    def packed_rows(self) -> int:
        """Storage rows of the row_packed layout, a multiple of 2048."""
        n = -(-self.padded_vocab // self.pack)
        return (n + 2047) // 2048 * 2048

    @property
    def fold(self) -> int:
        """Logical rows per feature-major storage column (8 for scalar
        tables)."""
        if not self.feature_major:
            return 1
        return 8 if self.emb_dim == 1 else 1

    @property
    def padded_dim(self) -> int:
        """Feature-major sublane count: emb_dim rounded up to 8."""
        if not self.feature_major:
            return self.emb_dim
        return max(8, (self.emb_dim + 7) // 8 * 8) if self.fold == 1 else 8

    @property
    def storage_shape(self) -> tuple[int, int]:
        if self.row_packed:
            return (self.packed_rows, 128)
        if self.feature_major:
            return (self.padded_dim, self.padded_vocab // self.fold)
        return (self.padded_vocab, self.emb_dim)

    def init_table(self, generator: torch.Generator, device) -> torch.Tensor:
        """Random table in storage layout: drawn in the logical
        ``[padded_vocab, emb_dim]`` shape, dummy and padding rows zero."""
        logical = _init_rows(
            generator, (self.padded_vocab, self.emb_dim), self.init,
            self.init_args, device,
        )
        logical[self.dummy_id:] = 0.0
        return to_storage(self, logical).to(torch_dtype(self.dtype))


def packed_gather(spec: EmbeddingTableSpec, table: torch.Tensor,
                  ids: torch.Tensor) -> torch.Tensor:
    """Logical rows ``[n, emb_dim]`` of row_packed storage for flat ids.

    Storage row indices are clipped into the table (the reference's
    ``mode="clip"``), so sentinel ids (``2**31 - 2``) read the last
    padding row; callers never use those outputs."""
    p, d = spec.pack, spec.emb_dim
    r = torch.clamp(torch.div(ids, p, rounding_mode="floor"), 0,
                    table.shape[0] - 1)
    rows = table[r]  # [n, 128]
    if p == 1:
        return rows[:, :d]
    sub = torch.remainder(ids, p).long()
    r3 = rows[:, : p * d].reshape(-1, p, d)
    return r3[torch.arange(r3.shape[0], device=r3.device), sub]


def packed_expand(spec: EmbeddingTableSpec, vals: torch.Tensor,
                  sub: torch.Tensor) -> torch.Tensor:
    """Inverse of the lane extract: ``vals [n, emb_dim]`` placed into
    lanes ``[sub*d, (sub+1)*d)`` of zeroed 128-lane rows."""
    d = spec.emb_dim
    out = torch.zeros((vals.shape[0], 128), dtype=vals.dtype,
                      device=vals.device)
    lanes = sub.long().reshape(-1, 1) * d + torch.arange(d, device=vals.device)
    return out.scatter_(1, lanes, vals)


def to_storage(spec: EmbeddingTableSpec, logical: torch.Tensor) -> torch.Tensor:
    """``[padded_vocab, emb_dim]`` logical table -> storage layout."""
    if spec.row_packed:
        p, d = spec.pack, spec.emb_dim
        vr = spec.packed_rows
        pad_rows = vr * p - spec.padded_vocab
        if pad_rows:
            logical = torch.cat([
                logical,
                logical.new_zeros((pad_rows, d)),
            ])
        t = logical.reshape(vr, p * d)
        if p * d < 128:
            t = torch.cat([t, t.new_zeros((vr, 128 - p * d))], dim=1)
        return t.contiguous()
    if not spec.feature_major:
        return logical
    r, d, dp = spec.fold, spec.emb_dim, spec.padded_dim
    if r > 1:  # column c, sublane s holds logical row c * r + s
        return logical.reshape(spec.padded_vocab // r, r * d).T.contiguous()
    t = logical.T
    if dp > d:
        t = torch.cat([t, t.new_zeros((dp - d, t.shape[1]))])
    return t.contiguous()


def from_storage(spec: EmbeddingTableSpec, storage: torch.Tensor) -> torch.Tensor:
    """Storage layout -> logical ``[padded_vocab, emb_dim]``."""
    if spec.row_packed:
        p, d = spec.pack, spec.emb_dim
        flat = storage[:, : p * d].reshape(-1, d)
        return flat[: spec.padded_vocab]
    if not spec.feature_major:
        return storage
    if spec.fold > 1:
        return storage.T.reshape(spec.padded_vocab, spec.emb_dim)
    return storage[: spec.emb_dim].T


def lookup(spec: EmbeddingTableSpec, table: torch.Tensor,
           ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` (storage layout) for ``ids`` of any shape ->
    ``ids.shape + [emb_dim]`` (the reference's ``EmbeddingLookup``).
    Ids must lie in the table.  With ``spec.max_norm`` each row is
    scaled by ``min(1, max_norm / max(norm, 1e-12))``."""
    flat = ids.reshape(-1)
    if spec.row_packed:
        out = packed_gather(spec, table, flat)
    elif spec.feature_major:
        r, d = spec.fold, spec.emb_dim
        cols = torch.div(flat, r, rounding_mode="floor").long()
        g = table[: r * d, cols].T.reshape(-1, r, d)  # drop sublane padding
        sub = torch.remainder(flat, r).long()
        out = g[torch.arange(g.shape[0], device=g.device), sub]
    else:
        # its backward (the dense step's table gradient) sorts the ids and
        # sums each id's rows in chunks, then the chunks, in a fixed
        # order: deterministic, and parallel over a hot id's duplicates,
        # which the backward of ``table[ids]`` adds one after another
        out = torch.nn.functional.embedding(flat, table)
    if spec.max_norm is not None:
        norms = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        out = out * torch.clamp(
            spec.max_norm / torch.clamp(norms, min=1e-12), max=1.0)
    return out.reshape(*ids.shape, spec.emb_dim)


def _row_index(spec: EmbeddingTableSpec, storage: torch.Tensor, ids):
    """Index tuple of logical rows ``ids`` in storage: selecting it gives
    ``[n, emb_dim]``, and assigning ``[n, emb_dim]`` rows to it writes
    them."""
    ids = torch.as_tensor(ids).reshape(-1).to(storage.device).long()
    d = spec.emb_dim
    lanes = torch.arange(d, device=storage.device)
    if spec.row_packed:
        p = spec.pack
        return ((ids // p)[:, None], (ids % p)[:, None] * d + lanes[None, :])
    if not spec.feature_major:
        return (ids,)
    r = spec.fold
    if r == 1:  # [Dp, Vc]: column i, sublanes [0, d)
        return (lanes[None, :], ids[:, None])
    # folded: logical row i at sublanes [(i % r) * d, +d) of column i // r
    return ((ids % r)[:, None] * d + lanes[None, :], (ids // r)[:, None])


def read_rows(spec: EmbeddingTableSpec, storage: torch.Tensor,
              ids) -> torch.Tensor:
    """Logical rows ``[len(ids), emb_dim]`` of a table in any storage
    convention (row_packed, plain row-major, feature-major at any fold),
    on the table's device."""
    return storage[_row_index(spec, storage, ids)]


def write_rows(spec: EmbeddingTableSpec, storage: torch.Tensor, ids,
               rows) -> torch.Tensor:
    """Set logical rows in place (one index-put on the table's device:
    nothing of the table crosses to the host); returns ``storage``."""
    rows = torch.as_tensor(rows).to(storage.device, storage.dtype)
    storage[_row_index(spec, storage, ids)] = rows.reshape(-1, spec.emb_dim)
    return storage


class HashEmbeddingLookup:
    """Dynamic-vocabulary embedding lookup (the reference's
    ``HashEmbeddingLookup``).

    Arbitrary int64 keys (-1 and -2 reserved) map to dense slots of a
    fixed-capacity arena by a host-side hash store, which also tracks
    admission (``permit_filter_value``: a key must be seen in at least
    that many steps before it gets a real slot) and eviction
    (``evict_filter_value``: keys untouched for that many steps are
    erased).  The id -> slot translation runs on the host in the input
    pipeline; the device side is a plain gather over the arena
    ``[capacity + 1, dim]`` whose last row (the dummy slot, where keys
    not admitted land) is zero."""

    RESERVED_KEYS = (-1, -2)

    def __init__(self, embedding_size: int, capacity: int = 1 << 20,
                 default_value="normal", permit_filter_value: int = 1,
                 evict_filter_value: int = 0x7FFFFFFF,
                 max_norm: Optional[float] = None, seed: int = 0, store=None):
        if permit_filter_value < 1:
            raise ValueError("permit_filter_value must be >= 1")
        if evict_filter_value < 1:
            raise ValueError("evict_filter_value must be >= 1")
        self.embedding_size = embedding_size
        self.capacity = capacity
        self.default_value = default_value
        self.permit_filter_value = permit_filter_value
        self.evict_filter_value = evict_filter_value
        self.max_norm = max_norm
        self._rng = np.random.default_rng(seed)
        if store is None:
            from mindrec_tpu_torch.native.hashstore import HashStore

            store = HashStore(capacity=capacity,
                              permit_threshold=permit_filter_value,
                              evict_threshold=evict_filter_value)
        self.store = store
        self.dummy_slot = capacity

    def init(self, generator: torch.Generator, device="cuda") -> torch.Tensor:
        shape = (self.capacity + 1, self.embedding_size)
        if isinstance(self.default_value, str):
            arena = _init_rows(generator, shape, self.default_value, (), device)
        else:
            arena = torch.full(shape, float(self.default_value),
                               dtype=torch.float32, device=device)
        arena[self.dummy_slot] = 0.0
        return arena

    def map_ids(self, ids) -> np.ndarray:
        """Host side: raw feature ids -> arena slots (keys not admitted,
        or with the arena full, go to the dummy slot); advances the
        store's step clock."""
        ids = np.asarray(ids)
        slots = self.store.lookup_or_insert(ids.reshape(-1))
        slots = np.where(slots < 0, self.dummy_slot, slots)
        return slots.reshape(ids.shape).astype(np.int32)

    def evict_step(self) -> np.ndarray:
        """Erase expired keys; returns the slots freed."""
        return self.store.evict()

    def __call__(self, arena: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
        out = arena[slots.long()]
        if self.max_norm is not None:
            norms = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
            out = out * torch.clamp(
                self.max_norm / torch.clamp(norms, min=1e-12), max=1.0)
        return out

    def export_table(self, arena: torch.Tensor):
        """(keys, vectors) of every admitted key, on the host."""
        keys, slots = self.store.items()
        return keys, arena[torch.from_numpy(slots).to(arena.device)].cpu().numpy()

    def import_table(self, arena: torch.Tensor, keys, vectors) -> torch.Tensor:
        """Admit ``keys`` (forced) and write their vectors in place."""
        slots = self.store.lookup_or_insert(np.asarray(keys).reshape(-1),
                                            force=True)
        ok = slots >= 0
        arena[torch.from_numpy(slots[ok]).to(arena.device)] = torch.as_tensor(
            np.asarray(vectors)[ok]).to(arena.device, arena.dtype)
        return arena
