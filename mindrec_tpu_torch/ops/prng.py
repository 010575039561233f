"""Random keys on the device, the port's counterpart of ``jax.random``
for dropout.

A key is an int64 tensor of two 32-bit words on the state's device; the
train state keeps one (``TrainState.rng``) and each step splits it, as
the reference does.  :func:`split` and :func:`bernoulli` are pure
functions of the key, computed by integer tensor ops: each output word
hashes its counter (the element's index) with the key in two keyed
rounds of a 32-bit mixer.  So

* nothing is read on the host, and a step captured in a CUDA graph
  draws on each replay from the key the state holds then: masks differ
  from step to step in replays too;
* the captured and the eager step draw the same masks from the same
  key, as do the CPU and the card;
* the stream is a tensor of the state, so a checkpoint carries it.

(A per-state CUDA ``torch.Generator`` would need each capture to
register it with the graph, a method PyTorch's CPU builds lack, and the
warm-up step and the capture would advance it differently from an eager
run.)  The bits are not JAX's threefry bits: parity tests run with
dropout off or inject the reference's masks.
"""

from __future__ import annotations

import contextlib
import math

import torch

M32 = 0xFFFFFFFF


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mixer on int64 tensors holding values below
    2**32; both multipliers are below 2**31, so no product overflows."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & M32
    return x ^ (x >> 15)


def _hash(key: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    return _mix(_mix(counters ^ key[0]) ^ key[1])


def _counters(n: int, device, start: int = 0) -> torch.Tensor:
    if start + n > M32:
        raise ValueError(f"{start + n} draws exceed the 2**32 counters of a key")
    return torch.arange(start, start + n, dtype=torch.int64, device=device)


def key(seed: int, device="cuda") -> torch.Tensor:
    """The key of an integer seed (any Python int), on ``device``."""
    seed = int(seed)
    words = torch.tensor([seed & M32, ((seed >> 32) & M32) ^ 0x9E3779B9],
                         dtype=torch.int64, device=device)
    return _hash(words, _counters(2, device))


def split(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (the next key, a subkey to draw from)."""
    w = _hash(key, _counters(4, key.device))
    return w[:2], w[2:]


def bernoulli(key: torch.Tensor, p: float, shape, offset: int = 0) -> torch.Tensor:
    """Bool tensor of ``shape``, each element True with probability
    ``p`` (to 2**-32).  ``offset``: the draws start at that counter, so a
    block of a larger draw is drawn alone."""
    shape = tuple(shape)
    n = math.prod(shape)
    bits = _hash(key, _counters(n, key.device, offset))
    return (bits < int(p * 2**32)).reshape(shape)


_first_row = 0  # batch_rows: the first row of this rank's batch slice


@contextlib.contextmanager
def batch_rows(first: int):
    """Inside, :func:`dropout` draws the rows of a global batch from
    row ``first`` on: a data rank of a mesh, holding rows ``[first,
    first + B_local)``, draws the masks those rows get in the global
    batch."""
    global _first_row
    old, _first_row = _first_row, int(first)
    try:
        yield
    finally:
        _first_row = old


def dropout(h: torch.Tensor, keep_prob: float, key: torch.Tensor) -> torch.Tensor:
    """Inverted dropout: ``where(keep, h / keep_prob, 0)`` in ``h``'s
    type, ``keep`` drawn by :func:`bernoulli` (from :func:`batch_rows`'s
    row on).  ``keep_prob`` is rounded to ``h``'s type first, as the
    reference divides by a weakly typed scalar (a 0-dim CPU operand: no
    host read, nothing to stage)."""
    if _first_row:
        keep = bernoulli(key, keep_prob, h.shape,
                         _first_row * math.prod(h.shape[1:]))
    else:
        keep = bernoulli(key, keep_prob, h.shape)
    return torch.where(keep, h / torch.tensor(keep_prob, dtype=h.dtype), 0.0)
