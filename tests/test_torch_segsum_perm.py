"""``segsum_sorted`` reading batch-order gradients through ``perm``, on
the CPU: the port's wrapper (which takes the plain version for CPU
tensors) against the JAX package's ``streamed_segsum`` in interpret mode
on the sorted rows ``g[perm]``, as the reference's step gathers them in
front of it; the shared edge cases of ``tests/test_torch_cuda.py``
against the float64 sum; and the wrapper's argument checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindrec_tpu.ops.pallas.stream_segsum import streamed_segsum
from mindrec_tpu_torch.ops.kernels.segsum import segsum_sorted
from test_torch_cuda import (
    SEGSUM_SORTED_CASES, SEGSUM_SORTED_IDS, segsum_float64,
    segsum_sorted_case,
)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("index_dtype", ["int32", "int64"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["identity", "reversed", "random",
                                  "compacted"])
def test_segsum_perm_matches_pallas(kind, dtype, index_dtype):
    """``g`` of ``segsum_sorted_case`` (a compacted ``perm`` reads 700 of
    934 rows).  f32 sums over the same terms in another order: rtol /
    atol 1e-5, as ``test_segsum_matches_pallas``; the reference never
    writes its 512-column output blocks past the last segment's, so it is
    compared up to that block, and the port's columns past the last
    segment are zero."""
    n_out = 1024
    g32, uidx, perm = segsum_sorted_case(700, 24, "mixed", 0, kind)
    perm = perm.astype(index_dtype)
    g_j = jnp.asarray(g32).astype(getattr(jnp, dtype))
    ref = np.asarray(streamed_segsum(
        g_j[jnp.asarray(perm)], jnp.asarray(uidx), row_major=True,
        n_out=n_out, matmul_dtype=jnp.float32, interpret=True))
    out = segsum_sorted(_t(g32).to(getattr(torch, dtype)), _t(uidx), n_out,
                        perm=_t(perm))
    assert out.shape == (24, n_out) and out.dtype == torch.float32
    last = int(uidx[-1])
    seen = min(n_out, (last // 512 + 1) * 512)
    np.testing.assert_allclose(out.numpy()[:, :seen], ref[:, :seen],
                               rtol=1e-5, atol=1e-5)
    assert not out.numpy()[:, last + 1:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SEGSUM_SORTED_CASES, ids=SEGSUM_SORTED_IDS)
def test_segsum_sorted_edge_cases_plain(case, dtype):
    """The card's edge cases through the wrapper on the CPU: the values
    make every float32 sum exact, so the plain version equals the float64
    sum of ``g[perm]``."""
    _id, n, d, n_out, pattern, shift, kind = case
    g, uidx, perm = segsum_sorted_case(n, d, pattern, shift, kind)
    exact, _ = segsum_float64(g[perm], uidx, n_out)
    out = segsum_sorted(_t(g).to(getattr(torch, dtype)), _t(uidx), n_out,
                        perm=_t(perm))
    assert out.shape == (d, n_out) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), exact)


@pytest.mark.parametrize("what", ["perm-too-short", "perm-float",
                                  "perm-int16", "perm-2d", "rows-without-perm"])
def test_segsum_sorted_rejects_bad_perm(what):
    """A ``perm`` of the wrong length, type or rank, and a ``g`` whose rows
    do not match the positions when there is no ``perm``, raise before
    any sum, on the CPU as on the card."""
    g = torch.ones((10, 3))
    uidx = torch.arange(8, dtype=torch.int32)
    perm = {
        "perm-too-short": torch.arange(7),
        "perm-float": torch.arange(8, dtype=torch.float32),
        "perm-int16": torch.arange(8, dtype=torch.int16),
        "perm-2d": torch.arange(8).reshape(2, 4),
        "rows-without-perm": None,
    }[what]
    with pytest.raises(ValueError, match="segsum_sorted"):
        segsum_sorted(g, uidx, 8, perm=perm)
