"""Edge cases of ``segsum_unsorted`` and ``adam_cols`` on the CPU: the
port's plain versions (which the wrappers take for CPU tensors) against
the JAX package's Pallas kernels in interpret mode, on the same numpy
inputs.  The case lists are shared with ``tests/test_torch_cuda.py``,
which runs them on a card, CUDA kernel against plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindrec_tpu.ops.pallas import stream_update
from mindrec_tpu.ops.pallas.stream_segsum import streamed_segsum_unsorted
from mindrec_tpu_torch.ops.kernels.segsum import segsum_unsorted
from mindrec_tpu_torch.ops.kernels.update_cols import adam_cols
from test_torch_cuda import (
    ADAM_COLS_CASES, SEGSUM_IDS, SEGSUM_UNSORTED_CASES, adam_cols_case,
    segsum_float64, segsum_unsorted_case,
)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SEGSUM_UNSORTED_CASES, ids=SEGSUM_IDS)
def test_segsum_unsorted_edge_cases_match_pallas(case, dtype):
    """float32 inputs: the reference sums in float32 (``matmul_dtype``
    float32).  bfloat16 inputs: the reference at its default
    ``matmul_dtype`` (bfloat16), whose one-hot products of bf16 values
    are exact, summed in float32.  Both sides are held against a float64
    sum: the port within 8 * 2**-24 * sqrt(n_s) * sqrt(sum g**2) (a
    float32 sum in any order); the reference within that plus
    1e-5 * sum |g|, because XLA's CPU dot may run at reduced internal
    precision (~5e-6 relative per term on some hosts)."""
    _id, n, d, n_out, pattern = case
    g, seg = segsum_unsorted_case(n, d, n_out, pattern)
    ref64, tol = segsum_float64(g, seg, n_out)
    mass, _ = segsum_float64(np.abs(g), seg, n_out)
    out = segsum_unsorted(_t(g).to(getattr(torch, dtype)), _t(seg), n_out)
    assert out.shape == (d, n_out) and out.dtype == torch.float32
    assert (np.abs(out.numpy() - ref64) <= tol).all()
    md = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = streamed_segsum_unsorted(
        jnp.asarray(g).astype(getattr(jnp, dtype)), jnp.asarray(seg), n_out,
        matmul_dtype=md, interpret=True)
    assert (np.abs(np.asarray(ref) - out.numpy()) <= 2 * tol + 1e-5 * mass).all()


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fold", [1, 8])
@pytest.mark.parametrize("kind", ADAM_COLS_CASES)
def test_adam_cols_edge_cases_match_pallas(kind, fold, state_dtype):
    """The reference runs with ``matmul_dtype`` float32 on bf16-exact
    gradients, so its one-hot products are exact whatever precision the
    dot runs at.  Weights and float32 moments: rtol 2e-5 (the sums of
    runs and the elementwise arithmetic in another order); a bfloat16
    moment may round to its neighbour, one ulp = 2**-7."""
    c = adam_cols_case(kind, fold)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-6, loss_scale=1000.0)
    lr_t = 1e-3 * np.sqrt(1 - 0.999**2) / (1 - 0.9**2)
    sd_j, sd_t = getattr(jnp, state_dtype), getattr(torch, state_dtype)
    ref = stream_update.streamed_adam_cols(
        jnp.asarray(c["table"]), jnp.asarray(c["m"]).astype(sd_j),
        jnp.asarray(c["v"]).astype(sd_j), jnp.asarray(c["cols"]),
        jnp.asarray(c["aug"]), jnp.float32(lr_t), dim=c["dim"], fold=fold,
        tile=256, chunk=256, matmul_dtype=jnp.float32, interpret=True,
        **hyper)
    state = [_t(c["table"]), _t(c["m"]).to(sd_t), _t(c["v"]).to(sd_t)]
    before = [x.clone() for x in state]
    out = adam_cols(*state, _t(c["cols"]), _t(c["aug"]),
                    torch.tensor(lr_t, dtype=torch.float32), dim=c["dim"],
                    fold=fold, **hyper)
    for got, want in zip(out, ref):
        rtol = 2.0**-7 if got.dtype == torch.bfloat16 else 2e-5
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=rtol,
                                   atol=1e-8)
    changed = any(not torch.equal(x, y) for x, y in zip(out, before))
    assert changed == (kind != "all-sentinel")
