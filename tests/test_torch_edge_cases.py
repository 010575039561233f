"""Edge cases of ``segsum_unsorted``, ``segsum_cols``,
``adam_cols_from_sums``, ``gather_rows``, ``ftrl_cols_from_sums`` and the
fused update + gather on the CPU: the port's plain versions (which the wrappers take for CPU tensors) against
the JAX package's Pallas kernels in interpret mode, on the same numpy
inputs.  The case lists are shared with ``tests/test_torch_cuda.py``,
which runs them on a card, CUDA kernel against plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindrec_tpu.ops.pallas import stream_fused, stream_update
from mindrec_tpu.ops.pallas.stream_gather import streamed_gather_rows
from mindrec_tpu.ops.pallas.stream_segsum import (
    streamed_segsum, streamed_segsum_unsorted,
)
from mindrec_tpu_torch.ops.kernels.gather import gather_rows
from mindrec_tpu_torch.ops.kernels.segsum import segsum_cols, segsum_unsorted
from mindrec_tpu_torch.ops.kernels.update_cols import (
    adam_cols_from_sums, ftrl_cols_from_sums,
)
from test_torch_cuda import (
    ADAM_COLS_CASES, FTRL_COLS_CASES, FTRL_COLS_IDS, FUSED_EDGE_CASES,
    FUSED_EDGE_IDS, GATHER_ROWS_CASES, GATHER_ROWS_IDS, SEGSUM_COLS_CASES,
    SEGSUM_COLS_IDS, SEGSUM_IDS, SEGSUM_UNSORTED_CASES, adam_cols_case,
    ftrl_cols_case, fused_call, fused_edge_case, fused_edge_state,
    gather_rows_case, segsum_cols_case, segsum_float64, segsum_unsorted_case,
    sums_of,
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SEGSUM_COLS_CASES, ids=SEGSUM_COLS_IDS)
def test_segsum_cols_edge_cases_match_pallas(case, dtype):
    """The port takes ``g`` as the transposed view of a contiguous [N, D]
    (as the step passes it); the reference takes the same values as a
    float32 [D, N] array with ``matmul_dtype`` float32 (bfloat16 inputs
    are compared in float32: the TPU kernel rounds to its
    ``matmul_dtype``).  rtol / atol 1e-5; the case's values make every
    float32 sum exact.  The reference takes no segment at or past its
    ``n_out`` (a multiple of its 512-column blocks) and never writes the
    blocks past the last segment's, so it runs at ``n_out`` rounded up
    past the last segment and is compared up to that block and to the
    port's ``n_out``; the port's columns past the last segment are zero."""
    _id, n, d, n_out, pattern = case
    g, uidx = segsum_cols_case(n, d, pattern)
    last = int(uidx[-1])
    n_ref = -(-max(n_out, last + 1) // 512) * 512
    ref = np.asarray(streamed_segsum(
        jnp.asarray(g.T), jnp.asarray(uidx), n_out=n_ref,
        matmul_dtype=jnp.float32, interpret=True))
    rows = _t(g).to(getattr(torch, dtype))
    out = segsum_cols(rows.T, _t(uidx), n_out)
    assert out.shape == (d, n_out) and out.dtype == torch.float32
    seen = min(n_out, (last // 512 + 1) * 512)
    np.testing.assert_allclose(out.numpy()[:, :seen], ref[:, :seen],
                               rtol=1e-5, atol=1e-5)
    assert not out.numpy()[:, last + 1:].any()


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
    out = adam_cols_from_sums(*state, _t(c["cols"]), *sums_of(c),
                              torch.tensor(lr_t, dtype=torch.float32),
                              dim=c["dim"], fold=fold, **hyper)
    for got, want in zip(out, ref):
        rtol = 2.0**-7 if got.dtype == torch.bfloat16 else 2e-5
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=rtol,
                                   atol=1e-8)
    changed = any(not torch.equal(x, y) for x, y in zip(out, before))
    assert changed == (kind != "all-sentinel")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GATHER_ROWS_CASES, ids=GATHER_ROWS_IDS)
def test_gather_rows_edge_cases_match_pallas(case, dtype):
    """The port (its plain version, which a CPU tensor takes) equals the
    reference exactly: the table's values are exact in bf16, so the
    reference's one-hot product (``matmul_dtype`` float32) copies them
    at any precision its dot runs at.  The reference takes its slots in
    whole chunks of 128: its columns and buffer are padded with
    sentinel slots, which keep the buffer, and compared over the N
    slots.  Every element outside the live slots' lanes keeps the
    buffer's value."""
    _id, dp, fold, off, width, n, pattern = case
    table, cols, buf = gather_rows_case(dp, fold, width, n, pattern)
    pad = -n % 128
    ref = np.asarray(streamed_gather_rows(
        jnp.asarray(table).astype(getattr(jnp, dtype)),
        jnp.asarray(np.concatenate([cols, np.full(pad, 2**31 - 2, np.int32)])),
        jnp.asarray(np.concatenate([buf, np.zeros((pad, width), np.float32)])),
        lane_offset=off, tile=128, chunk=128, matmul_dtype=jnp.float32,
        interpret=True))[:n]
    out = gather_rows(_t(table).to(getattr(torch, dtype)), _t(cols),
                      _t(buf), off)
    np.testing.assert_array_equal(out.numpy(), ref)
    live = (cols >= 0) & (cols < table.shape[1])
    keep = np.ones_like(buf, bool)
    keep[live, off:off + dp] = False
    np.testing.assert_array_equal(out.numpy()[keep], buf[keep])


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FTRL_COLS_CASES, ids=FTRL_COLS_IDS)
def test_ftrl_cols_edge_cases_match_pallas(case, table_dtype):
    """The reference runs with ``matmul_dtype`` float32 on gradients whose
    float32 sums are exact in any order (so its one-hot sums equal the
    port's slot-order sums at any precision its dot runs at); the FTRL
    arithmetic is the same elementwise float32, held at rtol 2e-5 (as
    the ``adam_cols`` cases); a bfloat16 weight may round to its
    neighbour, one ulp = 2**-7.  Untouched elements keep their values."""
    _id, fold, dp, n, kind = case
    c = ftrl_cols_case(kind, fold, dp, n)
    hyper = dict(dim=c["dim"], fold=fold, learning_rate=5e-2, l1=5e-4,
                 l2=5e-4, loss_scale=1000.0)
    tj, tt = getattr(jnp, table_dtype), getattr(torch, table_dtype)
    ref = stream_update.streamed_ftrl_cols(
        jnp.asarray(c["table"]).astype(tj), jnp.asarray(c["accum"]),
        jnp.asarray(c["linear"]), jnp.asarray(c["cols"]),
        jnp.asarray(c["aug"]), tile=256, chunk=256,
        matmul_dtype=jnp.float32, interpret=True, **hyper)
    state = [_t(c["table"]).to(tt), _t(c["accum"]), _t(c["linear"])]
    before = [x.clone() for x in state]
    out = ftrl_cols_from_sums(*state, _t(c["cols"]), *sums_of(c), **hyper)
    for got, want in zip(out, ref):
        rtol = 2.0**-7 if got.dtype == torch.bfloat16 else 2e-5
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=rtol,
                                   atol=1e-8)
    changed = any(not torch.equal(x, y) for x, y in zip(out, before))
    assert changed == (kind != "all-sentinel")


@pytest.mark.parametrize("opt", ["adam", "ftrl"])
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FUSED_EDGE_CASES, ids=FUSED_EDGE_IDS)
def test_fused_edge_cases_match_pallas(case, table_dtype, opt):
    """The port (its plain version, which CPU tensors take) against the
    reference's fused kernel in interpret mode (``matmul_dtype`` float32,
    on gradients whose float32 sums are exact in any order): the state at
    rtol 2e-5 (the same elementwise float32 arithmetic in another
    order), a bfloat16 weight (the reference runs on its float32
    widening) within one ulp (2**-7); the rows of the next ids inside the
    table held as the weights are, and equal to the
    port's updated table's columns; the rows outside the table zero (the
    reference compares only inside); the state unchanged when the update
    list is all sentinels.

    The reference gets its own copy of the state.  ``jnp.asarray`` of a
    numpy view of a torch tensor may alias its memory (on the CPU, when
    the buffer happens to be 64-byte aligned), and JAX runs the
    reference asynchronously, so the port's in-place update could change
    the reference's inputs before the reference read them: it then
    applied the update a second time.  That was the failure seen in
    loaded 6-worker runs (fold-8 cases, at random, errors up to 2.3
    relative; with the port run first on purpose, the aliased reference
    leaves a float64 oracle of the update while the port stays on it); it
    depended on the heap's alignment, so a case passed alone.
    The dots stay pinned to full float32 precision
    (``jax.default_matmul_precision("highest")``)."""
    _id, kind, fold = case
    c = fused_edge_case(kind, fold)
    state, hyper, lr_t = fused_edge_state(c, opt, table_dtype)
    before = [x.clone() for x in state]
    # the reference's fused kernels take float32 tables: a bfloat16 table
    # runs there as its float32 widening; a copy, never the port's memory
    ref_state = [jnp.asarray(np.array(x.float().numpy())) for x in state]
    ref_args = [jnp.asarray(c["cols"]), jnp.asarray(c["aug"])]
    kw = dict(fold=fold, tile=128, chunk=64, matmul_dtype=jnp.float32,
              interpret=True, **hyper)
    with jax.default_matmul_precision("highest"):
        if opt == "adam":
            ref = stream_fused.fused_adam_gather(
                *ref_state, *ref_args, jnp.float32(1e-3),
                jnp.asarray(c["nxt"]), **kw)
        else:
            ref = stream_fused.fused_ftrl_gather(
                *ref_state, *ref_args, jnp.asarray(c["nxt"]), **kw)
    out = fused_call(opt, lr_t)(state, _t(c["cols"]), _t(c["aug"]),
                                _t(c["nxt"]), fold=fold, **hyper)
    atol = 1e-8 if opt == "adam" else 1e-7
    for got, want in zip(out[:3], ref[:3]):
        rtol = 2.0**-7 if got.dtype == torch.bfloat16 else 2e-5
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=rtol,
                                   atol=atol)
    nxt, rows = c["nxt"], out[3].numpy()
    inside = (nxt >= 0) & (nxt < state[0].shape[1])
    rtol = 2.0**-7 if table_dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(rows[:, inside], np.asarray(ref[3])[:, inside],
                               rtol=rtol, atol=atol)
    np.testing.assert_array_equal(
        rows[:, inside], out[0].float().numpy()[:, nxt[inside]])
    assert not rows[:, ~inside].any()
    changed = any(not torch.equal(x, y) for x, y in zip(out[:3], before))
    assert changed == (kind != "update-all-sentinel")
