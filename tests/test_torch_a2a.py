"""The explicit all-to-all exchange (``mindrec_tpu_torch/ops/a2a.py``)
against the JAX package's ``sharded_unique_gather`` and the plain take
(``tests/test_all_to_all.py``'s claims): forward equality, data-sharded
ids, the gradient of the dense formulation, ids past the capacity read
zeros, and no collective near the table's bytes (the wrappers' byte
counters).  The port's side is one spawn of 4 gloo ranks, (data 2,
model 2); this module imports JAX only inside its tests (its rank-side
job runs in the spawned ranks).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mindrec_tpu_torch.ops.a2a import SENTINEL, sharded_unique_gather
from mindrec_tpu_torch.parallel import launch
from mindrec_tpu_torch.parallel import mesh as pm

DP, VC, U = 8, 4096, 256


def _table() -> np.ndarray:
    return np.random.default_rng(0).standard_normal((DP, VC)).astype(np.float32)


def _uq(n_real, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ids = rng.choice(VC - 17, size=n_real, replace=False).astype(np.int32)
    out = np.full(U, SENTINEL, np.int32)
    out[:n_real] = np.sort(ids)
    return out


def _take(table, uq):
    ok = uq < SENTINEL
    return np.where(ok[None, :], table[:, np.clip(uq, 0, VC - 1)], 0.0)


def a2a_job(args):
    """Rank side: every case on this rank's block of the table."""
    mesh = pm.make_mesh(2, 2)
    m, d = mesh.axis_index("model"), mesh.axis_index("data")
    vl = VC // 2
    full = torch.from_numpy(_table())
    block = full[:, m * vl:(m + 1) * vl].contiguous()
    out = {}
    pm.reset_collectives()
    uq = torch.from_numpy(_uq(200))
    out["fwd"] = sharded_unique_gather(block, uq, mesh, data_axis=None).numpy()
    out["fwd_log"] = list(pm.COLLECTIVES)
    own = torch.from_numpy(_uq(100 + 8 * d, seed=d))  # this data rank's ids
    out["data_ids"] = sharded_unique_gather(block, own, mesh).numpy()
    w = torch.from_numpy(np.random.default_rng(7).standard_normal(U)
                         .astype(np.float32))
    t = block.clone().requires_grad_(True)
    rows = sharded_unique_gather(t, uq, mesh, data_axis=None)
    (torch.square(rows) * w[None, :]).sum().backward()
    out["grad"] = t.grad.numpy()
    t = block.clone().requires_grad_(True)
    rows = sharded_unique_gather(t, own, mesh)  # gradient summed over data
    (torch.square(rows) * w[None, :]).sum().backward()
    out["grad_data"] = t.grad.numpy()
    skew = np.full(U, SENTINEL, np.int32)
    skew[:64] = np.arange(64)  # every real id on model rank 0
    out["capacity"] = sharded_unique_gather(
        block, torch.from_numpy(skew), mesh, data_axis=None, capacity=4).numpy()
    out["rank"] = (d, m)
    return out


@pytest.fixture(scope="module")
def runs():
    """Each rank's outputs of one spawn."""
    res, _ = launch.run_job(f"{__file__}:a2a_job", {"device": "cpu"}, 4,
                            timeout=110)
    return res


def test_forward_matches_reference_and_take(runs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mindrec_tpu.ops.a2a import sharded_unique_gather as jax_gather
    from test_torch_mesh import jax_mesh

    table, uq = _table(), _uq(200)
    want = _take(table, uq)
    jm = jax_mesh()
    jt = jax.device_put(jnp.asarray(table), NamedSharding(jm, P(None, "model")))
    with jm:
        ref = np.asarray(jax_gather(jt, jnp.asarray(uq), jm, data_axis=None))
    np.testing.assert_array_equal(ref, want)
    for o in runs:
        np.testing.assert_array_equal(o["fwd"], want)


def test_forward_data_sharded_ids(runs):
    table = _table()
    for o in runs:
        d = o["rank"][0]
        np.testing.assert_array_equal(o["data_ids"],
                                      _take(table, _uq(100 + 8 * d, seed=d)))


def test_grad_matches_dense_formulation(runs):
    table = torch.from_numpy(_table())
    w = torch.from_numpy(np.random.default_rng(7).standard_normal(U)
                         .astype(np.float32))

    def dense_grad(uq):
        t = table.clone().requires_grad_(True)
        ok = torch.from_numpy(uq < SENTINEL)
        idx = torch.from_numpy(np.clip(uq, 0, VC - 1)).long()
        rows = torch.where(ok[None, :], t[:, idx], 0.0)
        (torch.square(rows) * w[None, :]).sum().backward()
        return t.grad.numpy()

    g = dense_grad(_uq(200))
    g_data = dense_grad(_uq(100, seed=0)) + dense_grad(_uq(108, seed=1))
    for o in runs:
        m = o["rank"][1]
        cols = slice(m * VC // 2, (m + 1) * VC // 2)
        np.testing.assert_allclose(o["grad"], g[:, cols], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(o["grad_data"], g_data[:, cols], rtol=1e-6,
                                   atol=1e-6)


def test_capacity_overflow_reads_zero(runs):
    """Ids past a peer's capacity read zeros instead of corrupting their
    neighbours; at least one capacity's worth comes through."""
    table = _table()
    for o in runs:
        got = o["capacity"]
        served = 0
        for i in range(64):
            row = got[:, i]
            assert (row == table[:, i]).all() or (row == 0).all()
            served += bool((row == table[:, i]).all())
        assert served >= 4
        assert (got[:, 64:] == 0).all()


def test_collectives_never_table_scale(runs):
    """The forward's exchanges (ids, rows, the rows' gather) stay far below
    the table: their bytes depend on U, never on the vocab."""
    table_bytes = DP * VC * 4
    for o in runs:
        log = o["fwd_log"]
        assert [op for op, *_ in log] == ["all_to_all", "all_to_all",
                                          "all_gather"]
        assert max(b for *_, b in log) * 4 < table_bytes, log
        # M peers x K = U/M ids each, their rows, this rank's U/M rows
        assert [b for *_, b in log] == [U * 4, U * DP * 4, U // 2 * DP * 4]
