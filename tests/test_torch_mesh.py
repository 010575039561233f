"""The port's (data, model) mesh on ``torch.distributed``
(``mindrec_tpu_torch/parallel/mesh.py``, ``dist.py``, ``launch.py``) and
the helpers the other multi-rank tests share.

Ranks are gloo subprocesses on the CPU (``launch.run_job``), at most
(data 2, model 2); each spawn has a hard time limit and kills its ranks
when one fails.  The JAX side of the parity tests runs in the pytest
process on a (2, 2) mesh of 4 of the 8 virtual CPU devices
(``tests/conftest.py``).  This module imports no JAX at its top: its
rank-side job runs in the spawned ranks.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mindrec_tpu_torch.parallel import dist, launch
from mindrec_tpu_torch.parallel import mesh as pm

JOBS = "mindrec_tpu_torch.parallel.jobs:train_on_mesh"
SPAWN_TIMEOUT = 110  # seconds per spawn, rank start-up included


# ---------------------------------------------------------------------------
# helpers shared by the multi-rank test files
# ---------------------------------------------------------------------------


def jax_mesh(data=2, model=2):
    """A (data, model) JAX mesh of the first data * model CPU devices."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[: data * model]).reshape(data, model),
                ("data", "model"))


def spawn(runs: list[dict], world: int, timeout=SPAWN_TIMEOUT) -> list[list]:
    """Run every spec of ``runs`` (``parallel/jobs.py``) in one spawn of
    ``world`` ranks; -> per run, each rank's record."""
    res, _outs = launch.run_job(JOBS, {"device": "cpu", "runs": runs}, world,
                                 timeout=timeout)
    return [[res[r][i] for r in range(world)] for i in range(len(runs))]


def save_state(path, state) -> str:
    from mindrec_tpu_torch.io.checkpoint import save_checkpoint

    return save_checkpoint(path, state, step=0)


def state_from_jax(js):
    from mindrec_tpu_torch import convert

    import jax

    host = jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d))
    return convert.state_from_jax(*host, np.asarray(js.step), device="cpu")


def merged(records, like):
    """The whole state of a run from its ranks' sliced files."""
    from mindrec_tpu_torch.io.checkpoint import merge_sliced

    return merge_sliced([r["path"] for r in records], like)


def flat(state) -> dict:
    from mindrec_tpu_torch.io.checkpoint import flatten_state

    return {k: v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in flatten_state(state) if k != ".rng"}


def jax_flat(js) -> dict:
    """A JAX state's leaves under the port's checkpoint keys."""
    import jax

    return flat(state_from_jax(jax.tree.map(np.asarray, js)))


def assert_states_close(got: dict, want: dict, rtol=1e-5, atol=1e-6, only=None):
    assert got.keys() == want.keys()
    for k in want:
        if only is None or any(s in k for s in only):
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                       err_msg=k)


def single_run(spec: dict):
    """The spec run in this process on one rank (no mesh): -> (state,
    losses)."""
    from mindrec_tpu_torch.data.criteo import to_device
    from mindrec_tpu_torch.io.checkpoint import restore_checkpoint
    from mindrec_tpu_torch.parallel.jobs import (
        DTYPES, build_net, build_opt, load_batches,
    )
    from mindrec_tpu_torch.train.step import (
        init_train_state, make_batch_sort, make_train_step, prep_groups,
    )

    model = build_net(spec["net"])
    ow, od = build_opt(spec["opt_w"]), build_opt(spec["opt_d"])
    state = init_train_state(model, spec.get("seed", 0), ow, od, device="cpu")
    if spec.get("state"):
        state = restore_checkpoint(spec["state"], state)
    kw = dict(spec.get("step", {}))
    if "matmul_dtype" in kw:
        kw["matmul_dtype"] = DTYPES[kw["matmul_dtype"]]
    step = make_train_step(model, ow, od, jit=False, **kw)
    batches = load_batches(spec["batches"])
    if spec.get("prep"):
        prep = make_batch_sort(getattr(model.config, "field_size", 0),
                               groups=prep_groups(model), native=False)
        batches = [prep(b) for b in batches]
    losses = []
    for b in batches:
        state, (lw, ld) = step(state, to_device(b, "cpu"))
        losses.append((float(lw), float(ld)))
    return state, losses


def check_losses(got, want, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol)


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------


def test_single_process_mesh():
    mesh = pm.make_mesh()
    assert (mesh.data, mesh.model, mesh.size, mesh.rank) == (1, 1, 1, 0)
    x = torch.arange(4.0)
    assert pm.all_reduce(x, "data", mesh) is x  # an axis of one rank
    with pytest.raises(ValueError, match="needs 2 ranks"):
        pm.make_mesh(data=1, model=2)


def test_backend_choice(monkeypatch):
    """NCCL is the card's default when every rank has a card; gloo on the
    CPU and when ranks share cards; NCCL asked for with more ranks than
    cards raises naming gloo."""
    monkeypatch.delenv("MR_BACKEND", raising=False)
    assert dist.pick_backend(None, "cpu", 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dist.pick_backend(None, "cuda", 1) == "nccl"
    assert dist.pick_backend(None, "cuda", 4) == "gloo"
    with pytest.raises(ValueError, match="gloo"):
        dist.pick_backend("nccl", "cuda", 4)
    monkeypatch.setenv("MR_BACKEND", "nccl")
    with pytest.raises(ValueError, match="gloo"):
        dist.pick_backend(None, "cuda", 2)
    with pytest.raises(ValueError, match="gloo"):
        dist.pick_backend(None, "cpu", 1)
    monkeypatch.setenv("MR_BACKEND", "gloo")
    assert dist.pick_backend(None, "cuda", 4) == "gloo"
    with pytest.raises(ValueError, match="backend"):
        dist.pick_backend("mpi", "cpu", 1)


def _wd(**kw):
    from mindrec_tpu_torch.models.wide_deep import WideDeepConfig, WideDeepModel

    base = dict(batch_size=32, field_size=8, vocab_size=3000, emb_dim=8,
                deep_layer_dim=(16,), sparse=True,
                deep_table_slice_mode="table_row_slice")
    return WideDeepConfig(**{**base, **kw}), WideDeepModel


@pytest.mark.parametrize("mode", ["table_row_slice", "table_column_slice"])
def test_placements_tile_the_table(mode):
    """Every rank's block of a sliced table and of its row-aligned
    optimizer state: the model ranks' blocks tile the table once, the
    data ranks hold the same one, everything else is replicated."""
    from mindrec_tpu_torch.train import optim
    from mindrec_tpu_torch.train.step import init_train_state

    cfg, cls = _wd(deep_table_slice_mode=mode)
    full = init_train_state(cls(cfg), 0, optim.ftrl(), optim.lazy_adam(),
                            device="cpu")
    table = full.params["deep"]["table"]
    for data, model in ((2, 2), (1, 4)):
        cover = torch.zeros_like(table)
        for r in range(data * model):
            mesh = pm.Mesh(data, model, rank=r)
            st = pm.shard_train_state(full, cls(cfg, mesh=mesh), mesh)
            pl = pm.state_placements(full, cls(cfg, mesh=mesh), mesh)
            blk = pl.params["deep"]["table"]
            assert torch.equal(st.params["deep"]["table"], table[blk.index])
            for k in ("m", "v"):
                assert pl.opt_d["deep/table"][k] == blk
                assert st.opt_d["deep/table"][k].shape == st.params["deep"]["table"].shape
            assert pl.params["wide"]["table"] is None
            assert st.params["wide"]["table"] is full.params["wide"]["table"]
            assert pl.opt_d["deep/table"]["step"] is None
            if mesh.axis_index("data") == 0:
                cover[blk.index] += 1
        assert torch.equal(cover, torch.ones_like(cover))
        dim = 1 if mode == "table_row_slice" else 0
        assert st.params["deep"]["table"].shape[dim] * model == table.shape[dim]


def test_shard_batch_and_full_batch():
    b = {"ids": np.arange(32).reshape(8, 4), "label": np.arange(8.0)[:, None],
         "scalar": np.float32(3.0)}
    parts = [pm.shard_batch(b, pm.Mesh(2, 2, rank=r)) for r in range(4)]
    np.testing.assert_array_equal(parts[0]["ids"], parts[1]["ids"])
    np.testing.assert_array_equal(parts[2]["ids"], b["ids"][4:])
    assert parts[3]["scalar"] == 3.0
    full = pm.shard_batch(b, pm.Mesh(2, 2), full_batch=True)
    assert isinstance(full, pm.FullBatch) and full["ids"] is b["ids"]
    with pytest.raises(ValueError, match="divide"):
        pm.shard_batch({"ids": np.zeros((3, 2))}, pm.Mesh(2, 1))


def collectives_job(args):
    """Rank side of :func:`test_collectives_over_gloo`."""
    mesh = pm.make_mesh(2, 2)
    r, d, m = mesh.rank, mesh.axis_index("data"), mesh.axis_index("model")
    x = torch.full((3,), float(r))
    out = {
        "data_sum": pm.all_reduce(x, "data", mesh).tolist(),
        "model_min": pm.all_reduce(x, "model", mesh, op="min").tolist(),
        "gather": pm.all_gather(torch.tensor([r, 10 * r]), "model", mesh).tolist(),
        "a2a": pm.all_to_all(torch.tensor([100 * r, 100 * r + 1]), "model",
                             mesh).tolist(),
        "log": list(pm.COLLECTIVES),
        "at": (d, m),
    }
    # the differentiable sum over model passes its gradient through
    w = torch.tensor([float(r + 1)], requires_grad=True)
    y = pm.sum_over(w * 2.0, "model", mesh)
    y.sum().backward()
    out["grad"], out["y"] = w.grad.tolist(), y.tolist()
    # recorded, as a captured step records them: nothing travels until
    # each closure runs, from the source's values at that time, into the
    # output the recording returned
    recs, logged = [], len(pm.COLLECTIVES)
    with pm.recording(recs.append):
        got = [pm.all_reduce(torch.zeros(3), "model", mesh),
               pm.all_gather(torch.tensor([0, 0]), "model", mesh),
               pm.all_to_all(torch.tensor([0, 0]), "model", mesh)]
    out["recorded"] = dict(
        returned=[g is rc.out for g, rc in zip(got, recs)],
        ops=[(rc.op, rc.axis) for rc in recs],
        logged_while_recording=len(pm.COLLECTIVES) - logged)
    pm.reset_collectives()
    runs = []
    for shift in (5, 7):
        recs[0].src.copy_(torch.full((3,), float(r + shift)))
        recs[1].src.copy_(torch.tensor([r + shift, 10 * r + shift]))
        recs[2].src.copy_(torch.tensor([100 * r + shift, 100 * r + shift + 1]))
        ptrs = [rc.out.data_ptr() for rc in recs]
        for rc in recs:
            rc.run()
        runs.append(dict(same_out=[p == rc.out.data_ptr()
                                   for p, rc in zip(ptrs, recs)],
                         values=[rc.out.tolist() for rc in recs]))
    out["recorded"].update(runs=runs, log=list(pm.COLLECTIVES))
    return out


@pytest.fixture(scope="module")
def gloo_ranks():
    """One spawn of 4 gloo ranks on the CPU running :func:`collectives_job`."""
    res, _ = launch.run_job(f"{__file__}:collectives_job", {"device": "cpu"},
                            4, timeout=SPAWN_TIMEOUT)
    return res


def test_collectives_over_gloo(gloo_ranks):
    """4 gloo ranks on the CPU: rank r sits at (r // 2, r % 2); each
    collective runs over this rank's row or column and logs its bytes."""
    for r, o in enumerate(gloo_ranks):
        d, m = r // 2, r % 2
        assert tuple(o["at"]) == (d, m)
        assert o["data_sum"] == [float(m + m + 2)] * 3  # ranks m and 2 + m
        assert o["model_min"] == [float(2 * d)] * 3
        assert o["gather"] == [2 * d, 20 * d, 2 * d + 1, 10 * (2 * d + 1)]
        # block j of each model rank goes to model rank j
        assert o["a2a"] == [100 * (2 * d) + m, 100 * (2 * d + 1) + m]
        assert [(op, ax) for op, ax, _ in o["log"]] == [
            ("all_reduce", "data"), ("all_reduce", "model"),
            ("all_gather", "model"), ("all_to_all", "model")]
        assert [b for *_, b in o["log"]] == [12, 12, 16, 16]
        assert o["grad"] == [2.0]
        assert o["y"] == [2.0 * ((2 * d + 1) + (2 * d + 2))]


def test_recorded_collectives_over_gloo(gloo_ranks):
    """The collectives recorded by a capture (``mesh.recording``), on the
    2 ranks of each model row: each returns its fixed output and does
    not communicate or log; after its source is changed in place, its
    closure writes the new result into that same output (same
    ``data_ptr``) and logs ``(op, axis, bytes)`` as the eager call does."""
    for r, o in enumerate(gloo_ranks):
        d, m = r // 2, r % 2
        rec = o["recorded"]
        assert rec["returned"] == [True] * 3
        assert rec["ops"] == [("all_reduce", "model"), ("all_gather", "model"),
                              ("all_to_all", "model")]
        assert rec["logged_while_recording"] == 0
        for shift, run in zip((5, 7), rec["runs"]):
            assert run["same_out"] == [True] * 3
            lo, hi = 2 * d, 2 * d + 1  # the model row's ranks
            assert run["values"] == [
                [float(lo + hi + 2 * shift)] * 3,
                [lo + shift, 10 * lo + shift, hi + shift, 10 * hi + shift],
                [100 * lo + shift + m, 100 * hi + shift + m]]
        assert rec["log"] == [("all_reduce", "model", 12),
                              ("all_gather", "model", 16),
                              ("all_to_all", "model", 16)] * 2


def test_spawn_kills_the_group_when_a_rank_fails():
    """A rank that raises fails the spawn at once (the others, waiting in
    a collective, are killed), with each rank's output."""
    with pytest.raises(launch.RanksFailed, match="rank 1 exited"):
        launch.run_job(f"{__file__}:failing_job", {"device": "cpu"}, 2,
                       timeout=60)


def failing_job(args):
    mesh = pm.make_mesh(2, 1)
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    pm.all_reduce(torch.ones(1), "data", mesh)  # waits for rank 1
