"""Distributed online training (``mindrec_tpu_torch/examples/
dist_online_train.py`` through ``run_dist_online_train.sh``): 2 gloo
ranks on the CPU, a ``FileChannel`` spool sharded by rank, data-parallel
gradients, a checkpoint directory per rank; the counterpart of
``tests/test_dist_online.py`` at its shape.

Every run starts from the reference's initial state (its ``RecModel``,
carried over by ``convert.py``).  With the MLP in float32 (the script's
``main`` with ``use_mixed_precision=False``, run on each rank by
``parallel/jobs.py:online_rank``) the final parameters of the 2 ranks
equal the port's one-process run of the global stream (rank slices in
rank order) within rtol 1e-5 / atol 1e-8.  At the script's default,
through the launcher, the MLP in bfloat16, each rank rounds its half of
a weight gradient to bfloat16 before the sum over ranks (6e-4 relative
against one process in the first layer's bias), so that run is held to
the port's one-process run and to the reference's one-process oracle
(``tests/test_dist_online.py:95-123``) within the reference test's own
rtol 1e-3 / atol 5e-5.  (In float32 one deep row's gradient sum is at
rounding level at step 2 and LazyAdam's first step, lr times its sign,
goes the other way in the two packages: 8.6e-5 apart, in one process as
well.)
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
LAUNCH = REPO / "mindrec_tpu_torch" / "examples" / "run_dist_online_train.sh"
BS, F, V, STEPS = 16, 4, 256, 6
SPAWN_TIMEOUT = 110  # seconds, rank start-up included


def _batch(rng):
    return {
        "ids": rng.integers(0, V, (BS, F)).astype(np.int32),
        "wts": np.ones((BS, F), np.float32),
        "label": rng.integers(0, 2, (BS, 1)).astype(np.float32),
    }


def _reference_start(mixed: bool):
    """The reference's RecModel at the global batch and its state as a
    port state."""
    import jax

    from mindrec_tpu import RecModel
    from mindrec_tpu.models.wide_deep import WideDeepConfig, WideDeepModel
    from mindrec_tpu.train import optim
    from mindrec_tpu_torch import convert

    cfg = WideDeepConfig(batch_size=BS * 2, field_size=F, vocab_size=V,
                         emb_dim=8, deep_layer_dim=(16, 8), sparse=True,
                         use_mixed_precision=mixed)
    rm = RecModel(WideDeepModel(cfg), optim.ftrl(loss_scale=cfg.loss_scale),
                  optim.lazy_adam(loss_scale=cfg.loss_scale), donate=False)
    js = rm.state
    # copies: the port's steps update in place, the reference's state
    # must not move with them
    ts = convert.state_from_jax(
        *jax.tree.map(np.array, (js.params, js.opt_w, js.opt_d)),
        np.array(js.step), device="cpu")
    return rm, ts


@pytest.mark.parametrize("mixed", [False, True], ids=["float32", "bf16"])
def test_two_rank_online_matches_one_process(tmp_path, mixed):
    import jax

    from mindrec_tpu.train.step import flatten_params as jflat
    from mindrec_tpu_torch import RecModel
    from mindrec_tpu_torch.data.streaming import FileChannel
    from mindrec_tpu_torch.io.checkpoint import save_checkpoint
    from mindrec_tpu_torch.models.wide_deep import WideDeepConfig, WideDeepModel
    from mindrec_tpu_torch.parallel.launch import free_port, run_job
    from mindrec_tpu_torch.train import optim
    from mindrec_tpu_torch.train.step import flatten_params

    sender = FileChannel(tmp_path / "spool", num_shards=2).sender()
    rng = np.random.default_rng(0)
    per_rank = [[], []]
    for _ in range(STEPS):
        for r in range(2):
            b = _batch(rng)
            per_rank[r].append(b)
            sender.send(b, shard_id=r)
    sender.close()
    globals_ = [{k: np.concatenate([per_rank[0][i][k], per_rank[1][i][k]])
                 for k in per_rank[0][i]} for i in range(STEPS)]

    jrm, start = _reference_start(mixed)
    rtol, atol = (1e-3, 5e-5) if mixed else (1e-5, 1e-8)
    init = save_checkpoint(tmp_path / "init", start, step=0)
    env = {k: v for k, v in os.environ.items() if not k.startswith("MR_")}
    out = tmp_path / "final.npz"
    argv = ["--device", "cpu", "--batch-size", str(BS), "--field-size", str(F),
            "--vocab", str(V), "--emb-dim", "8", "--deep-layers", "16", "8",
            "--ckpt-interval", "2", "--ckpt-keep", "2", "--recv-timeout", "30",
            "--init-state", init, "--final-params", str(out)]
    if mixed:  # the script's default, through its launcher
        env.update(PYTHON=sys.executable, MR_SCHED_PORT=str(free_port()))
        r = subprocess.run(
            ["bash", str(LAUNCH), "2", str(tmp_path / "spool"), *argv],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=SPAWN_TIMEOUT)
        assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
        logs = [(tmp_path / "online_logs" / f"rank_{rank}.log").read_text()
                for rank in range(2)]
    else:
        recs, logs = run_job(
            "mindrec_tpu_torch.parallel.jobs:online_rank",
            {"device": "cpu", "config": {"use_mixed_precision": False},
             "argv": ["--spool", str(tmp_path / "spool"),
                      "--ckpt-dir", "online_ckpt", *argv]},
            2, timeout=SPAWN_TIMEOUT, env=env, cwd=tmp_path)
        assert recs == [{"steps": STEPS}] * 2
    for rank in range(2):
        log = logs[rank]
        assert f"rank {rank}: stream drained" in log and f"({STEPS} steps)" in log
        ckpts = sorted(p.name for p in
                       (tmp_path / "online_ckpt" / f"rank_{rank}").glob("*.npz"))
        assert ckpts == [f"ckpt-{s:010d}-r{rank}.npz" for s in (4, 6)], ckpts
    got = np.load(out)

    # the port's one-process run of the global stream, same start
    cfg = WideDeepConfig(batch_size=BS * 2, field_size=F, vocab_size=V,
                         emb_dim=8, deep_layer_dim=(16, 8), sparse=True,
                         use_mixed_precision=mixed)
    rm = RecModel(WideDeepModel(cfg), optim.ftrl(loss_scale=cfg.loss_scale),
                  optim.lazy_adam(loss_scale=cfg.loss_scale), device="cpu")
    rm.state = start
    for gb in globals_:
        rm.state, _ = rm.train_step(rm.state, rm._tensors(gb))
    one = {k: v.detach().float().numpy() for k, v in flatten_params(rm.state.params)}
    assert sorted(got.files) == sorted(one)
    for k in one:
        np.testing.assert_allclose(got[k], one[k], rtol=rtol, atol=atol,
                                   err_msg=f"2 ranks against 1 at {k}")

    if not mixed:
        return
    # the reference's one-process oracle (tests/test_dist_online.py:95-123)
    for gb in globals_:
        jrm.state, _ = jrm.train_step(jrm.state, gb)
    for key, leaf in jflat(jrm.state.params)[0]:
        np.testing.assert_allclose(got[key], np.asarray(leaf), rtol=1e-3,
                                   atol=5e-5, err_msg=f"reference at {key}")
    jax.clear_caches()
