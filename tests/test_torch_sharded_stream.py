"""The streamed step on the mesh (``mindrec_tpu_torch/ops/sharded_stream.py``
and the mesh composition of ``train/step.py``) against the JAX package's
``tests/test_sharded_stream.py`` regimes.

The JAX side runs its streamed Pallas path (``use_pallas=True``) in
interpret mode on a (2, 2) mesh of virtual CPU devices; the port runs
one spawn of 4 gloo ranks.  Held, over 2 steps, within rtol 1e-5 (losses)
and rtol 1e-5 / atol 1e-6 (tables, moments, FTRL state): the row-sliced
and column-sliced Wide&Deep steps, the row-sliced step fed by host prep,
the multitable model with ``emb128`` row-sliced, each also against the
port's single-device run, and the row-sliced step built with
``jit=True`` (on CPU tensors the eager step) bit for bit the eager one.
The byte counters of the collectives show every one of them below a
quarter of the sliced table's bytes.  The reference's three fallbacks
warn with its words, a one-rank mesh keeps the plain path and
``jit=True`` on a mesh builds a ``CapturedStep`` on every branch.
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindrec_tpu.models import multitable as jmt
from mindrec_tpu.models import wide_deep as jwd
from mindrec_tpu.ops.pallas import stream_update
from mindrec_tpu.parallel.mesh import shard_batch, shard_train_state
from mindrec_tpu.train import optim as jopt
from mindrec_tpu.train import step as jstep
from mindrec_tpu_torch.models import wide_deep
from mindrec_tpu_torch.parallel import mesh as pm
from mindrec_tpu_torch.parallel.jobs import save_batches
from mindrec_tpu_torch.train import optim
from mindrec_tpu_torch.train.step import (
    CapturedStep, init_train_state, make_train_step,
)
from test_torch_mesh import (
    assert_states_close, check_losses, flat, jax_flat, jax_mesh, merged,
    save_state, single_run, spawn, state_from_jax,
)


@pytest.fixture(autouse=True, scope="module")
def _interpret_kernels():
    stream_update.INTERPRET = True
    yield
    stream_update.INTERPRET = False


WD = dict(batch_size=32, field_size=8, vocab_size=3000, emb_dim=8,
          deep_layer_dim=[16], use_mixed_precision=False, sparse=True,
          deep_table_slice_mode="table_row_slice", loss_scale=1024.0)
MT = dict(batch_size=16, continue_field_size=4, indicator_field_size=2,
          emb128_field_size=1, emb64_single_field_size=2,
          multi_hot_sizes=[3, 4, 3, 2, 2, 3], emb_128_size=100,
          emb64_single_size=50, emb64_multi_size=60, indicator_size=16,
          deep_layer_dim=[32, 16], use_mixed_precision=False,
          loss_scale=1000.0, sparse=True, emb128_slice_mode="table_row_slice")
BYTES = dict(batch_size=32, field_size=39, vocab_size=131072, emb_dim=16,
             deep_layer_dim=[64, 32], sparse=True,
             deep_table_slice_mode="table_row_slice", loss_scale=1024.0)
F32 = {"matmul_dtype": "float32", "use_pallas": True}


def _wd_batches(cfg, n=2):
    out = []
    for s in range(n):
        rng = np.random.default_rng(s)
        B, F = cfg["batch_size"], cfg["field_size"]
        out.append({
            "ids": rng.integers(0, cfg["vocab_size"], (B, F)).astype(np.int32),
            "wts": np.ones((B, F), np.float32),
            "label": (rng.uniform(size=(B, 1)) > 0.5).astype(np.float32)})
    return out


def _mt_batches(n=2):
    out = []
    for s in range(n):
        rng = np.random.default_rng(s)
        B = MT["batch_size"]
        b = {
            "continue_val": rng.uniform(size=(B, 4)).astype(np.float32),
            "indicator_id": rng.integers(0, 16, (B, 2)).astype(np.int32),
            "emb_128_id": rng.integers(0, 100, (B, 1)).astype(np.int32),
            "emb_64_single_id": rng.integers(0, 50, (B, 2)).astype(np.int32),
            "label": (rng.uniform(size=(B, 1)) > 0.5).astype(np.float32),
        }
        for name, L in zip(jmt.MULTI_FIELDS, MT["multi_hot_sizes"]):
            b[f"multi_{name}_id"] = rng.integers(0, 60, (B, L)).astype(np.int32)
            lens = rng.integers(1, L + 1, B)
            b[f"multi_{name}_mask"] = (
                np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
        out.append(b)
    return out


def _tuples(cfg):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}


def _jax_run(model, model_m, opts, batches, mesh):
    js = jstep.init_train_state(model, jax.random.PRNGKey(0), *opts)
    init = state_from_jax(js)
    with mesh:
        st = shard_train_state(js, model_m, mesh)
        step = jstep.make_train_step(model_m, *opts, jit=True, donate=False,
                                     use_pallas=True, matmul_dtype=jnp.float32)
        losses = []
        for b in batches:
            st, (lw, ld) = step(st, shard_batch(b, mesh))
            losses.append((float(lw), float(ld)))
    return init, jax_flat(st), losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_stream")
    jm = jax_mesh()
    specs, ref = {}, {}
    wd_b, mt_b = str(tmp / "wd.npz"), str(tmp / "mt.npz")
    save_batches(wd_b, _wd_batches(WD))
    save_batches(mt_b, _mt_batches())
    ls = WD["loss_scale"]
    wd_opts = ({"kind": "ftrl", "loss_scale": ls},
               {"kind": "lazy_adam", "loss_scale": ls})
    for name, slice_mode in (("row", "table_row_slice"),
                             ("column", "table_column_slice")):
        cfg = {**WD, "deep_table_slice_mode": slice_mode}
        jo = (jopt.ftrl(loss_scale=ls), jopt.lazy_adam(loss_scale=ls))
        init, want, losses = _jax_run(
            jwd.WideDeepModel(jwd.WideDeepConfig(**_tuples(cfg))),
            jwd.WideDeepModel(jwd.WideDeepConfig(**_tuples(cfg)), mesh=jm),
            jo, _wd_batches(WD), jm)
        ref[name] = (want, losses)
        specs[name] = dict(net={"name": "wide_deep", "config": cfg},
                           opt_w=wd_opts[0], opt_d=wd_opts[1],
                           state=save_state(tmp / f"{name}-init", init),
                           batches=wd_b, step=F32, out=str(tmp / name))
    specs["host_prep"] = {**specs["row"], "prep": True,
                          "out": str(tmp / "host_prep")}
    ref["host_prep"] = ref["row"]
    specs["row_jit"] = {**specs["row"], "step": {**F32, "jit": True},
                        "out": str(tmp / "row_jit")}
    mls = MT["loss_scale"]
    jo = (jopt.ftrl(loss_scale=mls), jopt.lazy_adam(loss_scale=mls))
    init, want, losses = _jax_run(
        jmt.MultiTableWideDeepModel(jmt.MultiTableConfig(**_tuples(MT))),
        jmt.MultiTableWideDeepModel(jmt.MultiTableConfig(**_tuples(MT)), mesh=jm),
        jo, _mt_batches(), jm)
    ref["multitable"] = (want, losses)
    specs["multitable"] = dict(
        net={"name": "multitable", "config": MT},
        opt_w={"kind": "ftrl", "loss_scale": mls},
        opt_d={"kind": "lazy_adam", "loss_scale": mls},
        state=save_state(tmp / "mt-init", init), batches=mt_b, step=F32,
        out=str(tmp / "multitable"))
    bb = str(tmp / "bytes.npz")
    save_batches(bb, _wd_batches(BYTES, n=1))
    specs["bytes"] = dict(net={"name": "wide_deep", "config": BYTES},
                          opt_w=wd_opts[0], opt_d=wd_opts[1], batches=bb)
    names = list(specs)
    recs = spawn([{"data": 2, "model": 2, **specs[n]} for n in names], 4)
    out = {}
    for name, rec in zip(names, recs):
        if name == "bytes":
            out[name] = dict(records=rec)
            continue
        if name == "row_jit":  # held to the eager run, bit for bit
            out[name] = dict(records=rec,
                             mesh=flat(merged(rec, out["row"]["like"])))
            continue
        single, s_losses = single_run(specs[name])
        out[name] = dict(records=rec, mesh=flat(merged(rec, single)),
                         single=flat(single), single_losses=s_losses,
                         jax=ref[name], like=single)
    return out


def _check(r):
    losses = r["records"][0]["losses"]
    for rec in r["records"][1:]:
        np.testing.assert_array_equal(rec["losses"], losses)
    check_losses(losses, r["single_losses"])
    assert_states_close(r["mesh"], r["single"])
    want, jl = r["jax"]
    check_losses(losses, jl)
    assert_states_close(r["mesh"], want)


def test_row_sliced_streamed_step_matches_reference(runs):
    _check(runs["row"])


def test_column_sliced_streamed_step_matches_reference(runs):
    _check(runs["column"])


def test_sharded_streamed_with_host_prep(runs):
    """Host prep's ``uq_ids`` arrive sliced over data and are gathered
    back: the same run as the device-derived unique vector."""
    _check(runs["host_prep"])
    np.testing.assert_array_equal(runs["host_prep"]["records"][0]["losses"],
                                  runs["row"]["records"][0]["losses"])


def test_captured_sharded_step_equals_eager(runs):
    """``jit=True`` on the mesh (the eager step on CPU tensors): losses on
    every rank and the merged state bit for bit the eager run's, so
    within the tolerances above of the JAX package's jitted mesh step."""
    got, want = runs["row_jit"], runs["row"]
    for rec, ref in zip(got["records"], want["records"]):
        assert rec["losses"] == ref["losses"]
        assert rec["collectives"] == ref["collectives"]
        assert rec["launches"] == ref["launches"]
        assert rec["captures"] == rec["replays"] == 0
    assert_states_close(got["mesh"], want["mesh"], rtol=0, atol=0)
    jstate, jl = want["jax"]
    check_losses(got["records"][0]["losses"], jl)
    assert_states_close(got["mesh"], jstate)


def test_multitable_sharded_matches_reference(runs):
    """emb128 row-sliced, the other id groups replicated, the indicator
    group on the tiny path summed per data rank."""
    _check(runs["multitable"])


def test_collectives_stay_batch_scale(runs):
    """Every collective of the row-sliced streamed step (gathered rows,
    summed gradients, dense gradients, unique ids, losses) moves less
    than a quarter of the deep table's bytes."""
    spec = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(
        **_tuples(BYTES))).deep_spec
    table_bytes = int(np.prod(spec.storage_shape)) * 4
    for rec in runs["bytes"]["records"]:
        coll = rec["collectives"][0]
        ops = {(op, ax) for op, ax, _ in coll}
        assert {("all_gather", "data"), ("all_reduce", "model"),
                ("all_reduce", "data")} <= ops
        assert max(b for *_, b in coll) < table_bytes / 4, coll


def _warning(fn):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fn()
    msgs = [str(x.message) for x in w if "falling back" in str(x.message)]
    assert len(msgs) == 1, msgs
    return msgs[0]


@pytest.mark.parametrize("case", ["column_fold", "row_layout_sliced",
                                  "row_layout_dp", "no_data_axis"])
def test_fallback_warnings_word_for_word(case):
    """The reference's fallbacks of the streamed path on a mesh fire on
    the same configurations with the same words, and take the generic
    path."""
    from jax.sharding import Mesh

    cfg = dict(WD, table_layout="feature_major")
    kw = {}
    if case == "column_fold":  # a folded table cannot column-slice
        cfg.update(emb_dim=1, deep_table_slice_mode="table_column_slice")
    if case in ("row_layout_sliced", "row_layout_dp"):
        kw["row_layout"] = False
    if case == "row_layout_dp":
        cfg["deep_table_slice_mode"] = "none"
    if case == "no_data_axis":
        jm = Mesh(np.array(jax.devices()[:2]), ("model",))
        tm = pm.Mesh(1, 2, axis_names=("model",))
    else:
        jm, tm = jax_mesh(), pm.Mesh(2, 2)
    jmodel = jwd.WideDeepModel(jwd.WideDeepConfig(**_tuples(cfg)), mesh=jm)
    want = _warning(lambda: jstep.make_train_step(
        jmodel, jopt.ftrl(), jopt.lazy_adam(), use_pallas=True, **kw))
    tmodel = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**_tuples(cfg)),
                                     mesh=tm)
    fn = None

    def build():
        nonlocal fn
        fn = make_train_step(tmodel, optim.ftrl(), optim.lazy_adam(),
                             use_pallas=True, **kw)

    assert _warning(build) == want
    assert fn.__name__ == "step_generic"


def test_single_device_mesh_keeps_plain_path():
    """A one-rank mesh: no warning, and the step is the plain one, bit
    for bit."""
    cfg = wide_deep.WideDeepConfig(**_tuples(WD))
    b = {k: torch.from_numpy(v) for k, v in _wd_batches(WD, n=1)[0].items()}
    out = []
    for mesh in (None, pm.Mesh(1, 1)):
        model = wide_deep.WideDeepModel(cfg, mesh=mesh)
        st = init_train_state(model, 0, optim.ftrl(), optim.lazy_adam(),
                              device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            step = make_train_step(model, optim.ftrl(), optim.lazy_adam())
        st, losses = step(st, b)
        out.append((flat(st), [float(x) for x in losses]))
    assert out[0][1] == out[1][1]
    assert_states_close(out[1][0], out[0][0], rtol=0, atol=0)


@pytest.mark.parametrize("branch,cfg,kw", [
    ("step_rows", {}, {}),
    ("step_generic", {}, {"use_pallas": False}),
    ("step_dense", {"sparse": False}, {}),
], ids=["streamed", "generic", "dense"])
def test_capture_on_a_mesh_builds_a_captured_step(branch, cfg, kw):
    """``jit=True`` on a (2, 2) mesh captures the streamed, the generic
    and the dense step (``CapturedStep`` around the branch, its graphs
    cut at every collective on the card); nothing builds an eager step
    in its place."""
    model = wide_deep.WideDeepModel(
        wide_deep.WideDeepConfig(**_tuples({**WD, **cfg})), mesh=pm.Mesh(2, 2))
    step = make_train_step(model, optim.ftrl(), optim.lazy_adam(), jit=True,
                           **kw)
    assert isinstance(step, CapturedStep)
    assert step.step.__name__ == branch
    assert step.graphs == 0 and step.segments == []


def test_local_segments_in_global_order():
    """A data rank's sum in the global unique order: its own ids sorted,
    each at its id's place among the global unique ids (gaps where the
    rank has no position, zero there), equal to a float64 sum over the
    global indices; no gradient row is read twice or out of range."""
    from mindrec_tpu_torch.ops import sharded_stream as ss

    rng = np.random.default_rng(3)
    glob = rng.integers(0, 5000, size=900)
    ub = 1024
    uq_np = np.unique(glob)
    uq = torch.from_numpy(np.concatenate(
        [uq_np, np.full(ub - uq_np.size, 2**31 - 2)]).astype(np.int32))
    ids = glob[:300]  # this rank's positions
    g = rng.normal(size=(ids.size, 5)).astype(np.float32)
    uidx, perm = ss.local_segments(torch.from_numpy(ids), uq)
    assert uidx.dtype == perm.dtype == torch.int32
    assert (torch.diff(uidx) >= 0).all() and (torch.diff(uidx) > 1).any()
    assert sorted(perm.tolist()) == list(range(ids.size))
    want = np.zeros((ub, 5))
    np.add.at(want, np.searchsorted(uq_np, ids), g.astype(np.float64))
    got = ss.partial_segsum_sharded(pm.Mesh(1, 1), torch.from_numpy(g),
                                    torch.from_numpy(ids), uq, ub)
    np.testing.assert_allclose(got.numpy(), want.T, rtol=1e-6, atol=1e-6)
    assert (got.numpy()[:, ~np.isin(np.arange(ub), uidx.numpy())] == 0).all()
