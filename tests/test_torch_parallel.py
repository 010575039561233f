"""Mesh-parallel training of the port against the JAX package's mesh
(``tests/test_parallel.py``'s regimes) and against the port's own
single-device step.

The port's ranks run in one spawn of 4 gloo processes on a (data 2,
model 2) mesh (``parallel/jobs.py``); the JAX side runs each regime on a
(2, 2) mesh of 4 virtual CPU devices with its defaults (the generic path
on the CPU).  Regimes: data parallelism of the dense step, the sparse
step with the deep table row-sliced (streamed, full-batch input, and the
generic path), column-sliced, DeepFM and DCN row-sliced, the dense step
over a row-sliced table, dropout and the overflow guard.  Losses agree
within rtol 1e-5, tables and optimizer state within rtol 1e-5, atol 1e-6.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from mindrec_tpu.models import dcn as jdcn
from mindrec_tpu.models import deepfm as jdeepfm
from mindrec_tpu.models import wide_deep as jwd
from mindrec_tpu.parallel.mesh import shard_batch, shard_train_state
from mindrec_tpu.train import optim as jopt
from mindrec_tpu.train import step as jstep
from mindrec_tpu_torch.parallel.jobs import save_batches
from test_torch_mesh import (
    assert_states_close, check_losses, flat, jax_flat, jax_mesh, merged,
    save_state, single_run, spawn, state_from_jax,
)

BASE = dict(batch_size=32, field_size=8, vocab_size=512, emb_dim=8,
            deep_layer_dim=[32, 16], use_mixed_precision=False,
            loss_scale=1.0)
FTRL_ADAM = ({"kind": "ftrl"}, {"kind": "lazy_adam"})
ADAM_ADAM = ({"kind": "adam", "loss_scale": 1.0},
             {"kind": "adam", "loss_scale": 1.0})
F32 = {"matmul_dtype": "float32"}


def _batches(n=2, cfg=BASE, seed0=0):
    out = []
    for s in range(seed0, seed0 + n):
        rng = np.random.default_rng(s)
        B, F = cfg["batch_size"], cfg["field_size"]
        out.append({
            "ids": rng.integers(0, cfg["vocab_size"], (B, F)).astype(np.int32),
            "wts": np.ones((B, F), np.float32),
            "label": (rng.uniform(size=(B, 1)) > 0.5).astype(np.float32),
        })
    return out


REGIMES = {
    # name: (net, jax model class+config, opts, port step kw, extra)
    "dp": ("wide_deep", {}, FTRL_ADAM, F32, {}),
    "hybrid": ("wide_deep", {"sparse": True,
                             "deep_table_slice_mode": "table_row_slice"},
               FTRL_ADAM, F32, {}),
    "column": ("wide_deep", {"sparse": True,
                             "deep_table_slice_mode": "table_column_slice"},
               FTRL_ADAM, F32, {}),
    "deepfm": ("deepfm", {"sparse": True, "table_slice_mode": "table_row_slice"},
               ADAM_ADAM, F32, {}),
    "dcn": ("dcn", {"sparse": True, "table_slice_mode": "table_row_slice",
                    "cross_layer_num": 2}, ADAM_ADAM, F32, {}),
    "dense_sliced": ("wide_deep", {"deep_table_slice_mode": "table_row_slice"},
                     FTRL_ADAM, F32, {}),
}
PORT_ONLY = {
    # name: (regime it equals on the JAX side or None, step kw, extra)
    "full_batch": ("hybrid", F32, {"full_batch": True}),
    "generic": ("hybrid", {"use_pallas": False}, {}),
    "dropout": (None, F32, {"dropout_flag": True, "keep_prob": 0.8}),
    "guard": (None, {**F32, "check_overflow": True}, {"inf": True}),
}


def _net(name, cfg):
    c = {k: v for k, v in {**BASE, **cfg}.items()
         if not (name == "dcn" and k == "use_mixed_precision")}
    return {"name": name, "config": c}


def _jax_model(name, cfg, mesh=None):
    c = {k: tuple(v) if isinstance(v, list) else v
         for k, v in _net(name, cfg)["config"].items()}
    mod = {"wide_deep": (jwd.WideDeepConfig, jwd.WideDeepModel),
           "deepfm": (jdeepfm.DeepFMConfig, jdeepfm.DeepFMModel),
           "dcn": (jdcn.DCNConfig, jdcn.DCNModel)}[name]
    return mod[1](mod[0](**c), mesh=mesh)


def _jax_opt(spec):
    kw = {k: v for k, v in spec.items() if k != "kind"}
    return getattr(jopt, spec["kind"])(**kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every regime: the JAX mesh run, the port's 4-rank run (one spawn)
    and the port's single-device run, from one JAX init."""
    tmp = tmp_path_factory.mktemp("parallel")
    batches = _batches()
    bpath = str(tmp / "batches.npz")
    save_batches(bpath, batches)
    bad = [dict(b) for b in batches]
    bad[0]["wts"] = bad[0]["wts"].copy()
    bad[0]["wts"][3, 1] = np.inf  # data rank 0's slice
    badpath = str(tmp / "bad.npz")
    save_batches(badpath, bad)
    jm = jax_mesh()
    specs, jax_out = {}, {}
    for name, (net, cfg, opts, kw, _x) in REGIMES.items():
        jopts = tuple(_jax_opt(o) for o in opts)
        js = jstep.init_train_state(_jax_model(net, cfg), jax.random.PRNGKey(0),
                                    *jopts)
        spath = save_state(tmp / f"{name}-init", state_from_jax(js))
        specs[name] = dict(net=_net(net, cfg), opt_w=opts[0], opt_d=opts[1],
                           state=spath, batches=bpath, step=kw,
                           out=str(tmp / f"{name}-out"))
        model_m = _jax_model(net, cfg, jm)
        with jm:
            st = shard_train_state(js, model_m, jm)
            step = jstep.make_train_step(model_m, *jopts, jit=True, donate=False)
            losses = []
            for b in batches:
                st, (lw, ld) = step(st, shard_batch(b, jm))
                losses.append((float(lw), float(ld)))
        jax_out[name] = (jax_flat(st), losses)
    for name, (base, kw, extra) in PORT_ONLY.items():
        net = "wide_deep"
        cfg = dict(REGIMES[base][1]) if base else {}
        cfg.update({k: v for k, v in extra.items() if k in ("dropout_flag",
                                                              "keep_prob")})
        specs[name] = dict(
            net=_net(net, cfg), opt_w=FTRL_ADAM[0], opt_d=FTRL_ADAM[1],
            state=specs[base]["state"] if base else None,
            batches=badpath if extra.get("inf") else bpath, step=kw,
            full_batch=extra.get("full_batch", False),
            out=str(tmp / f"{name}-out"))
    specs["hybrid"]["unsliced"] = str(tmp / "hybrid-whole")
    names = list(specs)
    recs = spawn([{"data": 2, "model": 2, **specs[n]} for n in names], 4)
    out = {}
    for name, rec in zip(names, recs):
        single, s_losses = single_run(specs[name])
        out[name] = dict(records=rec, mesh=flat(merged(rec, single)),
                         single=flat(single), single_losses=s_losses,
                         like=single,
                         jax=jax_out.get(name) or jax_out.get(
                             PORT_ONLY.get(name, (None,))[0]))
    return out


def _check(r, name):
    losses = r["records"][0]["losses"]
    for rec in r["records"][1:]:  # every rank reports the global losses
        np.testing.assert_array_equal(rec["losses"], losses)
    check_losses(losses, r["single_losses"])
    assert_states_close(r["mesh"], r["single"])
    if r["jax"] is not None:
        want, jl = r["jax"]
        check_losses(losses, jl)
        assert_states_close(r["mesh"], want)


def test_dp_matches_single_device(runs):
    """Dense step, batch split over data: post-step parameters equal the
    single-device step on the global batches (the gradient reduction)."""
    _check(runs["dp"], "dp")


def test_dp_diverges_if_not_reduced(runs):
    """The oracle detects a missing reduction: training on one data
    rank's half of each batch gives other parameters."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        half = [{k: v[:16] for k, v in b.items()} for b in _batches()]
        save_batches(f"{tmp}/h.npz", half)
        jopts = tuple(_jax_opt(o) for o in FTRL_ADAM)
        js = jstep.init_train_state(_jax_model("wide_deep", {}),
                                    jax.random.PRNGKey(0), *jopts)
        spath = save_state(f"{tmp}/init", state_from_jax(js))
        st, _ = single_run(dict(net=_net("wide_deep", {}), opt_w=FTRL_ADAM[0],
                                opt_d=FTRL_ADAM[1], state=spath,
                                batches=f"{tmp}/h.npz", step=F32))
    with pytest.raises(AssertionError):
        assert_states_close(flat(st), runs["dp"]["mesh"])


def test_hybrid_row_slice_matches_unsharded(runs):
    """Row-sliced sparse training == the unsharded step (JAX's mesh and
    the port's one device); the whole state rank 0 gathers over the
    model axis equals the merged sliced files bit for bit."""
    from mindrec_tpu_torch.io.checkpoint import restore_checkpoint

    r = runs["hybrid"]
    _check(r, "hybrid")
    assert "unsliced" not in r["records"][1]
    whole = flat(restore_checkpoint(r["records"][0]["unsliced"],
                                    r["like"]))
    for k, v in r["mesh"].items():
        np.testing.assert_array_equal(whole[k], v, err_msg=k)


def test_full_batch_mode(runs):
    """Every rank given the whole batch takes its own slice: the same
    post-step state as the sharded input."""
    _check(runs["full_batch"], "full_batch")


def test_column_slice_matches_unsharded(runs):
    _check(runs["column"], "column")


@pytest.mark.parametrize("which", ["deepfm", "dcn"])
def test_other_models_row_slice_matches_unsharded(runs, which):
    _check(runs[which], which)


def test_dense_step_over_a_sliced_table(runs):
    """The dense step with the deep table row-sliced: the sharded lookup
    and its l2 term summed over model, every gradient over data."""
    _check(runs["dense_sliced"], "dense_sliced")


def test_generic_path_on_a_mesh(runs):
    """use_pallas=False: each table's position gradients gathered over
    data, each rank updating its owned ids."""
    _check(runs["generic"], "generic")


def test_dropout_draws_the_global_rows(runs):
    """Each data rank draws its rows' masks of the global batch, so the
    mesh run trains as the single-device one."""
    _check(runs["dropout"], "dropout")


def test_overflow_guard_on_a_mesh(runs):
    """A non-finite weight in data rank 0's slice: every rank skips the
    step alike (the flag is ANDed over all ranks), as one device does."""
    r = runs["guard"]
    _check(r, "guard")
    assert not np.isfinite(r["records"][0]["losses"][0][1])
