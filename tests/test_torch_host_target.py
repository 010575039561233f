"""The host-target regime (``parameter_server=True, vocab_cache_size=0``:
tables in host tiers or on table servers, the row optimiser on the host)
against the reference's ``HostTargetAdapter`` and against the port's own
device sparse step.

The dense state comes from JAX through ``convert.py``; both sides' tiers
are seeded with the same rows (host tiers draw from different generators
in the two packages).  The reference's expansion gradient is XLA's
scatter-add, the port's the sorted segment-sum (its plain version here):
losses rtol 1e-5, rows and dense parameters rtol 1e-5, atol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindrec_tpu.models import wide_deep as jwd
from mindrec_tpu.train import host_target as jht
from mindrec_tpu.train import optim as jopt
from mindrec_tpu_torch import convert
from mindrec_tpu_torch.data.criteo import to_device
from mindrec_tpu_torch.models import wide_deep
from mindrec_tpu_torch.ops.embedding import read_rows
from mindrec_tpu_torch.train import host_target, optim
from mindrec_tpu_torch.train.step import (
    flatten_params, init_train_state, make_train_step,
)
from test_torch_remote import servers

CFG = dict(batch_size=16, field_size=4, vocab_size=500, emb_dim=8,
           deep_layer_dim=(16, 8), use_mixed_precision=False, sparse=True,
           parameter_server=True, loss_scale=1.0)
STEPS = 4


def _batch(rng):
    B, F = CFG["batch_size"], CFG["field_size"]
    return {"ids": rng.integers(0, CFG["vocab_size"], (B, F)).astype(np.int32),
            "wts": rng.uniform(0.5, 1.5, (B, F)).astype(np.float32),
            "label": rng.integers(0, 2, (B, 1)).astype(np.float32)}


def _batches(seed=0, n=STEPS):
    rng = np.random.default_rng(seed)
    return [_batch(rng) for _ in range(n)]


def _seed_rows(adapters, dims, seed=7):
    """The same initial rows of every id in every adapter's param tiers."""
    rng = np.random.default_rng(seed)
    ids = np.arange(CFG["vocab_size"])
    for name, d in dims.items():
        rows = rng.normal(0, 0.01, (ids.size, d)).astype(np.float32)
        for ad in adapters:
            ad.tiers[name]["param"].write(ids, rows)


def _jax_keys(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            np.asarray(v) for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_spec_declares_host_target():
    """PS mode without the cache declares host tables; the cache or no PS
    keeps them on the device; the device step refuses host tables, naming
    the adapter."""
    model = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**CFG))
    assert model.deep_spec.target == model.wide_spec.target == "host"
    for change in ({"parameter_server": False}, {"vocab_cache_size": 64}):
        m = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**{**CFG, **change}))
        assert m.deep_spec.target == m.wide_spec.target == "device"
    with pytest.raises(NotImplementedError, match="HostTargetAdapter"):
        make_train_step(model, optim.ftrl(), optim.lazy_adam())
    state = host_target.init_dense_state(model, 0, optim.ftrl(),
                                         optim.lazy_adam(), device="cpu")
    keys = [k for k, _ in flatten_params(state.params)]
    assert not any("table" in k for k in keys) and "wide/bias" in keys


def _pair(tmp_path, tier, opts):
    """(reference adapter, port adapter, reference state, port state)."""
    jm = jwd.WideDeepModel(jwd.WideDeepConfig(**CFG))
    tm = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**CFG))
    kw = dict(vocab_size=CFG["vocab_size"], unique_bucket=64, spill_dir=str(tmp_path))
    jo, to = opts
    ref = jht.HostTargetAdapter(jm, opt_w=jo[0], opt_d=jo[1],
                                matmul_dtype=jnp.float32,
                                remote_addrs=tier.get("ref"), **kw)
    port = host_target.HostTargetAdapter(tm, opt_w=to[0], opt_d=to[1],
                                         matmul_dtype=torch.float32,
                                         remote_addrs=tier.get("port"), **kw)
    _seed_rows((ref, port), {"wide": 1, "deep": CFG["emb_dim"]})
    js = jht.init_dense_state(jm, jax.random.PRNGKey(0), *jo)
    ts = convert.state_from_jax(*jax.tree.map(np.asarray, (
        js.params, js.opt_w, js.opt_d)), np.asarray(js.step), device="cpu")
    return ref, port, js, ts


def _opts(kind):
    if kind == "ftrl+adam":
        return ((jopt.ftrl(loss_scale=1.0), jopt.lazy_adam(loss_scale=1.0)),
                (optim.ftrl(loss_scale=1.0), optim.lazy_adam(loss_scale=1.0)))
    return ((jopt.lazy_adam(loss_scale=1.0), jopt.ftrl(loss_scale=1.0, l1=1e-3)),
            (optim.lazy_adam(loss_scale=1.0), optim.ftrl(loss_scale=1.0, l1=1e-3)))


@pytest.mark.parametrize("where,kind", [("host", "ftrl+adam"),
                                        ("server", "ftrl+adam"),
                                        ("host", "adam+ftrl")])
def test_host_target_matches_reference(tmp_path, where, kind):
    """The port's adapter against the reference's over 4 steps from one
    dense state and the same tier rows, on host tiers or on each
    package's own table server: losses, the touched rows of every tier,
    and the dense parameters."""
    batches = _batches()
    if where == "host":
        ref, port, js, ts = _pair(tmp_path, {}, _opts(kind))
        runs = _run_pair(ref, port, js, ts, batches)
    else:
        with servers("port", 2, tmp_path / "p") as pa, \
                servers("ref", 2, tmp_path / "r") as ra:
            ref, port, js, ts = _pair(tmp_path, {"port": pa, "ref": ra},
                                      _opts(kind))
            runs = _run_pair(ref, port, js, ts, batches)
    (jl, tl), (js, ts), (jrows, trows) = runs
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for k in jrows:
        np.testing.assert_allclose(trows[k], jrows[k], rtol=1e-5, atol=1e-6,
                                   err_msg=str(k))
    want = _jax_keys(js.params)
    for k, t in flatten_params(ts.params):
        np.testing.assert_allclose(t.numpy(), want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert int(ts.step) == STEPS


def _run_pair(ref, port, js, ts, batches):
    jl, tl = [], []
    for b in batches:
        js, (lw, ld) = ref.train_step(js, b)
        ts, (lw2, ld2) = port.train_step(ts, b)
        jl += [float(lw), float(ld)]
        tl += [float(lw2), float(ld2)]
    touched = np.unique(np.concatenate([b["ids"].ravel() for b in batches]))
    rows = [{(n, t): tier.read(touched) for n, tiers in ad.tiers.items()
             for t, tier in tiers.items()} for ad in (ref, port)]
    return (jl, tl), (js, ts), rows


def test_eval_step_matches_reference(tmp_path):
    ref, port, js, ts = _pair(tmp_path, {}, _opts("ftrl+adam"))
    b = _batches(seed=1, n=1)[0]
    js, _ = ref.train_step(js, b)
    ts, _ = port.train_step(ts, b)
    want, wl = ref.eval_step(js.params, b)
    got, gl = port.eval_step(ts.params, b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    assert gl is b["label"] and wl is b["label"]


def test_host_target_matches_port_device_step(tmp_path):
    """The port's host-target run against its own device sparse step (the
    same model without PS mode) from the same tables and dense state:
    losses, the touched rows and the dense parameters (both expand the
    rows in float32; the device step's row updates run in float32, the
    host's in float64)."""
    dev_model = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(
        **{**CFG, "parameter_server": False}))
    ps_model = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**CFG))
    opts = lambda: (optim.ftrl(loss_scale=1.0), optim.lazy_adam(loss_scale=1.0))  # noqa: E731
    state = init_train_state(dev_model, 0, *opts(), device="cpu")
    ids = np.arange(CFG["vocab_size"])
    init = {n: read_rows(spec, state.params[p[0]][p[1]], ids).numpy().copy()
            for n, (p, spec) in dev_model.table_specs.items()}
    adapter = host_target.HostTargetAdapter(
        ps_model, CFG["vocab_size"], 64, *opts(), spill_dir=str(tmp_path),
        matmul_dtype=torch.float32)
    for n, rows in init.items():
        adapter.tiers[n]["param"].write(ids, rows)
    hstate = host_target.init_dense_state(ps_model, 0, *opts(), device="cpu")
    dense = dict(flatten_params(state.params))
    for k, t in flatten_params(hstate.params):
        t.copy_(dense[k])
    step = make_train_step(dev_model, *opts(), matmul_dtype=torch.float32)
    batches = _batches(seed=2)
    for b in batches:
        state, (lw, ld) = step(state, to_device(b, "cpu"))
        hstate, (hw, hd) = adapter.train_step(hstate, b)
        np.testing.assert_allclose([float(hw), float(hd)],
                                   [float(lw), float(ld)], rtol=1e-5)
    touched = np.unique(np.concatenate([b["ids"].ravel() for b in batches]))
    for n, (p, spec) in dev_model.table_specs.items():
        np.testing.assert_allclose(
            adapter.read_rows(n, touched),
            read_rows(spec, state.params[p[0]][p[1]], touched).numpy(),
            rtol=1e-5, atol=1e-6, err_msg=n)
    dense = dict(flatten_params(state.params))
    for k, t in flatten_params(hstate.params):
        np.testing.assert_allclose(t.numpy(), dense[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_bucket_overflow_and_sort_ids():
    """``sort_ids`` gives ``np.unique``'s ascending ids and inverse with a
    stable ``perm``; a batch past the bucket raises."""
    rng = np.random.default_rng(3)
    ids = rng.integers(-50, 50, 400).astype(np.int64)
    uq, uidx, perm, uidx_sorted = host_target.sort_ids(ids)
    want_uq, want_inv = np.unique(ids, return_inverse=True)
    np.testing.assert_array_equal(uq, want_uq)
    np.testing.assert_array_equal(uidx, want_inv)
    np.testing.assert_array_equal(perm, np.argsort(ids, kind="stable"))
    np.testing.assert_array_equal(uidx_sorted, uidx[perm])
    model = wide_deep.WideDeepModel(wide_deep.WideDeepConfig(**CFG))
    ad = host_target.HostTargetAdapter(model, CFG["vocab_size"], 8,
                                       optim.ftrl(), optim.lazy_adam())
    state = host_target.init_dense_state(model, 0, optim.ftrl(),
                                         optim.lazy_adam(), device="cpu")
    with pytest.raises(RuntimeError, match="unique_bucket"):
        ad.train_step(state, _batches(n=1)[0])
    assert dataclasses.is_dataclass(model.config)
