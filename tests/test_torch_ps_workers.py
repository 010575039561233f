"""Several PS workers over one set of table servers
(``mindrec_tpu_torch/parallel/jobs.py:ps_worker``), the port's
counterpart of ``tests/mp_scripts/ps_worker.py``: 2 table servers and 2
workers, each a gloo rank on the CPU training the cache regime over
``RemoteTier``, each owning the ids ``i % 2 == worker``.

The rows the servers hold at the end equal the port's one-process run of
each worker's batches (host tiers, same process) bit for bit, and the
reference's ``ps_worker.build_and_train(None, worker, 2)`` run in this
process from the same initial state (carried over by ``convert.py``)
within rtol 1e-4 / atol 1e-8.  Both packages run the MLP and the rows in
float32 for that comparison (the reference module's config and step
factory are patched in this process; no file changes): in bfloat16 XLA
and PyTorch round the products in other orders, and after 4 steps the
deep rows differed by up to 3.7e-2 relative (2.2e-6 absolute), the wide
ones by 8.2e-3; in float32 by at most 2.7e-7 (params) and 1.1e-4 (Adam's
v, at 4e-22 absolute).
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mindrec_tpu_torch.parallel import jobs, launch

REPO = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 110  # seconds, rank start-up included

# the shape of tests/mp_scripts/ps_worker.py
SPEC = {"vocab": 100_000, "cache_rows": 64, "batch": 8, "fields": 4,
        "emb": 8, "layers": [16, 8], "steps": 4, "workers": 2,
        "loss_scale": 1.0, "seed": 100, "mixed": False,
        "matmul_dtype": "float32"}


def _ref_ps_worker():
    sys.path.insert(0, str(REPO / "tests" / "mp_scripts"))
    try:
        import ps_worker
    finally:
        sys.path.pop(0)
    return ps_worker


@pytest.fixture()
def ref_f32(monkeypatch):
    """The reference worker module, its model and step in float32."""
    import functools

    import jax.numpy as jnp

    ref = _ref_ps_worker()
    cfg, factory = ref.WideDeepConfig, ref.make_train_step
    monkeypatch.setattr(ref, "WideDeepConfig", lambda **kw: cfg(
        **kw, use_mixed_precision=False))
    monkeypatch.setattr(ref, "make_train_step", functools.partial(
        factory, matmul_dtype=jnp.float32))
    return ref


@pytest.fixture(scope="module")
def ref_state(tmp_path_factory):
    """The reference worker's initial state, saved as a port checkpoint."""
    import jax

    from mindrec_tpu.models.wide_deep import WideDeepConfig, WideDeepModel
    from mindrec_tpu.train import optim
    from mindrec_tpu.train.step import init_train_state
    from mindrec_tpu_torch import convert
    from mindrec_tpu_torch.io.checkpoint import save_checkpoint

    ref = _ref_ps_worker()
    model = WideDeepModel(WideDeepConfig(
        batch_size=ref.B, field_size=ref.F, vocab_size=ref.CACHE_ROWS,
        emb_dim=ref.D, deep_layer_dim=(16, 8), sparse=True, loss_scale=1.0,
        use_mixed_precision=False))
    js = init_train_state(model, 0, optim.ftrl(loss_scale=1.0),
                          optim.lazy_adam(loss_scale=1.0))
    ts = convert.state_from_jax(
        *jax.tree.map(np.asarray, (js.params, js.opt_w, js.opt_d)),
        np.asarray(js.step), device="cpu")
    return save_checkpoint(tmp_path_factory.mktemp("ps_state"), ts, step=0)


def _server_rows(addrs, oracle, touched):
    from mindrec_tpu_torch.ops.remote import RemoteTier

    out = {}
    for name, tiers in oracle.tiers.items():
        for tname, tier in tiers.items():
            remote = RemoteTier(addrs, name if tname == "param"
                                else f"{name}.{tname}", tier.dim, init_std=0.0)
            out[name, tname] = remote.read(touched)
            remote.close()
    return out


def test_spec_matches_the_reference_worker():
    """The port's batches and initial rows are the reference script's."""
    ref = _ref_ps_worker()
    assert (SPEC["vocab"], SPEC["cache_rows"], SPEC["batch"], SPEC["fields"],
            SPEC["emb"], SPEC["steps"]) == (ref.VIRTUAL_VOCAB, ref.CACHE_ROWS,
                                            ref.B, ref.F, ref.D, ref.STEPS)
    for w in range(2):
        for got, want in zip(jobs.owned_batches(SPEC, w), ref.owned_batches(w, 2)):
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
            assert (got["ids"] % 2 == w).all()
    ids = np.array([0, 5, 99_999], np.int64)
    np.testing.assert_array_equal(jobs.det_rows(ids, 8, 1), ref.det_rows(ids, 8, 1))


def test_two_workers_over_two_servers(tmp_path, ref_state, ref_f32):
    """1 rendezvous + 2 servers + 2 workers: each worker's rows on the
    servers (params and optimizer state) equal its one-process run bit for
    bit and the reference's within rtol 1e-4 / atol 1e-8; the workers'
    losses and row loads equal their one-process runs'; the two workers
    touched disjoint ids."""
    from test_torch_remote import servers

    spec = {**SPEC, "device": "cpu", "state": ref_state}
    ref, seen = ref_f32, []
    with servers("port", 2, tmp_path) as addrs:
        recs, _ = launch.run_job("mindrec_tpu_torch.parallel.jobs:ps_worker",
                                 {**spec, "servers": addrs}, 2,
                                 timeout=SPAWN_TIMEOUT)
        for w in range(2):
            oracle, touched, orec = jobs.build_and_train_ps(spec, w)
            seen.append(touched)
            assert recs[w]["worker"] == w and recs[w]["touched"] == touched.size
            assert recs[w]["losses"] == orec["losses"]
            assert recs[w]["loaded"] == orec["loaded"]
            got = _server_rows(addrs, oracle, touched)
            for (name, tname), rows in got.items():
                want = oracle.tiers[name][tname].read(touched)
                np.testing.assert_array_equal(rows, want,
                                              err_msg=f"{w} {name}.{tname}")
            jref, jtouched = ref.build_and_train(None, w, 2)
            np.testing.assert_array_equal(jtouched, touched)
            for (name, tname), rows in got.items():
                want = jref.tiers[name][tname].read(touched)
                np.testing.assert_allclose(rows, want, rtol=1e-4, atol=1e-8,
                                           err_msg=f"{w} {name}.{tname}")
    assert np.intersect1d(*seen).size == 0


# ---------------------------------------------------------------------------
# train_criteo's placement regimes on 2 workers, beside what the
# reference's driver does there (ROADMAP.md section 3, faults 11-13)
# ---------------------------------------------------------------------------

TINY = ["--device", "cpu", "--model", "wide_deep", "--batch_size", "32",
        "--vocab_size", "2000", "--emb_dim", "8", "--deep_layer_dim", "[16,8]",
        "--epochs", "1", "--steps_per_epoch", "4"]
CACHE = ["--sparse", "1", "--vocab_cache_size", "1024"]


@pytest.fixture()
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for k in [k for k in os.environ if k.startswith(("MR_", "MINDREC_CRASH"))]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    return tmp_path


def _finals(outs: list[str]) -> list[dict]:
    """Each rank's ``final metrics`` dict from its output."""
    found = [[line for line in o.splitlines() if line.startswith("final metrics")]
             for o in outs]
    assert all(len(f) == 1 for f in found), [o[-2000:] for o in outs]
    return [ast.literal_eval(f[0].split(":", 1)[1].strip()) for f in found]


def _two_workers(argv, addrs=None) -> list[dict]:
    env = dict(os.environ)
    if addrs:
        env["MR_SERVER_HOSTS"] = ",".join(addrs)
    outs = launch.run_ranks(
        [sys.executable, "-m", "mindrec_tpu_torch.examples.train_criteo", *argv],
        2, timeout=SPAWN_TIMEOUT, env=env)
    return _finals(outs)


def _one_process(argv, addrs, monkeypatch) -> dict:
    from mindrec_tpu_torch.examples import train_criteo

    if addrs:
        monkeypatch.setenv("MR_SERVER_HOSTS", ",".join(addrs))
    try:
        return train_criteo.main(argv)
    finally:
        monkeypatch.delenv("MR_SERVER_HOSTS", raising=False)


def _ps_launcher(servers_n: int, workers: int, argv) -> list[dict]:
    from mindrec_tpu_torch.parallel.launch import free_port

    env = dict(os.environ, PYTHON=sys.executable,
               MR_SCHED_PORT=str(free_port()),
               MR_SERVER_PORT_BASE=str(free_port()))
    r = subprocess.run(
        ["bash", str(REPO / "mindrec_tpu_torch" / "examples" / "run_ps_train.sh"),
         str(servers_n), str(workers), *argv],
        env=env, capture_output=True, text=True, timeout=SPAWN_TIMEOUT)
    logs = [Path(f"ps_logs/worker_{w}.log").read_text() for w in range(workers)]
    assert r.returncode == 0, r.stdout[-2000:] + "\n".join(l[-2000:] for l in logs)
    return _finals(logs)


def test_cache_regime_workers_own_their_ids(in_tmp):
    """``run_ps_train.sh 2 2`` in the cache regime: each worker trains its
    own model on its own stream over the ids it owns, so no row of the 2
    table servers is trained by both and a second launch ends where the
    first did, each worker with a checkpoint file of its own; the two
    workers' results differ (``ps_worker`` holds the rows themselves to a
    one-process run, bit for bit, above).  The reference's driver
    gives every worker the same synthetic stream (``SyntheticCriteo`` with
    seed 1 on every process) over the same rows (fault 11): its 2 workers
    over servers raced, ending at AUC 0.50381 and 0.50407.  Packed data
    cannot be given to a worker's class without merging ids, and is
    refused (``test_multi_card_options_raise_item_9``)."""
    from mindrec_tpu.data.criteo import SyntheticCriteo as RefSynthetic
    from mindrec_tpu_torch.data.criteo import SyntheticCriteo
    from mindrec_tpu_torch.examples import train_criteo

    argv = TINY + CACHE + ["--ckpt_interval", "2"]
    over_servers = _ps_launcher(2, 2, argv)
    assert sorted(p.name for p in Path("ckpt").iterdir()) == [
        f"ckpt-000000000{s}-r{w}.npz" for s in (2, 4) for w in (0, 1)]
    assert _ps_launcher(2, 2, argv) == over_servers
    assert over_servers[0] != over_servers[1]
    # each worker's ids are its own, one to one with its stream's (below
    # vocab / 2); the reference's workers share theirs
    raw = [SyntheticCriteo(32, 39, 1000, steps=4, seed=1 + 1000 * w).get_batch(0)
           for w in range(2)]
    ids = [train_criteo.own_ids(w, 2)(raw[w])["ids"] for w in range(2)]
    assert (ids[0] % 2 == 0).all() and (ids[1] % 2 == 1).all()
    for w in range(2):
        assert ids[w].dtype == raw[w]["ids"].dtype and (ids[w] < 2000).all()
        np.testing.assert_array_equal(ids[w] // 2, raw[w]["ids"])
    ref = [RefSynthetic(32, 39, 2000, steps=4, seed=1).get_batch(0)["ids"]
           for _w in range(2)]
    np.testing.assert_array_equal(ref[0], ref[1])


@pytest.mark.parametrize("n_servers", [0, 2], ids=["host_tiers", "servers"])
def test_host_target_regime_is_data_parallel(in_tmp, monkeypatch, n_servers):
    """``parameter_server`` on 2 workers trains one model data-parallel:
    the same final metrics as one process on the global batches, with host
    tiers of each rank's own or over 2 shared servers.  The reference's
    driver fails in this regime on any number of processes (fault 12: it
    builds the model without ``parameter_server=True``, and the loss's l2
    term reads the absent table)."""
    from test_torch_remote import servers

    argv = TINY + ["--parameter_server", "1"]
    if n_servers:
        with servers("port", 2, in_tmp / "two") as addrs:
            two = _two_workers(argv, addrs)
        with servers("port", 2, in_tmp / "one") as addrs:
            one = _one_process(argv, addrs, monkeypatch)
    else:
        two, one = _two_workers(argv), _one_process(argv, None, monkeypatch)
        _reference_driver_fails(argv[2:], monkeypatch)
    assert two[0] == two[1]
    assert two[0]["auc"] == pytest.approx(one["auc"], rel=1e-6)


def _reference_driver_fails(argv, monkeypatch):
    """The reference's ``examples/train_criteo.py`` in this process."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_ref_train_criteo", REPO / "examples" / "train_criteo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["train_criteo.py", *argv])
    with pytest.raises(KeyError, match="table"):
        mod.main()


@pytest.mark.parametrize("n_servers", [0, 2], ids=["own_stores", "servers"])
def test_dynamic_regime_counts_cluster_steps(in_tmp, monkeypatch, n_servers):
    """``dynamic_embedding`` on 2 workers with admission after 2 sightings:
    the same final metrics as one process on the global batches, with a
    hash store per rank or one over 2 shared servers (rank 0 asks it, so
    each key counts once per step of the cluster).  The reference's
    workers each send the whole batch to the shared servers (fault 13):
    shown here with the reference's own store, one lookup per worker
    admits in one cluster step a key that one process admits in two."""
    from test_torch_remote import servers

    argv = TINY + ["--dynamic_embedding", "1", "--sparse", "1",
                   "--permit_filter_value", "2"]
    if n_servers:
        with servers("port", 2, in_tmp / "two") as addrs:
            two = _two_workers(argv, addrs)
        with servers("port", 2, in_tmp / "one") as addrs:
            one = _one_process(argv, addrs, monkeypatch)
        from mindrec_tpu.ops.remote import RemoteHashStore as RefStore

        keys = np.arange(10, 20, dtype=np.int64)
        with servers("ref", 2, in_tmp / "ref") as addrs:
            single = RefStore(addrs, "single", 64, permit_threshold=2)
            assert (single.lookup_or_insert(keys) < 0).all()  # step 1: pending
            w0, w1 = (RefStore(addrs, "pair", 64, permit_threshold=2)
                      for _ in range(2))
            assert (w0.lookup_or_insert(keys) < 0).all()
            assert (w1.lookup_or_insert(keys) >= 0).all()  # same step: admitted
            for s in (single, w0, w1):
                s.close()
    else:
        two, one = _two_workers(argv), _one_process(argv, None, monkeypatch)
    assert two[0] == two[1]
    assert two[0]["auc"] == pytest.approx(one["auc"], rel=1e-6)


def dynamic_mesh_job(args):
    """A rank's side of ``test_dynamic_adapter_on_a_mesh``: a tiny W&D
    over slots, its slice of each global key batch translated by the
    mesh adapter (over ``args["servers"]`` or a store of its own), an
    eviction at the end; -> the slots, the freed count, a digest of the
    reset rows."""
    from mindrec_tpu_torch.models.wide_deep import WideDeepConfig, WideDeepModel
    from mindrec_tpu_torch.parallel import mesh as pm
    from mindrec_tpu_torch.train import optim
    from mindrec_tpu_torch.train.dynamic import DynamicEmbeddingAdapter
    from mindrec_tpu_torch.train.step import init_train_state

    mesh = pm.make_mesh(data=2, model=1)
    model = WideDeepModel(WideDeepConfig(batch_size=8, field_size=2,
                                         vocab_size=64, emb_dim=4,
                                         deep_layer_dim=(4,), sparse=True))
    state = init_train_state(model, 0, optim.ftrl(), optim.lazy_adam(),
                             device="cpu")
    ad = DynamicEmbeddingAdapter(capacity=64, permit_filter_value=2,
                                 evict_filter_value=3, table_name="dmesh",
                                 remote_addrs=args["servers"], mesh=mesh)
    d = mesh.axis_index(pm.DATA_AXIS)
    slots = []
    for ids in np.asarray(args["batches"], np.int64):
        part = {"ids": ids[4 * d: 4 * (d + 1)]}
        slots.append(ad.transform_batch(part)["ids"].tolist())
    state, n = ad.evict(state, model.table_specs)
    return {"slots": slots, "freed": n,
            "deep": float(state.params["deep"]["table"].double().sum())}


@pytest.mark.parametrize("shared", [False, True], ids=["own_stores", "servers"])
def test_dynamic_adapter_on_a_mesh(tmp_path, shared):
    """``DynamicEmbeddingAdapter(mesh=)`` on 2 gloo ranks: each rank gets
    the slots of its own slice of the global batch, the same as one
    process's adapter gives the global batch (admission after 2
    sightings), and an eviction frees the same slots and resets the same
    rows on both ranks."""
    from mindrec_tpu_torch.train.dynamic import DynamicEmbeddingAdapter
    from test_torch_remote import servers

    rng = np.random.default_rng(3)
    pool = rng.integers(0, 10**9, 12, dtype=np.int64)
    batches = [rng.choice(pool if s < 3 else pool[:4], (8, 2)) for s in range(7)]
    args = {"device": "cpu", "batches": [b.tolist() for b in batches]}

    def one_process(addrs):
        ad = DynamicEmbeddingAdapter(capacity=64, permit_filter_value=2,
                                     evict_filter_value=3, table_name="done",
                                     remote_addrs=addrs)
        return [ad.transform_batch({"ids": b})["ids"] for b in batches], ad

    if shared:
        with servers("port", 2, tmp_path) as addrs:
            recs, _ = launch.run_job(f"{__file__}:dynamic_mesh_job",
                                     {**args, "servers": addrs}, 2,
                                     timeout=SPAWN_TIMEOUT)
            want, ad = one_process(addrs)
            freed = ad.store.evict().size
    else:
        recs, _ = launch.run_job(f"{__file__}:dynamic_mesh_job",
                                 {**args, "servers": None}, 2,
                                 timeout=SPAWN_TIMEOUT)
        want, ad = one_process(None)
        freed = ad.store.evict().size
    for i, w in enumerate(want):
        got = np.concatenate([np.asarray(recs[0]["slots"][i]),
                              np.asarray(recs[1]["slots"][i])])
        np.testing.assert_array_equal(got, w, err_msg=f"batch {i}")
    assert recs[0]["freed"] == recs[1]["freed"] == freed > 0
    assert recs[0]["deep"] == recs[1]["deep"]
