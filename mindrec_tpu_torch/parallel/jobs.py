"""Train a model for a few steps on a mesh of ranks, or as one of several
PS workers: the rank side of a multi-rank run started by
:func:`~mindrec_tpu_torch.parallel.launch.run_job`.

:func:`ps_worker` is a PS worker (the port's counterpart of the
reference's ``tests/mp_scripts/ps_worker.py``): rank ``r`` of ``W``
trains the cache regime's Wide&Deep on its own batches, whose ids all
have ``id % W == r`` (:func:`owned_batches`), over ``RemoteTier`` tiers
on shared table servers, and flushes every resident row at the end;
:func:`build_and_train_ps` with no servers is the one-process run the
servers' rows are held against.  :func:`online_rank` is a rank of
``examples/dist_online_train.py`` with fields of its model's config
replaced.

:func:`train_on_mesh` joins nothing itself (``launch`` has joined the
group): it builds the mesh and the model from a JSON-able spec, makes the
whole state (from a seed, or restored from a checkpoint file), cuts it to
this rank's blocks, runs the step on the global batches it is given
(each rank its data slice; eager, or captured with ``"jit": true`` among
the step's arguments), and saves its sliced checkpoint file.  It returns,
per step, the losses, the host-clock milliseconds, the kernel launches
(``train/step.py:real_launches``) and the collectives' bytes
(``parallel/mesh.py``), and for a captured step its captures, replays and
graphs per capture (``segments``), so a caller can hold the run against a
one-rank run of the same batches or against the eager step.

A spec::

    {"data": 2, "model": 2, "device": "cuda" (default) | "cpu",
     "net": {"name": "wide_deep" | "deepfm" | "dcn" | "multitable",
             "config": {...}},
     "opt_w": {"kind": "ftrl", ...}, "opt_d": {"kind": "lazy_adam", ...},
     "state": "path.npz" | None, "seed": 0,
     "batches": "path.npz" | {"synthetic": {"vocab": V, "fields": F,
                                            "batch": B, "steps": n}},
     "prep": false, "full_batch": false, "step": {...make_train_step...},
     "out": "directory for the sliced checkpoint" | None,
     "unsliced": "directory where rank 0 saves the whole state" | None,
     "equal_to": i | None}

``equal_to`` (in a list of ``runs``): the index of an earlier run of the
list whose final state this run's is compared with on the rank, leaf by
leaf; the record's ``differs`` names the leaves that are not bit for bit
equal.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mindrec_tpu_torch.parallel import mesh as pm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_net(net: dict, mesh=None):
    """A model of the port from ``{"name", "config"}``."""
    cfg = {k: tuple(v) if isinstance(v, list) else v
           for k, v in net.get("config", {}).items()}
    name = net["name"]
    if name == "wide_deep":
        from mindrec_tpu_torch.models.wide_deep import WideDeepConfig, WideDeepModel

        return WideDeepModel(WideDeepConfig(**cfg), mesh=mesh)
    if name == "deepfm":
        from mindrec_tpu_torch.models.deepfm import DeepFMConfig, DeepFMModel

        return DeepFMModel(DeepFMConfig(**cfg), mesh=mesh)
    if name == "dcn":
        from mindrec_tpu_torch.models.dcn import DCNConfig, DCNModel

        return DCNModel(DCNConfig(**cfg), mesh=mesh)
    if name == "multitable":
        from mindrec_tpu_torch.models.multitable import (
            MultiTableConfig, MultiTableWideDeepModel,
        )

        return MultiTableWideDeepModel(MultiTableConfig(**cfg), mesh=mesh)
    raise ValueError(f"unknown model {name!r}")


def build_opt(spec: dict):
    """An optimizer of ``train/optim.py`` from ``{"kind", ...kwargs}``."""
    from mindrec_tpu_torch.train import optim

    kw = dict(spec)
    kind = kw.pop("kind")
    if "state_dtype" in kw:
        kw["state_dtype"] = DTYPES[kw["state_dtype"]]
    return getattr(optim, kind)(**kw)


def load_batches(spec) -> list[dict]:
    """Global host batches: from an ``.npz`` of ``{i}/{key}`` arrays, or
    ``SyntheticCriteo`` batches made from their seed."""
    if isinstance(spec, str):
        with np.load(spec) as z:
            n = 1 + max(int(k.split("/")[0]) for k in z.files)
            out = [{} for _ in range(n)]
            for k in z.files:
                i, key = k.split("/", 1)
                out[int(i)][key] = z[k]
        return out
    from mindrec_tpu_torch.data.criteo import SyntheticCriteo

    s = spec["synthetic"]
    data = SyntheticCriteo(s["batch"], s["fields"], s["vocab"],
                           steps=s["steps"], seed=s.get("seed", 0),
                           fields=s.get("kind", "uniform"))
    return [data.get_batch(i) for i in range(s["steps"])]


def save_batches(path, batches: list[dict]) -> None:
    np.savez(path, **{f"{i}/{k}": v for i, b in enumerate(batches)
                      for k, v in b.items()})


def unshard_state(state, shardings, mesh):
    """The whole state from every rank's blocks (each sliced leaf gathered
    over the model axis along its sliced dimension): table-scale
    collectives, for checking a run, never inside a step."""
    from mindrec_tpu_torch.io.checkpoint import _rebuild, flatten_state

    pls = {k: pl for k, pl in flatten_state(shardings)
           if isinstance(pl, pm.Placement)}
    leaves = []
    for key, x in flatten_state(state):
        pl = pls.get(key)
        if pl is not None:
            dim = next(i for i, s in enumerate(pl.index) if s != slice(None))
            x = pm.all_gather(x.movedim(dim, 0).contiguous(), pm.MODEL_AXIS,
                              mesh).movedim(0, dim).contiguous()
        leaves.append(x)
    return _rebuild(state, iter(leaves))


def train_on_mesh(args: dict):
    """Run the spec (module docstring) on this rank; -> its record.  With
    ``args["runs"]`` (a list of specs, each over ``args``' other keys)
    run them in turn in this process; -> their records."""
    if "runs" in args:
        common = {k: v for k, v in args.items() if k != "runs"}
        kept = {r["equal_to"] for r in args["runs"]
                if r.get("equal_to") is not None}
        recs, states = [], {}
        for i, r in enumerate(args["runs"]):
            rec, state = _run_on_mesh({**common, **r})
            if r.get("equal_to") is not None:
                rec["differs"] = _differing_leaves(states[r["equal_to"]], state)
            if i in kept:
                states[i] = state
            del state
            recs.append(rec)
        return recs
    return _run_on_mesh(args)[0]


def _differing_leaves(a, b) -> list[str]:
    """The checkpoint keys of the leaves of two states that are not bit
    for bit equal."""
    from mindrec_tpu_torch.io.checkpoint import flatten_state

    want = dict(flatten_state(a))

    def same(x, y):
        if isinstance(x, torch.Tensor):
            return torch.equal(x, y)
        return bool(np.array_equal(x, y))

    return [k for k, x in flatten_state(b) if not same(x, want[k])]


def _run_on_mesh(args: dict):
    """One spec on this rank; -> (its record, its final state)."""
    from mindrec_tpu_torch.data.criteo import to_device
    from mindrec_tpu_torch.io.checkpoint import restore_checkpoint, save_checkpoint
    from mindrec_tpu_torch.ops.kernels import reset_launches
    from mindrec_tpu_torch.parallel.dist import rank_device
    from mindrec_tpu_torch.train.step import (
        CapturedStep, init_train_state, make_batch_sort, make_train_step,
        prep_groups, real_launches,
    )

    mesh = pm.make_mesh(args["data"], args["model"])
    dev = rank_device(args.get("device", "cuda"))
    model = build_net(args["net"], mesh)
    ow, od = build_opt(args["opt_w"]), build_opt(args["opt_d"])
    full = init_train_state(model, args.get("seed", 0), ow, od, device=dev)
    if args.get("state"):
        full = restore_checkpoint(args["state"], full)
    shardings = pm.state_placements(full, model, mesh)
    state = pm.shard_train_state(full, model, mesh)
    del full
    step_kw = dict(args.get("step", {}))
    if "matmul_dtype" in step_kw:
        step_kw["matmul_dtype"] = DTYPES[step_kw["matmul_dtype"]]
    step = make_train_step(model, ow, od, **step_kw)
    captured = isinstance(step, CapturedStep)
    batches = load_batches(args["batches"])
    if args.get("prep"):
        cfg = model.config
        prep = make_batch_sort(getattr(cfg, "field_size", 0),
                               groups=prep_groups(model), native=False)
        batches = [prep(b) for b in batches]
    rec = {"rank": mesh.rank, "losses": [], "ms": [], "launches": [],
           "collectives": [], "captures": 0, "replays": 0}
    for b in batches:
        if args.get("full_batch"):
            part = pm.FullBatch(to_device(b, dev))
        else:
            part = to_device(pm.shard_batch(b, mesh), dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        reset_launches()
        pm.reset_collectives()
        if captured:
            step.reset_counts()
        t0 = time.perf_counter()
        state, (lw, ld) = step(state, part)
        lw, ld = float(lw), float(ld)  # waits for the step
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["losses"].append((lw, ld))
        rec["launches"].append({k: v for k, v in real_launches(step).items()
                                if v})
        rec["collectives"].append(list(pm.COLLECTIVES))
        if captured:
            rec["captures"] += step.captures
            rec["replays"] += step.replays
    if captured:
        rec["segments"] = step.segments
    if args.get("out"):
        rec["path"] = save_checkpoint(args["out"], state, int(state.step),
                                      process_index=mesh.rank,
                                      force_sliced=True, shardings=shardings)
    if args.get("unsliced"):
        whole = unshard_state(state, shardings, mesh)
        if mesh.rank == 0:
            rec["unsliced"] = save_checkpoint(args["unsliced"], whole,
                                              int(state.step))
    return rec, state


# ---------------------------------------------------------------------------
# several PS workers over one set of table servers
# ---------------------------------------------------------------------------

def det_rows(ids: np.ndarray, dim: int, salt: int) -> np.ndarray:
    """Rows made from each id alone (the same in a worker and in its
    one-process run, whatever order they first read ids in)."""
    ids = np.asarray(ids, np.int64).reshape(-1, 1)
    j = np.arange(dim, dtype=np.int64)[None, :]
    return (((ids * 31 + j * 7 + salt) % 97).astype(np.float32) / 97.0
            - 0.5) * 0.02


def owned_batches(spec: dict, worker: int) -> list[dict]:
    """Worker ``worker``'s batches: every id ``i`` has ``i % workers ==
    worker``, so no two workers ever train one row.  ``traffic``
    ``uniform`` draws the ids' quotients uniformly below ``vocab //
    workers``; ``zipf`` draws them from Zipf(``zipf_a``), as the cache
    recipe draws its ids (``benchmarks/bench_cached.py:make_ids``)."""
    w, n = worker, spec["workers"]
    rng = np.random.default_rng(spec.get("seed", 100) + w)
    b, f, vocab = spec["batch"], spec["fields"], spec["vocab"]
    out = []
    for _ in range(spec["steps"]):
        if spec.get("traffic", "uniform") == "zipf":
            q = (rng.zipf(spec.get("zipf_a", 1.3), (b, f)).astype(np.int64)
                 - 1) % (vocab // n)
        else:
            q = rng.integers(0, vocab // n, (b, f))
        out.append({
            "ids": (q * n + w).astype(np.int64),
            "wts": rng.normal(size=(b, f)).astype(np.float32),
            "label": rng.integers(0, 2, (b, 1)).astype(np.float32),
        })
    return out


def ps_worker_model(spec: dict):
    """(model, opt_w, opt_d) of a PS worker's cache-regime Wide&Deep."""
    from mindrec_tpu_torch.models.wide_deep import WideDeepConfig, WideDeepModel
    from mindrec_tpu_torch.train import optim

    scale = float(spec.get("loss_scale", 1.0))
    cfg = WideDeepConfig(
        batch_size=spec["batch"], field_size=spec["fields"],
        vocab_size=spec["cache_rows"], emb_dim=spec["emb"],
        deep_layer_dim=tuple(spec["layers"]), sparse=True, loss_scale=scale,
        use_mixed_precision=spec.get("mixed", True),
        table_layout=spec.get("layout", "auto"))
    return (WideDeepModel(cfg), optim.ftrl(loss_scale=scale),
            optim.lazy_adam(loss_scale=scale))


def build_and_train_ps(spec: dict, worker: int, servers=None):
    """Train worker ``worker``'s batches in the cache regime, its tiers on
    ``servers`` ("host:port" list) or, with None, on host tiers in this
    process (the one-process run the servers' rows are held against).
    Every id the run touches starts from :func:`det_rows` (optimizer
    state: FTRL's accumulator 1, the rest 0); at the end every resident
    row is flushed.  -> (adapter, the touched ids, a record of the run:
    losses, ms, ``prepare`` ms, rows loaded and evicted, and kernel
    launches per step).  ``spec["use_kernels"]`` False: the plain
    versions of the kernels."""
    from mindrec_tpu_torch.io.checkpoint import restore_checkpoint
    from mindrec_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mindrec_tpu_torch.parallel.dist import rank_device
    from mindrec_tpu_torch.train.cached import CachedTrainingAdapter
    from mindrec_tpu_torch.train.step import init_train_state, make_train_step

    dev = rank_device(spec.get("device", "cuda"))
    model, opt_w, opt_d = ps_worker_model(spec)
    state = init_train_state(model, 0, opt_w, opt_d, device=dev)
    if spec.get("state"):
        state = restore_checkpoint(spec["state"], state)
    batch, fields = spec["batch"], spec["fields"]
    adapter = CachedTrainingAdapter(
        model, virtual_vocab=spec["vocab"], cache_rows=spec["cache_rows"],
        max_swap=batch * fields + 8, remote_addrs=servers or None,
        ram_bytes=spec.get("ram_bytes"), spill_dir=spec.get("spill_dir"))
    step = make_train_step(model, opt_w, opt_d, jit=False,
                           use_kernels=spec.get("use_kernels", True),
                           **({"matmul_dtype": DTYPES[spec["matmul_dtype"]]}
                              if "matmul_dtype" in spec else {}))
    batches = owned_batches(spec, worker)
    touched = np.unique(np.concatenate([b["ids"].reshape(-1) for b in batches]))
    for salt, tiers in enumerate(adapter.tiers.values()):
        d = tiers["param"].dim
        tiers["param"].write(touched, det_rows(touched, d, salt))
        for tname, tier in tiers.items():
            if tname != "param":
                bias = 1.0 if tname == "accum" else 0.0
                tier.write(touched, np.full((touched.size, d), bias, np.float32))
    rec = {"worker": worker, "losses": [], "ms": [], "prepare_ms": [],
           "loaded": [], "evicted": [], "launches": [],
           "touched": int(touched.size)}
    for b in batches:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        reset_launches()
        t0 = time.perf_counter()
        prep = adapter.prepare(b)
        t1 = time.perf_counter()
        state = adapter.apply_swap(state, prep)
        adapter.writeback(prep)
        state, (lw, ld) = step(state, adapter.transform(b, prep))
        lw, ld = float(lw), float(ld)  # waits for the step
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["prepare_ms"].append((t1 - t0) * 1e3)
        rec["losses"].append((lw, ld))
        rec["loaded"].append(int(prep["load_ids"].size))
        rec["evicted"].append(int(prep["evict_ids"].size))
        rec["launches"].append({k: v for k, v in LAUNCHES.items() if v})
        if not (np.isfinite(lw) and np.isfinite(ld)):
            raise FloatingPointError(f"worker {worker}: loss {lw}, {ld}")
    t0 = time.perf_counter()
    adapter.flush_all(state)
    rec["flush_ms"] = (time.perf_counter() - t0) * 1e3
    rec["row_bytes"] = int(sum(t.dim * 4 for tiers in adapter.tiers.values()
                               for t in tiers.values()))
    return adapter, touched, rec


def ps_worker(args: dict) -> dict:
    """A PS worker's side of a multi-worker run (``launch.run_job``): this
    rank is worker ``rank`` of ``world``; its tiers live on
    ``args["servers"]``.  -> the record of :func:`build_and_train_ps`."""
    import torch.distributed as tdist

    rank = tdist.get_rank() if tdist.is_initialized() else 0
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    spec = {**args, "workers": world}
    adapter, _touched, rec = build_and_train_ps(spec, rank, args["servers"])
    for tiers in adapter.tiers.values():
        for t in tiers.values():
            getattr(t, "close", lambda: None)()
    return rec


def online_rank(args: dict) -> dict:
    """A rank of ``examples/dist_online_train.py`` started by
    ``launch.run_job``: ``main(args["argv"], **args["config"])``, the
    model's config fields replaced (a float32 MLP for a tight check).
    -> the rank's step count."""
    from mindrec_tpu_torch.examples import dist_online_train

    state = dist_online_train.main(args["argv"], **args.get("config", {}))
    return {"steps": int(state.step)}
