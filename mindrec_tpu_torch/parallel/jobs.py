"""Train a model for a few steps on a mesh of ranks: the rank side of a
multi-rank run started by :func:`~mindrec_tpu_torch.parallel.launch.run_job`.

:func:`train_on_mesh` joins nothing itself (``launch`` has joined the
group): it builds the mesh and the model from a JSON-able spec, makes the
whole state (from a seed, or restored from a checkpoint file), cuts it to
this rank's blocks, runs the eager step on the global batches it is given
(each rank its data slice), and saves its sliced checkpoint file.  It
returns, per step, the losses, the host-clock milliseconds, the kernel
launches and the collectives' bytes (``parallel/mesh.py``), so a caller
can hold the run against a one-rank run of the same batches.

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
     "unsliced": "directory where rank 0 saves the whole state" | None}
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
        return [train_on_mesh({**common, **r}) for r in args["runs"]]
    from mindrec_tpu_torch.data.criteo import to_device
    from mindrec_tpu_torch.io.checkpoint import restore_checkpoint, save_checkpoint
    from mindrec_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mindrec_tpu_torch.parallel.dist import rank_device
    from mindrec_tpu_torch.train.step import (
        init_train_state, make_batch_sort, make_train_step, prep_groups,
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
    step = make_train_step(model, ow, od, jit=False, **step_kw)
    batches = load_batches(args["batches"])
    if args.get("prep"):
        cfg = model.config
        prep = make_batch_sort(getattr(cfg, "field_size", 0),
                               groups=prep_groups(model), native=False)
        batches = [prep(b) for b in batches]
    rec = {"rank": mesh.rank, "losses": [], "ms": [], "launches": [],
           "collectives": []}
    for b in batches:
        if args.get("full_batch"):
            part = pm.FullBatch(to_device(b, dev))
        else:
            part = to_device(pm.shard_batch(b, mesh), dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        reset_launches()
        pm.reset_collectives()
        t0 = time.perf_counter()
        state, (lw, ld) = step(state, part)
        lw, ld = float(lw), float(ld)  # waits for the step
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["losses"].append((lw, ld))
        rec["launches"].append({k: v for k, v in LAUNCHES.items() if v})
        rec["collectives"].append(list(pm.COLLECTIVES))
    if args.get("out"):
        rec["path"] = save_checkpoint(args["out"], state, int(state.step),
                                      process_index=mesh.rank,
                                      force_sliced=True, shardings=shardings)
    if args.get("unsliced"):
        whole = unshard_state(state, shardings, mesh)
        if mesh.rank == 0:
            rec["unsliced"] = save_checkpoint(args["unsliced"], whole,
                                              int(state.step))
    return rec
