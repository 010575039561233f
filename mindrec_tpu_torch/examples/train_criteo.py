"""Train a CTR model on Criteo-format data: the port's counterpart of
``examples/train_criteo.py`` (one script, ``--model`` selects Wide&Deep,
DeepFM or DCN).

Usage::

  python -m mindrec_tpu_torch.examples.train_criteo --model wide_deep \\
      [--config mindrec_tpu_torch/examples/wide_deep_config.yaml] \\
      [--device cuda|cpu] [--key value ...]

Every yaml key is an option (``--sparse 1``, ``--dynamic_embedding 1``,
``--vocab_cache_size N``, ``--parameter_server 1``, ...).  The embedding
placement regimes are the reference's: the card cache over host or
remote tiers (``vocab_cache_size``), host-resident tables
(``parameter_server`` without the cache), the hash dynamic vocabulary
(``dynamic_embedding``); with ``MR_SERVER_HOSTS`` set their tiers or hash
store live on table servers (``run_ps_train.sh``).

Several ranks (``MR_WORKER_NUM`` > 1 with the ``MR_*`` bootstrap,
``run_distribute_train.sh``; the backend from ``MR_BACKEND``) form a
(data, model) mesh with ``--mesh_model`` model ranks: the deep table is
sliced per ``deep_table_slice_mode`` (DeepFM's and DCN's table per
``table_slice_mode``), ``field_slice`` lays the fields out so each model
rank's block holds its part of them (``data/field_slice.py``, Wide&Deep
on a model axis > 1), and the other ranks train data-parallel.  On the
card each rank's step is captured as on one card (``RecModel``'s
``jit``; its graphs cut at every collective) and a rank prints its
captures and replays before its final metrics.  Each rank saves its
sliced checkpoint file.  Packed data is read by data rank:
each reads its own files (``num_shards`` = the data axis) at its slice of
the batch, unless ``--unique_bucket`` sorts the global batch on every
rank.

The placement regimes on several workers (:func:`worker_layout`; with
``MR_SERVER_HOSTS`` over one set of table servers, ``run_ps_train.sh S
W``):

* the card cache (``vocab_cache_size``) trains one model per worker, as
  the reference builds it (without the mesh), each on its own stream
  (synthetic data from a seed of its own, packed data from its own
  files) over the ids it owns, ``id % W == rank`` (an id of another
  worker's class is moved into the worker's own), so no two workers
  train one row of the shared tiers: the contract of the reference's
  ``tests/mp_scripts/ps_worker.py``.  Each worker saves its own
  checkpoint file (``-r<rank>``) and spills into its own directory;
* host tables (``parameter_server``) and the hash vocabulary
  (``dynamic_embedding``) train one model data-parallel on the mesh
  (``train/host_target.py``, ``train/dynamic.py``: every rank gathers
  the global batch's ids; over servers rank 0 alone updates the rows or
  asks the hash store).

Each rank leaves the group when it is done (``parallel/dist.shutdown``).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="wide_deep",
                    choices=["wide_deep", "deepfm", "dcn"])
    ap.add_argument("--config", default=str(HERE / "wide_deep_config.yaml"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh_model", type=int, default=1,
                    help="model-parallel axis size of the ranks' mesh")
    ap.add_argument("--enable_profiling", action="store_true",
                    help="torch.profiler trace around training, with the "
                    "program's spans on (utils/profiling.span)")
    ap.add_argument("--profiler_path", default="./profiler_data")
    ap.add_argument("--save_graphs", action="store_true",
                    help="dump one train step's operators and, on the card, "
                    "its CUDA graph (utils/profiling.dump_ir)")
    ap.add_argument("--graphs_path", default="./graphs")
    ap.add_argument("--ckpt_dir", default="./ckpt")
    ap.add_argument("--ckpt_interval", type=int, default=0,
                    help="save every N steps (0 = off); keep --ckpt_keep")
    ap.add_argument("--ckpt_keep", type=int, default=5)
    ap.add_argument("--async_ckpt", type=lambda s: s.lower() == "true",
                    default=False,
                    help="write checkpoints on a background thread")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint in --ckpt_dir and "
                    "continue")
    ap.add_argument("--unique_bucket", type=int, default=0,
                    help="run the host input pipeline (prep pool -> "
                    "staging, adaptive regrow) with this distinct-id "
                    "bound; 0 = off.  Plain sparse regime only")
    ap.add_argument("--prep_placement", default="host",
                    choices=["host", "device", "auto"],
                    help="with --unique_bucket: where the sort prep runs "
                    "('device' stages the compact wire and sorts on the "
                    "card; 'auto' measures the link and picks)")
    return ap.parse_known_args(argv)


def worker_layout(model_name: str, cfg, mesh) -> str:
    """How the ranks share a run: ``"one"`` (a single process),
    ``"replicas"`` (the card cache on several workers: one model per
    worker over the ids it owns) or ``"data"`` (one model on the mesh:
    data-parallel, with a model axis per ``--mesh_model``).  Packed data
    in ``"replicas"`` raises: real ids cannot be moved into a worker's
    class without W of them sharing one row."""
    if mesh is None or mesh.size == 1:
        return "one"
    if model_name == "wide_deep" and getattr(cfg, "vocab_cache_size", 0) > 0:
        if getattr(cfg, "dataset_type", "synthetic") == "packed":
            raise ValueError(
                "the card cache on several workers trains one model per "
                "worker over the ids it owns (id % workers == rank): it would "
                f"fold {mesh.size} distinct ids of the packed data into one "
                "row (ROADMAP.md section 3, reference fault 11). Train packed "
                "data on one worker, or in the host-table or hash regime")
        return "replicas"
    return "data"


def own_ids(rank: int, workers: int):
    """A batch transform mapping ids below ``vocab // workers`` one to one
    onto worker ``rank``'s class of the vocab (``id * workers + rank``),
    as the reference's ``ps_worker.py`` draws a worker's ids."""
    def fn(batch):
        ids = np.asarray(batch["ids"])
        return {**batch,
                "ids": (ids.astype(np.int64) * workers + rank).astype(ids.dtype)}

    return fn


def field_slice_layout(cfg, mesh):
    """``field_slice``: -> (the Wide&Deep config's field count and vocab,
    a host batch transform) laying each field part on its model rank's
    block of the row-sliced deep table (``data/field_slice.py``)."""
    from mindrec_tpu_torch.data.field_slice import (
        compute_manual_shape, equalized_layout, pad_fields, remap_ids,
    )

    if mesh is None or mesh.model < 2:
        raise ValueError("field_slice lays the fields over the model axis: "
                         "take --mesh_model > 1 over several ranks")
    ms = compute_manual_shape(cfg.field_size, cfg.vocab_size, mesh.model)
    rows, vocab = equalized_layout(ms)

    def transform(batch):
        ids, wts = pad_fields(batch["ids"], batch["wts"], ms)
        return {**batch, "ids": remap_ids(ids, ms, rows).astype(np.int32),
                "wts": wts}

    return ms.target_column, vocab, transform


class _Mapped:
    """A re-iterable dataset with ``fn`` applied to each batch."""

    def __init__(self, data, fn):
        self.data, self.fn = data, fn

    def __iter__(self):
        return (self.fn(b) for b in self.data)

    def __len__(self):
        return len(self.data)


def build(model_name: str, cfg, mesh=None):
    """-> (model, its config, opt_w, opt_d), as the reference builds them."""
    from mindrec_tpu_torch.train import optim

    if model_name == "wide_deep":
        from mindrec_tpu_torch.models.wide_deep import (
            WideDeepConfig, WideDeepModel,
        )

        mcfg = WideDeepConfig(
            batch_size=cfg.batch_size, field_size=cfg.field_size,
            vocab_size=cfg.vocab_size, emb_dim=cfg.emb_dim,
            deep_layer_dim=tuple(cfg.deep_layer_dim),
            deep_layer_act=cfg.deep_layer_act, keep_prob=cfg.keep_prob,
            dropout_flag=cfg.dropout_flag,
            use_mixed_precision=cfg.use_mixed_precision, sparse=cfg.sparse,
            dynamic_embedding=cfg.dynamic_embedding,
            deep_table_slice_mode=cfg.deep_table_slice_mode,
            l2_coef=cfg.l2_coef, loss_scale=cfg.loss_scale,
        )
        opt_w = optim.ftrl(loss_scale=mcfg.loss_scale)
        opt_d = (optim.lazy_adam(loss_scale=mcfg.loss_scale)
                 if (mcfg.sparse or mcfg.dynamic_embedding)
                 else optim.adam(loss_scale=mcfg.loss_scale))
        return WideDeepModel(mcfg, mesh=mesh), mcfg, opt_w, opt_d
    if model_name == "deepfm":
        from mindrec_tpu_torch.models.deepfm import DeepFMConfig, DeepFMModel

        mcfg = DeepFMConfig(
            batch_size=cfg.batch_size, field_size=cfg.field_size,
            vocab_size=cfg.vocab_size, emb_dim=cfg.emb_dim,
            loss_scale=cfg.loss_scale,
        )
        opt_w = optim.ftrl(loss_scale=mcfg.loss_scale)
        opt_d = optim.adam(learning_rate=mcfg.learning_rate,
                           eps=mcfg.epsilon, loss_scale=mcfg.loss_scale)
        return DeepFMModel(mcfg, mesh=mesh), mcfg, opt_w, opt_d
    from mindrec_tpu_torch.models.dcn import DCNConfig, DCNModel

    mcfg = DCNConfig(batch_size=cfg.batch_size, field_size=cfg.field_size,
                     vocab_size=cfg.vocab_size)
    return (DCNModel(mcfg, mesh=mesh), mcfg, optim.ftrl(),
            optim.adam(learning_rate=mcfg.learning_rate,
                       loss_scale=mcfg.loss_scale))


def main(argv=None) -> dict:
    """Train, evaluate, and return the final metrics."""
    args, rest = parse_args(argv)

    from mindrec_tpu_torch import RecModel
    from mindrec_tpu_torch.config import Config, get_config
    from mindrec_tpu_torch.data.criteo import (
        PackedCriteoDataset, SyntheticCriteo, to_device,
    )
    from mindrec_tpu_torch.parallel.dist import (
        initialize_from_env, rank_device, shutdown,
    )
    from mindrec_tpu_torch.parallel.mesh import (
        DATA_AXIS, LocalBatch, make_mesh, shard_batch, state_placements,
    )
    from mindrec_tpu_torch.train.callbacks import (
        EvalCallback, LossCallback, TimeMonitor,
    )
    from mindrec_tpu_torch.train.step import CapturedStep
    cfg = get_config(args.config, rest)
    topo = initialize_from_env(device=args.device)
    print(f"topology: {topo}", flush=True)
    if topo["process_count"] > 1:
        import torch.distributed as tdist

        print(f"backend: {tdist.get_backend()}", flush=True)
    device = rank_device(args.device)
    mesh = None
    if args.mesh_model > 1 or topo["process_count"] > 1:
        mesh = make_mesh(model=args.mesh_model)
    layout = worker_layout(args.model, cfg, mesh)
    rank, workers = topo["process_index"], topo["process_count"]
    spill = "./emb_spill" if workers == 1 else f"./emb_spill/rank_{rank}"
    remap, cfg0 = None, cfg
    if getattr(cfg, "field_slice", False):
        if args.model != "wide_deep":
            raise ValueError("field_slice lays out the Wide&Deep deep table")
        fields, vocab, remap = field_slice_layout(cfg, mesh)
        cfg = Config({**cfg.to_dict(), "field_size": fields,
                      "vocab_size": vocab,
                      "deep_table_slice_mode": "table_row_slice"})
    model, mcfg, opt_w, opt_d = build(args.model, cfg, mesh)

    if args.unique_bucket and (
        getattr(cfg, "vocab_cache_size", 0)
        or getattr(cfg, "parameter_server", False)
        or getattr(cfg, "dynamic_embedding", False)
    ):
        raise SystemExit(
            "--unique_bucket (host input pipeline) is incompatible with "
            "the cache/host-target/dynamic regimes: their adapters "
            "translate ids after prep would have sorted the raw ids"
        )
    placement, wire = args.prep_placement, None
    if placement != "host":
        if not args.unique_bucket:
            raise SystemExit("--prep_placement device/auto needs "
                             "--unique_bucket")
        from mindrec_tpu_torch.data import wire as wire_mod

        if placement == "auto":
            # keep prep on the host when the link moves the host-prep
            # payload in under 10 ms (it can never dominate the step)
            host_payload = cfg.batch_size * cfg.field_size * 25
            if device == "cpu":
                placement = "host"
            else:
                bw = wire_mod.measure_bandwidth(device=device)
                placement = "host" if host_payload / bw < 0.010 else "device"
                print(f"[mindrec] prep placement auto -> {placement} "
                      f"(link {bw / 1e6:.0f} MB/s)", flush=True)
        if placement == "device":
            wire = wire_mod.BatchWire.for_sparse(
                cfg.vocab_size, cfg.batch_size, cfg.field_size)
    rm = RecModel(model, opt_w, opt_d,
                  unique_bucket=args.unique_bucket or None,
                  wire=wire, prep_placement=placement, device=device)
    # the device step a --save_graphs dump shows, and its batch's ids
    dump_step, dump_ids = rm.train_step, None

    # --- embedding placement regimes (the reference's matrix) -----------
    server_hosts = [h.strip() for h in
                    os.environ.get("MR_SERVER_HOSTS", "").split(",")
                    if h.strip()]
    if args.model == "wide_deep" and getattr(cfg, "vocab_cache_size", 0) > 0:
        # card-cache regime: the model holds vocab_cache_size rows per
        # table, misses swap through host (or remote) tiers
        from mindrec_tpu_torch.models.wide_deep import WideDeepModel
        from mindrec_tpu_torch.train.cached import (
            CachedTrainingAdapter, cached_train_step,
        )

        mcfg_cache = dataclasses.replace(
            mcfg, vocab_size=cfg.vocab_cache_size,
            # the swap is a contiguous column scatter on feature-major
            # storage, as the reference builds it
            table_layout="feature_major")
        model = WideDeepModel(mcfg_cache)
        # the reference passes donate=False: its swap returns new
        # buffers; the port's swap and step update the state in place
        rm = RecModel(model, opt_w, opt_d, device=device)
        rm.rank_id = rank  # a worker's own checkpoint file
        adapter = CachedTrainingAdapter(
            model, virtual_vocab=cfg.vocab_size,
            cache_rows=cfg.vocab_cache_size,
            max_swap=cfg.batch_size * cfg.field_size + 8,
            ram_bytes=getattr(cfg, "host_ram_bytes", None) or None,
            spill_dir=spill,
            remote_addrs=server_hosts or None,
        )
        dump_step, dump_ids = rm.train_step, cfg.vocab_cache_size
        rm.train_step = functools.partial(cached_train_step, adapter,
                                          rm.train_step)
        orig_eval = rm.eval_step

        def cached_eval(params, batch, _rm=rm, _ad=adapter):
            prep = _ad.prepare(batch)
            _rm.state = _ad.apply_swap(_rm.state, prep)
            _ad.writeback(prep)
            return orig_eval(_rm.state.params, _ad.transform(batch, prep))

        rm.eval_step = cached_eval
        print(f"cache regime: {cfg.vocab_cache_size:,} card rows of "
              f"{cfg.vocab_size:,} (remote={bool(server_hosts)})"
              + (f", worker {rank} of {workers} over the ids it owns"
                 if layout == "replicas" else ""), flush=True)
    elif args.model == "wide_deep" and getattr(cfg, "parameter_server", False):
        # host-target regime: the tables never reach the card
        from mindrec_tpu_torch.train.host_target import (
            HostTargetAdapter, init_dense_state,
        )

        from mindrec_tpu_torch.models.wide_deep import WideDeepModel

        # parameter_server=True declares the tables host-resident (and
        # drops their l2 term, as the reference's config rule does)
        model = rm.model = WideDeepModel(
            dataclasses.replace(mcfg, parameter_server=True), mesh=mesh)
        adapter = HostTargetAdapter(
            model, vocab_size=cfg.vocab_size,
            unique_bucket=cfg.batch_size * cfg.field_size,
            opt_w=opt_w, opt_d=opt_d,
            remote_addrs=server_hosts or None,
            spill_dir=None if server_hosts else spill,
            mesh=mesh,
        )
        rm.state = init_dense_state(model, 0, opt_w, opt_d, device=device)
        if rm.mesh is not None:  # the dense state: every leaf replicated
            rm.shardings = state_placements(rm.state, model, rm.mesh)
        rm.train_step = adapter.train_step
        rm.eval_step = adapter.eval_step
        dump_step = None  # the step runs host row updates around the card
        print(f"host-target regime: tables host-resident "
              f"(remote={bool(server_hosts)})", flush=True)
    elif getattr(cfg, "dynamic_embedding", False):
        # hash dynamic-vocabulary regime: any int64 id -> an arena slot
        from mindrec_tpu_torch.train.dynamic import DynamicEmbeddingAdapter

        dyn = DynamicEmbeddingAdapter(
            capacity=cfg.vocab_size,
            permit_filter_value=getattr(cfg, "permit_filter_value", 1) or 1,
            evict_filter_value=(getattr(cfg, "evict_filter_value", 0)
                                or 0x7FFFFFFF),
            remote_addrs=server_hosts or None,
            mesh=mesh, device=device,
        )
        train0, eval0 = rm.train_step, rm.eval_step
        dump_ids = cfg.vocab_size
        # a replaced step takes host batches: translate, then stage
        rm.train_step = lambda state, batch: train0(
            state, to_device(dyn.transform_batch(batch), rm.device))
        rm.eval_step = lambda params, batch: eval0(
            params, to_device(dyn.transform_batch(batch), rm.device))
        print(f"dynamic-embedding regime: arena {cfg.vocab_size:,} slots "
              f"(remote={bool(server_hosts)}, "
              f"step={getattr(train0, 'step', train0).__name__})", flush=True)

    # packed data by data rank: each reads its own files at its slice of
    # the batch (host prep sorts the global batch: every rank reads it)
    local = rm.mesh is not None and not args.unique_bucket
    n_data = rm.mesh.data if local else 1

    def make_data(train: bool):
        if cfg.dataset_type == "packed":
            sub = "train" if train else "test"
            d = rm.mesh.axis_index(DATA_AXIS) if local else 0
            data = PackedCriteoDataset(Path(cfg.data_path) / sub,
                                       cfg.batch_size // n_data,
                                       num_shards=n_data, shard_id=d)
        else:
            # the data's own field count and vocab: field_slice lays them
            # out anew; a cache worker trains a stream of its own
            src = cfg if remap is None else cfg0
            mine = layout == "replicas"  # ids below vocab / W, moved below
            data = SyntheticCriteo(
                cfg.batch_size, src.field_size,
                src.vocab_size // workers if mine else src.vocab_size,
                steps=cfg.steps_per_epoch,
                seed=(1 if train else 999) + (1000 * rank if mine else 0),
            )
        if layout == "replicas":
            data = _Mapped(data, own_ids(rank, workers))
        if remap is not None:
            data = _Mapped(data, remap)
        # marked last: a transform returns a plain dict, which
        # shard_batch would slice a second time
        if local and cfg.dataset_type == "packed":
            data = _Mapped(data, LocalBatch)
        return data

    callbacks = [
        LossCallback(cfg.loss_file_name, per_print_times=10),
        TimeMonitor(speed_of_light=model if cfg.sparse else None,
                    batch_size=cfg.batch_size),
        EvalCallback(rm, make_data(train=False), cfg.eval_file_name),
    ]
    if args.ckpt_interval > 0:
        from mindrec_tpu_torch.train.callbacks import CheckpointCallback

        callbacks.append(CheckpointCallback(
            args.ckpt_dir, save_steps=args.ckpt_interval,
            keep_max=args.ckpt_keep, async_save=args.async_ckpt,
        ))
    if args.resume:
        from mindrec_tpu_torch.io.checkpoint import (
            latest_checkpoint, restore_checkpoint,
        )

        path, ck_step = latest_checkpoint(args.ckpt_dir,
                                          rank=topo["process_index"])
        if path and rm.mesh is not None:  # every rank's sliced file
            paths = [str(Path(args.ckpt_dir) / f"ckpt-{ck_step:010d}-r{r}.npz")
                     for r in range(mesh.size)]
            rm.state = restore_checkpoint(paths, rm.state,
                                          shardings=rm.shardings)
            print(f"resumed from {path} (step {int(rm.state.step)})",
                  flush=True)
        elif path:
            rm.state = restore_checkpoint(path, rm.state)
            print(f"resumed from {path} (step {int(rm.state.step)})",
                  flush=True)
        else:
            print("resume requested but no checkpoint found; starting "
                  "fresh", flush=True)
    if os.environ.get("MINDREC_CRASH_AT_STEP"):
        from mindrec_tpu_torch.train.callbacks import FaultInjector

        callbacks.append(FaultInjector(
            int(os.environ["MINDREC_CRASH_AT_STEP"]),
            once_marker=os.environ.get("MINDREC_CRASH_MARKER"),
        ))

    if args.save_graphs:
        from mindrec_tpu_torch.utils.profiling import dump_ir

        if dump_step is None:
            print("dumped IR: none (the host-target step is not one "
                  "device step)", flush=True)
        else:
            b0 = dict(next(iter(make_data(train=True))))
            if dump_ids is not None:  # adapter regimes: any in-arena ids
                b0["ids"] = (np.asarray(b0["ids"]) % dump_ids).astype(np.int32)
            if rm.mesh is not None:
                b0 = shard_batch(b0, rm.mesh)
            files = dump_ir(dump_step, rm.state, to_device(b0, rm.device),
                            path=args.graphs_path, name="train_step")
            print(f"dumped IR: {files}", flush=True)

    profiler = None
    if args.enable_profiling:
        from mindrec_tpu_torch.utils.profiling import (
            Profiler, enable_spans, spans_enabled,
        )

        spans_were = spans_enabled()
        enable_spans(True)  # before the train step's first capture
        profiler = Profiler(args.profiler_path)
    try:
        rm.train(cfg.epochs, make_data(train=True), callbacks=callbacks)
    finally:
        if profiler is not None:
            trace = profiler.analyse()
            enable_spans(spans_were)
            print(f"profiler trace -> {trace}", flush=True)
    step = rm.train_step
    if isinstance(step, CapturedStep) and step.captures:
        print(f"captured step: {step.captures} captures, {step.replays} "
              f"replays, graphs per capture {step.segments}", flush=True)
    metrics = rm.eval(make_data(train=False))
    print(f"final metrics: {metrics}", flush=True)
    if workers > 1:
        shutdown()
    return metrics


if __name__ == "__main__":
    main()
