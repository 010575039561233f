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
store live on table servers (``run_ps_train.sh``).  One process trains on
one card: several workers (``MR_WORKER_NUM`` > 1), ``--mesh_model`` > 1,
``deep_table_slice_mode`` other than ``none`` and ``field_slice`` shard
over several cards and raise (ROADMAP.md section 1 item 9).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
from pathlib import Path

import numpy as np

from mindrec_tpu_torch.examples import ITEM9

HERE = Path(__file__).resolve().parent


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="wide_deep",
                    choices=["wide_deep", "deepfm", "dcn"])
    ap.add_argument("--config", default=str(HERE / "wide_deep_config.yaml"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh_model", type=int, default=1,
                    help="model-parallel axis size (> 1: item 9)")
    ap.add_argument("--enable_profiling", action="store_true",
                    help="torch.profiler trace around training")
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


def check_single_card(mesh_model: int, cfg=None) -> None:
    """Raise for the options that shard over several cards (item 9)."""
    if mesh_model > 1:
        raise NotImplementedError(
            f"--mesh_model {mesh_model} shards tables over several cards "
            f"({ITEM9})")
    if int(os.environ.get("MR_WORKER_NUM", "1") or 1) > 1:
        raise NotImplementedError(
            f"MR_WORKER_NUM={os.environ['MR_WORKER_NUM']}: several worker "
            f"processes train data-parallel ({ITEM9})")
    if cfg is None:
        return
    if getattr(cfg, "deep_table_slice_mode", "none") != "none":
        raise NotImplementedError(
            f"deep_table_slice_mode={cfg.deep_table_slice_mode!r} shards the "
            f"deep table ({ITEM9})")
    if getattr(cfg, "field_slice", False):
        raise NotImplementedError(f"field_slice shards the fields ({ITEM9})")


def build(model_name: str, cfg):
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
        return WideDeepModel(mcfg), mcfg, opt_w, opt_d
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
        return DeepFMModel(mcfg), mcfg, opt_w, opt_d
    from mindrec_tpu_torch.models.dcn import DCNConfig, DCNModel

    mcfg = DCNConfig(batch_size=cfg.batch_size, field_size=cfg.field_size,
                     vocab_size=cfg.vocab_size)
    return (DCNModel(mcfg), mcfg, optim.ftrl(),
            optim.adam(learning_rate=mcfg.learning_rate,
                       loss_scale=mcfg.loss_scale))


def main(argv=None) -> dict:
    """Train, evaluate, and return the final metrics."""
    args, rest = parse_args(argv)
    check_single_card(args.mesh_model)

    from mindrec_tpu_torch import RecModel
    from mindrec_tpu_torch.config import get_config
    from mindrec_tpu_torch.data.criteo import (
        PackedCriteoDataset, SyntheticCriteo, to_device,
    )
    from mindrec_tpu_torch.parallel.dist import initialize_from_env
    from mindrec_tpu_torch.train.callbacks import (
        EvalCallback, LossCallback, TimeMonitor,
    )
    device = args.device
    cfg = get_config(args.config, rest)
    check_single_card(args.mesh_model, cfg)
    topo = initialize_from_env(device=device)
    print(f"topology: {topo}", flush=True)
    model, mcfg, opt_w, opt_d = build(args.model, cfg)

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
        adapter = CachedTrainingAdapter(
            model, virtual_vocab=cfg.vocab_size,
            cache_rows=cfg.vocab_cache_size,
            max_swap=cfg.batch_size * cfg.field_size + 8,
            ram_bytes=getattr(cfg, "host_ram_bytes", None) or None,
            spill_dir="./emb_spill",
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
              f"{cfg.vocab_size:,} (remote={bool(server_hosts)})", flush=True)
    elif args.model == "wide_deep" and getattr(cfg, "parameter_server", False):
        # host-target regime: the tables never reach the card
        from mindrec_tpu_torch.train.host_target import (
            HostTargetAdapter, init_dense_state,
        )

        from mindrec_tpu_torch.models.wide_deep import WideDeepModel

        # parameter_server=True declares the tables host-resident (and
        # drops their l2 term, as the reference's config rule does)
        model = rm.model = WideDeepModel(
            dataclasses.replace(mcfg, parameter_server=True))
        adapter = HostTargetAdapter(
            model, vocab_size=cfg.vocab_size,
            unique_bucket=cfg.batch_size * cfg.field_size,
            opt_w=opt_w, opt_d=opt_d,
            remote_addrs=server_hosts or None,
            spill_dir=None if server_hosts else "./emb_spill",
        )
        rm.state = init_dense_state(model, 0, opt_w, opt_d, device=device)
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

    def make_data(train: bool):
        if cfg.dataset_type == "packed":
            sub = "train" if train else "test"
            return PackedCriteoDataset(Path(cfg.data_path) / sub,
                                       cfg.batch_size)
        return SyntheticCriteo(
            cfg.batch_size, cfg.field_size, cfg.vocab_size,
            steps=cfg.steps_per_epoch, seed=1 if train else 999,
        )

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

        path, _ck_step = latest_checkpoint(args.ckpt_dir,
                                           rank=topo["process_index"])
        if path:
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
            files = dump_ir(dump_step, rm.state, to_device(b0, rm.device),
                            path=args.graphs_path, name="train_step")
            print(f"dumped IR: {files}", flush=True)

    profiler = None
    if args.enable_profiling:
        from mindrec_tpu_torch.utils.profiling import Profiler

        profiler = Profiler(args.profiler_path)
    try:
        rm.train(cfg.epochs, make_data(train=True), callbacks=callbacks)
    finally:
        if profiler is not None:
            trace = profiler.analyse()
            print(f"profiler trace -> {trace}", flush=True)
    metrics = rm.eval(make_data(train=False))
    print(f"final metrics: {metrics}", flush=True)
    return metrics


if __name__ == "__main__":
    main()
