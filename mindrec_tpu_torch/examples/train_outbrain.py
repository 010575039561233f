"""Train and evaluate the multitable Wide&Deep on Outbrain data with
MAP@12: the port's counterpart of ``examples/train_outbrain.py``.

The reference recipe: four tables, FTRL (l1 = l2 = 5e-4, initial
accumulator 0.1) and Adam (eps 1e-6) with loss scale 1000; metrics AUC
and MAP@12 grouped by ``display_id``.

Usage::

  python -m mindrec_tpu_torch.examples.train_outbrain --synthetic \\
      --batch_size 64 --steps_per_epoch 8 --epochs 1 [--device cpu]
  python -m mindrec_tpu_torch.examples.train_outbrain \\
      --data_path /data/outbrain --batch_size 131072

Real data are TFRecords written by
``mindrec_tpu_torch.data.outbrain.write_outbrain_tfrecords``.
``--mesh_model`` > 1 row-slices the emb128 table over the model axis of
a mesh of the launched ranks (``MR_*`` env, one process per rank, e.g.
``run_distribute_train.sh``'s bootstrap); the other ranks form the data
axis.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    """Train, evaluate; returns the final metrics."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_path", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--batch_size", type=int, default=131072)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--steps_per_epoch", type=int, default=8,
                    help="synthetic mode only")
    ap.add_argument("--sparse", type=lambda s: s.lower() == "true",
                    default=True, help="row-sparse grads + lazy optimizers")
    ap.add_argument("--emb128_size", type=int, default=650_000)
    ap.add_argument("--deep_layers", type=int, nargs="*",
                    default=[1024, 1024, 1024, 1024, 1024])
    ap.add_argument("--mesh_model", type=int, default=1)
    ap.add_argument("--loss_file_name", default="loss_outbrain.log")
    ap.add_argument("--eval_file_name", default="eval_outbrain.log")
    ap.add_argument("--host_prep", type=lambda s: s.lower() == "true",
                    default=False,
                    help="run the host input pipeline (per-group native "
                    "prep pool -> staging; tiny-vocab groups skip sorting)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from mindrec_tpu_torch import RecModel
    from mindrec_tpu_torch.data.outbrain import (
        OutbrainTFRecordDataset, SyntheticOutbrain,
    )
    from mindrec_tpu_torch.models.multitable import (
        MultiTableConfig, MultiTableWideDeepModel,
    )
    from mindrec_tpu_torch.parallel.dist import (
        initialize_from_env, rank_device, shutdown,
    )
    from mindrec_tpu_torch.parallel.mesh import make_mesh
    from mindrec_tpu_torch.train import optim
    from mindrec_tpu_torch.train.callbacks import (
        EvalCallback, LossCallback, TimeMonitor,
    )
    from mindrec_tpu_torch.train.metrics import AUCMetric, GroupedMapMetric

    topo = initialize_from_env(device=args.device)
    print(f"topology: {topo}", flush=True)
    cfg = MultiTableConfig(
        batch_size=args.batch_size, emb_128_size=args.emb128_size,
        deep_layer_dim=tuple(args.deep_layers), sparse=args.sparse,
        emb128_slice_mode=("table_row_slice" if args.mesh_model > 1
                           else "none"),
    )
    mesh = None
    if args.mesh_model > 1 or topo["process_count"] > 1:
        mesh = make_mesh(model=args.mesh_model)
    model = MultiTableWideDeepModel(cfg, mesh=mesh)
    opt_w = optim.ftrl(learning_rate=cfg.ftrl_lr, l1=5e-4, l2=5e-4,
                       initial_accum=0.1, loss_scale=cfg.loss_scale)
    opt_d = (optim.lazy_adam if cfg.sparse else optim.adam)(
        learning_rate=cfg.adam_lr, eps=1e-6, loss_scale=cfg.loss_scale)
    rm = RecModel(
        model, opt_w, opt_d,
        metrics={"auc": AUCMetric(), "map12": GroupedMapMetric(k=12)},
        host_prep=args.host_prep, device=rank_device(args.device),
    )

    def make_data(train: bool):
        if args.synthetic or not args.data_path:
            return SyntheticOutbrain(cfg, steps=args.steps_per_epoch,
                                     seed=1 if train else 999)
        return OutbrainTFRecordDataset(args.data_path, args.batch_size,
                                       train_mode=train)

    callbacks = [
        LossCallback(args.loss_file_name, per_print_times=10),
        TimeMonitor(),
        EvalCallback(rm, make_data(train=False), args.eval_file_name),
    ]
    rm.train(args.epochs, make_data(train=True), callbacks=callbacks)
    metrics = rm.eval(make_data(train=False))
    print(f"final metrics: {metrics}", flush=True)
    if topo["process_count"] > 1:
        shutdown()
    return metrics


if __name__ == "__main__":
    main()
