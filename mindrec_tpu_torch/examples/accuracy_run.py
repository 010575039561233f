"""Accuracy run: Wide&Deep, DeepFM or DCN on statistics-faithful
synthetic Criteo with a planted model of known Bayes AUC.  The port's
counterpart of ``examples/accuracy_run.py``.

The data are ``data/realistic.py:RealisticCriteo``: the published
per-column cardinalities, zipf id traffic, ~27% positives, a planted
linear + pairwise model whose Bayes AUC is the ceiling the trained AUC
is reported against (the reference's oracle on real Criteo is 0.80).

Modes:

* default (in memory): a fixed dataset is staged on the device once and
  trained for N epochs;
* ``--fresh``: a new batch every step (no sample is seen twice);
* ``--pipeline``: raw reference-format TSV -> ``data/preprocess.py`` ->
  packed shards -> training from the files (``--async-prep`` through
  the host input pipeline).

Writes one JSON line per event to ``--log`` (default accuracy_run.log).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def main(argv=None) -> dict:
    """Run; returns the final event (AUC beside the Bayes ceiling)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="wide_deep",
                    choices=["wide_deep", "deepfm", "dcn"])
    ap.add_argument("--vocab-scale", type=float, default=0.01,
                    help="fraction of the real criteo-kaggle cardinalities")
    ap.add_argument("--batch-size", type=int, default=16000)
    ap.add_argument("--emb-dim", type=int, default=80)
    ap.add_argument("--deep-layers", type=int, nargs="*",
                    default=[1024, 512, 256, 128])
    ap.add_argument("--train-batches", type=int, default=64,
                    help="distinct staged batches (dataset size = this x "
                    "batch size)")
    ap.add_argument("--eval-batches", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--eval-every", type=int, default=5, help="epochs")
    ap.add_argument("--fresh", action="store_true",
                    help="generate a new batch every step")
    ap.add_argument("--fresh-steps-per-epoch", type=int, default=500)
    ap.add_argument("--pipeline", action="store_true",
                    help="TSV -> preprocess -> packed shards -> train")
    ap.add_argument("--async-prep", action="store_true",
                    help="with --pipeline: feed the step through the host "
                    "input pipeline (prep pool + staging)")
    ap.add_argument("--pipeline-rows", type=int, default=200_000)
    ap.add_argument("--prepare-only", action="store_true",
                    help="with --pipeline: write the TSV and preprocess it, "
                    "then exit")
    ap.add_argument("--eval-every-steps", type=int, default=0,
                    help="also eval every N train steps")
    ap.add_argument("--work-dir", default="./accuracy_data")
    ap.add_argument("--log", default="accuracy_run.log")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from mindrec_tpu_torch.data.criteo import to_device
    from mindrec_tpu_torch.data.realistic import RealisticCriteo, write_tsv
    from mindrec_tpu_torch.train import optim
    from mindrec_tpu_torch.train.metrics import AUCMetric
    from mindrec_tpu_torch.train.step import (
        init_train_state, make_eval_step, make_train_step,
    )

    dev = args.device
    gen = RealisticCriteo(vocab_scale=args.vocab_scale)
    work = Path(args.work_dir)
    if args.prepare_only:
        from mindrec_tpu_torch.data.preprocess import preprocess

        if (work / "packed" / "train").exists():
            print(json.dumps({"event": "prepare_skip"}), flush=True)
            return {"event": "prepare_skip"}
        t0 = time.time()
        files = write_tsv(gen, work / "raw", args.pipeline_rows)
        preprocess(files, str(work / "packed"), workers=2,
                   line_per_sample=100)
        done = {"event": "preprocess_done",
                "elapsed_s": round(time.time() - t0, 1)}
        print(json.dumps(done), flush=True)
        return done
    bayes = gen.bayes_auc(100_000)
    log = open(args.log, "a")

    def emit(rec):
        rec["ts"] = time.strftime("%Y-%m-%d %H:%M:%S")
        print(json.dumps(rec), flush=True)
        log.write(json.dumps(rec) + "\n")
        log.flush()
        return rec

    emit({"event": "start", "model": args.model, "vocab": gen.vocab_size,
          "bayes_auc": round(bayes, 4), "pos_rate": round(gen.positive_rate(), 4),
          "batch_size": args.batch_size, "async_prep": bool(args.async_prep),
          "dataset_samples": args.train_batches * args.batch_size})

    # pipeline mode: preprocess maps categories to its own id space (one
    # OOV bucket per column), so the bound is vocab + 26 OOV ids
    vocab = gen.vocab_size + (26 if args.pipeline else 0)
    layers = tuple(args.deep_layers)
    if args.model == "wide_deep":
        from mindrec_tpu_torch.models.wide_deep import (
            WideDeepConfig, WideDeepModel,
        )

        cfg = WideDeepConfig(batch_size=args.batch_size, field_size=39,
                             vocab_size=vocab, emb_dim=args.emb_dim,
                             deep_layer_dim=layers, sparse=True,
                             loss_scale=1024.0)
        model = WideDeepModel(cfg)
        opt_w = optim.ftrl(loss_scale=cfg.loss_scale)
        opt_d = optim.lazy_adam(loss_scale=cfg.loss_scale)
    elif args.model == "deepfm":
        from mindrec_tpu_torch.models.deepfm import DeepFMConfig, DeepFMModel

        cfg = DeepFMConfig(batch_size=args.batch_size, field_size=39,
                           vocab_size=vocab, emb_dim=args.emb_dim,
                           deep_layer_dim=layers, sparse=True,
                           loss_scale=1024.0)
        model = DeepFMModel(cfg)
        opt_w = optim.adam(learning_rate=cfg.learning_rate, eps=cfg.epsilon,
                           loss_scale=cfg.loss_scale)
        opt_d = optim.adam(learning_rate=cfg.learning_rate, eps=cfg.epsilon,
                           loss_scale=cfg.loss_scale)
    else:
        from mindrec_tpu_torch.models.dcn import DCNConfig, DCNModel

        cfg = DCNConfig(batch_size=args.batch_size, field_size=39,
                        vocab_size=vocab, emb_dim=min(args.emb_dim, 27),
                        sparse=True, loss_scale=1.0, learning_rate=3e-4)
        model = DCNModel(cfg)
        opt_w = optim.adam(learning_rate=cfg.learning_rate,
                           loss_scale=cfg.loss_scale)
        opt_d = optim.adam(learning_rate=cfg.learning_rate,
                           loss_scale=cfg.loss_scale)

    state = init_train_state(model, 0, opt_w, opt_d, device=dev)
    step = make_train_step(model, opt_w, opt_d, jit=True, donate=True)
    ev = make_eval_step(model)

    if args.pipeline:
        from mindrec_tpu_torch.data.criteo import PackedCriteoDataset
        from mindrec_tpu_torch.data.preprocess import preprocess

        if not (work / "packed" / "train").exists():
            emit({"event": "generate_tsv", "rows": args.pipeline_rows})
            files = write_tsv(gen, work / "raw", args.pipeline_rows)
            emit({"event": "preprocess"})
            preprocess(files, str(work / "packed"), workers=2,
                       line_per_sample=100)

        def train_ds():  # line_per_sample as the preprocess packed it
            return PackedCriteoDataset(work / "packed" / "train",
                                       args.batch_size, line_per_sample=100)

        def eval_ds():
            return PackedCriteoDataset(work / "packed" / "test",
                                       args.batch_size, line_per_sample=100)

        if args.async_prep:
            from mindrec_tpu_torch.data.pipeline import SparseInputPipeline

            base_ds = train_ds

            def train_ds():  # noqa: F811 -- lossless prep, one capture
                return iter(SparseInputPipeline(
                    base_ds(), field_size=39, policy=None, workers=2,
                    depth=3, device=dev != "cpu"))
        eval_batches = None
    else:
        train_batches = []
        if not args.fresh:
            emit({"event": "stage_batches", "n": args.train_batches})
            train_batches = [to_device(gen.batch(args.batch_size, step=i), dev)
                             for i in range(args.train_batches)]
        eval_batches = [to_device(gen.batch(args.batch_size,
                                            step=10**6 + 50 + i), dev)
                        for i in range(args.eval_batches)]

    def staged(b):
        """A host batch copied to the device; a staged one as it is."""
        if isinstance(next(iter(b.values())), torch.Tensor):
            return b
        return to_device(b, dev)

    def run_eval():
        m = AUCMetric()
        for b in (eval_batches if eval_batches is not None else eval_ds()):
            p, lab = ev(state.params, staged(b))
            m.update(p.float().cpu().numpy(), lab.float().cpu().numpy())
        return m.eval()

    t0, seen, fresh_step = time.time(), 0, 0
    ld = None
    for ep in range(1, args.epochs + 1):
        if args.fresh:
            def fresh_iter():
                nonlocal fresh_step
                for _ in range(args.fresh_steps_per_epoch):
                    fresh_step += 1
                    yield gen.batch(args.batch_size, step=fresh_step)
            it = fresh_iter()
        else:
            it = train_ds() if args.pipeline else train_batches
        ep_step = 0
        for b in it:
            state, (_lw, ld) = step(state, staged(b))
            seen += args.batch_size
            ep_step += 1
            if args.eval_every_steps and ep_step % args.eval_every_steps == 0:
                emit({"event": "eval", "epoch": ep, "step": ep_step,
                      "samples": seen, "loss": round(float(ld), 4),
                      "auc": round(run_eval(), 4),
                      "bayes_auc": round(bayes, 4),
                      "elapsed_s": round(time.time() - t0, 1)})
        if ep % args.eval_every == 0 or ep == args.epochs:
            emit({"event": "eval", "epoch": ep, "samples": seen,
                  "loss": round(float(ld), 4), "auc": round(run_eval(), 4),
                  "bayes_auc": round(bayes, 4),
                  "elapsed_s": round(time.time() - t0, 1)})
    final = run_eval()
    out = emit({"event": "final", "auc": round(final, 4),
                "bayes_auc": round(bayes, 4), "reference_oracle": 0.80,
                "auc_vs_bayes": round(final / bayes, 4),
                "loss": None if ld is None else float(ld)})
    log.close()
    return out


if __name__ == "__main__":
    main()
