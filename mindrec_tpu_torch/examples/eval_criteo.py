"""Standalone eval: the port's counterpart of ``examples/eval_criteo.py``.

Restores a checkpoint (a single file, a directory whose latest file is
picked, or several per-rank sliced files, merged first) and reports AUC
over the eval dataset.

Usage::

  python -m mindrec_tpu_torch.examples.eval_criteo --model wide_deep \\
      --ckpt ./ckpt [--device cuda|cpu] [--key value ...]
  python -m mindrec_tpu_torch.examples.eval_criteo --ckpt 'ckpt/ckpt-*-r*.npz'
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path

HERE = Path(__file__).resolve().parent


def build(model_name, cfg):
    """The model-construction switch of ``train_criteo.py`` at eval's
    options, as the reference's eval builds it."""
    from mindrec_tpu_torch.train import optim

    if model_name == "wide_deep":
        from mindrec_tpu_torch.models.wide_deep import (
            WideDeepConfig, WideDeepModel,
        )

        mcfg = WideDeepConfig(
            batch_size=cfg.batch_size, field_size=cfg.field_size,
            vocab_size=cfg.vocab_size, emb_dim=cfg.emb_dim,
            deep_layer_dim=tuple(cfg.deep_layer_dim),
            use_mixed_precision=cfg.use_mixed_precision, sparse=cfg.sparse,
            loss_scale=cfg.loss_scale,
        )
        return WideDeepModel(mcfg), optim.ftrl(), optim.adam()
    if model_name == "deepfm":
        from mindrec_tpu_torch.models.deepfm import DeepFMConfig, DeepFMModel

        mcfg = DeepFMConfig(
            batch_size=cfg.batch_size, field_size=cfg.field_size,
            vocab_size=cfg.vocab_size, emb_dim=cfg.emb_dim,
        )
        return DeepFMModel(mcfg), optim.ftrl(), optim.adam()
    from mindrec_tpu_torch.models.dcn import DCNConfig, DCNModel

    mcfg = DCNConfig(batch_size=cfg.batch_size, field_size=cfg.field_size,
                     vocab_size=cfg.vocab_size)
    return DCNModel(mcfg), optim.ftrl(), optim.adam()


def resolve_ckpt(spec: str):
    """-> (paths, sliced): a directory gives its latest file; a glob or
    list of several files gives rank slices."""
    p = Path(spec)
    if p.is_dir():
        from mindrec_tpu_torch.io.checkpoint import latest_checkpoint

        path, step = latest_checkpoint(p)
        if path is None:
            raise FileNotFoundError(f"no checkpoints under {p}")
        print(f"restoring step {step}: {path}", flush=True)
        return [path], False
    matches = sorted(glob.glob(spec))
    if not matches:
        raise FileNotFoundError(spec)
    return matches, len(matches) > 1


def main(argv=None) -> dict:
    """Restore, evaluate, append the line to ``--eval_file_name``; returns
    the metrics."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="wide_deep",
                    choices=["wide_deep", "deepfm", "dcn"])
    ap.add_argument("--config", default=str(HERE / "wide_deep_config.yaml"))
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint file, directory (latest picked), or "
                    "glob of per-rank sliced files to merge")
    ap.add_argument("--eval_file_name", default="eval.log")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, rest = ap.parse_known_args(argv)

    from mindrec_tpu_torch import RecModel
    from mindrec_tpu_torch.config import get_config
    from mindrec_tpu_torch.data.criteo import PackedCriteoDataset, SyntheticCriteo
    from mindrec_tpu_torch.io.checkpoint import merge_sliced, restore_checkpoint

    cfg = get_config(args.config, rest)
    rm = RecModel(*build(args.model, cfg), device=args.device)
    paths, sliced = resolve_ckpt(args.ckpt)
    if sliced:
        print(f"merging {len(paths)} sliced checkpoints", flush=True)
        rm.state = merge_sliced(paths, rm.state)
    else:
        rm.state = restore_checkpoint(paths[0], rm.state)

    if cfg.dataset_type == "packed":
        data = PackedCriteoDataset(Path(cfg.data_path) / "test", cfg.batch_size)
    else:
        data = SyntheticCriteo(cfg.batch_size, cfg.field_size, cfg.vocab_size,
                               steps=cfg.steps_per_epoch, seed=999)
    metrics = rm.eval(data)
    line = f"EvalCallBack metric: {metrics}"
    print(line, flush=True)
    with open(args.eval_file_name, "a", encoding="utf-8") as f:
        f.write(line + "\n")
    return metrics


if __name__ == "__main__":
    main()
