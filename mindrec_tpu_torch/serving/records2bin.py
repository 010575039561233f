"""Dataset -> raw ``.bin`` inputs for the C++ inference client.

Port of ``mindrec_tpu/serving/records2bin.py``: walks a dataset batch by
batch and writes, per batch, ``ids_<i>.bin`` (int32 ``[B, F]``),
``wts_<i>.bin`` (float32 ``[B, F]``) and appends the labels to
``labels.txt``, the layout ``serving/infer_client.cc`` reads.

Usage::

  python -m mindrec_tpu_torch.serving.records2bin --data ./data/test \\
      --out ./bins --batch-size 1000 [--max-batches N]
  python -m mindrec_tpu_torch.serving.records2bin --synthetic \\
      --out ./bins --batch-size 1000 [--max-batches N]

``--data`` reads packed Criteo shards (``data/criteo.py:
PackedCriteoDataset``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def convert(dataset, out_dir, max_batches=None) -> int:
    """Write the batches of ``dataset``; returns how many."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = 0
    with open(out / "labels.txt", "w", encoding="utf-8") as lf:
        for i, batch in enumerate(dataset):
            if max_batches is not None and i >= max_batches:
                break
            ids = np.ascontiguousarray(batch["ids"], np.int32)
            wts = np.ascontiguousarray(batch["wts"], np.float32)
            (out / f"ids_{i}.bin").write_bytes(ids.tobytes())
            (out / f"wts_{i}.bin").write_bytes(wts.tobytes())
            for v in np.asarray(batch["label"]).reshape(-1):
                lf.write(f"{float(v):g}\n")
            n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", help="packed dataset dir (e.g. <root>/test)")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch-size", type=int, default=1000)
    ap.add_argument("--field-size", type=int, default=39)
    ap.add_argument("--vocab-size", type=int, default=200000)
    ap.add_argument("--max-batches", type=int, default=None)
    args = ap.parse_args(argv)

    if args.synthetic:
        from mindrec_tpu_torch.data.criteo import SyntheticCriteo

        ds = SyntheticCriteo(args.batch_size, args.field_size,
                             args.vocab_size, steps=args.max_batches or 4,
                             seed=999)
    else:
        from mindrec_tpu_torch.data.criteo import PackedCriteoDataset

        ds = PackedCriteoDataset(args.data, args.batch_size)
    n = convert(ds, args.out, args.max_batches)
    print(f"wrote {n} batches to {args.out}")


if __name__ == "__main__":
    main()
