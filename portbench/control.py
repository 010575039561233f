"""The readings that the check's limits are set from.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--program-seeds 4,5,...]

For each seed of ``--program-seeds`` the program runs its set-up (the
ring, the weights, the first three steps through ``RecModel.train``) and
its readings are compared with the float32 reference: these give each
number's lower reading.  For each seed of ``--seeds`` three stand-ins take
the program's place and are compared with the float32 reference alike:

* ``control``: the reference itself with every MLP matmul's operands in
  float8 e4m3 (per-tensor scales), the precision below the bfloat16 the
  configurations state for the MLP;
* ``half_batch``: the reference with the loss's mean taken over the first
  half of each batch, the rest left out (a planted fault);
* ``frozen``: the reference with every update leaving the state as it
  was (a planted fault: a step that returns its state unchanged).  Its
  first gradients and changes are 0, so it reads 1 on ``grad_gap`` and
  ``change_gap`` by construction; its medians and its ``loss_gap`` are
  what the run reads.

Prints one JSON line per reading and, last, the smallest and largest of
each number by who read it.  On the card by default;
``--device cpu`` runs the same at the sizes a cell's files give.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _seeds(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x.strip()]


STAND_INS = {"control": {"precision": "fp8"},
             "half_batch": {"half_batch": True},
             "frozen": {"frozen": True}}


def readings(cd: dict, program_seeds, seeds, device) -> list[dict]:
    """[{"who", "seed", number: value}] for the program's seeds and the
    stand-ins' seeds."""
    import torch

    from portbench import checks, harness
    from portbench.sources import make_source

    dev = torch.device(device)
    config, traffic = cd["config"], cd["traffic"]
    out = []

    def row(who, seed, got, ref):
        numbers = checks.compare(got, ref)
        r = {"who": who, "seed": seed,
             **{k: numbers[k][0] for k in checks.NUMBERS},
             "worst": {k: str(numbers[k][1]) for k in checks.NUMBERS},
             "leaves": checks.leaf_gaps(got, ref),
             "norms": {side: {k: d[k] for k in ("grad", "change")}
                       for side, d in (("got", got), ("ref", ref))}}
        print(json.dumps(r), flush=True)
        out.append(r)

    def free():
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    for seed in program_seeds:
        program, staged, raw, got = harness.setup(cd, seed, dev,
                                                  warmup=False)
        del program, staged
        free()
        ref = harness.reference(config, seed, dev, raw)
        row("program", seed, got, ref)
        free()
    for seed in seeds:
        raw = [make_source(config, traffic, seed).get_batch(i)
               for i in range(harness.CHECK_STEPS)]
        ref = harness.reference(config, seed, dev, raw)
        for who, kw in STAND_INS.items():
            got = harness.reference(config, seed, dev, raw, **kw)
            row(who, seed, got, ref)
            free()
    return out


def summary(rows: list[dict]) -> dict:
    """{who: {number: [least, most]}}."""
    from portbench.checks import NUMBERS

    out = {}
    for who in sorted({r["who"] for r in rows}):
        mine = [r for r in rows if r["who"] == who]
        out[who] = {k: [min(r[k] for r in mine), max(r[k] for r in mine)]
                    for k in NUMBERS}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from portbench import harness

    cd = harness.load_cell(args.workload)
    rows = readings(cd, _seeds(args.program_seeds), _seeds(args.seeds),
                    args.device)
    print(json.dumps({"workload": args.workload, "summary": summary(rows)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
