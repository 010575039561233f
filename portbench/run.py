"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON object on the last line of standard
output, and each number the check compared beside its limit as the last
lines of standard error.  Exits with another code than 0, printing no
result, when no CUDA card is there, when fewer cards are there than the
cell asks for, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the run inside the checkout, at a
# fixed path (the program builds its own library under
# mindrec_tpu_torch/_build/, inside the checkout too)
CACHE = ROOT / "portbench_cache"
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA card; the benchmark runs only on one",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["cell"]["chips"]:
        print(f"portbench: {args.workload} needs {cell['cell']['chips']} "
              f"cards, {torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), T_START,
                                     cell_data=cell)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    print(harness.card_line(), file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
