"""Runs of the benchmark's cells on the card, outside the benchmark's own
command: a short rehearsal, or the full sets that bounds are set from.

    python3 portbench/rehearse.py [cell ...] [--seconds 3] [--seed 11]
    python3 portbench/rehearse.py CELL --seconds 20 --seeds 1,2,3,4,5,6 \\
        --sets 2 --trace-seeds 7,8,9 [--out chiprun_out/sets]

Without ``--seeds`` each cell (all of ``BENCHMARK.json``'s by default)
runs once with ``--trace 1`` and once with ``--trace 0``; the first run
in a checkout builds the port's kernels and native prep.  With
``--seeds`` each cell runs ``--sets`` sets of one run per seed (the same
seeds in every set), after one traced run per ``--trace-seeds``.  Every
run is its own process, as the benchmark's command; its result line and
the end of its standard error go to ``--out``.  Last, per cell and set:
each metric's median and its spread (the distance between the first and
third quartile of ``statistics.quantiles(values, n=4)``, as a share of
the median), and the runs that came out not correct.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


SMI = ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
       "temperature.gpu", "--format=csv,noheader,nounits", "-lms", "1000"]


def clocks(samples: str) -> str:
    """Median and range of each column of the card's samples."""
    rows = []
    for line in samples.splitlines():
        try:
            rows.append([float(x) for x in line.split(",")])
        except ValueError:
            continue
    if not rows:
        return "no samples"
    cols = list(zip(*rows))
    names = ("sm MHz", "mem MHz", "W", "C")
    return ", ".join(f"{n} {statistics.median(c):.0f} [{min(c):.0f}-"
                     f"{max(c):.0f}]" for n, c in zip(names, cols))


def run(cell: str, seed: int, seconds: float, trace: int, out: Path | None,
        tag: str = "") -> dict | None:
    cmd = [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
           cell, "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace)]
    t0 = time.perf_counter()
    load0 = os.getloadavg()[0]
    try:
        smi = subprocess.Popen(SMI, stdout=subprocess.PIPE,
                               stderr=subprocess.DEVNULL, text=True)
    except OSError:
        smi = None
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=1500)
    finally:
        samples = ""
        if smi is not None:
            smi.terminate()
            samples = smi.communicate(timeout=30)[0]
    wall = time.perf_counter() - t0
    print(f"   card during the run: {clocks(samples)}; host load "
          f"{load0:.2f} -> {os.getloadavg()[0]:.2f}")
    if out is not None:
        stem = f"{cell}{tag}_t{trace}_{seed}"
        (out / f"{stem}.out").write_text(p.stdout)
        (out / f"{stem}.err").write_text(p.stderr[-20000:])
    print(f"== {cell}{tag} trace {trace} seed {seed}: rc {p.returncode}, "
          f"{wall:.1f} s of process", flush=True)
    for line in p.stderr.strip().splitlines()[-9:]:
        print("   ", line[:400])
    try:
        res = json.loads(p.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        return None
    print("   ", json.dumps({k: v for k, v in res.items()
                             if k not in ("breakdown", "checks")}), flush=True)
    for k, rows in res.get("breakdown", {}).items():
        for name, s in rows:
            print(f"    {k} {s:.6f} s {name[:100]}")
    return res


def spread(values: list[float]) -> tuple[float, float]:
    """(median, (q3 - q1) / median)."""
    med = statistics.median(values)
    q1, _q2, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med if med else float("inf")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cells", nargs="*")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = args.cells or [w["name"] for w in bench["workloads"]]
    out = Path(args.out) if args.out else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    bad = 0
    for cell in cells:
        if not seeds:
            for trace in (1, 0):
                bad += run(cell, args.seed, args.seconds, trace, out) is None
            continue
        # the traced runs first: the first run in a checkout builds
        for s in (int(x) for x in args.trace_seeds.split(",") if x):
            bad += run(cell, s, args.seconds, 1, out) is None
        sets = []
        for k in range(args.sets):
            sets.append([run(cell, s, args.seconds, 0, out, f"_set{k + 1}")
                         for s in seeds])
        for k, results in enumerate(sets, 1):
            ok = [r for r in results if r is not None]
            bad += len(results) - len(ok)
            wrong = [s for s, r in zip(seeds, results)
                     if r is None or not r["correct"]]
            summary = {}
            for name in (ok[0]["metrics"] if ok else {}):
                vals = [r["metrics"][name]["value"] for r in ok]
                if len(vals) >= 2:
                    med, spr = spread(vals)
                    summary[name] = {"median": med, "spread": spr,
                                     "values": vals}
            print(f"## {cell} set {k}: not correct {wrong}",
                  json.dumps(summary), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
