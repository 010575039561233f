#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s phases on one card, after building the
kernels, and print what ``chip_smoke.py`` prints for them::

    python3 tools/chip_phases.py ps            # phases 15-16, then 23-26
    python3 tools/chip_phases.py cache dynamic

Phases: ``assemble`` (the feature assembly's kernels of phase 5),
``cache`` (15), ``dynamic`` (16), ``files`` (17-20),
``outbrain`` (21), ``online`` (22), ``ps`` (23-26: PS mode, which
compares itself with phases 15 and 16's results, so it runs them first),
``generic`` (27-28: the generic sparse path), ``drivers`` (29),
``sharded`` (30: ranks of a mesh sharing the card over gloo),
``workers`` (31: PS workers over shared servers, distributed online
training, the elastic wrapper).
Exits non-zero without a card or when a phase fails.
"""

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

PHASES = ("assemble", "cache", "dynamic", "files", "outbrain", "online", "ps",
          "generic", "drivers", "sharded", "workers")


def main(names) -> int:
    bad = [n for n in names if n not in PHASES]
    if bad or not names:
        print(f"phases: {' '.join(PHASES)} (got {' '.join(names) or 'none'})",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    cs.SMI = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    cs.log(cs.SMI)
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    cs.phase_build()
    dev = torch.device("cuda", 0)
    out = {}
    for name in PHASES:
        if name not in names and not (name in ("cache", "dynamic")
                                      and "ps" in names):
            continue
        t = time.perf_counter()
        if name == "ps":
            out[name] = cs.phase_ps(dev, out["cache"], out["dynamic"])
        elif name == "assemble":
            out[name] = cs.check_assemble(dev)
        elif name == "generic":
            out[name] = (cs.phase_generic_wd(dev), cs.phase_generic_dyn(dev))
        elif name == "drivers":
            out[name] = cs.phase_drivers(dev)
        elif name == "workers":
            out[name] = cs.phase_workers(dev)
        elif name == "sharded":
            data, bucket, _host0 = cs.wd_setup()
            gen = torch.Generator(device=dev).manual_seed(0)
            out[name] = cs.phase_sharded(dev, gen, data, bucket)
        else:
            fn = {"cache": cs.phase_cache, "dynamic": cs.phase_dynamic,
                  "files": cs.phase_files, "outbrain": cs.phase_outbrain_files,
                  "online": cs.phase_online_kafka}[name]
            out[name] = fn(dev)
        cs.log(f"[time] {name} {time.perf_counter() - t:.1f} s")
        torch.cuda.empty_cache()
    cs.log(f"[done] {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
