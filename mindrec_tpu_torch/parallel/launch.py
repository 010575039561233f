"""Start a group of ranks on this host and wait for them, with a hard
time limit.

:func:`run_ranks` starts one process per rank with the ``MR_*``
bootstrap env (``parallel/dist.py``) on a free ``localhost`` port, waits
for all of them, and kills every rank still running when one fails or
the time limit passes (then it raises with each rank's output).

Run as a module it is a rank's side of a job: it joins the group, calls
a function of a module (``pkg.mod:FUNC``) or of a file (``FILE.py:FUNC``)
and writes what the function returns::

    python -m mindrec_tpu_torch.parallel.launch TARGET ARGS.json OUT_DIR

``FUNC(args)`` gets the decoded ``ARGS.json``; its return value is
pickled to ``OUT_DIR/rank<r>.pkl``.  ``args["device"]`` (default
``cuda``; ``cpu`` runs the group on the host) and ``args["backend"]``
pick where the group runs.
"""

from __future__ import annotations

import importlib.util
import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RanksFailed(RuntimeError):
    """A rank exited non-zero or the group ran past its time limit."""


def run_ranks(argv: list[str], world: int, timeout: float = 120.0,
              env: dict | None = None) -> list[str]:
    """Run ``argv`` as ranks ``0 .. world-1`` of one group; -> each
    rank's output (stdout and stderr together).  Raises
    :class:`RanksFailed` when a rank fails or ``timeout`` seconds pass,
    after killing every rank still running.  Each rank runs PyTorch's CPU
    operators on one thread unless ``OMP_NUM_THREADS`` says otherwise:
    ranks sharing a host would each start a thread per core."""
    base = dict(os.environ if env is None else env)
    base.setdefault("OMP_NUM_THREADS", "1")
    base.update(MR_SCHED_HOST="127.0.0.1", MR_SCHED_PORT=str(free_port()),
                MR_WORKER_NUM=str(world))
    logs, procs = [], []
    try:
        for r in range(world):
            log = tempfile.TemporaryFile(mode="w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                argv, stdout=log, stderr=subprocess.STDOUT,
                env={**base, "MR_WORKER_ID": str(r)}))
        deadline = time.monotonic() + timeout
        failed = None
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {codes[bad[0]]}"
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = f"ranks still running after {timeout:.0f} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    if failed:
        detail = "\n".join(f"--- rank {r}\n{o[-4000:]}" for r, o in enumerate(outs))
        raise RanksFailed(f"{failed}\n{detail}")
    return outs


def run_job(target: str, args: dict, world: int, timeout: float = 120.0,
            env: dict | None = None) -> tuple[list, list[str]]:
    """Run ``target`` (``pkg.mod:FUNC`` or ``FILE.py:FUNC``) on ``world``
    ranks with ``args``;
    -> (each rank's return value, each rank's output)."""
    with tempfile.TemporaryDirectory() as tmp:
        spec = Path(tmp) / "args.json"
        spec.write_text(json.dumps(args))
        root = str(Path(__file__).resolve().parents[2])
        env = dict(os.environ if env is None else env)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH", "")) if p)
        outs = run_ranks([sys.executable, "-m", "mindrec_tpu_torch.parallel.launch",
                          target, str(spec), tmp], world, timeout, env)
        results = []
        for r in range(world):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
    return results, outs


def _main(target: str, args_path: str, out_dir: str) -> None:
    from mindrec_tpu_torch.parallel.dist import initialize_from_env

    args = json.loads(Path(args_path).read_text())
    topo = initialize_from_env(device=args.get("device", "cuda"),
                               backend=args.get("backend"),
                               timeout_s=int(args.get("timeout_s", 120)))
    path, func = target.rsplit(":", 1)
    if path.endswith(".py"):
        spec = importlib.util.spec_from_file_location("_mr_job", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(path)
    result = getattr(mod, func)(args)
    out = Path(out_dir) / f"rank{topo['process_index']}.pkl"
    tmp = out.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, out)


if __name__ == "__main__":
    _main(*sys.argv[1:4])
