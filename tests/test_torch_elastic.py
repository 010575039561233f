"""Elastic recovery on the port (``mindrec_tpu_torch/examples/
run_elastic_train.sh`` over ``train_criteo --resume``), the counterpart
of ``tests/test_elastic.py`` with the same arguments on the CPU: a
trainer crashes mid-run (``MINDREC_CRASH_AT_STEP``), a restart resumes
from its last checkpoint with the global step kept, and the wrapper
restarts it by itself, at most ``MAX_RESTARTS`` times."""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WRAPPER = REPO / "mindrec_tpu_torch" / "examples" / "run_elastic_train.sh"
RUN_TIMEOUT = 110  # seconds per trainer process

ARGS = [
    "--device", "cpu",
    "--model", "wide_deep", "--vocab_size", "2000", "--batch_size", "32",
    "--epochs", "1", "--steps_per_epoch", "8", "--sparse", "true",
    "--emb_dim", "8", "--deep_layer_dim", "[16,8]",
]


def _env(crash_at=None):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MR_", "MINDREC_CRASH"))}
    env["PYTHONPATH"] = str(REPO)
    env["PYTHON"] = sys.executable
    if crash_at:
        env["MINDREC_CRASH_AT_STEP"] = str(crash_at)
    return env


def _steps(ckpt_dir: Path) -> list[int]:
    return sorted(int(re.search(r"ckpt-(\d+)-", p.name).group(1))
                  for p in ckpt_dir.glob("ckpt-*.npz"))


def test_crash_resume_roundtrip(tmp_path):
    cmd = [sys.executable, "-m", "mindrec_tpu_torch.examples.train_criteo",
           *ARGS, "--ckpt_dir", str(tmp_path / "ckpt"),
           "--ckpt_interval", "2", "--ckpt_keep", "3", "--resume"]
    # run 1 crashes at step 5: checkpoints at steps 2 and 4
    r1 = subprocess.run(cmd, env=_env(crash_at=5), cwd=tmp_path,
                        capture_output=True, text=True, timeout=RUN_TIMEOUT)
    assert r1.returncode != 0
    assert "simulated crash at step 5" in r1.stdout + r1.stderr
    assert _steps(tmp_path / "ckpt") == [2, 4]
    # run 2 resumes from step 4 and finishes
    r2 = subprocess.run(cmd, env=_env(), cwd=tmp_path, capture_output=True,
                        text=True, timeout=RUN_TIMEOUT)
    assert r2.returncode == 0, r2.stdout[-3000:] + r2.stderr[-3000:]
    m = re.search(r"resumed from .*step (\d+)", r2.stdout)
    assert m and int(m.group(1)) == 4, r2.stdout[-2000:]
    assert "final metrics" in r2.stdout
    # the checkpoints after the resume carry global steps past the crash
    assert _steps(tmp_path / "ckpt")[-1] > 4


def test_elastic_wrapper_restarts(tmp_path):
    """The wrapper sees the crash at step 3, restarts the trainer with
    ``--resume`` from the step-2 checkpoint, and the run ends with exit 0
    at a global step past the crash (the reference's wrapper does the
    same)."""
    env = _env(crash_at=3)
    env["MINDREC_CRASH_MARKER"] = str(tmp_path / "crashed_once")
    env["MR_CKPT_INTERVAL"] = "2"
    r = subprocess.run(["bash", str(WRAPPER), "2", *ARGS,
                        "--ckpt_dir", str(tmp_path / "ckpt")],
                       env=env, cwd=tmp_path, capture_output=True, text=True,
                       timeout=3 * RUN_TIMEOUT)
    assert "restart 1/2" in r.stderr
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert re.search(r"resumed from .*step 2\)", r.stdout), r.stdout[-2000:]
    assert "final metrics" in r.stdout
    # the restart trains its epoch anew from the step-2 state: 2 + 8
    assert _steps(tmp_path / "ckpt")[-1] == 10


def test_elastic_wrapper_gives_up(tmp_path):
    """A trainer that crashes on every start: the wrapper restarts it
    ``MAX_RESTARTS`` times, then exits with the trainer's code."""
    env = _env(crash_at=1)
    r = subprocess.run(["bash", str(WRAPPER), "1", *ARGS,
                        "--ckpt_dir", str(tmp_path / "ckpt")],
                       env=env, cwd=tmp_path, capture_output=True, text=True,
                       timeout=3 * RUN_TIMEOUT)
    assert r.returncode != 0
    assert "restart 1/1" in r.stderr
    assert "elastic: giving up after 1 restarts" in r.stderr
    assert "restart 2/1" not in r.stderr
