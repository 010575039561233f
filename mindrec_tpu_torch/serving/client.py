"""Build and run the C++ inference client (``infer_client.cc``).

The client is built from this directory's ``infer_client.cc`` by ``g++``
at first use (never at import) into
``mindrec_tpu_torch/_build/infer_client-<hash>/`` (listed in
``.gitignore``), where the hash covers the source and the flags, as
``native/batchprep.py`` builds the native prep.  A failed build raises
with the compiler's output.  The client runs on the host CPU: its
latency is host time.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "infer_client.cc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-Wall")
_LATENCY = re.compile(r"avg latency: ([0-9.]+) ms")


def build_dir() -> Path:
    """Directory of the binary for the current source and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / f"infer_client-{h.hexdigest()[:16]}"


def build() -> Path:
    """Compile ``infer_client.cc`` with g++ (once per source hash);
    returns the binary's path.  Raises with the compiler's output."""
    exe = build_dir() / "infer_client"
    if exe.exists():
        return exe
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found (set CXX): the inference client "
                           "is built from mindrec_tpu_torch/serving at "
                           "first use")
    exe.parent.mkdir(parents=True, exist_ok=True)
    tmp = exe.with_name(f"infer_client.tmp{os.getpid()}.{threading.get_ident()}")
    r = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{cxx} failed to build {SRC.name} "
                           f"(rc {r.returncode}):\n{r.stdout}")
    os.replace(tmp, exe)  # atomic: concurrent builds each land whole
    return exe


def run_files(model_path, ids_path, wts_path, batch: int, fields: int,
              out_path) -> tuple[np.ndarray, float]:
    """Run the client on binary input files (``records2bin``'s layout):
    -> (probabilities [batch] float64 as printed, its latency in host
    ms).  Raises when the client fails."""
    r = subprocess.run(
        [str(build()), str(model_path), str(ids_path), str(wts_path),
         str(batch), str(fields), str(out_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"infer_client failed (rc {r.returncode}): "
                           f"{r.stderr}")
    m = _LATENCY.search(r.stderr)
    if m is None:
        raise RuntimeError(f"infer_client printed no latency: {r.stderr}")
    probs = np.array([float(x) for x in Path(out_path).read_text().split()])
    if probs.size != batch:
        raise RuntimeError(f"infer_client wrote {probs.size} of {batch} "
                           f"probabilities")
    return probs, float(m.group(1))


def run_client(model_path, ids, wts) -> tuple[np.ndarray, float]:
    """Run the client on one batch (``ids [B, F]`` int32, ``wts [B, F]``
    float32) through files in a temporary directory."""
    ids = np.ascontiguousarray(ids, np.int32)
    wts = np.ascontiguousarray(wts, np.float32)
    with tempfile.TemporaryDirectory(prefix="mrec-client-") as d:
        d = Path(d)
        (d / "ids.bin").write_bytes(ids.tobytes())
        (d / "wts.bin").write_bytes(wts.tobytes())
        return run_files(model_path, d / "ids.bin", d / "wts.bin",
                         ids.shape[0], ids.shape[1], d / "out.txt")
