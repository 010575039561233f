"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The library
lands in ``mindrec_tpu_torch/_build/<hash>/`` (listed in ``.gitignore``),
where the hash covers the sources and the flags, so a changed source
rebuilds and an unchanged one is reused.  ``-Xptxas=-v`` output
(registers, spills) is kept in ``build.log`` beside the library.

Ranks started together (``parallel/launch.py``) build under a file lock
on ``_build/.lock``: the first builds, the others wait and load its
library.  The entry points return a ``cudaError_t``; :func:`check`
raises on any non-zero code.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
LIB_NAME = "libmindrec_kernels.so"
# --fmad=false: no multiply-add contraction, so the update kernels round
# exactly where the plain PyTorch versions (and the JAX reference) do
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
        Path("/usr/local/cuda/bin/nvcc")
    ]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels are built "
            "from mindrec_tpu_torch/csrc at first use"
        )
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    """Directory of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` (in parallel) and link; returns the library
    path.  Reuses a library already built from the same sources; one
    process at a time builds (a file lock)."""
    out = build_dir()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with open(BUILD_ROOT / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():  # another process built it while we waited
            return lib
        return _build_locked(out, lib)


def _build_locked(out: Path, lib: Path) -> Path:
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in _sources():
        obj = out / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    log, failed = [], []
    for src, _obj, proc in jobs:
        text, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    (out / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}:\n" + "\n".join(log)
        )
    tmp = out / (LIB_NAME + f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _s, o, _p in jobs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.mr_error_string.argtypes = [ctypes.c_int]
            lib.mr_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


_bound: dict[str, object] = {}


def kernel_fn(name: str, argtypes: list, restype=ctypes.c_int):
    """ctypes entry point ``name`` with its argument types declared."""
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _bound[name] = fn
    return fn


def scratch_len(name: str, *sizes: int) -> int:
    """Elements of a kernel's scratch buffer, asked of the library's
    ``name(sizes...)`` so that the kernel's chunk sizes live in its source
    alone.  ``sizes``: an int64 count, then ints."""
    fn = kernel_fn(name, [ctypes.c_int64] + [ctypes.c_int] * (len(sizes) - 1),
                   restype=ctypes.c_int64)
    return int(fn(*sizes))


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc != 0:
        msg = library().mr_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_of(t) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
