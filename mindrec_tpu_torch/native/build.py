"""Build a native host library of the port with g++ at first use.

Every C++ library under ``mindrec_tpu_torch/native`` is compiled into
``mindrec_tpu_torch/_build/<stem>-<hash>/`` (listed in ``.gitignore``),
where the hash covers the sources and the flags: a changed source
rebuilds, an unchanged one is reused.  A failed build raises with the
compiler's output; there is no quiet fallback.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_ROOT = HERE.parent / "_build"
SHARED_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


def build_dir(stem: str, srcs, flags=SHARED_FLAGS, root=None) -> Path:
    """Directory of the library for these sources and flags."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in srcs:
        h.update(Path(src).read_bytes())
    return Path(root or BUILD_ROOT) / f"{stem}-{h.hexdigest()[:16]}"


def build_library(stem: str, src: Path, lib_name: str, headers=(),
                  flags=SHARED_FLAGS, root=None) -> Path:
    """Compile ``src`` (its ``headers`` in the hash too) with g++ once per
    source hash under ``root`` (default ``_build/``); returns the library
    path.  Raises with the compiler's output on failure."""
    lib = build_dir(stem, (src, *headers), flags, root) / lib_name
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found (set CXX): {src.name} is built "
                           f"from mindrec_tpu_torch/native at first use")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib_name}.tmp{os.getpid()}.{threading.get_ident()}")
    r = subprocess.run([cxx, *flags, str(src), "-o", str(tmp)],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{cxx} failed to build {src.name} "
                           f"(rc {r.returncode}):\n{r.stdout}")
    os.replace(tmp, lib)  # atomic: concurrent builds each land whole
    return lib
