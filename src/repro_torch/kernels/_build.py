"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel package keeps its sources under ``csrc/`` with a plain C entry
point (no PyTorch headers, so a build takes seconds, not minutes).  On
first use a source set is compiled for Hopper into a shared library under
``build/repro_torch_kernels/`` at the repository root (the checkout's own
ignored build directory), named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads the library already
there.  Nothing here runs at import time: CPU-only hosts import every
module without a compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Sequence

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_NAME_LOCKS: dict = {}       # one lock per library: builds run in parallel
_LIBS: dict = {}
#: name -> {"seconds", "path", "cached", "log"} of the last load/build;
#: ``log`` holds nvcc's output, including ptxas' register/spill report.
BUILD_LOG: dict = {}


def nvcc_path() -> str:
    """nvcc from ``$CUDA_HOME``/``$CUDA_PATH``, then ``PATH``, then the
    toolkit's conventional install prefix."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _digest(sources: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load(name: str, sources: Sequence[os.PathLike]) -> ctypes.CDLL:
    """Compile ``sources`` into ``lib<name>-<hash>.so`` (once) and load it.
    Raises ``RuntimeError`` with nvcc's output when the build fails.
    Libraries of different names build concurrently when called from
    several threads; one name builds once."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        srcs = [Path(s) for s in sources]
        so = BUILD_DIR / f"lib{name}-{_digest(srcs)}.so"
        t0 = time.perf_counter()
        log, cached = "", so.exists()
        if not cached:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   *(str(s) for s in srcs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
            os.replace(tmp, so)       # atomic: concurrent builders agree
        lib = ctypes.CDLL(str(so))
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                           "path": str(so), "cached": cached, "log": log}
        _LIBS[name] = lib
        return lib
