"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel package keeps its sources under ``csrc/`` with a plain C entry
point (no PyTorch headers, so a build takes seconds, not minutes).  On
first use a source set is compiled for Hopper into a shared library under
``build/repro_torch_kernels/`` at the repository root (the checkout's own
ignored build directory), named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads the library already
there.  A library whose source compiles in parts (``parts``: each a set of
extra flags, such as a macro that selects the part) builds every part
into an object at once, one nvcc each, and links the objects.  Nothing
here runs at import time: CPU-only hosts import every module without a
compiler.
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


def _digest(sources: Sequence[Path], parts=None) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    if parts is not None:
        h.update(repr(parts).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile_parts(srcs, parts, so):
    """Every (source, part) into an object, all nvcc processes at once,
    then the objects into ``so``.  Returns nvcc's output."""
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs, procs = [], []
    for i, (src, part) in enumerate((s, p) for s in srcs for p in parts):
        obj = so.with_name(f"{so.stem}.{os.getpid()}.{i}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc_path(), *flags, *part, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    log, failed = "", []
    for proc in procs:
        out, _ = proc.communicate()
        log += out
        if proc.returncode != 0:
            failed.append(proc.returncode)
    try:
        if not failed:
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(so), *map(str, objs)],
                capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                failed.append(proc.returncode)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed for {so.name} (exit {failed[0]}):"
                           f"\n{log}")
    return log


def load(name: str, sources: Sequence[os.PathLike],
         parts=None) -> ctypes.CDLL:
    """Compile ``sources`` into ``lib<name>-<hash>.so`` (once) and load it;
    with ``parts`` (a sequence of tuples of extra nvcc flags), each source
    once for each part, in parallel, linked into the one library.  Raises
    ``RuntimeError`` with nvcc's output when the build fails.  Libraries
    of different names build concurrently when called from several
    threads; one name builds once."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        srcs = [Path(s) for s in sources]
        so = BUILD_DIR / f"lib{name}-{_digest(srcs, parts)}.so"
        t0 = time.perf_counter()
        log, cached = "", so.exists()
        if not cached:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            if parts is not None:
                log = _compile_parts(srcs, parts, tmp)
            else:
                cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                       *(str(s) for s in srcs)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {name} (exit "
                                       f"{proc.returncode}):\n{log}")
            os.replace(tmp, so)       # atomic: concurrent builders agree
        lib = ctypes.CDLL(str(so))
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                           "path": str(so), "cached": cached, "log": log}
        _LIBS[name] = lib
        return lib
