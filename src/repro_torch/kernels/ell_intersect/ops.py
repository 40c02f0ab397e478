"""Wrappers of the sorted-row intersection kernel (``csrc/intersect.cu``).

``ell_intersect_counts`` takes an ``OrientedELL`` and returns the
per-oriented-edge counts; ``ell_intersect`` takes two row matrices and
intersects them row by row (the form the reference's kernel tests use).
For tensors on the CPU both run the plain version (``ref``).  For CUDA
tensors they launch the CUDA kernel, which gathers each edge's two rows
from ``nbr`` itself, or raise ``ValueError`` for an input the kernel does
not take (another dtype, a non-contiguous tensor, mismatched devices):
nothing falls back.  Callers that want the plain version on the card
(parity runs) pass ``use_kernels=False`` or call ``ref`` themselves.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ell_intersect.ref import (
    ell_intersect_counts_plain, ell_intersect_plain)

#: Launches of the CUDA kernel, counted where the wrapper launches it
#: (under a lock: the service's worker threads may launch concurrently).
KERNEL_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

CSRC = Path(__file__).resolve().parent / "csrc"

#: the widest rows the staged path takes (``kStagedMaxK``)
STAGED_MAX_K = 32

_LIB = None


def _lanes_log2(k: int) -> int:
    """The kernel's path for rows of K slots, as log2 of the lanes an
    edge: 0 for 1 <= K <= 32, a lane an edge merging the two rows staged
    in shared memory (row u once per run of edges); otherwise the search
    path, where the lanes an edge are the power of two at or above K/16
    (between 2 and 32), each lane binary-searching at most 16 ids of the
    shorter row in the longer one."""
    if 1 <= k <= STAGED_MAX_K:
        return 0
    target = min(-(-max(k, 1) // 16), 32)
    g = 1
    while (1 << g) < target:
        g += 1
    return g


def library():
    """The built kernel library (compiled on first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("ell_intersect", sorted(CSRC.glob("*.cu")))
        fn = lib.ell_intersect
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4
                       + [ctypes.c_int, ctypes.c_void_p])
        _LIB = lib
    return _LIB


def _launch(nbr, eu, ev, sentinel: int) -> torch.Tensor:
    global KERNEL_LAUNCHES
    dev = nbr.device
    if dev.type != "cuda":
        raise ValueError(f"ell_intersect: unsupported device {dev}")
    if nbr.dim() != 2 or nbr.dtype != torch.int32:
        raise ValueError("ell_intersect: nbr must be [rows, K] int32, got "
                         f"{tuple(nbr.shape)} {nbr.dtype}")
    for name, t in (("eu", eu), ("ev", ev)):
        if t.dim() != 1 or t.dtype != torch.int32:
            raise ValueError(f"ell_intersect: {name} must be [E] int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if eu.shape != ev.shape:
        raise ValueError("ell_intersect: eu and ev differ in length")
    for name, t in (("nbr", nbr), ("eu", eu), ("ev", ev)):
        if t.device != dev:
            raise ValueError(f"ell_intersect: {name} is on {t.device}, "
                             f"nbr on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"ell_intersect: {name} must be contiguous")
    E = eu.shape[0]
    out = torch.empty(E, dtype=torch.int32, device=dev)
    if E == 0:
        return out
    if nbr.shape[0] == 0:
        raise ValueError("ell_intersect: nbr has no rows")
    lib = library()
    with torch.cuda.device(dev):
        rc = lib.ell_intersect(
            nbr.data_ptr(), eu.data_ptr(), ev.data_ptr(), out.data_ptr(),
            E, nbr.shape[1], nbr.shape[0], int(sentinel),
            _lanes_log2(nbr.shape[1]),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ell_intersect launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        KERNEL_LAUNCHES += 1
    return out


def ell_intersect(a, b, sentinel: int):
    """``c[i] = |a[i] ∩ b[i]|`` for two ``[E, K]`` int32 row matrices.

    CPU tensors: the plain version.  CUDA tensors: one launch of the
    kernel over ``nbr = cat(a, b)`` with edge ``i`` joining rows ``i``
    and ``E + i``.
    """
    if a.device.type == "cpu":
        return ell_intersect_plain(a, b, sentinel)
    if a.shape != b.shape or a.dim() != 2:
        raise ValueError("ell_intersect: a and b must be [E, K] of one "
                         "shape")
    for name, t in (("a", a), ("b", b)):
        if t.device != a.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"ell_intersect: {name} must be a contiguous "
                             f"int32 tensor on {a.device}")
    E = a.shape[0]
    ids = torch.arange(E, dtype=torch.int32, device=a.device)
    return _launch(torch.cat([a, b]), ids, ids + E, sentinel)


def ell_intersect_counts(oriented, use_kernels: bool = True,
                         chunk_edges: int = 1 << 18) -> torch.Tensor:
    """Per-oriented-edge intersection counts for a whole ``OrientedELL``.

    Returns an int32 tensor of length ``oriented.n_edges`` on the
    orientation's device (a count is at most K); the triangle count is
    its int64 sum.  ``use_kernels=True``: on the card one kernel launch
    over every padded edge (padding edges count 0 and are sliced off), on
    the CPU the plain version; ``False``: the plain version wherever the
    orientation lives.  ``chunk_edges`` bounds the plain version's
    temporaries; the kernel gathers rows in place and needs no chunks.
    """
    if not use_kernels or oriented.nbr.device.type == "cpu":
        return ell_intersect_counts_plain(oriented, chunk_edges)
    counts = _launch(oriented.nbr, oriented.eu, oriented.ev,
                     oriented.n_vertices)
    return counts[: oriented.n_edges]
