"""Wrapper of the ELL gather + combine kernel (``csrc/ell_combine.cu``).

``ell_spmv(nbr, mask, w, x, op)`` computes ``y[v] = reduce_k(op, mask ?
f(w, x[nbr]) : id)``: ``w * x`` summed for 'sum', ``x`` for 'min'/'max'
(weights ignored).  For tensors on the CPU it runs the plain version
(``ref.ell_combine_plain``).  For CUDA tensors it launches the kernel,
which reads each row's mask first and loads ``nbr`` and ``w`` only at the
live slots (a lane a row; the warp gathers its rows' live slots
together), or raises ``ValueError`` for an input the kernel does not take
(state that is not 1-D float32, another op, K above ``MAX_K``, layouts
that are not contiguous ``[V, K]`` int32 / bool / float32, mismatched
devices, an empty gather source): nothing falls back.  It keeps its own
launch count.

Left out of the reference on purpose: the 16 MiB VMEM budget for ``x``
with its fallback to the reference (``x`` stays in device memory and L2
on the card) and the padding of rows to 512 and K to 128 lanes (the
kernel reads each row's ragged edge itself).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ell_combine.ref import (ell_combine_plain,
                                                 ell_combine_ref)

#: Launches of the CUDA kernel, counted where the wrapper launches it
#: (under a lock: worker threads may launch concurrently).
KERNEL_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

CSRC = Path(__file__).resolve().parent / "csrc"
_OPS = {"sum": 0, "min": 1, "max": 2}
#: the widest row the kernel takes: 32 rows of K slots in int32
MAX_K = (2 ** 31 - 1) // 32

_LIB = None


def library():
    """The built kernel library (compiled on first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("ell_combine", sorted(CSRC.glob("*.cu")))
        fn = lib.ell_combine
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
        _LIB = lib
    return _LIB


def check(nbr, mask, w, x, op: str) -> None:
    """Raise ``ValueError`` for an input the kernel does not take (the
    device last, so the layout rules can be checked on any tensor)."""
    if op not in _OPS:
        raise ValueError(f"ell_spmv: unknown op {op!r}")
    dev = x.device
    if x.dim() != 1 or x.dtype != torch.float32:
        raise ValueError(f"ell_spmv: the kernel takes 1-D float32 x, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if nbr.dim() != 2 or nbr.dtype != torch.int32:
        raise ValueError("ell_spmv: nbr must be [V, K] int32")
    V, K = nbr.shape
    if K > MAX_K:
        raise ValueError(f"ell_spmv: K={K} exceeds {MAX_K} (a warp's 32 "
                         "rows are indexed in int32)")
    if mask.dtype != torch.bool or tuple(mask.shape) != (V, K):
        raise ValueError("ell_spmv: mask must be [V, K] bool")
    if w.dtype != torch.float32 or tuple(w.shape) != (V, K):
        raise ValueError("ell_spmv: w must be [V, K] float32")
    for name, t in (("nbr", nbr), ("mask", mask), ("w", w), ("x", x)):
        if t.device != dev:
            raise ValueError(f"ell_spmv: {name} is on {t.device}, x on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"ell_spmv: {name} must be contiguous")
    if V and x.shape[0] == 0:
        raise ValueError("ell_spmv: empty gather source")
    if dev.type != "cuda":
        raise ValueError(f"ell_spmv: unsupported device {dev}")


def ell_spmv(nbr, mask, w, x, op: str = "sum"):
    """``y[v] = reduce_k(op, mask ? f(w, x[nbr]) : id)`` over one ELL
    layout: the plain version for CPU tensors, the kernel for CUDA
    tensors (or ``ValueError``)."""
    global KERNEL_LAUNCHES
    if x.device.type == "cpu":
        return ell_combine_plain(nbr, mask, w, x, op=op)
    check(nbr, mask, w, x, op)
    V, K = nbr.shape
    out = torch.empty(V, dtype=torch.float32, device=x.device)
    if V == 0:
        return out
    lib = library()
    with torch.cuda.device(x.device):
        rc = lib.ell_combine(
            nbr.data_ptr(), mask.data_ptr(), w.data_ptr(), x.data_ptr(),
            out.data_ptr(), V, K, x.shape[0], _OPS[op],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ell_combine launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        KERNEL_LAUNCHES += 1
    return out


def ell_spmv_ref(nbr, mask, w, x, op: str = "sum"):
    """The plain version under the kernel's signature."""
    return ell_combine_ref(nbr, mask, w, x, op=op)

