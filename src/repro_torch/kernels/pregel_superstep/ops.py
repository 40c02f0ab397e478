"""Wrapper of the fused superstep kernel (``csrc/superstep.cu``).

For tensors on the CPU, ``fused_superstep`` runs the plain version
(``ref.superstep_plain``).  For CUDA tensors it launches the CUDA kernel
or raises ``ValueError`` for an input the kernel does not take (state
with trailing dims, a message that is not one of the compiled edge
programs, an unsupported dtype): nothing falls back.  Callers that want
the plain version on the card (parity runs) call ``superstep_plain``
themselves.

The kernel cannot inline an arbitrary Python edge program the way the
reference's Pallas kernel inlines a jnp callable, so this module exports
the four compiled programs as module-level functions.  Vertex programs
use them as their ``message``; the wrapper picks the compiled program by
the function's identity.  Each is also plain torch code, so the dense
and frontier paths and the plain version call the very same function.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pregel_superstep.ref import (
    as_dtype, fill_value, superstep_plain)

#: Launches of the CUDA kernel, counted where the wrapper launches it
#: (under a lock: the service's worker threads may launch concurrently).
KERNEL_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

CSRC = Path(__file__).resolve().parent / "csrc"


def msg_src(x, w):
    """The source state itself (connected components, k-core)."""
    return x


def msg_src_plus_one(x, w):
    """One hop further (BFS)."""
    return x + 1.0


def msg_src_plus_w(x, w):
    """Relaxation along a weighted edge (SSSP)."""
    return x + w


def msg_src_times_w(x, w):
    """Weighted contribution (the sum form of an SpMV)."""
    return x * w


#: compiled edge program -> its index in the CUDA source
EDGE_PROGRAMS = {msg_src: 0, msg_src_plus_one: 1, msg_src_plus_w: 2,
                 msg_src_times_w: 3}
_OPS = {"sum": 0, "min": 1, "max": 2}
_DTYPES = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2,
           torch.float16: 3}


def compiled(message) -> bool:
    """Whether ``message`` is one of the kernel's compiled edge programs."""
    try:
        return message in EDGE_PROGRAMS
    except TypeError:            # unhashable callable
        return False


_LIB = None


def library():
    """The built kernel library (compiled on first call)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("pregel_superstep", sorted(CSRC.glob("*.cu")))
        fn = lib.pregel_superstep
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
                       + [ctypes.c_int] * 4
                       + [ctypes.c_double, ctypes.c_int, ctypes.c_void_p])
        _LIB = lib
    return _LIB


#: slots a block takes at once (``kPiece`` in the CUDA source)
PIECE_SLOTS = 2048


def _rows_per_tile(k: int) -> int:
    """R, the rows a block owns: as many as fit one piece of 2048 slots,
    a multiple of 4 from 4 up (so every tile starts on a 4-slot group);
    a row longer than a piece is a tile of its own, walked piece by
    piece."""
    r = max(1, PIECE_SLOTS // max(k, 1))
    return r - r % 4 if r >= 4 else r


def kernel_out_dtype(x: torch.Tensor, message, message_dtype=None):
    """The dtype the kernel writes: the channel dtype when set, else the
    edge program's result (int32 only for ``msg_src`` on int32 state)."""
    if message_dtype is not None:
        return as_dtype(message_dtype)
    if message is msg_src and x.dtype == torch.int32:
        return torch.int32
    return torch.float32


def fused_superstep(nbr, mask, w, x, *, message, op: str, identity,
                    message_dtype=None):
    """One fused superstep: agg over masked message(x[nbr], w).

    CPU tensors: the plain version.  CUDA tensors: the hand-written
    kernel, bit-identical to the plain version for min/max (and equal up
    to summation order for float sums), or ``ValueError``.
    """
    global KERNEL_LAUNCHES
    if x.device.type == "cpu":
        return superstep_plain(nbr, mask, w, x, message=message, op=op,
                               identity=identity,
                               message_dtype=message_dtype)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fused_superstep: unsupported device {dev}")
    if not compiled(message):
        raise ValueError(
            f"fused_superstep: {getattr(message, '__name__', message)!r} is "
            "not a compiled edge program; use one of "
            f"{[f.__name__ for f in EDGE_PROGRAMS]}")
    if op not in _OPS:
        raise ValueError(f"fused_superstep: unknown op {op!r}")
    if x.dim() != 1 or x.dtype not in (torch.int32, torch.float32):
        raise ValueError("fused_superstep: the kernel takes 1-D int32 or "
                         f"float32 state, got {tuple(x.shape)} {x.dtype}")
    if nbr.dim() != 2 or nbr.dtype != torch.int32:
        raise ValueError("fused_superstep: nbr must be [V, K] int32")
    V, K = nbr.shape
    if mask.dtype != torch.bool or tuple(mask.shape) != (V, K):
        raise ValueError("fused_superstep: mask must be [V, K] bool")
    if w.dtype != torch.float32 or tuple(w.shape) != (V, K):
        raise ValueError("fused_superstep: w must be [V, K] float32")
    for name, t in (("nbr", nbr), ("mask", mask), ("w", w), ("x", x)):
        if t.device != dev:
            raise ValueError(f"fused_superstep: {name} is on {t.device}, "
                             f"x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"fused_superstep: {name} must be contiguous")
    out_dtype = kernel_out_dtype(x, message, message_dtype)
    if out_dtype not in _DTYPES:
        raise ValueError("fused_superstep: unsupported message dtype "
                         f"{out_dtype}")
    if out_dtype == torch.int32 and not (message is msg_src
                                         and x.dtype == torch.int32):
        raise ValueError("fused_superstep: an int32 channel needs an int32 "
                         "message")
    out = torch.empty(V, dtype=out_dtype, device=dev)
    if V == 0:
        return out
    if x.shape[0] == 0:
        raise ValueError("fused_superstep: empty gather source")
    lib = library()
    with torch.cuda.device(dev):
        rc = lib.pregel_superstep(
            nbr.data_ptr(), mask.data_ptr(), w.data_ptr(), x.data_ptr(),
            out.data_ptr(), V, K, x.shape[0], _DTYPES[x.dtype],
            EDGE_PROGRAMS[message], _OPS[op], _DTYPES[out_dtype],
            float(fill_value(op, identity)), _rows_per_tile(K),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pregel_superstep launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        KERNEL_LAUNCHES += 1
    return out
