"""Wrapper of the fused superstep kernel (``csrc/superstep.cu``).

For tensors on the CPU, ``fused_superstep`` runs the plain version
(``ref.superstep_plain``).  For CUDA tensors it launches a CUDA kernel:
``pregel_superstep`` for state ``[Vx]``, ``pregel_superstep_batched``
for state ``[Vx, B]`` (a fused batch of B queries lifted by
``core.pregel.batched_spec``, ``w`` shared by every column).  An input
neither entry takes (a message that is not one of the compiled edge
programs, an unsupported dtype, state with more dims) raises
``ValueError``: nothing falls back.  Callers that want the plain version
on the card (parity runs) call ``superstep_plain`` themselves.

``csr_superstep`` is the same superstep over the destination-sorted edge
list read as a CSR (the dense path's gather, message and combine in one
pass): ``csr_superstep_plain`` on the CPU, ``pregel_superstep_csr`` on
the card, for 1-D int32 or float32 state under min or max.  Its row
offsets and tile table (``csr_layout``) are built once a graph.

The kernel cannot inline an arbitrary Python edge program the way the
reference's Pallas kernel inlines a jnp callable, so this module exports
the four compiled programs as module-level functions.  Vertex programs
use them as their ``message``; the wrapper picks the compiled program by
the function's identity, through the ``base`` a batched lift carries.
Each is also plain torch code, so the dense and frontier paths and the
plain version call the very same function.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pregel_superstep.ref import (
    as_dtype, csr_superstep_plain, fill_value, superstep_plain)

#: Launches of the CUDA kernels (both entries), counted where the wrapper
#: launches them (under a lock: the service's worker threads may launch
#: concurrently).
KERNEL_LAUNCHES = 0
#: Of those, the launches of the ``[Vx, B]`` entry.
BATCHED_LAUNCHES = 0
#: Calls of the CSR entry (``pregel_superstep_csr``), not in the two
#: counts above.
CSR_LAUNCHES = 0
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


def base_program(message):
    """The callable the kernel would compile ``message`` as: ``message``
    itself, or for a batched lift (``core.pregel.batched_spec``) the
    scalar program it carries as ``base``."""
    return getattr(message, "base", message)


def compiled(message) -> bool:
    """Whether ``message`` is one of the kernel's compiled edge programs,
    or a batched lift of one."""
    try:
        return base_program(message) in EDGE_PROGRAMS
    except TypeError:            # unhashable callable
        return False


_LIB = None


def library():
    """The built kernel library (compiled on first call)."""
    global _LIB
    if _LIB is None:
        # the source's four parts (1-D entry, batched on int32 and on
        # float32 state, CSR entry) compile at once
        lib = _build.load("pregel_superstep", sorted(CSRC.glob("*.cu")),
                          parts=[(f"-DSUPERSTEP_PART={p}",)
                                 for p in (1, 2, 3, 4)])
        fn = lib.pregel_superstep
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
                       + [ctypes.c_int] * 4
                       + [ctypes.c_double, ctypes.c_int, ctypes.c_void_p])
        fb = lib.pregel_superstep_batched
        fb.restype = ctypes.c_int
        fb.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4
                       + [ctypes.c_int] * 4 + [ctypes.c_double]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fc = lib.pregel_superstep_csr
        fc.restype = ctypes.c_int
        fc.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_void_p, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 3
                       + [ctypes.c_double, ctypes.c_void_p])
        _LIB = lib
    return _LIB


#: slots a block takes at once (``kPiece`` in the CUDA source)
PIECE_SLOTS = 2048
#: values (slots x columns) a block of the batched entry holds at once
#: for rows longer than ``SHORT_ROW``
BATCHED_VALUES = 8192
#: columns the batched entry takes in one pass over a tile
BATCHED_COLS = 1024
#: K at most for which the batched entry keeps a row's values in
#: registers (``kShortRow``); such a tile holds at most ``SHORT_PIECE``
#: slots (``kMaxShortPiece``)
SHORT_ROW = 64
SHORT_PIECE = 3072
#: threads a block (``kThreads``)
THREADS = 256
#: shared memory a block may have on the H100 (``kMaxSmem``)
MAX_SMEM_BYTES = 232448


def _rows_per_tile(k: int, piece: int = PIECE_SLOTS) -> int:
    """R, the rows a block owns: as many as fit one piece of ``piece``
    slots, a multiple of 4 from 4 up (so every tile starts on a 4-slot
    group); a row longer than a piece is a tile of its own, walked piece
    by piece."""
    r = max(1, piece // max(k, 1))
    return r - r % 4 if r >= 4 else r


class BatchedGeometry(NamedTuple):
    """The launch of ``pregel_superstep_batched``, in the order its C
    entry point takes it."""
    rows: int        # R, rows a tile
    piece: int       # P, slots a piece (a multiple of 4)
    cols: int        # C, columns a pass
    vec: bool        # 16-byte loads of 4 columns, else 4-byte ones
    smem: int        # dynamic shared memory a block, bytes


def _batched_geometry(b: int, k: int, aligned: bool) -> BatchedGeometry:
    """The batched entry's launch for ``b`` columns and ``k`` slots a row;
    ``aligned``: x and out start on 16-byte boundaries.  The columns go
    in passes of up to ``BATCHED_COLS``, in groups of 4 (``vec``) or 1.
    Rows of at most ``SHORT_ROW`` slots in groups of 4: a tile holds a
    row for each column group of a block's threads (at most
    ``SHORT_PIECE`` slots), shared memory two tiles' ids and weights and
    three tiles' mask bytes (19 bytes a slot).  Longer rows, and single
    columns: a piece holds ``BATCHED_VALUES`` values (slots x columns of
    a pass, at most 2048 slots), shared memory its ids, weights and
    values and a long row's carried partials.  The CUDA source counts
    the same (``batched_smem_bytes``) and refuses any other count."""
    cols = min(b, BATCHED_COLS)
    vec = aligned and b % 4 == 0
    if k <= SHORT_ROW and vec:
        groups = cols // 4
        rows = _rows_per_tile(k, min(max(THREADS // groups, 1) * max(k, 1),
                                     SHORT_PIECE))
        piece = max(4, -(-rows * k // 4) * 4)
        return BatchedGeometry(rows, piece, cols, vec, 19 * piece)
    piece = min(PIECE_SLOTS, max(4, BATCHED_VALUES // cols // 4 * 4))
    smem = 4 * (2 * piece + piece * cols + cols)
    return BatchedGeometry(_rows_per_tile(k, piece), piece, cols, vec, smem)


def kernel_out_dtype(x: torch.Tensor, message, message_dtype=None):
    """The dtype the kernel writes: the channel dtype when set, else the
    edge program's result (int32 only for ``msg_src`` on int32 state)."""
    if message_dtype is not None:
        return as_dtype(message_dtype)
    if base_program(message) is msg_src and x.dtype == torch.int32:
        return torch.int32
    return torch.float32


def fused_superstep(nbr, mask, w, x, *, message, op: str, identity,
                    message_dtype=None):
    """One fused superstep: agg over masked message(x[nbr], w).

    ``x`` is ``[Vx]`` with a compiled edge program, or ``[Vx, B]`` with a
    batched lift of one (``w`` broadcast over the B columns); the result
    is ``[V]`` or ``[V, B]``.  CPU tensors: the plain version.  CUDA
    tensors: the hand-written kernel, bit-identical to the plain version
    for min/max (and equal up to summation order for float sums), or
    ``ValueError``.
    """
    global KERNEL_LAUNCHES, BATCHED_LAUNCHES
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
    program = base_program(message)
    if op not in _OPS:
        raise ValueError(f"fused_superstep: unknown op {op!r}")
    batched = program is not message
    if x.dim() != (2 if batched else 1) \
            or x.dtype not in (torch.int32, torch.float32):
        raise ValueError(
            "fused_superstep: the kernels take int32 or float32 state, 1-D "
            "[Vx] with a compiled edge program or 2-D [Vx, B] with its "
            f"batched lift; got {tuple(x.shape)} {x.dtype}"
            f"{' with a batched lift' if batched else ''}")
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
    if out_dtype == torch.int32 and not (program is msg_src
                                         and x.dtype == torch.int32):
        raise ValueError("fused_superstep: an int32 channel needs an int32 "
                         "message")
    out = torch.empty((V,) + tuple(x.shape[1:]), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    if x.shape[0] == 0:
        raise ValueError("fused_superstep: empty gather source")
    lib = library()
    fill = float(fill_value(op, identity))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if batched:
            geo = _batched_geometry(
                x.shape[1], K,
                x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
            rc = lib.pregel_superstep_batched(
                nbr.data_ptr(), mask.data_ptr(), w.data_ptr(), x.data_ptr(),
                out.data_ptr(), V, K, x.shape[0], x.shape[1],
                _DTYPES[x.dtype], EDGE_PROGRAMS[program], _OPS[op],
                _DTYPES[out_dtype], fill, *geo, stream)
        else:
            rc = lib.pregel_superstep(
                nbr.data_ptr(), mask.data_ptr(), w.data_ptr(), x.data_ptr(),
                out.data_ptr(), V, K, x.shape[0], _DTYPES[x.dtype],
                EDGE_PROGRAMS[program], _OPS[op], _DTYPES[out_dtype],
                fill, _rows_per_tile(K), stream)
    if rc != 0:
        entry = "pregel_superstep_batched" if batched else "pregel_superstep"
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        KERNEL_LAUNCHES += 1
        BATCHED_LAUNCHES += batched
    return out


#: items (row ends and edges together) a block of the CSR entry takes
#: (``kCsrTile``)
CSR_TILE = 2048


class CSRLayout(NamedTuple):
    """A destination-sorted edge list read as a CSR, for ``csr_superstep``:
    ``rowptr`` [V + 1] int32 (row v's edges are ``rowptr[v]`` to
    ``rowptr[v + 1]``; edges past ``rowptr[V]`` are padding), and
    ``tiles`` [n_tiles + 1, 2] int32, the (row, edge) at which each block's
    ``CSR_TILE`` items of the merge of row ends and edges start."""
    rowptr: torch.Tensor
    tiles: torch.Tensor


def csr_layout(dst: torch.Tensor, n_vertices: int):
    """The CSR of edges whose destinations ``dst`` (int32, padding = V)
    are sorted, on ``dst``'s device; None where they are not sorted or
    the merge of V row ends and the edges has 2^31 items or more."""
    V = int(n_vertices)
    dev = dst.device
    if dst.numel() > 1 and bool((dst[1:] < dst[:-1]).any()):
        return None
    rowptr = torch.searchsorted(
        dst.contiguous(), torch.arange(V + 1, dtype=dst.dtype, device=dev),
        out_int32=True)
    total = V + int(rowptr[-1])
    if total >= 2 ** 31:
        return None
    # tile t starts at diagonal d = t * CSR_TILE of the merge path: the row
    # ends taken there are those of rows i with rowptr[i + 1] + i < d
    n_tiles = max(1, -(-total // CSR_TILE))
    diag = (torch.arange(n_tiles + 1, device=dev) * CSR_TILE).clamp_(
        max=total)
    key = rowptr[1:].long() + torch.arange(V, device=dev)
    rows = torch.searchsorted(key, diag)
    tiles = torch.stack([rows, diag - rows], dim=1).to(torch.int32)
    return CSRLayout(rowptr, tiles.contiguous())


def csr_superstep(layout: CSRLayout, src, w, x, *, message, op: str,
                  identity):
    """One dense superstep through the CSR: agg[v] = op over v's in-edges
    e of message(x[src[e]], w[e]), ``identity`` where v has none.

    ``x`` is [Vx] int32 or float32 with a compiled edge program, ``op``
    min or max; the result is [V] (int32 for ``msg_src`` on int32 state,
    else float32).  CPU tensors: the plain version.  CUDA tensors: the
    hand-written kernel, bit-identical to the plain version, or
    ``ValueError`` (among others for ``src`` and ``w`` not 16-byte aligned
    or not a multiple of 4 edges: the partition's shards always are).  The
    output is the one allocation.
    """
    global CSR_LAUNCHES
    if x.device.type == "cpu":
        return csr_superstep_plain(layout.rowptr, src, w, x, message=message,
                                   op=op, identity=identity)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"csr_superstep: unsupported device {dev}")
    if not compiled(message):
        raise ValueError(
            f"csr_superstep: {getattr(message, '__name__', message)!r} is "
            "not a compiled edge program")
    program = base_program(message)
    if op not in ("min", "max"):
        raise ValueError(f"csr_superstep: op must be min or max, got {op!r}")
    if x.dim() != 1 or x.dtype not in (torch.int32, torch.float32):
        raise ValueError("csr_superstep: the kernel takes 1-D int32 or "
                         f"float32 state; got {tuple(x.shape)} {x.dtype}")
    rowptr, tiles = layout
    V = rowptr.shape[0] - 1
    n = src.shape[0]
    if src.dtype != torch.int32 or src.dim() != 1:
        raise ValueError("csr_superstep: src must be [n] int32")
    if w.dtype != torch.float32 or tuple(w.shape) != (n,):
        raise ValueError("csr_superstep: w must be [n] float32")
    if rowptr.dtype != torch.int32 or tiles.dtype != torch.int32 \
            or tiles.dim() != 2 or tiles.shape[1] != 2:
        raise ValueError("csr_superstep: the layout must come from "
                         "csr_layout")
    for name, t in (("rowptr", rowptr), ("tiles", tiles), ("src", src),
                    ("w", w), ("x", x)):
        if t.device != dev:
            raise ValueError(f"csr_superstep: {name} is on {t.device}, "
                             f"x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"csr_superstep: {name} must be contiguous")
    if n % 4 or src.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("csr_superstep: src and w must be 16-byte aligned "
                         "and hold a multiple of 4 edges")
    out_dtype = kernel_out_dtype(x, program)
    out = torch.empty((V,), dtype=out_dtype, device=dev)
    if V == 0:
        return out
    if x.shape[0] == 0:
        raise ValueError("csr_superstep: empty gather source")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = library().pregel_superstep_csr(
            rowptr.data_ptr(), tiles.data_ptr(), tiles.shape[0] - 1,
            src.data_ptr(), n, w.data_ptr(), x.data_ptr(), out.data_ptr(),
            V, x.shape[0], _DTYPES[x.dtype], EDGE_PROGRAMS[program],
            _OPS[op], float(identity), stream)
    if rc != 0:
        raise RuntimeError(f"pregel_superstep_csr launch failed: CUDA error "
                           f"{rc}")
    with _COUNT_LOCK:
        CSR_LAUNCHES += 1
    return out
