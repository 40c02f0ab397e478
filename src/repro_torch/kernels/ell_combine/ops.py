"""Wrapper of the ELL gather + combine (``ell_spmv``).

The function is a special case of the fused Pregel superstep, so on the
card it launches that hand-written kernel
(``kernels/pregel_superstep/csrc/superstep.cu``) rather than a body of its
own: 'sum' runs the ``x * w`` edge program with fill 0, 'min'/'max' the
``x`` program with fill ``±inf``, on float32 state only.  Anything else
raises ``ValueError``; nothing falls back.  It keeps its own launch count,
apart from ``pregel_superstep``'s.  For tensors on the CPU it runs the
plain version (``ref.ell_combine_plain``).

Left out of the reference on purpose: the 16 MiB VMEM budget for ``x``
with its fallback to the reference (``x`` stays in device memory and L2
on the card) and the padding of rows to 512 and K to 128 lanes (the
kernel masks its ragged edge itself).
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels.ell_combine.ref import (
    _IDENTITY, ell_combine_plain, ell_combine_ref)
from repro_torch.kernels.pregel_superstep import ops as superstep_ops

#: Launches of the superstep kernel made by ``ell_spmv``, counted where it
#: launches (under a lock: worker threads may launch concurrently).
KERNEL_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

_PROGRAM = {"sum": superstep_ops.msg_src_times_w,
            "min": superstep_ops.msg_src, "max": superstep_ops.msg_src}


def ell_spmv(nbr, mask, w, x, op: str = "sum"):
    """``y[v] = reduce_k(op, mask ? f(w, x[nbr]) : id)`` over one ELL
    layout."""
    global KERNEL_LAUNCHES
    if x.device.type == "cpu":
        return ell_combine_plain(nbr, mask, w, x, op=op)
    if op not in _PROGRAM:
        raise ValueError(f"ell_spmv: unknown op {op!r}")
    if x.dtype != torch.float32:
        raise ValueError(f"ell_spmv: the kernel takes float32 x, got "
                         f"{x.dtype}")
    out, launched = superstep_ops.launch(
        nbr, mask, w, x, message=_PROGRAM[op], op=op, fill=_IDENTITY[op],
        caller="ell_spmv")
    if launched:
        with _COUNT_LOCK:
            KERNEL_LAUNCHES += 1
    return out


def ell_spmv_ref(nbr, mask, w, x, op: str = "sum"):
    """The plain version under the kernel's signature."""
    return ell_combine_ref(nbr, mask, w, x, op=op)
