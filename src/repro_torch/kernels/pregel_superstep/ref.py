"""Plain PyTorch version of the fused Pregel superstep.

One superstep over the in-neighbor ELL layout, under the signature the
CUDA kernel implements:

    agg[v] = reduce_k( op, mask[v,k] ? message(x[nbr[v,k]], w[v,k])
                                     : fill )

where ``fill`` is the monoid identity for min/max and 0 for sum —
matching the dense path's segment-combine semantics (segment-sum drops
padded edges outright, so vertices with no message aggregate to 0
regardless of the declared identity; empty min/max segments are
normalized to the identity).

``message`` must be elementwise in ``(src_state, w)`` and
shape-polymorphic (called on ``[V, K]`` gathered tiles here and on
``[E]`` edge vectors by the dense path).  Trailing state dims are
supported (messages ``[V, K, ...]`` reduce over axis 1): state ``[Vx,
B]`` with a message lifted by ``core.pregel.batched_spec`` is the fused
batch of B queries.

The wrapper (``ops.fused_superstep``) runs this for tensors on the CPU,
``[Vx]`` and ``[Vx, B]`` state alike; ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold both CUDA entries (``pregel_superstep``
and ``pregel_superstep_batched``) against it on the card.

``csr_superstep_plain`` is the plain version of the third entry
(``pregel_superstep_csr``): the same superstep over the destination-sorted
edge list read as a CSR, which is the dense path's gather, message and
segment-combine.
"""
from __future__ import annotations

import torch


def fill_value(op: str, identity):
    return 0 if op == "sum" else identity


def as_dtype(dtype) -> torch.dtype:
    """A dtype given by name (``"bfloat16"``) or as a ``torch.dtype``."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def superstep_plain(nbr, mask, w, x, *, message, op: str, identity,
                    message_dtype=None):
    """agg[v] = reduce_k over masked message(x[nbr[v,k]], w[v,k]).

    nbr : [V, K] int32 (sentinel/invalid slots guarded by mask)
    x   : [Vx] or [Vx, ...] gather source (vertex state)
    Returns [V] or [V, ...] aggregates in the message dtype (cast to
    ``message_dtype`` first when set — the reduced-precision channel).
    """
    vals = x[nbr.clamp(0, x.shape[0] - 1).long()]
    msgs = message(vals, w)
    if message_dtype is not None:
        msgs = msgs.to(as_dtype(message_dtype))
    m = mask != 0
    if msgs.dim() > m.dim():
        m = m.reshape(tuple(m.shape) + (1,) * (msgs.dim() - m.dim()))
    fill = torch.tensor(fill_value(op, identity), dtype=msgs.dtype,
                        device=msgs.device)
    contrib = torch.where(m, msgs, fill)
    if contrib.shape[1] == 0:          # no slots: every row is the fill
        return fill.expand((contrib.shape[0],)
                           + tuple(contrib.shape[2:])).clone()
    if op == "sum":
        return contrib.sum(dim=1, dtype=msgs.dtype)
    if op == "min":
        return contrib.amin(dim=1)
    if op == "max":
        return contrib.amax(dim=1)
    raise ValueError(f"unknown op {op!r}")


def csr_superstep_plain(rowptr, src, w, x, *, message, op: str, identity):
    """agg[v] = reduce over the in-edges e of v (``rowptr[v] <= e <
    rowptr[v + 1]``) of message(x[src[e]], w[e]); ``identity`` where v has
    none.  min/max only; edges past ``rowptr[V]`` (padding) are not read.

    rowptr : [V + 1] int32 row offsets of the destination-sorted edges
    src, w : [n] int32 source ids and float32 weights, n >= rowptr[V]
    x      : [Vx] gather source (ids clamped into [0, Vx))
    """
    if op not in ("min", "max"):
        raise ValueError(f"csr_superstep_plain: op must be min or max, "
                         f"got {op!r}")
    V = rowptr.shape[0] - 1
    nnz = int(rowptr[-1])
    seg = torch.repeat_interleave(
        torch.arange(V, device=rowptr.device), rowptr.diff().long(),
        output_size=nnz)
    msgs = message(x[src[:nnz].clamp(0, x.shape[0] - 1).long()], w[:nnz])
    out = torch.full((V,), identity, dtype=msgs.dtype, device=msgs.device)
    return out.scatter_reduce_(0, seg, msgs, reduce="a" + op,
                               include_self=False)
