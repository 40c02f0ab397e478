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
