"""Plain PyTorch version of the ELL gather + combine.

    y[v] = reduce_k{ op }( mask[v,k] ? f(w[v,k], x[nbr[v,k]]) : id )

``f`` multiplies for 'sum' (weighted SpMV) and passes ``x`` through for
'min'/'max' (label propagation; weights ignored), with ``id`` 0 and
``±inf``.  The wrapper (``ops.ell_spmv``) runs this for tensors on the
CPU; ``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

import torch

_IDENTITY = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}


def ell_combine_plain(nbr, mask, w, x, op: str = "sum"):
    """nbr: [V, K] int32 (invalid slots may hold any index; mask guards);
    x: [Vx] gather source.  Returns [V] in x's dtype."""
    if op not in _IDENTITY:
        raise ValueError(f"unknown op {op!r}")
    vals = x[nbr.clamp(0, x.shape[0] - 1).long()]            # [V, K]
    ident = torch.tensor(_IDENTITY[op], dtype=vals.dtype, device=vals.device)
    if op == "sum":
        return torch.where(mask, vals * w, ident).sum(dim=1)
    contrib = torch.where(mask, vals, ident)
    if contrib.shape[1] == 0:          # no slots: every row is the identity
        return ident.expand(contrib.shape[0]).clone()
    return contrib.amin(dim=1) if op == "min" else contrib.amax(dim=1)


#: the reference's name for the same function
ell_combine_ref = ell_combine_plain
