"""Plain PyTorch version of the sorted-row intersection kernel.

Rows are sorted ascending with the sentinel padding value greater than
every valid id, so membership of each element of ``b`` in ``a`` is one
``searchsorted`` probe: the merge-intersection of two sorted neighbor
lists in O(K log K).  Rows must be duplicate-free (the
``build_oriented_ell`` invariant) or matches would be over-counted.

The wrapper (``ops``) runs this for tensors on the CPU; ``chip_smoke.py``
holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch


def ell_intersect_plain(a: torch.Tensor, b: torch.Tensor,
                        sentinel: int) -> torch.Tensor:
    """counts[i] = |a[i] ∩ b[i]| over sorted, deduped, sentinel-padded
    rows.

    a, b: [E, K] int32, each row ascending; invalid slots == sentinel.
    Returns [E] int32 intersection sizes (sentinel slots never match).
    """
    e, k = a.shape
    if k == 0:
        return torch.zeros(e, dtype=torch.int32, device=a.device)
    a, b = a.contiguous(), b.contiguous()
    idx = torch.searchsorted(a, b).clamp_(0, k - 1)
    hit = (torch.gather(a, 1, idx) == b) & (b != sentinel)
    return hit.sum(dim=1, dtype=torch.int32)


def ell_intersect_counts_plain(oriented,
                               chunk_edges: int = 1 << 18) -> torch.Tensor:
    """Per-oriented-edge counts ``|nbr[eu[e]] ∩ nbr[ev[e]]|`` for a whole
    ``OrientedELL``, as int32 on its device, length ``n_edges``.

    The two rows of each edge are gathered chunk by chunk, bounding the
    temporaries to a few ``[chunk_edges, K]`` tensors whatever E is.
    Edge endpoints are clamped into ``[0, V]`` as the kernel clamps them;
    padding edges gather the all-sentinel row ``V`` and count 0.
    """
    nbr = oriented.nbr
    rows = nbr.shape[0]
    n = int(oriented.eu.shape[0])
    out = torch.empty(n, dtype=torch.int32, device=nbr.device)
    for lo in range(0, n, chunk_edges):
        hi = min(lo + chunk_edges, n)
        eu = oriented.eu[lo:hi].clamp(0, rows - 1).long()
        ev = oriented.ev[lo:hi].clamp(0, rows - 1).long()
        out[lo:hi] = ell_intersect_plain(nbr[eu], nbr[ev],
                                         oriented.n_vertices)
    return out[: oriented.n_edges]
