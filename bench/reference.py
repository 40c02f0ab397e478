"""The plain reference: BFS hop distances and SSSP float32 distances.

Plain PyTorch over the benchmark's own undirected edge list, in
synchronous rounds as a Pregel superstep runs them: round ``r`` reads
the distances after round ``r - 1``, relaxes every edge out of a vertex
that changed in round ``r - 1`` (at first: the root) and keeps the
minimum.  After ``k`` rounds a vertex holds the least distance over
paths of at most ``k`` edges; with no bound the rounds run until nothing
changes.  A distance is the float32 sum ``d[u] + w`` along its path, so
any implementation of the same semantics gives the same bits.

The rounds also count the least bytes an answer needs (the roofline's
numerator): each edge out of a changed vertex read once, a 4-byte id and
for SSSP a 4-byte weight, and each changed distance written once.  A
bottom-up traversal could read less; such a change needs this count
revised first.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from bench.gen import EdgeList

ID_BYTES = 4
WEIGHT_BYTES = 4
VALUE_BYTES = 4


class Adjacency:
    """Both directions of every pair, grouped by source (CSR), with each
    edge's source beside it."""

    def __init__(self, edges: EdgeList, device):
        lo = edges.lo.to(device=device, dtype=torch.int64)
        hi = edges.hi.to(device=device, dtype=torch.int64)
        w = edges.w.to(device=device, dtype=torch.float32)
        src = torch.cat([lo, hi])
        order = torch.argsort(src, stable=True)
        self.src = src[order].to(torch.int32)
        self.nbr = torch.cat([hi, lo])[order]
        self.w = torch.cat([w, w])[order]
        self.n = edges.n_vertices


@dataclasses.dataclass
class Answer:
    dist: torch.Tensor        # [V] in ``dtype``, inf where unreached
    rounds: int               # rounds that relaxed at least one edge set
    least_bytes: int


def relax(adj: Adjacency, root: int, weighted: bool,
          max_rounds: Optional[int] = None,
          dtype: torch.dtype = torch.float32) -> Answer:
    """Distances from ``root``: hop counts (``weighted=False``) or sums of
    weights, after at most ``max_rounds`` synchronous rounds.  A round
    picks the edges out of the vertices that changed by a mask over every
    edge's source, so its cost is one pass over the sources plus the
    edges it relaxes."""
    dev = adj.nbr.device
    dist = torch.full((adj.n,), float("inf"), dtype=dtype, device=dev)
    dist[root] = 0
    changed = torch.zeros(adj.n, dtype=torch.bool, device=dev)
    changed[root] = True
    per_edge = ID_BYTES + (WEIGHT_BYTES if weighted else 0)
    rounds = least = 0
    n_changed = 1
    while n_changed and (max_rounds is None or rounds < max_rounds):
        idx = torch.nonzero(changed.index_select(0, adj.src)).flatten()
        src = adj.src.index_select(0, idx)
        step = adj.w.index_select(0, idx).to(dtype) if weighted \
            else torch.ones((), dtype=dtype, device=dev)
        cand = dist.index_select(0, src) + step
        new = dist.scatter_reduce(0, adj.nbr.index_select(0, idx), cand,
                                  reduce="amin", include_self=True)
        changed = new < dist
        n_changed = int(changed.sum())
        least += idx.numel() * per_edge + n_changed * VALUE_BYTES
        dist = new
        rounds += 1
    return Answer(dist, rounds, least)
