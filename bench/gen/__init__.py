"""Graph generators of the benchmark's configurations.

Each module here has ``generate(cfg, seed, device) -> EdgeList``: the
configuration's graph for the run's ``seed``, made on ``device`` in a
few large calls.  Every generator ends in :func:`simple_pairs`, so the graph is
simple and undirected: no self-loops, no duplicate pairs, one weight per
pair for both directions.  No answer then depends on which duplicate a
side keeps.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class EdgeList:
    """Undirected pairs ``lo < hi`` (int64) and one float32 weight each,
    over ``n_vertices`` vertices.  ``order``, where the generator fixes
    it, is every vertex in the order the traffic draws its roots from;
    otherwise the traffic draws that order from the run's seed."""

    lo: torch.Tensor
    hi: torch.Tensor
    w: torch.Tensor
    n_vertices: int
    order: Optional[torch.Tensor] = None

    @property
    def n_pairs(self) -> int:
        return int(self.lo.numel())

    def degrees(self) -> torch.Tensor:
        n = self.n_vertices
        return (torch.bincount(self.lo, minlength=n)
                + torch.bincount(self.hi, minlength=n))

    def to(self, device) -> "EdgeList":
        return EdgeList(self.lo.to(device), self.hi.to(device),
                        self.w.to(device), self.n_vertices,
                        None if self.order is None
                        else self.order.to(device))


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named random stream of a run: runs with the
    same ``seed`` draw the same numbers, and streams do not overlap."""
    tag = int.from_bytes(stream.encode(), "little")
    return int(np.random.SeedSequence([int(seed), tag])
               .generate_state(1, np.uint64)[0]) >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def simple_pairs(a: torch.Tensor, b: torch.Tensor, n: int,
                 w_low: float, w_high: float,
                 g: torch.Generator) -> EdgeList:
    """Drop self-loops and duplicate pairs of the edges ``(a, b)``, then
    draw one weight in ``[w_low, w_high)`` for each pair left."""
    keep = a != b
    a, b = a[keep], b[keep]
    key = torch.unique(torch.minimum(a, b) * n + torch.maximum(a, b))
    u = torch.rand(key.numel(), generator=g, device=key.device)
    w = (w_low + (w_high - w_low) * u).to(torch.float32)
    return EdgeList(key // n, key % n, w, n)
