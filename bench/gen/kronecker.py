"""The Graph 500 Kronecker generator, on the device.

As the specification's reference code: ``edgefactor * 2^scale`` edges,
each placed by ``scale`` independent quadrant choices with probabilities
A, B, C and D = 1 - A - B - C; then the vertex labels are permuted at
random.  The weights are drawn per undirected pair (the specification
draws them per generated edge; after duplicates are dropped each pair
keeps one).

The edges, their weights and the order in which the traffic draws its
roots come from the configuration's ``structure_seed``; the label
permutation comes from the run's seed.  Every seed then serves the same
graph and the same queries under other labels: the same work in another
order.  Drawn anew for each seed, the graphs and the roots moved a
query's mean time by 3-7 % from seed to seed on an H100, which the open
loop's queue at three quarters of its capacity magnified about five
times in its tail.
"""
from __future__ import annotations

import torch

from bench.gen import EdgeList, generator, simple_pairs


def generate(cfg: dict, seed: int, device) -> EdgeList:
    scale = int(cfg["scale"])
    n = 1 << scale
    m = int(cfg["edgefactor"]) * n
    a, b, c = float(cfg["A"]), float(cfg["B"]), float(cfg["C"])
    g = generator(int(cfg["structure_seed"]), "graph", device)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    i = torch.zeros(m, dtype=torch.int64, device=device)
    j = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        i_bit = torch.rand(m, generator=g, device=device) > ab
        j_bit = torch.rand(m, generator=g, device=device) > torch.where(
            i_bit, c_norm, a_norm)
        i |= i_bit.to(torch.int64) << bit
        j |= j_bit.to(torch.int64) << bit
    e = simple_pairs(i, j, n, float(cfg["weight_low"]),
                     float(cfg["weight_high"]), g)
    order = torch.randperm(n, generator=g, device=device)
    perm = torch.randperm(n, generator=generator(seed, "labels", device),
                          device=device)
    lo, hi = perm[e.lo], perm[e.hi]
    return EdgeList(torch.minimum(lo, hi), torch.maximum(lo, hi), e.w, n,
                    order=perm[order])
