"""Identifier edge sets: the combined-connected-users input, on the device.

One user-user edge set per identifier type: each of ``n_users *
links_per_user_per_type`` links joins a user drawn uniformly to the user
a geometric offset (``offset_p``) further on, so users that share an
identifier sit close in id order (bounded degree, local ids).  The same
shape as ``repro_torch.data.synthetic.identifier_edge_sets``, drawn with
torch on the device instead of numpy on the host.
"""
from __future__ import annotations

import torch

from bench.gen import EdgeList, generator, simple_pairs


def generate(cfg: dict, seed: int, device) -> EdgeList:
    n = int(cfg["n_users"])
    m = int(round(float(cfg["links_per_user_per_type"]) * n))
    types = int(cfg["identifier_types"])
    g = generator(seed, "graph", device)
    src = torch.randint(0, n, (types * m,), generator=g, device=device)
    off = torch.empty(types * m, device=device).geometric_(
        float(cfg["offset_p"]), generator=g).to(torch.int64)
    return simple_pairs(src, (src + off) % n, n, float(cfg["weight_low"]),
                        float(cfg["weight_high"]), g)
