"""Degree statistics — the cheapest library call, and the planner's input."""
from __future__ import annotations

import torch

from repro_torch.core import graph as G
from repro_torch.core import planner as P
from repro_torch.core import registry as R


def degree_stats(g: G.GraphCOO) -> dict:
    """Host-side summary used by the planner and the ETL reports."""
    outd = G.out_degrees(g)
    ind = G.in_degrees(g)
    return {
        "n_vertices": g.n_vertices,
        "n_edges": g.n_edges,
        "max_out_degree": int(torch.max(outd)),
        "max_in_degree": int(torch.max(ind)),
        "mean_degree": float(g.n_edges / max(g.n_vertices, 1)),
        "dangling": int(torch.sum(outd == 0)),
    }


# ------------------------------------------------------------ registration

R.register(R.AlgorithmDef(
    name="degree_stats",
    run=lambda eng: (degree_stats(eng.coo), None),
    cost=lambda g, params, count_only: P.QuerySpec(
        "degree_stats", 1, iterations=1),
    doc="Host-side degree summary (also the planner's input).",
))


def degree_histogram(g: G.GraphCOO, n_bins: int = 64) -> torch.Tensor:
    """log2-bucketed in-degree histogram (power-law diagnostics for ETL);
    int32 counts, as the reference's."""
    ind = G.in_degrees(g)
    b = torch.clamp(torch.ceil(torch.log2(torch.clamp(ind, min=1.0))),
                    0, n_bins - 1)
    return torch.bincount(b.to(torch.int64),
                          minlength=n_bins).to(torch.int32)
