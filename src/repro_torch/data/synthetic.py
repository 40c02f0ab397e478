"""Shape-faithful synthetic graph generators.

The paper's production graphs cannot leave Twitter; we generate graphs
with the same *structure* at configurable scale:

* ``user_follow_graph``      — directed power-law (small-world) graph,
  the PageRank workload (paper: millions of vertices, billions of edges).
* ``safety_bipartite_graph`` — heterogeneous user<->identifier graph for
  multi-account detection (paper: 14.89B vertices / 30.86B edges across 4
  daily snapshots; identifier degrees heavy-tailed, which is exactly why
  the legacy job needed MaxAdjacentNodes).
* ``identifier_edge_sets``   — the combined-connected-users inputs: one
  edge set per identifier type (paper: 2 daily snapshots, 2.41B vertices
  / 1.50B edges).

All generators are numpy + seeded (deterministic tests/benchmarks).
"""
from __future__ import annotations

import numpy as np


def _power_law_degrees(n: int, rng, alpha: float = 2.1, d_min: int = 1,
                       d_max: int | None = None) -> np.ndarray:
    """Zipf-ish degree sequence (discrete Pareto), clipped."""
    d_max = d_max or max(4, n // 4)
    u = rng.random(n)
    deg = np.floor(d_min * (1 - u) ** (-1.0 / (alpha - 1.0))).astype(np.int64)
    return np.clip(deg, d_min, d_max)


def user_follow_graph(n_users: int, mean_degree: float = 8.0,
                      seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Directed power-law graph via a Chung-Lu style sampler.

    Returns (src, dst) int64 arrays; may contain a few duplicate edges
    (dedup'd at build_coo, as the ETL does).
    """
    rng = np.random.default_rng(seed)
    n_edges = int(n_users * mean_degree)
    out_w = _power_law_degrees(n_users, rng).astype(np.float64)
    in_w = _power_law_degrees(n_users, rng).astype(np.float64)
    src = rng.choice(n_users, size=n_edges, p=out_w / out_w.sum())
    dst = rng.choice(n_users, size=n_edges, p=in_w / in_w.sum())
    keep = src != dst
    return src[keep].astype(np.int64), dst[keep].astype(np.int64)


def safety_bipartite_graph(n_users: int, n_identifiers: int,
                           mean_ids_per_user: float = 2.0,
                           hub_fraction: float = 0.001,
                           hub_degree: int = 500,
                           seed: int = 0):
    """(user, identifier) edges with heavy-tailed identifier degrees.

    ``hub_fraction`` of identifiers are shared by ~``hub_degree`` users
    (the paper's motivation for the MaxAdjacentNodes cap: a few emails /
    phones connect huge numbers of accounts).
    Returns (user_ids, identifier_ids).
    """
    rng = np.random.default_rng(seed)
    n_edges = int(n_users * mean_ids_per_user)
    users = rng.integers(0, n_users, size=n_edges)
    id_w = _power_law_degrees(n_identifiers, rng, alpha=2.0).astype(np.float64)
    n_hubs = max(1, int(n_identifiers * hub_fraction))
    id_w[:n_hubs] = hub_degree
    ids = rng.choice(n_identifiers, size=n_edges, p=id_w / id_w.sum())
    # dedup (user, id) pairs — a user registers an identifier once
    key = users * np.int64(n_identifiers) + ids
    _, keep = np.unique(key, return_index=True)
    return users[keep].astype(np.int64), ids[keep].astype(np.int64)


def identifier_edge_sets(n_users: int, n_sets: int = 4,
                         mean_degree: float = 1.5, seed: int = 0):
    """One (src,dst) user-user edge set per identifier type — the
    combined-connected-users input.  Edges inside a set link users that
    share an identifier of that type."""
    rng = np.random.default_rng(seed)
    sets = []
    for t in range(n_sets):
        n_edges = int(n_users * mean_degree)
        src = rng.integers(0, n_users, size=n_edges)
        # preferential attachment to small offsets -> chains + clusters
        off = rng.geometric(p=0.3, size=n_edges)
        dst = (src + off) % n_users
        sets.append((src.astype(np.int64), dst.astype(np.int64)))
    return sets


def rmat_graph(scale: int, edge_factor: int = 8, seed: int = 0,
               a=0.57, b=0.19, c=0.19):
    """Graph500-style R-MAT: 2^scale vertices, edge_factor*2^scale edges."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor * n
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        r = rng.random(m)
        s_bit = (r >= a + b) & (r < a + b + c) | (r >= a + b + c)
        d_bit = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        src |= s_bit.astype(np.int64) << bit
        dst |= d_bit.astype(np.int64) << bit
    keep = src != dst
    return src[keep], dst[keep], n
