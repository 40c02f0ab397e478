"""HITS hub/authority scores (Kleinberg) — the registry's one-file
extension example.

This module is the proof of the platform's extension contract: adding
it registers a new algorithm that both engines run, the planner prices
and ``GraphQuery.of("hits", ...)`` serves — with **zero edits** to
``engines.py``, ``planner.py`` or ``query.py`` (``registry.ensure_loaded``
auto-discovers it).

Formulation.  HITS iterates

    authority[v] <- sum_{(u, v) in E} hub[u]
    hub[u]       <- sum_{(u, v) in E} authority[v]

to the principal eigenvectors of ``A^T A`` / ``A A^T``.  The BSP engine
aggregates along *in*-edges only, so we run the iteration on the
**doubled role graph**: 2V vertices where vertex ``u`` is u's hub role
and vertex ``V + v`` is v's authority role, and every directed edge
``(u, v)`` becomes

    u     -> V + v      (hubs feed authorities)
    V + v -> u          (authorities feed hubs)

One superstep on this graph performs one simultaneous HITS update for
both score vectors.  The per-half L2 renormalization runs *inside* the
superstep: ``global_value`` (computed over the **new** aggregate —
``global_over_agg``) reduces the fresh hub/authority sums to their
squared norms, and ``apply`` divides each half by its own norm.  The
whole iteration — update, normalize, convergence test — is one
``run_pregel`` call like every other fixpoint algorithm here.  Scores
are returned L2-normalized.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.core import planner as P
from repro_torch.core import registry as R
from repro_torch.core.partition import ShardedCOO, partition
from repro_torch.core.pregel import PregelSpec, run_pregel
from repro_torch.kernels.pregel_superstep.ops import msg_src_times_w


# bounded: a rolling catalog of snapshot sizes must not accrete specs
# without limit
@lru_cache(maxsize=64)
def _hits_spec(n_vertices: int, tol: float) -> PregelSpec:
    """One simultaneous (hub, authority) update with in-loop per-half
    L2 normalization; converged when no score moved by ``tol``."""
    V = n_vertices

    def global_value(agg, ids, valid):
        # squared L2 norm of each half of the *new* aggregate
        sq = torch.where(valid, agg * agg, 0.0)
        is_hub = ids < V
        return torch.stack([torch.where(is_hub, sq, 0.0).sum(),
                            torch.where(is_hub, 0.0, sq).sum()])

    def apply(old, agg, ids, gval):
        hub_norm = torch.clamp_min(torch.sqrt(gval[0]), 1e-12)
        auth_norm = torch.clamp_min(torch.sqrt(gval[1]), 1e-12)
        return torch.where(ids < V, agg / hub_norm, agg / auth_norm)

    def halt(old, new, valid):
        return torch.all(torch.where(valid, torch.abs(new - old), 0.0) < tol)

    return PregelSpec(
        message=msg_src_times_w,
        combine="sum",
        apply=apply,
        identity=0.0,
        halt=halt,
        global_value=global_value,
        global_over_agg=True,
    )


def role_graph(g: G.GraphCOO) -> G.GraphCOO:
    """The 2V-vertex doubled graph: (u, v) -> u→(V+v) and (V+v)→u, on
    ``g``'s device."""
    V = g.n_vertices
    src = G.to_numpy(g.src)[: g.n_edges]
    dst = G.to_numpy(g.dst)[: g.n_edges]
    w = G.to_numpy(g.w)[: g.n_edges]
    return G.build_coo(
        np.concatenate([src, dst + V]), np.concatenate([dst + V, src]),
        2 * V, w=np.concatenate([w, w]), dedup=False, device=g.device)


def _role_init(n_pad: int, V: int, device) -> torch.Tensor:
    init = torch.zeros(n_pad, dtype=torch.float32, device=device)
    init[: 2 * V] = 1.0 / np.sqrt(max(V, 1))
    return init


def hits(
    g: G.GraphCOO,
    max_iters: int = 50,
    tol: float = 1e-6,
    mesh=None,
    n_data: int = 1,
    n_model: int = 1,
    sharded: Optional[ShardedCOO] = None,
):
    """Returns ``({'hubs': [V], 'authorities': [V]}, iterations)`` with
    each score vector L2-normalized (all-zero when the graph has no
    edges feeding that role).  The whole iteration — including the
    per-half renormalization and the ``tol`` convergence test — is one
    ``run_pregel`` call."""
    V = g.n_vertices
    if sharded is None:
        sharded = partition(role_graph(g), n_data, n_model)
    init = _role_init(sharded.n_pad, V, sharded.src.device)
    state, iters = run_pregel(_hits_spec(V, float(tol)), sharded, init,
                              max_iters, mesh=mesh)
    return {"hubs": state[:V], "authorities": state[V: 2 * V]}, int(iters)


def hits_reference(src, dst, n_vertices: int, max_iters: int = 50,
                   tol: float = 1e-6):
    """Numpy oracle mirroring the device schedule exactly (simultaneous
    updates, per-superstep renormalization, per-superstep tol check), in
    float64.  The reference's oracle multiplies by a dense 0/1 ``V x V``
    matrix; this one multiplies by the same matrix stored sparse (its
    distinct ``(src, dst)`` pairs, products by ``np.bincount``), so it
    also serves graphs of millions of vertices."""
    V = n_vertices
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    key = np.unique(src * max(V, 1) + dst)
    s, d = key // max(V, 1), key % max(V, 1)

    def unit(x):
        return x / max(np.linalg.norm(x), 1e-12)

    h = np.full(V, 1.0 / np.sqrt(max(V, 1)))
    a = np.full(V, 1.0 / np.sqrt(max(V, 1)))
    iters = 0
    while iters < max_iters:
        nh = unit(np.bincount(s, weights=a[d], minlength=V))   # A a
        na = unit(np.bincount(d, weights=h[s], minlength=V))   # A^T h
        iters += 1
        converged = (np.max(np.abs(nh - h), initial=0.0) < tol
                     and np.max(np.abs(na - a), initial=0.0) < tol)
        h, a = nh, na
        if converged:
            break
    return {"hubs": h.astype(np.float32),
            "authorities": a.astype(np.float32)}, iters


# ------------------------------------------------------------ registration

def _role_shards(eng) -> ShardedCOO:
    """The doubled role graph's shards: derived state, packed once per
    engine and reused across queries."""
    key = "hits/sharded"
    if key not in eng.cache:
        eng.cache[key] = eng.partition_of(role_graph(eng.coo))
    return eng.cache[key]


def _engine_run(eng, max_iters, tol):
    return hits(eng.coo, max_iters=max_iters, tol=tol, mesh=eng.mesh,
                sharded=_role_shards(eng))


def _warm_start(eng, params, seed):
    """Restart the power iteration from an ancestor snapshot's converged
    hub/authority vectors, packed into the doubled role-graph layout.
    The iteration converges to the principal eigenvectors from any
    positive start, so the answer matches the cold run within ``tol``
    with fewer iterations.  Declines on a malformed or degenerate seed
    (a near-zero half would pin the iteration at zero)."""
    val = getattr(seed, "value", seed)
    if not isinstance(val, dict) \
            or "hubs" not in val or "authorities" not in val:
        return None
    V = eng.coo.n_vertices
    h = G.to_numpy(val["hubs"]).astype(np.float32)
    a = G.to_numpy(val["authorities"]).astype(np.float32)
    if h.ndim != 1 or a.ndim != 1 or V == 0:
        return None
    sharded = _role_shards(eng)
    base = np.float32(1.0 / np.sqrt(max(V, 1)))
    init = np.zeros(sharded.n_pad, dtype=np.float32)
    init[: 2 * V] = base                  # new vertices: uniform prior
    n_h, n_a = min(h.shape[0], V), min(a.shape[0], V)
    init[:n_h] = h[:n_h]
    init[V: V + n_a] = a[:n_a]
    if (np.linalg.norm(init[:V]) < 1e-6
            or np.linalg.norm(init[V: 2 * V]) < 1e-6
            or not np.isfinite(init).all()):
        return None
    state, iters = run_pregel(
        _hits_spec(V, float(params["tol"])), sharded,
        torch.from_numpy(init).to(sharded.src.device),
        params["max_iters"], mesh=eng.mesh)
    return ({"hubs": state[:V], "authorities": state[V: 2 * V]},
            int(iters))


def _cost(g: P.GraphStats, params: dict, count_only: bool) -> P.QuerySpec:
    # power iteration on the doubled edge set; two tables out
    iters = min(30, params.get("max_iters") or 30)
    return P.QuerySpec("hits", 1 if count_only else 2 * g.n_vertices,
                       iterations=iters, state_bytes_per_vertex=8.0,
                       edge_bytes_factor=2.0)


R.register(R.AlgorithmDef(
    name="hits",
    run=_engine_run,
    params=(
        R.Param("max_iters", 50, check=lambda n: n >= 1, normalize=int),
        R.Param("tol", 1e-6, check=lambda t: t > 0.0, normalize=float),
    ),
    cost=_cost,
    example_params={},
    warm_start=_warm_start,
    doc="HITS hub/authority scores via the doubled role graph.",
))
