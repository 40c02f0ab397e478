"""PageRank on the BSP engine.

The paper's recommendation teams run PageRank on the user-follow graph;
the legacy Scalding implementation takes >11 hours per iteration.  Here a
whole run (power iterations + dangling-mass redistribution + convergence
check) runs on the device, with the halt read on the host once per
superstep.

Formulation (matches ``networkx.pagerank`` so tests can cross-check):

    x' = (1-a)/V + a * (A_norm^T x + dangling_mass / V)

with ``A_norm[u, v] = w(u, v) / outdeg(u)`` and
``dangling_mass = sum_{outdeg(u)=0} x[u]``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.core import planner as P
from repro_torch.core import registry as R
from repro_torch.core.partition import ShardedCOO, partition
from repro_torch.core.pregel import PregelSpec, run_pregel
from repro_torch.kernels.pregel_superstep.ops import msg_src_times_w


def _normalize(g: G.GraphCOO) -> tuple[G.GraphCOO, torch.Tensor]:
    """Fold 1/outdeg into edge weights; return the graph + dangling mask."""
    outdeg = G.out_degrees(g)
    dangling = (outdeg == 0).to(torch.float32)
    inv = torch.where(outdeg > 0, 1.0 / torch.clamp_min(outdeg, 1.0), 0.0)
    src_c = g.src.clamp(0, g.n_vertices - 1).long()
    w_norm = g.w * inv[src_c]
    return G.GraphCOO(g.src, g.dst, w_norm, g.n_vertices, g.n_edges), \
        dangling


def _normalize_and_partition(
    g: G.GraphCOO, n_data: int, n_model: int, device=None,
) -> tuple[ShardedCOO, torch.Tensor]:
    """Fold 1/outdeg into edge weights; return sharded edges + dangling mask."""
    g_norm, dangling = _normalize(g)
    sharded = partition(g_norm, n_data, n_model, device=device)
    return sharded, dangling.to(sharded.src.device)


def pagerank(
    g: G.GraphCOO,
    alpha: float = 0.85,
    tol: float = 1e-8,
    max_iters: int = 100,
    mesh=None,
    n_data: int = 1,
    n_model: int = 1,
    sharded: Optional[ShardedCOO] = None,
    dangling: Optional[torch.Tensor] = None,
    init: Optional[torch.Tensor] = None,
):
    """Returns (ranks [V] summing to 1, iterations_run).

    ``init`` optionally replaces the uniform starting vector — the
    warm-start seam.  Power iteration contracts to the same fixpoint from
    any probability vector, so a warm start changes iterations, never
    the converged ranks beyond ``tol``."""
    if sharded is None:
        sharded, dangling = _normalize_and_partition(g, n_data, n_model)
    V = g.n_vertices
    n_model_eff = sharded.n_model
    dev = sharded.src.device

    # Vertex state layout: dangling flag rides along per owned vertex.
    if n_model_eff > 1:
        d_pad = torch.zeros(sharded.n_pad, dtype=torch.float32, device=dev)
        d_pad[:V] = dangling
    else:
        d_pad = dangling

    def global_value(x, ids, valid):
        # dangling mass owned by this vertex shard
        d = d_pad[ids.long()] if n_model_eff > 1 else d_pad
        return torch.where(valid, x * d, 0.0).sum()

    def apply(x, agg, ids, dangling_mass):
        return (1.0 - alpha) / V + alpha * (agg + dangling_mass / V)

    def halt(old, new, valid):
        # per-shard L1 budget; exact when vertices are replicated
        budget = tol * V / n_model_eff
        return torch.where(valid, (new - old).abs(), 0.0).sum() < budget

    spec = PregelSpec(
        message=msg_src_times_w, combine="sum", apply=apply, identity=0.0,
        halt=halt, global_value=global_value,
    )
    if init is None:
        init = torch.full((sharded.n_pad,) if n_model_eff > 1 else (V,),
                          1.0 / V, dtype=torch.float32, device=dev)
    state, iters = run_pregel(spec, sharded, init, max_iters, mesh=mesh)
    return state[:V], iters


# ------------------------------------------------------------ registration

def _normalized(eng):
    """The 1/outdeg-normalized partition: derived state both engines
    cache across queries."""
    key = "pagerank/normalized"
    if key not in eng.cache:
        g_norm, dangling = _normalize(eng.coo)
        eng.cache[key] = (eng.partition_of(g_norm), dangling)
    return eng.cache[key]


def _engine_run(eng, alpha, tol, max_iters):
    sharded, dangling = _normalized(eng)
    return pagerank(eng.coo, alpha=alpha, tol=tol, max_iters=max_iters,
                    mesh=eng.mesh, sharded=sharded, dangling=dangling)


def _warm_start(eng, params, seed):
    """Restart the power iteration from an ancestor snapshot's converged
    ranks: resize to this graph's V (new vertices get the uniform
    prior), renormalize to a probability vector, and run the standard
    iteration.  The contraction mapping lands on the same ranks within
    ``tol`` — only the iteration count shrinks.  Declines (``None``) on
    a malformed seed, falling back to the cold run."""
    prev = G.to_numpy(getattr(seed, "value", seed))
    V = eng.coo.n_vertices
    if prev.ndim != 1 or prev.size == 0 or V == 0 \
            or prev.dtype.kind != "f":
        return None
    x = np.full(V, 1.0 / V, dtype=np.float64)
    n = min(prev.shape[0], V)
    x[:n] = prev[:n]
    total = float(x.sum())
    if not np.isfinite(total) or total <= 0.0:
        return None
    x = (x / total).astype(np.float32)
    sharded, dangling = _normalized(eng)
    init = torch.zeros(sharded.n_pad if sharded.n_model > 1 else V,
                       dtype=torch.float32, device=eng.device)
    init[:V] = torch.from_numpy(x)
    ranks, iters = pagerank(
        eng.coo, alpha=params["alpha"], tol=params["tol"],
        max_iters=params["max_iters"], mesh=eng.mesh,
        sharded=sharded, dangling=dangling, init=init)
    return ranks, int(iters)


def _cost(g: P.GraphStats, params: dict, count_only: bool) -> P.QuerySpec:
    # power iteration typically converges well before the cap
    iters = min(40, params.get("max_iters") or 40)
    return P.QuerySpec("pagerank", 1 if count_only else g.n_vertices,
                       iterations=iters)


R.register(R.AlgorithmDef(
    name="pagerank",
    run=_engine_run,
    params=(
        R.Param("alpha", 0.85, check=lambda a: 0.0 < a < 1.0),
        R.Param("tol", 1e-8, check=lambda t: t > 0.0),
        R.Param("max_iters", 100, check=lambda n: n >= 1, normalize=int),
    ),
    cost=_cost,
    example_params={"max_iters": 20},
    warm_start=_warm_start,
    doc="Power-iteration PageRank with dangling-mass redistribution.",
))


def pagerank_reference(src, dst, n_vertices, alpha=0.85, tol=1e-8, max_iters=100):
    """Pure-numpy oracle (same formulation) for tests."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    V = n_vertices
    outdeg = np.bincount(src, minlength=V).astype(np.float64)
    x = np.full(V, 1.0 / V)
    for it in range(max_iters):
        contrib = np.where(outdeg[src] > 0, x[src] / np.maximum(outdeg[src], 1), 0.0)
        agg = np.bincount(dst, weights=contrib, minlength=V)
        dm = x[outdeg == 0].sum()
        new = (1 - alpha) / V + alpha * (agg + dm / V)
        if np.abs(new - x).sum() < tol * V:
            return new, it + 1
        x = new
    return x, max_iters
