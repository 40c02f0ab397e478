"""Traversal workloads: BFS hop distance and weighted SSSP.

Both are one ``PregelSpec`` over the min-monoid — the relaxation

    dist[v] <- min(dist[v], min_{(u,v) in E} dist[u] + cost(u, v))

with ``cost = 1`` (BFS) or ``cost = w`` (SSSP, Bellman-Ford).  The
count-only fast path (``reachable_count``) returns the size of the
reachable set without materializing the distance table — the query
class where the paper's local engine wins by orders of magnitude
(Fig. 5).

Distances are float32 with ``inf`` for unreachable vertices.  Edge
weights must be non-negative for SSSP (Bellman-Ford converges in at most
V-1 supersteps; the ``halt`` fixpoint check stops far earlier on
small-diameter social graphs).

Compatible BFS or SSSP queries also run *fused*: B source sets as one
``[V, B]`` program (``batched_spec``), each column bit-identical to its
query run alone; on the card the fused variant of that program runs the
kernel's batched entry.
"""
from __future__ import annotations

import heapq
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.core import planner as P
from repro_torch.core import registry as R
from repro_torch.core.partition import ShardedCOO, partition
from repro_torch.core.pregel import (PregelSpec, batched_spec,
                                     converged_halt, run_pregel)
from repro_torch.kernels.pregel_superstep.ops import (msg_src_plus_one,
                                                      msg_src_plus_w)


def _relax_apply(dist, agg, ids, gval):
    return torch.minimum(dist, agg)


def _finite_frontier(dist):
    """Activity predicate: only a vertex with a finite distance can
    improve a neighbor (inf + cost == inf is a no-op under min)."""
    return torch.isfinite(dist)


# Both relaxations declare the full superstep-variant contract: the
# message is elementwise in (src_state, w) — one of the kernel's compiled
# edge programs, so the fused variant runs the CUDA kernel on the card;
# the min fold makes frontier compression *exact* ('monotone'); and min
# tolerates reduced-precision message channels by construction.
_BFS_SPEC = PregelSpec(
    message=msg_src_plus_one,
    combine="min", apply=_relax_apply, identity=float("inf"),
    halt=converged_halt, elementwise_message=True,
    frontier_mode="monotone", frontier_init=_finite_frontier)

_SSSP_SPEC = PregelSpec(
    message=msg_src_plus_w,
    combine="min", apply=_relax_apply, identity=float("inf"),
    halt=converged_halt, elementwise_message=True,
    frontier_mode="monotone", frontier_init=_finite_frontier)


def _init_distances(sources, n_pad: int, device) -> torch.Tensor:
    init = np.full(n_pad, np.inf, dtype=np.float32)
    init[np.asarray(sources, dtype=np.int64)] = 0.0
    return torch.from_numpy(init).to(device)


def _run_relaxation(spec, g: G.GraphCOO, sources, max_iters, mesh,
                    n_data, n_model, sharded: Optional[ShardedCOO]):
    if max_iters is None:
        # worst case (path graph) needs V-1 relaxation rounds; the halt
        # check exits the loop at the fixpoint, so the generous bound
        # costs nothing on small-diameter graphs
        max_iters = g.n_vertices
    if sharded is None:
        sharded = partition(g, n_data, n_model)
    init = _init_distances(sources, sharded.n_pad, sharded.src.device)
    dist, iters = run_pregel(spec, sharded, init, max_iters, mesh=mesh)
    return dist[: g.n_vertices], iters


def bfs_distances(
    g: G.GraphCOO,
    sources: Sequence[int],
    max_iters: Optional[int] = None,
    mesh=None,
    n_data: int = 1,
    n_model: int = 1,
    sharded: Optional[ShardedCOO] = None,
):
    """Hop distance from the source set along directed edges.

    Returns ``(dist [V] float32 with inf = unreachable, iters)``.
    ``max_iters=None`` (default) guarantees convergence; an explicit
    smaller bound truncates distances beyond that many hops to inf.
    """
    return _run_relaxation(_BFS_SPEC, g, sources, max_iters, mesh,
                           n_data, n_model, sharded)


def sssp(
    g: G.GraphCOO,
    source: int,
    max_iters: Optional[int] = None,
    mesh=None,
    n_data: int = 1,
    n_model: int = 1,
    sharded: Optional[ShardedCOO] = None,
):
    """Single-source weighted shortest paths (non-negative weights).
    ``max_iters=None`` (default) guarantees Bellman-Ford convergence."""
    return _run_relaxation(_SSSP_SPEC, g, [source], max_iters, mesh,
                           n_data, n_model, sharded)


def reachable_count(dist) -> int:
    """Count-only fast path: |{v : dist[v] < inf}| — never materializes
    the distance table on the host."""
    return int(torch.isfinite(dist).sum())


# ------------------------------------------------------------ registration
#
# BFS and SSSP register their PregelSpec *as* the runner: the generic
# engine drives run_pregel, and the definition only supplies the initial
# state.  This is the purest "algorithm as data" form the registry
# supports.

def _bfs_init(eng, params):
    mi = params["max_iters"]
    if mi is None:
        mi = eng.coo.n_vertices
    return _init_distances(params["sources"], eng.sharded.n_pad,
                           eng.device), mi


def _sssp_init(eng, params):
    mi = params["max_iters"]
    if mi is None:
        mi = eng.coo.n_vertices
    return _init_distances([params["source"]], eng.sharded.n_pad,
                           eng.device), mi


def _sources_tuple(s):
    return tuple(int(x) for x in np.atleast_1d(np.asarray(s)))


# Fused batch runners: B relaxations with different sources are one
# pregel program over [V, B] state (batched_spec lifts the scalar spec
# onto a trailing batch axis).  The min monoid is exact per column, so
# column b is bit-identical to running query b alone — the service's
# fusion contract.  Queries fuse only within an equal max_iters group
# (the fuse key), so the shared loop bound is every ticket's own.

def _relax_batch(spec, eng, source_sets, max_iters):
    V = eng.coo.n_vertices
    mi = max_iters if max_iters is not None else V
    # built on the device: a host copy is n_pad * B * 4 bytes (512 MB at
    # 2^24 x 8)
    init = torch.full((eng.sharded.n_pad, len(source_sets)), float("inf"),
                      device=eng.device)
    for b, sources in enumerate(source_sets):
        init[torch.as_tensor(np.asarray(sources, dtype=np.int64),
                             device=eng.device), b] = 0.0
    # batched_spec propagates the superstep-variant declarations, so the
    # fused batch rides the frontier/fused path where supported — still
    # bit-identical per column (min is exact under any strategy).
    dist, iters = eng.run_superstep(batched_spec(spec), init, mi,
                                    variant="auto")
    values = [dist[:V, b] for b in range(len(source_sets))]
    return values, int(iters), {"pregel_calls": 1}


def _bfs_batch(eng, params_list):
    return _relax_batch(_BFS_SPEC, eng,
                        [p["sources"] for p in params_list],
                        params_list[0]["max_iters"])


def _sssp_batch(eng, params_list):
    return _relax_batch(_SSSP_SPEC, eng,
                        [(p["source"],) for p in params_list],
                        params_list[0]["max_iters"])


def _relax_fuse_key(params):
    return ("max_iters", params["max_iters"])


def _relax_incremental(spec, eng, sources, seed, delta):
    """Localized repair for *add-only* deltas: seed distances from the
    ancestor's converged table (old distances are path lengths still
    achievable in the new graph, hence elementwise upper bounds) and the
    frontier from the delta's touched endpoints.  The min relaxation
    from that state reaches exactly the cold fixpoint — and since every
    distance is a deterministic along-path float sum, byte-identical to
    a cold run.  Removals can lengthen distances (values would need to
    rise), so those decline; so does a run that exhausts its iteration
    budget before the halt fires (parity is only proven at the
    fixpoint)."""
    if delta is None or delta.n_removed:
        return None
    prev = G.to_numpy(getattr(seed, "value", seed))
    V = eng.coo.n_vertices
    if prev.ndim != 1 or prev.shape[0] > V or prev.dtype.kind != "f":
        return None
    mi = V
    init = np.full(eng.sharded.n_pad, np.inf, dtype=np.float32)
    init[: prev.shape[0]] = prev
    init[np.asarray(sources, dtype=np.int64)] = 0.0
    act = np.zeros(V, dtype=bool)
    touched = np.asarray(delta.touched)
    act[touched[touched < V]] = True
    dist, iters = eng.run_superstep(
        spec, torch.from_numpy(init).to(eng.device), mi, variant="auto",
        init_active=torch.from_numpy(act).to(eng.device))
    if int(iters) >= mi:
        return None
    return dist[:V], int(iters)


def _bfs_incremental(eng, params, seed, delta):
    # an explicit max_iters truncates distances beyond that many hops —
    # trajectory-dependent semantics a warm seed cannot reproduce
    if params["max_iters"] is not None:
        return None
    return _relax_incremental(_BFS_SPEC, eng, params["sources"], seed,
                              delta)


def _sssp_incremental(eng, params, seed, delta):
    if params["max_iters"] is not None:
        return None
    return _relax_incremental(_SSSP_SPEC, eng, (params["source"],), seed,
                              delta)


def _bfs_cost(g: P.GraphStats, params: dict, count_only: bool):
    # small-world graphs: effective diameter ~ a dozen supersteps
    iters = min(12, params.get("max_iters") or 12)
    return P.superstep_specs("bfs",
                             output_rows=1 if count_only else g.n_vertices,
                             iterations=iters, state_bytes_per_vertex=4.0)


def _sssp_cost(g: P.GraphStats, params: dict, count_only: bool):
    # weighted relaxation settles slower than hop distance
    iters = min(24, params.get("max_iters") or 24)
    return P.superstep_specs("sssp",
                             output_rows=1 if count_only else g.n_vertices,
                             iterations=iters, state_bytes_per_vertex=4.0)


R.register(R.AlgorithmDef(
    name="bfs",
    run=_BFS_SPEC,
    init=_bfs_init,
    params=(
        R.Param("sources", R.REQUIRED, normalize=_sources_tuple),
        R.Param("max_iters", None, check=lambda n: n >= 1, normalize=int),
    ),
    count=reachable_count,
    count_method="reachable_count",
    cost=_bfs_cost,
    variants=R.superstep_variants(_BFS_SPEC),
    batch_runner=_bfs_batch,
    fuse=_relax_fuse_key,
    incremental=_bfs_incremental,
    example_params={"sources": (0,)},
    doc="Hop distances from a source set along directed edges.",
))

R.register(R.AlgorithmDef(
    name="sssp",
    run=_SSSP_SPEC,
    init=_sssp_init,
    params=(
        R.Param("source", R.REQUIRED, normalize=int),
        R.Param("max_iters", None, check=lambda n: n >= 1, normalize=int),
    ),
    cost=_sssp_cost,
    variants=R.superstep_variants(_SSSP_SPEC),
    batch_runner=_sssp_batch,
    fuse=_relax_fuse_key,
    incremental=_sssp_incremental,
    example_params={"source": 0},
    doc="Single-source weighted shortest paths (non-negative weights).",
))


# ---------------------------------------------------------------- oracles

def bfs_reference(src, dst, n_vertices: int, sources) -> np.ndarray:
    """Queue BFS oracle (host) for tests."""
    adj = [[] for _ in range(n_vertices)]
    for s, d in zip(np.asarray(src), np.asarray(dst)):
        adj[int(s)].append(int(d))
    dist = np.full(n_vertices, np.inf, dtype=np.float32)
    from collections import deque
    q = deque()
    for s in sources:
        dist[int(s)] = 0.0
        q.append(int(s))
    while q:
        u = q.popleft()
        for v in adj[u]:
            if not np.isfinite(dist[v]):
                dist[v] = dist[u] + 1.0
                q.append(v)
    return dist


def sssp_reference(src, dst, w, n_vertices: int, source: int) -> np.ndarray:
    """Dijkstra oracle (host) for tests — non-negative weights."""
    adj = [[] for _ in range(n_vertices)]
    for s, d, ww in zip(np.asarray(src), np.asarray(dst), np.asarray(w)):
        adj[int(s)].append((int(d), float(ww)))
    dist = np.full(n_vertices, np.inf, dtype=np.float64)
    dist[source] = 0.0
    heap = [(0.0, source)]
    while heap:
        du, u = heapq.heappop(heap)
        if du > dist[u]:
            continue
        for v, ww in adj[u]:
            nd = du + ww
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return dist.astype(np.float32)
