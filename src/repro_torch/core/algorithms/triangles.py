"""Cohesion workloads: triangle counting and k-core degree-peeling.

**Triangle counting** needs neighborhood *intersection*, which a scalar
message cannot carry.  Two registered execution variants produce the
same count; the planner picks the cheaper feasible one per
(graph, engine) from the cost hook's two QuerySpecs:

* ``bitset`` — the pregel formulation over N-D vertex state: each
  vertex carries a packed neighborhood bitset (``ceil(V/32)`` 32-bit
  words, plus one count word), built in one superstep (sum of deduped
  one-hot rows == bitwise OR) and intersected in a second where each
  edge reads *both* endpoint states:

      superstep 1:  state[v] <- OR_{(u,v) in E} onehot(u)     (adjacency)
      superstep 2:  count[v] <- sum_{(u,v) in E} popcount(N(u) & N(v))

  On the symmetrized graph every triangle is counted six times (three
  undirected edges, two directions each), so ``total // 6`` is exact.
  Memory is O(V^2/32) words of state and O(E * V/32) gather traffic —
  the quadratic term that confines this variant to small graphs (the
  planner's choice only for small interactive ones).

* ``intersect`` — the degree-ordered ELL-intersection formulation
  (NScale / GraphX style): orient every undirected edge from its
  lower-(degree, id) endpoint to the higher, keep each vertex's sorted
  oriented out-neighbor row (``OrientedELL``, cached on the engine next
  to the ShardedCOO/ELL derived state), and sum
  ``|nbr[u] ∩ nbr[v]|`` over the oriented edges — each triangle counted
  exactly once at its lowest-rank edge.  The intersection runs through
  the ``kernels/ell_intersect`` wrapper: the hand-written CUDA kernel on
  the card, its plain ``searchsorted`` version on the CPU.  Memory is
  O(V * d_max) with the orientation's d_max = O(sqrt(E)) — *linear* in
  E·d̄, so large-V triangle queries stay on whichever engine the cost
  model prefers instead of being forced distributed by bitset memory.

**k-core** is the classic peeling fixpoint as a scalar vertex program:
vertices stay alive while their alive-degree is >= k; peeling runs to
convergence on either engine.

Both require a symmetrized graph (``build_coo(..., symmetrize=True)``,
enforced via the ``GraphCOO.symmetric`` flag) — on a directed edge list
they would run fine but return silently wrong answers.  Self-loops are
tolerated: triangle counting clears each vertex's own bit from its
neighborhood bitset, and k-core counts a self-loop once toward degree.
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
from repro_torch.core.pregel import PregelSpec, converged_halt, run_pregel
from repro_torch.kernels.ell_intersect import ops as intersect_ops
from repro_torch.kernels.pregel_superstep.ops import msg_src


def _n_words(n_vertices: int) -> int:
    return -(-n_vertices // 32)


# The bitset words are 32-bit words held in int64, where the reference
# holds them in uint32: torch has no uint32 index_add_ (the dense
# path's sum combine), shifts, negation or comparisons, and int64 keeps
# every word non-negative.  The words, counts and results are the
# reference's exactly.

# agg = summed one-hot rows of in-neighbors == their OR (edges are
# deduped so no bit is added twice); count word arrives as 0.
_ADJACENCY_SPEC = PregelSpec(
    message=msg_src,
    combine="sum",
    apply=lambda old, agg, ids, gval: agg,
    identity=0)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word held in an int64 tensor (the SWAR
    count: torch has no popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


@lru_cache(maxsize=None)
def _intersect_spec(n_words: int) -> PregelSpec:
    W = n_words

    def message(src_state, w, dst_state):
        sb, db = src_state[:, :W], dst_state[:, :W]
        common = _popcount32(sb & db).sum(dim=-1)
        # a self-loop edge intersects N(v) with itself (|N(v)|, not a
        # triangle count).  With own bits cleared, adjacent *distinct*
        # vertices always differ in their bitsets (v is in N(u) but not
        # in N(v)), so bitset equality identifies exactly the loops.
        is_loop = torch.all(sb == db, dim=-1)
        return torch.where(is_loop, torch.zeros_like(common), common)

    def apply(old, agg, ids, gval):
        return torch.cat([old[:, :W], agg[:, None].to(old.dtype)], dim=-1)

    return PregelSpec(
        message=message, combine="sum", apply=apply, identity=0,
        needs_dst_state=True)


def triangle_count(
    g: G.GraphCOO,
    mesh=None,
    n_data: int = 1,
    n_model: int = 1,
    sharded: Optional[ShardedCOO] = None,
):
    """Returns ``(n_triangles, per_vertex_pair_counts [V] int64 — popcount
    sums per destination, each triangle contributing 6 across the
    graph)``.
    """
    G.require_symmetric(g, "triangle_count")
    V = g.n_vertices
    W = _n_words(V)
    if sharded is None:
        sharded = partition(g, n_data, n_model)
    dev = sharded.src.device
    # own-bit bitset rows; the trailing word accumulates the pair counts
    init = torch.zeros((sharded.n_pad, W + 1), dtype=torch.int64, device=dev)
    ids = torch.arange(V, dtype=torch.int64, device=dev)
    own_bits = torch.ones_like(ids) << (ids % 32)
    init[ids, ids // 32] = own_bits

    bitsets, _ = run_pregel(_ADJACENCY_SPEC, sharded, init, max_iters=1,
                            mesh=mesh)
    # self-loops would put v's own bit in N(v) and inflate every
    # intersection along v's edges — clear it unconditionally
    bitsets[ids, ids // 32] &= ~own_bits
    counted, _ = run_pregel(_intersect_spec(W), sharded, bitsets,
                            max_iters=1, mesh=mesh)
    per_vertex = counted[:V, W]
    return int(per_vertex.sum()) // 6, per_vertex


def triangle_count_intersect(
    g: G.GraphCOO,
    oriented: Optional[G.OrientedELL] = None,
    use_kernels: bool = True,
):
    """The linear-memory variant: degree-ordered sorted-row intersection.

    Returns ``(n_triangles, per_oriented_edge_counts [n_edges] int32 —
    the |nbr[u] ∩ nbr[v]| term per oriented edge, summing to the exact
    count)``.  The counts stay on the device; their int64 sum is the one
    value that crosses to the host.  Pass a cached ``oriented`` (the
    engine does) to skip the host-side orientation build.
    ``use_kernels=False`` runs the plain version wherever the orientation
    lives.
    """
    G.require_symmetric(g, "triangle_count")
    if oriented is None:
        oriented = G.build_oriented_ell(
            G.to_numpy(g.src[: g.n_edges]), G.to_numpy(g.dst[: g.n_edges]),
            g.n_vertices, device=g.device)
    counts = intersect_ops.ell_intersect_counts(oriented,
                                                use_kernels=use_kernels)
    return int(counts.sum(dtype=torch.int64)), counts


# ------------------------------------------------------------------- k-core

@lru_cache(maxsize=None)
def _kcore_spec(k: int) -> PregelSpec:
    def apply(alive, deg, ids, gval):
        # peeling is monotone: once dropped, never resurrected
        return torch.where(alive > 0.5, (deg >= k).to(torch.float32),
                           torch.zeros_like(alive))

    # The 0/1 aliveness sum is integer-valued in f32 (exact for degrees
    # < 2^24), so 'delta' frontier compression is exact: changed
    # vertices scatter msg(new) - msg(old) into a carried aggregate.
    # Reduced-precision channels stay *off* (no allow_inexact_sum):
    # bf16 cannot represent degrees above 256 exactly, which would break
    # the bit-parity contract between variants.  The message is the
    # kernel's compiled ``msg_src`` program, so the fused variant runs
    # the CUDA kernel on the card.
    return PregelSpec(
        message=msg_src,
        combine="sum", apply=apply, identity=0.0,
        halt=converged_halt, elementwise_message=True,
        frontier_mode="delta")


def k_core(
    g: G.GraphCOO,
    k: int,
    max_iters: Optional[int] = None,
    mesh=None,
    n_data: int = 1,
    n_model: int = 1,
    sharded: Optional[ShardedCOO] = None,
):
    """Returns ``(in_core [V] bool, iters)`` — membership in the maximal
    subgraph where every vertex has degree >= k (a self-loop counts once
    toward its vertex's degree).  ``max_iters=None`` (default) guarantees
    the peeling reaches its fixpoint (at most V rounds; the halt check
    exits far earlier in practice)."""
    G.require_symmetric(g, "k_core")
    V = g.n_vertices
    if max_iters is None:
        max_iters = V
    if sharded is None:
        sharded = partition(g, n_data, n_model)
    init = torch.ones(sharded.n_pad, dtype=torch.float32,
                      device=sharded.src.device)
    alive, iters = run_pregel(_kcore_spec(int(k)), sharded, init,
                              max_iters, mesh=mesh)
    return alive[:V] > 0.5, iters


def core_size(in_core) -> int:
    """Count-only fast path: |k-core| without materializing membership."""
    return int(in_core.sum())


# ------------------------------------------------------------ registration

def _tri_run_bitset(eng):
    count, _per_vertex = triangle_count(eng.coo, mesh=eng.mesh,
                                        sharded=eng.sharded)
    return count, 2


def _tri_run_intersect(eng):
    count, _per_edge = triangle_count_intersect(
        eng.coo, oriented=eng.oriented, use_kernels=eng.use_kernels)
    return count, 1


def oriented_degree_estimate(n_vertices: int, n_edges: int) -> float:
    """Analytic stand-in for the degree-ordered orientation's max
    out-degree, which the planner cannot know without building the
    adjacency: near the mean degree on heavy-tailed graphs (hubs rank
    last and mostly *receive*), never above the sqrt(2E) arboricity-style
    bound.  A calibration target like the other planner constants."""
    avg = n_edges / max(n_vertices, 1)
    return max(min((2.0 * max(n_edges, 1)) ** 0.5, 2.0 * avg + 16.0), 1.0)


def _tri_cost(g: P.GraphStats, params: dict, count_only: bool):
    # bitset: two supersteps over neighborhood bitsets of ceil(V/32)
    # words — sized with the runner's own _n_words (ceil), not floor
    word_bytes = 4.0 * max(_n_words(g.n_vertices), 1)
    bitset = P.QuerySpec("triangle_count", 1, iterations=2,
                         state_bytes_per_vertex=word_bytes,
                         edge_bytes_factor=max(2 * word_bytes / 12, 1.0),
                         variant="bitset")
    # intersect: one pass over the oriented edges; resident state is the
    # sorted out-neighbor rows (~4*d_max B/vertex), per-edge work is
    # charged as the reference's K x K lane-compare (compute-equivalent
    # bytes), kept for plan parity with the reference.  Once an engine
    # has built the OrientedELL its *measured* row width flows back
    # through GraphStats and replaces the analytic estimate.
    if g.oriented_width is not None:
        d_hat = max(float(g.oriented_width), 1.0)
    else:
        d_hat = oriented_degree_estimate(g.n_vertices, g.n_edges)
    intersect = P.QuerySpec("triangle_count", 1, iterations=1,
                            state_bytes_per_vertex=4.0 * d_hat,
                            edge_bytes_factor=max(d_hat * d_hat / 12.0, 1.0),
                            variant="intersect")
    return (bitset, intersect)


R.register(R.AlgorithmDef(
    name="triangle_count",
    run=_tri_run_bitset,
    variants={"bitset": _tri_run_bitset, "intersect": _tri_run_intersect},
    cost=_tri_cost,
    requires_symmetric=True,
    doc="Global triangle count; bitset intersection on small graphs, "
        "degree-ordered sorted-ELL intersection beyond the bitset wall.",
))


def _kcore_run(eng, k, max_iters):
    return k_core(eng.coo, k, max_iters=max_iters, mesh=eng.mesh,
                  sharded=eng.sharded)


def _kcore_variant(mode):
    """Superstep-variant runner: same init as ``k_core``, dispatched
    through the engine's superstep choke point."""
    def run(eng, k, max_iters):
        G.require_symmetric(eng.coo, "k_core")
        V = eng.coo.n_vertices
        mi = max_iters if max_iters is not None else V
        init = torch.ones(eng.sharded.n_pad, dtype=torch.float32,
                          device=eng.device)
        alive, iters = eng.run_superstep(_kcore_spec(int(k)), init, mi,
                                         variant=mode)
        return alive[:V] > 0.5, int(iters)
    return run


def _kcore_cost(g: P.GraphStats, params: dict, count_only: bool):
    iters = min(10, params.get("max_iters") or 10)
    return P.superstep_specs("k_core",
                             output_rows=1 if count_only else g.n_vertices,
                             iterations=iters, state_bytes_per_vertex=4.0)


def _kcore_incremental(eng, params, seed, delta):
    """Localized repair for *removal-only* deltas: removing edges can
    only shrink the core (any subgraph with min degree >= k in the new
    graph had it in the old one), so ``core_new ⊆ core_old`` and
    peeling the new graph *from the old membership* reaches the k-core
    of the old core's induced subgraph — which is exactly ``core_new``.
    Membership is a canonical bool vector, so the repaired result is
    byte-identical to a cold peel from all-alive.  Added edges can grow
    the core (dropped vertices would need to resurrect), so those
    decline, as does an explicit iteration cap (truncated-peeling
    semantics) or a budget-exhausted run."""
    if delta is None or delta.n_added or params["max_iters"] is not None:
        return None
    prev = G.to_numpy(getattr(seed, "value", seed))
    V = eng.coo.n_vertices
    if prev.ndim != 1 or prev.shape[0] != V or prev.dtype != np.bool_:
        return None
    mi = V
    init = np.zeros(eng.sharded.n_pad, dtype=np.float32)
    init[:V] = prev.astype(np.float32)
    alive, iters = eng.run_superstep(_kcore_spec(int(params["k"])),
                                     torch.from_numpy(init).to(eng.device),
                                     mi, variant="auto")
    if int(iters) >= mi:
        return None
    return alive[:V] > 0.5, int(iters)


R.register(R.AlgorithmDef(
    name="k_core",
    run=_kcore_run,
    params=(
        R.Param("k", R.REQUIRED, check=lambda k: k >= 1, normalize=int),
        R.Param("max_iters", None, check=lambda n: n >= 1, normalize=int),
    ),
    count=core_size,
    count_method="k_core_size",
    cost=_kcore_cost,
    variants={"dense": _kcore_variant("dense"),
              "fused": _kcore_variant("fused"),
              "frontier": _kcore_variant("frontier")},
    requires_symmetric=True,
    incremental=_kcore_incremental,
    example_params={"k": 3},
    doc="k-core membership via degree peeling to fixpoint.",
))


# ---------------------------------------------------------------- oracles

def triangle_count_reference(src, dst, n_vertices: int) -> int:
    """Dense-matmul oracle: trace(A^3) / 6 on the symmetrized 0/1
    adjacency (small graphs only)."""
    a = np.zeros((n_vertices, n_vertices), dtype=np.int64)
    s = np.asarray(src)
    d = np.asarray(dst)
    a[s, d] = 1
    a[d, s] = 1
    np.fill_diagonal(a, 0)
    return int(np.trace(a @ a @ a)) // 6


def k_core_reference(src, dst, n_vertices: int, k: int) -> np.ndarray:
    """Iterative peeling oracle on the symmetrized edge list."""
    s = np.asarray(src, dtype=np.int64)
    d = np.asarray(dst, dtype=np.int64)
    alive = np.ones(n_vertices, dtype=bool)
    while True:
        keep = alive[s] & alive[d]
        deg = np.bincount(d[keep], minlength=n_vertices)
        drop = alive & (deg < k)
        if not drop.any():
            return alive
        alive[drop] = False
