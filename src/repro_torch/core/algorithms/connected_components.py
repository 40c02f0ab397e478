"""Combined connected users == connected components on the unified graph.

The paper's second flagship workload: the legacy Scalding pipeline ran CC
*separately per identifier edge-set* then merged (17-29 h); GraphFrames
builds ONE graph over all identifiers and runs CC directly (40 min, 37x).
We implement that unified formulation as hash-to-min label propagation:

    label[v] <- min(label[v], min_{u in N(v)} label[u])

on the symmetrized edge list, iterated to fixpoint.
``accelerated=True`` adds pointer-jumping (label <- label[label]) each
round — O(log d) instead of O(d) rounds (GraphFrames' large-star/
small-star needs dynamic edge mutation; pointer jumping gets the same
asymptotics with a pure gather).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.core import planner as P
from repro_torch.core import registry as R
from repro_torch.core.partition import ShardedCOO, partition
from repro_torch.core.pregel import PregelSpec, converged_halt, run_pregel
from repro_torch.kernels.pregel_superstep.ops import msg_src


def _cc_apply(lbl, agg, ids, gval):
    return torch.minimum(lbl, agg)


def _cc_apply_jump(lbl, agg, ids, gval):
    # pointer jumping: labels are vertex ids, chase one hop
    new = torch.minimum(lbl, agg)
    return torch.minimum(new, new[new.clamp(0, new.shape[0] - 1).long()])


# Hash-to-min is a monotone min fold, so frontier compression is exact;
# the default activity predicate (state != identity) marks every vertex
# active in round 1, as labels start at their own vertex id.  Pointer
# jumping lives in ``apply``, which every superstep strategy runs
# densely — the frontier only prunes *message* work.  The message is the
# kernel's compiled ``msg_src`` program, so the fused variant runs the
# CUDA kernel on the card.
_CC_SPEC = PregelSpec(message=msg_src, combine="min", apply=_cc_apply,
                      identity=int(np.iinfo(np.int32).max),
                      halt=converged_halt, elementwise_message=True,
                      frontier_mode="monotone")
_CC_SPEC_JUMP = PregelSpec(message=msg_src, combine="min",
                           apply=_cc_apply_jump,
                           identity=int(np.iinfo(np.int32).max),
                           halt=converged_halt, elementwise_message=True,
                           frontier_mode="monotone")


def connected_components(
    g: G.GraphCOO,
    max_iters: int = 200,
    mesh=None,
    n_data: int = 1,
    n_model: int = 1,
    accelerated: bool = True,
    sharded: Optional[ShardedCOO] = None,
):
    """Returns (labels [V] int32 — min vertex id per component, iters).

    ``g`` must already be symmetrized (``build_coo(..., symmetrize=True)``);
    isolated vertices keep their own id.
    """
    V = g.n_vertices
    if sharded is None:
        sharded = partition(g, n_data, n_model)
    spec = _CC_SPEC_JUMP if (accelerated and sharded.n_model == 1) \
        else _CC_SPEC
    init = torch.arange(sharded.n_pad, dtype=torch.int32,
                        device=sharded.src.device)
    labels, iters = run_pregel(spec, sharded, init, max_iters, mesh=mesh)
    return labels[:V], iters


def num_components(labels) -> int:
    """Count-only fast path (the query where the paper's Neo4j wins 300x:
    'Neo4j takes <2 s to return the count, Spark spends ~10 min')."""
    V = labels.shape[0]
    is_root = labels == torch.arange(V, dtype=labels.dtype,
                                     device=labels.device)
    return int(is_root.sum())


# ------------------------------------------------------------ registration

def _engine_run(eng, max_iters):
    return connected_components(
        eng.coo, max_iters=max_iters, mesh=eng.mesh, sharded=eng.sharded,
        accelerated=eng.n_model == 1)


def _cc_variant(mode):
    """Superstep-variant runner: same spec/init choices as
    ``connected_components``, dispatched through the engine's superstep
    choke point (which falls back to dense when unsupported)."""
    def run(eng, max_iters):
        sharded = eng.sharded
        spec = _CC_SPEC_JUMP if sharded.n_model == 1 else _CC_SPEC
        init = torch.arange(sharded.n_pad, dtype=torch.int32,
                            device=eng.device)
        labels, iters = eng.run_superstep(spec, init, max_iters,
                                          variant=mode)
        return labels[: eng.coo.n_vertices], int(iters)
    return run


def _cc_incremental(eng, params, seed, delta):
    """Localized repair for *add-only* deltas.

    The previous snapshot's labels are min-ids of old components; on an
    add-only delta every old label is an elementwise upper bound on the
    new fixpoint, and for every old edge ``u -> v`` the old fixpoint
    already satisfies ``label[v] <= label[u]`` — untouched sources'
    messages are no-ops.  Seeding the state with the old labels and the
    frontier with the delta's touched endpoints therefore runs exactly
    the repair wavefront and converges to the cold answer's canonical
    min-id labels, byte for byte.  Removals can split components
    (labels would need to *rise*), so those decline to a cold run.
    """
    if delta is None or delta.n_removed:
        return None
    prev = G.to_numpy(getattr(seed, "value", seed))
    V = eng.coo.n_vertices
    if prev.ndim != 1 or prev.shape[0] > V or prev.dtype.kind not in "iu":
        return None
    sharded = eng.sharded
    init = np.arange(sharded.n_pad, dtype=np.int32)
    init[: prev.shape[0]] = prev
    act = np.zeros(V, dtype=bool)
    touched = np.asarray(delta.touched)
    act[touched[touched < V]] = True
    spec = _CC_SPEC_JUMP if sharded.n_model == 1 else _CC_SPEC
    labels, iters = eng.run_superstep(
        spec, torch.from_numpy(init).to(eng.device), params["max_iters"],
        variant="auto", init_active=torch.from_numpy(act).to(eng.device))
    if int(iters) >= params["max_iters"]:
        return None          # budget exhausted before the fixpoint
    return labels[:V], int(iters)


def _cost(g: P.GraphStats, params: dict, count_only: bool):
    # pointer-jumping converges in O(log d) rounds; honour a tighter
    # user-supplied cap (the planner must not cost a 4-superstep query
    # at the analytic 16)
    iters = min(16, params.get("max_iters") or 16)
    return P.superstep_specs("connected_components",
                             output_rows=1 if count_only else g.n_vertices,
                             iterations=iters)


R.register(R.AlgorithmDef(
    name="connected_components",
    run=_engine_run,
    params=(
        R.Param("max_iters", 200, check=lambda n: n >= 1, normalize=int),
    ),
    count=num_components,
    count_method="num_components",
    cost=_cost,
    variants={"dense": _cc_variant("dense"),
              "fused": _cc_variant("fused"),
              "frontier": _cc_variant("frontier")},
    requires_symmetric=True,
    incremental=_cc_incremental,
    doc="Hash-to-min label propagation with pointer-jumping acceleration.",
))


def connected_components_reference(src, dst, n_vertices):
    """Union-find oracle (numpy, host) for tests."""
    parent = np.arange(n_vertices, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for s, d in zip(np.asarray(src), np.asarray(dst)):
        rs, rd = find(int(s)), find(int(d))
        if rs != rd:
            if rs < rd:
                parent[rd] = rs
            else:
                parent[rs] = rd
    return np.array([find(i) for i in range(n_vertices)], dtype=np.int32)
