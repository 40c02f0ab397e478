"""Community detection via synchronous weighted label propagation.

Classic LPA (Raghavan et al.) has every vertex adopt the label carried
by the plurality of its neighbors — a *mode* over neighbor labels, which
a single sum/min/max monoid cannot express (GraphX's LabelPropagation
merges hash-maps per message for exactly this reason; maps are not a
fixed-shape tensor type).  We express the mode with the pregel engine's
*structured messages*: each edge emits ``2C`` columns —

    columns [0, C)   : edge weight one-hot on ``hash(label_src) % C``
                       (combine **sum**  -> per-channel neighbor mass)
    columns [C, 2C)  : label value on the same channel, +inf elsewhere
                       (combine **min**  -> per-channel representative)

so one superstep delivers, per vertex, the weighted frequency histogram
of neighbor labels over C hash channels plus the smallest label in each
channel.  ``apply`` adopts the smallest label among maximal-mass
channels; a unit self-weight on the current label's channel breaks the
2-cycle oscillation synchronous LPA is known for.  Hash collisions merge
label mass within a channel (the representative is the channel min) —
with C default 64 and social-graph mean degrees ~10, collisions inside a
single neighborhood are rare, and the fixpoint iteration self-corrects.

The hash is Knuth's multiplicative hash in uint32 arithmetic.  torch's
CPU build lacks most uint32 operations, so it is computed in int64 and
masked to 32 bits: the channels are exactly the reference's.  The
message is written into one ``[E, 2C]`` float32 buffer (``E * 2C * 4``
bytes: 25.8 GB at the 2^22 identifier graph's 50 M edges and C = 64).

Labels are vertex ids carried in float32 channels, exact for
V < 2^24 — document-and-assert rather than silently lose precision.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import torch

from repro_torch.core import graph as G
from repro_torch.core import planner as P
from repro_torch.core import registry as R
from repro_torch.core.partition import ShardedCOO, partition
from repro_torch.core.pregel import PregelSpec, converged_halt, run_pregel

_HASH_MULT = 2654435761                     # Knuth multiplicative hash
_MAX_EXACT_LABEL = 1 << 24                  # float32 integer-exact range


def _channel(labels, n_channels: int):
    """``(uint32(label) * 2654435761 mod 2^32) % C`` as int64 indices.
    Labels are non-negative and below 2^24, so the int64 product never
    overflows and the mask is the uint32 wraparound."""
    h = (labels.to(torch.int64) * _HASH_MULT) & 0xFFFFFFFF
    return h % n_channels


@lru_cache(maxsize=None)
def _lpa_spec(n_channels: int, self_weight: float) -> PregelSpec:
    C = n_channels

    def message(lbl_src, w):
        E = lbl_src.shape[0]
        ch = _channel(lbl_src, C)[:, None]
        out = torch.zeros((E, 2 * C), dtype=torch.float32,
                          device=lbl_src.device)
        out[:, C:] = float("inf")
        out.scatter_(1, ch, w.to(torch.float32)[:, None])
        out.scatter_(1, ch + C, lbl_src.to(torch.float32)[:, None])
        return out

    def apply(lbl, agg, ids, gval):
        mass, rep = agg[:, :C], agg[:, C:]
        best_w = mass.amax(dim=-1)
        # smallest label among maximal-mass channels (deterministic
        # tie-break, independent of channel/hash order)
        inf = torch.full((), float("inf"), dtype=rep.dtype, device=rep.device)
        cand_f = torch.where(mass == best_w[:, None], rep, inf).amin(dim=-1)
        has_cand = torch.isfinite(cand_f)
        cand = torch.where(has_cand, cand_f,
                           torch.zeros((), dtype=cand_f.dtype,
                                       device=cand_f.device)).to(torch.int32)
        # mass already backing the current label, plus the self-vote that
        # prevents synchronous 2-cycles (e.g. a two-vertex component
        # swapping labels forever)
        cur_w = mass.gather(1, _channel(lbl, C)[:, None])[:, 0] + self_weight
        adopt = has_cand & ((best_w > cur_w)
                            | ((best_w == cur_w) & (cand < lbl)))
        return torch.where(adopt, cand, lbl)

    # Superstep-strategy declaration: LPA opts *out* of every fast
    # path.  The message is a [E, 2C] structured tensor (not
    # elementwise), the (sum ⊕ min) grouped monoid has no single
    # scatter op (no fused/frontier variant), and the mass channels are
    # an inexact float sum, so a reduced-precision message channel is
    # rejected by ``check_precision`` (allow_inexact_sum stays False).
    # Label adoption is also not a monotone fold of the aggregate —
    # dense is the only exact execution.
    return PregelSpec(
        message=message,
        combine=(("sum", C), ("min", C)),
        apply=apply,
        identity=(0.0, float("inf")),
        halt=converged_halt,
        elementwise_message=False,
        frontier_mode=None,
        allow_inexact_sum=False,
    )


def label_propagation(
    g: G.GraphCOO,
    max_iters: int = 30,
    n_channels: int = 64,
    self_weight: float = 1.0,
    mesh=None,
    n_data: int = 1,
    n_model: int = 1,
    sharded: Optional[ShardedCOO] = None,
):
    """Returns ``(labels [V] int32, iters)`` — one label per community.

    ``g`` should be symmetrized (community membership is undirected, like
    connected components).  Labels are vertex ids; two vertices share a
    community iff they share a label.  Synchronous LPA may not reach a
    global fixpoint on adversarial structures — ``max_iters`` bounds the
    loop and the result is deterministic either way (no RNG: ties break
    toward the smallest label).
    """
    if g.n_vertices >= _MAX_EXACT_LABEL:
        raise ValueError(
            f"label_propagation carries labels in float32 channels; "
            f"V={g.n_vertices} exceeds the exact-integer range 2^24")
    G.require_symmetric(g, "label_propagation")
    V = g.n_vertices
    if sharded is None:
        sharded = partition(g, n_data, n_model)
    init = torch.arange(sharded.n_pad, dtype=torch.int32,
                        device=sharded.src.device)
    spec = _lpa_spec(n_channels, float(self_weight))
    labels, iters = run_pregel(spec, sharded, init, max_iters, mesh=mesh)
    return labels[:V], iters


def num_communities(labels) -> int:
    """Count-only fast path: number of distinct labels, computed on
    device with one scatter — no host-side unique over the table."""
    V = labels.shape[0]
    present = torch.zeros(V, dtype=torch.int32, device=labels.device)
    present[labels.clamp(0, max(V - 1, 0)).long()] = 1
    return int(present.sum())


# ------------------------------------------------------------ registration

def _engine_run(eng, max_iters, n_channels, self_weight):
    return label_propagation(
        eng.coo, max_iters=max_iters, n_channels=n_channels,
        self_weight=self_weight, mesh=eng.mesh, sharded=eng.sharded)


def _cost(g: P.GraphStats, params: dict, count_only: bool) -> P.QuerySpec:
    # structured messages: 2C channels of 4 bytes vs 12-byte edges
    n_channels = params.get("n_channels") or 64
    iters = min(15, params.get("max_iters") or 15)
    return P.QuerySpec("label_propagation",
                       1 if count_only else g.n_vertices,
                       iterations=iters, state_bytes_per_vertex=4.0,
                       edge_bytes_factor=2 * n_channels * 4 / 12)


R.register(R.AlgorithmDef(
    name="label_propagation",
    run=_engine_run,
    params=(
        R.Param("max_iters", 30, check=lambda n: n >= 1, normalize=int),
        R.Param("n_channels", 64, check=lambda c: c >= 1, normalize=int),
        R.Param("self_weight", 1.0, check=lambda w: w >= 0.0,
                normalize=float),
    ),
    count=num_communities,
    count_method="num_communities",
    cost=_cost,
    requires_symmetric=True,
    example_params={"max_iters": 15},
    doc="Synchronous weighted label propagation over hash channels.",
))


def communities_reference(src, dst, n_vertices: int):
    """Union-find oracle: on graphs whose ground-truth communities are
    the connected components (e.g. disjoint cliques), LPA must agree."""
    from repro_torch.core.algorithms.connected_components import (
        connected_components_reference)
    return connected_components_reference(src, dst, n_vertices)
