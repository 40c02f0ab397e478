"""Multi-account detection: the two-hop motif
``(user1)-[e1]->(identifier)-[e2]->(user2)``.

The paper runs this on a 14.89B-vertex heterogeneous graph of users and
identifiers (emails, phones): two users are "the same" when one identifier
connects them directly.  GraphFrames solves it with Motif Finding; the
legacy Scalding job did a 3-step join with a MaxAdjacentNodes=100 cap
(losing 27.8% of edges, Table I).

Formulation: pack the identifier->users adjacency in ELL (``[I, K]``);
every unordered pair of valid slots in a row is a match.  The pair
expansion is a statically-shaped ``[I, K*(K-1)/2]`` tensor — degree skew
became padding at ETL time, so there is no shuffle and no stragglers.
Its memory is O(I * K^2): at I = 2^20 rows and K = 48 it is 1.18 G pair
slots, tens of GB with the sort.  Deduplication across identifiers is
one sort of packed 64-bit keys ``lo << 32 | hi`` (torch has no
``lexsort``; the packed key orders pairs exactly as a lexsort on
``(lo, hi)`` does, and the sentinel ``int32 max`` still sorts last).
The count-only fast path never materializes pairs at all — the workload
class where the paper's local engine (Neo4j) dominates.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.core import planner as P
from repro_torch.core import registry as R

_SENT = int(np.iinfo(np.int32).max)


def _pair_slots(k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Static upper-triangle slot indices for one ELL row of width K."""
    a, b = np.triu_indices(k, k=1)
    return (torch.from_numpy(a.astype(np.int64)).to(device),
            torch.from_numpy(b.astype(np.int64)).to(device))


def _expand_pairs(nbr, mask, slot_a, slot_b):
    """[I, K] rows -> canonical (lo, hi) pair columns [I*P] (int32).

    Invalid slots (and self-pairs) become (SENT, SENT) so they sort
    last."""
    u1 = nbr[:, slot_a]                      # [I, P]
    u2 = nbr[:, slot_b]
    valid = mask[:, slot_a] & mask[:, slot_b] & (u1 != u2)
    sent = torch.full((), _SENT, dtype=torch.int32, device=nbr.device)
    lo = torch.where(valid, torch.minimum(u1, u2), sent)
    hi = torch.where(valid, torch.maximum(u1, u2), sent)
    return lo.reshape(-1), hi.reshape(-1), valid.reshape(-1)


def _packed_keys(nbr, mask, slot_a, slot_b):
    """The expansion's pairs as packed int64 keys ``lo << 32 | hi`` (both
    int32 and non-negative, so the key orders exactly as the pair does);
    the int32 columns are released when this returns."""
    lo, hi, _ = _expand_pairs(nbr, mask, slot_a, slot_b)
    key = lo.to(torch.int64)
    key <<= 32
    key |= hi.to(torch.int64)
    return key


def _dedup_sorted(key):
    """Sort the packed pairs (a stable sort, as the reference's lexsort
    on ``(lo, hi)``); unique = first occurrence of each valid pair."""
    key_s = torch.sort(key, stable=True).values
    del key
    uniq = torch.ones(key_s.shape[0], dtype=torch.bool, device=key_s.device)
    uniq[1:] = key_s[1:] != key_s[:-1]
    lo_s = (key_s >> 32).to(torch.int32)
    hi_s = (key_s & 0xFFFFFFFF).to(torch.int32)
    return lo_s, hi_s, uniq & (lo_s != _SENT)


def two_hop_pairs(ell: G.GraphELL, n_users: int, dedup: bool = True):
    """All (user, user) matches.

    Returns ``(pairs [N_pad, 2] int32, valid [N_pad] bool, count)`` where
    ``count`` (a 0-d int64 tensor) is the number of *distinct* pairs when
    ``dedup`` else total (with per-identifier multiplicity).
    """
    sa, sb = _pair_slots(ell.max_degree, ell.nbr.device)
    if not dedup:
        lo, hi, valid = _expand_pairs(ell.nbr, ell.mask, sa, sb)
        pairs = torch.stack([lo, hi], dim=-1)
        return pairs, valid, valid.sum()
    lo_s, hi_s, uniq = _dedup_sorted(_packed_keys(ell.nbr, ell.mask, sa, sb))
    pairs = torch.stack([lo_s, hi_s], dim=-1)
    return pairs, uniq, uniq.sum()


def two_hop_count_upper_bound(identifier_degrees):
    """Count-only fast path: sum_i d_i*(d_i-1)/2 — no pair materialization.

    Upper bound on distinct matches (exact when no user pair shares two
    identifiers).  This is the 'return only a count' query class from the
    paper's Fig. 5 discussion.  Computed in int64 (the reference's int32
    products wrap past d = 46341).
    """
    d = identifier_degrees.to(torch.int64)
    return (d * (d - 1) // 2).sum()


def multi_account_pairs(
    user_ids: np.ndarray,
    identifier_ids: np.ndarray,
    n_users: int,
    n_identifiers: int,
    max_adjacent_nodes: int = 100,
    dedup: bool = True,
    device=None,
):
    """End-to-end: (user, identifier) edge snapshot -> matched user pairs.

    Mirrors the production job: builds the identifier->users ELL adjacency
    (with the paper's MaxAdjacentNodes cap) and expands the motif.
    Returns ``(pairs, valid, count, ell)``.
    """
    ell = G.build_ell(
        src=np.asarray(user_ids), dst=np.asarray(identifier_ids),
        n_vertices=n_identifiers, max_degree=max_adjacent_nodes,
        direction="in", device=device,
    )
    # rows index identifiers; entries are user ids (sentinel n_users safe
    # because build_ell used n_identifiers as sentinel — remap it)
    nbr = torch.where(ell.mask, ell.nbr,
                      torch.full((), n_users, dtype=torch.int32,
                                 device=ell.nbr.device))
    ell = G.GraphELL(nbr, ell.mask, ell.w, ell.n_vertices,
                     ell.n_edges, ell.n_edges_total)
    pairs, valid, count = two_hop_pairs(ell, n_users, dedup=dedup)
    return pairs, valid, count, ell


# ------------------------------------------------------------ registration

def _engine_run(eng, n_users=None, dedup=True, expected_pairs=None):
    """Motif expansion over the engine's cached ELL adjacency — both
    engines share the one built-once layout (padding slots are gated by
    the mask, so no sentinel remap is needed)."""
    pairs, valid, count = two_hop_pairs(
        eng.ell, n_users or eng.coo.n_vertices, dedup=dedup)
    return (pairs, valid, int(count)), None


def _engine_count(eng, **_):
    """Count-only fast path on *exact* COO in-degrees — identical on
    both engines (the capped ELL degrees would undercount wherever the
    cap truncated a row)."""
    return int(two_hop_count_upper_bound(G.in_degrees(eng.coo))), None


def _cost(g: P.GraphStats, params: dict, count_only: bool) -> P.QuerySpec:
    rows = 1 if count_only else (params.get("expected_pairs")
                                 or max(g.n_edges * 4, g.n_vertices))
    return P.QuerySpec("two_hop", rows, iterations=1)


R.register(R.AlgorithmDef(
    name="two_hop",
    run=_engine_run,
    params=(
        R.Param("n_users", None, check=lambda n: n >= 1, normalize=int,
                doc="user-id space size for bipartite graphs "
                    "(defaults to n_vertices)"),
        R.Param("dedup", True, normalize=bool),
        R.Param("expected_pairs", None, check=lambda n: n >= 1,
                normalize=int, doc="planner hint: estimated output rows"),
    ),
    count_run=_engine_count,
    cost=_cost,
    method="two_hop_pairs",
    count_method="two_hop_count",
    example_params=None,    # output is O(V * K^2)
    doc="Multi-account two-hop motif over the ELL layout.",
))


def two_hop_reference(user_ids, identifier_ids, n_users):
    """Pure-python oracle: distinct user pairs sharing >=1 identifier."""
    from collections import defaultdict
    by_id = defaultdict(list)
    for u, i in zip(np.asarray(user_ids), np.asarray(identifier_ids)):
        by_id[int(i)].append(int(u))
    pairs = set()
    for users in by_id.values():
        us = sorted(set(users))
        for a in range(len(us)):
            for b in range(a + 1, len(us)):
                pairs.add((us[a], us[b]))
    return pairs
