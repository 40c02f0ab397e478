"""Faithful re-implementations of the legacy Scalding pipelines.

The paper's speedups (17x multi-account, 37x combined connected users) are
measured AGAINST these pipelines, so they are part of the reproduction.
They are deliberately implemented the way a MapReduce dataflow runs them:

* every step **fully materializes** its output (MapReduce writes each
  stage to HDFS; we materialize numpy arrays and round-trip them through
  a serialization buffer to model the disk barrier),
* every shuffle is a **global sort** (MapReduce's sort-merge shuffle),
* no cross-step fusion, no convergence short-circuiting.

This is an honest algorithmic baseline, not a parody: the asymptotics and
data movement match the legacy jobs the paper describes; only constants
shrink because both run on the same host here.  Benchmarks report the
*ratio*, as the paper does.
"""
from __future__ import annotations

import io
from typing import Sequence

import numpy as np


def _hdfs_barrier(*arrays: np.ndarray) -> tuple[np.ndarray, ...]:
    """Model a MapReduce stage boundary: serialize + deserialize outputs."""
    buf = io.BytesIO()
    np.savez(buf, *arrays)
    buf.seek(0)
    loaded = np.load(buf)
    return tuple(loaded[k] for k in loaded.files)


def _group_adjacency(keys: np.ndarray, vals: np.ndarray, cap: int):
    """Sort-merge groupby key -> capped neighbor lists (one MR stage)."""
    order = np.argsort(keys, kind="stable")          # the shuffle sort
    keys, vals = keys[order], vals[order]
    starts = np.flatnonzero(np.concatenate([[True], keys[1:] != keys[:-1]]))
    counts = np.diff(np.concatenate([starts, [keys.shape[0]]]))
    slot = np.arange(keys.shape[0]) - np.repeat(starts, counts)
    keep = slot < cap                                 # MaxAdjacentNodes
    return keys[keep], vals[keep], slot[keep]


def legacy_multi_account(
    user_ids: np.ndarray,
    identifier_ids: np.ndarray,
    max_adjacent_nodes: int = 100,
) -> set:
    """The 3-step Scalding job (Section IV-C-1 of the paper).

    1) user -> identifiers adjacency, 2) identifier -> users adjacency,
    3) join on identifier, group by user.  Returns distinct user pairs.
    """
    u = np.asarray(user_ids, dtype=np.int64)
    i = np.asarray(identifier_ids, dtype=np.int64)

    # Step 1: identifier neighbors per user (materialized).
    k1, v1, _ = _group_adjacency(u, i, max_adjacent_nodes)
    k1, v1 = _hdfs_barrier(k1, v1)

    # Step 2: user neighbors per identifier (materialized).
    k2, v2, _ = _group_adjacency(i, u, max_adjacent_nodes)
    k2, v2 = _hdfs_barrier(k2, v2)

    # Step 3: join step-1 output with step-2 output on identifier, then
    # group by user.  MapReduce realizes the join as another sort-merge.
    o1 = np.argsort(v1, kind="stable")     # step-1 rows keyed by identifier
    ju, jid = k1[o1], v1[o1]
    o2 = np.argsort(k2, kind="stable")
    jid2, jus = k2[o2], v2[o2]

    # merge-join jid (sorted) with jid2 (sorted)
    left_start = np.searchsorted(jid2, jid, side="left")
    left_end = np.searchsorted(jid2, jid, side="right")
    reps = (left_end - left_start).astype(np.int64)
    rows = np.repeat(np.arange(jid.shape[0]), reps)
    offs = np.arange(reps.sum()) - np.repeat(np.cumsum(reps) - reps, reps)
    idx2 = np.repeat(left_start, reps) + offs
    pa, pb = ju[rows], jus[idx2]
    (pa, pb) = _hdfs_barrier(pa, pb)

    keep = pa != pb
    lo = np.minimum(pa[keep], pb[keep])
    hi = np.maximum(pa[keep], pb[keep])
    key = lo * np.int64(1 << 32) + hi
    key = np.unique(key)                   # final group-by-user dedup
    return {(int(k >> 32), int(k & 0xFFFFFFFF)) for k in key}


def _cc_one_edge_set(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """Per-edge-set CC, the way the legacy job did it: iterative min-label
    propagation where EVERY round is a materialized sort-merge stage."""
    labels = np.arange(n, dtype=np.int64)
    for _ in range(n):  # upper bound; breaks on fixpoint
        ls = labels[src]
        ld = labels[dst]
        new = labels.copy()
        np.minimum.at(new, dst, ls)
        np.minimum.at(new, src, ld)
        (new,) = _hdfs_barrier(new)        # stage boundary each round
        if np.array_equal(new, labels):
            break
        labels = new
    return labels


def legacy_connected_users(
    edge_sets: Sequence[tuple[np.ndarray, np.ndarray]],
    n_vertices: int,
) -> np.ndarray:
    """The 2-step Scalding job (Section IV-C-2): CC per identifier edge-set,
    then a merge job combining the per-set labelings."""
    per_set = []
    for src, dst in edge_sets:
        per_set.append(_cc_one_edge_set(np.asarray(src, np.int64),
                                        np.asarray(dst, np.int64),
                                        n_vertices))
    # Merge job: each per-set labeling induces (v, label) equivalences;
    # combine by iterating pairwise merges (as the legacy combine did).
    labels = np.arange(n_vertices, dtype=np.int64)
    changed = True
    while changed:
        changed = False
        for ls in per_set:
            # v ~ ls[v]: propagate the current min label through each
            # per-set group (one sort-merge stage per labeling)
            srt = np.argsort(ls, kind="stable")
            uniq_vals, uniq_idx = np.unique(ls[srt], return_index=True)
            grp_min = np.minimum.reduceat(labels[srt], uniq_idx)
            lookup = np.full(n_vertices, np.iinfo(np.int64).max)
            lookup[uniq_vals] = grp_min
            new = np.minimum(labels, lookup[ls])
            (new,) = _hdfs_barrier(new)
            if not np.array_equal(new, labels):
                labels = new
                changed = True
    return labels.astype(np.int32)
