"""Node similarity (common-neighbors / Jaccard) on the ELL layout.

The paper lists "node similarity" and "topic similarity" among the jobs
teams kept re-implementing.  On the ELL layout a similarity query for a
batch of (u, v) pairs is two row gathers and one masked intersection —
O(K^2) per pair with K = MaxAdjacentNodes, fully vectorized.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.core import planner as P
from repro_torch.core import registry as R


def _row_intersection_counts(nbr_u, mask_u, nbr_v, mask_v):
    """[B, K] rows -> |N(u) ∩ N(v)| per batch element (int32)."""
    eq = nbr_u[:, :, None] == nbr_v[:, None, :]
    eq &= mask_u[:, :, None] & mask_v[:, None, :]
    return eq.sum(dim=(1, 2), dtype=torch.int32)


def _ids(x, device) -> torch.Tensor:
    """Vertex ids as an int64 index tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)


def common_neighbors(ell: G.GraphELL, u, v):
    """Common-neighbor counts for pairs (u[i], v[i])."""
    u, v = _ids(u, ell.nbr.device), _ids(v, ell.nbr.device)
    return _row_intersection_counts(
        ell.nbr[u], ell.mask[u], ell.nbr[v], ell.mask[v])


def jaccard_similarity(ell: G.GraphELL, u, v):
    """|N(u) ∩ N(v)| / |N(u) ∪ N(v)| for pairs (u[i], v[i])."""
    u, v = _ids(u, ell.nbr.device), _ids(v, ell.nbr.device)
    inter = common_neighbors(ell, u, v).to(torch.float32)
    du = ell.mask[u].sum(dim=1).to(torch.float32)
    dv = ell.mask[v].sum(dim=1).to(torch.float32)
    union = du + dv - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1.0),
                       torch.zeros((), dtype=torch.float32,
                                   device=union.device))


# ------------------------------------------------------------ registration

def _vertex_batch(x):
    return tuple(int(i) for i in np.atleast_1d(np.asarray(x)))


def _engine_run(eng, u, v):
    return jaccard_similarity(eng.ell, u, v), None


def _batch_run(eng, params_list):
    """Fused batch path: B pair-batches concatenated into one gather +
    intersection call, slices scattered back per query.  Each row's
    arithmetic is independent, so every slice is bit-identical to
    running its query alone."""
    u_all = np.concatenate(
        [np.asarray(p["u"], np.int64) for p in params_list])
    v_all = np.concatenate(
        [np.asarray(p["v"], np.int64) for p in params_list])
    sims = jaccard_similarity(eng.ell, u_all, v_all)
    values, off = [], 0
    for p in params_list:
        n = len(p["u"])
        values.append(sims[off: off + n])
        off += n
    return values, None, {"pregel_calls": 0, "kernel_calls": 1}


def _cost(g: P.GraphStats, params: dict, count_only: bool) -> P.QuerySpec:
    rows = len(params.get("u") or (1,))
    return P.QuerySpec("jaccard", rows, iterations=1, row_bytes=4)


R.register(R.AlgorithmDef(
    name="jaccard",
    run=_engine_run,
    params=(
        R.Param("u", R.REQUIRED, normalize=_vertex_batch),
        R.Param("v", R.REQUIRED, normalize=_vertex_batch),
    ),
    cost=_cost,
    batch_runner=_batch_run,
    fuse=lambda params: (),      # any two pair-batches may share a call
    # the batched ELL-row intersection is an interactive single-device
    # workload — the capability flag keeps the planner honest about it
    engines=("local",),
    example_params={"u": (0, 1), "v": (1, 2)},
    doc="Jaccard similarity for (u[i], v[i]) vertex pairs on ELL rows.",
))
