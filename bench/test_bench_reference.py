"""The plain reference: hand-worked cases, and the port at tiny sizes."""
from __future__ import annotations

import math

import pytest
import torch

from bench.gen import EdgeList
from bench.reference import Adjacency, relax

INF = math.inf


def edges(pairs, weights, n):
    lo = torch.tensor([min(a, b) for a, b in pairs])
    hi = torch.tensor([max(a, b) for a, b in pairs])
    return EdgeList(lo, hi, torch.tensor(weights, dtype=torch.float32), n)


# 0 -1- 1 -1- 2 -1- 3, a shortcut 0 -2.5- 2, and 4 -1- 5 apart from them
GRAPH = edges([(0, 1), (1, 2), (2, 3), (0, 2), (4, 5)],
              [1.0, 1.0, 1.0, 2.5, 1.0], 6)


def test_bfs_hop_distances():
    ans = relax(Adjacency(GRAPH, "cpu"), 0, weighted=False)
    assert ans.dist.tolist() == [0, 1, 1, 2, INF, INF]
    assert ans.rounds == 3


def test_sssp_takes_the_lighter_longer_path():
    ans = relax(Adjacency(GRAPH, "cpu"), 0, weighted=True)
    assert ans.dist.tolist() == [0, 1, 2, 3, INF, INF]
    # round 1 reaches 2 over the shortcut (2.5); round 2 finds 1 + 1
    assert ans.rounds == 4


def test_round_bound_truncates_like_supersteps():
    ans = relax(Adjacency(GRAPH, "cpu"), 0, weighted=True, max_rounds=1)
    assert ans.dist.tolist() == [0, 1, 2.5, INF, INF, INF]
    ans = relax(Adjacency(GRAPH, "cpu"), 3, weighted=False, max_rounds=2)
    assert ans.dist.tolist() == [2, 2, 1, 0, INF, INF]


def test_least_bytes_count_edges_out_of_changed_vertices():
    """BFS from 0: round 1 reads 0's 2 edges and writes 1 and 2; round 2
    reads their 2 + 3 edges and writes 3; round 3 reads 3's edge and
    writes nothing.  SSSP adds a 4-byte weight an edge."""
    ans = relax(Adjacency(GRAPH, "cpu"), 0, weighted=False)
    assert ans.least_bytes == (2 + 5 + 1) * 4 + (2 + 1) * 4
    ans = relax(Adjacency(GRAPH, "cpu"), 0, weighted=True)
    # rounds: {0} -> 1, 2 changed; {1, 2} -> 2 (1+1), 3 (2.5+1) changed;
    # {2, 3} -> 3 (2+1) changed; {3} -> nothing
    reads = 2 + 5 + (3 + 1) + 1
    assert ans.least_bytes == reads * 8 + (2 + 2 + 1) * 4


def test_float32_sums_along_the_path():
    g = edges([(0, 1), (1, 2)], [0.1, 0.2], 3)
    ans = relax(Adjacency(g, "cpu"), 0, weighted=True)
    want = torch.tensor(0.1, dtype=torch.float32) + torch.tensor(
        0.2, dtype=torch.float32)
    assert ans.dist[2].item() == want.item()


@pytest.mark.parametrize("variant", ["dense", "frontier", "fused"])
@pytest.mark.parametrize("name", ["graph500-s21", "idsets-s22"])
@pytest.mark.parametrize("max_iters", [None, 4])
def test_reference_equals_the_port(variant, name, max_iters):
    """Every variant of the port's engine, on the port's own COO of the
    benchmark's edge list, answers bit for bit as the reference does."""
    from bench.test_bench_gen import GENERATORS, config
    from repro_torch.core import graph as G
    from repro_torch.core.engines import LocalEngine
    gen = dict(GENERATORS)[name]
    e = gen.generate(config(name), 5, "cpu")
    coo = G.build_coo(e.lo.numpy(), e.hi.numpy(), e.n_vertices,
                      w=e.w.numpy(), symmetrize=True, device="cpu")
    eng = LocalEngine(coo, device="cpu")
    adj = Adjacency(e, "cpu")
    roots = torch.nonzero(e.degrees() > 0).flatten()[:3].tolist()
    for root in roots:
        for algo, params in (("bfs", {"sources": (root,)}),
                             ("sssp", {"source": root})):
            r = eng.run(algo, {**params, "max_iters": max_iters},
                        variant=variant)
            want = relax(adj, root, algo == "sssp", max_iters)
            assert torch.equal(r.value, want.dist), (algo, root)
