"""The rest of the single-card graph platform in the port against the JAX
reference: two-hop (multi-account), label propagation, Jaccard and
common neighbours, the legacy Scalding baselines, and the end-to-end
workloads of ``tests/test_system.py`` and ``tests/test_algorithms.py``.

The same inputs (numpy, fixed seeds) go through both packages.
Tolerance: none for ids, labels, pairs, masks, counts and Jaccard scores
(byte-equal; LPA's float channels sum unit weights, exact in any order);
PageRank against networkx within its own test's ``atol`` 1e-6.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import graph as JG  # noqa: E402
from repro.core import planner as JP  # noqa: E402
from repro.core.query import GraphPlatform as JPlatform  # noqa: E402
from repro.core.query import GraphQuery as JQuery  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import planner as TP  # noqa: E402
from repro_torch.core.engines import DistributedEngine, LocalEngine  # noqa: E402
from repro_torch.core.query import GraphPlatform, GraphQuery  # noqa: E402
from repro_torch.data import synthetic as S  # noqa: E402

jth = importlib.import_module("repro.core.algorithms.two_hop")
tth = importlib.import_module("repro_torch.core.algorithms.two_hop")
jcm = importlib.import_module("repro.core.algorithms.community")
tcm = importlib.import_module("repro_torch.core.algorithms.community")
jsim = importlib.import_module("repro.core.algorithms.similarity")
tsim = importlib.import_module("repro_torch.core.algorithms.similarity")
jleg = importlib.import_module("repro.core.algorithms.legacy")
tleg = importlib.import_module("repro_torch.core.algorithms.legacy")
tcc = importlib.import_module(
    "repro_torch.core.algorithms.connected_components")

CPU = "cpu"


@pytest.fixture(autouse=True)
def _analytic_calibration():
    """Pin both packages' planners to their analytic constants."""
    JP.set_calibration(None)
    TP.set_calibration(None)
    yield
    JP.set_calibration(None)
    TP.set_calibration(None)


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


@pytest.fixture(scope="module")
def bipartite():
    return S.safety_bipartite_graph(400, 150, seed=11)


@pytest.fixture(scope="module")
def sym_pair():
    src, dst = S.user_follow_graph(600, 4.0, seed=13)
    keep = src != dst
    return (JG.build_coo(src[keep], dst[keep], 600, symmetrize=True),
            TG.build_coo(src[keep], dst[keep], 600, symmetrize=True,
                         device=CPU))


@pytest.fixture(scope="module")
def digraph():
    src, dst = S.user_follow_graph(600, 4.0, seed=13)
    return TG.build_coo(src, dst, 600, device=CPU)


@pytest.fixture(scope="module")
def sym_graph(sym_pair):
    return sym_pair[1]


# ------------------------------------------------------------- two-hop

@pytest.mark.parametrize("cap", [1, 4, 16, None])
@pytest.mark.parametrize("dedup", [True, False])
def test_multi_account_pairs_match_reference(bipartite, cap, dedup):
    u, i = bipartite
    cap = cap or int(np.bincount(i).max())
    jp, jv, jc, _ = jth.multi_account_pairs(u, i, 400, 150,
                                            max_adjacent_nodes=cap,
                                            dedup=dedup)
    tp, tv, tc, ell = tth.multi_account_pairs(u, i, 400, 150,
                                              max_adjacent_nodes=cap,
                                              dedup=dedup, device=CPU)
    assert tp.dtype == torch.int32 and tv.dtype == torch.bool
    assert _bits(tp) == _bits(jp) and _bits(tv) == _bits(jv)
    assert int(tc) == int(jc)
    assert ell.max_degree == cap


def test_two_hop_equals_the_python_oracle(bipartite):
    u, i = bipartite
    cap = int(np.bincount(i).max())
    pairs, valid, count, _ = tth.multi_account_pairs(
        u, i, 400, 150, max_adjacent_nodes=cap, device=CPU)
    got = {(int(a), int(b)) for (a, b), ok in zip(pairs.numpy(),
                                                   valid.numpy()) if ok}
    want = tth.two_hop_reference(u, i, 400)
    assert got == want == jth.two_hop_reference(u, i, 400)
    assert int(count) == len(want)
    # the distinct pairs in sorted order, then the sentinel pairs
    kept = pairs.numpy()[valid.numpy()]
    assert [tuple(p) for p in kept.tolist()] == sorted(want)
    sent = (pairs.numpy() == np.iinfo(np.int32).max).all(axis=1)
    assert sent.any() and sent[np.argmax(sent):].all()


def test_two_hop_through_the_platform(bipartite):
    u, i = bipartite
    V = int(max(u.max(), i.max())) + 1
    jplat = JPlatform(JG.build_coo(u, i, V), local_max_degree=16)
    plat = GraphPlatform(TG.build_coo(u, i, V, device=CPU),
                         local_max_degree=16, device=CPU)
    for dedup in (True, False):
        q, jq = (GraphQuery.two_hop(400, dedup=dedup),
                 JQuery.two_hop(400, dedup=dedup))
        (tp, tv, tc), (jp, jv, jc) = plat.query(q).value, \
            jplat.query(jq).value
        assert _bits(tp) == _bits(jp) and _bits(tv) == _bits(jv)
        assert tc == jc and isinstance(tc, int)
    # count fast path: exact in-degrees, not the capped ELL rows
    got = plat.query(GraphQuery.two_hop(400, count_only=True)).value
    want = jplat.query(JQuery.two_hop(400, count_only=True)).value
    d = np.bincount(i, minlength=V).astype(np.int64)
    assert got == want == int((d * (d - 1) // 2).sum())
    assert got == plat.local.two_hop_count().value


def test_two_hop_count_upper_bound_is_int64():
    d = torch.tensor([50_000.0, 3.0, 0.0, 1.0])
    assert int(tth.two_hop_count_upper_bound(d)) == \
        50_000 * 49_999 // 2 + 3


# ------------------------------------------------- label propagation

@pytest.mark.parametrize("n_channels,self_weight", [(64, 1.0), (1, 0.0),
                                                    (3, 0.0), (17, 2.0)])
def test_label_propagation_matches_reference(sym_pair, n_channels,
                                             self_weight):
    jg, tg = sym_pair
    want, wi = jcm.label_propagation(jg, n_channels=n_channels,
                                     self_weight=self_weight)
    got, gi = tcm.label_propagation(tg, n_channels=n_channels,
                                    self_weight=self_weight)
    assert got.dtype == torch.int32
    assert _bits(got) == _bits(want) and int(gi) == int(wi)
    assert tcm.num_communities(got) == jcm.num_communities(want)


def test_lpa_channels_are_the_reference_hash():
    labels = np.array([0, 1, 2, 7, 99, 2**24 - 1, 123457, 5000000],
                      dtype=np.int32)
    for c in (1, 2, 7, 64, 1000):
        want = np.asarray(jcm._channel(np.asarray(labels), c))
        got = tcm._channel(torch.from_numpy(labels), c).numpy()
        assert got.tolist() == want.tolist()


def test_label_propagation_on_disjoint_cliques():
    """Ground-truth communities = connected components (disjoint
    cliques): LPA must produce exactly one label per clique."""
    es, ed, off = [], [], 0
    for size in [5, 9, 2, 14, 3, 7]:
        a, b = np.triu_indices(size, k=1)
        es.append(a + off)
        ed.append(b + off)
        off += size
    es, ed = np.concatenate(es), np.concatenate(ed)
    g = TG.build_coo(es, ed, off, symmetrize=True, device=CPU)
    labels, _ = tcm.label_propagation(g)
    labels = labels.numpy()
    comp = tcm.communities_reference(es, ed, off)
    comp_to_labels = {}
    for v in range(off):
        # labels are vertex ids and never cross component boundaries
        assert comp[labels[v]] == comp[v]
        comp_to_labels.setdefault(comp[v], set()).add(labels[v])
    assert all(len(ls) == 1 for ls in comp_to_labels.values())
    assert tcm.num_communities(torch.from_numpy(labels)) == 6


def test_label_propagation_deterministic(sym_graph):
    a, _ = tcm.label_propagation(sym_graph)
    b, _ = tcm.label_propagation(sym_graph)
    assert _bits(a) == _bits(b)


def test_label_propagation_rejects_directed_and_oversized_graphs():
    g = TG.build_coo(np.array([0, 1, 2]), np.array([1, 2, 0]), 3,
                     device=CPU)
    with pytest.raises(ValueError, match="symmetriz"):
        tcm.label_propagation(g)
    big = TG.GraphCOO(g.src, g.dst, g.w, 1 << 24, g.n_edges, True)
    with pytest.raises(ValueError, match="2\\^24"):
        tcm.label_propagation(big)


def test_local_and_distributed_engines_agree(sym_graph, digraph):
    lo_d, di_d = (LocalEngine(digraph, device=CPU),
                  DistributedEngine(digraph, n_data=4, device=CPU))
    lo_s, di_s = (LocalEngine(sym_graph, device=CPU),
                  DistributedEngine(sym_graph, n_data=4, device=CPU))
    assert _bits(lo_d.bfs([0, 3]).value) == _bits(di_d.bfs([0, 3]).value)
    assert _bits(lo_s.label_propagation().value) == \
        _bits(di_s.label_propagation().value)
    assert lo_s.triangle_count().value == di_s.triangle_count().value


def test_count_only_fast_paths(sym_graph):
    lo_s = LocalEngine(sym_graph, device=CPU)
    labels = lo_s.label_propagation().value.numpy()
    assert lo_s.num_communities().value == len(np.unique(labels))


def test_platform_routes_new_algorithms(sym_pair):
    jg, tg = sym_pair
    plat = GraphPlatform(tg, n_data=4, device=CPU)
    jplat = JPlatform(jg, n_data=4)
    queries = [(GraphQuery.bfs([0]), JQuery.bfs([0])),
               (GraphQuery.bfs([0], count_only=True),
                JQuery.bfs([0], count_only=True)),
               (GraphQuery.sssp(1), JQuery.sssp(1)),
               (GraphQuery.label_propagation(), JQuery.label_propagation()),
               (GraphQuery.label_propagation(count_only=True),
                JQuery.label_propagation(count_only=True)),
               (GraphQuery.triangle_count(), JQuery.triangle_count()),
               (GraphQuery.k_core(3), JQuery.k_core(3)),
               (GraphQuery.k_core(3, count_only=True),
                JQuery.k_core(3, count_only=True))]
    for q, jq in queries:
        r, jr = plat.query(q), jplat.query(jq)
        plan = r.meta["plan"]
        assert plan.engine == jr.meta["plan"].engine
        assert plan.est_local_s > 0 and plan.est_dist_s > 0
        if q.count_only or q.algorithm == "triangle_count":
            assert isinstance(r.value, int) and r.value == jr.value
        else:
            assert _bits(r.value) == _bits(jr.value)


# ------------------------------------------------------ similarity

@pytest.mark.parametrize("k", [1, 5, 32])
def test_similarity_matches_reference(k):
    import jax.numpy as jnp
    rng = np.random.default_rng(k)
    src, dst = S.user_follow_graph(300, 5.0, seed=k)
    jell = JG.build_ell(src, dst, 300, max_degree=k, direction="out")
    tell = TG.build_ell(src, dst, 300, max_degree=k, direction="out",
                        device=CPU)
    u = rng.integers(0, 300, 500)
    v = rng.integers(0, 300, 500)
    ju, jv = jnp.asarray(u, jnp.int32), jnp.asarray(v, jnp.int32)
    got_c = tsim.common_neighbors(tell, torch.from_numpy(u), v)
    assert got_c.dtype == torch.int32
    assert _bits(got_c) == _bits(jsim.common_neighbors(jell, ju, jv))
    assert _bits(tsim.jaccard_similarity(tell, u, v)) == \
        _bits(jsim.jaccard_similarity(jell, ju, jv))


def test_jaccard_against_a_set_oracle(sym_graph):
    plat = GraphPlatform(sym_graph, local_max_degree=8, device=CPU)
    rng = np.random.default_rng(0)
    u, v = rng.integers(0, 600, 200), rng.integers(0, 600, 200)
    got = plat.query(GraphQuery.of("jaccard", u=u, v=v)).value.numpy()
    ell = plat.local.ell
    nbr, mask = ell.nbr.numpy(), ell.mask.numpy()
    for k in range(200):
        a = set(nbr[u[k]][mask[u[k]]].tolist())
        b = set(nbr[v[k]][mask[v[k]]].tolist())
        want = len(a & b) / len(a | b) if a | b else 0.0
        assert got[k] == np.float32(want)


# ---------------------------------------------------------- legacy

def test_legacy_pipelines_match_reference(bipartite):
    u, i = bipartite
    for cap in (3, 100):
        assert tleg.legacy_multi_account(u, i, cap) == \
            jleg.legacy_multi_account(u, i, cap)
    sets = S.identifier_edge_sets(500, n_sets=3, seed=5)
    got = tleg.legacy_connected_users(sets, 500)
    assert got.dtype == np.int32
    assert got.tobytes() == jleg.legacy_connected_users(sets, 500).tobytes()


# ------------------------------------ mirrors of tests/test_system.py

@pytest.fixture(scope="module")
def follow_graph():
    return S.user_follow_graph(2000, 5.0, seed=7)


def test_platform_routes_and_answers_cc(follow_graph):
    src, dst = follow_graph
    g = TG.build_coo(src, dst, 2000, symmetrize=True, device=CPU)
    plat = GraphPlatform(g, n_data=4, device=CPU)
    r = plat.query(GraphQuery.connected_components())
    ref = tcc.connected_components_reference(src, dst, 2000)
    assert (r.value.numpy() == ref).all()
    assert r.engine == "local"          # medium graph -> local engine
    assert "plan" in r.meta


def test_count_only_fast_path(follow_graph):
    src, dst = follow_graph
    g = TG.build_coo(src, dst, 2000, symmetrize=True, device=CPU)
    plat = GraphPlatform(g, n_data=4, device=CPU)
    r = plat.query(GraphQuery.connected_components(count_only=True))
    ref = tcc.connected_components_reference(src, dst, 2000)
    assert r.value == len(np.unique(ref))


def test_multi_account_detection_end_to_end(bipartite):
    """Paper section IV-C-1: the motif expansion vs the legacy 3-step
    Scalding join must agree at uncapped degree."""
    u, i = bipartite
    maxdeg = int(np.bincount(i).max())
    ref = tth.two_hop_reference(u, i, 400)
    legacy = tleg.legacy_multi_account(u, i, max_adjacent_nodes=maxdeg)
    assert legacy == ref
    pairs, valid, count, _ = tth.multi_account_pairs(
        u, i, 400, 150, max_adjacent_nodes=maxdeg, device=CPU)
    got = {(int(p[0]), int(p[1]))
           for p, ok in zip(pairs.numpy(), valid.numpy()) if ok}
    assert got == ref
    assert int(count) == len(ref)


def test_combined_connected_users_vs_legacy():
    """Paper section IV-C-2: unified-graph CC == per-set legacy CC + merge."""
    sets = S.identifier_edge_sets(500, n_sets=3, seed=5)
    lab_legacy = tleg.legacy_connected_users(sets, 500)
    allsrc = np.concatenate([s for s, _ in sets])
    alldst = np.concatenate([d for _, d in sets])
    g = TG.build_coo(allsrc, alldst, 500, symmetrize=True, device=CPU)
    plat = GraphPlatform(g, device=CPU)
    r = plat.query(GraphQuery.connected_components())
    assert (r.value.numpy() == lab_legacy).all()


def test_unified_graph_merges_across_sets():
    """The unified graph merges components that per-set CC cannot."""
    sets = S.identifier_edge_sets(500, n_sets=3, seed=9)
    allsrc = np.concatenate([s for s, _ in sets])
    alldst = np.concatenate([d for _, d in sets])
    unified = tcc.connected_components_reference(allsrc, alldst, 500)
    first_only = tcc.connected_components_reference(sets[0][0], sets[0][1],
                                                    500)
    assert len(np.unique(unified)) <= len(np.unique(first_only))


def test_pagerank_against_networkx(follow_graph):
    networkx = pytest.importorskip("networkx")
    src, dst = follow_graph
    n = 2000
    g = TG.build_coo(src, dst, n, device=CPU)
    plat = GraphPlatform(g, device=CPU)
    r = plat.query(GraphQuery.pagerank(tol=1e-10, max_iters=200))
    gg = networkx.DiGraph()
    gg.add_nodes_from(range(n))
    gg.add_edges_from(zip(g.src[:g.n_edges].tolist(),
                          g.dst[:g.n_edges].tolist()))
    ref = networkx.pagerank(gg, alpha=0.85, tol=1e-10, max_iter=200)
    refv = np.array([ref[i] for i in range(n)])
    np.testing.assert_allclose(r.value.numpy(), refv, atol=1e-6)
