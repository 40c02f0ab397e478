"""Mirror of ``tests/test_incremental.py``: snapshot deltas and
warm-started fixpoints in the port against the reference —
``GraphCOO.apply_delta`` (canonical digests, lineage, validation), the
``SnapshotStore``'s delta partitions, the time-versioned catalog
(``add_snapshot`` / ``as_of``), seeded repairs and warm starts, the
planner's incremental-vs-full pricing and the ``metrics()`` counters.

Each case runs the reference test's body on both packages
(``torch_parity.both``), keeps its assertions, and records what the two
must agree on: digests, lineage, delta manifests, every result's bytes,
mode and iteration count, plans and the incremental counters.
Tolerance: none, but PageRank and HITS values within 1e-4 (the
reference test's own bound, warm against cold) across packages.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from torch_parity import (Pair, bits, both, edges, host,  # noqa: E402
                          pin_analytic, plan_rec, raised, result, unclocked)

N = 240


@pytest.fixture(autouse=True)
def _analytic_calibration():
    pin_analytic()
    yield
    pin_analytic()


def _edges(n, m, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, m), rng.integers(0, n, m)], axis=1)


@pytest.fixture(scope="module")
def graph():
    def build(M):
        src, dst = M.S.user_follow_graph(N, 4.0, seed=11)
        return M.build_coo(src, dst, N)
    return Pair.build(build)


@pytest.fixture(scope="module")
def sym_graph():
    def build(M):
        src, dst = M.S.user_follow_graph(N, 4.0, seed=11)
        keep = src != dst
        return M.build_coo(src[keep], dst[keep], N, symmetrize=True)
    return Pair.build(build)


def _coo_rec(g):
    s, d, w = edges(g)
    return [g.content_digest(), g.n_vertices, g.n_edges, g.symmetric,
            s, d, w]


def _delta_rec(d):
    return [d.n_added, d.n_removed, host(d.touched), d.nbytes()]


# ---------------------------------------------------------------------------
# GraphCOO.apply_delta: canonicalization and lineage
# ---------------------------------------------------------------------------

def test_apply_delta_digest_matches_scratch_build(graph):
    def case(M, graph):
        added = np.array([[1, 7], [7, 1], [3, 9]])
        src, dst, w = edges(graph)
        removed = np.stack([src[:2], dst[:2]], axis=1)
        child = graph.apply_delta(added=added, removed=removed)
        src, dst = src.astype(np.int64), dst.astype(np.int64)
        key = src * (N + 1) + dst
        rem_key = removed[:, 0].astype(np.int64) * (N + 1) + removed[:, 1]
        keep = ~np.isin(key, rem_key)
        scratch = M.build_coo(
            np.concatenate([src[keep], added[:, 0]]),
            np.concatenate([dst[keep], added[:, 1]]), N,
            w=np.concatenate([w[keep], np.ones(added.shape[0], np.float32)]))
        assert child.content_digest() == scratch.content_digest()
        assert child.content_digest() != graph.content_digest()
        return [_coo_rec(child), _delta_rec(child.delta)]
    both(case, graph)


def test_apply_delta_symmetric_edits_both_directions(sym_graph):
    def case(M, sym_graph):
        child = sym_graph.apply_delta(added=[[2, 5]])
        src, dst, _ = edges(child)
        pairs = set(zip(src.tolist(), dst.tolist()))
        assert (2, 5) in pairs and (5, 2) in pairs
        assert child.symmetric
        return [_coo_rec(child), _delta_rec(child.delta)]
    both(case, sym_graph)


def test_apply_delta_records_lineage(graph):
    def case(M, graph):
        child = graph.apply_delta(added=[[0, 5]], removed=[[1, 2]])
        assert child.parent_digest == graph.content_digest()
        d = child.delta
        assert d.n_added == 1 and d.n_removed == 1 and d.nbytes() > 0
        assert host(d.touched).tolist() == sorted({0, 5, 1, 2})
        assert getattr(graph, "parent_digest", None) is None
        return [child.parent_digest, _delta_rec(d), host(d.added),
                host(d.removed), _coo_rec(child)]
    both(case, graph)


DELTA_ERRORS = {
    "added_endpoint": ("endpoints", lambda g: g.apply_delta(added=[[0, N]])),
    "removed_endpoint": ("endpoints",
                         lambda g: g.apply_delta(removed=[[-1, 0]])),
    "added_w_length": ("added_w", lambda g: g.apply_delta(
        added=[[0, 1], [1, 2]], added_w=[1.0])),
}


@pytest.mark.parametrize("name", sorted(DELTA_ERRORS))
def test_apply_delta_validates(graph, name):
    match, fn = DELTA_ERRORS[name]

    def case(M, graph):
        with pytest.raises(ValueError, match=match):
            fn(graph)
        return raised(fn, graph)
    both(case, graph)


def test_apply_delta_add_then_remove_roundtrips_digest(graph):
    def case(M, graph):
        src, dst, _ = edges(graph)
        existing = set(zip(src.tolist(), dst.tolist()))
        fresh = np.array([[u, v] for u, v in _edges(N, 40, seed=3).tolist()
                          if (u, v) not in existing][:10])
        assert fresh.shape[0] >= 3
        child = graph.apply_delta(added=fresh)
        back = child.apply_delta(removed=fresh)
        assert back.content_digest() == graph.content_digest()
        return [_coo_rec(child), _coo_rec(back)]
    both(case, graph)


# ---------------------------------------------------------------------------
# SnapshotStore delta partitions
# ---------------------------------------------------------------------------

def _delta(M, name, base, added, removed=None):
    removed = np.zeros((0, 2), np.int64) if removed is None else removed
    return M.SnapshotDelta(name, base, added[:, 0], added[:, 1],
                           removed[:, 0], removed[:, 1])


def test_snapshot_store_delta_roundtrip_and_manifest(tmp_path):
    def case(M):
        store = M.SnapshotStore(str(tmp_path / M.name))
        base = _edges(N, 60, seed=1)
        store.write(M.Snapshot("day0", base[:, 0], base[:, 1]))
        d1, d2 = _edges(N, 8, seed=2), _edges(N, 5, seed=3)
        store.write_delta(_delta(M, "day1", "day0", d1))
        store.write_delta(_delta(M, "day2", "day1", d2, removed=d1[:3]))
        rt = store.read_delta("day2")
        assert rt.base == "day1" and rt.n_added == 5 and rt.n_removed == 3
        man = store.manifest("day2")
        assert man == {"name": "day2", "base": "day0",
                       "deltas": ["day1", "day2"]}
        snap = store.resolve("day2")
        expect = np.concatenate([base, d1], axis=0)
        key = expect[:, 0] * (N + 1) + expect[:, 1]
        rem = d1[:3, 0] * (N + 1) + d1[:3, 1]
        expect = np.concatenate([expect[~np.isin(key, rem)], d2], axis=0)
        got = np.stack([snap.src, snap.dst], axis=1)
        assert np.array_equal(np.sort(got, axis=0), np.sort(expect, axis=0))
        assert store.list() == ["day0"]
        assert store.list_deltas() == ["day1", "day2"]
        return [man, [rt.name, rt.base, rt.added_src, rt.added_dst,
                      rt.removed_src, rt.removed_dst], snap.name, snap.src,
                snap.dst]
    both(case)


def test_snapshot_store_delta_errors(tmp_path):
    def case(M):
        store = M.SnapshotStore(str(tmp_path / M.name))
        out = []
        with pytest.raises(KeyError, match="available deltas"):
            store.read_delta("nope")
        out.append(raised(store.read_delta, "nope"))
        store.write_delta(_delta(M, "day1", "day0", _edges(N, 4, seed=4)))
        with pytest.raises(KeyError, match="day0"):
            store.manifest("day1")
        out.append(raised(store.manifest, "day1"))
        store.write(M.Snapshot("dayA", *_edges(N, 4, seed=5).T))
        store.write_delta(_delta(M, "c1", "c2", _edges(N, 2, seed=6)))
        store.write_delta(_delta(M, "c2", "c1", _edges(N, 2, seed=7)))
        with pytest.raises(KeyError, match="cycle"):
            store.manifest("c1")
        out.append(raised(store.manifest, "c1"))
        return out
    both(case)


# ---------------------------------------------------------------------------
# Time-versioned catalog
# ---------------------------------------------------------------------------

def _versioned_service(M, coo, added, **kw):
    svc = M.GraphAnalyticsService()
    svc.add_snapshot("g", coo, as_of="2026-08-01", **kw)
    svc.add_snapshot("g", as_of="2026-08-02", added=added, **kw)
    return svc


def test_add_snapshot_versioning_rules(graph):
    def case(M, graph):
        svc = M.GraphAnalyticsService()
        out = []
        with pytest.raises(ValueError, match="either a graph or a delta"):
            svc.add_snapshot("g")
        out.append(raised(svc.add_snapshot, "g"))
        with pytest.raises(KeyError, match="no base version"):
            svc.add_snapshot("g", added=[[0, 1]])
        out.append(raised(svc.add_snapshot, "g", added=[[0, 1]]))
        svc.add_snapshot("g", graph, as_of=3)
        with pytest.raises(ValueError, match="not both"):
            svc.add_snapshot("g", graph, added=[[0, 1]])
        with pytest.raises(ValueError, match="must advance"):
            svc.add_snapshot("g", graph, as_of=3)
        ctx = svc.add_snapshot("g", added=[[0, 1]])
        assert svc.snapshot_versions("g") == [3, 4]
        assert svc.context("g") is ctx
        return [out, svc.snapshot_versions("g"), ctx.coo.content_digest()]
    both(case, graph)


def test_context_as_of_resolution(graph):
    def case(M, graph):
        svc = _versioned_service(M, graph, added=[[0, 1]])
        old = svc.context("g", as_of="2026-08-01")
        mid = svc.context("g", as_of="2026-08-01T23:59")
        new = svc.context("g", as_of="2026-09-01")
        assert old is mid and old is not new
        assert new is svc.context("g")
        with pytest.raises(KeyError, match="no version"):
            svc.context("g", as_of="2025-01-01")
        svc.add_graph("plain", graph)
        with pytest.raises(KeyError, match="no time-versioned"):
            svc.context("plain", as_of="2026-08-01")
        return [old.coo.content_digest(), new.coo.content_digest(),
                svc.snapshot_versions("g")]
    both(case, graph)


# ---------------------------------------------------------------------------
# Parity: seeded execution is invisible in the answers
# ---------------------------------------------------------------------------

EXACT_QUERIES = {
    "connected_components": ("connected_components", {}),
    "bfs": ("bfs", {"sources": (0,)}),
    "sssp": ("sssp", {"source": 0}),
}


@pytest.mark.parametrize("alg", sorted(EXACT_QUERIES))
@pytest.mark.parametrize("force_engine", ["local", "distributed"])
def test_incremental_exact_parity(sym_graph, alg, force_engine):
    def case(M, sym_graph):
        q = M.GraphQuery.of(*EXACT_QUERIES[alg][:1],
                            **EXACT_QUERIES[alg][1])
        added = _edges(N, 6, seed=21)
        svc = _versioned_service(M, sym_graph, added,
                                 force_engine=force_engine)
        parent = svc.call("g", q, as_of="2026-08-01")
        r = svc.call("g", q)
        assert r.meta.get("mode") == "incremental"
        assert r.iterations <= parent.iterations
        ctx = svc.context("g")
        cold = ctx.engine(r.meta["plan"].engine).run(
            q.algorithm, q.params, variant=r.meta["plan"].variant)
        assert bits(r.value) == bits(cold.value)
        return [result(parent), result(r), result(cold),
                unclocked(svc.metrics()["incremental"])]
    both(case, sym_graph)


def test_incremental_kcore_parity_on_removal(sym_graph):
    def case(M, sym_graph):
        q = M.GraphQuery.of("k_core", k=2)
        src, dst, _ = edges(sym_graph)
        sel = src < dst
        removed = np.stack([src[sel][:5], dst[sel][:5]], axis=1)
        svc = M.GraphAnalyticsService()
        svc.add_snapshot("g", sym_graph, as_of=0)
        parent = svc.call("g", q)
        svc.add_snapshot("g", as_of=1, removed=removed)
        r = svc.call("g", q)
        assert r.meta.get("mode") == "incremental"
        ctx = svc.context("g")
        cold = ctx.engine(r.meta["plan"].engine).run(
            q.algorithm, q.params, variant=r.meta["plan"].variant)
        assert bits(r.value) == bits(cold.value)
        return [result(parent), result(r), result(cold)]
    both(case, sym_graph)


def test_incremental_declines_to_cold_without_parent_result(sym_graph):
    def case(M, sym_graph):
        svc = _versioned_service(M, sym_graph, added=[[0, 9]])
        r = svc.call("g", M.GraphQuery.of("connected_components"))
        assert r.meta.get("mode") is None
        assert svc.metrics()["incremental"]["incremental_runs"] == 0
        return [result(r), svc.metrics()["incremental"]]
    both(case, sym_graph)


WARM = {
    "pagerank": lambda v: [("ranks", v)],
    "hits": lambda v: [("hubs", v["hubs"]),
                       ("authorities", v["authorities"])],
}


@pytest.mark.parametrize("alg", sorted(WARM))
def test_warm_start_parity_and_fewer_iterations(graph, alg):
    def case(M, graph):
        q = M.GraphQuery.of(alg)
        svc = _versioned_service(M, graph, _edges(N, 1, seed=33))
        parent = svc.call("g", q, as_of="2026-08-01")
        r = svc.call("g", q)
        assert r.meta.get("mode") == "warm"
        ctx = svc.context("g")
        cold = ctx.engine(r.meta["plan"].engine).run(
            q.algorithm, q.params, variant=r.meta["plan"].variant)
        assert r.iterations < cold.iterations
        for name, warm_v in WARM[alg](r.value):
            cold_v = dict(WARM[alg](cold.value))[name]
            assert np.allclose(host(warm_v), host(cold_v), atol=1e-4), name
        return [result(parent, tol=1e-4), result(r, tol=1e-4),
                result(cold, tol=1e-4)]
    both(case, graph)


def test_warm_start_walks_past_unanswered_versions(graph):
    def case(M, graph):
        svc = M.GraphAnalyticsService()
        svc.add_snapshot("g", graph, as_of=0)
        q = M.GraphQuery.of("pagerank")
        svc.call("g", q)
        svc.add_snapshot("g", as_of=1, added=[[0, 3]])
        svc.add_snapshot("g", as_of=2, added=[[1, 4]])
        r = svc.call("g", q)
        assert r.meta.get("mode") == "warm"
        return result(r, tol=1e-4)
    both(case, graph)


# ---------------------------------------------------------------------------
# Planner pricing, submit path, pools, metrics
# ---------------------------------------------------------------------------

def test_plan_mode_crossover_small_vs_huge_delta(sym_graph):
    def case(M, sym_graph):
        q = M.GraphQuery.of("connected_components")
        svc = M.GraphAnalyticsService()
        svc.add_snapshot("g", sym_graph, as_of=0)
        svc.call("g", q)
        svc.add_snapshot("g", as_of=1, added=[[0, 7]])
        _, mode = svc._seed_for(svc.context("g"), q)
        assert mode == "incremental"
        plan = svc.context("g").plan(q, seed_mode=mode)
        full = svc.context("g").plan(q)
        assert plan.mode == "incremental"
        assert plan.est_s < M.P.plan_cost(full)
        assert "incremental repair" in plan.reason
        svc.add_snapshot("g", as_of=2, added=np.stack(
            [np.arange(N), np.roll(np.arange(N), 1)], axis=1))
        svc.call("g", q, as_of=1)
        _, mode2 = svc._seed_for(svc.context("g"), q)
        assert mode2 == "incremental"
        big = svc.context("g").plan(q, seed_mode=mode2)
        assert big.mode == "full"
        assert "full recompute beats incremental" in big.reason
        return [plan_rec(plan), plan_rec(full), plan_rec(big)]
    both(case, sym_graph)


def test_price_incremental_estimate_monotone_in_touched(graph):
    def case(M, graph):
        stats = M.P.GraphStats.of(graph)
        q = M.P.QuerySpec("connected_components", graph.n_vertices,
                          iterations=8, state_bytes_per_vertex=4.0)
        deltas = [M.G.GraphDelta(added=np.zeros((0, 2), np.int64),
                                 removed=np.zeros((0, 2), np.int64),
                                 touched=np.arange(k, dtype=np.int32))
                  for k in (2, 20, 200)]
        costs = [M.P.estimate_incremental_cost(stats, q, d) for d in deltas]
        full = M.P.full_traffic_cost(stats, q)
        assert costs == sorted(costs) and costs[0] < full
        return [costs, full]
    both(case, graph)


def test_submitted_seeded_ticket_never_fuses(sym_graph):
    def case(M, sym_graph):
        q = M.GraphQuery.of("bfs", sources=(0,))
        svc = _versioned_service(M, sym_graph, added=[[0, 9]])
        parent = svc.call("g", q, as_of="2026-08-01")
        t = svc.submit("g", q)
        assert t.plan.mode == "incremental"
        assert t.fuse_key is None and t.seed is not None
        r = svc.result(t)
        assert r.meta.get("mode") == "incremental"
        cold = svc.context("g").engine(t.plan.engine).run(
            q.algorithm, q.params, variant=t.plan.variant)
        assert bits(r.value) == bits(cold.value)
        assert r.iterations <= parent.iterations
        return [plan_rec(t.plan), t.tier, result(r), result(cold)]
    both(case, sym_graph)


def test_incremental_parity_under_two_pools(sym_graph):
    def case(M, sym_graph):
        ps = M.PL.PoolSet([M.PL.DevicePool("onprem"),
                           M.PL.DevicePool("cloud")])
        q = M.GraphQuery.of("connected_components")
        svc = M.GraphAnalyticsService(pools=ps)
        svc.add_snapshot("g", sym_graph, as_of=0, pools=["cloud"])
        svc.call("g", q)
        svc.add_snapshot("g", as_of=1, added=[[0, 9]], pools=["cloud"])
        r = svc.call("g", q)
        assert r.meta.get("mode") == "incremental"
        ctx = svc.context("g")
        cold = ctx.engine(r.meta["plan"].engine).run(
            q.algorithm, q.params, variant=r.meta["plan"].variant)
        assert bits(r.value) == bits(cold.value)
        return [result(r), result(cold),
                unclocked(svc.metrics()["pools"])]
    both(case, sym_graph)


def test_metrics_incremental_counters(graph, sym_graph):
    def case(M, graph, sym_graph):
        svc = M.GraphAnalyticsService()
        base = svc.metrics()["incremental"]
        assert base == {"warm_hits": 0, "incremental_runs": 0,
                        "iterations_saved": 0, "delta_bytes_applied": 0}
        svc.add_snapshot("cc", sym_graph, as_of=0)
        svc.add_snapshot("pr", graph, as_of=0)
        qc, qp = (M.GraphQuery.of("connected_components"),
                  M.GraphQuery.of("pagerank"))
        svc.call("cc", qc)
        svc.call("pr", qp)
        svc.add_snapshot("cc", as_of=1, added=[[0, 9]])
        svc.add_snapshot("pr", as_of=1, added=[[0, 9]])
        svc.call("cc", qc)
        svc.call("pr", qp)
        m = svc.metrics()["incremental"]
        assert m["incremental_runs"] == 1 and m["warm_hits"] == 1
        assert m["iterations_saved"] > 0 and m["delta_bytes_applied"] > 0
        return m
    both(case, graph, sym_graph)


@pytest.mark.parametrize("share", [0.001, 0.01])
def test_warm_start_supersteps_by_delta_size(share):
    """chip_smoke phase 13's PageRank scenario at 2^12 (user-follow graph,
    seed 5, symmetrized; an add-only delta of ``share`` of the edge set;
    phase 4's halt, L1 < 1e-5): the warm start's supersteps, and the cold
    run's, are the reference's.  The warm start saves supersteps on the
    0.1 % delta; on the 1 % one it takes more than a cold run in both
    packages (26 against 19 here)."""
    V = 2 ** 12

    def case(M):
        src, dst = M.S.user_follow_graph(V, 4.0, seed=5)
        keep = src != dst
        g = M.build_coo(src[keep], dst[keep], V, symmetrize=True)
        q = M.GraphQuery.of("pagerank", tol=1e-5 / V)
        rng = np.random.default_rng(23)
        n = int(g.n_edges * share)
        added = np.stack([rng.integers(0, V, n), rng.integers(0, V, n)],
                         axis=1)
        svc = M.GraphAnalyticsService()
        svc.add_snapshot("g", g, as_of=0)
        parent = svc.call("g", q)
        svc.add_snapshot("g", as_of=1, added=added)
        r = svc.call("g", q)
        cold = svc.context("g").engine("local").run("pagerank", q.params)
        assert r.meta.get("mode") == "warm"
        assert float(np.abs(host(r.value).astype(np.float64)
                            - host(cold.value)).sum()) < 1e-4
        if share <= 0.001:
            assert r.iterations < cold.iterations
        return [parent.iterations, r.iterations, cold.iterations,
                result(r, tol=1e-4), result(cold, tol=1e-4)]
    both(case)
