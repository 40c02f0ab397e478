"""Mirror of ``tests/test_service.py``: the service tier in the port
against the reference — fused batches, FIFO determinism, tiers and
admission, calibration-driven thresholds, the catalog and its shared
result cache, measured-stats feedback, and the regression cases.

Each case runs the reference test's body on both packages
(``torch_parity.both``), keeps its assertions, and records what the two
must agree on: every ticket's tier, plan and status, admission and
rejection decisions, execution logs, counters and result bytes.
Tolerance: none, but PageRank values within 1e-6.  ``count_calls``
counts ``Engine.run_superstep`` in each package apart.
"""
import dataclasses
from collections import OrderedDict

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_parity import (PORT, REF, Pair, approx, bits, both, edges,  # noqa: E402
                          pin_analytic, plan_rec, raised, result)

N = 260


@pytest.fixture(autouse=True)
def _analytic_calibration():
    pin_analytic()
    yield
    pin_analytic()


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


def _batch_service(M, graph, **add_kw):
    svc = M.GraphAnalyticsService(interactive_threshold_s=0.0)
    svc.add_graph("g", graph, **add_kw)
    return svc


@pytest.fixture()
def count_calls(monkeypatch):
    """``Engine.run_superstep`` calls, per package."""
    calls = Pair({M.name: {"n": 0} for M in (REF, PORT)})
    for M in (REF, PORT):
        real = M.Engine.run_superstep

        def counting(self, *a, _real=real, _c=calls[M.name], **kw):
            _c["n"] += 1
            return _real(self, *a, **kw)

        monkeypatch.setattr(M.Engine, "run_superstep", counting)
    return calls


def _tickets(svc, ts, tol=None):
    return [[t.ticket_id, t.tier, t.status, t.attempts, t.pool,
             plan_rec(t.plan), result(svc.result(t), tol=tol)] for t in ts]


# ------------------------------------------------------------ fused batches

@pytest.mark.parametrize("force_engine", ["local", "distributed"])
def test_fused_bfs_acceptance(graph, force_engine, count_calls):
    def case(M, graph, calls):
        svc = _batch_service(M, graph, n_data=4, force_engine=force_engine)
        sources = [(0,), (5,), (9,), (17,), (42,)]
        tickets = [svc.submit("g", M.GraphQuery.bfs(s)) for s in sources]
        assert all(t.tier == "batch" for t in tickets)
        calls["n"] = 0
        svc.drain()
        assert calls["n"] == 1
        solo = M.GraphPlatform(graph, n_data=4, force_engine=force_engine)
        for t in tickets:
            r = svc.result(t)
            assert r.engine == force_engine
            assert r.meta["fused"]["batch_size"] == len(sources)
            assert r.meta["fused"]["pregel_calls"] == 1
            assert bits(r.value) == bits(solo.query(t.query).value)
        assert svc.stats["fused_batches"] == 1
        assert svc.stats["fused_tickets"] == len(sources)
        return [_tickets(svc, tickets), dict(svc.stats), calls["n"]]
    both(case, graph, count_calls)


@pytest.mark.parametrize("force_engine", ["local", "distributed"])
def test_fused_sssp_parity(graph, force_engine):
    def case(M, graph):
        svc = _batch_service(M, graph, n_data=4, force_engine=force_engine)
        tickets = [svc.submit("g", M.GraphQuery.sssp(s))
                   for s in (0, 3, 7, 31)]
        svc.drain()
        solo = M.GraphPlatform(graph, n_data=4, force_engine=force_engine)
        for t in tickets:
            r = svc.result(t)
            assert r.meta["fused"]["batch_size"] == 4
            assert bits(r.value) == bits(solo.query(t.query).value)
        return _tickets(svc, tickets)
    both(case, graph)


def test_fused_jaccard_parity(graph):
    def case(M, graph):
        svc = _batch_service(M, graph)
        queries = [M.GraphQuery.of("jaccard", u=[0, 1], v=[2, 3]),
                   M.GraphQuery.of("jaccard", u=[5], v=[9]),
                   M.GraphQuery.of("jaccard", u=[10, 11, 12],
                                   v=[13, 14, 15])]
        tickets = [svc.submit("g", q) for q in queries]
        svc.drain()
        solo = M.GraphPlatform(graph)
        for t in tickets:
            r = svc.result(t)
            assert r.meta["fused"]["batch_size"] == 3
            assert r.meta["fused"]["kernel_calls"] == 1
            assert bits(r.value) == bits(solo.query(t.query).value)
        return _tickets(svc, tickets)
    both(case, graph)


def test_fused_count_only_applies_reducer(graph):
    def case(M, graph):
        svc = _batch_service(M, graph)
        t_full = svc.submit("g", M.GraphQuery.bfs([0]))
        t_count = svc.submit("g", M.GraphQuery.bfs([3], count_only=True))
        svc.drain()
        assert svc.result(t_full).meta["fused"]["batch_size"] == 2
        solo = M.GraphPlatform(graph)
        want = solo.query(M.GraphQuery.bfs([3], count_only=True)).value
        assert svc.result(t_count).value == want
        return [_tickets(svc, [t_full, t_count]), want]
    both(case, graph)


def test_fuse_key_separates_incompatible_queries(graph, count_calls):
    def case(M, graph, calls):
        svc = _batch_service(M, graph)
        a = [svc.submit("g", M.GraphQuery.bfs([s])) for s in (0, 1)]
        b = [svc.submit("g", M.GraphQuery.bfs([s], max_iters=2))
             for s in (2, 3)]
        calls["n"] = 0
        svc.drain()
        assert calls["n"] == 2
        assert svc.result(a[0]).meta["fused"]["batch_size"] == 2
        assert svc.result(b[0]).meta["fused"]["batch_size"] == 2
        assert svc.stats["fused_batches"] == 2
        return [_tickets(svc, a + b), dict(svc.stats), calls["n"]]
    both(case, graph, count_calls)


def test_fusion_never_crosses_graphs(graph, sym_graph):
    def case(M, graph, sym_graph):
        svc = M.GraphAnalyticsService(interactive_threshold_s=0.0)
        svc.add_graph("a", graph)
        svc.add_graph("b", sym_graph)
        ta = [svc.submit("a", M.GraphQuery.bfs([s])) for s in (0, 1)]
        tb = [svc.submit("b", M.GraphQuery.bfs([s])) for s in (0, 1)]
        svc.drain()
        assert svc.result(ta[0]).meta["fused"]["batch_size"] == 2
        assert svc.result(tb[0]).meta["fused"]["batch_size"] == 2
        assert svc.stats["fused_batches"] == 2
        solo_b = M.GraphPlatform(sym_graph)
        assert bits(svc.result(tb[1]).value) == \
            bits(solo_b.query(tb[1].query).value)
        return [_tickets(svc, ta + tb), dict(svc.stats)]
    both(case, graph, sym_graph)


# ------------------------------------------------------- FIFO determinism

def _run_mixed(M, graph):
    svc = M.GraphAnalyticsService(interactive_threshold_s=0.0)
    svc.add_graph("g", graph, n_data=4)
    Q = M.GraphQuery
    svc.submit("g", Q.bfs([0]))
    svc.submit("g", Q.pagerank(max_iters=5))
    svc.submit("g", Q.of("jaccard", u=[0], v=[1]))
    svc.submit("g", Q.bfs([7]))
    svc.submit("g", Q.sssp(2))
    svc.submit("g", Q.sssp(9))
    svc.drain()
    return [(e["algorithm"], tuple(e["tickets"]), e["fused"])
            for e in svc.execution_log]


def test_fifo_deterministic_and_fuses_across_queue(graph):
    def case(M, graph):
        log1, log2 = _run_mixed(M, graph), _run_mixed(M, graph)
        assert log1 == log2
        heads = [t[1][0] for t in log1]
        assert heads == sorted(heads)
        by_algo = {t[0]: t for t in log1}
        assert by_algo["bfs"] == ("bfs", (0, 3), True)
        assert by_algo["sssp"] == ("sssp", (4, 5), True)
        assert by_algo["pagerank"][2] is False
        return log1
    both(case, graph)


# ------------------------------------------------- tiers, bypass, admission

def test_interactive_bypasses_batch_queue(graph):
    def case(M, graph):
        try:
            M.P.set_calibration(M.P.CalibrationProfile(
                algo_time_scale={"pagerank": 1e9}))
            svc = M.GraphAnalyticsService(interactive_threshold_s=1e-2)
            svc.add_graph("g", graph)
            batch_t = svc.submit("g", M.GraphQuery.pagerank(max_iters=5))
            assert batch_t.tier == "batch"
            quick = svc.submit("g", M.GraphQuery.degree_stats())
            assert quick.tier == "interactive"
            r = svc.result(quick)
            assert r.value is not None
            assert batch_t.status == "queued"
            pending = [t.ticket_id for t in svc.pending()]
            assert pending == [batch_t.ticket_id]
            svc.drain()
            assert batch_t.status == "done"
            return [result(r), pending, plan_rec(batch_t.plan),
                    approx(svc.result(batch_t).value, 1e-6)]
        finally:
            M.P.set_calibration(None)
    both(case, graph)


def test_tier_classification_follows_threshold(graph):
    def case(M, graph):
        lo = M.GraphAnalyticsService(interactive_threshold_s=0.0)
        hi = M.GraphAnalyticsService(interactive_threshold_s=1e9)
        lo.add_graph("g", graph)
        hi.add_graph("g", graph)
        q = M.GraphQuery.degree_stats()
        tiers = [lo.submit("g", q).tier, hi.submit("g", q).tier]
        assert tiers == ["batch", "interactive"]
        return tiers
    both(case, graph)


def test_admission_rejection_carries_plan(graph):
    def case(M, graph):
        svc = M.GraphAnalyticsService(admission_budget_s=1e-12)
        svc.add_graph("g", graph)
        with pytest.raises(M.AdmissionRejected) as exc:
            svc.submit("g", M.GraphQuery.pagerank())
        e = exc.value
        assert isinstance(e.plan, M.P.Plan)
        assert e.plan.engine in ("local", "distributed")
        assert e.est_s == M.P.plan_cost(e.plan)
        assert e.budget_s == 1e-12
        assert e.query.algorithm == "pagerank"
        assert svc.stats["rejected"] == 1 and svc.stats["submitted"] == 0
        assert not svc.pending()
        return [plan_rec(e.plan), e.est_s, e.budget_s, dict(svc.stats)]
    both(case, graph)


def test_thresholds_follow_active_calibration_profile(graph, tmp_path):
    def case(M, graph):
        svc = M.GraphAnalyticsService()
        svc.add_graph("g", graph)
        path = tmp_path / f"{M.name}.json"
        try:
            M.P.CalibrationProfile(interactive_threshold_s=123.0,
                                   admission_budget_s=456.0).to_json(path)
            M.P.load_calibration(path)
            got = [svc.interactive_threshold_s, svc.admission_budget_s]
            assert got == [123.0, 456.0]
        finally:
            M.P.set_calibration(None)
        assert svc.interactive_threshold_s == \
            M.P.CalibrationProfile().interactive_threshold_s
        return [got, svc.interactive_threshold_s, path.read_text()]
    both(case, graph)


# ------------------------------------------------ catalog + result cache

def test_catalog_digest_dedup_shares_context(graph):
    def case(M, graph):
        svc = M.GraphAnalyticsService()
        svc.add_graph("a", graph)
        reload_ = M.G.GraphCOO(graph.src, graph.dst, graph.w,
                               graph.n_vertices, graph.n_edges,
                               graph.symmetric)
        svc.add_graph("b", reload_)
        assert svc.context("a") is svc.context("b")
        svc.add_graph("c", graph, n_data=4)
        assert svc.context("c") is not svc.context("a")
        return [svc.graph_names(), graph.content_digest(),
                reload_.content_digest()]
    both(case, graph)


def test_shared_result_cache_across_snapshot_names(graph):
    def case(M, graph):
        svc = M.GraphAnalyticsService()
        svc.add_graph("a", graph)
        svc.add_graph("c", graph, n_data=4)
        q = M.GraphQuery.connected_components(count_only=True) \
            if graph.symmetric else M.GraphQuery.pagerank(max_iters=10)
        r1 = svc.call("a", q)
        assert svc.cache_stats == {"hits": 0, "misses": 1}
        r2 = svc.call("c", q)
        assert r2.meta.get("cache") == "hit"
        assert bits(r2.value) == bits(r1.value)
        assert svc.context("c")._local is None
        return [result(r1, tol=1e-6), result(r2, tol=1e-6),
                svc.cache_stats]
    both(case, graph)


def test_fused_batch_results_enter_shared_cache(graph):
    def case(M, graph):
        svc = _batch_service(M, graph)
        tickets = [svc.submit("g", M.GraphQuery.bfs([s]))
                   for s in (0, 5, 9, 17)]
        svc.drain()
        runs_before = svc.context("g").local.n_runs
        r = svc.call("g", M.GraphQuery.bfs([5]))
        assert r.meta.get("cache") == "hit"
        assert bits(r.value) == bits(svc.result(tickets[1]).value)
        t_again = svc.submit("g", M.GraphQuery.bfs([9]))
        svc.drain()
        assert svc.result(t_again).meta.get("cache") == "hit"
        assert svc.context("g").local.n_runs == runs_before
        return [_tickets(svc, tickets + [t_again]), result(r), runs_before]
    both(case, graph)


def test_ticket_result_is_reusable(graph):
    def case(M, graph):
        svc = _batch_service(M, graph)
        t = svc.submit("g", M.GraphQuery.bfs([0]))
        r1 = svc.result(t)
        r2 = svc.result(t)
        assert r1 is r2
        assert isinstance(t, M.QueryTicket) and t.status == "done"
        return _tickets(svc, [t])
    both(case, graph)


def test_unknown_graph_name_raises(graph):
    def case(M, graph):
        svc = M.GraphAnalyticsService()
        with pytest.raises(KeyError, match="catalog"):
            svc.submit("nope", M.GraphQuery.degree_stats())
        return raised(svc.submit, "nope", M.GraphQuery.degree_stats())
    both(case, graph)


# ------------------------------------------------- measured-stats feedback

def test_measured_oriented_width_reaches_triangle_cost(sym_graph):
    def case(M, sym_graph):
        plat = M.GraphPlatform(sym_graph)
        assert plat.stats.oriented_width is None
        analytic = {s.variant: s
                    for s in M.P.specs_for("triangle_count", plat.stats)}
        plat.local.run("triangle_count", variant="intersect")
        width = plat.local.oriented.max_out_degree
        stats = plat.stats
        assert stats.oriented_width == width
        measured = {s.variant: s
                    for s in M.P.specs_for("triangle_count", stats)}
        assert measured["intersect"].state_bytes_per_vertex == 4.0 * width
        assert measured["intersect"].state_bytes_per_vertex != \
            analytic["intersect"].state_bytes_per_vertex
        plan = plat.plan(M.GraphQuery.triangle_count())
        assert plan.variant in ("bitset", "intersect")
        return [width, stats, analytic, measured, plan_rec(plan)]
    both(case, sym_graph)


def test_max_degree_measured_from_ell_build(graph):
    def case(M, graph):
        plat = M.GraphPlatform(graph)
        _ = plat.local.ell
        want = int(np.bincount(edges(graph)[1],
                               minlength=graph.n_vertices).max())
        assert plat.stats.max_degree == want
        return plat.stats
    both(case, graph)


def test_with_measurements_rejects_unknown_fields():
    def case(M):
        s = M.P.GraphStats(10, 20, 240)
        with pytest.raises(ValueError, match="unknown measurement"):
            s.with_measurements({"bogus": 1})
        assert dataclasses.replace(s) == s.with_measurements({})
        return [raised(s.with_measurements, {"bogus": 1}),
                s.with_measurements({"max_degree": 3, "oriented_width": None})]
    both(case)


# ------------------------------------------------- engine-free cache key

def test_result_cache_key_is_engine_free(graph):
    def case(M, graph):
        shared = OrderedDict()
        p_local = M.GraphPlatform(graph, result_cache=shared)
        q = M.GraphQuery.pagerank(max_iters=8)
        first = p_local.query(q)
        assert first.engine == "local"
        p_forced = M.GraphPlatform(graph, n_data=4,
                                   force_engine="distributed",
                                   result_cache=shared)
        r = p_forced.query(q)
        assert r.meta.get("cache") == "hit"
        assert bits(r.value) == bits(first.value)
        assert p_forced._dist is None
        return [result(first, tol=1e-6), result(r, tol=1e-6)]
    both(case, graph)


# -------------------------------------------------------- regression cases

def test_calibration_change_invalidates_cached_plans(graph):
    def case(M, graph):
        plat = M.GraphPlatform(graph)
        q = M.GraphQuery.pagerank(max_iters=5)
        p1 = plat.plan(q)
        try:
            M.P.set_calibration(M.P.CalibrationProfile(
                algo_time_scale={"pagerank": 1e6}))
            p2 = plat.plan(q)
            assert p2.est_local_s == pytest.approx(p1.est_local_s * 1e6)
        finally:
            M.P.set_calibration(None)
        p3 = plat.plan(q)
        assert p3.est_local_s == pytest.approx(p1.est_local_s)
        return [plan_rec(p) for p in (p1, p2, p3)]
    both(case, graph)


def test_stale_plan_cannot_dodge_admission_after_recalibration(graph):
    def case(M, graph):
        svc = M.GraphAnalyticsService(interactive_threshold_s=0.0)
        svc.add_graph("g", graph)
        t = svc.submit("g", M.GraphQuery.bfs([0]))
        try:
            M.P.set_calibration(M.P.CalibrationProfile(
                algo_time_scale={"bfs": 1e12}, admission_budget_s=1.0))
            with pytest.raises(M.AdmissionRejected) as exc:
                svc.submit("g", M.GraphQuery.bfs([0]))
        finally:
            M.P.set_calibration(None)
        svc.drain()
        return [plan_rec(exc.value.plan), exc.value.est_s,
                _tickets(svc, [t]), dict(svc.stats)]
    both(case, graph)


def test_directly_constructed_query_fuses_safely(graph):
    def case(M, graph):
        svc = _batch_service(M, graph)
        t_raw = svc.submit("g", M.GraphQuery("bfs", params={"sources": (0,)}))
        t_of = svc.submit("g", M.GraphQuery.bfs([1]))
        svc.drain()
        assert svc.result(t_raw).meta["fused"]["batch_size"] == 2
        solo = M.GraphPlatform(graph)
        assert bits(svc.result(t_raw).value) == \
            bits(solo.query(M.GraphQuery.bfs([0])).value)
        assert bits(svc.result(t_of).value) == \
            bits(solo.query(M.GraphQuery.bfs([1])).value)
        return _tickets(svc, [t_raw, t_of])
    both(case, graph)


def test_plan_cache_disabled_with_cache_size_zero(graph):
    def case(M, graph):
        plat = M.GraphPlatform(graph, cache_size=0)
        q = M.GraphQuery.pagerank()
        a, b = plat.plan(q), plat.plan(q)
        assert a is not b
        return [plan_rec(a), plan_rec(b)]
    both(case, graph)


def test_foreign_ticket_rejected(graph):
    def case(M, graph):
        svc_a = _batch_service(M, graph)
        svc_b = _batch_service(M, graph)
        t = svc_a.submit("g", M.GraphQuery.bfs([0]))
        svc_b.submit("g", M.GraphQuery.degree_stats())
        with pytest.raises(ValueError, match="not issued by this service"):
            svc_b.result(t)
        return raised(svc_b.result, t)
    both(case, graph)


def test_remove_graph_releases_context(graph):
    def case(M, graph):
        svc = M.GraphAnalyticsService()
        svc.add_graph("a", graph)
        svc.add_graph("b", graph)
        ctx = svc.context("a")
        svc.remove_graph("a")
        names = list(svc.graph_names())
        assert "a" not in names
        assert svc.context("b") is ctx
        assert svc._by_digest
        svc.remove_graph("b")
        assert not svc._by_digest
        with pytest.raises(KeyError):
            svc.context("b")
        svc.remove_graph("never-added")
        return [names, list(svc.graph_names()), raised(svc.context, "b")]
    both(case, graph)


def test_pending_tickets_survive_remove_and_rebind(graph, sym_graph):
    def case(M, graph, sym_graph):
        svc = _batch_service(M, graph)
        t = svc.submit("g", M.GraphQuery.bfs([0]))
        svc.remove_graph("g")
        svc.drain()
        solo = M.GraphPlatform(graph)
        assert bits(svc.result(t).value) == \
            bits(solo.query(M.GraphQuery.bfs([0])).value)
        svc2 = _batch_service(M, graph)
        t2 = svc2.submit("g", M.GraphQuery.bfs([0], count_only=True))
        svc2.add_graph("g", sym_graph)
        svc2.drain()
        want2 = solo.query(M.GraphQuery.bfs([0], count_only=True)).value
        assert svc2.result(t2).value == want2
        t3 = svc2.submit("g", M.GraphQuery.bfs([0], count_only=True))
        svc2.drain()
        want3 = M.GraphPlatform(sym_graph).query(
            M.GraphQuery.bfs([0], count_only=True)).value
        assert svc2.result(t3).value == want3
        return [_tickets(svc, [t]), _tickets(svc2, [t2, t3]), want2, want3]
    both(case, graph, sym_graph)


def test_failing_execution_fails_ticket_not_drain(graph):
    def case(M, graph):
        svc = _batch_service(M, graph)
        bad = svc.submit("g", M.GraphQuery("bfs", params={}))
        good = svc.submit("g", M.GraphQuery.bfs([1]))
        finished = svc.drain()
        assert {t.ticket_id for t in finished} == {bad.ticket_id,
                                                   good.ticket_id}
        assert bad.status == "dead-letter" and good.status == "done"
        assert bad.attempts == 1
        assert svc.stats["failed"] == 1 and svc.stats["dead_letters"] == 1
        assert not svc.pending()
        with pytest.raises(ValueError, match="missing required parameter"):
            svc.result(bad)
        solo = M.GraphPlatform(graph)
        assert bits(svc.result(good).value) == \
            bits(solo.query(M.GraphQuery.bfs([1])).value)
        return [[bad.status, bad.attempts, good.status],
                _tickets(svc, [good]), dict(svc.stats),
                raised(svc.result, bad)]
    both(case, graph)


def test_infeasible_plan_rejected_even_under_infinite_budget(graph):
    def case(M, graph):
        try:
            M.P.set_calibration(M.P.CalibrationProfile(local_mem_budget=0.0))
            svc = M.GraphAnalyticsService()
            svc.add_graph("g", graph)
            with pytest.raises(M.AdmissionRejected) as exc:
                svc.submit("g", M.GraphQuery.of("jaccard", u=[0], v=[1]))
            assert exc.value.est_s == float("inf")
            return [plan_rec(exc.value.plan), exc.value.est_s,
                    dict(svc.stats)]
        finally:
            M.P.set_calibration(None)
    both(case, graph)


def test_cache_hit_does_not_replay_fused_meta(graph):
    def case(M, graph):
        svc = _batch_service(M, graph)
        tickets = [svc.submit("g", M.GraphQuery.bfs([s])) for s in (0, 5)]
        svc.drain()
        assert svc.result(tickets[0]).meta["fused"]["batch_size"] == 2
        hit = svc.call("g", M.GraphQuery.bfs([0]))
        assert hit.meta.get("cache") == "hit"
        assert "fused" not in hit.meta
        return [_tickets(svc, tickets), result(hit)]
    both(case, graph)


def test_resolved_ticket_history_is_bounded(graph):
    def case(M, graph):
        svc = M.GraphAnalyticsService(interactive_threshold_s=0.0,
                                      cache_size=0, history_size=2)
        svc.add_graph("g", graph)
        ts = [svc.submit("g", M.GraphQuery.bfs([s], count_only=True))
              for s in (0, 1, 2)]
        svc.drain()
        assert len(svc._tickets) == 2 and len(svc._results) == 2
        with pytest.raises(ValueError, match="aged out"):
            svc.result(ts[0])
        newest = svc.result(ts[2])
        assert newest.value is not None
        return [sorted(svc._tickets), result(newest),
                raised(svc.result, ts[0])]
    both(case, graph)


def test_direct_engine_variant_selection_uses_measurements(sym_graph):
    def case(M, sym_graph):
        narrow = M.LocalEngine(sym_graph)
        narrow._measured["oriented_width"] = 1
        r1 = narrow.run("triangle_count")
        assert r1.meta["variant"] == "intersect"
        wide = M.LocalEngine(sym_graph)
        wide._measured["oriented_width"] = 10**6
        r2 = wide.run("triangle_count")
        assert r2.meta["variant"] == "bitset"
        return [result(r1), result(r2)]
    both(case, sym_graph)


# ------------------------------------------------- batched_spec contract

def test_batched_spec_rejects_structured_messages():
    def case(M):
        structured = M.PR.PregelSpec(
            message=lambda s, w: s, combine=(("sum", 1), ("min", 1)),
            apply=lambda old, agg, ids, gval: agg, identity=(0.0, 0.0))
        with pytest.raises(ValueError, match="batch axis"):
            M.PR.batched_spec(structured)
        return raised(M.PR.batched_spec, structured)
    both(case)


def test_batched_spec_memoized():
    def case(M):
        spec = M.alg("traversal")._BFS_SPEC
        assert M.PR.batched_spec(spec) is M.PR.batched_spec(spec)
        return True
    both(case)
