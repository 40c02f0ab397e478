"""Mirror of ``tests/test_service_runtime.py``: the concurrent service
runtime in the port against the reference — fault injection, retry and
dead-letter, backoff schedules, backpressure, the metrics snapshot and
the deterministic concurrency stress digests (scheduler, superstep
variants, federation spill, incremental lineage).

Each case runs the reference test's body on both packages
(``torch_parity.both``), keeps its assertions (a concurrent drain equals
the serial one, byte for byte, in each package), and records what the
two must agree on: ticket statuses and attempts, retry sleeps, counters,
backpressure decisions, metrics without wall times, plans, and every
ticket's value.  Tolerance: none, but PageRank and HITS within 1e-6
(their float sums run in another order in the port, so the stress
digests over their bytes are each package's own: each package's
concurrent drain must equal its serial one byte for byte, as in the
reference).  Timing assertions (the tier p50s, the overlapped drain)
are each package's own, as in the reference.
"""
import dataclasses
import hashlib
import importlib
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_parity import (PORT, REF, Pair, approx_tree, bits, both,  # noqa: E402
                          edges, pin_analytic, plan_rec, raised, result,
                          unclocked)

N = 300
FLAKY = "_rt_flaky"


@pytest.fixture(autouse=True)
def _analytic_calibration():
    pin_analytic()
    yield
    pin_analytic()


@pytest.fixture(scope="module")
def graph():
    def build(M):
        src, dst = M.S.user_follow_graph(N, 4.0, seed=7)
        return M.build_coo(src, dst, N)
    return Pair.build(build)


@pytest.fixture(scope="module")
def graph2():
    def build(M):
        src, dst = M.S.user_follow_graph(N, 3.0, seed=13)
        return M.build_coo(src, dst, N)
    return Pair.build(build)


@pytest.fixture()
def flaky_algorithm():
    for M in (REF, PORT):
        M.R.register(M.R.AlgorithmDef(
            name=FLAKY,
            run=lambda eng, tag=0: (np.arange(8, dtype=np.float64) + tag,
                                    None),
            params=(M.R.Param("tag", default=0),),
            engines=("local",),
            doc="runtime-harness flaky algorithm",
        ), replace=True)
    yield FLAKY
    for M in (REF, PORT):
        M.R.uninstall_fault(None)
        M.R.unregister(FLAKY)


def _service(M, graph, **kw):
    kw.setdefault("interactive_threshold_s", 0.0)
    kw.setdefault("retry", M.RetryPolicy(max_attempts=3, base_s=1e-4,
                                         cap_s=1e-3))
    svc = M.GraphAnalyticsService(**kw)
    svc.add_graph("g", graph, force_engine="local")
    return svc


def _status(ts):
    return [[t.ticket_id, t.status, t.attempts, t.tier, t.pool,
             plan_rec(t.plan)] for t in ts]


def _counters(svc):
    m = svc.metrics()
    return [m["counters"], m["retry"], m["queue_depths"]]


# ---------------------------------------------------------- fault injection

def test_retry_then_success_after_n_failures(graph, flaky_algorithm):
    def case(M, graph):
        svc = _service(M, graph)
        M.R.install_fault(FLAKY, M.R.FailNTimes(2))
        t = svc.submit("g", M.GraphQuery.of(FLAKY))
        svc.drain()
        assert t.status == "done" and t.attempts == 3
        r = svc.result(t)
        np.testing.assert_array_equal(np.asarray(r.value), np.arange(8.0))
        m = svc.metrics()
        assert m["counters"]["retries"] == 2
        assert m["counters"]["dead_letters"] == 0
        assert m["retry"]["max_attempts"] == 3
        return [_status([t]), result(r), _counters(svc)]
    both(case, graph)


def test_dead_letter_after_max_attempts(graph, flaky_algorithm):
    def case(M, graph):
        svc = _service(M, graph)
        M.R.install_fault(FLAKY, M.R.FailAlways())
        bad = svc.submit("g", M.GraphQuery.of(FLAKY))
        good = svc.submit("g", M.GraphQuery.bfs([1]))
        finished = svc.drain()
        assert {t.ticket_id for t in finished} == {bad.ticket_id,
                                                   good.ticket_id}
        assert bad.status == "dead-letter" and bad.attempts == 3
        assert good.status == "done"
        m = svc.metrics()
        assert m["counters"]["retries"] == 2
        assert m["counters"]["dead_letters"] == 1
        assert m["counters"]["failed"] == 1
        assert not svc.pending()
        return [_status([bad, good]), result(svc.result(good)),
                _counters(svc)]
    both(case, graph)


def test_exception_chain_preserved_through_result(graph, flaky_algorithm):
    def case(M, graph):
        svc = _service(M, graph)
        M.R.install_fault(FLAKY, M.R.FailAlways())
        t = svc.submit("g", M.GraphQuery.of(FLAKY))
        svc.drain()
        with pytest.raises(M.R.FaultInjected) as exc:
            svc.result(t)
        chain, e = [], exc.value
        while e is not None:
            chain.append(e)
            e = e.__cause__
        assert len(chain) == 3
        assert all(isinstance(e, M.R.FaultInjected) for e in chain)
        return [type(e).__name__ for e in chain]
    both(case, graph)


def test_flaky_success_is_cached_not_retried(graph, flaky_algorithm):
    def case(M, graph):
        svc = _service(M, graph)
        M.R.install_fault(FLAKY, M.R.FailNTimes(1))
        t1 = svc.submit("g", M.GraphQuery.of(FLAKY))
        svc.drain()
        assert t1.status == "done" and t1.attempts == 2
        M.R.install_fault(FLAKY, M.R.FailAlways())
        t2 = svc.submit("g", M.GraphQuery.of(FLAKY))
        svc.drain()
        assert t2.status == "done"
        assert svc.result(t2).meta.get("cache") == "hit"
        return [_status([t1, t2]), result(svc.result(t2)), _counters(svc)]
    both(case, graph)


def test_permanent_error_dead_letters_without_retry(graph):
    def case(M, graph):
        svc = _service(M, graph)
        t = svc.submit("g", M.GraphQuery("bfs", params={}))
        svc.drain()
        assert t.status == "dead-letter" and t.attempts == 1
        assert svc.metrics()["counters"]["retries"] == 0
        with pytest.raises(ValueError, match="missing required"):
            svc.result(t)
        return [_status([t]), _counters(svc), raised(svc.result, t)]
    both(case, graph)


def test_backoff_sleeps_follow_seeded_schedule(graph, flaky_algorithm,
                                               monkeypatch):
    # both services call the one ``time`` module's sleep: one recorder,
    # emptied as each package's case starts
    slept = []
    for M in (REF, PORT):
        service_mod = importlib.import_module(f"{M.name}.core.service")
        assert service_mod.time is time
    monkeypatch.setattr(time, "sleep", slept.append)

    def case(M, graph):
        slept.clear()
        pol = M.RetryPolicy(max_attempts=4, base_s=1e-3, cap_s=8e-3)
        svc = _service(M, graph, retry=pol, seed=42)
        M.R.install_fault(FLAKY, M.R.FailAlways())
        t = svc.submit("g", M.GraphQuery.of(FLAKY))
        svc.drain()
        assert t.status == "dead-letter"
        want = pol.schedule(42 * 1_000_003 + t.ticket_id)
        assert tuple(slept) == want
        assert len(slept) == pol.max_attempts - 1
        return [list(slept), want, pol.bounds()]
    both(case, graph)


def test_fused_group_dead_letters_as_a_unit(graph):
    def case(M, graph):
        calls = {"n": 0}

        def exploding_batch(eng, params_list):
            calls["n"] += 1
            raise RuntimeError("batch runner down")

        defn = M.R.get("bfs")
        M.R.register(dataclasses.replace(defn, batch_runner=exploding_batch),
                     replace=True)
        try:
            svc = _service(M, graph)
            ts = [svc.submit("g", M.GraphQuery.bfs([s])) for s in (0, 1, 2)]
            svc.drain()
            assert calls["n"] == svc.retry.max_attempts
            assert all(t.status == "dead-letter" for t in ts)
            assert all(t.error is ts[0].error for t in ts)
            assert svc.metrics()["counters"]["dead_letters"] == 3
            return [calls["n"], _status(ts), _counters(svc)]
        finally:
            M.R.register(defn, replace=True)
    both(case, graph)


# ------------------------------------------------------------- backpressure

def test_backpressure_typed_rejection_at_depth_budget(graph):
    def case(M, graph):
        svc = _service(M, graph, tier_depth={"batch": 2})
        svc.submit("g", M.GraphQuery.bfs([0]))
        svc.submit("g", M.GraphQuery.bfs([1]))
        with pytest.raises(M.Backpressure) as exc:
            svc.submit("g", M.GraphQuery.bfs([2]))
        e = exc.value
        assert (e.tier, e.depth, e.budget) == ("batch", 2, 2)
        assert e.query.algorithm == "bfs"
        m = svc.metrics()
        assert m["counters"]["backpressure"] == 1
        assert m["counters"]["submitted"] == 2
        before = _counters(svc)
        svc.drain()
        t = svc.submit("g", M.GraphQuery.bfs([2]))
        svc.drain()
        assert t.status == "done"
        return [[e.graph_name, e.engine, e.tier, e.depth, e.budget], before,
                _status([t]), _counters(svc)]
    both(case, graph)


def test_backpressure_budget_is_per_tier(graph):
    def case(M, graph):
        svc = M.GraphAnalyticsService(interactive_threshold_s=1e9,
                                      tier_depth={"batch": 0})
        svc.add_graph("g", graph)
        t = svc.submit("g", M.GraphQuery.degree_stats())
        assert t.tier == "interactive"
        svc.drain()
        assert t.status == "done"
        return [_status([t]), result(svc.result(t))]
    both(case, graph)


# ------------------------------------------------------------------ metrics

def test_metrics_snapshot_fields(graph):
    def case(M, graph):
        svc = _service(M, graph)
        tickets = [svc.submit("g", M.GraphQuery.bfs([s]))
                   for s in (0, 1, 2, 3)]
        m0 = svc.metrics()
        assert m0["queue_depths"]["local.batch"] == 4
        svc.drain()
        m = svc.metrics()
        assert all(d == 0 for d in m["queue_depths"].values())
        assert m["fusion"] == {**m["fusion"], "batches": 1, "tickets": 4,
                               "max_width": 4}
        lat = m["tier_latency_s"]["batch"]
        assert lat["count"] == len(tickets)
        assert lat["p50_s"] is not None and lat["p50_s"] <= lat["p99_s"]
        assert lat["buckets"]["le_inf"] == len(tickets)
        svc.submit("g", M.GraphQuery.bfs([0]))
        svc.drain()
        m2 = svc.metrics()
        assert m2["cache"]["hits"] >= 1 and m2["cache"]["hit_rate"] > 0
        return [m0["queue_depths"], m["fusion"], m["counters"],
                lat["count"], m2["cache"], _status(tickets)]
    both(case, graph)


# ------------------------------------------- deterministic concurrency

def _stress_services(M, graph, graph2, **kw):
    svc = M.GraphAnalyticsService(cache_size=64, **kw)
    svc.add_graph("local_g", graph, force_engine="local")
    svc.add_graph("dist_g", graph2, n_data=4, force_engine="distributed")
    return svc


def _stress_workload(M, n_tickets=100, seed=1234):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_tickets):
        name = ("local_g", "dist_g")[int(rng.integers(0, 2))]
        kind = int(rng.integers(0, 5))
        if kind == 0:
            q = M.GraphQuery.bfs([int(rng.integers(0, N))])
        elif kind == 1:
            q = M.GraphQuery.sssp(int(rng.integers(0, N)))
        elif kind == 2:
            q = M.GraphQuery.pagerank(max_iters=int(rng.integers(3, 8)))
        elif kind == 3:
            q = M.GraphQuery.degree_stats()
        else:
            q = M.GraphQuery.bfs([int(rng.integers(0, N))], count_only=True)
        out.append((name, q))
    return out


def _median_estimate(M, svc, workload):
    ests = [svc.context(name).plan(q) for name, q in workload]
    return float(np.median([M.P.plan_cost(p) for p in ests]))


def _run_stress(M, graph, graph2, workers, threshold):
    svc = _stress_services(M, graph, graph2,
                           interactive_threshold_s=threshold)
    tickets = [svc.submit(name, q) for name, q in _stress_workload(M)]
    tiers = {t.tier for t in tickets}
    svc.drain(workers=workers)
    per_ticket = {}
    for t in tickets:
        assert t.status == "done", (t.status, t.error)
        per_ticket[t.ticket_id] = bits(svc.result(t).value)
    return per_ticket, tiers, svc, tickets


def _values(svc, tickets):
    """Each ticket's value for the cross-package record: byte-equal,
    PageRank and HITS within 1e-6 (their float sums run in another
    order in the port, so their bytes, and the digests over them, are
    each package's own)."""
    return [approx_tree(svc.result(t).value, 1e-6)
            if t.query.algorithm in ("pagerank", "hits")
            else svc.result(t).value for t in tickets]


def test_stress_concurrent_drain_matches_serial(graph, graph2):
    def case(M, graph, graph2):
        probe = _stress_services(M, graph, graph2)
        threshold = _median_estimate(M, probe, _stress_workload(M))
        serial, tiers_s, svc_s, ts = _run_stress(M, graph, graph2, 1,
                                                threshold)
        conc, tiers_c, svc, _ = _run_stress(M, graph, graph2, 4, threshold)
        assert tiers_s == tiers_c == {"interactive", "batch"}
        assert serial.keys() == conc.keys() and serial == conc
        assert svc.metrics()["counters"]["executed"] > 0
        assert svc.metrics()["fusion"]["batches"] >= 1
        return [threshold, [(t.tier, plan_rec(t.plan)) for t in ts],
                _values(svc_s, ts)]
    both(case, graph, graph2)


def test_interactive_p50_beats_batch_under_slow_batch(graph, graph2):
    def case(M, graph, graph2):
        M.R.install_fault("pagerank", M.R.Delay(0.05))
        try:
            slow_qs = [M.GraphQuery.pagerank(max_iters=m)
                       for m in (50, 60, 70)]
            quick_qs = [M.GraphQuery.bfs([s], count_only=True)
                        for s in range(6)]
            probe = _stress_services(M, graph, graph2).context("local_g")
            hi = max(M.P.plan_cost(probe.plan(q)) for q in quick_qs)
            lo = min(M.P.plan_cost(probe.plan(q)) for q in slow_qs)
            assert hi < lo
            svc = _stress_services(M, graph, graph2,
                                   interactive_threshold_s=(hi + lo) / 2.0)
            slow = [svc.submit("local_g", q) for q in slow_qs]
            quick = [svc.submit("local_g", q) for q in quick_qs]
            assert all(t.tier == "batch" for t in slow)
            assert all(t.tier == "interactive" for t in quick)
            svc.drain(workers=2)
            m = svc.metrics()["tier_latency_s"]
            assert m["interactive"]["p50_s"] < m["batch"]["p50_s"]
            return [hi, lo, _status(slow + quick),
                    [bits(svc.result(t).value) for t in quick]]
        finally:
            M.R.uninstall_fault("pagerank")
    both(case, graph, graph2)


def test_concurrent_drain_overlaps_engines(graph, graph2):
    def case(M, graph, graph2):
        svc = _stress_services(M, graph, graph2, interactive_threshold_s=0.0)
        svc.call("local_g", M.GraphQuery.sssp(1))
        svc.call("dist_g", M.GraphQuery.sssp(1))
        M.R.install_fault("sssp", M.R.Delay(0.25))
        try:
            ts = [svc.submit("local_g", M.GraphQuery.sssp(0)),
                  svc.submit("dist_g", M.GraphQuery.sssp(0))]
            t0 = time.perf_counter()
            svc.drain(workers=2)
            wall = time.perf_counter() - t0
            assert wall < 0.45, wall
        finally:
            M.R.uninstall_fault("sssp")
        return [_status(ts), [bits(svc.result(t).value) for t in ts]]
    both(case, graph, graph2)


def test_result_awaits_inflight_ticket(graph, flaky_algorithm):
    def case(M, graph):
        M.R.install_fault(FLAKY, M.R.Delay(0.1))
        svc = _service(M, graph)
        t = svc.submit("g", M.GraphQuery.of(FLAKY))
        worker = threading.Thread(target=svc.drain)
        worker.start()
        r = svc.result(t)
        worker.join(timeout=60)
        assert not worker.is_alive()
        assert t.status == "done"
        assert svc.context("g").local.n_runs == 1
        np.testing.assert_array_equal(np.asarray(r.value), np.arange(8.0))
        return [_status([t]), result(r)]
    both(case, graph)


def test_superstep_variant_digest_parity(graph):
    def case(M, graph):
        s, d, _ = edges(graph)
        sym = M.build_coo(s, d, graph.n_vertices, symmetrize=True)
        engines = {False: M.LocalEngine(graph), True: M.LocalEngine(sym)}
        chunks = []
        for name, defn in sorted(M.R.items()):
            variants = sorted(defn.variants or ())
            if "frontier" not in variants:
                continue
            eng = engines[defn.requires_symmetric]
            params = dict(defn.example_params or {})
            outs = {v: bits(eng.run(defn, params, variant=v).value)
                    for v in variants}
            for v, b in outs.items():
                assert b == outs["dense"], (name, v)
            chunks.append(name.encode() + b":" + outs["dense"])
        assert chunks
        return hashlib.blake2b(b"|".join(chunks),
                               digest_size=16).hexdigest()
    both(case, graph)


def test_federation_spill_stress_digest(graph, graph2):
    def case(M, graph, graph2):
        def run(workers):
            svc = M.GraphAnalyticsService(
                pools=M.PL.PoolSet([
                    M.PL.DevicePool("onprem", capacity=2, max_inflight=2),
                    M.PL.DevicePool("cloud", capacity=32,
                                    compute_scale=1.0),
                ]),
                interactive_threshold_s=0.0, cache_size=64)
            svc.add_graph("g", graph)
            svc.add_graph("h", graph2)
            workload = _stress_workload(M, n_tickets=60, seed=99)
            tickets = [svc.submit(("g", "h")[name == "dist_g"], q)
                       for name, q in workload]
            spilled = svc.stats["spilled"]
            svc.drain(workers=workers)
            per = {}
            for t in tickets:
                assert t.status == "done", (t.status, t.error)
                per[t.ticket_id] = bits(svc.result(t).value)
            return per, spilled, [t.pool for t in tickets], \
                unclocked(svc.metrics()["pools"]), _values(svc, tickets)
        serial, spill_s, pools_s, pm_s, values = run(1)
        conc, spill_c, pools_c, _, _ = run(4)
        assert spill_s == spill_c > 0
        assert set(pools_s) == set(pools_c) == {"onprem", "cloud"}
        assert serial == conc
        return [spill_s, pools_s, pm_s, values]
    both(case, graph, graph2)


def test_incremental_lineage_stress_digest(graph):
    def case(M, graph):
        s, d, _ = edges(graph)
        sym = M.build_coo(s, d, graph.n_vertices, symmetrize=True)
        rng = np.random.default_rng(17)
        added = np.stack([rng.integers(0, N, 5), rng.integers(0, N, 5)],
                         axis=1)
        queries = [M.GraphQuery.of("connected_components"),
                   M.GraphQuery.of("bfs", sources=(0,)),
                   M.GraphQuery.of("pagerank"),
                   M.GraphQuery.of("hits")]

        def run(workers):
            svc = M.GraphAnalyticsService(cache_size=64)
            svc.add_snapshot("g", sym, as_of=0)
            for q in queries:
                svc.call("g", q, as_of=0)
            svc.add_snapshot("g", as_of=1, added=added)
            tickets = [svc.submit("g", q) for q in queries for _ in range(2)]
            seeded = sum(t.plan.mode != "full" for t in tickets)
            svc.drain(workers=workers)
            per = {}
            for t in tickets:
                assert t.status == "done", (t.status, t.error)
                per[t.ticket_id] = bits(svc.result(t).value)
            return per, seeded, svc.metrics()["incremental"], \
                [(t.plan.mode, t.plan.engine) for t in tickets], \
                _values(svc, tickets)
        serial, seeded_s, meter_s, modes, values = run(1)
        conc, seeded_c, meter_c, _, _ = run(4)
        assert seeded_s == seeded_c == len(serial)
        assert meter_s == meter_c
        assert meter_s["incremental_runs"] == 2 and meter_s["warm_hits"] == 2
        assert serial == conc
        return [meter_s, modes, values]
    both(case, graph)
