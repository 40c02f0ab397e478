"""Mirror of ``tests/test_obs.py``: end-to-end observability in the port
against the reference — span trees, the plan-candidate tables, the hard
lifecycles (retry, dead letter, fused groups, spill, cache hits),
superstep profiles, the Chrome trace export and its validator, the
metrics exposition, and the plan-accuracy meter that feeds calibration.

Each case runs the reference test's body on both packages
(``torch_parity.both``), keeps its assertions, and records what the two
must agree on: every span tree (names, ids, attributes and events, host
clock readings taken out), ``explain()`` with its numbers masked, the
exported trace's events without timestamps, counters and result bytes.
Tolerance: none.

The metrics-text mirror does not depend on host timing: after the
drain it gives each package the same latencies (chosen by the test,
some in the ``le_1e-02`` / ``le_1e+02`` buckets, whose metric names
collide in both packages: ROADMAP.md §3) and the same accuracy samples,
and holds the two expositions to one text; the reference's round trip
is asserted for every name but the colliding one, whose collision is
asserted as such.
"""
import math
import re

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_parity import (PORT, REF, Pair, bits, both, edges,  # noqa: E402
                          pin_analytic, plan_rec, raised, result, unclocked)

N = 200
FLAKY = "_obs_flaky"


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


@pytest.fixture()
def flaky_algorithm():
    for M in (REF, PORT):
        M.R.register(M.R.AlgorithmDef(
            name=FLAKY,
            run=lambda eng, tag=0: (np.arange(8, dtype=np.float64) + tag,
                                    None),
            params=(M.R.Param("tag", default=0),),
            engines=("local",),
            doc="observability-harness flaky algorithm",
        ), replace=True)
    yield FLAKY
    for M in (REF, PORT):
        M.R.uninstall_fault(None)
        M.R.unregister(FLAKY)


def _traced_service(M, graph, **kw):
    kw.setdefault("trace_depth", 32)
    svc = M.GraphAnalyticsService(**kw)
    svc.add_graph("g", graph)
    return svc


def span_rec(s):
    """A span tree without its host-clock readings."""
    return [s.span_id, s.name, unclocked(s.attrs),
            [(name, unclocked(attrs)) for _, name, attrs in s.events],
            [span_rec(c) for c in s.children]]


_NUMBER = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?|-?\d+e[-+]?\d+")


def explained(svc, t):
    """``explain()`` with every decimal number masked (wall times) and
    the port's own ``realized_variant`` attribute left out."""
    text = re.sub(r" realized_variant=\S+", "", svc.explain(t))
    return _NUMBER.sub("#", text)


# ---------------------------------------------------------------------------
# The span tree
# ---------------------------------------------------------------------------

def test_span_tree_full_lifecycle(graph):
    def case(M, graph):
        svc = _traced_service(M, graph)
        t = svc.submit("g", M.GraphQuery.bfs([0]))
        svc.result(t)
        tr = svc.tracer.trace(t.ticket_id)
        for name in ("ticket", "submit", "admission", "plan", "queue-wait",
                     "attempt", "execute", "resolve"):
            span = tr.find(name)
            assert span is not None and span.t1 is not None, name
        assert tr.root.attrs["status"] == "done"
        qw = tr.find("queue-wait")
        assert qw.attrs["wait_s"] == pytest.approx(qw.duration_s)
        adm = tr.find("admission")
        assert adm.attrs["tier"] == t.tier
        assert adm.attrs["est_s"] == pytest.approx(t.est_s)
        text = svc.explain(t)
        for needle in ("ticket #", "admission", "queue-wait", "attempt",
                       "resolve", "status=done"):
            assert needle in text
        return [span_rec(tr.root), explained(svc, t)]
    both(case, graph)


def test_plan_span_records_all_candidates(graph):
    def case(M, graph):
        svc = _traced_service(M, graph)
        t = svc.submit("g", M.GraphQuery.bfs([0]))
        cands = svc.tracer.trace(t.ticket_id).find("plan").attrs[
            "candidates"]
        assert len(cands) == 6
        assert sum(c["chosen"] for c in cands) == 1
        chosen = next(c for c in cands if c["chosen"])
        assert (chosen["engine"], chosen["variant"]) == (t.plan.engine,
                                                         t.plan.variant)
        assert chosen["est_s"] == min(c["est_s"] for c in cands
                                      if c["feasible"])
        losers = [c for c in cands if not c["chosen"]]
        assert losers and all(c["est_s"] >= chosen["est_s"]
                              for c in losers if c["feasible"])
        text = svc.explain(t)
        assert "<- chosen" in text and "vs chosen" in text
        return [cands, explained(svc, t)]
    both(case, graph)


def test_plan_candidates_span_pools(graph):
    def case(M, graph):
        pools = M.PL.PoolSet([M.PL.DevicePool("onprem"),
                              M.PL.DevicePool("cloud", compute_scale=0.5)])
        svc = M.GraphAnalyticsService(pools=pools, trace_depth=8)
        svc.add_graph("g", graph, pools=["onprem"])
        t = svc.submit("g", M.GraphQuery.pagerank())
        cands = svc.tracer.trace(t.ticket_id).find("plan").attrs[
            "candidates"]
        assert {c["pool"] for c in cands} == {"onprem", "cloud"}
        chosen = next(c for c in cands if c["chosen"])
        assert chosen["pool"] == t.plan.pool
        assert any(c["transfer_s"] > 0 for c in cands
                   if c["pool"] == "cloud")
        for c in cands:
            assert c["est_s"] == pytest.approx(c["compute_s"]
                                               + c["transfer_s"])
        return [cands, plan_rec(t.plan)]
    both(case, graph)


def test_incremental_mode_candidates_and_explain(graph):
    def case(M, graph):
        s, d, _ = edges(graph)
        sym = M.build_coo(s, d, N, symmetrize=True)
        svc = M.GraphAnalyticsService(trace_depth=8)
        svc.add_snapshot("g", sym, as_of=0)
        q = M.GraphQuery.of("connected_components")
        svc.call("g", q, as_of=0)
        svc.add_snapshot("g", as_of=1, added=[[0, 7], [7, 0]])
        t = svc.submit("g", q)
        assert t.plan.mode == "incremental"
        cands = svc.tracer.trace(t.ticket_id).find("plan").attrs[
            "candidates"]
        assert "incremental" in {c["mode"] for c in cands}
        assert next(c for c in cands if c["chosen"])["mode"] == \
            "incremental"
        svc.drain()
        text = svc.explain(t)
        assert "mode=incremental" in text and "<- chosen" in text
        return [cands, explained(svc, t), result(svc.result(t))]
    both(case, graph)


# ---------------------------------------------------------------------------
# Hard lifecycles
# ---------------------------------------------------------------------------

def test_retry_then_success_attempt_spans(graph, flaky_algorithm):
    def case(M, graph):
        svc = _traced_service(
            M, graph, interactive_threshold_s=0.0,
            retry=M.RetryPolicy(max_attempts=3, base_s=1e-4, cap_s=1e-3))
        M.R.install_fault(FLAKY, M.R.FailNTimes(2))
        t = svc.submit("g", M.GraphQuery.of(FLAKY))
        svc.drain()
        assert t.status == "done"
        tr = svc.tracer.trace(t.ticket_id)
        attempts = tr.find_all("attempt")
        assert [a.attrs["attempt"] for a in attempts] == [1, 2, 3]
        assert "error" in attempts[0].attrs and "error" in attempts[1].attrs
        assert "error" not in attempts[2].attrs
        retries = [attrs for (_, name, attrs) in tr.root.events
                   if name == "retry"]
        assert [a["after_attempt"] for a in retries] == [1, 2]
        assert all(a["sleep_s"] >= 1e-4 for a in retries)
        assert tr.root.attrs["status"] == "done"
        return [span_rec(tr.root), [a["sleep_s"] for a in retries]]
    both(case, graph)


def test_dead_letter_exception_chain_on_final_attempt(graph,
                                                      flaky_algorithm):
    def case(M, graph):
        svc = _traced_service(
            M, graph, interactive_threshold_s=0.0,
            retry=M.RetryPolicy(max_attempts=3, base_s=1e-4, cap_s=1e-3))
        M.R.install_fault(FLAKY, M.R.FailAlways())
        t = svc.submit("g", M.GraphQuery.of(FLAKY))
        svc.drain()
        assert t.status == "dead-letter"
        tr = svc.tracer.trace(t.ticket_id)
        last = tr.find_all("attempt")[-1]
        assert len(last.attrs["error_chain"]) == 3
        assert all("FaultInjected" in e for e in last.attrs["error_chain"])
        resolve = tr.find("resolve")
        assert resolve.attrs["status"] == "dead-letter"
        assert "error" in resolve.attrs
        assert tr.root.attrs["status"] == "dead-letter"
        text = svc.explain(t)
        assert "cause[0]" in text and "cause[2]" in text
        return [span_rec(tr.root), explained(svc, t)]
    both(case, graph)


def test_fused_group_shares_one_execute_span(graph):
    def case(M, graph):
        svc = _traced_service(M, graph, interactive_threshold_s=0.0)
        ts = [svc.submit("g", M.GraphQuery.bfs([s])) for s in (0, 5, 9)]
        svc.drain()
        execs = [svc.tracer.trace(t.ticket_id).find("execute") for t in ts]
        assert len({id(e) for e in execs}) == 1
        assert len({e.span_id for e in execs}) == 1
        ex = execs[0]
        assert ex.attrs["fused"] is True
        assert ex.attrs["batch_size"] == len(ts)
        assert ex.attrs["group"] == [t.ticket_id for t in ts]
        members = [c for c in ex.children if c.name == "ticket"]
        assert [c.attrs["ticket_id"] for c in members] == \
            [t.ticket_id for t in ts]
        assert [c.attrs["index"] for c in members] == [0, 1, 2]
        assert "superstep" in ex.attrs
        return [span_rec(ex), [bits(svc.result(t).value) for t in ts]]
    both(case, graph)


def test_spill_records_both_placements(graph):
    def case(M, graph):
        svc = M.GraphAnalyticsService(
            pools=M.PL.PoolSet([M.PL.DevicePool("onprem", capacity=1),
                                M.PL.DevicePool("cloud", capacity=16)]),
            interactive_threshold_s=0.0, trace_depth=16)
        svc.add_graph("g", graph)
        ts = [svc.submit("g", M.GraphQuery("bfs", params={"sources": (i,)}))
              for i in range(3)]
        assert [t.pool for t in ts] == ["onprem", "cloud", "cloud"]
        kept = svc.tracer.trace(ts[0].ticket_id).find("plan")
        assert "spilled" not in kept.attrs
        spilt = svc.tracer.trace(ts[1].ticket_id).find("plan")
        assert spilt.attrs["spilled"] is True
        assert spilt.attrs["original_placement"]["pool"] == "onprem"
        assert spilt.attrs["pool"] == "cloud"
        assert next(c for c in spilt.attrs["candidates"]
                    if c["chosen"])["pool"] == "cloud"
        svc.drain()
        text = svc.explain(ts[1])
        assert "spilled=True" in text and "original_placement" in text
        return [span_rec(kept), span_rec(spilt), explained(svc, ts[1])]
    both(case, graph)


def test_cache_hit_skips_execution_spans(graph):
    def case(M, graph):
        svc = _traced_service(M, graph, interactive_threshold_s=0.0)
        a = svc.submit("g", M.GraphQuery.bfs([3]))
        svc.drain()
        b = svc.submit("g", M.GraphQuery.bfs([3]))
        svc.drain()
        assert "superstep" in svc.result(a).meta
        rb = svc.result(b)
        assert rb.meta.get("cache") == "hit"
        assert "superstep" not in rb.meta
        tr = svc.tracer.trace(b.ticket_id)
        assert tr.find("attempt") is None
        assert any(name == "cache-hit" for (_, name, _) in tr.root.events)
        assert tr.root.attrs["status"] == "done"
        return [span_rec(tr.root), result(svc.result(a)), result(rb)]
    both(case, graph)


# ---------------------------------------------------------------------------
# Superstep profiling
# ---------------------------------------------------------------------------

def test_superstep_counters_per_variant(graph):
    def case(M, graph):
        eng = M.LocalEngine(graph)
        defn = M.R.get("bfs")
        ref = bits(eng.run(defn, {"sources": (0,)}, variant="dense").value)
        rec = []
        for variant in ("dense", "fused", "frontier"):
            r = eng.run(defn, {"sources": (0,)}, variant=variant,
                        profile=True)
            ss = r.meta["superstep"]
            assert ss["variant"] == variant and ss["iterations"] >= 1
            assert ss["halt_step"] == ss["iterations"]
            assert ss["halted"] == (ss["iterations"] < ss["max_iters"])
            assert ss["message_bytes"] > 0
            assert bits(r.value) == ref
            if variant == "frontier":
                occ = ss["frontier_occupancy"]
                assert len(occ) == ss["iterations"]
                assert all(c >= 0 for c in occ)
            bare = eng.run(defn, {"sources": (0,)}, variant=variant)
            assert "superstep" not in bare.meta
            rec.append(result(r))
        return rec
    both(case, graph)


def test_mixed_tier_drain_every_ticket_explained(graph):
    def case(M, graph):
        Q = M.GraphQuery
        qs = [Q.bfs([0], count_only=True), Q.bfs([1]), Q.bfs([2]),
              Q.pagerank(max_iters=5)]
        probe = _traced_service(M, graph)
        ests = sorted(M.P.plan_cost(probe.context("g").plan(q)) for q in qs)
        svc = _traced_service(
            M, graph, interactive_threshold_s=(ests[0] + ests[1]) / 2)
        ts = [svc.submit("g", q) for q in qs]
        assert {t.tier for t in ts} == {"interactive", "batch"}
        svc.drain()
        texts = []
        for t in ts:
            tr = svc.tracer.trace(t.ticket_id)
            assert tr.root.attrs["status"] == "done"
            assert tr.find("plan").attrs["candidates"]
            assert tr.find("queue-wait").attrs["wait_s"] >= 0
            text = svc.explain(t)
            assert "candidates (pool/engine/variant/mode):" in text
            assert "wait_s=" in text
            texts.append(explained(svc, t))
        for t in ts[1:3]:
            ex = svc.tracer.trace(t.ticket_id).find("execute")
            assert ex.attrs["superstep"]["iterations"] >= 1
        return [ests, [t.tier for t in ts], texts]
    both(case, graph)


# ---------------------------------------------------------------------------
# Tracing must not perturb anything
# ---------------------------------------------------------------------------

def test_tracing_is_invisible_in_results(graph):
    def case(M, graph):
        def run(trace_depth):
            svc = M.GraphAnalyticsService(interactive_threshold_s=0.0,
                                          trace_depth=trace_depth)
            svc.add_graph("g", graph)
            qs = [M.GraphQuery.bfs([s]) for s in (0, 5, 9)] + \
                [M.GraphQuery.pagerank(max_iters=4),
                 M.GraphQuery.degree_stats()]
            ts = [svc.submit("g", q) for q in qs]
            svc.drain(workers=2)
            rs = [svc.result(t) for t in ts]
            return ([bits(r.value) for r in rs], [r.iterations for r in rs],
                    svc.metrics()["counters"])
        off = run(0)
        on = run(64)
        assert on == off
        return [off[1], off[2], off[0][:3], off[0][4]]
    both(case, graph)


def test_trace_ring_is_bounded(graph):
    def case(M, graph):
        svc = _traced_service(M, graph, trace_depth=2,
                              interactive_threshold_s=0.0, cache_size=0)
        ts = [svc.submit("g", M.GraphQuery.bfs([s])) for s in (0, 1, 2, 3)]
        svc.drain()
        counters = svc.tracer.counters_snapshot()
        assert counters["retained"] == 2 and counters["evicted"] == 2
        assert counters["tickets"] == 4
        assert svc.tracer.trace(ts[0].ticket_id) is None
        with pytest.raises(KeyError, match="aged out"):
            svc.explain(ts[0])
        newest = explained(svc, ts[-1])
        with pytest.raises(ValueError, match="trace_depth"):
            M.OBS.Tracer(trace_depth=0)
        return [counters, newest, raised(svc.explain, ts[0]),
                raised(M.OBS.Tracer, trace_depth=0)]
    both(case, graph)


def test_explain_requires_tracing(graph):
    def case(M, graph):
        svc = M.GraphAnalyticsService()
        svc.add_graph("g", graph)
        t = svc.submit("g", M.GraphQuery.bfs([0]))
        svc.drain()
        assert svc.metrics()["trace"]["enabled"] == 0
        with pytest.raises(RuntimeError, match="tracing is off"):
            svc.explain(t)
        return [svc.metrics()["trace"], raised(svc.explain, t)]
    both(case, graph)


def test_observer_seam_records_fault_and_transfer_events(graph,
                                                         flaky_algorithm):
    def case(M, graph):
        M.OBS.emit("fault", algorithm="nobody-listens")
        pools = M.PL.PoolSet([M.PL.DevicePool("onprem"),
                              M.PL.DevicePool("cloud", compute_scale=1e-9)])
        svc = M.GraphAnalyticsService(
            pools=pools, interactive_threshold_s=0.0, trace_depth=8,
            retry=M.RetryPolicy(max_attempts=2, base_s=1e-4, cap_s=1e-3))
        svc.add_graph("g", graph, pools=["onprem"])
        M.R.install_fault(FLAKY, M.R.FailNTimes(1))
        t = svc.submit("g", M.GraphQuery.of(FLAKY))
        assert t.pool == "cloud"
        svc.drain()
        assert t.status == "done"
        faults = [a for (_, kind, a) in svc.tracer.events if kind == "fault"]
        assert any(a["error"] is not None for a in faults)
        assert any(a["error"] is None for a in faults)
        assert all(a["algorithm"] == FLAKY for a in faults)
        transfers = [a for (_, kind, a) in svc.tracer.events
                     if kind == "transfer"]
        assert transfers and all(a["bytes"] > 0 for a in transfers)
        tr = svc.tracer.trace(t.ticket_id)
        assert any(name == "transfer" for (_, name, _) in tr.root.events)
        return [[(kind, unclocked(a)) for (_, kind, a) in svc.tracer.events],
                span_rec(tr.root)]
    both(case, graph)


# ---------------------------------------------------------------------------
# Chrome trace export
# ---------------------------------------------------------------------------

def test_chrome_trace_export_and_schema(graph, tmp_path):
    def case(M, graph):
        svc = _traced_service(M, graph, interactive_threshold_s=0.0)
        ts = [svc.submit("g", M.GraphQuery.bfs([s])) for s in (0, 5)]
        svc.drain()
        path = tmp_path / f"{M.name}.json"
        doc = svc.tracer.export_chrome_trace(str(path))
        n = M.OBS.validate_chrome_trace(str(path))
        assert n == len(doc["traceEvents"]) > 0
        by_tid = {}
        for ev in doc["traceEvents"]:
            by_tid.setdefault(ev["tid"], []).append(ev)
        assert set(by_tid) == {t.ticket_id for t in ts}
        exec_ids = {tid: [e["args"]["span_id"] for e in evs
                          if e["name"] == "execute"]
                    for tid, evs in by_tid.items()}
        assert all(len(ids) == 1 for ids in exec_ids.values())
        assert len({ids[0] for ids in exec_ids.values()}) == 1
        return [n, [unclocked({k: v for k, v in ev.items()
                               if k not in ("ts", "dur")})
                    for ev in doc["traceEvents"]]]
    both(case, graph)


@pytest.mark.parametrize("bad,match", [
    ('{"no": []}', "traceEvents"),
    ('{"traceEvents": [{"ph": "X"}]}', "missing"),
    ('{"traceEvents": [{"name": "x", "ph": "Q", "ts": 0, '
     '"pid": 1, "tid": 1}]}', "phase"),
    ('{"traceEvents": [{"name": "x", "ph": "X", "ts": 0, '
     '"pid": 1, "tid": 1}]}', "dur"),
], ids=["top-level", "fields", "phase", "dur"])
def test_chrome_trace_validator_rejects(bad, match):
    def case(M):
        with pytest.raises(ValueError, match=match) as exc:
            M.OBS.validate_chrome_trace(bad)
        return str(exc.value)
    both(case)


# ---------------------------------------------------------------------------
# Metrics exposition
# ---------------------------------------------------------------------------

# submit-to-resolution latencies the test gives each tier: some land in
# the le_1e-02 bucket, some between it and le_1e+02, one past it
CHOSEN_LATENCIES = {"interactive": (0.004, 0.03, 0.5, 7.0),
                    "batch": (0.0009, 0.009, 0.011, 2.0, 99.0, 150.0)}
CHOSEN_WALL_S = 0.25


def _metrics_with_chosen_timings(M, graph):
    svc = _traced_service(M, graph, interactive_threshold_s=0.0)
    ts = [svc.submit("g", M.GraphQuery.bfs([s])) for s in (0, 5)]
    svc.drain()
    for tier, xs in CHOSEN_LATENCIES.items():
        svc._hist[tier] = M.LatencyHistogram()
        for x in xs:
            svc._hist[tier].observe(x)
    svc._accuracy = M.OBS.PlanAccuracyMeter()
    t = ts[0]
    svc._accuracy.record("bfs", t.plan.engine, t.plan.variant, t.plan.pool,
                         est_s=t.est_s, wall_s=CHOSEN_WALL_S, width=2)
    return svc


def test_metrics_text_roundtrips_metrics(graph):
    def case(M, graph):
        svc = _metrics_with_chosen_timings(M, graph)
        text = svc.metrics_text()
        parsed = M.OBS.parse_prometheus(text)
        leaves = []
        M.OBS._flatten(svc.metrics(), (), leaves)
        names = [M.OBS._metric_name("gas", p) for p, _ in leaves]
        colliding = {n for n in names if names.count(n) > 1}
        checked = 0
        for (path, value), name in zip(leaves, names):
            if name in colliding:
                continue
            if value is None:
                assert math.isnan(parsed[name]), name
            elif isinstance(value, (bool, int, float)):
                assert parsed[name] == pytest.approx(float(value)), name
            else:
                continue
            checked += 1
        assert checked >= 50
        assert parsed["gas_trace_enabled"] == 1
        assert parsed["gas_accuracy_samples"] >= 1
        assert parsed["gas_counters_executed"] >= 1
        # the quirk, held to parity: le_1e-02 and le_1e+02 share a name
        # in both tiers, and with these latencies their counts differ
        collide = {}
        for tier, xs in CHOSEN_LATENCIES.items():
            b = svc.metrics()["tier_latency_s"][tier]["buckets"]
            name = M.OBS._metric_name(
                "gas", ("tier_latency_s", tier, "buckets", "le_1e-02"))
            assert name == M.OBS._metric_name(
                "gas", ("tier_latency_s", tier, "buckets", "le_1e+02"))
            assert name in colliding
            assert b["le_1e-02"] != b["le_1e+02"]
            assert parsed[name] in (b["le_1e-02"], b["le_1e+02"])
            collide[tier] = [name, b["le_1e-02"], b["le_1e+02"],
                             parsed[name]]
        return [text, sorted(colliding), collide, checked]
    both(case, graph)


def test_latency_window_exact_flag():
    def case(M):
        h = M.LatencyHistogram(max_samples=4)
        for x in (0.1, 0.2, 0.3):
            h.observe(x)
        snap1 = h.snapshot()
        assert snap1["window_exact"] is True and snap1["window_size"] == 3
        for x in (0.4, 0.5):
            h.observe(x)
        snap = h.snapshot()
        assert snap["window_exact"] is False and snap["window_size"] == 4
        assert snap["count"] == 5 and snap["buckets"]["le_inf"] == 5
        assert snap["p50_s"] in (0.3, 0.4)
        return [snap1, snap]
    both(case)


# ---------------------------------------------------------------------------
# Plan accuracy -> calibration feedback
# ---------------------------------------------------------------------------

def test_accuracy_meter_records_per_key(graph):
    def case(M, graph):
        svc = _traced_service(M, graph, interactive_threshold_s=0.0,
                              cache_size=0)
        for s in (0, 1):
            svc.submit("g", M.GraphQuery.bfs([s]))
        svc.drain()
        svc.call("g", M.GraphQuery.pagerank(max_iters=4))
        acc = svc.metrics()["accuracy"]
        assert acc["samples"] >= 2
        assert acc["mean_abs_rel_err"] is not None
        assert any(k.startswith("bfs|") for k in acc["by_key"])
        assert any(k.startswith("pagerank|") for k in acc["by_key"])
        for row in acc["by_key"].values():
            assert row["n"] >= 1
            assert row["est_s_mean"] > 0 and row["wall_s_mean"] > 0
            assert row["wall_over_est"] > 0
        return [acc["samples"],
                {k: [r["n"], r["est_s_mean"]]
                 for k, r in acc["by_key"].items()}]
    both(case, graph)


def test_fused_group_records_one_accuracy_sample(graph):
    def case(M, graph):
        svc = _traced_service(M, graph, interactive_threshold_s=0.0)
        for s in (0, 5, 9):
            svc.submit("g", M.GraphQuery.bfs([s]))
        svc.drain()
        samples = [s for key, dq in svc._accuracy._samples.items()
                   if key[0] == "bfs" for s in dq]
        assert len(samples) == 1
        est, wall, mode, width = samples[0]
        assert width == 3 and est > 0 and wall > 0
        return [sorted(svc._accuracy._samples), est, mode, width]
    both(case, graph)


def test_calibration_refit_from_production_traces(graph):
    """The loop closes in both packages: the meter's samples feed the
    port's ``fit_profile``, the reference's fit rule."""
    from repro_torch.launch.calibrate import fit_profile

    def case(M, graph):
        svc = _traced_service(M, graph, interactive_threshold_s=0.0,
                              cache_size=0)
        for s in range(4):
            svc.submit("g", M.GraphQuery.bfs([s]))
        svc.drain()
        samples = svc._accuracy.calibration_samples()
        assert "bfs" in samples and samples["bfs"]
        for wall, est in samples["bfs"]:
            assert wall > 0 and est > 0
        profile = fit_profile(samples)
        ratios = sorted(w / e for w, e in samples["bfs"])
        assert profile.algo_time_scale["bfs"] == pytest.approx(
            float(np.median(ratios)))
        return [sorted(samples), [est for _, est in samples["bfs"]]]
    both(case, graph)


def test_accuracy_meter_bounds_and_shape():
    def case(M):
        m = M.OBS.PlanAccuracyMeter(max_samples=3)
        for i in range(5):
            m.record("bfs", "local", "dense", None, est_s=1.0,
                     wall_s=2.0 + i)
        snap = m.snapshot()
        assert snap["samples"] == 3
        row = snap["by_key"]["bfs|local|dense|-"]
        assert row["n"] == 3
        assert row["wall_over_est"] == pytest.approx(5.0)
        assert snap["mean_abs_rel_err"] == pytest.approx(4.0)
        cal = m.calibration_samples()
        assert cal == {"bfs": [(4.0, 1.0), (5.0, 1.0), (6.0, 1.0)]}
        return [snap, cal]
    both(case)


def test_infeasible_candidates_carry_the_reason():
    def case(M):
        g = M.P.GraphStats(n_vertices=2_410_000_000,
                           n_edges=1_500_000_000,
                           bytes_coo=1_500_000_000 * 12)
        plan = M.P.choose_engine(g, M.P.spec_for("connected_components", g),
                                 256)
        assert plan.engine == "distributed" and plan.candidates
        assert sum(c.chosen for c in plan.candidates) == 1
        local = next(c for c in plan.candidates if c.engine == "local")
        assert not local.feasible and not math.isfinite(local.est_s)
        assert local.note == "exceeds local memory budget"
        return plan_rec(plan)
    both(case)
