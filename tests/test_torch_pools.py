"""Mirror of ``tests/test_pools.py``: hybrid-cloud federation in the port
against the reference — ``DevicePool`` / ``PoolSet`` semantics, the
runtime's ``PoolGate`` and ``TransferLedger``, pool-aware placement,
residency and transfer accounting, batch spill, plan and cache
invalidation on topology changes, cross-pool result parity, the
``metrics()["pools"]`` surface and the checked-in calibration profile.

Each case runs the reference test's body on both packages
(``torch_parity.both``), keeps its assertions, and records what the two
must agree on: placements, plans and their prices, spill and tier
decisions, ledger bytes, metrics (no wall times) and result bytes.
Tolerance: none, but PageRank and HITS values within 1e-6.  The
profile cases compare what both packages promise of their own profile
(auto-loaded, fitted, generation bumps, JSON round trip); the two
profiles' numbers differ by design (a CPU fit and a card fit).
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from torch_parity import (PORT, REF, Pair, approx, bits, both,  # noqa: E402
                          pin_analytic, plan_rec, raised, unclocked)

N = 240
FLOAT_TOL = {"pagerank": 1e-6, "hits": 1e-6}


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


def _two_pools(M, link_bandwidth=None, cloud_scale=1.0, **kw):
    bw = M.PL.DEFAULT_LINK_BANDWIDTH if link_bandwidth is None \
        else link_bandwidth
    return M.PL.PoolSet([
        M.PL.DevicePool("onprem", link_bandwidth=bw, **kw),
        M.PL.DevicePool("cloud", link_bandwidth=bw,
                        compute_scale=cloud_scale, **kw),
    ])


def _pool_rec(p):
    return [p.name, p.devices, p.n_chips, p.link_bandwidth,
            p.compute_scale, p.capacity, p.max_inflight, p.healthy]


def _value(name, v):
    return approx(v, FLOAT_TOL[name]) if name in FLOAT_TOL and \
        not isinstance(v, dict) else (
            {k: approx(x, FLOAT_TOL[name]) for k, x in v.items()}
            if name in FLOAT_TOL else v)


# ---------------------------------------------------------------------------
# DevicePool / PoolSet semantics
# ---------------------------------------------------------------------------

POOL_ERRORS = {
    "empty_name": lambda M: M.PL.DevicePool(""),
    "zero_link": lambda M: M.PL.DevicePool("p", link_bandwidth=0.0),
    "zero_scale": lambda M: M.PL.DevicePool("p", compute_scale=0.0),
    "negative_capacity": lambda M: M.PL.DevicePool("p", capacity=-1),
    "zero_inflight": lambda M: M.PL.DevicePool("p", max_inflight=0),
    "duplicate_names": lambda M: M.PL.PoolSet([M.PL.DevicePool("a"),
                                               M.PL.DevicePool("a")]),
    "empty_poolset": lambda M: M.PL.PoolSet([]),
}


@pytest.mark.parametrize("name", sorted(POOL_ERRORS))
def test_devicepool_validates_fields(name):
    def case(M):
        with pytest.raises(ValueError):
            POOL_ERRORS[name](M)
        return raised(POOL_ERRORS[name], M)
    both(case)


def test_poolset_names_order_and_lookup():
    def case(M):
        ps = _two_pools(M)
        assert ps.names() == ("onprem", "cloud")
        assert "cloud" in ps and "gpu" not in ps
        assert ps.default.name == "onprem"
        with pytest.raises(KeyError):
            ps.get("gpu")
        return [ps.names(), [_pool_rec(p) for p in ps.pools()],
                ps.generation, ps.trivial]
    both(case)


def test_poolset_trivial_only_for_one_unit_scale_healthy_pool():
    def case(M):
        flags = [M.PL.single_pool().trivial, _two_pools(M).trivial,
                 M.PL.single_pool(compute_scale=0.5).trivial]
        ps = M.PL.single_pool()
        ps.set_health("default", False)
        flags.append(ps.trivial)
        assert flags == [True, False, False, False]
        return flags
    both(case)


def test_poolset_health_generation_bumps_only_on_change():
    def case(M):
        ps = _two_pools(M)
        gens = [ps.generation]
        ps.set_health("cloud", True)
        gens.append(ps.generation)
        ps.set_health("cloud", False)
        gens.append(ps.generation)
        healthy = [p.name for p in ps.healthy_pools()]
        ps.set_health("cloud", True)
        gens.append(ps.generation)
        g0 = gens[0]
        assert gens == [g0, g0, g0 + 1, g0 + 2] and healthy == ["onprem"]
        return [gens, healthy]
    both(case)


def test_default_pools_partitions_devices():
    def case(M):
        ps = M.PL.default_pools(devices=("dev0", "dev1", "dev2", "dev3"))
        assert ps.get("onprem").devices == ("dev0", "dev1")
        assert ps.get("cloud").devices == ("dev2", "dev3")
        assert ps.get("onprem").n_chips == 2
        one = M.PL.default_pools(devices=("solo",))
        assert one.get("onprem").devices == one.get("cloud").devices
        return [[_pool_rec(p) for p in ps.pools()],
                [_pool_rec(p) for p in one.pools()]]
    both(case)


# ---------------------------------------------------------------------------
# Runtime primitives
# ---------------------------------------------------------------------------

def test_pool_gate_caps_and_release():
    def case(M):
        gate = M.RT.PoolGate({"a": 1, "b": None})
        seq = [gate.try_acquire("a"), gate.try_acquire("a"),
               gate.try_acquire("b"), gate.try_acquire("b"),
               gate.try_acquire(None)]
        assert seq == [True, False, True, True, True]
        gate.release("a")
        seq += [gate.inflight("a"), gate.try_acquire("a")]
        assert seq[-2:] == [0, True]
        with pytest.raises(RuntimeError):
            gate.release("unknown")
        return [seq, gate.inflight("a"), gate.inflight("b")]
    both(case)


def test_transfer_ledger_accumulates():
    def case(M):
        led = M.RT.TransferLedger()
        led.record("cloud", 100)
        led.record("cloud", 50)
        assert led.bytes_for("cloud") == 150
        assert led.transfers_for("cloud") == 2
        assert led.snapshot() == {
            "cloud": {"transfer_bytes": 150, "transfers": 2}}
        return led.snapshot()
    both(case)


# ---------------------------------------------------------------------------
# Placement: both acceptance directions
# ---------------------------------------------------------------------------

def test_placement_follows_data_when_transfer_dominates(graph):
    def case(M, graph):
        svc = M.GraphAnalyticsService(pools=_two_pools(M, link_bandwidth=1.0))
        svc.add_graph("g", graph, pools=["cloud"])
        plan = svc.context("g").plan(M.GraphQuery("pagerank"))
        assert plan.pool == "cloud" and plan.transfer_s == 0.0
        assert "resident" in plan.reason
        return plan_rec(plan)
    both(case, graph)


def test_placement_follows_compute_when_transfer_is_cheap(graph):
    def case(M, graph):
        ps = M.PL.PoolSet([
            M.PL.DevicePool("onprem", link_bandwidth=1e15,
                            compute_scale=0.01),
            M.PL.DevicePool("cloud", link_bandwidth=1e15),
        ])
        svc = M.GraphAnalyticsService(pools=ps)
        svc.add_graph("g", graph, pools=["cloud"])
        plan = svc.context("g").plan(M.GraphQuery("pagerank"))
        assert plan.pool == "onprem" and plan.transfer_s > 0.0
        assert plan.est_s is not None and np.isfinite(plan.est_s)
        return plan_rec(plan)
    both(case, graph)


def test_trivial_poolset_reproduces_prepool_plans(graph):
    def case(M, graph):
        svc = M.GraphAnalyticsService()
        svc.add_graph("g", graph)
        plan = svc.context("g").plan(M.GraphQuery("pagerank"))
        stats = svc.context("g").current_stats()
        legacy = M.P.choose_plan(stats, M.P.specs_for("pagerank", stats), 1)
        assert plan.pool is None
        assert (plan.engine, plan.variant) == (legacy.engine, legacy.variant)
        assert M.P.plan_cost(plan) == M.P.plan_cost(legacy)
        return [plan_rec(plan), plan_rec(legacy), stats]
    both(case, graph)


def test_pool_plans_price_scale_and_transfer(graph):
    def case(M, graph):
        bw = 1e6
        svc = M.GraphAnalyticsService(
            pools=_two_pools(M, link_bandwidth=bw, cloud_scale=0.5))
        svc.add_graph("g", graph, pools=["onprem"])
        plan = svc.context("g").plan(M.GraphQuery("pagerank"))
        stats = svc.context("g").current_stats()
        spec = M.P.best_spec_for_engine(
            stats, M.P.specs_for("pagerank", stats), plan.engine)
        base = (M.P.estimate_local_cost(stats, spec)
                if plan.engine == "local"
                else M.P.estimate_dist_cost(stats, spec, 1))
        scale = 0.5 if plan.pool == "cloud" else 1.0
        transfer = 0.0 if plan.pool == "onprem" else stats.bytes_coo / bw
        assert plan.est_s == pytest.approx(scale * base + transfer)
        assert M.P.plan_cost(plan) == plan.est_s
        return [plan_rec(plan), base]
    both(case, graph)


# ---------------------------------------------------------------------------
# Residency, transfers, materialization
# ---------------------------------------------------------------------------

def test_execution_materializes_pool_and_charges_ledger(graph):
    def case(M, graph):
        ps = M.PL.PoolSet([
            M.PL.DevicePool("onprem", link_bandwidth=1e15),
            M.PL.DevicePool("cloud", link_bandwidth=1e15,
                            compute_scale=0.01),
        ])
        svc = M.GraphAnalyticsService(pools=ps, cache_size=0)
        svc.add_graph("g", graph, pools=["onprem"])
        ctx = svc.context("g")
        plan = ctx.plan(M.GraphQuery("pagerank"))
        assert plan.pool == "cloud" and plan.transfer_s > 0
        gen0 = ctx.residency_generation
        r1 = svc.call("g", M.GraphQuery("pagerank"))
        pm = svc.metrics()["pools"]
        assert pm["cloud"]["transfers"] == 1
        assert pm["cloud"]["transfer_bytes"] == ctx.stats.bytes_coo
        assert "cloud" in ctx.residency
        assert ctx.residency_generation == gen0 + 1
        r2 = svc.call("g", M.GraphQuery("pagerank"))
        pm2 = svc.metrics()["pools"]
        assert pm2["cloud"]["transfers"] == 1
        replan = ctx.plan(M.GraphQuery("pagerank"))
        assert replan.transfer_s == 0.0
        return [plan_rec(plan), unclocked(pm), unclocked(pm2),
                sorted(ctx.residency), plan_rec(replan),
                approx(r1.value, 1e-6), approx(r2.value, 1e-6)]
    both(case, graph)


def test_replica_names_merge_residency(graph):
    def case(M, graph):
        svc = M.GraphAnalyticsService(pools=_two_pools(M))
        c1 = svc.add_graph("a", graph, pools=["onprem"])
        c2 = svc.add_graph("b", graph, pools=["cloud"])
        assert c1 is c2
        assert c1.residency == frozenset({"onprem", "cloud"})
        return sorted(c1.residency)
    both(case, graph)


def test_remove_replica_shrinks_residency_and_invalidates_plans(graph):
    def case(M, graph):
        svc = M.GraphAnalyticsService(
            pools=_two_pools(M, link_bandwidth=1.0, cloud_scale=0.5))
        svc.add_graph("a", graph, pools=["onprem"])
        svc.add_graph("b", graph, pools=["cloud"])
        ctx = svc.context("a")
        q = M.GraphQuery("pagerank")
        plan = ctx.plan(q)
        assert plan.pool == "cloud" and ctx.plan(q) is plan
        svc.remove_graph("b")
        replan = ctx.plan(q)
        assert replan is not plan and replan.pool == "onprem"
        assert ctx.residency == frozenset({"onprem"})
        return [plan_rec(plan), plan_rec(replan)]
    both(case, graph)


def test_pool_health_flip_invalidates_cached_plans(graph):
    def case(M, graph):
        svc = M.GraphAnalyticsService(
            pools=_two_pools(M, link_bandwidth=1.0, cloud_scale=0.5))
        svc.add_graph("g", graph)
        ctx = svc.context("g")
        q = M.GraphQuery("pagerank")
        plans = [ctx.plan(q)]
        svc.set_pool_health("cloud", False)
        plans.append(ctx.plan(q))
        svc.set_pool_health("cloud", True)
        plans.append(ctx.plan(q))
        assert [p.pool for p in plans] == ["cloud", "onprem", "cloud"]
        svc.set_pool_health("onprem", False)
        svc.set_pool_health("cloud", False)
        bfs = M.GraphQuery("bfs", params={"sources": (0,)})
        with pytest.raises(ValueError):
            ctx.plan(bfs)
        return [[plan_rec(p) for p in plans], raised(ctx.plan, bfs)]
    both(case, graph)


def test_topology_change_rekeys_result_cache(graph):
    def case(M, graph):
        svc = M.GraphAnalyticsService(pools=_two_pools(M))
        svc.add_graph("g", graph)
        q = M.GraphQuery("pagerank")
        r1 = svc.call("g", q)
        r2 = svc.call("g", q)
        assert r2.meta.get("cache") == "hit"
        svc.set_pool_health("cloud", False)
        r3 = svc.call("g", q)
        assert r3.meta.get("cache") != "hit"
        assert bits(r1.value) == bits(r3.value)
        return [[r.meta.get("cache") for r in (r1, r2, r3)],
                approx(r1.value, 1e-6), svc.cache_stats]
    both(case, graph)


# ---------------------------------------------------------------------------
# Spill
# ---------------------------------------------------------------------------

def _batch_two_pool_service(M, graph, **pool_kw):
    svc = M.GraphAnalyticsService(
        pools=M.PL.PoolSet([M.PL.DevicePool("onprem", **pool_kw),
                            M.PL.DevicePool("cloud", capacity=16)]),
        interactive_threshold_s=0.0)
    svc.add_graph("g", graph)
    return svc


def _bfs(M, i):
    return M.GraphQuery("bfs", params={"sources": (i,)})


def test_batch_spill_engages_under_capacity_pressure(graph):
    def case(M, graph):
        svc = _batch_two_pool_service(M, graph, capacity=1)
        ts = [svc.submit("g", _bfs(M, i)) for i in range(4)]
        assert [t.pool for t in ts] == ["onprem", "cloud", "cloud", "cloud"]
        assert svc.stats["spilled"] == 3
        assert ts[1].tier == "batch"
        assert "spilled from onprem" in ts[1].plan.reason
        pm = svc.metrics()["pools"]
        assert pm["onprem"]["spilled_away"] == 3
        assert pm["onprem"]["queue_depths"]["local.batch"] == 1
        assert pm["cloud"]["queue_depths"]["local.batch"] == 3
        svc.drain()
        assert all(t.status == "done" for t in ts)
        vals = [bits(svc.result(t).value) for t in ts]
        solo = M.GraphAnalyticsService()
        solo.add_graph("g", graph)
        for i, v in enumerate(vals):
            assert v == bits(solo.call("g", _bfs(M, i)).value)
        return [[(t.pool, t.tier, plan_rec(t.plan)) for t in ts],
                dict(svc.stats), unclocked(pm), vals]
    both(case, graph)


def test_spill_requires_residency(graph):
    def case(M, graph):
        svc = M.GraphAnalyticsService(
            pools=M.PL.PoolSet([
                M.PL.DevicePool("onprem", capacity=1, link_bandwidth=1.0),
                M.PL.DevicePool("cloud", capacity=16, link_bandwidth=1.0),
            ]),
            interactive_threshold_s=0.0)
        svc.add_graph("g", graph, pools=["onprem"])
        ts = [svc.submit("g", _bfs(M, i)) for i in range(3)]
        assert [t.pool for t in ts] == ["onprem"] * 3
        assert svc.stats["spilled"] == 0
        return [[plan_rec(t.plan) for t in ts], dict(svc.stats)]
    both(case, graph)


def test_spill_skips_unhealthy_pools(graph):
    def case(M, graph):
        svc = _batch_two_pool_service(M, graph, capacity=1)
        svc.set_pool_health("cloud", False)
        ts = [svc.submit("g", _bfs(M, i)) for i in range(3)]
        assert [t.pool for t in ts] == ["onprem"] * 3
        assert svc.stats["spilled"] == 0
        return [[plan_rec(t.plan) for t in ts], dict(svc.stats)]
    both(case, graph)


def test_concurrent_drain_matches_serial_with_spill(graph):
    def case(M, graph):
        def run(workers):
            svc = _batch_two_pool_service(M, graph, capacity=1)
            ts = [svc.submit("g", _bfs(M, i)) for i in range(6)]
            svc.drain(workers=workers)
            return [bits(svc.result(t).value) for t in ts]
        serial = run(1)
        assert serial == run(4)
        return serial
    both(case, graph)


def test_pool_gate_limits_inflight(graph):
    def case(M, graph):
        svc = M.GraphAnalyticsService(
            pools=M.PL.PoolSet([
                M.PL.DevicePool("onprem", max_inflight=1),
                M.PL.DevicePool("cloud", max_inflight=1, capacity=16),
            ]),
            interactive_threshold_s=0.0, cache_size=0)
        svc.add_graph("g", graph)
        ts = [svc.submit("g", M.GraphQuery("pagerank",
                                           params={"max_iters": 5 + i}))
              for i in range(5)]
        svc.drain(workers=4)
        assert all(t.status == "done" for t in ts)
        pm = svc.metrics()["pools"]
        assert pm["onprem"]["inflight"] == 0 and pm["cloud"]["inflight"] == 0
        return [[(t.pool, t.status) for t in ts],
                [approx(svc.result(t).value, 1e-6) for t in ts]]
    both(case, graph)


# ---------------------------------------------------------------------------
# Cross-pool parity: every algorithm x variant
# ---------------------------------------------------------------------------

def _example_suite(M):
    return [(name, defn) for name, defn in M.R.items()
            if defn.example_params is not None]


@pytest.mark.parametrize("name", [n for n, _ in _example_suite(REF)])
def test_every_algorithm_and_variant_identical_across_pools(
        name, graph, sym_graph):
    def case(M, graph, sym_graph):
        pools = _two_pools(M).pools()
        defn = M.R.get(name)
        g = sym_graph if defn.requires_symmetric else graph
        params = dict(defn.example_params)
        rec = []
        for base in (M.LocalEngine(g), M.DistributedEngine(g, n_data=4)):
            if base.name not in defn.engines:
                continue
            for var in (None,) + tuple(sorted(defn.variants or ())):
                ref = base.run(name, params, variant=var).value
                for pool in pools:
                    twin = base.for_pool(pool)
                    assert twin is not base
                    got = twin.run(name, params, variant=var).value
                    assert bits(got) == bits(ref), (name, var, pool.name)
                rec.append([base.name, var, _value(name, ref)])
        assert rec
        return rec
    assert [n for n, _ in _example_suite(PORT)] == \
        [n for n, _ in _example_suite(REF)]
    both(case, graph, sym_graph)


def test_for_pool_twins_are_cached_and_share_nothing(graph):
    def case(M, graph):
        pools = _two_pools(M)
        eng = M.LocalEngine(graph)
        a = eng.for_pool(pools.get("onprem"))
        b = eng.for_pool(pools.get("cloud"))
        assert a is eng.for_pool(pools.get("onprem"))
        assert a is not b and a is not eng
        assert a.pool.name == "onprem" and b.pool.name == "cloud"
        assert set(eng.pool_twins()) == {"onprem", "cloud"}
        assert a.for_pool(pools.get("onprem")) is a
        return [sorted(eng.pool_twins()), a.pool.name, b.pool.name]
    both(case, graph)


def test_service_results_identical_to_prepool_platform(graph):
    def case(M, graph):
        queries = [M.GraphQuery("pagerank"),
                   M.GraphQuery("bfs", params={"sources": (3,)}),
                   M.GraphQuery("degree_stats")]
        plat = M.GraphPlatform(graph)
        rec = []
        for home in ("onprem", "cloud"):
            svc = M.GraphAnalyticsService(
                pools=_two_pools(M, link_bandwidth=1.0))
            svc.add_graph("g", graph, pools=[home])
            for q in queries:
                plan = svc.context("g").plan(q)
                assert plan.pool == home
                v = svc.call("g", q).value
                assert bits(v) == bits(plat.query(q).value)
                rec.append([plan_rec(plan), _value(q.algorithm, v)])
        return rec
    both(case, graph)


# ---------------------------------------------------------------------------
# Metrics surface
# ---------------------------------------------------------------------------

def test_metrics_pools_section_shape(graph):
    def case(M, graph):
        svc = _batch_two_pool_service(M, graph, capacity=1)
        svc.submit("g", M.GraphQuery("pagerank"))
        m = svc.metrics()
        assert set(m["pools"]) == {"onprem", "cloud"}
        row = m["pools"]["onprem"]
        assert {"healthy", "capacity", "max_inflight", "inflight",
                "queue_depths", "transfer_bytes", "transfers",
                "spilled_away"} <= set(row)
        assert m["counters"]["spilled"] == 0
        assert m["queue_depths"]["local.batch"] == 1
        assert row["queue_depths"]["local.batch"] == 1
        return [unclocked(m["pools"]), m["counters"], m["queue_depths"]]
    both(case, graph)


def test_trivial_pool_metrics_mirror_aggregate_depths(graph):
    def case(M, graph):
        svc = M.GraphAnalyticsService(interactive_threshold_s=0.0)
        svc.add_graph("g", graph)
        svc.submit("g", M.GraphQuery("pagerank"))
        m = svc.metrics()
        assert m["queue_depths"]["local.batch"] == 1
        assert m["pools"]["default"]["queue_depths"]["local.batch"] == 1
        return [unclocked(m["pools"]), m["queue_depths"]]
    both(case, graph)


# ---------------------------------------------------------------------------
# The checked-in calibration profile
# ---------------------------------------------------------------------------

def test_reference_profile_is_checked_in_and_autoloads():
    def case(M):
        assert M.P.AUTO_LOADED_REFERENCE
        ref = M.P.CalibrationProfile.from_json(M.P.reference_profile_path())
        assert ref.source != "analytic-defaults"
        assert ref.algo_time_scale
        return [M.P.AUTO_LOADED_REFERENCE, sorted(ref.algo_time_scale),
                ref.admission_budget_s]
    both(case)


def test_load_reference_calibration_bumps_generation_and_applies():
    def case(M):
        gen0 = M.P.calibration_generation()
        ref = M.P.load_reference_calibration()
        assert M.P.calibration_generation() == gen0 + 1
        assert M.P.active_calibration() is ref
        svc = M.GraphAnalyticsService()
        assert svc.interactive_threshold_s == ref.interactive_threshold_s
        M.P.set_calibration(None)
        assert M.P.calibration_generation() == gen0 + 2
        assert M.P.active_calibration().source == "analytic-defaults"
        return [M.P.calibration_generation() - gen0,
                svc.interactive_threshold_s == ref.interactive_threshold_s]
    both(case)


def test_reference_profile_roundtrips_through_json(tmp_path):
    def case(M):
        ref = M.P.CalibrationProfile.from_json(M.P.reference_profile_path())
        out = tmp_path / f"{M.name}.json"
        ref.to_json(out)
        again = M.P.CalibrationProfile.from_json(out)
        assert again == ref
        return again == ref
    both(case)


def test_each_package_reads_the_others_profile(tmp_path):
    """The profile is one format: the reference's loader reads the
    port's card fit to the same profile, and the port's the reference's."""
    port_fit = PORT.P.CalibrationProfile.from_json(
        PORT.P.reference_profile_path())
    ref_fit = REF.P.CalibrationProfile.from_json(
        REF.P.reference_profile_path())
    for fit, other in ((port_fit, REF), (ref_fit, PORT)):
        path = tmp_path / "x.json"
        fit.to_json(path)
        read = other.P.CalibrationProfile.from_json(path)
        assert read.source == fit.source
        assert dict(read.algo_time_scale) == dict(fit.algo_time_scale)
        assert dict(read.superstep_edge_bytes) == \
            dict(fit.superstep_edge_bytes)
        assert read.interactive_threshold_s == fit.interactive_threshold_s
