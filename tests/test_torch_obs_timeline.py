"""The port's ``gas.*`` regions on the profiler's timeline, the execution
timeline that rides on the execute span, and the submit-side spans timed
where their work happens.  CPU only, no JAX: the regions are the port's.

With tracing on, a drained ticket's work shows as nested ``torch.profiler``
ranges (``gas.execute`` ⊃ ``gas.init``, ``gas.loop`` ⊃ ``gas.sync``); with
it off the program enters no range, builds no timeline and reads the
device on the host exactly as often as traced.  ``host_syncs`` counts the
loops' reads: one a superstep for the dense and fused loops, one pack
before the loop and a pack and a halt read a superstep for the frontier's.
"""
from __future__ import annotations

import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import engines as E
from repro_torch.core import obs
from repro_torch.core import pregel as PR
from repro_torch.core import service as SV
from repro_torch.core.engines import LocalEngine
from repro_torch.core.graph import build_coo
from repro_torch.core.query import GraphQuery
from repro_torch.data.synthetic import user_follow_graph

CPU = "cpu"
N = 300


def _graph(kind: str = "follow"):
    if kind == "follow":
        src, dst = user_follow_graph(N, 4.0, seed=3)
        return build_coo(src, dst, N, symmetrize=True, device=CPU)
    if kind == "path":                     # a long diameter: many rounds
        src = np.arange(N - 1)
        return build_coo(src, src + 1, N, symmetrize=True, device=CPU)
    if kind == "islands":                  # edges, and isolated vertices
        src = np.arange(0, 40, 2)
        return build_coo(src, src + 1, N, symmetrize=True, device=CPU)
    raise ValueError(kind)


def _service(trace_depth: int = 64, **kw):
    svc = SV.GraphAnalyticsService(trace_depth=trace_depth, **kw)
    svc.add_graph("g", _graph(), device=CPU)
    return svc


def _ranges(prof) -> list:
    """``(name, start_us, end_us)`` of every ``gas.*`` range recorded."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.name.startswith(obs.REGION_PREFIX)]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _drained_bfs(svc, roots=(0, 7)):
    ts = [svc.submit("g", GraphQuery.bfs([r])) for r in roots]
    svc.drain()
    return ts


def test_traced_drain_nests_the_regions_on_the_profilers_timeline():
    svc = _service()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ts = _drained_bfs(svc)
    got = _ranges(prof)
    names = {n for n, _, _ in got}
    assert {"gas.submit", "gas.plan", "gas.admit", "gas.execute",
            "gas.init", "gas.loop", "gas.sync", "gas.finish"} <= names
    by = {n: [r for r in got if r[0] == n] for n in names}
    for sub in ("gas.plan", "gas.admit"):
        for r in by[sub]:
            assert any(_inside(r, s) for s in by["gas.submit"]), sub
    for sub in ("gas.init", "gas.loop", "gas.finish"):
        assert len(by[sub]) == len(ts)
        for r in by[sub]:
            assert any(_inside(r, e) for e in by["gas.execute"]), sub
    for r in by["gas.sync"]:
        assert any(_inside(r, lp) for lp in by["gas.loop"])
    # the program counted one range a read
    syncs = sum(svc.tracer.trace(t.ticket_id).find("execute")
                .attrs["timeline"]["host_syncs"] for t in ts)
    assert syncs == len(by["gas.sync"])


def _host_reads(prof) -> int:
    """Host reads of tensor values: scalars read out and packs whose
    length the host needs."""
    return sum(1 for e in prof.events()
               if e.name in ("aten::_local_scalar_dense", "aten::nonzero"))


@pytest.mark.parametrize("variant", ["dense", "fused", "frontier"])
def test_untraced_run_enters_no_region_and_reads_as_often(monkeypatch,
                                                          variant):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def no_timeline():
        raise AssertionError("a timeline was built with tracing off")

    g = _graph()
    params = {"sources": (0,)}
    with profile(activities=[ProfilerActivity.CPU]) as traced:
        LocalEngine(g, device=CPU).run("bfs", params, variant=variant,
                                       profile=True)
    monkeypatch.setattr(PR, "record_function", Counting)
    monkeypatch.setattr(E, "Timeline", no_timeline)
    with profile(activities=[ProfilerActivity.CPU]) as bare:
        r = LocalEngine(g, device=CPU).run("bfs", params, variant=variant)
    svc = SV.GraphAnalyticsService()
    svc.add_graph("g", g, device=CPU)
    with profile(activities=[ProfilerActivity.CPU]) as off:
        t = svc.submit("g", GraphQuery.bfs([0]))
        svc.drain()
    assert entered == []
    assert _ranges(bare) == [] and _ranges(off) == []
    assert "timeline" not in r.meta
    assert "timeline" not in svc.result(t).meta and t.trace() is None
    # profiled, the run read the device on the host as often as bare
    assert _host_reads(traced) == _host_reads(bare) > 0


def test_ranges_are_entered_only_while_a_profiler_records(monkeypatch):
    entered = []
    real = PR.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(PR, "record_function", counting)
    svc = _service()
    ts = _drained_bfs(svc)
    assert entered == []                   # traced, but nothing records
    ex = svc.tracer.trace(ts[0].ticket_id).find("execute")
    assert ex.attrs["timeline"]["host_syncs"] > 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _drained_bfs(svc, roots=(11,))
    assert set(entered) == {n for n, _, _ in _ranges(prof)}
    assert "gas.sync" in entered and "gas.submit" in entered


def test_plan_span_times_the_planner_and_admission_leaves_it_out(
        monkeypatch):
    svc = _service()
    plan = SV.GraphContext.plan

    def slow_plan(self, *a, **kw):
        time.sleep(0.005)
        return plan(self, *a, **kw)

    monkeypatch.setattr(SV.GraphContext, "plan", slow_plan)
    t = svc.submit("g", GraphQuery.bfs([0]))
    tr = svc.tracer.trace(t.ticket_id)
    sub, adm, pl = tr.find("submit"), tr.find("admission"), tr.find("plan")
    assert pl.duration_s >= 0.005
    assert adm.duration_s < 0.005
    assert sub.t0 <= pl.t0 <= pl.t1 <= adm.t0 <= adm.t1 == sub.t1
    assert tr.root.t0 == sub.t0
    assert tr.find("queue-wait").t0 == sub.t1
    assert t.trace() is tr                # the ticket hands it out


@pytest.mark.parametrize("kind", ["follow", "path", "islands"])
@pytest.mark.parametrize("variant", ["dense", "fused", "frontier"])
@pytest.mark.parametrize("algo,params", [("bfs", {"sources": (1,)}),
                                         ("sssp", {"source": 1})])
def test_host_syncs_are_exact(kind, variant, algo, params):
    r = LocalEngine(_graph(kind), device=CPU).run(
        algo, params, variant=variant, profile=True)
    assert r.meta["realized_variant"] == variant
    n = r.iterations
    want = n if variant != "frontier" else 1 + 2 * n
    tl = r.meta["timeline"]
    assert tl["host_syncs"] == want
    assert set(tl) == {"init_wall_s", "host_syncs", "kernel_supersteps"}
    assert tl["kernel_supersteps"] == 0        # the CPU runs no kernel
    assert tl["init_wall_s"] >= 0
    assert "loop_span_ms" not in tl            # no CUDA device: no figure


def test_timeline_rides_on_the_execute_span_and_not_in_the_cache():
    svc = _service()
    a, = _drained_bfs(svc, roots=(3,))
    ex = svc.tracer.trace(a.ticket_id).find("execute")
    tl = ex.attrs["timeline"]
    assert set(tl) == {"init_wall_s", "host_syncs", "kernel_supersteps"}
    assert svc.result(a).meta["timeline"]["host_syncs"] == tl["host_syncs"]
    assert "timeline" not in svc.explain(a)
    b = svc.submit("g", GraphQuery.bfs([3]))
    svc.drain()
    assert "timeline" not in svc.result(b).meta    # a cache hit ran nothing


def test_a_late_reading_is_taken_when_the_trace_is_read():
    tracer = obs.Tracer(trace_depth=4)
    svc = SV.GraphAnalyticsService(tracer=tracer)
    assert tracer.annotate is PR.profiler_range
    svc.add_graph("g", _graph(), device=CPU)
    t = svc.submit("g", GraphQuery.bfs([0]))
    svc.drain()
    calls = []

    def late():
        calls.append(1)
        return 2.5

    with tracer._lock:
        ex = tracer._last_execute([t.ticket_id])
    tracer.on_execute_result([t.ticket_id], engine="local",
                             attrs={"timeline": {"loop_span_ms": late}})
    assert calls == []                    # recorded, not read
    tr = tracer.trace(t.ticket_id)
    assert calls == [1]
    assert tr.find("execute") is ex
    assert ex.attrs["timeline"]["loop_span_ms"] == 2.5
    tracer.trace(t.ticket_id)
    assert calls == [1]                   # read once


def test_a_region_without_a_profiler_factory_is_timed_on_the_clock():
    ticks = iter([1.0, 3.5])
    tracer = obs.Tracer(trace_depth=1, clock=lambda: next(ticks))
    assert tracer.annotate is None
    with tracer.region("plan") as reg:
        assert reg.t1 is None
    assert (reg.t0, reg.t1) == (1.0, 3.5)
