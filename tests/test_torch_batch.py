"""Fused query batches in the port against the JAX reference.

The same graphs (numpy, fixed seeds) go through both packages:

* ``batched_spec`` — memoized, rejects structured messages, and each
  column of a batched program is byte-equal to its scalar program alone
  under every superstep strategy (dense, frontier, fused; the fused
  strategy runs the kernel's plain version on the CPU);
* ``Engine.run_batch`` for BFS and SSSP — every column byte-equal to the
  solo run and to the reference's ``Engine.run_batch``, iteration counts
  equal; per-query ``count_only`` reducers; fuse keys that keep
  incompatible queries apart; Jaccard pair-batches;
* mirrors of the fusion tests of ``tests/test_service.py`` on CPU
  tensors (one fused execution for B tickets, bit-identical to solo
  ``GraphPlatform.query`` runs).

Tolerance: none — ids, distances and Jaccard scores are compared byte
for byte (min monoids are exact in any order; Jaccard is a per-row
quotient of integer counts).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import graph as JG  # noqa: E402
from repro.core import planner as JP  # noqa: E402
from repro.core.engines import LocalEngine as JLocal  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import planner as TP  # noqa: E402
from repro_torch.core import pregel  # noqa: E402
from repro_torch.core.engines import (DistributedEngine, Engine,  # noqa: E402
                                      LocalEngine)
from repro_torch.core.query import GraphPlatform, GraphQuery  # noqa: E402
from repro_torch.core.service import (GraphAnalyticsService,  # noqa: E402
                                      QueryTicket)
from repro_torch.data import synthetic as S  # noqa: E402

traversal = importlib.import_module("repro_torch.core.algorithms.traversal")

N = 260
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


def _edges(seed=11):
    return S.user_follow_graph(N, 4.0, seed=seed)


@pytest.fixture(scope="module")
def graph():
    src, dst = _edges()
    w = np.random.default_rng(3).uniform(0.5, 2.0, src.size)
    return TG.build_coo(src, dst, N, w=w.astype(np.float32), device=CPU)


@pytest.fixture(scope="module")
def jgraph():
    src, dst = _edges()
    w = np.random.default_rng(3).uniform(0.5, 2.0, src.size)
    return JG.build_coo(src, dst, N, w=w.astype(np.float32))


@pytest.fixture(scope="module")
def sym_graph():
    src, dst = _edges()
    keep = src != dst
    return TG.build_coo(src[keep], dst[keep], N, symmetrize=True, device=CPU)


def _batch_service(graph, **add_kw):
    """A service where every admitted ticket lands in the batch tier."""
    svc = GraphAnalyticsService(interactive_threshold_s=0.0)
    svc.add_graph("g", graph, device=CPU, **add_kw)
    return svc


@pytest.fixture()
def count_pregel_calls(monkeypatch):
    """Count fused pregel executions: the traversal batch runner
    dispatches each fused program through Engine.run_superstep once."""
    calls = {"n": 0}
    real = Engine.run_superstep

    def counting(self, *a, **kw):
        calls["n"] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(Engine, "run_superstep", counting)
    return calls


# ------------------------------------------------- batched_spec contract

def test_batched_spec_rejects_structured_messages():
    structured = pregel.PregelSpec(
        message=lambda s, w: s, combine=(("sum", 1), ("min", 1)),
        apply=lambda old, agg, ids, gval: agg, identity=(0.0, 0.0))
    with pytest.raises(ValueError, match="batch axis"):
        pregel.batched_spec(structured)


def test_batched_spec_memoized():
    spec = traversal._BFS_SPEC
    assert pregel.batched_spec(spec) is pregel.batched_spec(spec)


def test_batched_message_carries_its_compiled_program():
    from repro_torch.kernels.pregel_superstep import ops
    for spec, prog in ((traversal._BFS_SPEC, ops.msg_src_plus_one),
                       (traversal._SSSP_SPEC, ops.msg_src_plus_w)):
        lifted = pregel.batched_spec(spec).message
        assert lifted is not prog and lifted.base is prog
        assert ops.compiled(lifted) and ops.base_program(lifted) is prog
    assert not ops.compiled(pregel.batched_spec(pregel.PregelSpec(
        message=lambda s, w: s, combine="min",
        apply=lambda old, agg, ids, gval: agg, identity=0.0)).message)


@pytest.mark.parametrize("variant", ["dense", "frontier", "fused"])
@pytest.mark.parametrize("name", ["bfs", "sssp"])
def test_batched_columns_equal_solo_runs(graph, variant, name):
    """Each column of the batched program is its scalar program alone,
    byte for byte, with equal iteration counts at the slowest column."""
    spec = {"bfs": traversal._BFS_SPEC, "sssp": traversal._SSSP_SPEC}[name]
    eng = LocalEngine(graph, device=CPU)
    source_sets = [(0,), (5, 9), (17,), (42,)]
    n_pad = eng.sharded.n_pad if variant == "dense" else N
    init = torch.full((n_pad, len(source_sets)), float("inf"))
    for b, s in enumerate(source_sets):
        init[list(s), b] = 0.0
    got, iters = eng.run_superstep(pregel.batched_spec(spec), init, N,
                                   variant=variant)
    solo_iters = []
    for b, s in enumerate(source_sets):
        one = torch.full((n_pad,), float("inf"))
        one[list(s)] = 0.0
        want, it = eng.run_superstep(spec, one, N, variant=variant)
        assert _bits(got[:N, b]) == _bits(want[:N])
        solo_iters.append(int(it))
    assert int(iters) == max(solo_iters)


def _decay_apply(old, agg, ids, gval):
    return 0.5 * old + agg


def _dst_min_msg(s, w, d):
    return torch.minimum(s, d) + w


@pytest.mark.parametrize("spec,iters", [
    (traversal._BFS_SPEC, N),
    (pregel.PregelSpec(message=lambda s, w: s * w, combine="sum",
                       apply=_decay_apply, identity=0.0), 5),
    (pregel.PregelSpec(message=_dst_min_msg, combine="min",
                       apply=traversal._relax_apply, identity=float("inf"),
                       halt=pregel.converged_halt, needs_dst_state=True), N),
], ids=["bfs-min", "float-sum", "two-endpoint-min"])
def test_dense_batch_by_column_equals_row_gather(graph, spec, iters):
    """The dense path gathers and combines a batched program's [V, B]
    state a column at a time; the [E, B] row gather of the same lifted
    message (a plain wrapper hides the lift) gives the same bytes."""
    eng = LocalEngine(graph, device=CPU)
    lifted = pregel.batched_spec(spec)
    rows = pregel.PregelSpec(**{**lifted.__dict__,
                                "message": lambda *a: lifted.message(*a)})
    rng = np.random.default_rng(5)
    init = rng.uniform(0.0, 4.0, (eng.sharded.n_pad, 3)).astype(np.float32)
    init[rng.random(init.shape) < 0.7] = np.inf if spec.combine == "min" \
        else 0.0
    init = torch.from_numpy(init)
    got, it_got = pregel.run_pregel(lifted, eng.sharded, init, iters)
    want, it_want = pregel.run_pregel(rows, eng.sharded, init, iters)
    assert int(it_got) == int(it_want)
    assert _bits(got) == _bits(want)


@pytest.mark.parametrize("variant", ["dense", "frontier", "fused"])
def test_run_batch_matches_solo_and_reference(graph, jgraph, variant,
                                              monkeypatch):
    """``Engine.run_batch`` under each strategy (forced through
    ``run_superstep``) against solo runs and the reference's
    ``run_batch``."""
    real = Engine.run_superstep
    monkeypatch.setattr(
        Engine, "run_superstep",
        lambda self, spec, s, mi, variant=None, init_active=None:
        real(self, spec, s, mi, variant=forced, init_active=init_active))
    forced = variant
    eng, jeng = LocalEngine(graph, device=CPU), JLocal(jgraph)
    for algo, ps in (("bfs", [{"sources": (0,)}, {"sources": (3, 77)},
                              {"sources": (200,)}]),
                     ("sssp", [{"source": 1}, {"source": 9},
                               {"source": 140}])):
        got = eng.run_batch(algo, ps)
        want = jeng.run_batch(algo, ps)
        for p, g, w in zip(ps, got, want):
            assert _bits(g.value) == _bits(w.value)
            assert g.iterations == w.iterations
            assert g.meta["realized_variant"] == variant
            assert _bits(g.value) == _bits(eng.run(algo, p).value)


def test_run_batch_meta_and_count_only(graph, jgraph):
    eng, jeng = LocalEngine(graph, device=CPU), JLocal(jgraph)
    ps = [{"sources": (0,)}, {"sources": (7,)}, {"sources": (9, 11)}]
    got = eng.run_batch("bfs", ps, count_only=[False, True, True],
                        profile=True)
    want = jeng.run_batch("bfs", ps, count_only=[False, True, True])
    assert got[1].value == want[1].value and got[2].value == want[2].value
    assert isinstance(got[1].value, int)
    for i, r in enumerate(got):
        assert r.meta["fused"] == {"batch_size": 3, "index": i,
                                   "pregel_calls": 1}
        assert r.meta["superstep"] is got[0].meta["superstep"]
    with pytest.raises(ValueError, match="length mismatch"):
        eng.run_batch("bfs", ps, count_only=[True])
    with pytest.raises(ValueError, match="no batch runner"):
        eng.run_batch("pagerank", [{}])


def test_run_batch_injects_one_fault_per_fused_execution(graph):
    from repro_torch.core import registry as R
    eng = LocalEngine(graph, device=CPU)
    R.install_fault("bfs", R.FailNTimes(1))
    try:
        with pytest.raises(R.FaultInjected, match=r"\(1/1\)"):
            eng.run_batch("bfs", [{"sources": (0,)}, {"sources": (1,)}])
        # the one failure was spent on the one fused execution
        out = eng.run_batch("bfs", [{"sources": (0,)}, {"sources": (1,)}])
        assert len(out) == 2
    finally:
        R.uninstall_fault("bfs")


def test_jaccard_batch_matches_solo_and_reference(graph, jgraph):
    eng, jeng = LocalEngine(graph, device=CPU), JLocal(jgraph)
    ps = [{"u": (0, 1, 2), "v": (3, 4, 5)}, {"u": (7,), "v": (9,)},
          {"u": (10, 11), "v": (12, 250)}]
    got = eng.run_batch("jaccard", ps)
    want = jeng.run_batch("jaccard", ps)
    for p, g, w in zip(ps, got, want):
        assert _bits(g.value) == _bits(w.value)
        assert _bits(g.value) == _bits(eng.run("jaccard", p).value)
        assert g.meta["fused"]["kernel_calls"] == 1


def test_fuse_keys_match_the_reference():
    from repro.core import registry as JR
    from repro_torch.core import registry as R
    for algo, ps in (("bfs", [{"sources": (0,)},
                              {"sources": (1,), "max_iters": 2}]),
                     ("sssp", [{"source": 0}, {"source": 3, "max_iters": 5}]),
                     ("jaccard", [{"u": (0,), "v": (1,)}])):
        d, jd = R.get(algo), JR.get(algo)
        keys = [d.fuse(d.validate(p)) for p in ps]
        assert keys == [jd.fuse(jd.validate(p)) for p in ps]
    bfs = R.get("bfs")
    assert bfs.fuse(bfs.validate({"sources": (0,)})) != \
        bfs.fuse(bfs.validate({"sources": (0,), "max_iters": 2}))


# ------------------------------------- mirrors of tests/test_service.py

@pytest.mark.parametrize("force_engine", ["local", "distributed"])
def test_fused_bfs_acceptance(graph, force_engine, count_pregel_calls):
    """B=5 BFS tickets -> one pregel invocation, results bit-identical
    to solo GraphPlatform.query runs, on both engines."""
    svc = _batch_service(graph, n_data=4, force_engine=force_engine)
    sources = [(0,), (5,), (9,), (17,), (42,)]
    tickets = [svc.submit("g", GraphQuery.bfs(s)) for s in sources]
    assert all(t.tier == "batch" for t in tickets)

    count_pregel_calls["n"] = 0
    svc.drain()
    assert count_pregel_calls["n"] == 1          # ONE fused execution

    solo = GraphPlatform(graph, n_data=4, force_engine=force_engine,
                         device=CPU)
    for t in tickets:
        r = svc.result(t)
        assert r.engine == force_engine
        fused = r.meta["fused"]
        assert fused["batch_size"] == len(sources)
        assert fused["pregel_calls"] == 1
        assert _bits(r.value) == _bits(solo.query(t.query).value)
    assert svc.stats["fused_batches"] == 1
    assert svc.stats["fused_tickets"] == len(sources)


@pytest.mark.parametrize("force_engine", ["local", "distributed"])
def test_fused_sssp_parity(graph, force_engine):
    svc = _batch_service(graph, n_data=4, force_engine=force_engine)
    tickets = [svc.submit("g", GraphQuery.sssp(s)) for s in (0, 3, 7, 31)]
    svc.drain()
    solo = GraphPlatform(graph, n_data=4, force_engine=force_engine,
                         device=CPU)
    for t in tickets:
        r = svc.result(t)
        assert r.meta["fused"]["batch_size"] == 4
        assert _bits(r.value) == _bits(solo.query(t.query).value)


def test_fused_jaccard_parity(graph):
    svc = _batch_service(graph)
    queries = [GraphQuery.of("jaccard", u=[0, 1], v=[2, 3]),
               GraphQuery.of("jaccard", u=[5], v=[9]),
               GraphQuery.of("jaccard", u=[10, 11, 12], v=[13, 14, 15])]
    tickets = [svc.submit("g", q) for q in queries]
    svc.drain()
    solo = GraphPlatform(graph, device=CPU)
    for t in tickets:
        r = svc.result(t)
        assert r.meta["fused"]["batch_size"] == 3
        assert r.meta["fused"]["kernel_calls"] == 1
        assert _bits(r.value) == _bits(solo.query(t.query).value)


def test_fused_count_only_applies_reducer(graph):
    """count_only is per-ticket within a fused batch: the reducer runs
    on that ticket's slice of the shared execution."""
    svc = _batch_service(graph)
    t_full = svc.submit("g", GraphQuery.bfs([0]))
    t_count = svc.submit("g", GraphQuery.bfs([3], count_only=True))
    svc.drain()
    assert svc.result(t_full).meta["fused"]["batch_size"] == 2
    solo = GraphPlatform(graph, device=CPU)
    assert svc.result(t_count).value == \
        solo.query(GraphQuery.bfs([3], count_only=True)).value


def test_fuse_key_separates_incompatible_queries(graph, count_pregel_calls):
    """Differing max_iters must not fuse (the loop bound is shared);
    the queue splits into two fused groups."""
    svc = _batch_service(graph)
    a = [svc.submit("g", GraphQuery.bfs([s])) for s in (0, 1)]
    b = [svc.submit("g", GraphQuery.bfs([s], max_iters=2)) for s in (2, 3)]
    count_pregel_calls["n"] = 0
    svc.drain()
    assert count_pregel_calls["n"] == 2
    assert svc.result(a[0]).meta["fused"]["batch_size"] == 2
    assert svc.result(b[0]).meta["fused"]["batch_size"] == 2
    assert svc.stats["fused_batches"] == 2


def test_fusion_never_crosses_graphs(graph, sym_graph):
    """Same algorithm, same fuse key, different snapshots: two separate
    executions (a fused program shares one graph's edge shards)."""
    svc = GraphAnalyticsService(interactive_threshold_s=0.0)
    svc.add_graph("a", graph, device=CPU)
    svc.add_graph("b", sym_graph, device=CPU)
    ta = [svc.submit("a", GraphQuery.bfs([s])) for s in (0, 1)]
    tb = [svc.submit("b", GraphQuery.bfs([s])) for s in (0, 1)]
    svc.drain()
    assert svc.result(ta[0]).meta["fused"]["batch_size"] == 2
    assert svc.result(tb[0]).meta["fused"]["batch_size"] == 2
    assert svc.stats["fused_batches"] == 2
    solo_b = GraphPlatform(sym_graph, device=CPU)
    assert _bits(svc.result(tb[1]).value) == \
        _bits(solo_b.query(tb[1].query).value)


def _run_mixed(graph):
    svc = GraphAnalyticsService(interactive_threshold_s=0.0)
    svc.add_graph("g", graph, n_data=4, device=CPU)
    svc.submit("g", GraphQuery.bfs([0]))                    # 0 fuses w/ 3
    svc.submit("g", GraphQuery.pagerank(max_iters=5))       # 1 solo
    svc.submit("g", GraphQuery.of("jaccard", u=[0], v=[1]))  # 2 solo-batch
    svc.submit("g", GraphQuery.bfs([7]))                    # 3
    svc.submit("g", GraphQuery.sssp(2))                     # 4 fuses w/ 5
    svc.submit("g", GraphQuery.sssp(9))                     # 5
    svc.drain()
    return [(e["algorithm"], tuple(e["tickets"]), e["fused"])
            for e in svc.execution_log]


def test_fifo_deterministic_and_fuses_across_queue(graph):
    """Two identical submission sequences produce identical execution
    logs; fusion pulls compatible tickets forward to their group head
    but group heads stay in FIFO order."""
    log1, log2 = _run_mixed(graph), _run_mixed(graph)
    assert log1 == log2
    heads = [t[1][0] for t in log1]
    assert heads == sorted(heads)            # group heads in FIFO order
    by_algo = {t[0]: t for t in log1}
    assert by_algo["bfs"] == ("bfs", (0, 3), True)
    assert by_algo["sssp"] == ("sssp", (4, 5), True)
    assert by_algo["pagerank"][2] is False


def test_interactive_bypasses_batch_queue(graph):
    """An interactive ticket resolves immediately even with older batch
    work queued ahead of it — and the batch work stays queued."""
    try:
        TP.set_calibration(TP.CalibrationProfile(
            algo_time_scale={"pagerank": 1e9}))
        svc = GraphAnalyticsService(interactive_threshold_s=1e-2)
        svc.add_graph("g", graph, device=CPU)
        batch_t = svc.submit("g", GraphQuery.pagerank(max_iters=5))
        assert batch_t.tier == "batch"
        quick = svc.submit("g", GraphQuery.degree_stats())
        assert quick.tier == "interactive"
        r = svc.result(quick)
        assert r.value is not None
        assert batch_t.status == "queued"        # bypassed, not drained
        assert [t.ticket_id for t in svc.pending()] == [batch_t.ticket_id]
        svc.drain()
        assert batch_t.status == "done"
    finally:
        TP.set_calibration(None)


def test_fused_batch_results_enter_shared_cache(graph):
    """A ticket answered by a fused batch seeds the result cache: the
    same query re-submitted (or re-called synchronously) is a hit."""
    svc = _batch_service(graph)
    tickets = [svc.submit("g", GraphQuery.bfs([s])) for s in (0, 5, 9, 17)]
    svc.drain()
    runs_before = svc.context("g").local.n_runs
    r = svc.call("g", GraphQuery.bfs([5]))
    assert r.meta.get("cache") == "hit"
    assert _bits(r.value) == _bits(svc.result(tickets[1]).value)
    t_again = svc.submit("g", GraphQuery.bfs([9]))
    svc.drain()
    assert svc.result(t_again).meta.get("cache") == "hit"
    assert svc.context("g").local.n_runs == runs_before


def test_ticket_result_is_reusable(graph):
    svc = _batch_service(graph)
    t = svc.submit("g", GraphQuery.bfs([0]))
    r1 = svc.result(t)                 # drains
    r2 = svc.result(t)                 # already done: stored result
    assert r1 is r2
    assert isinstance(t, QueryTicket) and t.status == "done"


def test_directly_constructed_query_fuses_safely(graph):
    """A GraphQuery built without schema defaults filled (bypassing
    ``.of``) must not crash the drain: fuse keys are computed over
    validated params."""
    svc = _batch_service(graph)
    t_raw = svc.submit("g", GraphQuery("bfs", params={"sources": (0,)}))
    t_of = svc.submit("g", GraphQuery.bfs([1]))
    svc.drain()
    assert svc.result(t_raw).meta["fused"]["batch_size"] == 2
    solo = GraphPlatform(graph, device=CPU)
    assert _bits(svc.result(t_raw).value) == \
        _bits(solo.query(GraphQuery.bfs([0])).value)
    assert _bits(svc.result(t_of).value) == \
        _bits(solo.query(GraphQuery.bfs([1])).value)


def test_cache_hit_does_not_replay_fused_meta(graph):
    """'fused' describes one execution; a later cache hit for the same
    query must not claim it was part of that batch."""
    svc = _batch_service(graph)
    tickets = [svc.submit("g", GraphQuery.bfs([s])) for s in (0, 5)]
    svc.drain()
    assert svc.result(tickets[0]).meta["fused"]["batch_size"] == 2
    hit = svc.call("g", GraphQuery.bfs([0]))
    assert hit.meta.get("cache") == "hit"
    assert "fused" not in hit.meta
    assert "realized_variant" not in hit.meta


def test_fused_tickets_match_the_reference_service(graph, jgraph):
    """The same submissions to both packages' services: the same
    execution log and byte-equal results per ticket."""
    from repro.core.query import GraphQuery as JQuery
    from repro.core.service import GraphAnalyticsService as JService
    jsvc = JService(interactive_threshold_s=0.0)
    jsvc.add_graph("g", jgraph)
    svc = _batch_service(graph)
    subs = [("bfs", (0,)), ("sssp", 4), ("bfs", (3, 8)), ("sssp", 60),
            ("bfs", (100,))]
    pairs = []
    for algo, arg in subs:
        if algo == "bfs":
            pairs.append((svc.submit("g", GraphQuery.bfs(arg)),
                          jsvc.submit("g", JQuery.bfs(arg))))
        else:
            pairs.append((svc.submit("g", GraphQuery.sssp(arg)),
                          jsvc.submit("g", JQuery.sssp(arg))))
    svc.drain()
    jsvc.drain()
    assert [(e["algorithm"], e["tickets"], e["fused"])
            for e in svc.execution_log] == \
        [(e["algorithm"], e["tickets"], e["fused"])
         for e in jsvc.execution_log]
    for t, jt in pairs:
        assert _bits(svc.result(t).value) == _bits(jsvc.result(jt).value)


def test_engines_share_fusion(graph):
    """The distributed (meshless, 4 shards) engine's fused batch equals
    the local engine's, column for column."""
    lo = LocalEngine(graph, device=CPU)
    di = DistributedEngine(graph, n_data=4, device=CPU)
    ps = [{"sources": (0,)}, {"sources": (9,)}]
    for a, b in zip(lo.run_batch("bfs", ps), di.run_batch("bfs", ps)):
        assert _bits(a.value) == _bits(b.value)
