"""The port's main path — ``GraphPlatform.query`` → ``service.call`` →
plan → engine — against the JAX reference platform.

Same graph bytes in both packages (``data/synthetic`` identifier edge
sets, the combined-connected-users input), same queries: CC labels and
counts, BFS and SSSP distances byte-equal; PageRank within ``tol * V``
in L1 (float32 sums in another order); the planner's engine and variant
choices equal.  Plus the device rule (no CUDA -> the default device
raises) and the import boundary (the port never imports jax or the
reference package).
"""
import dataclasses
import subprocess
import sys
from collections import OrderedDict
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import graph as JG  # noqa: E402
from repro.core import planner as JP  # noqa: E402
from repro.core.query import GraphPlatform as JPlatform  # noqa: E402
from repro.core.query import GraphQuery as JQuery  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import obs  # noqa: E402
from repro_torch.core import planner as TP  # noqa: E402
from repro_torch.core import pools as PL  # noqa: E402
from repro_torch.core.query import GraphPlatform, GraphQuery  # noqa: E402
from repro_torch.core.service import GraphAnalyticsService  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
V = 1200
CPU = "cpu"


@pytest.fixture(autouse=True)
def _analytic_calibration():
    """Pin both packages' planners to their analytic constants."""
    JP.set_calibration(None)
    TP.set_calibration(None)
    yield
    JP.set_calibration(None)
    TP.set_calibration(None)


def _edges(seed=3):
    sets = synthetic.identifier_edge_sets(V, n_sets=4, mean_degree=1.5,
                                          seed=seed)
    return (np.concatenate([s for s, _ in sets]),
            np.concatenate([d for _, d in sets]))


@pytest.fixture(scope="module")
def graphs():
    s, d = _edges()
    w = np.random.default_rng(5).uniform(0.5, 2.0, s.size).astype(np.float32)
    return (JG.build_coo(s, d, V, w=w, symmetrize=True),
            TG.build_coo(s, d, V, w=w, symmetrize=True, device=CPU))


@pytest.fixture(scope="module")
def unweighted():
    s, d = _edges()
    return (JG.build_coo(s, d, V, symmetrize=True),
            TG.build_coo(s, d, V, symmetrize=True, device=CPU))


def _bits(v):
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return np.ascontiguousarray(np.asarray(v)).tobytes()


SOURCES = (0, 300, 600, 900)
QUERIES = {
    "cc": (lambda Q: Q.connected_components()),
    "cc_count": (lambda Q: Q.connected_components(count_only=True)),
    "bfs": (lambda Q: Q.bfs(SOURCES)),
    "bfs_count": (lambda Q: Q.bfs(SOURCES, count_only=True)),
    "bfs_capped": (lambda Q: Q.bfs(SOURCES, max_iters=5)),
    "sssp": (lambda Q: Q.sssp(17)),
    "pagerank": (lambda Q: Q.pagerank(tol=1e-6)),
}


@pytest.mark.parametrize("name", sorted(QUERIES))
@pytest.mark.parametrize("force_engine", [None, "distributed"])
def test_platform_query_matches_reference(graphs, unweighted, name,
                                         force_engine):
    # PageRank folds 1/outdeg into the raw weights, so it is a
    # probability iteration only on unit weights
    jg, tg = unweighted if name == "pagerank" else graphs
    jp = JPlatform(jg, force_engine=force_engine)
    tp = GraphPlatform(tg, force_engine=force_engine, device=CPU)
    jq, tq = QUERIES[name](JQuery), QUERIES[name](GraphQuery)
    assert tq.key() == jq.key()
    jplan, tplan = jp.plan(jq), tp.plan(tq)
    assert (tplan.engine, tplan.variant, tplan.mode) == \
        (jplan.engine, jplan.variant, jplan.mode)
    assert tplan.reason == jplan.reason
    want, got = jp.query(jq), tp.query(tq)
    assert got.engine == want.engine
    assert got.meta.get("variant") == want.meta.get("variant")
    if name == "pagerank":
        err = np.abs(got.value.numpy().astype(np.float64)
                     - np.asarray(want.value, np.float64)).sum()
        assert err <= 1e-6 * V
        assert abs(got.iterations - want.iterations) <= 1
    else:
        if isinstance(want.value, int):
            assert got.value == want.value
        else:
            assert _bits(got.value) == _bits(want.value)
        assert got.iterations == want.iterations


def test_repeat_query_is_a_result_cache_hit(graphs):
    _, tg = graphs
    tp = GraphPlatform(tg, device=CPU)
    first = tp.query(GraphQuery.connected_components())
    runs = tp.local.n_runs
    again = tp.query(GraphQuery.connected_components())
    assert again.meta.get("cache") == "hit"
    assert tp.local.n_runs == runs
    assert _bits(again.value) == _bits(first.value)
    assert tp.cache_stats == {"hits": 1, "misses": 1}


@pytest.mark.parametrize("name", ["cc", "bfs", "sssp"])
@pytest.mark.parametrize("budget", [None, 16])
def test_realized_variant_is_reported(graphs, monkeypatch, name, budget):
    """The result says which superstep variant actually ran: the planned
    one within the uncapped-ELL budget, dense past it; a cache hit, which
    ran nothing, reports none."""
    from repro_torch.core import engines as E
    if budget is not None:
        monkeypatch.setattr(E, "SUPERSTEP_ELL_BUDGET", budget)
    _, tg = graphs
    tp = GraphPlatform(tg, device=CPU)
    q = QUERIES[name](GraphQuery)
    plan = tp.plan(q)
    assert plan.variant in ("fused", "frontier")
    first = tp.query(q)
    want = plan.variant if budget is None else "dense"
    assert first.meta["realized_variant"] == want
    again = tp.query(q)
    assert again.meta.get("cache") == "hit"
    assert "realized_variant" not in again.meta


def test_reloaded_snapshot_shares_the_cache(graphs):
    _, tg = graphs
    shared = OrderedDict()
    a = GraphPlatform(tg, device=CPU, result_cache=shared)
    a.query(GraphQuery.bfs([0]))
    clone = TG.GraphCOO(tg.src.clone(), tg.dst.clone(), tg.w.clone(),
                        tg.n_vertices, tg.n_edges, tg.symmetric)
    b = GraphPlatform(clone, device=CPU, result_cache=shared)
    assert b.query(GraphQuery.bfs([0])).meta.get("cache") == "hit"


def test_incremental_snapshot_matches_reference(graphs):
    """A delta version repairs the parent's cached CC/BFS result exactly,
    in both packages, with the same plan mode."""
    jg, tg = graphs
    from repro.core.service import GraphAnalyticsService as JService
    jsvc, tsvc = JService(), GraphAnalyticsService()
    jsvc.add_snapshot("g", jg, as_of=0)
    tsvc.add_snapshot("g", tg, as_of=0, device=CPU)
    added = [(5, 1100), (40, 41), (800, 20)]
    for name in ("cc", "bfs"):
        jq, tq = QUERIES[name](JQuery), QUERIES[name](GraphQuery)
        jsvc.call("g", jq)
        tsvc.call("g", tq)
    jsvc.add_snapshot("g", as_of=1, added=added)
    tsvc.add_snapshot("g", as_of=1, added=added, device=CPU)
    for name in ("cc", "bfs"):
        jq, tq = QUERIES[name](JQuery), QUERIES[name](GraphQuery)
        want, got = jsvc.call("g", jq), tsvc.call("g", tq)
        assert got.meta.get("mode") == want.meta.get("mode")
        assert got.meta["plan"].mode == want.meta["plan"].mode
        assert _bits(got.value) == _bits(want.value)
        old = tsvc.call("g", tq, as_of=0)
        assert _bits(old.value) == _bits(jsvc.call("g", jq, as_of=0).value)
    assert tsvc.metrics()["incremental"] == jsvc.metrics()["incremental"]


def test_submit_drain_matches_call(graphs):
    """Tickets through admission, tiers and the worker pool return the
    same bytes as the synchronous path."""
    _, tg = graphs
    svc = GraphAnalyticsService(workers=2, interactive_threshold_s=0.0,
                                trace_depth=8)
    svc.add_graph("g", tg, device=CPU)
    qs = [GraphQuery.bfs([0]), GraphQuery.bfs([7]), GraphQuery.sssp(3),
          GraphQuery.connected_components(count_only=True)]
    tickets = [svc.submit("g", q) for q in qs]
    assert {t.tier for t in tickets} == {"batch"}
    svc.drain()
    ref = GraphPlatform(tg, device=CPU)
    for t, q in zip(tickets, qs):
        got = svc.result(t).value
        want = ref.query(q).value
        assert _bits(got) == _bits(want) if not isinstance(want, int) \
            else got == want
    m = svc.metrics()
    assert m["counters"]["executed"] == len(qs)
    assert m["trace"]["tickets"] == len(qs)
    text = svc.metrics_text()
    assert obs.parse_prometheus(text)["gas_counters_executed"] == len(qs)
    assert "execute" in svc.explain(tickets[0])


def test_two_pool_federation_returns_the_same_bytes(graphs):
    _, tg = graphs
    pools = PL.default_pools(devices=[torch.device(CPU)],
                             cloud_compute_scale=0.5)
    svc = GraphAnalyticsService(pools=pools)
    svc.add_graph("g", tg, pools=["onprem"], device=CPU)
    r = svc.call("g", GraphQuery.bfs([0]))
    assert r.meta["plan"].pool in ("onprem", "cloud")
    ref = GraphPlatform(tg, device=CPU).query(GraphQuery.bfs([0]))
    assert _bits(r.value) == _bits(ref.value)


def test_registry_holds_the_slice():
    from repro_torch.core import registry as R
    assert R.names() == ["bfs", "connected_components", "degree_stats",
                         "k_core", "pagerank", "sssp", "triangle_count"]
    for name in ("bfs", "connected_components", "k_core", "sssp"):
        assert set(R.get(name).variants) == {"dense", "fused", "frontier"}
    assert set(R.get("triangle_count").variants) == {"bitset", "intersect"}
    assert R.get("k_core").incremental is not None


@pytest.mark.parametrize("algo", ["bfs", "sssp", "connected_components",
                                  "pagerank"])
@pytest.mark.parametrize("n_vertices,n_edges", [(10**3, 10**4),
                                                (10**6, 5 * 10**6),
                                                (2**24, 2 * 10**8),
                                                (10**9, 10**10)])
def test_planner_choices_match_reference(algo, n_vertices, n_edges):
    js = JP.GraphStats(n_vertices, n_edges, 12 * n_edges)
    ts = TP.GraphStats(n_vertices, n_edges, 12 * n_edges)
    for count_only in (False, True):
        jspecs = JP.specs_for(algo, js, count_only=count_only)
        tspecs = TP.specs_for(algo, ts, count_only=count_only)
        assert [dataclasses.astuple(s) for s in tspecs] == \
            [dataclasses.astuple(s) for s in jspecs]
        jplan = JP.choose_plan(js, jspecs, 4)
        tplan = TP.choose_plan(ts, tspecs, 4)
        assert (tplan.engine, tplan.variant, tplan.reason) == \
            (jplan.engine, jplan.variant, jplan.reason)


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="checks the CUDA-less default")
def test_default_device_raises_without_cuda(graphs):
    _, tg = graphs
    s, d = _edges()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TG.build_coo(s, d, V)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphPlatform(tg)
    with pytest.raises(RuntimeError, match="CUDA"):
        PL.default_pools()


def test_port_imports_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import repro_torch.core.query, repro_torch.core.service\n"
            "import repro_torch.core.algorithms\n"
            "import repro_torch.core.algorithms.triangles\n"
            "import repro_torch.kernels.ell_intersect\n"
            "import repro_torch.kernels.ell_combine\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
