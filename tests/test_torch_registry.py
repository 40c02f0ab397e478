"""Mirror of ``tests/test_registry.py``: the algorithm registry, engine
parity, host oracles, schema validation, the result cache and runtime
registration, in the port against the reference.

Each case runs the reference test's body on both packages
(``torch_parity.both``), keeps its assertions, and records what the two
must agree on.  Tolerance: none for ids, labels, counts, pairs,
distances and cache statistics (byte-equal); PageRank and HITS within
1e-6 (their float sums run in another order; the reference's own test
holds PageRank to networkx within 1e-6); the schema errors by exception
type.
"""
from collections import OrderedDict

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_parity import (PORT, REF, Pair, approx, both, edges, host,  # noqa: E402
                          pin_analytic, plan_rec, raised, result)

N = 300

PARAM_OVERRIDES = {
    "two_hop": {"dedup": True},
    "pagerank": {"tol": 1e-10},
}
FLOAT_TOL = {"pagerank": 1e-6, "hits": 1e-6}


@pytest.fixture(autouse=True)
def _analytic_calibration():
    pin_analytic()
    yield
    pin_analytic()


def _graphs(M):
    src, dst = M.S.user_follow_graph(N, 4.0, seed=13)
    keep = src != dst
    return {False: M.build_coo(src, dst, N),
            True: M.build_coo(src[keep], dst[keep], N, symmetrize=True)}


@pytest.fixture(scope="module")
def graphs():
    return Pair.build(_graphs)


@pytest.fixture(scope="module")
def engines(graphs):
    def build(M):
        built = {}
        for sym, g in graphs[M.name].items():
            maxdeg = int(np.bincount(edges(g)[1], minlength=N).max())
            built[sym] = (M.LocalEngine(g, max_degree=maxdeg),
                          M.DistributedEngine(g, n_data=4,
                                              max_degree=maxdeg))
        return built
    return Pair.build(build)


def _case_params(defn):
    if defn.name in PARAM_OVERRIDES:
        return {**(defn.example_params or {}), **PARAM_OVERRIDES[defn.name]}
    return dict(defn.example_params)


def _assert_same(a, b, ctx=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), ctx
        for k in a:
            _assert_same(a[k], b[k], f"{ctx}[{k}]")
        return
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), ctx
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{ctx}[{i}]")
        return
    a, b = host(a), host(b)
    assert a.shape == b.shape, ctx
    if np.issubdtype(a.dtype, np.floating):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=ctx)
    else:
        np.testing.assert_array_equal(a, b, err_msg=ctx)


def _value(name, v):
    """A value for the cross-package record: exact, or within the
    algorithm's tolerance for the float fixpoints."""
    if name not in FLOAT_TOL:
        return v
    if isinstance(v, dict):
        return {k: approx(x, FLOAT_TOL[name]) for k, x in v.items()}
    return approx(v, FLOAT_TOL[name])


def test_every_registration_declares_parity_params():
    def case(M):
        names = []
        for name, defn in M.R.items():
            assert defn.example_params is not None \
                or name in PARAM_OVERRIDES, name
            names.append([name, defn.example_params, defn.engines,
                          defn.requires_symmetric, defn.has_count_path,
                          sorted(defn.variants or ())])
        return names
    both(case)


@pytest.mark.parametrize("name", REF.R.names())
def test_engine_parity(name, engines):
    def case(M, engines):
        defn = M.R.get(name)
        params = _case_params(defn)
        local, dist = engines[defn.requires_symmetric]
        r_local = local.run(defn, params)
        assert r_local.engine == "local"
        rec = [_value(name, r_local.value), r_local.iterations]
        if "distributed" in defn.engines:
            r_dist = dist.run(defn, params)
            assert r_dist.engine == "distributed"
            _assert_same(r_local.value, r_dist.value, f"{name} full result")
            rec += [_value(name, r_dist.value), r_dist.iterations]
        if defn.has_count_path:
            c_local = local.run(defn, params, count_only=True)
            assert host(c_local.value).size == 1, name
            rec.append(c_local.value)
            if "distributed" in defn.engines:
                c_dist = dist.run(defn, params, count_only=True)
                _assert_same(c_local.value, c_dist.value, f"{name} count")
                rec.append(c_dist.value)
        return rec
    assert REF.R.names() == PORT.R.names()
    both(case, engines)


def test_parity_oracles(graphs, engines):
    def case(M, graphs, engines):
        cc = M.alg("connected_components")
        pr = M.alg("pagerank")
        tr = M.alg("traversal")
        tri = M.alg("triangles")
        th = M.alg("two_hop")
        dig, sym = graphs[False], graphs[True]
        s, d, w = edges(dig)
        ss, sd, _ = edges(sym)
        lod, los = engines[False][0], engines[True][0]
        rec = []
        ref, _ = pr.pagerank_reference(s, d, N, tol=1e-10)
        got = host(lod.run("pagerank", {"tol": 1e-10}).value)
        np.testing.assert_allclose(got, ref, atol=1e-6)
        rec.append(approx(got, 1e-6))
        got = host(los.run("connected_components").value)
        np.testing.assert_array_equal(
            got, cc.connected_components_reference(ss, sd, N))
        rec.append(got)
        got = host(lod.run("bfs", {"sources": (0,)}).value)
        np.testing.assert_array_equal(got,
                                      tr.bfs_reference(s, d, N, [0]))
        rec.append(got)
        got = host(lod.run("sssp", {"source": 0}).value)
        np.testing.assert_allclose(got, tr.sssp_reference(s, d, w, N, 0),
                                   atol=1e-5)
        rec.append(got)
        tc = los.run("triangle_count").value
        assert tc == tri.triangle_count_reference(ss, sd, N)
        rec.append(int(tc))
        got = host(los.run("k_core", {"k": 3}).value)
        np.testing.assert_array_equal(got,
                                      tri.k_core_reference(ss, sd, N, 3))
        rec.append(got)
        pairs, valid, count = lod.run("two_hop").value
        got = {(int(p[0]), int(p[1]))
               for p, ok in zip(host(pairs), host(valid)) if ok}
        ref_pairs = th.two_hop_reference(s, d, N)
        assert got == ref_pairs and count == len(ref_pairs)
        rec += [sorted(got), int(count)]
        u, v = 0, 1
        nbrs = [set() for _ in range(N)]
        for a, b in zip(s, d):
            nbrs[int(b)].add(int(a))
        union = len(nbrs[u] | nbrs[v])
        want = len(nbrs[u] & nbrs[v]) / union if union else 0.0
        got_j = float(host(lod.run("jaccard",
                                   {"u": [u], "v": [v]}).value)[0])
        assert got_j == pytest.approx(want)
        rec.append(got_j)
        return rec
    both(case, graphs, engines)


def test_two_hop_count_consistent_across_engines_and_exact(graphs):
    def case(M, graphs):
        dig = graphs[False]
        deg = np.bincount(edges(dig)[1], minlength=N).astype(np.int64)
        want = int((deg * (deg - 1) // 2).sum())
        lo = M.LocalEngine(dig, max_degree=2)
        di = M.DistributedEngine(dig, n_data=4, max_degree=2)
        got = [int(lo.two_hop_count().value), int(di.two_hop_count().value)]
        assert got == [want, want]
        return got
    both(case, graphs)


def test_distributed_two_hop_ell_cached(graphs):
    def case(M, graphs):
        eng = M.DistributedEngine(graphs[False], n_data=4)
        first = eng.run("two_hop").value
        assert eng._ell is not None
        ell = eng._ell
        again = eng.run("two_hop").value
        assert eng._ell is ell
        return [first, again]
    both(case, graphs)


# ------------------------------------------------------ schema validation

SCHEMA_ERRORS = {
    "unknown_algorithm": (KeyError, "unknown algorithm",
                          lambda M: M.GraphQuery.of("page_rank")),
    "unknown_param": (ValueError, "unknown parameter",
                      lambda M: M.GraphQuery.of("pagerank", aplha=0.9)),
    "missing_required": (ValueError, "missing required",
                         lambda M: M.GraphQuery.of("bfs")),
    "invalid_alpha": (ValueError, "invalid value",
                      lambda M: M.GraphQuery.of("pagerank", alpha=1.5)),
    "invalid_k": (ValueError, "invalid value",
                  lambda M: M.GraphQuery.of("k_core", k=0)),
}


@pytest.mark.parametrize("name", sorted(SCHEMA_ERRORS))
def test_schema_rejections_match(name):
    exc, match, make = SCHEMA_ERRORS[name]

    def case(M):
        with pytest.raises(exc, match=match):
            make(M)
        return raised(make, M)
    both(case)


def test_defaults_filled_and_normalized():
    def case(M):
        q = M.GraphQuery.of("pagerank")
        assert q.params == {"alpha": 0.85, "tol": 1e-8, "max_iters": 100}
        q2 = M.GraphQuery.of("bfs", sources=[3, 1])
        assert q2.params["sources"] == (3, 1)
        return [q.algorithm, q.params, q2.params, q2.count_only]
    both(case)


def test_engine_capability_flags(graphs):
    def case(M, graphs):
        defn = M.R.get("jaccard")
        assert defn.engines == ("local",)
        with pytest.raises(ValueError, match="supports engine"):
            M.DistributedEngine(graphs[False], n_data=4).run(
                "jaccard", {"u": [0], "v": [1]})
        plat = M.GraphPlatform(graphs[False], force_engine="distributed")
        r = plat.query(M.GraphQuery.of("jaccard", u=[0], v=[1]))
        assert r.engine == "local"
        assert "local" in r.meta["plan"].reason
        return result(r)
    both(case, graphs)


# ---------------------------------------------------------- result cache

def _platform(M, graphs):
    return M.GraphPlatform(graphs[True], n_data=4)


def test_repeated_query_served_from_cache(graphs):
    def case(M, graphs):
        platform = _platform(M, graphs)
        r1 = platform.query(M.GraphQuery.connected_components(
            count_only=True))
        runs = platform.local.n_runs + (
            platform._dist.n_runs if platform._dist else 0)
        r2 = platform.query(M.GraphQuery.connected_components(
            count_only=True))
        assert r2.value == r1.value
        assert r2.meta.get("cache") == "hit"
        assert "cache" not in r1.meta
        assert platform.local.n_runs + (
            platform._dist.n_runs if platform._dist else 0) == runs
        assert platform.cache_stats == {"hits": 1, "misses": 1}
        return [result(r1), result(r2), platform.cache_stats, runs]
    both(case, graphs)


def test_differing_params_miss(graphs):
    def case(M, graphs):
        platform = _platform(M, graphs)
        Q = M.GraphQuery
        rs = [platform.query(Q.connected_components(count_only=True)),
              platform.query(Q.connected_components(count_only=True,
                                                    max_iters=199)),
              platform.query(Q.connected_components(count_only=False))]
        assert platform.cache_stats["hits"] == 0
        assert platform.cache_stats["misses"] == 3
        return [[result(r) for r in rs], platform.cache_stats]
    both(case, graphs)


def test_cache_engine_independent(graphs):
    def case(M, graphs):
        auto = M.GraphPlatform(graphs[True], n_data=4)
        forced = M.GraphPlatform(graphs[True], n_data=4,
                                 force_engine="distributed")
        q = M.GraphQuery.connected_components(count_only=True)
        assert auto.query(q).engine == "local"
        assert forced.query(q).engine == "distributed"
        assert auto.query(q).value == forced.query(q).value
        shared = OrderedDict()
        local = M.GraphPlatform(graphs[True], n_data=4, result_cache=shared)
        first = local.query(q)
        assert first.engine == "local"
        re_planned = M.GraphPlatform(graphs[True], n_data=4,
                                     force_engine="distributed",
                                     result_cache=shared)
        r = re_planned.query(q)
        assert r.meta.get("cache") == "hit"
        assert r.value == first.value
        assert re_planned._dist is None
        return [result(first), result(r), auto.cache_stats,
                forced.cache_stats, re_planned.cache_stats]
    both(case, graphs)


def test_cache_lru_eviction(graphs):
    def case(M, graphs):
        plat = M.GraphPlatform(graphs[True], cache_size=1)
        q_a = M.GraphQuery.connected_components(count_only=True)
        q_b = M.GraphQuery.degree_stats()
        plat.query(q_a)
        plat.query(q_b)
        plat.query(q_a)
        assert plat.cache_stats == {"hits": 0, "misses": 3}
        r = plat.query(q_a)
        assert plat.cache_stats["hits"] == 1
        return [result(r), plat.cache_stats]
    both(case, graphs)


def test_cache_disabled(graphs):
    def case(M, graphs):
        plat = M.GraphPlatform(graphs[True], cache_size=0)
        q = M.GraphQuery.connected_components(count_only=True)
        plat.query(q)
        r = plat.query(q)
        assert r.meta.get("cache") is None
        assert plat.cache_stats == {"hits": 0, "misses": 2}
        return [result(r), plat.cache_stats]
    both(case, graphs)


def test_plan_cache_returns_same_plan(graphs):
    def case(M, graphs):
        platform = _platform(M, graphs)
        p1 = platform.plan(M.GraphQuery.pagerank())
        p2 = platform.plan(M.GraphQuery.pagerank())
        assert p1 is p2
        return plan_rec(p1)
    both(case, graphs)


# ------------------------------------------- registration as extension

def test_register_new_algorithm_end_to_end(graphs):
    name = "scaled_in_degree_test"

    def case(M, graphs):
        def _run(eng, scale):
            return M.G.in_degrees(eng.coo) * scale, 1

        M.R.register(M.R.AlgorithmDef(
            name=name, run=_run,
            params=(M.R.Param("scale", 1.0, check=lambda s: s > 0,
                              normalize=float),),
            count=lambda v: float(host(v).max()),
            count_method="max_scaled_in_degree_test",
            cost=lambda g, params, count_only: M.P.QuerySpec(
                name, 1 if count_only else g.n_vertices, iterations=1),
        ))
        try:
            plat = M.GraphPlatform(graphs[False], n_data=4)
            q = M.GraphQuery.of(name, scale=2.0)
            plan = plat.plan(q)
            assert plan.engine in ("local", "distributed")
            r = plat.query(q)
            np.testing.assert_allclose(
                host(r.value),
                2.0 * np.bincount(edges(graphs[False])[1], minlength=N))
            hit = plat.query(M.GraphQuery.of(name, scale=2.0))
            assert hit.meta["cache"] == "hit"
            lo = M.LocalEngine(graphs[False])
            di = M.DistributedEngine(graphs[False], n_data=4)
            v_lo = lo.run(name, {"scale": 2.0}).value
            v_di = di.run(name, {"scale": 2.0}).value
            np.testing.assert_allclose(host(v_lo), host(v_di))
            top = lo.max_scaled_in_degree_test(scale=2.0).value
            assert top == float(host(r.value).max())
            rec = [plan_rec(plan), result(r), result(hit), v_lo, v_di, top]
        finally:
            M.R.unregister(name)
        with pytest.raises(KeyError):
            M.R.get(name)
        return rec
    both(case, graphs)
