"""Mirror of ``tests/test_planner.py``: the cost-based router in the port
against the reference.

Each case runs the reference test's body on both packages
(``torch_parity.both``), keeps its assertions, and holds the two to the
same records: every plan's (engine, variant, pool, mode), its estimates
and reason, and the candidate table, entry for entry.  Tolerance: none
(the cost model is the same float arithmetic on the same stats).
"""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_parity import PORT, REF, both, pin_analytic, plan_rec, raised  # noqa: E402


@pytest.fixture(autouse=True)
def _analytic_calibration():
    pin_analytic()
    yield
    pin_analytic()


def _stats(M, v, e):
    return M.P.GraphStats(n_vertices=v, n_edges=e, bytes_coo=e * 12)


def _small_graph_small_output_routes_local(M):
    g = _stats(M, 400_000, 2_000_000)
    q = M.P.spec_for("connected_components", g, count_only=True)
    plan = M.P.choose_engine(g, q, 256)
    assert plan.engine == "local"
    return [q, plan_rec(plan)]


def _huge_graph_routes_distributed(M):
    g = _stats(M, 2_410_000_000, 1_500_000_000)
    q = M.P.spec_for("connected_components", g)
    plan = M.P.choose_engine(g, q, 256)
    assert plan.engine == "distributed"
    assert plan.est_local_s == float("inf")
    return [q, plan_rec(plan)]


def _multi_account_scale_routes_distributed(M):
    g = _stats(M, 14_890_000_000, 30_860_000_000)
    q = M.P.spec_for("two_hop", g)
    plan = M.P.choose_engine(g, q, 256)
    assert plan.engine == "distributed"
    return [q, plan_rec(plan)]


def _output_cardinality_flips_engine(M):
    g = _stats(M, 10_000_000, 50_000_000)
    q_count = M.P.spec_for("connected_components", g, count_only=True)
    q_pairs = M.P.spec_for("two_hop", g, expected_pairs=2_000_000_000)
    plan_count = M.P.choose_engine(g, q_count, 256)
    plan_pairs = M.P.choose_engine(g, q_pairs, 256)
    assert plan_count.engine == "local"
    assert plan_pairs.engine == "distributed"
    return [plan_rec(plan_count), plan_rec(plan_pairs)]


def _crossover_exists(M):
    q_engine, plans = [], []
    for v in [10**4, 10**5, 10**6, 10**7, 10**8, 10**9, 10**10]:
        g = _stats(M, v, v * 5)
        plan = M.P.choose_engine(g, M.P.spec_for("pagerank", g), 256)
        q_engine.append(plan.engine)
        plans.append(plan_rec(plan))
    assert q_engine[0] == "local" and q_engine[-1] == "distributed"
    assert sum(a != b for a, b in zip(q_engine, q_engine[1:])) == 1
    return plans


def _cost_estimates_positive_and_ordered(M):
    g = _stats(M, 1_000_000, 8_000_000)
    q = M.P.spec_for("pagerank", g)
    tl = M.P.estimate_local_cost(g, q)
    td = M.P.estimate_dist_cost(g, q, 256)
    assert tl > 0 and td > 0
    return [tl, td]


def _triangle_bitset_state_crosses_before_scalar_programs(M):
    def crossover(algorithm):
        for v in [10**3, 10**4, 10**5, 10**6, 10**7, 10**8, 10**9, 10**10]:
            g = _stats(M, v, v * 5)
            if M.P.choose_engine(g, M.P.spec_for(algorithm, g),
                                 256).engine == "distributed":
                return v
        return None
    tri, cc = crossover("triangle_count"), crossover("connected_components")
    assert tri < cc
    return [tri, cc]


def _user_max_iters_flows_into_cost(M):
    g = _stats(M, 1_000_000, 5_000_000)
    its = [M.P.spec_for("connected_components", g).iterations,
           M.P.spec_for("connected_components", g, max_iters=4).iterations,
           M.P.spec_for("bfs", g).iterations,
           M.P.spec_for("bfs", g, max_iters=3).iterations,
           M.P.spec_for("pagerank", g, max_iters=10).iterations,
           M.P.spec_for("pagerank", g, max_iters=500).iterations]
    assert its == [16, 4, 12, 3, 10, 40]
    tight = M.P.estimate_local_cost(g, M.P.spec_for("pagerank", g,
                                                    max_iters=5))
    loose = M.P.estimate_local_cost(g, M.P.spec_for("pagerank", g))
    assert tight < loose
    return [its, tight, loose]


def _spec_for_rejects_unknown_params(M):
    g = _stats(M, 1_000, 5_000)
    with pytest.raises(ValueError, match="unknown parameter"):
        M.P.spec_for("pagerank", g, iters=10)
    return raised(M.P.spec_for, "pagerank", g, iters=10)


def _platform_plan_for_new_queries(M):
    src, dst = np.array([0, 1, 2]), np.array([1, 2, 0])
    plat = M.GraphPlatform(M.build_coo(src, dst, 3, symmetrize=True))
    out = []
    for q in [M.GraphQuery.bfs([0]), M.GraphQuery.sssp(0),
              M.GraphQuery.label_propagation(),
              M.GraphQuery.triangle_count(), M.GraphQuery.k_core(2)]:
        plan = plat.plan(q)
        assert plan.engine == "local"
        out.append(plan_rec(plan))
    return out


CASES = {
    "small_graph_small_output_routes_local":
        _small_graph_small_output_routes_local,
    "huge_graph_routes_distributed": _huge_graph_routes_distributed,
    "multi_account_scale_routes_distributed":
        _multi_account_scale_routes_distributed,
    "output_cardinality_flips_engine": _output_cardinality_flips_engine,
    "crossover_exists": _crossover_exists,
    "cost_estimates_positive_and_ordered":
        _cost_estimates_positive_and_ordered,
    "triangle_bitset_state_crosses_before_scalar_programs":
        _triangle_bitset_state_crosses_before_scalar_programs,
    "user_max_iters_flows_into_cost": _user_max_iters_flows_into_cost,
    "spec_for_rejects_unknown_params": _spec_for_rejects_unknown_params,
    "platform_plan_for_new_queries": _platform_plan_for_new_queries,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_planner_matches_reference(name):
    both(CASES[name])


ALL_ALGORITHMS = ["pagerank", "connected_components", "two_hop",
                  "degree_stats", "bfs", "sssp", "label_propagation",
                  "triangle_count", "k_core"]


def _spec_and_plan(M, algorithm):
    g = _stats(M, 1_000_000, 5_000_000)
    out = []
    for count_only in (False, True):
        q = M.P.spec_for(algorithm, g, count_only=count_only)
        assert q.iterations >= 1 and q.output_rows >= 1
        plan = M.P.choose_engine(g, q, 256)
        assert plan.engine in ("local", "distributed")
        assert plan.est_dist_s > 0 and plan.est_dist_s != float("inf")
        assert plan.reason
        out.append([q, plan_rec(plan)])
    return out


@pytest.mark.parametrize("algorithm", ALL_ALGORITHMS)
def test_spec_and_plan_exist_for_every_algorithm(algorithm):
    both(_spec_and_plan, algorithm)


def _crosses_over_once(M, algorithm):
    engines = []
    for v in [10**3, 10**4, 10**5, 10**6, 10**7, 10**8, 10**9, 10**10]:
        g = _stats(M, v, v * 5)
        engines.append(M.P.choose_engine(g, M.P.spec_for(algorithm, g),
                                         256).engine)
    assert engines[0] == "local" and engines[-1] == "distributed"
    assert sum(a != b for a, b in zip(engines, engines[1:])) == 1
    return engines


@pytest.mark.parametrize("algorithm", ALL_ALGORITHMS)
def test_every_algorithm_crosses_over_once(algorithm):
    both(_crosses_over_once, algorithm)


def _fitted_profile_plans(M, profile_path):
    """Both planners under one profile: the port's checked-in card fit."""
    M.P.load_calibration(profile_path)
    out = []
    for algo in ("bfs", "sssp", "connected_components", "k_core",
                 "pagerank", "triangle_count"):
        for v, e in ((10**3, 10**4), (2**20, 2**22), (2**24, 2**27)):
            g = _stats(M, v, e)
            out.append(plan_rec(M.P.choose_plan(
                g, M.P.specs_for(algo, g), 1)))
    return out


def test_fitted_profile_gives_the_same_plans():
    """Pinned to one profile (the port's card fit, loaded into both),
    the two planners choose and price alike."""
    both(_fitted_profile_plans, PORT.P.reference_profile_path())
    assert REF.P.active_calibration().source == \
        PORT.P.active_calibration().source
