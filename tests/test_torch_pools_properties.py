"""Mirror of ``tests/test_pools_properties.py``: federation placement
monotonicity in the port against the reference, under generated graph
shapes, compute scales and link bandwidths.

Each example runs the reference property on both planners and holds
the two to the same placements and prices (``torch_parity.both``).
Tolerance: none (the same float arithmetic on the same stats).
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="optional test dep: hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from torch_parity import both, pin_analytic, plan_rec  # noqa: E402


@pytest.fixture(autouse=True)
def _analytic_calibration():
    pin_analytic()
    yield
    pin_analytic()


def _stats(M, n_vertices, degree):
    n_edges = n_vertices * degree
    return M.P.GraphStats(n_vertices, n_edges, n_edges * 12)


def _plan(M, stats, onprem_bw, cloud_bw, cloud_scale, resident):
    ps = M.PL.PoolSet([
        M.PL.DevicePool("onprem", link_bandwidth=onprem_bw),
        M.PL.DevicePool("cloud", link_bandwidth=cloud_bw,
                        compute_scale=cloud_scale),
    ])
    return M.P.choose_plan(stats, M.P.specs_for("pagerank", stats), 4,
                           pools=ps.pools(), resident=resident)


shapes = dict(n_vertices=st.integers(100, 10_000_000),
              degree=st.integers(1, 64),
              cloud_scale=st.floats(0.01, 2.0),
              bw=st.floats(1.0, 1e12))


@settings(max_examples=60, deadline=None)
@given(shrink=st.floats(1.5, 1e6), **shapes)
def test_raising_remote_transfer_cost_never_attracts_work(
        n_vertices, degree, cloud_scale, bw, shrink):
    def case(M):
        stats = _stats(M, n_vertices, degree)
        before = _plan(M, stats, bw, bw, cloud_scale, resident={"onprem"})
        after = _plan(M, stats, bw / shrink, bw / shrink, cloud_scale,
                      resident={"onprem"})
        if before.pool == "onprem":
            assert after.pool == "onprem"
        if after.pool == "cloud":
            assert before.pool == "cloud"
        return [plan_rec(before), plan_rec(after)]
    both(case)


@settings(max_examples=60, deadline=None)
@given(**shapes)
def test_revoking_residency_never_attracts_work(
        n_vertices, degree, cloud_scale, bw):
    def case(M):
        stats = _stats(M, n_vertices, degree)
        both_ = _plan(M, stats, bw, bw, cloud_scale,
                      resident={"onprem", "cloud"})
        revoked = _plan(M, stats, bw, bw, cloud_scale, resident={"onprem"})
        if both_.pool == "onprem":
            assert revoked.pool == "onprem"
        if revoked.pool == "cloud":
            assert both_.pool == "cloud"
        return [plan_rec(both_), plan_rec(revoked)]
    both(case)


@settings(max_examples=60, deadline=None)
@given(**shapes)
def test_pool_costs_are_what_the_plan_says(
        n_vertices, degree, cloud_scale, bw):
    def case(M):
        stats = _stats(M, n_vertices, degree)
        plan = _plan(M, stats, bw, bw, cloud_scale, resident={"onprem"})
        specs = [s for s in M.P.specs_for("pagerank", stats)
                 if s.variant == plan.variant]
        assert len(specs) == 1
        base = (M.P.estimate_local_cost(stats, specs[0])
                if plan.engine == "local"
                else M.P.estimate_dist_cost(stats, specs[0], 4))
        scale = cloud_scale if plan.pool == "cloud" else 1.0
        assert plan.est_s == pytest.approx(scale * base + plan.transfer_s,
                                           rel=1e-9)
        assert M.P.plan_cost(plan) == plan.est_s
        return [plan_rec(plan), base]
    both(case)
