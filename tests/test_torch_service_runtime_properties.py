"""Mirror of ``tests/test_service_runtime_properties.py``: the service
runtime's pure invariants in the port against the reference —
``RetryPolicy``'s bounds and seeded schedules, and backpressure under
any interleaving of submits and drains.

Each generated example runs the reference property in both packages
and holds the two to the same schedules, admission and backpressure
decisions, depths and counters (``torch_parity.both``).  Tolerance:
none.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from torch_parity import Pair, both, pin_analytic  # noqa: E402


@pytest.fixture(autouse=True)
def _analytic_calibration():
    pin_analytic()
    yield
    pin_analytic()


policy_args = st.fixed_dictionaries(dict(
    max_attempts=st.integers(min_value=1, max_value=8),
    base_s=st.floats(min_value=0.0, max_value=0.01,
                     allow_nan=False, allow_infinity=False),
    cap_s=st.floats(min_value=0.01, max_value=1.0,
                    allow_nan=False, allow_infinity=False),
    multiplier=st.floats(min_value=1.0, max_value=8.0,
                         allow_nan=False, allow_infinity=False),
))


@given(kw=policy_args, seed=st.integers(min_value=0, max_value=2**63))
@settings(max_examples=200, deadline=None)
def test_backoff_schedule_invariants(kw, seed):
    def case(M):
        policy = M.RetryPolicy(**kw)
        bounds = policy.bounds()
        sched = policy.schedule(seed)
        assert len(bounds) == len(sched) == policy.max_attempts - 1
        assert all(b1 <= b2 for b1, b2 in zip(bounds, bounds[1:]))
        assert all(policy.base_s <= b <= policy.cap_s for b in bounds)
        eps = 1e-12
        for s, b in zip(sched, bounds):
            assert policy.base_s - eps <= s <= b + eps
        assert policy.schedule(seed) == sched
        return [bounds, sched]
    both(case)


@given(st.integers(min_value=0, max_value=2**31))
@settings(max_examples=50, deadline=None)
def test_backoff_schedule_hash_seed_independent(seed):
    def case(M):
        pol = M.RetryPolicy(max_attempts=6, base_s=1e-3, cap_s=0.1)
        a = pol.schedule(seed)
        assert a == pol.schedule(seed)
        runs = [pol.schedule(s) for s in (seed, seed + 1, seed + 2)]
        assert len(set(runs)) >= 2
        return runs
    both(case)


@pytest.fixture(scope="module")
def small_graph():
    def build(M):
        src, dst = M.S.user_follow_graph(64, 3.0, seed=3)
        return M.build_coo(src, dst, 64)
    return Pair.build(build)


op_sequences = st.lists(st.booleans(), min_size=1, max_size=24)


@given(ops=op_sequences, budget=st.integers(min_value=1, max_value=3))
@settings(max_examples=40, deadline=None)
def test_backpressure_depth_never_exceeds_budget(small_graph, ops, budget):
    def case(M, small_graph):
        svc = M.GraphAnalyticsService(interactive_threshold_s=0.0,
                                      tier_depth={"batch": budget},
                                      cache_size=0)
        svc.add_graph("g", small_graph, force_engine="local")
        source, admitted, rejected, trail = 0, 0, 0, []
        for do_submit in ops:
            if do_submit:
                try:
                    svc.submit("g", M.GraphQuery.bfs([source % 64]))
                    admitted += 1
                    trail.append("admitted")
                except M.Backpressure as e:
                    rejected += 1
                    assert e.depth >= e.budget == budget
                    trail.append(("backpressure", e.depth, e.budget))
                source += 1
            else:
                trail.append(("drained", len(svc.drain())))
            depths = svc.metrics()["queue_depths"]
            assert all(d <= budget for d in depths.values()), depths
            trail.append(depths)
        m = svc.metrics()
        assert m["counters"]["submitted"] == admitted
        assert m["counters"]["backpressure"] == rejected
        svc.drain()
        assert not svc.pending()
        assert all(d == 0 for d in svc.metrics()["queue_depths"].values())
        return [trail, m["counters"]]
    both(case, small_graph)
