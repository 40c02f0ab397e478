"""HITS in the port: mirrors of ``tests/test_hits.py`` on CPU tensors,
plus parity with the JAX reference on the same graphs.

Tolerances: the float64 oracle within ``atol`` 1e-4 (as the reference's
own test: float32 device sums against float64 host sums); the reference
package within ``atol`` 1e-5 (both float32, summation order differs);
role-graph buffers and iteration counts exactly.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import graph as JG  # noqa: E402
from repro.core import planner as JP  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core import planner as P  # noqa: E402
from repro_torch.core import registry as R  # noqa: E402
from repro_torch.core.engines import DistributedEngine, LocalEngine  # noqa: E402
from repro_torch.core.query import GraphPlatform, GraphQuery  # noqa: E402
from repro_torch.data import synthetic as S  # noqa: E402

th = importlib.import_module("repro_torch.core.algorithms.hits")
jh = importlib.import_module("repro.core.algorithms.hits")

CPU = "cpu"


@pytest.fixture(autouse=True)
def _analytic_calibration():
    JP.set_calibration(None)
    P.set_calibration(None)
    yield
    JP.set_calibration(None)
    P.set_calibration(None)


def _graph(n=250, seed=3):
    src, dst = S.user_follow_graph(n, 4.0, seed=seed)
    return G.build_coo(src, dst, n, device=CPU), src, dst


def test_hits_matches_numpy_oracle():
    g, src, dst = _graph()
    got, _ = th.hits(g)
    want, _ = th.hits_reference(src, dst, g.n_vertices)
    # same schedule, float32 device vs float64 host
    np.testing.assert_allclose(got["hubs"].numpy(), want["hubs"], atol=1e-4)
    np.testing.assert_allclose(got["authorities"].numpy(),
                               want["authorities"], atol=1e-4)


def test_hits_against_networkx():
    networkx = pytest.importorskip("networkx")
    g, src, dst = _graph(n=120, seed=9)
    got, _ = th.hits(g, max_iters=200, tol=1e-10)
    gg = networkx.DiGraph()
    gg.add_nodes_from(range(g.n_vertices))
    gg.add_edges_from(zip(src.tolist(), dst.tolist()))
    h_ref, a_ref = networkx.hits(gg, max_iter=500, tol=1e-12)
    h_ref = np.array([h_ref[i] for i in range(g.n_vertices)])
    a_ref = np.array([a_ref[i] for i in range(g.n_vertices)])

    def l1(x):    # networkx L1-normalizes; compare directions
        x = np.abs(np.asarray(x, np.float64))
        return x / max(x.sum(), 1e-12)
    np.testing.assert_allclose(l1(got["hubs"]), l1(h_ref), atol=1e-4)
    np.testing.assert_allclose(l1(got["authorities"]), l1(a_ref), atol=1e-4)


def test_hits_star_graph():
    """Edges all point at vertex 0: it is the sole authority, and every
    spoke is an equal hub."""
    n = 6
    src = np.arange(1, n)
    dst = np.zeros(n - 1, dtype=np.int64)
    g = G.build_coo(src, dst, n, device=CPU)
    got, _ = th.hits(g)
    auth = got["authorities"].numpy()
    hubs = got["hubs"].numpy()
    assert auth[0] == pytest.approx(1.0)
    np.testing.assert_allclose(auth[1:], 0.0, atol=1e-7)
    assert hubs[0] == pytest.approx(0.0, abs=1e-7)
    np.testing.assert_allclose(hubs[1:], hubs[1], atol=1e-6)


def test_hits_empty_graph_is_finite():
    g = G.build_coo(np.array([], np.int64), np.array([], np.int64), 4,
                    device=CPU)
    got, _ = th.hits(g, max_iters=4)
    assert torch.isfinite(got["hubs"]).all()
    assert torch.isfinite(got["authorities"]).all()


def test_role_graph_shape():
    g, src, dst = _graph(n=50, seed=1)
    rg = th.role_graph(g)
    assert rg.n_vertices == 2 * g.n_vertices
    assert rg.n_edges == 2 * g.n_edges


def test_hits_registered_via_discovery():
    assert "hits" in R.names()
    defn = R.get("hits")
    assert defn.engines == ("local", "distributed")


def test_hits_engine_parity_and_cached_shards():
    g, _, _ = _graph()
    lo = LocalEngine(g, device=CPU)
    di = DistributedEngine(g, n_data=4, device=CPU)
    r_lo, r_di = lo.hits(), di.hits()
    np.testing.assert_allclose(r_lo.value["hubs"].numpy(),
                               r_di.value["hubs"].numpy(), atol=1e-5)
    np.testing.assert_allclose(r_lo.value["authorities"].numpy(),
                               r_di.value["authorities"].numpy(), atol=1e-5)
    # the doubled-graph shards are derived state, partitioned once
    assert "hits/sharded" in di.cache
    shards = di.cache["hits/sharded"]
    di.hits()
    assert di.cache["hits/sharded"] is shards


def test_hits_through_platform_with_cache():
    g, _, _ = _graph()
    plat = GraphPlatform(g, n_data=4, device=CPU)
    q = GraphQuery.of("hits", max_iters=30)
    r = plat.query(q)
    assert r.engine in ("local", "distributed")
    assert set(r.value) == {"hubs", "authorities"}
    assert "plan" in r.meta
    r2 = plat.query(GraphQuery.of("hits", max_iters=30))
    assert r2.meta.get("cache") == "hit"
    assert plat.query(GraphQuery.of("hits", max_iters=31)).meta.get(
        "cache") is None


def test_hits_planner_spec():
    stats = P.GraphStats(1_000_000, 5_000_000, 5_000_000 * 12)
    spec = P.spec_for("hits", stats)
    assert spec.output_rows == 2 * stats.n_vertices
    assert spec.iterations == 30
    assert P.spec_for("hits", stats, max_iters=5).iterations == 5
    plan = P.choose_engine(stats, spec, 256)
    assert plan.engine in ("local", "distributed")


# ----------------------------------------------- parity with the reference

@pytest.mark.parametrize("n,seed,max_iters,tol", [(250, 3, 50, 1e-6),
                                                  (400, 5, 8, 1e-6),
                                                  (120, 9, 200, 1e-10)])
def test_hits_matches_reference(n, seed, max_iters, tol):
    src, dst = S.user_follow_graph(n, 4.0, seed=seed)
    g, jg = G.build_coo(src, dst, n, device=CPU), JG.build_coo(src, dst, n)
    got, gi = th.hits(g, max_iters=max_iters, tol=tol)
    want, wi = jh.hits(jg, max_iters=max_iters, tol=tol)
    for k in ("hubs", "authorities"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5)
    assert abs(gi - wi) <= 1
    rg, jrg = th.role_graph(g), jh.role_graph(jg)
    for a, b in ((rg.src, jrg.src), (rg.dst, jrg.dst), (rg.w, jrg.w)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


def test_hits_oracle_matches_the_dense_reference_oracle():
    """The port's sparse float64 oracle is the reference's dense one,
    duplicate edges included (both count an edge once)."""
    src, dst = S.user_follow_graph(150, 4.0, seed=2)
    src = np.concatenate([src, src[:20]])
    dst = np.concatenate([dst, dst[:20]])
    got, gi = th.hits_reference(src, dst, 150)
    want, wi = jh.hits_reference(src, dst, 150)
    assert gi == wi
    for k in ("hubs", "authorities"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-7)


def test_hits_warm_start_through_the_catalog():
    """A delta snapshot warm-starts from its parent's scores: within tol
    of the cold run on the child, in no more iterations."""
    from repro_torch.core.service import GraphAnalyticsService
    g, src, dst = _graph()
    svc = GraphAnalyticsService()
    svc.add_snapshot("g", g, as_of=1, device=CPU)
    q = GraphQuery.of("hits", max_iters=100, tol=1e-7)
    svc.call("g", q)
    svc.add_snapshot("g", as_of=2, added=np.array([[1, 2], [3, 4]]),
                     device=CPU)
    warm = svc.call("g", q)
    child = svc.context("g", as_of=2).coo
    cold = LocalEngine(child, device=CPU).run("hits", q.params)
    assert warm.meta.get("mode") == "warm"
    assert warm.iterations <= cold.iterations
    for k in ("hubs", "authorities"):
        np.testing.assert_allclose(warm.value[k].numpy(),
                                   cold.value[k].numpy(), atol=1e-5)


def test_dense_float32_sums_accumulate_in_float64():
    """A vertex of in-degree 3e5 (power-law graphs have them): the dense
    combine's float32 sum is the float64 sum rounded once, not a float32
    running sum (which drifts by many ulps and moved HITS at 2^22 by
    1.7e-4)."""
    from repro_torch.core import pregel
    m = np.random.default_rng(0).random(300_000).astype(np.float32)
    got = pregel._local_combine(torch.from_numpy(m),
                                torch.zeros(m.size, dtype=torch.long), 1,
                                "sum", 0.0)
    assert got.dtype == torch.float32
    assert got[0].item() == np.float32(m.astype(np.float64).sum())


@pytest.mark.parametrize("chunk", [1, 7, 1 << 10])
def test_float64_sums_cast_a_slice_of_rows_at_a_time(monkeypatch, chunk):
    """The float64 copy of float32 messages is made a slice of rows at a
    time (LPA's [E, 2C] messages would otherwise gain a whole float64
    copy); the sums are those of one whole copy, over 1-D and over
    grouped [E, M] messages."""
    from repro_torch.core import pregel
    rng = np.random.default_rng(1)
    m = torch.from_numpy(rng.random((3000, 6)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 41, 3000))
    want = torch.zeros((41, 6), dtype=torch.float64).index_add_(
        0, idx, m.double())[:40].float()
    want1 = torch.zeros(41, dtype=torch.float64).index_add_(
        0, idx, m[:, 0].double())[:40].float()
    grouped = (("sum", 3), ("min", 3))
    monkeypatch.setattr(pregel, "_SUM_CHUNK", chunk)
    got = pregel._local_combine(m, idx, 40, grouped, (0.0, float("inf")))
    assert got[:, :3].numpy().tobytes() == want[:, :3].numpy().tobytes()
    got1 = pregel._local_combine(m[:, 0].contiguous(), idx, 40, "sum", 0.0)
    assert got1.numpy().tobytes() == want1.numpy().tobytes()
