"""Triangle counting, k-core and degree statistics in the port against
the JAX reference (``repro.core.algorithms.triangles`` / ``degrees``).

Same graph bytes in both packages, same queries.  Everything compared
here is integer-valued or boolean, so every comparison is exact: the
bitset words (int64 in the port, uint32 in the reference), per-vertex
and per-edge triangle terms, counts, k-core membership and iteration
counts, the degree summary, the planner's (engine, variant) choices, and
the removal-only incremental k-core repair against a cold peel.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import graph as JG  # noqa: E402
from repro.core import planner as JP  # noqa: E402
from repro.core import pregel as JPregel  # noqa: E402
from repro.core.algorithms import degrees as JD  # noqa: E402
from repro.core.engines import DistributedEngine as JDist  # noqa: E402
from repro.core.engines import LocalEngine as JLocal  # noqa: E402
from repro.core.partition import partition as j_partition  # noqa: E402
from repro.core.query import GraphPlatform as JPlatform  # noqa: E402
from repro.core.query import GraphQuery as JQuery  # noqa: E402
from repro.core.service import GraphAnalyticsService as JService  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import planner as TP  # noqa: E402
from repro_torch.core import pregel as TPregel  # noqa: E402
from repro_torch.core import registry as R  # noqa: E402
from repro_torch.core.algorithms import degrees as TD  # noqa: E402
from repro_torch.core.engines import DistributedEngine, LocalEngine  # noqa: E402
from repro_torch.core.partition import partition  # noqa: E402
from repro_torch.core.query import GraphPlatform, GraphQuery  # noqa: E402
from repro_torch.core.service import GraphAnalyticsService  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

JT = importlib.import_module("repro.core.algorithms.triangles")
TT = importlib.import_module("repro_torch.core.algorithms.triangles")
CPU = "cpu"


@pytest.fixture(autouse=True)
def _analytic_calibration():
    """Pin both packages' planners to their analytic constants."""
    JP.set_calibration(None)
    TP.set_calibration(None)
    yield
    JP.set_calibration(None)
    TP.set_calibration(None)


def _random_edges(n=250, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, 6 * n), rng.integers(0, n, 6 * n), n


def _star_edges(n=64):
    return np.zeros(n - 1, np.int64), np.arange(1, n), n


def _self_loop_edges():
    # K3 + self-loops + pendant
    return np.array([0, 1, 2, 0, 3, 3]), np.array([1, 2, 0, 0, 3, 1]), 4


def _empty_edges(n=5):
    e = np.array([], dtype=np.int64)
    return e, e, n


def _identifier_edges(n=600, seed=11):
    sets = synthetic.identifier_edge_sets(n, n_sets=4, mean_degree=1.5,
                                          seed=seed)
    return (np.concatenate([s for s, _ in sets]),
            np.concatenate([d for _, d in sets]), n)


GRAPHS = {
    "random": _random_edges,
    "star": _star_edges,
    "self_loop": _self_loop_edges,
    "empty": _empty_edges,
    "identifier": _identifier_edges,
}


def _pair(kind):
    src, dst, n = GRAPHS[kind]()
    return (JG.build_coo(src, dst, n, symmetrize=True),
            TG.build_coo(src, dst, n, symmetrize=True, device=CPU),
            src, dst)


def _bits(v):
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return np.ascontiguousarray(np.asarray(v)).tobytes()


# ------------------------------------------------------------ triangles

@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_bitset_matches_reference(kind):
    """Adjacency bitsets word for word, per-vertex pair counts and the
    count equal JAX's and the trace(A^3)/6 oracle."""
    jg, tg, src, dst = _pair(kind)
    n = tg.n_vertices
    jsg, tsg = j_partition(jg, 1, 1), partition(tg, 1, 1)
    W = TT._n_words(n)
    jinit = np.zeros((jsg.n_pad, W + 1), dtype=np.uint32)
    ids = np.arange(n)
    jinit[ids, ids // 32] = np.uint32(1) << (ids % 32).astype(np.uint32)
    jbits, _ = JPregel.run_pregel(JT._ADJACENCY_SPEC, jsg,
                                  jnp.asarray(jinit), max_iters=1)
    tbits, _ = TPregel.run_pregel(
        TT._ADJACENCY_SPEC, tsg,
        torch.from_numpy(jinit.astype(np.int64)), max_iters=1)
    np.testing.assert_array_equal(tbits.numpy().astype(np.uint32),
                                  np.asarray(jbits))

    want, want_pv = JT.triangle_count(jg)
    got, got_pv = TT.triangle_count(tg)
    assert got == want == TT.triangle_count_reference(src, dst, n)
    assert got_pv.dtype == torch.int64
    np.testing.assert_array_equal(got_pv.numpy(), want_pv)


@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_intersect_matches_reference(kind):
    jg, tg, src, dst = _pair(kind)
    want, want_pe = JT.triangle_count_intersect(jg)
    for use_kernels in (True, False):
        got, got_pe = TT.triangle_count_intersect(tg,
                                                  use_kernels=use_kernels)
        assert got == want == TT.triangle_count_reference(src, dst,
                                                          tg.n_vertices)
        assert got_pe.dtype == torch.int32
        np.testing.assert_array_equal(got_pe.numpy().astype(np.int64),
                                      want_pe)


@pytest.mark.parametrize("kind", sorted(GRAPHS))
@pytest.mark.parametrize("engine", ["local", "distributed"])
def test_variant_parity_on_both_engines(kind, engine):
    jg, tg, src, dst = _pair(kind)
    if engine == "local":
        jeng, teng = JLocal(jg), LocalEngine(tg, device=CPU)
    else:
        jeng = JDist(jg, n_data=4)
        teng = DistributedEngine(tg, n_data=4, device=CPU)
    want = TT.triangle_count_reference(src, dst, tg.n_vertices)
    for variant in ("bitset", "intersect"):
        j, t = (e.run("triangle_count", variant=variant)
                for e in (jeng, teng))
        assert t.value == j.value == want, variant
        assert t.iterations == j.iterations
        assert t.meta["variant"] == j.meta["variant"] == variant
    # the measured orientation width flows back as the reference's does
    assert teng.measurements() == jeng.measurements()


def test_unknown_variant_rejected():
    _, tg, _, _ = _pair("self_loop")
    with pytest.raises(ValueError, match="unknown variant"):
        LocalEngine(tg, device=CPU).run("triangle_count", variant="quantum")


def test_directed_graph_rejected():
    g = TG.build_coo(np.array([0, 1]), np.array([1, 2]), 3, device=CPU)
    with pytest.raises(ValueError, match="symmetrized"):
        TT.triangle_count(g)
    with pytest.raises(ValueError, match="symmetrized"):
        TT.k_core(g, 2)


def test_popcount_matches_numpy():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    words[:3] = [0, 2 ** 32 - 1, 2 ** 31]
    want = np.array([bin(int(w)).count("1") for w in words])
    got = TT._popcount32(torch.from_numpy(words.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------- k-core

@pytest.mark.parametrize("kind", ["random", "identifier", "self_loop",
                                  "star"])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_kcore_matches_reference_on_every_variant(kind, k):
    jg, tg, _, _ = _pair(kind)
    src = tg.src[: tg.n_edges].numpy()
    dst = tg.dst[: tg.n_edges].numpy()
    oracle = TT.k_core_reference(src, dst, tg.n_vertices, k)
    j_in, j_iters = JT.k_core(jg, k)
    t_in, t_iters = TT.k_core(tg, k)
    assert t_in.dtype == torch.bool
    np.testing.assert_array_equal(t_in.numpy(), np.asarray(j_in))
    np.testing.assert_array_equal(t_in.numpy(), oracle)
    assert t_iters == int(j_iters)
    eng, jeng = LocalEngine(tg, device=CPU), JLocal(jg)
    for variant in ("dense", "fused", "frontier"):
        r = eng.run("k_core", {"k": k}, variant=variant)
        jr = jeng.run("k_core", {"k": k}, variant=variant)
        assert r.meta["realized_variant"] == variant
        assert _bits(r.value) == _bits(t_in), variant
        assert r.iterations == jr.iterations == t_iters, variant
    assert TT.core_size(t_in) == int(oracle.sum())


def test_kcore_spec_uses_the_compiled_program():
    """The fused variant on the card needs one of the superstep kernel's
    compiled edge programs as the message."""
    from repro_torch.kernels.pregel_superstep import ops
    spec = TT._kcore_spec(3)
    assert ops.compiled(spec.message)
    assert spec.elementwise_message and spec.frontier_mode == "delta"
    assert TT._kcore_spec(3) is spec


def test_kcore_refuses_an_inexact_channel():
    with pytest.raises(ValueError, match="allow_inexact_sum"):
        TPregel.reduced_precision(TT._kcore_spec(2), torch.bfloat16)
    opted = TPregel.reduced_precision(TT._kcore_spec(2), torch.bfloat16,
                                      allow_inexact_sum=True)
    assert opted.message_dtype == "bfloat16"
    bad = dataclasses.replace(TT._kcore_spec(2), message_dtype="bfloat16")
    _, tg, _, _ = _pair("self_loop")
    with pytest.raises(ValueError, match="allow_inexact_sum"):
        TPregel.run_pregel(bad, partition(tg, 1, 1),
                           torch.ones(tg.n_vertices), 2)


def test_kcore_incremental_removal_matches_cold_and_reference():
    """A removal-only delta repairs the parent's k-core from its
    membership, byte-equal to a cold peel, in both packages."""
    jg, tg, _, _ = _pair("identifier")
    src = tg.src[: tg.n_edges].numpy()
    dst = tg.dst[: tg.n_edges].numpy()
    sel = (src < dst) & (src < 10)           # every edge of vertices 0-9
    removed = np.stack([src[sel], dst[sel]], axis=1)
    jsvc, tsvc = JService(), GraphAnalyticsService()
    jsvc.add_snapshot("g", jg, as_of=0)
    tsvc.add_snapshot("g", tg, as_of=0, device=CPU)
    jq, tq = JQuery.of("k_core", k=3), GraphQuery.of("k_core", k=3)
    jsvc.call("g", jq)
    tsvc.call("g", tq)
    jsvc.add_snapshot("g", as_of=1, removed=removed)
    tsvc.add_snapshot("g", as_of=1, removed=removed, device=CPU)
    want, got = jsvc.call("g", jq), tsvc.call("g", tq)
    assert got.meta.get("mode") == want.meta.get("mode") == "incremental"
    assert _bits(got.value) == _bits(want.value)
    ctx = tsvc.context("g")
    cold = ctx.engine(got.meta["plan"].engine).run(
        "k_core", tq.params, variant="dense")
    assert _bits(got.value) == _bits(cold.value)
    assert int(np.asarray(want.value).sum()) < \
        int(np.asarray(jsvc.call("g", jq, as_of=0).value).sum())


def test_kcore_incremental_declines_added_edges():
    _, tg, _, _ = _pair("random")
    eng = LocalEngine(tg, device=CPU)
    seed = eng.run("k_core", {"k": 2})
    delta = TG.GraphDelta(added=np.array([[0, 1]]),
                          removed=np.zeros((0, 2), np.int64),
                          touched=np.array([0, 1]))
    params = R.get("k_core").validate({"k": 2})
    assert TT._kcore_incremental(eng, params, seed, delta) is None


# --------------------------------------------------------------- degrees

@pytest.mark.parametrize("kind", ["random", "identifier", "star"])
def test_degree_stats_and_histogram_match_reference(kind):
    jg, tg, _, _ = _pair(kind)
    assert TD.degree_stats(tg) == JD.degree_stats(jg)
    got = TD.degree_histogram(tg, n_bins=16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JD.degree_histogram(jg, 16)))


# -------------------------------------------------------------- platform

QUERIES = {
    "triangles": (lambda Q: Q.triangle_count()),
    "kcore": (lambda Q: Q.k_core(3)),
    "kcore_count": (lambda Q: Q.k_core(4, count_only=True)),
    "degrees": (lambda Q: Q.degree_stats()),
}


@pytest.mark.parametrize("name", sorted(QUERIES))
@pytest.mark.parametrize("force_engine", [None, "distributed"])
def test_platform_matches_reference(name, force_engine):
    jg, tg, _, _ = _pair("identifier")
    jp = JPlatform(jg, force_engine=force_engine)
    tp = GraphPlatform(tg, force_engine=force_engine, device=CPU)
    jq, tq = QUERIES[name](JQuery), QUERIES[name](GraphQuery)
    assert tq.key() == jq.key()
    jplan, tplan = jp.plan(jq), tp.plan(tq)
    assert (tplan.engine, tplan.variant, tplan.mode, tplan.reason) == \
        (jplan.engine, jplan.variant, jplan.mode, jplan.reason)
    want, got = jp.query(jq), tp.query(tq)
    assert got.engine == want.engine
    assert got.meta.get("variant") == want.meta.get("variant")
    assert got.iterations == want.iterations
    if isinstance(want.value, (int, dict)):
        assert got.value == want.value
    else:
        assert _bits(got.value) == _bits(want.value)


@pytest.mark.parametrize("algo", ["triangle_count", "k_core",
                                  "degree_stats"])
@pytest.mark.parametrize("n_vertices,n_edges", [(300, 1500), (10**3, 10**4),
                                                (10**5, 5 * 10**5),
                                                (2 * 10**6, 10**7),
                                                (2**24, 13 * 10**7)])
@pytest.mark.parametrize("oriented_width", [None, 9])
def test_planner_choices_match_reference(algo, n_vertices, n_edges,
                                         oriented_width):
    """Bitset at small V, intersect (kept local) at large V, in both
    packages, with and without a measured orientation width."""
    js = JP.GraphStats(n_vertices, n_edges, 12 * n_edges,
                       oriented_width=oriented_width)
    ts = TP.GraphStats(n_vertices, n_edges, 12 * n_edges,
                       oriented_width=oriented_width)
    params = {"k": 4} if algo == "k_core" else {}
    for count_only in (False, True):
        jspecs = JP.specs_for(algo, js, count_only=count_only, **params)
        tspecs = TP.specs_for(algo, ts, count_only=count_only, **params)
        assert [dataclasses.astuple(s) for s in tspecs] == \
            [dataclasses.astuple(s) for s in jspecs]
        for chips in (4, 1):
            jplan = JP.choose_plan(js, jspecs, chips)
            tplan = TP.choose_plan(ts, tspecs, chips)
            assert (tplan.engine, tplan.variant, tplan.reason) == \
                (jplan.engine, jplan.variant, jplan.reason)
    # one card: intersect, kept local, from 10^5 vertices on (and at
    # every size once the orientation's width is measured); bitset below
    if algo == "triangle_count":
        small = n_vertices <= 10**3 and oriented_width is None
        assert (tplan.engine, tplan.variant) == \
            ("local", "bitset" if small else "intersect")
