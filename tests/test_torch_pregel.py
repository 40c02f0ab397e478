"""The port's Pregel loops and engines against the JAX reference.

The same graphs (numpy, fixed seeds) go through both packages:

* ``run_pregel`` / ``run_pregel_fused`` / ``run_pregel_frontier`` for
  CC, BFS and SSSP — exact final states and exact iteration counts
  (min monoids are order-independent, and the port reads the halt on
  the host where the reference decides it on the device);
* the dense == fused == frontier matrix of
  ``tests/test_pregel_superstep.py`` on the port's engines;
* PageRank within the algorithm's ``tol``: the L1 distance to the
  reference is at most ``tol * V`` and the iteration counts are equal or
  one apart, because float32 sums are taken in another order
  (``index_add_`` vs ``segment_sum``) and the halt compares an L1 norm
  against ``tol * V`` that can land on either side of the threshold.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import graph as JG  # noqa: E402
from repro.core import planner as JP  # noqa: E402
from repro.core import pregel as jpregel  # noqa: E402
from repro.core.engines import LocalEngine as JLocal  # noqa: E402
from repro.core.partition import partition_1d as j_partition_1d  # noqa: E402
from repro_torch.core import engines as E  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import planner as TP  # noqa: E402
from repro_torch.core import pregel  # noqa: E402
from repro_torch.core import registry as R  # noqa: E402
from repro_torch.core.engines import DistributedEngine, LocalEngine  # noqa: E402
from repro_torch.core.partition import partition, partition_1d  # noqa: E402

# the algorithms packages re-export functions under their modules' names,
# so the modules are looked up by their full names
jcc = importlib.import_module("repro.core.algorithms.connected_components")
jpr = importlib.import_module("repro.core.algorithms.pagerank")
jtr = importlib.import_module("repro.core.algorithms.traversal")
tcc = importlib.import_module(
    "repro_torch.core.algorithms.connected_components")
tpr = importlib.import_module("repro_torch.core.algorithms.pagerank")
ttr = importlib.import_module("repro_torch.core.algorithms.traversal")

N = 250
CPU = "cpu"


@pytest.fixture(autouse=True)
def _analytic_calibration():
    """Pin both packages' planners to their analytic constants."""
    JP.set_calibration(None)
    TP.set_calibration(None)
    yield
    JP.set_calibration(None)
    TP.set_calibration(None)


def _bits(v):
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return np.ascontiguousarray(np.asarray(v)).tobytes()


def _edges(kind):
    if kind == "random":
        rng = np.random.default_rng(3)
        s, d = rng.integers(0, N, 6 * N), rng.integers(0, N, 6 * N)
        return s, d, rng.uniform(0.1, 2.0, 6 * N).astype(np.float32), N
    if kind == "star":
        return (np.zeros(63, np.int64), np.arange(1, 64), None, 64)
    if kind == "self_loop":
        return (np.array([0, 1, 2, 0, 3, 3]), np.array([1, 2, 0, 0, 3, 1]),
                None, 4)
    e = np.array([], dtype=np.int64)
    return e, e, None, 5


GRAPHS = ["random", "star", "self_loop", "empty"]


def _pair(kind, weighted=True):
    s, d, w, n = _edges(kind)
    w = w if weighted else None
    return (JG.build_coo(s, d, n, w=w, symmetrize=True),
            TG.build_coo(s, d, n, w=w, symmetrize=True, device=CPU))


def _ells(jg, direction):
    src = np.asarray(jg.src)[: jg.n_edges]
    dst = np.asarray(jg.dst)[: jg.n_edges]
    w = np.asarray(jg.w)[: jg.n_edges]
    col = dst if direction == "in" else src
    k = max(int(np.bincount(col, minlength=jg.n_vertices).max())
            if col.size else 0, 1)
    return (JG.build_ell(src, dst, jg.n_vertices, k, w=w,
                         direction=direction),
            TG.build_ell(src, dst, jg.n_vertices, k, w=w,
                         direction=direction, device=CPU))


# (port spec, reference spec, initial state as numpy)
def _cases(n):
    dist = np.full(n, np.inf, np.float32)
    dist[0] = 0.0
    return {
        "cc": (tcc._CC_SPEC_JUMP, jcc._CC_SPEC_JUMP,
               np.arange(n, dtype=np.int32)),
        "cc_plain": (tcc._CC_SPEC, jcc._CC_SPEC,
                     np.arange(n, dtype=np.int32)),
        "bfs": (ttr._BFS_SPEC, jtr._BFS_SPEC, dist),
        "sssp": (ttr._SSSP_SPEC, jtr._SSSP_SPEC, dist),
    }


# ------------------------------------------------------- loops vs reference

@pytest.mark.parametrize("gname", GRAPHS)
@pytest.mark.parametrize("case", ["cc", "cc_plain", "bfs", "sssp"])
def test_run_pregel_matches_reference(gname, case):
    jg, tg = _pair(gname)
    tspec, jspec, init = _cases(jg.n_vertices)[case]
    want, wit = jpregel.run_pregel(jspec, j_partition_1d(jg, 1),
                                   jnp.asarray(init), jg.n_vertices + 2)
    got, git = pregel.run_pregel(tspec, partition_1d(tg, 1),
                                 torch.from_numpy(init), jg.n_vertices + 2)
    assert _bits(got) == _bits(want)
    assert git == int(wit)


@pytest.mark.parametrize("gname", GRAPHS)
@pytest.mark.parametrize("case", ["cc", "bfs", "sssp"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_run_pregel_fused_matches_reference(gname, case, use_kernels):
    jg, _ = _pair(gname)
    jell, tell = _ells(jg, "in")
    tspec, jspec, init = _cases(jg.n_vertices)[case]
    want, wit = jpregel.run_pregel_fused(jspec, jell, jnp.asarray(init),
                                         jg.n_vertices + 2)
    got, git = pregel.run_pregel_fused(tspec, tell, torch.from_numpy(init),
                                       jg.n_vertices + 2,
                                       use_kernels=use_kernels)
    assert _bits(got) == _bits(want)
    assert git == int(wit)


@pytest.mark.parametrize("gname", GRAPHS)
@pytest.mark.parametrize("case", ["cc", "bfs", "sssp"])
def test_run_pregel_frontier_matches_reference(gname, case):
    jg, _ = _pair(gname)
    jell, tell = _ells(jg, "out")
    tspec, jspec, init = _cases(jg.n_vertices)[case]
    want, wit, wocc = jpregel.run_pregel_frontier(
        jspec, jell, jnp.asarray(init), jg.n_vertices + 2, profile=True)
    got, git, gocc = pregel.run_pregel_frontier(
        tspec, tell, torch.from_numpy(init), jg.n_vertices + 2,
        profile=True)
    assert _bits(got) == _bits(want)
    assert git == int(wit)
    assert gocc.tolist() == np.asarray(wocc).tolist()


def test_frontier_init_active_seam_matches_reference():
    jg, _ = _pair("random")
    jell, tell = _ells(jg, "out")
    V = jg.n_vertices
    dist = np.full(V, np.inf, np.float32)
    dist[[0, 7]] = 0.0
    act = np.zeros(V, bool)
    act[[0, 7, 11]] = True
    want, wit = jpregel.run_pregel_frontier(
        jtr._SSSP_SPEC, jell, jnp.asarray(dist), V,
        init_active=jnp.asarray(act))
    got, git = pregel.run_pregel_frontier(
        ttr._SSSP_SPEC, tell, torch.from_numpy(dist), V,
        init_active=torch.from_numpy(act))
    assert _bits(got) == _bits(want) and git == int(wit)


def test_halt_none_runs_exactly_max_iters():
    _, tg = _pair("random")
    spec = dataclasses.replace(ttr._BFS_SPEC, halt=None)
    init = torch.full((tg.n_vertices,), float("inf"))
    init[0] = 0.0
    _, it = pregel.run_pregel(spec, partition_1d(tg, 1), init, 7)
    assert it == 7


class _StubMesh:
    """The attributes of a DeviceMesh the engine reads at construction."""

    mesh_dim_names = ("data", "model")
    device_type = "cpu"

    def __init__(self, shape):
        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)


def test_mesh_path_is_not_ported_yet():
    """The mesh path is ported (it runs in tests/test_torch_mesh.py on a
    gloo world): a DistributedEngine takes its shard counts from the
    mesh's axes, the 2-D layout only when asked for ``n_model > 1``, and
    a meshless run of a vertex-sharded layout is refused."""
    _, tg = _pair("random")
    eng = DistributedEngine(tg, mesh=_StubMesh((4, 2)), n_model=2)
    assert (eng.n_data, eng.n_model, eng.device.type) == (4, 2, "cpu")
    eng = DistributedEngine(tg, mesh=_StubMesh((4, 2)), n_data=7)
    assert (eng.n_data, eng.n_model) == (4, 1)
    assert not eng.superstep_supported(ttr._BFS_SPEC, "fused")
    with pytest.raises(ValueError, match="needs a mesh"):
        pregel.run_pregel(ttr._BFS_SPEC, partition(tg, 2, 2),
                          torch.zeros(2 * (-(-tg.n_vertices // 2))), 2)


# -------------------------------------------------- engine variant matrix

ALGOS = [
    ("bfs", {"sources": (0, 3)}),
    ("sssp", {"source": 0}),
    ("connected_components", {}),
]


def _engine(kind, g, **kw):
    if kind == "local":
        return LocalEngine(g, device=CPU, **kw)
    return DistributedEngine(g, n_data=2, device=CPU, **kw)


@pytest.mark.parametrize("gname", GRAPHS)
@pytest.mark.parametrize("kind", ["local", "distributed"])
@pytest.mark.parametrize("algo,params", ALGOS)
def test_variant_parity_every_algorithm(gname, kind, algo, params):
    """Each registered strategy returns a bit-identical value and the
    same iteration count as the dense oracle — and as the reference
    package's dense run."""
    jg, tg = _pair(gname)
    eng = _engine(kind, tg)
    defn = R.get(algo)
    assert set(defn.variants) == {"dense", "fused", "frontier"}
    ref = JLocal(jg).run(algo, params, variant="dense")
    for v in sorted(defn.variants):
        r = eng.run(algo, params, variant=v)
        assert _bits(r.value) == _bits(ref.value), (algo, v)
        assert r.iterations == ref.iterations, (algo, v)


def test_fused_plain_and_kernel_paths_agree():
    """use_kernels=False forces the plain version; on the CPU the
    wrapper's path is the plain version too — same bits."""
    _, tg = _pair("random")
    a = LocalEngine(tg, device=CPU).run("bfs", {"sources": (0,)},
                                        variant="fused")
    b = LocalEngine(tg, device=CPU, use_kernels=False).run(
        "bfs", {"sources": (0,)}, variant="fused")
    assert _bits(a.value) == _bits(b.value)
    assert a.iterations == b.iterations


@pytest.mark.parametrize("gname", GRAPHS)
@pytest.mark.parametrize("direction", ["in", "out"])
def test_measured_degree_matches_reference(gname, direction):
    """The uncapped max degree that gates the variants and sizes their
    layouts, counted where the port's COO lives, is the reference's
    host count, on directed graphs (in and out differ)."""
    s, d, _, n = _edges(gname)
    jg = JG.build_coo(s, d, n)
    tg = TG.build_coo(s, d, n, device=CPU)
    got = LocalEngine(tg, device=CPU)._measured_degree(direction)
    assert got == JLocal(jg)._measured_degree(direction)
    col = np.asarray(jg.dst if direction == "in" else jg.src)[: jg.n_edges]
    assert got == (int(np.bincount(col, minlength=n).max()) if col.size
                   else 0)


def test_budget_fallback_is_exact(monkeypatch):
    """Past the uncapped-ELL byte budget the variants take the dense path
    — forced variants still return the oracle's bits."""
    s, d = np.zeros(127, np.int64), np.arange(1, 128)
    tg = TG.build_coo(s, d, 128, symmetrize=True, device=CPU)
    eng = LocalEngine(tg, device=CPU)
    base = eng.run("connected_components", {}, variant="dense")
    monkeypatch.setattr(E, "SUPERSTEP_ELL_BUDGET", 16)
    assert not eng.superstep_supported(tcc._CC_SPEC, "fused")
    assert not eng.superstep_supported(tcc._CC_SPEC, "frontier")
    for v in ("fused", "frontier"):
        r = eng.run("connected_components", {}, variant=v)
        assert _bits(r.value) == _bits(base.value)
        assert r.meta["realized_variant"] == "dense"


@pytest.mark.parametrize("algo,params", ALGOS)
@pytest.mark.parametrize("variant", ["dense", "fused", "frontier"])
def test_realized_variant_in_meta(algo, params, variant):
    """Within the preconditions the forced variant is the one that ran,
    and the result says so (the profile counters agree)."""
    _, tg = _pair("random")
    r = LocalEngine(tg, device=CPU).run(algo, params, variant=variant,
                                        profile=True)
    assert r.meta["realized_variant"] == variant
    assert r.meta["superstep"]["variant"] == variant


def test_unsupported_specs_fall_back_dense():
    _, tg = _pair("random")
    eng = LocalEngine(tg, device=CPU)
    grouped = dataclasses.replace(tcc._CC_SPEC, combine=(("min", 1),),
                                  identity=(0,))
    assert not eng.superstep_supported(grouped, "fused")
    dense_only = dataclasses.replace(ttr._BFS_SPEC,
                                     elementwise_message=False)
    assert not eng.superstep_supported(dense_only, "fused")
    with pytest.raises(ValueError):
        pregel.run_pregel_fused(dense_only, None, torch.zeros(4), 1)
    no_frontier = dataclasses.replace(ttr._BFS_SPEC, frontier_mode=None)
    assert not eng.superstep_supported(no_frontier, "frontier")
    with pytest.raises(ValueError):
        pregel.run_pregel_frontier(no_frontier, None, torch.zeros(4), 1)
    # an uncompiled message meets the fused preconditions: the plain
    # version on the CPU runs any elementwise callable, and on the card
    # the kernel's wrapper raises rather than the engine turning away
    adhoc = dataclasses.replace(ttr._BFS_SPEC, message=lambda d, w: d + 1.0)
    assert eng.superstep_supported(adhoc, "fused")


def test_reduced_precision_parity_across_variants_and_packages():
    """bf16 message channel: all three strategies agree bit-for-bit, and
    with the reference's dense run."""
    jg, tg = _pair("random")
    V = tg.n_vertices
    init = np.full(V, np.inf, np.float32)
    init[0] = 0.0
    trp = pregel.reduced_precision(ttr._SSSP_SPEC, torch.bfloat16)
    assert trp.message_dtype == "bfloat16"
    eng = LocalEngine(tg, device=CPU)
    outs = {v: eng.run_superstep(trp, torch.from_numpy(init), V,
                                 variant=v)
            for v in ("dense", "fused", "frontier")}
    jrp = jpregel.reduced_precision(jtr._SSSP_SPEC, jnp.bfloat16)
    want, wit = JLocal(jg).run_superstep(jrp, jnp.asarray(init), V)
    for v, (got, it) in outs.items():
        assert _bits(got.float()) == _bits(np.asarray(want, np.float32)), v
        assert it == int(wit), v


def test_precision_validation_gates():
    pregel.check_precision(
        pregel.reduced_precision(ttr._BFS_SPEC, "float16"))
    ksum = dataclasses.replace(tcc._CC_SPEC, combine="sum")
    with pytest.raises(ValueError, match="allow_inexact_sum"):
        pregel.reduced_precision(ksum, torch.bfloat16)
    opted = pregel.reduced_precision(ksum, torch.bfloat16,
                                     allow_inexact_sum=True)
    assert opted.message_dtype == "bfloat16"
    grouped = dataclasses.replace(tcc._CC_SPEC, combine=(("min", 1),),
                                  identity=(0,))
    with pytest.raises(ValueError, match="structured"):
        pregel.reduced_precision(grouped, torch.bfloat16)
    _, tg = _pair("self_loop")
    bad = dataclasses.replace(ksum, message_dtype="bfloat16")
    with pytest.raises(ValueError, match="allow_inexact_sum"):
        pregel.run_pregel(bad, partition_1d(tg, 1),
                          torch.ones(tg.n_vertices, dtype=torch.int32), 2)


def test_profile_counters_match_reference():
    jg, tg = _pair("random")
    for v in ("dense", "fused", "frontier"):
        want = JLocal(jg).run("bfs", {"sources": (0,)}, variant=v,
                              profile=True).meta["superstep"]
        got = LocalEngine(tg, device=CPU).run(
            "bfs", {"sources": (0,)}, variant=v,
            profile=True).meta["superstep"]
        assert got == want, v


# ------------------------------------------------------------- PageRank

# tol * V must sit above float32's resolution (about V * 2^-24 in L1
# for ranks below 1): below it both packages stop on rounding noise, the
# halt becomes a coin flip and the iteration counts diverge (at V = 4 and
# tol = 1e-8 one package reaches an exact float fixpoint and the other
# never does).
@pytest.mark.parametrize("gname", ["random", "star", "self_loop"])
@pytest.mark.parametrize("tol", [1e-6, 1e-4])
def test_pagerank_within_tol(gname, tol):
    jg, tg = _pair(gname, weighted=False)
    want, wit = jpr.pagerank(jg, tol=tol)
    got, git = tpr.pagerank(tg, tol=tol)
    V = tg.n_vertices
    assert got.dtype == torch.float32
    assert np.abs(got.numpy().astype(np.float64)
                  - np.asarray(want, np.float64)).sum() <= tol * V
    assert abs(git - int(wit)) <= 1
    np.testing.assert_allclose(float(got.sum()), 1.0, rtol=1e-5)


def test_pagerank_engine_and_warm_start():
    jg, tg = _pair("random", weighted=False)
    eng = LocalEngine(tg, device=CPU)
    cold = eng.run("pagerank", {"tol": 1e-6})
    assert "pagerank/normalized" in eng.cache
    ref = jpr.pagerank_reference(np.asarray(jg.src)[: jg.n_edges],
                                 np.asarray(jg.dst)[: jg.n_edges],
                                 jg.n_vertices, tol=1e-6)[0]
    assert np.abs(cold.value.numpy() - ref).sum() <= 1e-6 * N * 10
    warm = eng.run("pagerank", {"tol": 1e-6}, seed=cold)
    assert warm.meta["mode"] == "warm"
    assert warm.iterations < cold.iterations
    assert np.abs(warm.value.numpy() - cold.value.numpy()).sum() \
        <= 1e-6 * N * 10


def test_oracles_agree_with_the_port():
    s, d, w, n = _edges("random")
    tg = TG.build_coo(s, d, n, w=w, symmetrize=True, device=CPU)
    src = tg.src[: tg.n_edges].numpy()
    dst = tg.dst[: tg.n_edges].numpy()
    eng = LocalEngine(tg, device=CPU)
    labels = eng.run("connected_components", {}).value.numpy()
    assert (labels == tcc.connected_components_reference(src, dst, n)).all()
    bfs = eng.run("bfs", {"sources": (0, 9)}).value.numpy()
    assert (bfs == ttr.bfs_reference(src, dst, n, (0, 9))).all()
    sp = eng.run("sssp", {"source": 4}).value.numpy()
    np.testing.assert_allclose(
        sp, ttr.sssp_reference(src, dst, tg.w[: tg.n_edges].numpy(), n, 4),
        rtol=1e-5)
