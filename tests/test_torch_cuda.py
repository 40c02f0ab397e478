"""The port on the card: the CUDA kernels (and ``ell_spmv``, which
launches the superstep kernel) against their plain versions, and the
engines and platform on ``cuda:0`` against the same port on the CPU.

Every test needs a CUDA device and skips without one (the kernels have
no CPU mode).  The file imports neither jax nor the reference package, so
it also runs on a GPU host that has only the port's dependencies; from
the repository root there::

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports the JAX package.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core.engines import LocalEngine  # noqa: E402
from repro_torch.core.query import GraphPlatform, GraphQuery  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels.ell_combine import ops as cops  # noqa: E402
from repro_torch.kernels.ell_combine.ref import ell_combine_plain  # noqa: E402
from repro_torch.kernels.ell_intersect import ops as iops  # noqa: E402
from repro_torch.kernels.ell_intersect.ref import ell_intersect_plain  # noqa: E402
from repro_torch.kernels.pregel_superstep import ops  # noqa: E402
from repro_torch.kernels.pregel_superstep.ref import superstep_plain  # noqa: E402

pytestmark = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device (the kernel has no CPU mode)")

INF = float("inf")
IMAX = int(np.iinfo(np.int32).max)


def _inputs(v, k, vx, seed, x_kind):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, vx + 1, (v, k)).astype(np.int32)   # + sentinel
    mask = rng.random((v, k)) < 0.7
    mask[: v // 10] = False
    w = rng.uniform(0.1, 2.0, (v, k)).astype(np.float32)
    if x_kind == "ids":
        x = rng.permutation(vx).astype(np.int32)
    elif x_kind == "dist":
        x = rng.integers(0, 40, vx).astype(np.float32)
        x[rng.random(vx) < 0.3] = np.inf
    else:
        x = rng.random(vx).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (nbr, mask, w, x)]


@pytest.mark.parametrize("v,k", [(1000, 37), (300, 1), (64, 0), (2000, 200)])
@pytest.mark.parametrize("msg,x_kind,op,md,ident", [
    (ops.msg_src, "ids", "min", None, IMAX),
    (ops.msg_src, "ids", "max", None, -IMAX - 1),
    (ops.msg_src_plus_one, "dist", "min", None, INF),
    (ops.msg_src_plus_w, "dist", "min", None, INF),
    (ops.msg_src_times_w, "unit", "sum", None, 0.0),
    (ops.msg_src, "unit", "min", "bfloat16", INF),
    (ops.msg_src_plus_w, "dist", "max", "float16", -INF),
])
def test_kernel_matches_plain(v, k, msg, x_kind, op, md, ident):
    args = _inputs(v, k, v, v + k, x_kind)
    kw = dict(message=msg, op=op, identity=ident, message_dtype=md)
    before = ops.KERNEL_LAUNCHES
    got = ops.fused_superstep(*args, **kw)
    torch.cuda.synchronize()
    assert ops.KERNEL_LAUNCHES == before + 1
    want = superstep_plain(*args, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    if op == "sum":
        # positive terms: only the summation order differs
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
    else:
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_kernel_rejects_what_it_does_not_compile():
    args = _inputs(10, 3, 10, 1, "unit")
    with pytest.raises(ValueError, match="compiled edge program"):
        ops.fused_superstep(*args, message=lambda s, w: s, op="min",
                            identity=INF)
    with pytest.raises(ValueError, match="1-D"):
        ops.fused_superstep(args[0], args[1], args[2],
                            args[3][:, None].repeat(1, 2),
                            message=ops.msg_src, op="min", identity=INF)
    with pytest.raises(ValueError, match="bool"):
        ops.fused_superstep(args[0], args[1].to(torch.uint8), args[2],
                            args[3], message=ops.msg_src, op="min",
                            identity=INF)


def _graph(device, weighted=True):
    sets = synthetic.identifier_edge_sets(3000, n_sets=4, mean_degree=1.5,
                                          seed=7)
    src = np.concatenate([s for s, _ in sets])
    dst = np.concatenate([d for _, d in sets])
    w = np.random.default_rng(2).uniform(0.5, 2.0, src.size) \
        if weighted else None
    return G.build_coo(src, dst, 3000, w=w, symmetrize=True, device=device)


def test_default_device_is_the_card():
    g = _graph(None)
    assert g.src.device.type == "cuda"
    assert GraphPlatform(g).local.device.type == "cuda"


@pytest.mark.parametrize("algo,params", [
    ("connected_components", {}),
    ("bfs", {"sources": (0, 1500)}),
    ("sssp", {"source": 11}),
])
def test_engine_variants_on_the_card_match_the_cpu(algo, params):
    """Every variant on cuda:0 (fused = the CUDA kernel, once per
    superstep) returns the CPU run's bytes and iteration count."""
    want = LocalEngine(_graph("cpu"), device="cpu").run(algo, params,
                                                        variant="dense")
    eng = LocalEngine(_graph("cuda"))
    for variant in ("dense", "fused", "frontier"):
        before = ops.KERNEL_LAUNCHES
        got = eng.run(algo, params, variant=variant)
        launched = ops.KERNEL_LAUNCHES - before
        assert (launched >= got.iterations) if variant == "fused" \
            else launched == 0, variant
        assert got.value.device.type == "cuda"
        assert torch.equal(got.value.cpu().view(torch.uint8),
                           want.value.view(torch.uint8)), variant
        assert got.iterations == want.iterations, variant


def test_platform_on_the_card_matches_the_cpu():
    cpu = GraphPlatform(_graph("cpu"), device="cpu")
    gpu = GraphPlatform(_graph("cuda"))
    for q in (GraphQuery.connected_components(),
              GraphQuery.connected_components(count_only=True),
              GraphQuery.bfs([0, 2000]), GraphQuery.sssp(5)):
        a, b = cpu.query(q), gpu.query(q)
        assert gpu.plan(q).variant == cpu.plan(q).variant
        if isinstance(a.value, int):
            assert a.value == b.value
        else:
            assert torch.equal(a.value.view(torch.uint8),
                               b.value.cpu().view(torch.uint8))
    # PageRank on unit weights (a probability iteration), within tol * V:
    # atomics on the card sum in another order than the CPU
    q = GraphQuery.pagerank(tol=1e-6)
    pr_cpu = GraphPlatform(_graph("cpu", False), device="cpu").query(q)
    pr_gpu = GraphPlatform(_graph("cuda", False)).query(q)
    err = (pr_cpu.value - pr_gpu.value.cpu()).abs().sum()
    assert float(err) <= 1e-6 * 3000
    assert abs(pr_cpu.iterations - pr_gpu.iterations) <= 1


def test_fused_with_an_uncompiled_message_raises_on_the_card():
    """The engine does not turn a fused request away for a message the
    kernel does not compile: the wrapper raises, nothing runs dense."""
    import dataclasses

    from repro_torch.core.algorithms import traversal
    eng = LocalEngine(_graph("cuda"))
    adhoc = dataclasses.replace(traversal._BFS_SPEC,
                                message=lambda d, w: d + 1.0)
    assert eng.superstep_supported(adhoc, "fused")
    init = torch.full((3000,), INF, device="cuda")
    init[0] = 0.0
    before = ops.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="compiled edge program"):
        eng.run_superstep(adhoc, init, 3000, variant="fused")
    assert ops.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("algo,params", [
    ("connected_components", {}),
    ("bfs", {"sources": (0, 1500)}),
    ("sssp", {"source": 11}),
])
def test_plain_fused_on_the_card_matches_the_kernel(algo, params):
    """use_kernels=False runs the plain version on the card (no launch)
    and returns the kernel run's bytes and iteration count."""
    g = _graph("cuda")
    before = ops.KERNEL_LAUNCHES
    plain = LocalEngine(g, use_kernels=False).run(algo, params,
                                                  variant="fused")
    assert ops.KERNEL_LAUNCHES == before
    kern = LocalEngine(g).run(algo, params, variant="fused")
    assert ops.KERNEL_LAUNCHES - before >= kern.iterations
    assert plain.meta["realized_variant"] == "fused"
    assert kern.meta["realized_variant"] == "fused"
    assert torch.equal(plain.value.view(torch.uint8),
                       kern.value.view(torch.uint8))
    assert plain.iterations == kern.iterations


# ------------------------------------------------------------ ell_intersect

def _sorted_rows(rng, e, k, vx, fill=0.6):
    rows = np.full((e, k), vx, dtype=np.int32)
    for i in range(e):
        n = rng.integers(0, int(k * fill) + 1)
        vals = rng.choice(vx, size=min(n, vx), replace=False)
        vals.sort()
        rows[i, : len(vals)] = vals
    return rows


@pytest.mark.parametrize("e,k,vx", [(16, 8, 40), (100, 37, 64),
                                    (256, 128, 500), (7, 200, 300),
                                    (64, 1, 10), (1000, 33, 2000),
                                    (20, 3000, 100000)])
def test_intersect_kernel_matches_plain(e, k, vx):
    """K = 1, K not a multiple of 32, and K past the reference's
    2048-slot VMEM bound: exact equality with the plain version."""
    rng = np.random.default_rng(e * k)
    a = torch.from_numpy(_sorted_rows(rng, e, k, vx)).cuda()
    b = torch.from_numpy(_sorted_rows(rng, e, k, vx)).cuda()
    before = iops.KERNEL_LAUNCHES
    got = iops.ell_intersect(a, b, vx)
    torch.cuda.synchronize()
    assert iops.KERNEL_LAUNCHES == before + 1
    assert torch.equal(got, ell_intersect_plain(a, b, vx))


def test_intersect_kernel_sentinel_and_identical_rows():
    vx = 32
    a = torch.full((8, 16), vx, dtype=torch.int32, device="cuda")
    b = a.clone()
    b[0, :3] = torch.tensor([1, 5, 9], dtype=torch.int32)
    assert (iops.ell_intersect(a, b, vx) == 0).all()
    row = torch.tensor([2, 3, 5, 7, 11, 100, 100, 100], dtype=torch.int32,
                       device="cuda").repeat(8, 1)
    assert (iops.ell_intersect(row, row.clone(), 100) == 5).all()


def test_intersect_counts_on_an_orientation_match_plain():
    g = _graph("cuda")
    o = G.build_oriented_ell(g.src[: g.n_edges].cpu().numpy(),
                             g.dst[: g.n_edges].cpu().numpy(), g.n_vertices)
    before = iops.KERNEL_LAUNCHES
    got = iops.ell_intersect_counts(o)
    assert iops.KERNEL_LAUNCHES == before + 1
    want = iops.ell_intersect_counts(o, use_kernels=False)
    assert iops.KERNEL_LAUNCHES == before + 1
    assert got.device.type == "cuda" and torch.equal(got, want)
    assert int(got.sum()) > 0


def test_intersect_wrapper_raises_on_what_it_does_not_take():
    a = torch.zeros((4, 3), dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError, match="int32"):
        iops.ell_intersect(a, a, 9)
    b = torch.zeros((3, 4), dtype=torch.int32, device="cuda").t()
    with pytest.raises(ValueError, match="contiguous"):
        iops.ell_intersect(b, b, 9)
    nbr = torch.zeros((5, 3), dtype=torch.int32, device="cuda")
    eu = torch.zeros(8, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        iops._launch(nbr, eu[::2], eu[:4], 4)
    with pytest.raises(ValueError, match="int32"):
        iops._launch(nbr, eu.long(), eu, 4)


# -------------------------------------------------------------- ell_combine

@pytest.mark.parametrize("v,k", [(1000, 37), (300, 1), (64, 0), (2000, 200)])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_ell_spmv_kernel_matches_plain(v, k, op):
    nbr, mask, w, x = _inputs(v, k, v, v + k, "unit")
    before = (cops.KERNEL_LAUNCHES, ops.KERNEL_LAUNCHES)
    got = cops.ell_spmv(nbr, mask, w, x, op=op)
    torch.cuda.synchronize()
    assert (cops.KERNEL_LAUNCHES, ops.KERNEL_LAUNCHES) == \
        (before[0] + 1, before[1])
    want = ell_combine_plain(nbr, mask, w, x, op=op)
    if op == "sum":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
    else:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_ell_spmv_raises_on_what_it_does_not_take():
    nbr, mask, w, x = _inputs(10, 3, 10, 1, "unit")
    with pytest.raises(ValueError, match="float32"):
        cops.ell_spmv(nbr, mask, w, x.double(), op="sum")
    with pytest.raises(ValueError, match="unknown op"):
        cops.ell_spmv(nbr, mask, w, x, op="mean")
    with pytest.raises(ValueError, match="contiguous"):
        cops.ell_spmv(nbr.t().contiguous().t(), mask, w, x, op="min")


# ------------------------------------------------------- cohesion queries

def test_cohesion_queries_on_the_card_match_the_cpu():
    """Triangles (both variants; intersect through the kernel), k-core on
    every variant (fused through the superstep kernel) and degree stats
    return the CPU run's answers."""
    cpu = LocalEngine(_graph("cpu"), device="cpu")
    gpu = LocalEngine(_graph("cuda"))
    want = cpu.run("triangle_count", variant="intersect").value
    before = iops.KERNEL_LAUNCHES
    assert gpu.run("triangle_count", variant="intersect").value == want
    assert iops.KERNEL_LAUNCHES == before + 1
    assert gpu.run("triangle_count", variant="bitset").value == want
    kc = cpu.run("k_core", {"k": 4}, variant="dense")
    for variant in ("dense", "fused", "frontier"):
        before = ops.KERNEL_LAUNCHES
        r = gpu.run("k_core", {"k": 4}, variant=variant)
        launched = ops.KERNEL_LAUNCHES - before
        assert (launched >= r.iterations) if variant == "fused" \
            else launched == 0, variant
        assert torch.equal(r.value.cpu(), kc.value), variant
        assert r.iterations == kc.iterations, variant
    plat = GraphPlatform(_graph("cuda"))
    assert plat.query(GraphQuery.degree_stats()).value == \
        GraphPlatform(_graph("cpu"), device="cpu").query(
            GraphQuery.degree_stats()).value
