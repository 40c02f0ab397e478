"""The port on the card: the CUDA kernel against its plain version, and
the engines and platform on ``cuda:0`` against the same port on the CPU.

Every test needs a CUDA device and skips without one (the kernel has no
CPU mode).  The file imports neither jax nor the reference package, so
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
