"""The port on the card: the CUDA kernels against their plain versions,
the engines and platform on ``cuda:0`` against the same port on the CPU,
the dense LM's prefill and decode through the flash kernel, and every LM
family's prefill, decode and train step on the card against the CPU.

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
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    REL_TOL, mha_plain, rel_err)
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


def _layout(v, k, seed, off=0):
    """A layout that holds every case the kernel must get right: masks
    with holes, rows whose live slots are not at the left, all-dead rows,
    all-sentinel rows, ids past Vx (and negative) behind live and dead
    slots, and the mask's rows ``off`` bytes from 16-byte alignment."""
    rng = np.random.default_rng(seed)
    vx = max(v - 3, 1)                      # ids at v and above: past Vx
    nbr = rng.integers(-2, v + 3, (v, k)).astype(np.int32)
    mask = rng.random((v, k)) < 0.5
    mask[::7] = False                       # all-dead rows
    nbr[3::7] = v                           # all-sentinel rows
    mask[3::7] = False
    if k > 1:
        mask[1::7] = False                  # live slots at the right only
        mask[1::7, k - k // 3 - 1:] = True
        mask[2::7, 0] = False               # holes
    w = rng.uniform(0.1, 2.0, (v, k)).astype(np.float32)
    buf = torch.zeros(v * k + off, dtype=torch.bool, device="cuda")
    m = buf[off:].view(v, k)
    m.copy_(torch.from_numpy(mask))
    return (torch.from_numpy(nbr).cuda(), m, torch.from_numpy(w).cuda(),
            vx)


def _state_x(kind, vx, seed):
    rng = np.random.default_rng(seed + 1)
    if kind == "ids":
        x = rng.permutation(vx).astype(np.int32)
    elif kind == "big":                     # int32 sums that wrap
        x = rng.integers(2 ** 29, 2 ** 31 - 1, vx).astype(np.int32)
    elif kind == "nan":                     # NaN, +inf, -inf for min/max
        x = rng.integers(0, 40, vx).astype(np.float32)
        x[rng.random(vx) < 0.05] = np.nan
        x[rng.random(vx) < 0.1] = np.inf
        x[rng.random(vx) < 0.05] = -np.inf
    elif kind == "dist":
        x = rng.integers(0, 40, vx).astype(np.float32)
        x[rng.random(vx) < 0.3] = np.inf
    else:
        x = rng.random(vx).astype(np.float32)
    return torch.from_numpy(x).cuda()


# (edge program, state, monoid, channel dtype, identity): every channel
# dtype, NaN and +-inf through min/max, int32 sums that wrap
LAYOUT_COMBOS = [
    (ops.msg_src, "ids", "min", None, IMAX),
    (ops.msg_src, "ids", "max", None, -IMAX - 1),
    (ops.msg_src, "big", "sum", None, 0),
    (ops.msg_src, "ids", "min", "float32", INF),
    (ops.msg_src_plus_one, "nan", "min", None, INF),
    (ops.msg_src_plus_w, "nan", "max", None, -INF),
    (ops.msg_src_times_w, "unit", "sum", None, 0.0),
    (ops.msg_src, "nan", "min", "bfloat16", INF),
    (ops.msg_src_plus_w, "dist", "max", "float16", -INF),
]


@pytest.mark.parametrize("k", [0, 1, 19, 20, 128, 3000])
@pytest.mark.parametrize("off", [0, 3])
@pytest.mark.parametrize("msg,x_kind,op,md,ident", LAYOUT_COMBOS)
def test_kernel_matches_plain_on_every_layout(k, off, msg, x_kind, op, md,
                                              ident):
    """Rows of 0 to 3000 slots (3000: one row a block, walked in chunks),
    V not a multiple of the rows a block owns, and every case of
    ``_layout``: min/max and int32 sums bit-equal to the plain version,
    float sums within rtol 1e-5 (only the summation order differs)."""
    v = 37 if k >= 1000 else 1001
    nbr, mask, w, vx = _layout(v, k, seed=k * 13 + off, off=off)
    rows = ops._rows_per_tile(k)
    assert rows == 1 or v % rows != 0
    assert k == 0 or mask.data_ptr() % 16 == off
    x = _state_x(x_kind, vx, seed=k + off)
    kw = dict(message=msg, op=op, identity=ident, message_dtype=md)
    before = ops.KERNEL_LAUNCHES
    got = ops.fused_superstep(nbr, mask, w, x, **kw)
    torch.cuda.synchronize()
    assert ops.KERNEL_LAUNCHES == before + 1
    want = superstep_plain(nbr, mask, w, x, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    if op == "sum" and got.dtype != torch.int32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
    else:
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_kernel_float_sum_repeats_its_bytes():
    """A float sum is reduced in a fixed order: two calls, same bytes."""
    nbr, mask, w, vx = _layout(20000, 19, seed=3)
    x = _state_x("unit", vx, seed=3) * 1e3
    kw = dict(message=ops.msg_src_times_w, op="sum", identity=0.0)
    a = ops.fused_superstep(nbr, mask, w, x, **kw)
    b = ops.fused_superstep(nbr, mask, w, x, **kw)
    assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    torch.testing.assert_close(a, superstep_plain(nbr, mask, w, x, **kw),
                               rtol=1e-5, atol=0.0)


# ------------------------------------------- pregel_superstep, [Vx, B] state

def _misaligned(x):
    """A contiguous copy of ``x`` 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


def _check_batched(b, k, off, msg, x_kind, op, md, ident, misaligned):
    from repro_torch.core.pregel import Lifted
    v = 37 if k >= 1000 else 301
    nbr, mask, w, vx = _layout(v, k, seed=k * 7 + off + b, off=off)
    x = torch.stack([_state_x(x_kind, vx, seed=k + off + 11 * c)
                     for c in range(b)], dim=1).contiguous()
    if misaligned:
        x = _misaligned(x)
    kw = dict(message=Lifted(msg, (-1, None)), op=op, identity=ident,
              message_dtype=md)
    before = (ops.KERNEL_LAUNCHES, ops.BATCHED_LAUNCHES)
    got = ops.fused_superstep(nbr, mask, w, x, **kw)
    torch.cuda.synchronize()
    assert (ops.KERNEL_LAUNCHES, ops.BATCHED_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    want = superstep_plain(nbr, mask, w, x, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape == (v, b)
    if op == "sum" and got.dtype != torch.int32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
    else:
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    # each column is the 1-D kernel on that column
    for c in (0, b - 1):
        one = ops.fused_superstep(nbr, mask, w, x[:, c].contiguous(),
                                  message=msg, op=op, identity=ident,
                                  message_dtype=md)
        if op == "sum" and got.dtype != torch.int32:
            torch.testing.assert_close(got[:, c], one, rtol=1e-5, atol=0.0)
        else:
            assert torch.equal(got[:, c].contiguous().view(torch.uint8),
                               one.view(torch.uint8))


@pytest.mark.parametrize("b", [1, 3, 4, 8, 16, 33, 64])
@pytest.mark.parametrize("k", [0, 1, 19, 40, 3000])
@pytest.mark.parametrize("off", [0, 3])
@pytest.mark.parametrize("msg,x_kind,op,md,ident", LAYOUT_COMBOS)
def test_batched_kernel_matches_plain(b, k, off, msg, x_kind, op, md,
                                      ident):
    """The batched entry (state [Vx, B], a batched lift of the edge
    program, w shared by the columns) on every layout case: min/max and
    int32 sums bit-equal to the plain version, float sums within rtol
    1e-5; widths of 4-column groups (16-byte loads) and not, past 32
    columns included."""
    _check_batched(b, k, off, msg, x_kind, op, md, ident, misaligned=False)


@pytest.mark.parametrize("b", [4, 8, 16])
@pytest.mark.parametrize("k", [1, 19, 3000])
@pytest.mark.parametrize("msg,x_kind,op,md,ident", LAYOUT_COMBOS)
def test_batched_kernel_matches_plain_on_misaligned_state(b, k, msg, x_kind,
                                                          op, md, ident):
    """State whose rows start 4 bytes off 16-byte alignment (a contiguous
    view at an odd offset): the entry's 4-byte loads, the same answers."""
    _check_batched(b, k, 3, msg, x_kind, op, md, ident, misaligned=True)


def test_batched_kernel_rejects_what_it_does_not_take():
    from repro_torch.core.pregel import Lifted
    nbr, mask, w, x = _inputs(10, 3, 10, 1, "unit")
    x2 = x[:, None].repeat(1, 4)
    lifted = Lifted(ops.msg_src, (-1, None))
    with pytest.raises(ValueError, match="compiled edge program"):
        ops.fused_superstep(nbr, mask, w, x2,
                            message=Lifted(lambda s, w: s, (-1, None)),
                            op="min", identity=INF)
    with pytest.raises(ValueError, match="1-D"):          # lift, 1-D state
        ops.fused_superstep(nbr, mask, w, x, message=lifted, op="min",
                            identity=INF)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_superstep(nbr, mask, w, x2.t().contiguous().t(),
                            message=lifted, op="min", identity=INF)


@pytest.mark.parametrize("algo,ps", [
    ("bfs", [{"sources": (0,)}, {"sources": (7, 900)}, {"sources": (1500,)},
             {"sources": (2999,)}]),
    ("sssp", [{"source": s} for s in (0, 11, 400, 2000, 2500)]),
])
def test_fused_batch_on_the_card_launches_the_batched_kernel(algo, ps,
                                                             monkeypatch):
    """``run_batch`` with the fused variant forced: one batched launch a
    superstep, every column byte-equal to its solo run on the CPU."""
    from repro_torch.core.engines import Engine
    real = Engine.run_superstep
    monkeypatch.setattr(
        Engine, "run_superstep",
        lambda self, spec, s, mi, variant=None, init_active=None:
        real(self, spec, s, mi, variant="fused", init_active=init_active))
    gpu = LocalEngine(_graph("cuda"))
    cpu = LocalEngine(_graph("cpu"), device="cpu")
    before = ops.BATCHED_LAUNCHES
    got = gpu.run_batch(algo, ps)
    torch.cuda.synchronize()
    assert ops.BATCHED_LAUNCHES - before == got[0].iterations
    for p, r in zip(ps, got):
        assert r.meta["realized_variant"] == "fused"
        want = cpu.run(algo, p)
        assert torch.equal(r.value.cpu().view(torch.uint8),
                           want.value.view(torch.uint8))


def test_service_fuses_tickets_on_the_card():
    from repro_torch.core.service import GraphAnalyticsService
    svc = GraphAnalyticsService(interactive_threshold_s=0.0)
    svc.add_graph("g", _graph("cuda"))
    tickets = [svc.submit("g", GraphQuery.bfs([s])) for s in (0, 9, 2000)]
    svc.drain()
    assert svc.stats["fused_batches"] == 1
    cpu = GraphPlatform(_graph("cpu"), device="cpu")
    for t in tickets:
        assert torch.equal(svc.result(t).value.cpu().view(torch.uint8),
                           cpu.query(t.query).value.view(torch.uint8))


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
    """Every variant on cuda:0 (fused = the CUDA kernel's ELL entry,
    once per superstep; dense = its CSR entry) returns the CPU run's
    bytes and iteration count."""
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


# ------------------------------------------- pregel_superstep's CSR entry

def _csr_case(kind, seed, off=0):
    """Sorted destinations (padding = V) of ``kind``, with src, w and dst
    as views ``off`` elements into their arrays (off = 1: src and w not
    16-byte aligned), on the card."""
    rng = np.random.default_rng(seed)
    if kind == "empty_rows":
        V, n = 5000, 3000
        dst = np.sort(rng.integers(0, V // 7, n) * 7)
    elif kind == "hub":
        V, n = 3000, 5 * ops.CSR_TILE + 4000
        dst = np.sort(np.concatenate([np.full(5 * ops.CSR_TILE, 1234),
                                      rng.integers(0, V, 4000)]))
    elif kind == "no_edges":
        V, n, dst = 700, 0, np.zeros(0, np.int64)
    else:                       # power-law rows, many tiles
        V, n = 1 << 15, 1 << 20
        dst = np.sort(np.minimum(rng.zipf(1.3, n), V) - 1)
    pad = 4 + off
    dst = np.concatenate([dst, np.full(pad, V)]).astype(np.int32)
    src = rng.integers(-2, V + 3, n + pad).astype(np.int32)   # clamped
    w = rng.uniform(0.1, 2.0, n + pad).astype(np.float32)
    src, w, dst = (torch.from_numpy(a).cuda()[off:] for a in (src, w, dst))
    return V, src, w, ops.csr_layout(dst, V)


@pytest.mark.parametrize("kind", ["empty_rows", "hub", "no_edges", "zipf"])
@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("msg,x_kind,op,ident", [
    (ops.msg_src, "ids", "min", IMAX), (ops.msg_src, "ids", "max", -1),
    (ops.msg_src, "dist", "min", INF), (ops.msg_src_plus_one, "dist",
                                        "min", INF),
    (ops.msg_src_plus_w, "dist", "min", INF),
    (ops.msg_src_plus_w, "dist", "max", -INF),
    (ops.msg_src_times_w, "vals", "max", -3.0),
    (ops.msg_src_plus_one, "ids", "min", INF),
])
def test_csr_kernel_matches_plain(kind, off, msg, x_kind, op, ident):
    """Bit for bit against the plain version: rows without in-edges,
    rows cut by tiles, ids past either end, padding; the output the one
    allocation, and no ELL launch.  src and w off 16-byte alignment are
    refused with ``ValueError`` and launch nothing."""
    V, src, w, lay = _csr_case(kind, 5, off)
    rng = np.random.default_rng(9)
    if x_kind == "ids":
        x = torch.from_numpy(rng.permutation(V).astype(np.int32)).cuda()
    else:
        x = torch.from_numpy(rng.integers(0, 40, V).astype(np.float32))
        x[torch.from_numpy(rng.random(V) < 0.3)] = INF
        x = x.cuda()
    want = ops.csr_superstep(
        ops.CSRLayout(lay.rowptr.cpu(), lay.tiles.cpu()), src.cpu(),
        w.cpu(), x.cpu(), message=msg, op=op, identity=ident)
    before, ell = ops.CSR_LAUNCHES, ops.KERNEL_LAUNCHES
    if off:
        with pytest.raises(ValueError, match="16-byte aligned"):
            ops.csr_superstep(lay, src, w, x, message=msg, op=op,
                              identity=ident)
        assert ops.CSR_LAUNCHES == before and ops.KERNEL_LAUNCHES == ell
        return
    got = ops.csr_superstep(lay, src, w, x, message=msg, op=op,
                            identity=ident)
    torch.cuda.synchronize()
    assert ops.CSR_LAUNCHES == before + 1 and ops.KERNEL_LAUNCHES == ell
    assert got.dtype == want.dtype and got.shape == (V,)
    assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8))


def test_csr_kernel_propagates_nan_and_rejects_what_it_does_not_take():
    V, src, w, lay = _csr_case("hub", 3)
    x = torch.full((V,), 5.0, device="cuda")
    x[src[:7].long().clamp(0, V - 1)] = float("nan")
    for op in ("min", "max"):
        got = ops.csr_superstep(lay, src, w, x, message=ops.msg_src_plus_w,
                                op=op, identity=INF)
        want = ops.csr_superstep(
            ops.CSRLayout(lay.rowptr.cpu(), lay.tiles.cpu()), src.cpu(),
            w.cpu(), x.cpu(), message=ops.msg_src_plus_w, op=op,
            identity=INF)
        assert torch.equal(got.isnan().cpu(), want.isnan())
        keep = ~want.isnan()
        assert torch.equal(got.cpu()[keep], want[keep])
    with pytest.raises(ValueError, match="min or max"):
        ops.csr_superstep(lay, src, w, x, message=ops.msg_src, op="sum",
                          identity=0.0)
    with pytest.raises(ValueError, match="compiled edge program"):
        ops.csr_superstep(lay, src, w, x, message=lambda a, b: a,
                          op="min", identity=INF)
    with pytest.raises(ValueError, match="1-D int32 or float32"):
        ops.csr_superstep(lay, src, w, x.double(), message=ops.msg_src,
                          op="min", identity=INF)


def _kronecker(scale, seed=4):
    """A Graph 500 Kronecker graph (edge factor 16) with its labels
    permuted, symmetrized, weighted, on the card."""
    src, dst, n = synthetic.rmat_graph(scale, 16, seed=seed)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    w = rng.uniform(0.0, 1.0, src.size)
    return G.build_coo(perm[src], perm[dst], n, w=w, symmetrize=True,
                       device="cuda")


@pytest.fixture(scope="module")
def kron18():
    return _kronecker(18)


@pytest.mark.parametrize("algo,params", [
    ("bfs", {"sources": (0,)}), ("bfs", {"sources": (12345, 7)}),
    ("sssp", {"source": 0}), ("sssp", {"source": 99999}),
    ("connected_components", {}),
])
def test_dense_superstep_through_the_csr_entry(kron18, algo, params):
    """The dense variant on the card runs each superstep through the CSR
    entry (one launch and one ``kernel_supersteps`` a superstep, no ELL
    launch) and returns the bytes and iterations of the plain engine
    (``use_kernels=False``), whose dense run keeps the PyTorch path and
    launches nothing."""
    eng = LocalEngine(kron18)
    csr, ell = ops.CSR_LAUNCHES, ops.KERNEL_LAUNCHES
    got = eng.run(algo, params, variant="dense", profile=True)
    torch.cuda.synchronize()
    assert got.meta["realized_variant"] == "dense"
    assert ops.CSR_LAUNCHES - csr == got.iterations
    assert got.meta["timeline"]["kernel_supersteps"] == got.iterations
    assert ops.KERNEL_LAUNCHES == ell
    want = LocalEngine(kron18, use_kernels=False).run(
        algo, params, variant="dense", profile=True)
    torch.cuda.synchronize()
    assert want.meta["realized_variant"] == "dense"
    assert want.meta["timeline"]["kernel_supersteps"] == 0
    assert ops.KERNEL_LAUNCHES == ell
    assert ops.CSR_LAUNCHES - csr == got.iterations
    assert got.iterations == want.iterations
    assert torch.equal(got.value.view(torch.uint8),
                       want.value.view(torch.uint8))


def test_dense_csr_route_allocates_nothing_new_after_warm_up(kron18):
    """After a BFS and an SSSP query, 20 more dense queries take every
    block from the caching allocator: no device segment is allocated."""
    eng = LocalEngine(kron18)
    for algo, p in (("bfs", {"sources": (1,)}), ("sssp", {"source": 1})):
        eng.run(algo, p, variant="dense")
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats()
    segments = stats["segment.all.allocated"]
    launches = ops.CSR_LAUNCHES
    for k in range(10):
        for algo, p in (("bfs", {"sources": (1000 * k + 3,)}),
                        ("sssp", {"source": 1000 * k + 5})):
            r = eng.run(algo, p, variant="dense")
            del r
    torch.cuda.synchronize()
    assert ops.CSR_LAUNCHES > launches
    assert torch.cuda.memory_stats()["segment.all.allocated"] == segments


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


def _runs_case(k, seed):
    """An orientation-shaped input: V rows of at most k sorted, deduped
    ids plus the all-sentinel row V; edges grouped by eu in runs of 1 to
    300 (runs that cross warps and blocks of 256 edges), some rows
    identical, some all sentinel, and padding edges eu = ev = V."""
    rng = np.random.default_rng(seed)
    V = 700
    nbr = _sorted_rows(rng, V + 1, k, V, fill=1.0)
    nbr[V] = V
    nbr[1] = nbr[0]                          # identical rows
    nbr[5:9] = V                             # all-sentinel rows
    lengths = [1, 31, 32, 33, 255, 256, 257, 300, 2, 3, 64, 1, 7]
    heads = np.sort(rng.choice(V, size=len(lengths), replace=False))
    eu = np.repeat(heads, lengths)
    ev = rng.integers(0, V, eu.size)
    ev[:40] = eu[:40]                        # a row against itself
    nbr[eu[:40], 0] = np.where(nbr[eu[:40], 0] == V, 0, nbr[eu[:40], 0])
    ev[40:80] = np.repeat([0, 1, 5, 9], 10)
    eu = np.concatenate([eu, np.full(100, V)])
    ev = np.concatenate([ev, np.full(100, V)])
    return [torch.from_numpy(a.astype(np.int32)).cuda()
            for a in (nbr, eu, ev)] + [V]


@pytest.mark.parametrize("k", [1, 9, 31, 32, 33, 3000])
def test_intersect_kernel_runs_padding_and_both_paths(k):
    """Both paths (K <= 32 staged in shared memory, wider rows searched)
    on runs of one eu that cross warp and block boundaries, identical and
    all-sentinel rows, and padding edges (count 0): exact counts."""
    nbr, eu, ev, V = _runs_case(k, seed=k)
    before = iops.KERNEL_LAUNCHES
    got = iops._launch(nbr, eu, ev, V)
    torch.cuda.synchronize()
    assert iops.KERNEL_LAUNCHES == before + 1
    want = ell_intersect_plain(nbr[eu.long()], nbr[ev.long()], V)
    assert torch.equal(got, want)
    assert int(want.sum()) > 0 and not bool(got[-100:].any())


@pytest.mark.parametrize("k", [1, 9, 31, 32, 33, 3000])
def test_intersect_two_matrix_form_every_path(k):
    """The two-row-matrix form (eu = arange(E), ev = arange(E) + E: no
    runs at all) with identical and all-sentinel rows, on both paths."""
    rng = np.random.default_rng(k + 1)
    e, vx = (40 if k >= 1000 else 600), 5000
    a = _sorted_rows(rng, e, k, vx, fill=0.9)
    b = _sorted_rows(rng, e, k, vx, fill=0.9)
    b[::5] = a[::5]                          # identical rows
    a[1::5] = vx                             # all-sentinel rows
    ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    got = iops.ell_intersect(ta, tb, vx)
    want = ell_intersect_plain(ta, tb, vx)
    assert torch.equal(got, want)
    assert torch.equal(got[::5], (ta[::5] < vx).sum(1, dtype=torch.int32))
    assert not bool(got[1::5].any())


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


def _ell_case(v, k, off, seed):
    """Masks with holes and all-dead rows; negative and sentinel ids at
    live slots (clamped to the ends of x); inf and NaN in x, and inf in
    w, only behind dead slots; the mask's rows misaligned by ``off``
    bytes from 16."""
    rng = np.random.default_rng(seed)
    vx = v + 2
    nbr = rng.integers(-2, vx + 2, (v, k)).astype(np.int32)
    mask = rng.random((v, k)) < 0.4
    mask[::5] = False
    if k > 1:
        mask[1::5, 0] = False
        mask[1::5, -1] = True
    live = nbr[mask]
    nbr[mask] = np.where((live == 5) | (live == 6), 7, live)
    nbr[~mask] = 5 + np.arange(int((~mask).sum())) % 2
    w = rng.uniform(0.1, 2.0, (v, k)).astype(np.float32)
    w[~mask] = np.inf
    x = rng.random(vx).astype(np.float32)
    x[5], x[6] = np.inf, np.nan
    buf = torch.zeros(v * k + off, dtype=torch.bool, device="cuda")
    m = buf[off:].view(v, k)
    m.copy_(torch.from_numpy(mask))
    return [torch.from_numpy(a).cuda() for a in (nbr,)] + [m] + \
        [torch.from_numpy(a).cuda() for a in (w, x)]


@pytest.mark.parametrize("k", [0, 1, 7, 128, 129, 3000])
@pytest.mark.parametrize("off", [0, 3])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_ell_spmv_kernel_holes_ids_and_misaligned_rows(k, off, op):
    v = 40 if k >= 1000 else 300
    nbr, mask, w, x = _ell_case(v, k, off, seed=k * 7 + off)
    assert k == 0 or mask.data_ptr() % 16 == off   # (empty: no storage)
    before = (cops.KERNEL_LAUNCHES, ops.KERNEL_LAUNCHES)
    got = cops.ell_spmv(nbr, mask, w, x, op=op)
    torch.cuda.synchronize()
    assert (cops.KERNEL_LAUNCHES, ops.KERNEL_LAUNCHES) == \
        (before[0] + 1, before[1])
    want = ell_combine_plain(nbr, mask, w, x, op=op)
    assert not bool(got.isnan().any()) and not bool(want.isnan().any())
    if op == "sum":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
        assert bool((got[::5] == 0).all())
    else:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


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


# -------------------------------------------------------- flash attention

def _attn(b, hq, hkv, s, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, h, s, d, generator=g, device="cuda").to(dtype)
            for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("b,hq,hkv,s,d,dtype,kw", [
    (1, 2, 2, 128, 16, torch.float32, dict(causal=True)),
    (2, 4, 2, 100, 32, torch.float32, dict(causal=False)),
    (3, 8, 1, 77, 64, torch.float32, dict(causal=True, window=5)),
    (1, 8, 1, 1000, 32, torch.float32, dict(causal=False, window=40)),
    (2, 4, 2, 200, 128, torch.bfloat16, dict(causal=True, window=64,
                                             softcap=50.0)),
    (1, 2, 1, 130, 256, torch.bfloat16, dict(causal=True, softcap=30.0)),
    (1, 2, 2, 64, 256, torch.float32, dict(causal=False)),
    (2, 6, 3, 1, 64, torch.bfloat16, dict(causal=True)),
    (2, 4, 1, 40, 16, torch.bfloat16, dict(causal=True)),
    (3, 8, 2, 333, 32, torch.bfloat16, dict(causal=True, window=100)),
    (1, 8, 8, 257, 64, torch.bfloat16, dict(causal=False, softcap=20.0)),
    (2, 8, 4, 1000, 256, torch.bfloat16, dict(causal=True, window=300,
                                              softcap=50.0)),
])
def test_flash_kernel_matches_plain(b, hq, hkv, s, d, dtype, kw):
    q, k, v = _attn(b, hq, hkv, s, d, dtype, seed=s + d)
    before = fops.KERNEL_LAUNCHES
    got = fops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fops.KERNEL_LAUNCHES == before + 1
    want = mha_plain(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    # float32: summation order only; bfloat16: the reference's tolerance
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # and each error against the size of its row's outputs
    assert rel_err(got, want) <= REL_TOL[dtype]


@pytest.mark.parametrize("b,hq,hkv,s,d,dtype,kw", [
    (2, 4, 2, 150, 64, torch.float32, dict(causal=True, softcap=50.0)),
    (1, 8, 1, 300, 256, torch.float32, dict(causal=True, window=64,
                                            softcap=30.0)),
    (2, 8, 4, 1000, 256, torch.bfloat16, dict(causal=True, window=300,
                                              softcap=50.0)),
    (1, 4, 2, 513, 128, torch.bfloat16, dict(causal=False, softcap=20.0)),
])
def test_flash_kernel_softcap_at_large_logits(b, hq, hkv, s, d, dtype, kw):
    """q scaled by 10 (scaled logits of std 10, up to about 50) drives
    the logits into the cap, where a kernel without the softcap is far
    outside the bound: the kernel launched with ``softcap=0`` shows it."""
    q, k, v = _attn(b, hq, hkv, s, d, torch.float32, seed=s + d + 1)
    q, k, v = (q * 10).to(dtype), k.to(dtype), v.to(dtype)
    got = fops.flash_attention(q, k, v, **kw)
    want = mha_plain(q, k, v, **kw)
    assert rel_err(got, want) <= REL_TOL[dtype]
    uncapped = fops.flash_attention(q, k, v, **{**kw, "softcap": 0.0})
    assert rel_err(uncapped, want) > 10 * REL_TOL[dtype]


def test_flash_kernel_reads_strided_views():
    """The model's [B, S, H, D] activations, transposed, need no copy."""
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _attn(2, 8, 4, 96, 64, torch.bfloat16, seed=3))
    assert not q.is_contiguous()
    got = fops.flash_attention(q, k, v, causal=True, window=32)
    want = fops.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True, window=32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("d", fops.HEAD_DIMS)
@pytest.mark.parametrize("s", [1, 77, 1000, 8193])
@pytest.mark.parametrize("g", [1, 3, 4, 8])
def test_flash_bf16_every_head_dim_and_length(d, s, g):
    """The Hopper kernel at every head dim it takes, lengths around its
    128-row query tile and its 64/128-key tiles (8193: one past 64 of
    them), causal, G query heads per kv head (2 kv heads)."""
    q, k, v = _attn(1, 2 * g, 2, s, d, torch.bfloat16, seed=s * d + g)
    before = fops.KERNEL_LAUNCHES
    got = fops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fops.KERNEL_LAUNCHES == before + 1
    want = mha_plain(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert rel_err(got, want) <= REL_TOL[torch.bfloat16]


@pytest.mark.parametrize("g", [1, 3, 4, 8])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_bf16_query_groups(g, d):
    """GQA with G query heads per kv head, each reading its kv head in
    place; non-causal, so every key tile is open."""
    q, k, v = _attn(2, 2 * g, 2, 300, d, torch.bfloat16, seed=g + d)
    got = fops.flash_attention(q, k, v, causal=False)
    assert rel_err(got, mha_plain(q, k, v, causal=False)) <= \
        REL_TOL[torch.bfloat16]


@pytest.mark.parametrize("d", [32, 128, 256])
@pytest.mark.parametrize("window", [1, 5, 40, 100])
def test_flash_bf16_windows_inside_a_tile(d, window):
    """Windows smaller than a key tile: most tiles of the band are
    skipped, and the open ones are masked on both sides."""
    q, k, v = _attn(1, 4, 2, 777, d, torch.bfloat16, seed=window + d)
    kw = dict(causal=True, window=window, softcap=30.0)
    got = fops.flash_attention(q, k, v, **kw)
    assert rel_err(got, mha_plain(q, k, v, **kw)) <= REL_TOL[torch.bfloat16]


@pytest.mark.parametrize("d", [64, 256])
def test_flash_bf16_window_of_s_or_more_masks_nothing(d):
    q, k, v = _attn(1, 4, 2, 500, d, torch.bfloat16, seed=d)
    full = fops.flash_attention(q, k, v, causal=True)
    for window in (500, 501, 10 ** 6):
        assert torch.equal(fops.flash_attention(q, k, v, causal=True,
                                                window=window), full)


@pytest.mark.parametrize("d", fops.HEAD_DIMS)
def test_flash_bf16_softcap_at_the_cap_every_head_dim(d):
    """q scaled by 10: logits up to about 50, bent hard by a softcap of
    50; the kernel launched without it must fail the same bound."""
    q, k, v = _attn(2, 4, 2, 600, d, torch.float32, seed=d + 2)
    q, k, v = (q * 10).bfloat16(), k.bfloat16(), v.bfloat16()
    kw = dict(causal=True, softcap=50.0)
    want = mha_plain(q, k, v, **kw)
    assert rel_err(fops.flash_attention(q, k, v, **kw), want) <= \
        REL_TOL[torch.bfloat16]
    assert rel_err(fops.flash_attention(q, k, v, causal=True), want) > \
        10 * REL_TOL[torch.bfloat16]


@pytest.mark.parametrize("d", fops.HEAD_DIMS)
def test_flash_bf16_reads_the_models_transposed_views(d):
    """[B, S, H, D] activations, transposed: TMA walks their strides, no
    copy, and the result is the contiguous inputs' bytes."""
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _attn(2, 8, 4, 333, d, torch.bfloat16, seed=d + 3))
    assert not q.is_contiguous()
    kw = dict(causal=True, window=200)
    got = fops.flash_attention(q, k, v, **kw)
    want = fops.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), **kw)
    assert torch.equal(got, want)
    assert rel_err(got, mha_plain(q, k, v, **kw)) <= REL_TOL[torch.bfloat16]


def test_flash_kernel_raises_on_what_it_does_not_take():
    q, k, v = _attn(1, 4, 2, 64, 64, torch.float32, seed=4)
    with pytest.raises(ValueError, match="dtype"):
        fops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="dtype"):
        fops.flash_attention(q.double(), k.double(), v.double())
    q48, k48, v48 = _attn(1, 4, 2, 64, 48, torch.float32, seed=5)
    with pytest.raises(ValueError, match="head dim"):
        fops.flash_attention(q48, k48, v48)
    with pytest.raises(ValueError, match="cpu"):
        fops.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="contiguous"):
        fops.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                             k, v)
    with pytest.raises(ValueError, match="aligned"):
        fops.flash_attention(q[..., 1:33], k[..., 1:33], v[..., 1:33])
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    with pytest.raises(ValueError, match="zero stride"):
        fops.flash_attention(qb, kb[:, :1].expand(1, 2, 64, 64),
                             vb[:, :1].expand(1, 2, 64, 64))
    with pytest.raises(ValueError, match="aligned"):
        fops.flash_attention(qb[..., 4:36], kb[..., 4:36], vb[..., 4:36])


# --------------------------------------------------------------- LM serving

@pytest.mark.parametrize("arch", ["gemma2-2b", "smollm-360m", "granite-8b"])
def test_prefill_launches_flash_once_per_layer(arch):
    """Reduced config: one kernel launch per layer in prefill, none in a
    decode step.  In float32 the kernel's prefill equals the plain
    version's and the CPU's within 1e-4 (summation order); in bfloat16 its
    logits are no farther from the float32 model's than the plain
    version's are (mean absolute distance, within 2x: both carry the
    rounding of bf16 activations, which dominates)."""
    import dataclasses

    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.models.transformer import DenseLM
    from repro_torch.train.serve_step import greedy_generate
    cfg = dataclasses.replace(reduced_config(get_config(arch), n_layers=4),
                              attn_impl="flash", dtype="bfloat16")
    model = DenseLM(cfg, generator=torch.Generator(device="cuda")
                    .manual_seed(0))
    f32_cfg = dataclasses.replace(cfg, dtype="float32")
    # the same (shared) master weights, plain attention and/or float32
    plain = DenseLM(cfg, params=_tree(model.params), use_kernels=False)
    f32 = DenseLM(f32_cfg, params=_tree(model.params), use_kernels=False)
    f32_kernel = DenseLM(f32_cfg, params=_tree(model.params))
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)).cuda()

    def prefill(m):
        before = fops.KERNEL_LAUNCHES
        out, cache = m.prefill({"tokens": tok}, cache_len=48)
        torch.cuda.synchronize()
        assert fops.KERNEL_LAUNCHES == before + (cfg.n_layers
                                                 if m.use_kernels else 0)
        return out, cache

    got, cache = prefill(model)
    plain_out, _ = prefill(plain)
    ref32, _ = prefill(f32)
    got32, _ = prefill(f32_kernel)
    torch.testing.assert_close(got32, ref32, rtol=1e-4, atol=1e-4)
    cpu = DenseLM(f32.cfg, device="cpu", params=_tree(f32.params, "cpu"))
    want32, _ = cpu.prefill({"tokens": tok.cpu()}, cache_len=48)
    torch.testing.assert_close(got32.cpu(), want32, rtol=1e-4, atol=1e-4)
    assert bool(torch.isfinite(got).all())
    assert float((got - ref32).abs().mean()) <= \
        2 * float((plain_out - ref32).abs().mean())

    before = fops.KERNEL_LAUNCHES
    model.decode_step(tok[:, -1:], cache, 40)
    out = greedy_generate(model, {"tokens": tok}, steps=4, cache_len=48)
    torch.cuda.synchronize()
    assert fops.KERNEL_LAUNCHES == before + cfg.n_layers   # one prefill
    assert out.shape == (2, 4) and out.dtype == torch.int32


def _tree(params, device=None):
    return {k: _tree(v, device) if isinstance(v, torch.nn.ParameterDict)
            else (v.detach() if device is None else v.detach().to(device))
            for k, v in params.items()}


# --------------------------------------------------------------- training

@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["gemma2-2b", "smollm-360m"])
def test_train_step_on_the_card_matches_the_cpu(arch, remat):
    """One float32 AdamW step of a reduced model from the same weights
    and masked batch on ``cuda`` and on the CPU.  Loss, gradient norm
    and lr within rtol 1e-5 (summation order); ``m`` within rtol 1e-4 and
    1e-5 of the leaf's largest magnitude (the gradients' order of error).
    Parameters: the first step moves each by about lr * sign(g), so an
    element whose gradient lies within that tolerance of zero may differ
    by up to 2 lr; every other one within lr * 1e-3."""
    import dataclasses

    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.models.registry import init_params
    from repro_torch.models.transformer import DenseLM
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    from repro_torch.utils.tree import flatten_with_paths
    cfg = dataclasses.replace(reduced_config(get_config(arch)), remat=remat)
    params = init_params(cfg, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    lab = np.roll(tok, -1, axis=1)
    lab[:, -5:] = -1
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    lr = 1e-3
    opt = AdamWConfig(peak_lr=lr, warmup_steps=0)
    out = {}
    for dev in ("cpu", "cuda"):
        model = DenseLM(cfg, device=dev, params=_moved(params, dev))
        state, metrics = make_train_step(model, opt)(
            init_train_state(model),
            {k: v.to(dev) for k, v in batch.items()})
        out[dev] = state, {k: float(v) for k, v in metrics.items()}
    (cs, cm), (gs, gm) = out["cpu"], out["cuda"]
    for k in ("loss", "grad_norm", "lr"):
        assert gm[k] == pytest.approx(cm[k], rel=1e-5), k
    assert gm["tokens"] == cm["tokens"]
    m_cpu = dict(flatten_with_paths(cs.opt["m"]))
    for name, m in flatten_with_paths(gs.opt["m"]):
        torch.testing.assert_close(m.cpu(), m_cpu[name], rtol=1e-4,
                                   atol=1e-5 * float(m_cpu[name].abs().max()))
    for (name, p), (_, q) in zip(flatten_with_paths(gs.params),
                                 flatten_with_paths(cs.params)):
        g = m_cpu[name].abs() / 0.1
        loose = g <= max(1e-5, 1e-4 * float(g.max()))
        diff = (p.cpu() - q).abs()
        assert bool((diff[~loose] <= lr * 1e-3 + 1e-7 * q.abs()[~loose])
                    .all()), name
        assert bool((diff[loose] <= 2 * lr * 1.01).all()), name


def _moved(tree, device):
    return {k: _moved(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def test_flash_attention_raises_under_autograd_on_the_card():
    """The kernel's output carries no gradient: with grad enabled and an
    input that requires grad, ``attention_output(impl="flash")`` raises
    before launching; under ``no_grad`` it launches once."""
    from repro_torch.models import layers as TL
    q = torch.randn(1, 64, 4, 64, device="cuda", dtype=torch.bfloat16)
    k = torch.randn(1, 64, 2, 64, device="cuda", dtype=torch.bfloat16)
    v = torch.randn(1, 64, 2, 64, device="cuda", dtype=torch.bfloat16)
    pos = torch.arange(64, device="cuda")
    before = fops.KERNEL_LAUNCHES
    with pytest.raises(RuntimeError, match="forward only"):
        TL.attention_output(q, k.requires_grad_(), v, pos, pos, "flash")
    assert fops.KERNEL_LAUNCHES == before
    with torch.no_grad():
        TL.attention_output(q, k, v, pos, pos, "flash")
    assert fops.KERNEL_LAUNCHES == before + 1


# ------------------------------------------------- the other LM families

FAMILY_ARCHS = ["olmoe_1b_7b", "dbrx_132b", "hymba_1p5b", "xlstm_125m",
                "whisper_large_v3", "paligemma_3b"]


def _family_batch(cfg, seed, b=2, s=40):
    """Tokens, next-token labels (the last five masked) and the stub
    frontend's embeddings, on the CPU."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    lab = np.roll(tok, -1, axis=1)
    lab[:, -5:] = -1
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    if cfg.family == "encdec":
        batch["audio_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.prefix_len, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_prefill_and_decode_on_the_card_match_the_cpu(arch):
    """Reduced config, float32, the serve CLI's attention (flash for MoE
    and Hymba: the kernel on the card, its plain version on the CPU, one
    launch a layer in the prefill and none in a decode step): prefill
    logits, every cache entry and three decode steps within 1e-4
    (summation order; Hymba S = 40 past its window of 16)."""
    import dataclasses

    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.launch import serve
    from repro_torch.models.registry import build_model, init_params
    cfg = reduced_config(get_config(arch))
    cfg = dataclasses.replace(cfg, attn_impl=serve.default_attn_impl(cfg))
    params = init_params(cfg, "cpu", torch.Generator().manual_seed(0))
    batch = _family_batch(cfg, 1)
    del batch["labels"]
    cache_len = 44 + cfg.prefix_len
    out = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev, params=_moved(params, dev))
        before = fops.KERNEL_LAUNCHES
        logits, cache = model.prefill({k: v.to(dev) for k, v in
                                       batch.items()}, cache_len=cache_len)
        torch.cuda.synchronize()
        launched = fops.KERNEL_LAUNCHES - before
        steps = []
        tok = torch.argmax(logits[:, -1], -1)[:, None].int()
        for i in range(3):
            lg, cache = model.decode_step(tok, cache,
                                          40 + cfg.prefix_len + i)
            steps.append(lg)
            tok = torch.argmax(lg[:, -1], -1)[:, None].int()
        torch.cuda.synchronize()
        want = (cfg.n_layers if dev == "cuda" and cfg.attn_impl == "flash"
                else 0)
        assert launched == want == fops.KERNEL_LAUNCHES - before
        out[dev] = logits, cache, steps
    (cl, cc, cs), (gl, gc, gs) = out["cpu"], out["cuda"]
    torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
    assert sorted(gc) == sorted(cc)
    for name in cc:
        torch.testing.assert_close(gc[name].cpu(), cc[name], rtol=1e-4,
                                   atol=1e-4)
    for a, b in zip(gs, cs):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_train_step_on_the_card_matches_the_cpu(arch):
    """One float32 AdamW step of each reduced family on ``cuda`` and on
    the CPU from the same weights and batch, through CUDA autograd: the
    MoE gather / scatter, the doubling scan, the xLSTM time loops, the
    encoder and cross attention.  Loss, gradient norm and lr within rtol
    1e-5 (a relative 1e-4 for MoE's ``aux``, a sum over routing
    decisions); ``m`` within rtol 1e-4 and 1e-5 of the leaf's largest
    magnitude; parameters within lr * 1e-3, or 2 lr where the gradient
    is within that tolerance of zero (see
    ``test_train_step_on_the_card_matches_the_cpu``)."""
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.models.registry import build_model, init_params
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    from repro_torch.utils.tree import flatten_with_paths
    cfg = reduced_config(get_config(arch))
    params = init_params(cfg, "cpu", torch.Generator().manual_seed(0))
    batch = _family_batch(cfg, 2, b=4, s=32)
    lr = 1e-3
    opt = AdamWConfig(peak_lr=lr, warmup_steps=0)
    out = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev, params=_moved(params, dev))
        state, metrics = make_train_step(model, opt)(
            init_train_state(model),
            {k: v.to(dev) for k, v in batch.items()})
        out[dev] = state, {k: float(v) for k, v in metrics.items()}
    (cs, cm), (gs, gm) = out["cpu"], out["cuda"]
    assert set(gm) == set(cm) and gm["tokens"] == cm["tokens"]
    for k in set(cm) - {"tokens"}:
        assert gm[k] == pytest.approx(cm[k], rel=1e-4 if k == "aux"
                                      else 1e-5), k
    m_cpu = dict(flatten_with_paths(cs.opt["m"]))
    for name, m in flatten_with_paths(gs.opt["m"]):
        torch.testing.assert_close(m.cpu(), m_cpu[name], rtol=1e-4,
                                   atol=1e-5 * float(m_cpu[name].abs().max()))
    for (name, p), (_, q) in zip(flatten_with_paths(gs.params),
                                 flatten_with_paths(cs.params)):
        g = m_cpu[name].abs() / 0.1
        loose = g <= max(1e-5, 1e-4 * float(g.max()))
        diff = (p.cpu() - q).abs()
        assert bool((diff[~loose] <= lr * 1e-3 + 1e-7 * q.abs()[~loose])
                    .all()), name
        assert bool((diff[loose] <= 2 * lr * 1.01).all()), name


@pytest.mark.parametrize("b,hq,hkv,s,d,kw", [
    (2, 16, 16, 2048, 128, dict(causal=True)),                 # OLMoE
    (2, 25, 5, 4096, 64, dict(causal=True, window=1024)),      # Hymba local
    (2, 25, 5, 4096, 64, dict(causal=True)),                   # Hymba global
    (1, 25, 5, 1100, 64, dict(causal=True, window=1024)),      # ragged
])
def test_flash_at_the_family_prefill_shapes(b, hq, hkv, s, d, kw):
    """bf16 at OLMoE's (MHA, D = 128) and Hymba's (group 5, D = 64,
    window 1024) prefill shapes against the plain version: ``rel_err``
    within ``REL_TOL``."""
    gen = torch.Generator(device="cuda").manual_seed(s)
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda")
               .bfloat16() for h in (hq, hkv, hkv))
    got = fops.flash_attention(q, k, v, **kw)
    want = mha_plain(q, k, v, **kw)
    assert got.dtype == torch.bfloat16
    assert rel_err(got, want) <= REL_TOL[torch.bfloat16]


def test_nccl_mesh_of_one_card_matches_the_local_engine(tmp_path):
    """A 1 x 1 NCCL ``DeviceMesh``: ``DistributedEngine(coo, mesh=...)``
    and ``GraphPlatform(coo, mesh=...)`` return LocalEngine's bytes on
    the card and launch no kernel (the mesh path is dense, as the
    reference's)."""
    from repro_torch.core.engines import DistributedEngine
    from repro_torch.launch import mesh as M
    g = _graph("cuda")
    queries = (("connected_components", {}), ("bfs", {"sources": (0, 1500)}),
               ("sssp", {"source": 11}), ("k_core", {"k": 3}))
    local = LocalEngine(g)
    want = [local.run(a, p) for a, p in queries]
    mods = (ops, iops, cops, fops)
    mesh = M.make_mesh((1, 1), device_type="cuda",
                       init_method=f"file://{tmp_path / 'rdv'}",
                       world_size=1, rank=0, timeout_s=60)
    try:
        before = [m.KERNEL_LAUNCHES for m in mods]
        eng = DistributedEngine(g, mesh=mesh)
        plat = GraphPlatform(g, mesh=mesh, force_engine="distributed")
        assert eng.device.type == "cuda" and eng.sharded.coord == (0, 0)
        for (a, p), w in zip(queries, want):
            got = eng.run(a, p)
            assert torch.equal(got.value.view(torch.uint8),
                               w.value.view(torch.uint8)), a
            assert got.iterations == w.iterations, a
        got = plat.query(GraphQuery.connected_components())
        assert got.engine == "distributed"
        assert torch.equal(got.value, want[0].value)
        assert [m.KERNEL_LAUNCHES for m in mods] == before
    finally:
        torch.distributed.destroy_process_group()
