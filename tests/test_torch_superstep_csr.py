"""The dense superstep's CSR entry on the host: its plain version
(``ref.csr_superstep_plain``, what ``ops.csr_superstep`` runs for CPU
tensors) against the dense path's own gather and ``_local_combine``, the
layout it reads (``ops.csr_layout``: row offsets and the tile table of the
kernel's merge path), the predicate that routes a dense superstep to it
(``pregel.csr_engages``), and ``_run_dense`` wired through it.  The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py``.
"""
import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core import pregel as P  # noqa: E402
from repro_torch.core.algorithms import traversal  # noqa: E402
from repro_torch.core.partition import partition  # noqa: E402
from repro_torch.kernels.pregel_superstep import ops  # noqa: E402

INF = float("inf")
IMAX = int(np.iinfo(np.int32).max)
PROGRAMS = list(ops.EDGE_PROGRAMS)


def _layout_graph(kind, seed=0):
    """A 1-D edge layout (sorted by destination, padding = V) of ``kind``:
    ``empty_rows`` (most rows without in-edges), ``hub`` (one row of
    several tiles' edges beside short rows), ``no_edges``."""
    rng = np.random.default_rng(seed)
    if kind == "no_edges":
        V, src, dst = 50, np.zeros(0, np.int64), np.zeros(0, np.int64)
    elif kind == "empty_rows":
        V = 400
        src, dst = rng.integers(0, V, 300), rng.integers(0, V // 8, 300) * 8
    else:
        V = 300
        n = 3 * ops.CSR_TILE
        src = rng.integers(0, V, n + 500)
        dst = np.concatenate([np.full(n, 17), rng.integers(0, V, 500)])
    w = rng.uniform(0.1, 2.0, src.size)
    g = G.build_coo(src, dst, V, w=w, dedup=False, device="cpu")
    return partition(g, 1, device="cpu")


def _state(V, dtype, seed=1):
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        return torch.from_numpy(rng.permutation(V).astype(np.int32))
    x = rng.integers(0, 40, V).astype(np.float32)
    x[rng.random(V) < 0.3] = np.inf
    return torch.from_numpy(x)


def _dense(sg, x, message, op, identity):
    """The dense path's superstep: gather, message, ``_local_combine``."""
    src = x.index_select(0, sg.gather_index("src", x.shape[0]))
    return P._local_combine(message(src, sg.w), sg.combine_index(),
                            sg.v_local, op, identity)


@pytest.mark.parametrize("kind", ["empty_rows", "hub", "no_edges"])
@pytest.mark.parametrize("message", PROGRAMS, ids=lambda m: m.__name__)
@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32],
                         ids=["float32", "int32"])
def test_plain_csr_matches_the_dense_combine(kind, message, op, dtype):
    """Bit for bit, with inf in the state, rows without in-edges (the
    identity), a row longer than a tile and the padding edges dropped."""
    sg = _layout_graph(kind)
    assert int(sg.dst[-1]) == sg.n_vertices          # padding is there
    x = _state(sg.n_vertices, dtype)
    if message is ops.msg_src and dtype == torch.int32:
        identity = IMAX if op == "min" else -1
    else:
        identity = INF if op == "min" else -2.5
    want = _dense(sg, x, message, op, identity)
    got = ops.csr_superstep(sg.csr_index(), sg.src, sg.w, x,
                            message=message, op=op, identity=identity)
    assert got.dtype == want.dtype
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.parametrize("kind", ["empty_rows", "hub", "no_edges"])
def test_layout_tiles_lie_on_the_merge_path(kind):
    """rowptr counts each row's in-edges (padding left out); tile t starts
    at item t * CSR_TILE of the merge of row ends and edges, at a
    coordinate (row i, edge j) with row i's edges around edge j."""
    sg = _layout_graph(kind)
    V = sg.n_vertices
    lay = sg.csr_index()
    dst = sg.dst[sg.dst < V].long()
    counts = torch.bincount(dst, minlength=V)
    assert lay.rowptr.dtype == torch.int32 and lay.tiles.dtype == torch.int32
    assert torch.equal(lay.rowptr.diff().long(), counts)
    assert int(lay.rowptr[0]) == 0
    nnz = int(lay.rowptr[-1])
    total = V + nnz
    rp = lay.rowptr.tolist()
    tiles = lay.tiles.tolist()
    assert len(tiles) == max(1, -(-total // ops.CSR_TILE)) + 1
    assert tiles[0] == [0, 0] and tiles[-1] == [V, nnz]
    for t, (i, j) in enumerate(tiles):
        assert i + j == min(t * ops.CSR_TILE, total)
        if i < V:
            assert rp[i] <= j <= rp[i + 1]
    if kind == "hub":                      # the hub is cut by tiles
        assert sum(1 for i, j in tiles[1:-1] if rp[i] < j) >= 2


def test_layout_of_unsorted_destinations_is_none():
    """Two edge shards side by side are not sorted by destination: no CSR,
    and the dense superstep keeps the PyTorch ops."""
    g = G.build_coo(np.arange(40) % 7, np.arange(40) % 13, 13,
                    device="cpu")
    assert partition(g, 1, device="cpu").csr_index() is not None
    assert partition(g, 2, device="cpu").csr_index() is None


def test_cuda_source_tiles_as_the_layout_does():
    """The CSR entry's tile of row ends and edges is the layout's, and its
    C signature the one the wrapper binds."""
    src = (ops.CSRC / "superstep.cu").read_text()
    assert "constexpr int kCsrThreads = 256;" in src
    assert "constexpr int kCsrItems = 8;" in src
    assert 256 * 8 == ops.CSR_TILE
    assert 'extern "C" int pregel_superstep_csr(const void* rowptr, ' \
        'const void* tiles,' in src


def _cuda_state(dim=1, dtype=torch.float32):
    """What the predicate reads of a state on a CUDA device."""
    return types.SimpleNamespace(device=torch.device("cuda", 0),
                                 dim=lambda: dim, dtype=dtype)


_BFS = traversal._BFS_SPEC


def _spec(**kw):
    import dataclasses
    return dataclasses.replace(_BFS, **kw)


@pytest.mark.parametrize("case,spec,state,mesh,engages", [
    ("bfs", _BFS, _cuda_state(), None, True),
    ("sssp", _spec(message=ops.msg_src_plus_w), _cuda_state(), None, True),
    ("cc_int32", _spec(message=ops.msg_src, identity=IMAX),
     _cuda_state(dtype=torch.int32), None, True),
    ("max", _spec(combine="max", identity=-INF), _cuda_state(), None, True),
    ("times_w", _spec(message=ops.msg_src_times_w), _cuda_state(), None,
     True),
    ("lifted_column", P.batched_spec(_BFS), _cuda_state(), None, True),
    ("sum", _spec(combine="sum", identity=0.0), _cuda_state(), None, False),
    ("grouped", _spec(combine=(("min", 1), ("max", 1)),
                      identity=(INF, -INF)), _cuda_state(), None, False),
    ("two_endpoint", _spec(needs_dst_state=True,
                           message=lambda s, w, d: s + 1.0),
     _cuda_state(), None, False),
    ("uncompiled", _spec(message=lambda s, w: s + 1.0), _cuda_state(), None,
     False),
    ("bf16_channel", _spec(message_dtype="bfloat16"), _cuda_state(), None,
     False),
    ("float64", _BFS, _cuda_state(dtype=torch.float64), None, False),
    ("2d_state", _BFS, _cuda_state(dim=2), None, False),
    ("cpu", _BFS, torch.zeros(4), None, False),
    ("mesh", _BFS, _cuda_state(), object(), False),
])
def test_csr_engages_where_the_kernel_computes_the_dense_superstep(
        case, spec, state, mesh, engages):
    assert P.csr_engages(spec, state, mesh) is engages, case


SPECS = {"bfs": traversal._BFS_SPEC, "sssp": traversal._SSSP_SPEC,
         "cc": importlib.import_module(
             "repro_torch.core.algorithms.connected_components")._CC_SPEC}


@pytest.mark.parametrize("algo", list(SPECS))
@pytest.mark.parametrize("batched", [False, True])
def test_run_dense_through_the_csr_route(algo, batched, monkeypatch):
    """With the predicate forced on (the CPU never engages it), the dense
    loop's supersteps go through ``csr_superstep`` (here its plain
    version), one counted a superstep, batched columns included, and the
    states are the PyTorch path's bytes."""
    sg = _layout_graph("hub")
    V = sg.n_vertices
    spec = SPECS[algo]
    if algo == "cc":
        init = torch.arange(V, dtype=torch.int32)
    else:
        init = torch.full((V,), INF)
        init[[3, 17]] = 0.0
    if batched:
        spec = P.batched_spec(spec)
        init = torch.stack([init, init.roll(5)], dim=1)
    want, n_want = P.run_pregel(spec, sg, init, 500)
    calls = []
    real = ops.csr_superstep

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(P, "csr_engages", lambda *a: True)
    monkeypatch.setattr(P.superstep_ops, "csr_superstep", counted)
    tl = P.Timeline()
    got, n_got = P.run_pregel(spec, sg, init, 500, timeline=tl)
    assert n_got == n_want
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert tl.kernel_supersteps == n_got
    assert len(calls) == n_got * (2 if batched else 1)
    assert tl.as_dict()["kernel_supersteps"] == n_got


@pytest.mark.parametrize("algo", list(SPECS))
def test_run_dense_without_kernels_keeps_the_pytorch_path(algo, monkeypatch):
    """``use_kernels=False`` (the plain engine of parity runs) never takes
    the CSR route, even where the predicate allows it, and a
    ``LocalEngine(use_kernels=False)`` hands that through to the dense
    variant."""
    from repro_torch.core.engines import LocalEngine
    monkeypatch.setattr(P, "csr_engages", lambda *a: True)
    monkeypatch.setattr(P.superstep_ops, "csr_superstep", None)
    sg = _layout_graph("hub")
    V = sg.n_vertices
    spec = SPECS[algo]
    if algo == "cc":
        init = torch.arange(V, dtype=torch.int32)
    else:
        init = torch.full((V,), INF)
        init[[3, 17]] = 0.0
    tl = P.Timeline()
    got, n_got = P.run_pregel(spec, sg, init, 500, timeline=tl,
                              use_kernels=False)
    assert n_got > 0 and tl.kernel_supersteps == 0
    rng = np.random.default_rng(2)
    g = G.build_coo(rng.integers(0, 200, 900), rng.integers(0, 200, 900),
                    200, w=rng.uniform(0.1, 2.0, 900), symmetrize=True,
                    device="cpu")
    r = LocalEngine(g, device="cpu", use_kernels=False).run(
        {"cc": "connected_components"}.get(algo, algo),
        {"cc": {}, "bfs": {"sources": (3,)}, "sssp": {"source": 3}}[algo],
        variant="dense", profile=True)
    assert r.meta["realized_variant"] == "dense"
    assert r.meta["timeline"]["kernel_supersteps"] == 0
