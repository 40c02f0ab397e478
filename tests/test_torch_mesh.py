"""The port's distributed engine on a device mesh against the JAX
reference, on the CPU.

One four-rank gloo world (``torch_mesh_cases.rank_main``, each rank a
fresh interpreter with one thread) runs every case on a ``(2, 2)``
``DeviceMesh`` in the 1-D layout ``(2, 1)`` (the model axis replicates
the program) and the 2-D layout ``(2, 2)``; one JAX subprocess runs the
reference's algorithms on a 4-device virtual mesh of the same shape.
Both start once per module and run side by side.  Each world has its
own deadline (300 s) and every process group a timeout (60 s).

Tolerance: none for partitions, CC labels, BFS/SSSP distances, LPA
labels, triangle counts and k-core membership (byte-equal) and their
iteration counts; PageRank within 1e-6 (the reference's mesh test's),
HITS within 1e-4 (``tests/test_hits.py``'s), a warm-started PageRank
within 1e-4 (``tests/test_incremental.py``'s); the mesh body's float sums
within a relative 1e-6 of the meshless run (the ranks' partial sums add
in another order).  PageRank's iteration count is not compared: its halt,
an L1 under ``tol * V`` = 8e-8, sits below float32 resolution here
(ROADMAP §3, kept on purpose).
"""
import importlib
import io
import json
import re
import subprocess
import sys
import types
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_cases as C  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core import partition as JPart  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import partition as TPart  # noqa: E402
from repro_torch.core.engines import LocalEngine  # noqa: E402
from repro_torch.core.pregel import run_pregel  # noqa: E402
from repro_torch.data import synthetic as S  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import run_graph  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXACT = ("cc", "bfs", "sssp", "lpa", "triangles", "kcore")
ATOL = {"pagerank": 1e-6, "hits": 1e-4}
WORLD_DEADLINE_S = 300.0


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


# ---------------------------------------------------------------- partition

@pytest.mark.parametrize("V", [300, 301, 800])
@pytest.mark.parametrize("nd,nm", [(1, 2), (2, 2), (4, 2), (3, 4)])
def test_partition_2d_matches_reference(nd, nm, V):
    src, dst = S.user_follow_graph(V, 5.0, seed=3)
    w = np.random.default_rng(V).uniform(0.5, 2.0, src.size).astype(
        np.float32)
    want = JPart.partition_2d(JG.build_coo(src, dst, V, w=w), nd, nm)
    got = TPart.partition_2d(TG.build_coo(src, dst, V, w=w, device="cpu"),
                             nd, nm)
    for f in ("src", "dst", "w"):
        assert _bits(getattr(got, f)) == _bits(getattr(want, f)), f
    for f in ("e_shard", "v_local", "n_pad", "n_data", "n_model",
              "vertex_layout"):
        assert getattr(got, f) == getattr(want, f), f
    # shard (d, m) at index d * n_model + m holds only dst in range m
    d = got.dst.numpy().reshape(nd * nm, -1)
    for i in range(nd * nm):
        real = d[i][d[i] < V]
        assert (real // got.v_local == i % nm).all()


@pytest.mark.parametrize("nd,nm", [(3, 1), (2, 2), (3, 4)])
def test_shard_is_the_slice_of_its_coordinate(nd, nm):
    src, dst = S.user_follow_graph(301, 5.0, seed=3)
    g = TG.build_coo(src, dst, 301, device="cpu")
    sg = TPart.partition(g, nd, nm)
    for d in range(nd):
        for m in range(max(nm, 2)):
            if nm > 1 and m >= nm:
                continue
            one = sg.shard(d, m)
            i = d * nm + (m if nm > 1 else 0)
            sl = slice(i * sg.e_shard, (i + 1) * sg.e_shard)
            assert torch.equal(one.dst, sg.dst[sl])
            assert torch.equal(one.w, sg.w[sl])
            assert one.coord == (d, m if nm > 1 else 0)
            assert one.v_start == (m * sg.v_local if nm > 1 else 0)
            seg = one.combine_index()
            live = one.dst < 301
            assert torch.equal(seg[live], (one.dst[live] - one.v_start).long())
            assert bool((seg[~live] == sg.v_local).all())
    with pytest.raises(ValueError):
        sg.shard(nd, 0)
    with pytest.raises(ValueError):
        sg.shard(0, 0).shard(0, 0)


# ------------------------------------------------------------- the worlds

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The four-rank torch world and the JAX reference, side by side."""
    out = tmp_path_factory.mktemp("mesh")
    ref_dir = out / "reference"
    ref_dir.mkdir()
    ref = C.start_reference(str(ref_dir))
    ranks = C.run_world(str(out), timeout_s=WORLD_DEADLINE_S)
    try:
        ref_out, _ = ref.communicate(timeout=WORLD_DEADLINE_S)
    except subprocess.TimeoutExpired:
        ref.kill()
        ref_out, _ = ref.communicate()
    for r, (rc, o) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}:\n{o[-4000:]}"
    assert ref.returncode == 0, ref_out[-4000:]
    got = []
    for r in range(C.WORLD):
        with np.load(out / f"rank{r}.npz") as z:
            arrays = dict(z)
        got.append((arrays, json.loads((out / f"rank{r}.json").read_text())))
    with np.load(ref_dir / "reference.npz") as z:
        want = dict(z)
    return got, (want, json.loads((ref_dir / "reference.json").read_text()))


@pytest.fixture(scope="module")
def cpu_graphs():
    return C.graphs(TG, device="cpu")


def _local_engine(name, gs):
    """The port's meshless LocalEngine on the CPU: ``{key: array}``."""
    q = {"cc": ("g800s", "connected_components", {}),
         "pagerank": ("g800", "pagerank", {"max_iters": C.PR_ITERS,
                                           "tol": C.PR_TOL}),
         "bfs": ("g300s", "bfs", {"sources": (0,)}),
         "sssp": ("g300w", "sssp", {"source": 0}),
         "lpa": ("g300s", "label_propagation", {}),
         "triangles": ("g300s", "triangle_count", {}),
         "kcore": ("g300s", "k_core", {"k": C.KCORE_K}),
         "hits": ("g800", "hits", {"max_iters": C.HITS_ITERS,
                                   "tol": C.HITS_TOL})}[name]
    r = LocalEngine(gs[q[0]], device="cpu").run(q[1], q[2])
    if name == "triangles":
        return {"count": np.asarray(r.value)}, r.iterations
    if isinstance(r.value, dict):
        return {k: v.numpy() for k, v in r.value.items()}, r.iterations
    return {"value": r.value.numpy()}, r.iterations


@pytest.mark.parametrize("layout", C.LAYOUTS, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("name", C.ALGORITHMS)
def test_mesh_matches_reference_and_local_engine(worlds, cpu_graphs, name,
                                                 layout):
    """Every rank returns the same whole state; it equals the JAX package
    on the same virtual mesh and the port's meshless LocalEngine."""
    ranks, (want, want_meta) = worlds
    tag = f"{layout[0]}x{layout[1]}"
    keys = sorted(k for k in want if k.startswith(f"{name}/{tag}/"))
    assert keys
    local, local_iters = _local_engine(name, cpu_graphs)
    for arrays, meta in ranks:
        for k in keys:
            got, ref = arrays[k], want[k]
            assert got.shape == ref.shape, k
            if name in EXACT:
                assert _bits(got.astype(ref.dtype)) == _bits(ref), k
            else:
                np.testing.assert_allclose(got, ref, rtol=0,
                                           atol=ATOL[name], err_msg=k)
            field = k.rsplit("/", 1)[1]
            if field in local:
                if name in EXACT:
                    assert _bits(got.astype(local[field].dtype)) == \
                        _bits(local[field]), k
                else:
                    np.testing.assert_allclose(got, local[field], rtol=0,
                                               atol=ATOL[name], err_msg=k)
        assert _bits(arrays[keys[0]]) == _bits(ranks[0][0][keys[0]])
        if name in EXACT:
            assert meta[f"{name}/{tag}/iters"] == \
                want_meta[f"{name}/{tag}/iters"]
            if name != "cc":        # the engine takes its own variant
                assert meta[f"{name}/{tag}/iters"] == local_iters


@pytest.mark.parametrize("layout", C.LAYOUTS, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("case", C.UNIT_CASES)
def test_mesh_body_matches_the_meshless_run(worlds, case, layout):
    """min, max, sum, a grouped combine, global_value, needs_dst_state
    and a halt that stops early: every rank equals the meshless
    run_pregel, with the same superstep count."""
    ranks, _ = worlds
    tag = f"{layout[0]}x{layout[1]}"
    g = C.unit_graph(TG, device="cpu")
    sg = TPart.partition_1d(g, 1)
    want, want_iters = C.run_unit(case, sg, sg.n_vertices)
    if case == "halt_early":
        assert want_iters < C.unit_case(case)[2]
    for arrays, meta in ranks:
        got = arrays[f"unit/{case}/{tag}"]
        assert meta[f"unit/{case}/{tag}/iters"] == want_iters
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        else:
            assert _bits(got) == _bits(want)


@pytest.mark.parametrize("layout", C.LAYOUTS, ids=lambda t: f"{t[0]}x{t[1]}")
def test_engine_and_platform_on_the_mesh(worlds, cpu_graphs, layout):
    """``DistributedEngine(coo, mesh=...)`` takes its shard counts from
    the mesh and keeps one shard a rank; its BFS, k-core, a fused BFS
    batch (each column its query alone) and a warm-started PageRank
    (fewer supersteps, within the reference's warm-start 1e-4), and CC
    through ``GraphPlatform(coo, mesh=...)``, equal the LocalEngine."""
    ranks, _ = worlds
    tag = f"{layout[0]}x{layout[1]}"
    bfs, _ = _local_engine("bfs", cpu_graphs)
    core, _ = _local_engine("kcore", cpu_graphs)
    cc, _ = _local_engine("cc", cpu_graphs)
    alone = [LocalEngine(cpu_graphs["g300s"], device="cpu").run(
        "bfs", {"sources": s}).value.numpy() for s in C.BATCH_SOURCES]
    pr = LocalEngine(cpu_graphs["g800"], device="cpu").run(
        "pagerank", {"max_iters": C.PR_ITERS, "tol": 1e-7}).value.numpy()
    for arrays, meta in ranks:
        d, m = meta["coordinate"]
        assert meta[f"engine/{tag}/shards"] == \
            [2, layout[1], [d, m if layout[1] > 1 else 0]]
        assert _bits(arrays[f"engine/bfs/{tag}"]) == _bits(bfs["value"])
        for i, want in enumerate(alone):
            assert _bits(arrays[f"engine/batch{i}/{tag}"]) == _bits(want)
        cold, warm = meta[f"engine/pagerank_warm/{tag}/iters"]
        assert meta[f"engine/pagerank_warm/{tag}/mode"] == "warm"
        assert warm < cold
        # tests/test_incremental.py's tolerance for a warm start
        np.testing.assert_allclose(arrays[f"engine/pagerank_warm/{tag}"],
                                   pr, rtol=0, atol=1e-4)
        assert _bits(arrays[f"engine/kcore/{tag}"]) == _bits(core["value"])
        assert _bits(arrays[f"platform/cc/{tag}"]) == _bits(cc["value"])
        assert meta[f"platform/cc/{tag}/engine"] == "distributed"


def test_planted_plan_divergence_runs_the_broadcast_plan(worlds):
    """Rank 1 plans the local engine, the others the distributed one:
    every rank runs rank (0, 0)'s plan, and the answers agree."""
    ranks, _ = worlds
    own = [meta["divergence/own_plan"] for _, meta in ranks]
    assert own == ["distributed", "local", "distributed", "distributed"]
    for arrays, meta in ranks:
        assert meta["divergence/plan"] == "distributed"
        assert meta["divergence/ran"] == "distributed"
        assert _bits(arrays["divergence/value"]) == \
            _bits(ranks[0][0]["divergence/value"])


def test_a_rank_that_skips_a_collective_fails_within_the_timeout(worlds):
    """On a mesh with a 5 s timeout rank 1 runs no query: every rank
    waiting on it raises within the timeout instead of hanging."""
    ranks, _ = worlds
    for r, (_, meta) in enumerate(ranks):
        if r == 1:
            assert meta["skip/error"] is None
            continue
        assert meta["skip/error"] and "Timed out" in meta["skip/error"]
        assert meta["skip/seconds"] < 3 * C.SKIP_TIMEOUT_S


def test_local_and_production_meshes(worlds):
    """``make_local_mesh(2, 8)`` clamps to the 4-rank world as the
    reference clamps to its devices; the 16 x 16 production mesh refuses
    a world of 4."""
    ranks, _ = worlds
    for _, meta in ranks:
        assert meta["local_mesh"] == [2, 2]
        assert "needs 256 ranks" in meta["production_mesh"]


# ------------------------------------------------------- without a world

class _StubMesh:
    """What MeshAxes reads of a DeviceMesh, with no process group."""

    def __init__(self, shape, coord):
        self.mesh_dim_names = ("data", "model")
        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)
        self._coord = coord
        self.device_type = "cpu"

    def get_coordinate(self):
        return list(self._coord)

    def get_group(self, name):
        return types.SimpleNamespace(name=name)


def test_local_shard_refuses_a_mesh_it_does_not_fit():
    pregel = importlib.import_module("repro_torch.core.pregel")
    g = C.unit_graph(TG, device="cpu")
    ax = pregel.MeshAxes(_StubMesh((2, 2), (1, 1)))
    assert (ax.n_data, ax.d, ax.n_model, ax.m) == (2, 1, 2, 1)
    assert ax.rank_at(1, 0) == 2
    one = pregel._local_shard(TPart.partition(g, 2, 2), ax, "cpu")
    assert one.coord == (1, 1)
    assert pregel._local_shard(TPart.partition(g, 2, 1), ax,
                               "cpu").coord == (1, 0)
    with pytest.raises(ValueError, match="data shards"):
        pregel._local_shard(TPart.partition(g, 4, 1), ax, "cpu")
    with pytest.raises(ValueError, match="model shards"):
        pregel._local_shard(TPart.partition(g, 2, 4), ax, "cpu")
    with pytest.raises(ValueError, match="the shard of"):
        pregel._local_shard(TPart.partition(g, 2, 2).shard(0, 1), ax, "cpu")
    spec, init, _ = C.unit_case("min")
    with pytest.raises(ValueError, match="needs a mesh"):
        run_pregel(spec, TPart.partition(g, 2, 2), init(38), 3)


def test_make_mesh_refuses_before_it_starts_a_world():
    with pytest.raises(ValueError, match="differ in length"):
        M.make_mesh((2, 2), ("data",), device_type="cpu")
    with pytest.raises(ValueError, match="only gloo"):
        M.make_mesh((1, 1), device_type="cpu", backend="nccl")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        M.make_mesh((1, 1), device_type="tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.make_mesh((1, 1), device_type="cuda")
    m = _StubMesh((2, 2), (0, 1))
    assert M.mesh_axis_sizes(m) == {"data": 2, "model": 2}
    assert M.n_chips(m) == 4


# ------------------------------------------------------------------ the CLI

def _result(out: str) -> str:
    return re.search(r"\[done\].*result=(\S+)", out).group(1)


def test_run_graph_distributed_answers_as_the_reference_cli():
    """``--engine distributed --n-data 4`` runs the meshless distributed
    engine (it raised before) and counts the reference's components."""
    argv = ["--job", "cc", "--engine", "distributed", "--n-data", "4",
            "--vertices", "3000", "--count-only"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        r = run_graph.main(argv + ["--device", "cpu"])
    assert r.engine == "distributed"
    ref = subprocess.run(
        [sys.executable, "-m", "repro.launch.run_graph", *argv],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**__import__("os").environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu"})
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert _result(buf.getvalue()) == _result(ref.stdout)
    assert "engine=distributed" in ref.stdout
