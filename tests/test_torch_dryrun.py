"""The dry run, its roofline and the graph dry run against the reference,
on the CPU.

``tests/test_roofline.py`` mirrored: ring factors, the dominant term,
and per-rank costs (a sharded matmul of known size on a fake world of 4
counts ``2 M N K / 4`` FLOPs a rank and its shard's bytes times
``ring(4)``).  Every (arch x shape) of the reference's ``SHAPES`` on a
fake ``(2, 2)`` world at reduced configs: skipped exactly where the
reference's ``shape_applicable`` skips, ``model_flops`` equal to the
reference's ``model_flops_for``, and rank (0, 0)'s bytes of parameters
and optimizer state equal to its shards under the reference's
``state_spec``.  One four-rank gloo world (``torch_dryrun_cases``;
deadline 300 s, process groups 60 s) counts a train cell on real tensors
(FLOPs and collective bytes equal to the fake world's, exactly) and runs
the graph dry run's PageRank bodies on a graph of 4096 vertices: within
1e-5 of the reference's compiled lowerings run on its ``(2, 2)``
virtual mesh.  The graph dry run at the paper's scale reproduces the
predicted bytes a rank.
"""
import json
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dryrun_cases as C  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import list_archs as jlist_archs  # noqa: E402
from repro_torch.configs.base import SHAPES, list_archs  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import graph_dryrun as GD  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.utils import roofline as RL  # noqa: E402
from repro_torch.utils import sharding as SH  # noqa: E402

WORLD_DEADLINE_S = 300.0
PR_ATOL = 1e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
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


# ------------------------------------------------ tests/test_roofline.py

def test_ring():
    assert RL.ring(1) == 0.0
    assert RL.ring(2) == 0.5
    assert RL.ring(16) == pytest.approx(15 / 16)


def test_roofline_analyze_dominant_term():
    rep = RL.analyze("t", {"flops": 1e12, "bytes accessed": 1e9}, None,
                     chips=4, model_flops_global=2e12)
    assert rep.compute_s == pytest.approx(1e12 / RL.PEAK_FLOPS_BF16)
    assert rep.memory_s == pytest.approx(1e9 / RL.HBM_BW)
    assert rep.dominant == "compute"
    assert rep.useful_ratio == pytest.approx(0.5)
    assert RL.PEAK_FLOPS_BF16 == 989e12 and RL.HBM_BW == 3.35e12


def test_links_follow_nodes_of_eight():
    """A group inside one node of 8 ranks takes NVLink, any other
    InfiniBand: on 16 x 16 both axes (16 ranks) take InfiniBand."""
    assert RL.link_bw(range(8)) == RL.NVLINK_BW == 450e9
    assert RL.link_bw(range(8, 16)) == RL.NVLINK_BW
    assert RL.link_bw(range(16)) == RL.IB_BW == 50e9
    assert RL.link_bw(range(0, 256, 16)) == RL.IB_BW


def test_collective_counter_ring_factors():
    """All-reduce 2(n-1)/n, all-gather (n-1)/n of its result, a permute
    1, each over its own group's size (the HLO parser's test, on the
    port's collectives in a fake world of 8)."""
    with D.fake_world(8):
        mesh = M.make_mesh((2, 4), device_type="cpu", backend="fake")
        with RL.CollectiveCounter() as c:
            SH.all_reduce(torch.zeros(1024, device="meta"),
                          mesh.get_group("model"))
            SH.gather(torch.zeros(32, 64, dtype=torch.bfloat16,
                                  device="meta"), SH.P("data"), mesh)
            RL.count_collective("collective-permute", 1024,
                                mesh.get_group("model"))
    st = c.stats
    assert st.counts == {"all-reduce": 1, "all-gather": 1,
                         "collective-permute": 1}
    assert st.raw_bytes["all-reduce"] == 4096
    assert st.link_bytes["all-reduce"] == pytest.approx(4096 * 1.5)
    assert st.raw_bytes["all-gather"] == 64 * 64 * 2
    assert st.link_bytes["all-gather"] == pytest.approx(64 * 64 * 2 * 0.5)
    assert st.link_bytes["collective-permute"] == 1024
    # every group of a world of 8 lies in one node: NVLink
    assert st.seconds == pytest.approx(sum(st.link_bytes.values())
                                       / RL.NVLINK_BW)


def test_sharded_matmul_counts_per_rank():
    """A [M, K] x [K, N] product with K split over 4 ranks, its partial
    sums reduce-scattered to each rank's rows: ``2 M N K / 4`` FLOPs a
    rank and the shard's bytes times ``ring(4)``."""
    m, k, n = 256, 512, 128
    with D.fake_world(4):
        mesh = M.make_mesh((1, 4), device_type="cpu", backend="fake")
        a = torch.zeros(m, k // 4, device="meta")
        b = torch.zeros(k // 4, n, device="meta")

        def run():
            SH.reduce_to(a @ b, SH.P("model", None), mesh, ("model",))
        got = D.measure(D.Program(run, {"inputs": [a, b]}))
    assert got["flops"] == 2 * m * n * k / 4
    shard = m // 4 * n * 4
    assert got["coll"].raw_bytes == {"reduce-scatter": shard}
    assert got["coll"].link_bytes["reduce-scatter"] == shard * RL.ring(4)


# -------------------------------------------------- the cells, reduced

@pytest.fixture(scope="module")
def cells_2x2():
    """Every (arch x shape) lowered (not run) on a fake (2, 2) world at
    reduced configs: ``{arch: {shape: (meta, state bytes) or "skip"}}``."""
    out = {}
    with D.fake_world(4):
        mesh = M.make_mesh((2, 2), device_type="cpu", backend="fake")
        for arch in list_archs():
            out[arch] = {}
            for name in SHAPES:
                try:
                    program, meta = D.lower_cell(arch, name, mesh,
                                                 reduced=True)
                except D.SkipCell:
                    out[arch][name] = "skip"
                    continue
                nbytes = {cat: sum(t.untyped_storage().nbytes()
                                   for t in ts)
                          for cat, ts in program.state.items()}
                out[arch][name] = (meta, nbytes)
    return out


def test_archs_and_shapes_are_the_references():
    assert list_archs() == jlist_archs()
    assert {k: tuple(v.__dict__.values()) for k, v in SHAPES.items()} == \
        {k: tuple(v.__dict__.values()) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", list_archs())
def test_cells_skip_where_the_reference_skips(world, cells_2x2, arch):
    _, (_, want) = world
    for name in SHAPES:
        runs = want["cells"][arch]["runs"][name]
        assert (cells_2x2[arch][name] != "skip") == runs, name


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_match_the_reference(world, cells_2x2, arch):
    _, (_, want) = world
    for name in SHAPES:
        if cells_2x2[arch][name] == "skip":
            continue
        meta, _ = cells_2x2[arch][name]
        assert meta["model_flops"] == \
            want["cells"][arch]["model_flops"][name], name


@pytest.mark.parametrize("arch", list_archs())
def test_state_bytes_are_the_references_shards(world, cells_2x2, arch):
    """Rank (0, 0)'s blocks of the train state: its parameters and its
    optimizer state (moments, master, step) byte for byte the size of
    the reference's shards under ``state_spec`` on (2, 2)."""
    _, (_, want) = world
    _, nbytes = cells_2x2[arch]["train_4k"]
    assert nbytes["params"] == want["cells"][arch]["params_bytes"]
    assert nbytes["opt"] == want["cells"][arch]["opt_bytes"]


# ---------------------------------------------------- the gloo world

def test_gloo_world_counts_equal_the_fake_worlds(world):
    """One reduced train cell counted on real tensors by each rank of a
    gloo world: the FLOPs and collective bytes (raw, ring-weighted and
    calls, by kind) of rank 0 of the fake world, exactly."""
    ranks, _ = world
    fake = C.fake_counts()
    assert fake["flops"] > 0 and fake["coll_counts"]
    for _, meta in ranks:
        assert meta["cell"] == fake


@pytest.mark.parametrize("variant", C.VARIANTS)
def test_graph_bodies_match_the_reference(world, variant):
    """The graph dry run's PageRank bodies, run for real on the gloo
    world: the reference's compiled lowerings on the same graph."""
    ranks, (want, _) = world
    for arrays, _ in ranks:
        np.testing.assert_allclose(arrays[f"pagerank/{variant}"],
                                   want[f"pagerank/{variant}"], rtol=0,
                                   atol=PR_ATOL)


@pytest.mark.parametrize("variant", C.VARIANTS)
def test_graph_lowerings_keep_the_references_terms(world, variant):
    """``e_shard``, ``v_local``, chips and the analytic FLOPs, bytes and
    collective bytes a superstep: the reference's at the same sizes."""
    _, (_, want) = world
    lower = dict(GD.VARIANTS)[variant]
    n_edges = C.layouts()[variant][0]
    with D.fake_world(4):
        mesh = M.make_mesh(C.MESH, device_type="cpu", backend="fake")
        _, meta = lower(mesh, C.V, n_edges, n_iters=C.ITERS)
    assert meta == want[variant]


# --------------------------------------------------- host reads, scale

def test_a_host_read_is_a_cell_error(monkeypatch, tmp_path):
    """A path that reads a tensor's value on the host cannot run on meta
    tensors: ``measure`` raises ``HostRead`` and ``run_cell`` records
    the cell as ``error`` with the reason, never ``ok``."""
    def reads_the_host():
        return int(torch.zeros(4, device="meta").sum().item())
    with pytest.raises(D.HostRead):
        D.measure(D.Program(reads_the_host, {}))

    def lower(*a, **kw):
        return D.Program(reads_the_host, {}), {
            "arch": "x", "shape": "y", "mesh": "16x16", "chips": 256,
            "model_flops": 0.0, "kind": "train"}
    monkeypatch.setattr(D, "lower_cell", lower)
    rec = D.run_cell("gemma2-2b", "train_4k", "single", str(tmp_path),
                     force=True)
    assert rec["status"] == "error" and "HostRead" in rec["error"]


def test_graph_dryrun_at_paper_scale(tmp_path):
    """The 30.86 G-edge graph on 256 ranks: 120.5 M edges a rank (1.45 GB
    at 12 bytes an edge); the 1-D baseline holds the whole float32 ``x``
    (8.0 GB) beside them, the grid V / 16 of it (0.5 GB)."""
    res = GD.main(["--mesh", "single", "--out", str(tmp_path / "g.json")])
    base = res["multi_account_30.9B/baseline_1d"]
    grid = res["multi_account_30.9B/grid_2d"]
    V = GD.WORKLOADS["multi_account_30.9B"]["n_vertices"]
    assert V == 2_005_098_124
    assert base["e_shard"] == grid["e_shard"] == 120_547_328
    assert base["edges_gb"] == pytest.approx(1.4466, abs=1e-3)
    assert base["mem_per_dev_gb"] >= V * 4 / 1e9 + base["edges_gb"]
    assert grid["mem_per_dev_gb"] < base["mem_per_dev_gb"] - 7.5
    assert grid["v_local"] * 4 / 1e9 == pytest.approx(0.5013, abs=1e-3)
    for rec in res.values():
        assert rec["dominant"] == "collective_s"
