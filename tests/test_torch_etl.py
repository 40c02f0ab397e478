"""The port's ETL pipeline and graph CLI: mirrors of ``tests/test_etl.py``
on CPU tensors (``tests/test_torch_etl_properties.py`` mirrors the
hypothesis properties), stores shared with the JAX reference, and
``launch/run_graph.py`` as a subprocess.

A snapshot store written by either package is read by the other, with
equal manifests and equal content hashes; the ETL's graphs are byte-equal
to the reference's.  Tolerance: none (ids, counts, hashes, bytes).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import graph as JG  # noqa: E402
from repro.data import etl as jetl  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.data import etl  # noqa: E402
from repro_torch.data import synthetic as S  # noqa: E402
from repro_torch.data.etl import (GraphETL, ResultSink, Snapshot,  # noqa: E402
                                  SnapshotDelta, SnapshotStore,
                                  max_adjacent_nodes_sweep)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


# ------------------------------------------ mirrors of tests/test_etl.py

def test_build_coo_sorted_dedup():
    src = np.array([3, 1, 1, 2, 3], dtype=np.int64)
    dst = np.array([0, 2, 2, 1, 0], dtype=np.int64)
    g = G.build_coo(src, dst, 4, device=CPU)
    assert g.n_edges == 3                      # dedup'd
    d = g.dst[:g.n_edges].numpy()
    assert (np.diff(d) >= 0).all()             # dst-sorted


def test_build_ell_cap_and_loss():
    # vertex 0 has 5 in-edges; cap 3 drops 2
    src = np.array([1, 2, 3, 4, 5, 1])
    dst = np.array([0, 0, 0, 0, 0, 2])
    ell = G.build_ell(src, dst, 6, max_degree=3, device=CPU)
    assert ell.n_edges == 4
    assert ell.n_edges_total == 6
    assert ell.lost_fraction == pytest.approx(2 / 6)


def test_csr_neighbors():
    src = np.array([0, 0, 1, 2])
    dst = np.array([1, 2, 2, 0])
    csr = G.build_csr(src, dst, 3, device=CPU)
    ip = csr.indptr.numpy()
    idx = csr.indices.numpy()
    assert set(idx[ip[0]:ip[1]].tolist()) == {1, 2}
    assert set(idx[ip[1]:ip[2]].tolist()) == {2}


def test_table1_sweep_monotonic():
    """Table I reproduction: loss % decreases as the cap rises, reaching
    exactly 0 at cap >= max degree."""
    u, i = S.safety_bipartite_graph(2000, 500, seed=4)
    caps = [1, 4, 16, 64, 256, 100000]
    rows = max_adjacent_nodes_sweep(u, i, 500, caps, device=CPU)
    losses = [r["lost_percentage"] for r in rows]
    assert all(a >= b for a, b in zip(losses, losses[1:]))
    assert losses[-1] == 0.0
    assert losses[0] > 10.0                    # tight cap loses real data
    assert rows == jetl.max_adjacent_nodes_sweep(u, i, 500, caps)


def test_snapshot_store_and_etl(tmp_path):
    store = SnapshotStore(str(tmp_path / "snaps"))
    rng = np.random.default_rng(0)
    for day in ["d0", "d1"]:
        store.write(Snapshot(day, rng.integers(0, 100, 500),
                             rng.integers(0, 100, 500)))
    assert store.list() == ["d0", "d1"]
    pipe = GraphETL(max_adjacent_nodes=16, device=CPU)
    snaps = [store.read(n) for n in store.list()]
    coo, ell, report = pipe.build(snaps, n_vertices=100)
    assert report.n_edges_in == 1000
    assert report.n_edges_deduped <= 1000
    assert coo.n_vertices == 100 and coo.device.type == "cpu"
    assert ell is not None and ell.max_degree == 16
    assert 0.0 <= report.lost_fraction < 1.0
    assert len(report.content_hash) == 16


def test_result_sink_roundtrip(tmp_path):
    sink = ResultSink(str(tmp_path / "out"))
    sink.write("cc_labels", {"labels": np.arange(10)}, {"algo": "cc"})
    arrays, manifest = sink.read("cc_labels")
    np.testing.assert_array_equal(arrays["labels"], np.arange(10))
    assert manifest["meta"]["algo"] == "cc"


def test_degree_stats():
    from repro_torch.core.algorithms.degrees import degree_stats
    src, dst = S.user_follow_graph(500, 4.0, seed=1)
    g = G.build_coo(src, dst, 500, device=CPU)
    stats = degree_stats(g)
    assert stats["n_vertices"] == 500
    assert stats["max_in_degree"] >= stats["mean_degree"]


def test_similarity():
    from repro_torch.core.algorithms.similarity import (common_neighbors,
                                                        jaccard_similarity)
    # triangle 0-1-2 plus pendant 3: N(0)={1,2}, N(1)={0,2}, N(2)={0,1,3}
    src = np.array([0, 0, 1, 1, 2, 2, 2, 3])
    dst = np.array([1, 2, 0, 2, 0, 1, 3, 2])
    ell = G.build_ell(src, dst, 4, max_degree=4, direction="out",
                      device=CPU)
    u, v = torch.tensor([0]), torch.tensor([1])
    assert int(common_neighbors(ell, u, v)[0]) == 1     # {2}
    jac = float(jaccard_similarity(ell, u, v)[0])
    assert jac == pytest.approx(1 / 3)                   # |{2}| / |{0,1,2}|


def test_local_engine_kernel_path():
    """LocalEngine with use_kernels=True routes the superstep and SpMV
    through the kernels' wrappers (their plain versions on the CPU) and
    matches use_kernels=False."""
    from repro_torch.core.engines import LocalEngine
    src, dst = S.user_follow_graph(300, 4.0, seed=8)
    g = G.build_coo(src, dst, 300, symmetrize=True, device=CPU)
    a = LocalEngine(g, use_kernels=False, device=CPU).connected_components()
    b = LocalEngine(g, use_kernels=True, device=CPU).connected_components()
    assert a.value.numpy().tobytes() == b.value.numpy().tobytes()


# --------------------------------------------- stores shared by both

def _fill(store_cls, snap_cls, delta_cls, root):
    store = store_cls(str(root))
    rng = np.random.default_rng(7)
    store.write(snap_cls("d0", rng.integers(0, 80, 400),
                         rng.integers(0, 80, 400)))
    store.write(snap_cls("d1", rng.integers(0, 80, 300),
                         rng.integers(0, 80, 300)))
    base = store.read("d1")
    store.write_delta(delta_cls(
        "d2", "d1", rng.integers(0, 90, 50), rng.integers(0, 90, 50),
        base.src[:20], base.dst[:20]))
    store.write_delta(delta_cls(
        "d3", "d2", rng.integers(0, 90, 10), rng.integers(0, 90, 10),
        np.zeros(0, np.int64), np.zeros(0, np.int64)))
    return store


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_written_by_one_package_is_read_by_the_other(tmp_path,
                                                          writer):
    if writer == "reference":
        _fill(jetl.SnapshotStore, jetl.Snapshot, jetl.SnapshotDelta,
              tmp_path)
    else:
        _fill(SnapshotStore, Snapshot, SnapshotDelta, tmp_path)
    port, ref = SnapshotStore(str(tmp_path)), jetl.SnapshotStore(
        str(tmp_path))
    assert port.list() == ref.list() == ["d0", "d1"]
    assert port.list_deltas() == ref.list_deltas() == ["d2", "d3"]
    for name in ("d0", "d1", "d2", "d3"):
        assert port.manifest(name) == ref.manifest(name)
        a, b = port.resolve(name), ref.resolve(name)
        assert a.src.tobytes() == b.src.tobytes()
        assert a.dst.tobytes() == b.dst.tobytes()
    snaps = [port.resolve("d0"), port.resolve("d3")]
    coo, ell, rep = GraphETL(max_adjacent_nodes=8, symmetrize=True,
                             device=CPU).build(snaps, n_vertices=90)
    jcoo, jell, jrep = jetl.GraphETL(max_adjacent_nodes=8,
                                     symmetrize=True).build(snaps,
                                                            n_vertices=90)
    assert rep.content_hash == jrep.content_hash
    assert (rep.n_edges_in, rep.n_edges_deduped, rep.n_edges_after_cap,
            rep.lost_fraction) == (jrep.n_edges_in, jrep.n_edges_deduped,
                                   jrep.n_edges_after_cap,
                                   jrep.lost_fraction)
    assert coo.content_digest() == jcoo.content_digest()
    assert ell.nbr.numpy().tobytes() == np.asarray(jell.nbr).tobytes()


def test_hash_arrays_is_the_reference_hash():
    rng = np.random.default_rng(1)
    for arrays in ((rng.integers(0, 9, 10),),
                   (rng.integers(0, 9, 10), rng.random(4).astype(np.float32)),
                   (np.zeros(0, np.int64),)):
        assert etl._hash_arrays(*arrays) == jetl._hash_arrays(*arrays)


def test_delta_chain_errors(tmp_path):
    store = SnapshotStore(str(tmp_path))
    e = np.zeros(0, np.int64)
    store.write_delta(SnapshotDelta("a", "b", e, e, e, e))
    store.write_delta(SnapshotDelta("b", "a", e, e, e, e))
    with pytest.raises(KeyError, match="cycle"):
        store.manifest("a")
    with pytest.raises(KeyError, match="not in store"):
        store.read("zzz")
    with pytest.raises(KeyError, match="delta partition"):
        store.manifest("missing")


def test_result_sink_takes_tensors_and_matches_the_reference(tmp_path):
    labels = torch.arange(12, dtype=torch.int32)
    path = ResultSink(str(tmp_path / "port")).write(
        "cc", {"labels": labels}, {"algo": "cc", "iters": 3})
    jetl.ResultSink(str(tmp_path / "ref")).write(
        "cc", {"labels": labels.numpy()}, {"algo": "cc", "iters": 3})
    got, man = jetl.ResultSink(str(tmp_path / "port")).read("cc")
    want, jman = ResultSink(str(tmp_path / "ref")).read("cc")
    assert got["labels"].tobytes() == want["labels"].tobytes()
    assert {k: v for k, v in man.items() if k != "time"} == \
        {k: v for k, v in jman.items() if k != "time"}
    assert os.path.exists(path)


# -------------------------------------------------------- the graph CLI

def _run_graph(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.run_graph", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_run_graph_cli_on_the_cpu():
    out = _run_graph("--job", "two-hop", "--vertices", "800",
                     "--device", "cpu")
    assert out.returncode == 0, out.stderr
    plan, done = out.stdout.strip().splitlines()[-2:]
    assert plan.startswith("[plan] engine=")
    assert done.startswith("[done]") and "device=cpu" in done
    from repro.launch import run_graph as jrun  # noqa: F401 (same CLI)
    from repro.core.query import GraphPlatform as JPlatform
    from repro.core.query import GraphQuery as JQuery
    u, i = S.safety_bipartite_graph(800, 200, seed=0)
    jcoo = JG.build_coo(u, i, int(max(u.max(), i.max())) + 1)
    want = JPlatform(jcoo).query(JQuery.two_hop(n_users=800)).value[2]
    assert done.endswith(f", {want})")


@pytest.mark.parametrize("job", ["cc", "pagerank", "stats"])
def test_run_graph_cli_jobs(job):
    from repro_torch.launch import run_graph
    r = run_graph.main(["--job", job, "--vertices", "500", "--device", "cpu",
                        "--count-only"])
    assert r.engine in ("local", "distributed")


def test_run_graph_refuses_the_distributed_engine():
    """``--engine distributed`` once raised here, where the reference's
    CLI runs it (ROADMAP §3, a fault of the port): it now runs the
    meshless distributed engine over ``--n-data`` shards."""
    from repro_torch.launch import run_graph
    r = run_graph.main(["--engine", "distributed", "--n-data", "3",
                        "--vertices", "500", "--device", "cpu"])
    assert r.engine == "distributed" and r.meta["plan"].engine == \
        "distributed"


def test_manifest_json_written_by_the_port_is_plain_json(tmp_path):
    ResultSink(str(tmp_path)).write("x", {"a": np.ones(3)}, {"k": 1})
    with open(tmp_path / "x.manifest.json") as f:
        man = json.load(f)
    assert man["arrays"] == {"a": [3]} and man["meta"] == {"k": "1"}
