"""The analytics service's queues on a device mesh, on the CPU.

One four-rank gloo world (``torch_service_mesh_cases.rank_main``, each
rank a fresh interpreter with one thread) submits fused BFS, SSSP, CC
and PageRank tickets to a service whose graphs hold a ``(2, 2)`` or a
``(4, 1)`` mesh and drains them with one worker.  Rank 1 carries a
planted divergence (another interactive threshold; its queues reversed).
The world has a deadline of 300 s and every process group a timeout of
60 s.

Tolerance: exact answers (BFS, SSSP, CC) byte-equal to the meshless
``LocalEngine``'s; PageRank within 1e-6 (``tests/test_torch_mesh.py``'s).
Every rank runs the same units in the same order (execution logs equal).
A meshless service schedules as the reference's service does: the same
execution log and counters, the same answers.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_service_mesh_cases as C  # noqa: E402
from torch_mesh_cases import graphs  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core.query import GraphQuery as JQuery  # noqa: E402
from repro.core.service import GraphAnalyticsService as JService  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core.engines import LocalEngine  # noqa: E402
from repro_torch.core.service import GraphAnalyticsService  # noqa: E402

WORLD_DEADLINE_S = 300.0
PR_ATOL = 1e-6
COUNTERS = ("submitted", "rejected", "executed", "failed", "fused_batches",
            "fused_tickets", "spilled")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("service_mesh")
    ranks = C.run_world(str(out), timeout_s=WORLD_DEADLINE_S)
    for r, (rc, o) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}:\n{o[-4000:]}"
    got = []
    for r in range(C.WORLD):
        with np.load(out / f"rank{r}.npz") as z:
            arrays = dict(z)
        got.append((arrays, json.loads((out / f"rank{r}.json").read_text())))
    return got


@pytest.fixture(scope="module")
def local_answers():
    """Each ticket's query on the port's meshless ``LocalEngine``."""
    gs = C.graphs(TG, device="cpu")
    out = {}
    for i, (name, q) in enumerate(C.tickets()):
        r = LocalEngine(gs[name], device="cpu").run(q.algorithm, q.params)
        for k, v in C.value_arrays(r.value).items():
            out[f"{i}/{k}"] = v
    return out


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _check_answers(arrays, prefix, want):
    for k, w in want.items():
        got = arrays[prefix + k]
        i = int(k.split("/")[0])
        if C.tickets()[i][1].algorithm == "pagerank":
            np.testing.assert_allclose(got, w, rtol=0, atol=PR_ATOL,
                                       err_msg=k)
        else:
            assert _bits(got.astype(w.dtype)) == _bits(w), k


@pytest.mark.parametrize("layout", list(C.LAYOUTS))
@pytest.mark.parametrize("run", ["threshold", "reversed"])
def test_mesh_service_answers_as_the_local_engine(world, local_answers,
                                                  layout, run):
    """``submit`` + ``drain(workers=1)`` on the mesh: every rank's
    answers equal ``LocalEngine``'s, with rank 1's planted divergence."""
    prefix = f"{layout}/" if run == "threshold" else f"{layout}/reversed/"
    for arrays, _ in world:
        _check_answers(arrays, prefix, local_answers)


@pytest.mark.parametrize("layout", list(C.LAYOUTS))
@pytest.mark.parametrize("run", ["threshold", "reversed"])
def test_every_rank_runs_rank_00s_schedule(world, layout, run):
    """The same units in the same order on every rank: rank (0, 0)'s
    (the batch tier, BFS and SSSP each one fused unit), though rank 1
    alone would have scheduled otherwise."""
    key = f"{layout}/log" if run == "threshold" else f"{layout}/reversed/log"
    logs = [meta[key] for _, meta in world]
    assert all(log == logs[0] for log in logs)
    assert {e["tier"] for e in logs[0]} == {"batch"}
    assert [e["tickets"] for e in logs[0] if e["fused"]] == \
        [[0, 1, 2, 3], [4, 5, 6, 7]]
    counters = [meta[f"{layout}/counters"] for _, meta in world]
    assert all(c == counters[0] for c in counters)


def test_the_divergence_alone_orders_units_otherwise():
    """What the planted divergences would do on a service of their own:
    rank 1's threshold serves every ticket interactive and unfused, and
    its reversed queue dequeues PageRank first; the agreed schedule
    above differs from both."""
    gs = C.graphs(TG, device="cpu")
    alone = GraphAnalyticsService(
        interactive_threshold_s=C.DIVERGENT_THRESHOLD_S)
    _, log = C.serve(alone, gs)
    assert {e["tier"] for e in log} == {"interactive"}
    assert not any(e["fused"] for e in log)
    rev = GraphAnalyticsService(interactive_threshold_s=C.THRESHOLD_S)
    _, log = C.serve(rev, gs, before_drain=C.reverse_queues)
    assert log[0]["tickets"] == [len(C.tickets()) - 1]


@pytest.mark.parametrize("layout", list(C.LAYOUTS))
@pytest.mark.parametrize("what", ["drain", "built"])
def test_worker_threads_on_a_mesh_service_raise(world, layout, what):
    """``drain(workers=2)`` on a mesh service, and a ``workers=2``
    service given a mesh context, raise ``ValueError`` naming the
    reason; nothing falls back to one worker."""
    for _, meta in world:
        msg = meta[f"{layout}/refuse/{what}"]
        assert msg and "rank to rank" in msg


def test_meshless_service_schedules_as_the_reference():
    """A meshless service: the reference's execution log, counters and
    answers on the same tickets."""
    tgs = C.graphs(TG, device="cpu")
    jgs = graphs(JG)
    mine, mlog = C.serve(
        GraphAnalyticsService(interactive_threshold_s=C.THRESHOLD_S), tgs)
    ref = JService(interactive_threshold_s=C.THRESHOLD_S)
    for name, g in jgs.items():
        ref.add_graph(name, g)
    ts = [ref.submit(name, JQuery.of(q.algorithm, **q.params))
          for name, q in C.tickets()]
    ref.drain(workers=1)
    assert mlog == [dict(e) for e in ref.execution_log]
    port_svc = GraphAnalyticsService(interactive_threshold_s=C.THRESHOLD_S)
    C.serve(port_svc, tgs)
    for k in COUNTERS:
        assert port_svc.metrics()["counters"][k] == \
            ref.metrics()["counters"][k], k
    want = {}
    for i, t in enumerate(ts):
        for k, v in C.value_arrays(ref.result(t).value).items():
            want[f"{i}/{k}"] = v
    _check_answers({k: v for k, v in mine.items()}, "", want)
