"""Worlds for ``tests/test_torch_service_mesh.py`` (no ``test_`` prefix: not
collected): the analytics service's queues on a device mesh.

``rank_main`` is one rank of a four-rank gloo world on the CPU.  On a
``(2, 2)`` mesh (the 2-D layout) and a ``(4, 1)`` one (the 1-D layout)
it submits fused BFS, SSSP, CC and PageRank tickets to a
``GraphAnalyticsService`` whose graphs hold the mesh (the distributed
engine forced), drains them with one worker, and writes each ticket's
answer and the service's execution log to ``rank{r}.npz`` / ``.json``.
Rank 1 runs with two planted divergences: another interactive
threshold (alone it would serve every ticket interactive, one at a
time), and, in a second service, its queues reversed before the drain
(alone it would dequeue PageRank first).  It also records the refusals
of worker threads on a mesh.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

from torch_mesh_cases import PR_ITERS, PR_TOL, ROOT, graphs

WORLD = 4
TIMEOUT_S = 60.0
LAYOUTS = {"2x2": ((2, 2), 2, 2), "4x1": ((4, 1), 4, 1)}
THRESHOLD_S = 0.0                # every ticket in the batch tier: fusion
DIVERGENT_RANK = 1
DIVERGENT_THRESHOLD_S = 1e9      # every ticket interactive


def tickets():
    """``(graph, GraphQuery)`` in submission order."""
    from repro_torch.core.query import GraphQuery
    out = [("g300s", GraphQuery.bfs([s])) for s in (0, 5, 17, 299)]
    out += [("g300w", GraphQuery.sssp(s)) for s in (0, 5, 17, 299)]
    out += [("g300s", GraphQuery.of("connected_components")),
            ("g800s", GraphQuery.of("connected_components"))]
    out += [("g800", GraphQuery.of("pagerank", max_iters=PR_ITERS,
                                   tol=PR_TOL))]
    return out


def value_arrays(value) -> dict:
    if isinstance(value, dict):
        return {k: _np(v) for k, v in value.items()}
    return {"value": _np(value)}


def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def reverse_queues(svc) -> None:
    """Every queue of ``svc`` in reverse order (the planted divergence of
    a rank whose own schedule differs)."""
    for q in svc._queues.values():
        q.reverse()


def serve(svc, gs, before_drain=None, **add_kw) -> tuple:
    """Submit every ticket, drain with one worker: ``(answers, log)``."""
    for name, g in gs.items():
        svc.add_graph(name, g, device="cpu", **add_kw)
    ts = [svc.submit(name, q) for name, q in tickets()]
    if before_drain is not None:
        before_drain(svc)
    svc.drain(workers=1)
    answers = {}
    for i, t in enumerate(ts):
        for k, v in value_arrays(svc.result(t).value).items():
            answers[f"{i}/{k}"] = v
    return answers, [dict(e) for e in svc.execution_log]


def rank_main(rank: int, world: int, init_method: str, outdir: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.core import graph as G
    from repro_torch.core.service import GraphAnalyticsService
    from repro_torch.launch import mesh as M
    meshes = {}
    for i, (tag, (shape, _, _)) in enumerate(LAYOUTS.items()):
        kw = dict(init_method=init_method, world_size=world, rank=rank) \
            if i == 0 else {}
        meshes[tag] = M.make_mesh(shape, device_type="cpu",
                                  timeout_s=TIMEOUT_S, **kw)
    gs = graphs(G, device="cpu")
    out, meta = {}, {"rank": rank}
    t0 = time.perf_counter()
    for tag, (_, nd, nm) in LAYOUTS.items():
        threshold = (DIVERGENT_THRESHOLD_S if rank == DIVERGENT_RANK
                     else THRESHOLD_S)
        svc = GraphAnalyticsService(interactive_threshold_s=threshold)
        answers, log = serve(svc, gs, mesh=meshes[tag], n_data=nd,
                             n_model=nm, force_engine="distributed")
        out.update({f"{tag}/{k}": v for k, v in answers.items()})
        meta[f"{tag}/log"] = log
        meta[f"{tag}/counters"] = svc.metrics()["counters"]
        meta[f"{tag}/tiers"] = sorted({e["tier"] for e in log})
        svc = GraphAnalyticsService(interactive_threshold_s=THRESHOLD_S)
        answers, log = serve(
            svc, gs, before_drain=reverse_queues
            if rank == DIVERGENT_RANK else None, mesh=meshes[tag],
            n_data=nd, n_model=nm, force_engine="distributed")
        out.update({f"{tag}/reversed/{k}": v for k, v in answers.items()})
        meta[f"{tag}/reversed/log"] = log
        # threads on the mesh service, and a service built with them
        for what, call in (
                ("drain", lambda: svc.drain(workers=2)),
                ("built", lambda: GraphAnalyticsService(workers=2).add_graph(
                    "g", gs["g300s"], mesh=meshes[tag], device="cpu"))):
            try:
                call()
                meta[f"{tag}/refuse/{what}"] = None
            except ValueError as e:
                meta[f"{tag}/refuse/{what}"] = str(e)
        meta[f"seconds/{tag}"] = time.perf_counter() - t0
    dist.barrier()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


def run_world(outdir: str, timeout_s: float = 300.0) -> list:
    """Start ``WORLD`` ranks of ``rank_main`` in fresh interpreters,
    rendezvous through a file under ``outdir``; returns each rank's
    ``(returncode, output)``.  Every rank still running at the deadline
    is killed."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    init = "file://" + os.path.join(outdir, "rendezvous")
    procs = []
    for r in range(WORLD):
        code = (f"import torch_service_mesh_cases as c; "
                f"c.rank_main({r}, {WORLD}, {init!r}, {outdir!r})")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout_s
    got = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            o, _ = p.communicate()
            o = (o or "") + "\n[killed at the world's deadline]"
        got.append((p.returncode, o))
    return got
