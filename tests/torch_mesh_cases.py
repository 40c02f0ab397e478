"""Worlds for ``tests/test_torch_mesh.py`` (no ``test_`` prefix: not
collected).

``rank_main`` is one rank of a four-rank gloo world on the CPU: it runs
every mesh case of the port on a ``(2, 2)`` mesh, in the 1-D layout
``(2, 1)`` and the 2-D layout ``(2, 2)``, and writes what it got to
``rank{r}.npz``.  ``reference_main`` runs the same algorithms through the
JAX package on a 4-device virtual mesh of the same shape and writes
``reference.npz``; it must start in a fresh interpreter, with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set before JAX
starts.  ``run_world`` starts the ranks, each in a fresh interpreter,
and waits for them under one deadline.

The inputs are the reference's own mesh tests' (``tests/test_pregel.py``,
``tests/test_algorithms.py``): ``user_follow_graph(800, 5.0, seed=3)``
for PageRank, CC and HITS, ``(300, 5.0, seed=3)`` without self-loops,
symmetrized, for BFS, LPA, triangles and k-core; SSSP on the same 300
edges with seeded weights, multiples of 1/4 in [1, 4].
"""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

MESH = (2, 2)
LAYOUTS = ((2, 1), (2, 2))
WORLD = 4
ALGORITHMS = ("cc", "pagerank", "bfs", "sssp", "lpa", "triangles", "kcore",
              "hits")
PR_ITERS, PR_TOL = 60, 1e-10          # tests/test_pregel.py's PageRank
HITS_ITERS, HITS_TOL = 50, 1e-6
KCORE_K = 3
BATCH_SOURCES = ((0,), (5, 17), (299,))
TIMEOUT_S = 60.0                      # every process group of the world
SKIP_TIMEOUT_S = 5.0                  # the mesh whose rank 1 skips
ROOT = Path(__file__).resolve().parents[1]


def edges():
    """``(src, dst)`` of both graphs and the SSSP weights (numpy)."""
    from repro_torch.data import synthetic as S
    s8, d8 = S.user_follow_graph(800, 5.0, seed=3)
    s3, d3 = S.user_follow_graph(300, 5.0, seed=3)
    keep = s3 != d3
    s3, d3 = s3[keep], d3[keep]
    w3 = (1.0 + np.random.default_rng(7).integers(0, 13, s3.size) / 4.0
          ).astype(np.float32)
    return (s8, d8), (s3, d3), w3


def graphs(G, **kw):
    """The four graphs in the package whose ``graph`` module is ``G``."""
    (s8, d8), (s3, d3), w3 = edges()
    return {"g800": G.build_coo(s8, d8, 800, **kw),
            "g800s": G.build_coo(s8, d8, 800, symmetrize=True, **kw),
            "g300s": G.build_coo(s3, d3, 300, symmetrize=True, **kw),
            "g300w": G.build_coo(s3, d3, 300, w=w3, symmetrize=True, **kw)}


def run_algorithm(pkg: str, name: str, gs: dict, **mesh_kw):
    """One algorithm through the functions of ``pkg`` (``repro`` or
    ``repro_torch``); ``mesh_kw`` is ``mesh``, ``n_data``, ``n_model``
    or nothing.  Returns ``(dict of numpy arrays, iterations)``."""
    alg = f"{pkg}.core.algorithms"
    m = lambda mod: importlib.import_module(f"{alg}.{mod}")  # noqa: E731
    nm = mesh_kw.get("n_model", 1)
    if name == "cc":
        out, it = m("connected_components").connected_components(
            gs["g800s"], accelerated=nm == 1, **mesh_kw)
    elif name == "pagerank":
        out, it = m("pagerank").pagerank(gs["g800"], max_iters=PR_ITERS,
                                         tol=PR_TOL, **mesh_kw)
    elif name == "bfs":
        out, it = m("traversal").bfs_distances(gs["g300s"], [0], **mesh_kw)
    elif name == "sssp":
        out, it = m("traversal").sssp(gs["g300w"], 0, **mesh_kw)
    elif name == "lpa":
        out, it = m("community").label_propagation(gs["g300s"], **mesh_kw)
    elif name == "triangles":
        count, per_vertex = m("triangles").triangle_count(gs["g300s"],
                                                          **mesh_kw)
        out, it = {"count": count, "per_vertex": per_vertex}, 2
    elif name == "kcore":
        out, it = m("triangles").k_core(gs["g300s"], KCORE_K, **mesh_kw)
    elif name == "hits":
        out, it = m("hits").hits(gs["g800"], max_iters=HITS_ITERS,
                                 tol=HITS_TOL, **mesh_kw)
    else:
        raise ValueError(name)
    if isinstance(out, dict):
        vals = {k: _np(v) for k, v in out.items()}
    else:
        vals = {"value": _np(out)}
    return vals, int(it)


def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


# ------------------------------------------------- the mesh body, alone

UNIT_V = 37                            # not a multiple of the model axis
UNIT_CASES = ("min", "max", "sum", "grouped", "global_value",
              "needs_dst_state", "halt_early")


def unit_graph(G, **kw):
    rng = np.random.default_rng(5)
    src = rng.integers(0, UNIT_V, 150)
    dst = rng.integers(0, UNIT_V, 150)
    w = (1.0 + rng.integers(0, 4, 150) / 4.0).astype(np.float32)
    return G.build_coo(src, dst, UNIT_V, w=w, **kw)


def unit_case(name: str):
    """``(spec, init state of length n, max_iters)`` for one unit case of
    the mesh body; the state's first ``V`` entries do not depend on the
    padded length ``n``."""
    import torch
    from repro_torch.core.pregel import PregelSpec, converged_halt
    big = np.iinfo(np.int32).max
    if name in ("min", "halt_early"):
        spec = PregelSpec(message=lambda x, w: x, combine="min",
                          apply=lambda old, agg, ids, g: torch.minimum(old,
                                                                       agg),
                          identity=big, halt=converged_halt)
        return spec, lambda n: torch.arange(n, dtype=torch.int32), \
            (3 if name == "min" else 100)
    if name == "max":
        spec = PregelSpec(message=lambda x, w: x, combine="max",
                          apply=lambda old, agg, ids, g: torch.maximum(old,
                                                                       agg),
                          identity=-big, halt=converged_halt)
        return spec, lambda n: torch.arange(n, dtype=torch.int32), 100
    if name == "sum":
        spec = PregelSpec(message=lambda x, w: x * w, combine="sum",
                          apply=lambda old, agg, ids, g: 0.5 * old + agg,
                          identity=0.0)
        return spec, lambda n: torch.arange(n) / 64.0, 4
    if name == "grouped":
        def message(x, w):
            return torch.stack([w, x.to(torch.float32), -x.to(torch.float32)],
                               dim=-1)

        def apply(old, agg, ids, g):
            return torch.where(agg[:, 0] > 2.0, agg[:, 1].to(torch.int32),
                               torch.minimum(old, (-agg[:, 2]).to(
                                   torch.int32)))
        spec = PregelSpec(message=message,
                          combine=(("sum", 1), ("min", 1), ("max", 1)),
                          apply=apply,
                          identity=(0.0, float("inf"), float("-inf")),
                          halt=converged_halt)
        return spec, lambda n: torch.arange(n, dtype=torch.int32), 20
    if name == "global_value":
        def gv(x, ids, valid):
            return torch.where(valid, x, 0.0).sum()
        spec = PregelSpec(message=lambda x, w: x * w, combine="sum",
                          apply=lambda old, agg, ids, g: agg / (1.0 + g),
                          identity=0.0, global_value=gv)
        return spec, lambda n: torch.ones(n), 5
    if name == "needs_dst_state":
        spec = PregelSpec(message=lambda s, w, d: s * d + w, combine="sum",
                          apply=lambda old, agg, ids, g: agg,
                          identity=0.0, needs_dst_state=True)
        return spec, lambda n: 1.0 + torch.arange(n) / 64.0, 1
    raise ValueError(name)


def run_unit(name, sg, n_state, mesh=None):
    from repro_torch.core.pregel import run_pregel
    spec, init, max_iters = unit_case(name)
    out, it = run_pregel(spec, sg, init(n_state), max_iters, mesh=mesh)
    return _np(out)[: sg.n_vertices], int(it)


# ------------------------------------------------------------- the ranks

def rank_main(rank: int, world: int, init_method: str, outdir: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.core import graph as G
    from repro_torch.core.engines import DistributedEngine
    from repro_torch.core.partition import partition
    from repro_torch.core.query import GraphPlatform, GraphQuery
    from repro_torch.launch import mesh as M
    out, meta = {}, {"rank": rank}
    mesh = M.make_mesh(MESH, device_type="cpu", init_method=init_method,
                       world_size=world, rank=rank, timeout_s=TIMEOUT_S)
    meta["coordinate"] = list(mesh.get_coordinate())
    gs = graphs(G, device="cpu")
    ug = unit_graph(G, device="cpu")
    for nd, nm in LAYOUTS:
        tag = f"{nd}x{nm}"
        for name in ALGORITHMS:
            vals, it = run_algorithm("repro_torch", name, gs, mesh=mesh,
                                     n_data=nd, n_model=nm)
            for k, v in vals.items():
                out[f"{name}/{tag}/{k}"] = v
            meta[f"{name}/{tag}/iters"] = it
        sg = partition(ug, nd, nm)
        for name in UNIT_CASES:
            v, it = run_unit(name, sg, sg.n_pad, mesh=mesh)
            out[f"unit/{name}/{tag}"] = v
            meta[f"unit/{name}/{tag}/iters"] = it
        # the engine and the platform on the mesh
        eng = DistributedEngine(gs["g300s"], mesh=mesh, n_model=nm)
        meta[f"engine/{tag}/shards"] = [eng.n_data, eng.n_model,
                                        list(eng.sharded.coord)]
        for name, q in (("bfs", ("bfs", {"sources": (0,)})),
                        ("kcore", ("k_core", {"k": KCORE_K}))):
            r = eng.run(*q)
            out[f"engine/{name}/{tag}"] = _np(r.value)
            meta[f"engine/{name}/{tag}/iters"] = r.iterations
        # a fused batch ([V, B] state, gathered a column at a time)
        for i, r in enumerate(eng.run_batch(
                "bfs", [{"sources": s} for s in BATCH_SOURCES])):
            out[f"engine/batch{i}/{tag}"] = _np(r.value)
        # PageRank warm-started from a converged answer (2-D: padded)
        eng = DistributedEngine(gs["g800"], mesh=mesh, n_model=nm)
        params = {"max_iters": PR_ITERS, "tol": 1e-7}
        cold = eng.run("pagerank", params)
        warm = eng.run("pagerank", params, seed=cold)
        out[f"engine/pagerank_warm/{tag}"] = _np(warm.value)
        meta[f"engine/pagerank_warm/{tag}/iters"] = [cold.iterations,
                                                     warm.iterations]
        meta[f"engine/pagerank_warm/{tag}/mode"] = warm.meta.get("mode")
        plat = GraphPlatform(gs["g800s"], mesh=mesh, n_model=nm,
                             force_engine="distributed")
        r = plat.query(GraphQuery.connected_components())
        out[f"platform/cc/{tag}"] = _np(r.value)
        meta[f"platform/cc/{tag}/engine"] = r.engine
    # the clamped development mesh and the production one (which needs
    # 256 ranks)
    meta["local_mesh"] = list(M.make_local_mesh(2, 8, device_type="cpu")
                              .mesh.shape)
    try:
        M.make_production_mesh(device_type="cpu")
        meta["production_mesh"] = None
    except ValueError as e:
        meta["production_mesh"] = str(e)
    # a planner divergence planted on rank 1: it would run the local
    # engine, the others the distributed one
    plat = GraphPlatform(gs["g800"], mesh=mesh, n_model=2,
                         force_engine="distributed")
    if rank == 1:
        plat._ctx.force_engine = "local"
    q = GraphQuery.pagerank(max_iters=PR_ITERS, tol=PR_TOL)
    meta["divergence/own_plan"] = plat._ctx._plan_local(q, None).engine
    r = plat.query(q)
    meta["divergence/ran"] = r.engine
    meta["divergence/plan"] = r.meta["plan"].engine
    out["divergence/value"] = _np(r.value)
    dist.barrier()
    # a rank that skips a collective: a mesh with a short timeout, where
    # rank 1 runs no query; every rank that waits on it must fail
    quick = M.make_mesh(MESH, device_type="cpu", timeout_s=SKIP_TIMEOUT_S)
    t0 = time.perf_counter()
    meta["skip/error"] = None
    if rank != 1:
        try:
            run_algorithm("repro_torch", "cc", gs, mesh=quick, n_data=2,
                          n_model=2)
        except Exception as e:            # the group's timeout
            meta["skip/error"] = type(e).__name__ + ": " + str(e)[:200]
    meta["skip/seconds"] = time.perf_counter() - t0
    # every rank stays until the others have timed out: a rank that
    # leaves closes its connections, and a peer still waiting on it
    # would see the close instead of its own timeout
    time.sleep(max(0.0, t0 + 3 * SKIP_TIMEOUT_S - time.perf_counter()))
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    # the process groups are broken by the planted skip: leave without
    # tearing them down
    sys.stdout.flush()
    os._exit(0)


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
        code = (f"import torch_mesh_cases as c; "
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


# ------------------------------------------------------------ the reference

def reference_main(outdir: str) -> None:
    """The JAX package's algorithms on a 4-device virtual mesh (run in a
    fresh interpreter with the XLA flag set)."""
    from repro.core import graph as JG
    from repro.launch.mesh import make_mesh
    mesh = make_mesh(MESH, ("data", "model"))
    gs = graphs(JG)
    out, meta = {}, {}
    for nd, nm in LAYOUTS:
        tag = f"{nd}x{nm}"
        for name in ALGORITHMS:
            vals, it = run_algorithm("repro", name, gs, mesh=mesh,
                                     n_data=nd, n_model=nm)
            for k, v in vals.items():
                out[f"{name}/{tag}/{k}"] = v
            meta[f"{name}/{tag}/iters"] = it
    np.savez(os.path.join(outdir, "reference.npz"), **out)
    with open(os.path.join(outdir, "reference.json"), "w") as f:
        json.dump(meta, f)


def start_reference(outdir: str) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    code = f"import torch_mesh_cases as c; c.reference_main({outdir!r})"
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
