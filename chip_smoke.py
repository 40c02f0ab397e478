#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a host with one CUDA card::

    python3 chip_smoke.py

It builds the port's CUDA kernels from the checkout's sources, holds each
against its plain PyTorch version on the card, drives the port's main path
(graph queries through ``LocalEngine.run`` and ``GraphPlatform.query``)
and checks the answers against host oracles (scipy).  Phases, in order;
any failure exits non-zero and prints no result line:

  0. card     nvidia-smi's name and power limit, torch's device name
  1. build    nvcc builds every kernel (seconds and ptxas' register report)
  2. kernels  kernel vs plain version for every (state dtype, edge program,
              monoid, channel dtype) the slice uses, on ragged shapes and on
              the uncapped in-ELL layouts of the phase-3 and phase-4 graphs:
              min/max bit-identical, float sums within rtol 1e-5; timed with
              CUDA events (median of 10 samples of 10 back-to-back calls)
              beside the byte bound
  3. engine   CC, BFS (4 sources) and SSSP on the V = 2^20 identifier graph
              through ``LocalEngine.run`` with variant dense, fused and
              frontier, and fused once more with ``use_kernels=False``
              (the plain version on the card): byte-equal values, equal
              iteration counts, the kernel's fused runs launch it once per
              superstep and no other run launches it
  4. platform ``GraphPlatform`` on the V = 2^24 identifier graph (~130 M
              directed edges, the paper's "combined connected users"):
              CC, CC count, BFS and weighted SSSP (64-superstep bound), a
              repeat CC served from the result cache, and PageRank on the
              graph's unit-weight view; checked against scipy

Both graphs carry random link weights from the seed, multiples of 1/4 in
[1, 4]: float32 path sums are exact, so SSSP is checked exactly and a
kernel that misreads ``w`` disagrees.  The line before the last is
``{"kernels": [...]}`` (launch counts from phases 3-4, the main path, in
total and per path, and the kernel's numbers at the V = 2^24
connected-components shape); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PHASE3_LOG2V = 20          # fits SUPERSTEP_ELL_BUDGET: fused/frontier run
MAIN_LOG2V = 24            # the main-path graph (dense path: over budget)
BFS_HOPS = 64              # superstep bound of the phase-4 BFS/SSSP queries
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
PAGERANK_HALT_L1 = 1e-5    # PageRank halts when an iteration moves < this
PAGERANK_L1_TOL = 1e-4
TIMING_REPS = 10
CALLS_PER_SAMPLE = 10


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise AssertionError(msg)


# --------------------------------------------------------------- helpers

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=TIMING_REPS, calls=CALLS_PER_SAMPLE, warmup=3):
    """Device time of one call: CUDA events around ``calls`` back-to-back
    calls (so the host's dispatch overlaps the device's work), divided
    by ``calls``; the median of ``reps`` such samples."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def bits_equal(a, b) -> bool:
    import torch
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def max_abs_err(a, b) -> float:
    import torch
    a, b = a.double(), b.double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(fin, torch.isfinite(a)) or \
            not torch.equal(a[~fin], b[~fin]):
        return float("inf")
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def identifier_graph(log2v: int, seed: int):
    """The combined-connected-users input: four identifier edge sets over
    2^log2v users, symmetrized and deduplicated, on cuda:0, each link
    weighted by a random multiple of 1/4 in [1, 4] (exact float32 path
    sums; weights of at least 1 bound a shortest path's hops by its
    length)."""
    import numpy as np
    from repro_torch.core import graph as G
    from repro_torch.data import synthetic
    V = 2 ** log2v
    t0 = time.perf_counter()
    sets = synthetic.identifier_edge_sets(V, n_sets=4, mean_degree=1.5,
                                          seed=seed)
    src = np.concatenate([s for s, _ in sets])
    dst = np.concatenate([d for _, d in sets])
    del sets
    rng = np.random.default_rng(seed + 1000)
    w = (1.0 + rng.integers(0, 13, src.size) / 4.0).astype(np.float32)
    coo = G.build_coo(src, dst, V, w=w, symmetrize=True)
    log(f"graph V=2^{log2v}={V} seed={seed}: {coo.n_edges} directed edges, "
        f"host build {time.perf_counter() - t0:.1f} s")
    return coo


def in_ell(coo):
    """The uncapped in-ELL layout the fused variant runs over."""
    import numpy as np
    from repro_torch.core import graph as G
    src = coo.src[: coo.n_edges].cpu().numpy()
    dst = coo.dst[: coo.n_edges].cpu().numpy()
    w = coo.w[: coo.n_edges].cpu().numpy()
    k = int(np.bincount(dst, minlength=coo.n_vertices).max())
    return G.build_ell(src, dst, coo.n_vertices, max(k, 1), w=w,
                       direction="in")


# --------------------------------------------------------------- phase 2

def _combos():
    import numpy as np
    from repro_torch.kernels.pregel_superstep import ops
    imax = int(np.iinfo(np.int32).max)
    inf = float("inf")
    # (name, state dtype, edge program, monoid, channel dtype, identity)
    return [
        ("cc", "int32", ops.msg_src, "min", None, imax),
        ("bfs", "float32", ops.msg_src_plus_one, "min", None, inf),
        ("sssp", "float32", ops.msg_src_plus_w, "min", None, inf),
        ("spmv", "float32", ops.msg_src_times_w, "sum", None, 0.0),
        ("cc_bf16", "float32", ops.msg_src, "min", "bfloat16", inf),
    ]


def _state(name, vx, gen):
    import torch
    dev = torch.device("cuda", 0)
    if name == "cc":
        return torch.randint(0, vx, (vx,), generator=gen, device=dev,
                             dtype=torch.int32)
    if name in ("bfs", "sssp"):
        x = (torch.randint(0, 64, (vx,), generator=gen, device=dev).float()
             if name == "bfs"
             else torch.rand(vx, generator=gen, device=dev) * 50)
        x[torch.rand(vx, generator=gen, device=dev) < 0.3] = float("inf")
        return x
    return torch.rand(vx, generator=gen, device=dev) * (
        100.0 if name == "cc_bf16" else 1.0)


def _ragged(v, k, gen):
    """Random nbr/mask/w with empty rows and all-sentinel rows."""
    import torch
    dev = torch.device("cuda", 0)
    nbr = torch.randint(0, v + 1, (v, k), generator=gen, device=dev,
                        dtype=torch.int32)
    mask = torch.rand((v, k), generator=gen, device=dev) < 0.6
    mask[: v // 10] = False                 # rows without an in-edge
    nbr[v // 10: v // 5] = v                # all-sentinel rows
    mask[v // 10: v // 5] = False
    w = torch.rand((v, k), generator=gen, device=dev) * 1.9 + 0.1
    return nbr, mask, w


def _bound(v, k, vx, prog_reads_w, x, out, program_adds):
    """Least time for the call on the card: bytes over memory rate vs
    operations over the float32 rate; the larger bounds it."""
    nbytes = v * k * (4 + 1 + (4 if prog_reads_w else 0)) \
        + x.element_size() * vx + out.element_size() * v
    ops = v * k * (2 if program_adds else 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernel(label, nbr, mask, w, gen, timed, results):
    """Every combination on one layout: kernel vs plain on the card."""
    import torch
    from repro_torch.kernels.pregel_superstep import ops
    from repro_torch.kernels.pregel_superstep.ref import superstep_plain
    V, K = nbr.shape
    for name, _, msg, op, md, ident in _combos():
        x = _state(name, V, gen)
        kw = dict(message=msg, op=op, identity=ident, message_dtype=md)
        got = ops.fused_superstep(nbr, mask, w, x, **kw)
        torch.cuda.synchronize()
        want = superstep_plain(nbr, mask, w, x, **kw)
        err = max_abs_err(got, want)
        if op == "sum":
            ok = got.dtype == want.dtype and torch.allclose(
                got, want, rtol=1e-5, atol=0.0)
        else:
            ok = bits_equal(got, want)
        row = {"layout": label, "combo": name, "V": V, "K": K,
               "ok": bool(ok), "max_abs_err": err}
        if timed:
            reads_w = msg in (ops.msg_src_plus_w, ops.msg_src_times_w)
            bound, by = _bound(V, K, V, reads_w, x, got,
                               msg is not ops.msg_src)
            row.update(
                ms=cuda_ms(lambda: ops.fused_superstep(nbr, mask, w, x,
                                                       **kw)),
                plain_ms=cuda_ms(lambda: superstep_plain(nbr, mask, w, x,
                                                         **kw)),
                bound_ms=bound, bound_by=by, library_ms=None)
            if op == "sum":
                row["library_ms"] = _library_spmv_ms(nbr, mask, w, x, want)
        results.append(row)
        log("kernel " + json.dumps(row))
        if not ok:
            fail(f"kernel disagrees with its plain version: {row}")


def _library_spmv_ms(nbr, mask, w, x, want):
    """One PyTorch call computing the same weighted sum: a CSR sparse
    matrix-vector product over the same layout (timed here only; the port
    never calls it)."""
    import warnings

    import torch
    counts = mask.sum(dim=1)
    crow = torch.zeros(nbr.shape[0] + 1, dtype=torch.int64,
                       device=nbr.device)
    crow[1:] = torch.cumsum(counts, 0)
    with warnings.catch_warnings():       # "CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_csr_tensor(crow, nbr[mask].long(), w[mask],
                                    size=(nbr.shape[0], x.shape[0]),
                                    check_invariants=False)
    xv = x.unsqueeze(1)
    y = torch.sparse.mm(a, xv).squeeze(1)
    if not torch.allclose(y, want, rtol=1e-4, atol=1e-6):
        fail("torch.sparse.mm disagrees with the plain version")
    return cuda_ms(lambda: torch.sparse.mm(a, xv))


# --------------------------------------------------------------- phase 3

def engine_phase(coo):
    import torch
    from repro_torch.core.engines import LocalEngine
    from repro_torch.kernels.pregel_superstep import ops
    V = coo.n_vertices
    eng = LocalEngine(coo)
    plain = LocalEngine(coo, use_kernels=False)   # parity: no kernel
    rows = []
    sources = tuple(i * V // 4 for i in range(4))
    for algo, params in (("connected_components", {}),
                         ("bfs", {"sources": sources}),
                         ("sssp", {"source": V // 3})):
        base = None
        for label, e, variant in (("dense", eng, "dense"),
                                  ("fused", eng, "fused"),
                                  ("frontier", eng, "frontier"),
                                  ("fused_plain", plain, "fused")):
            k0 = ops.KERNEL_LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = e.run(algo, params, variant=variant)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = ops.KERNEL_LAUNCHES - k0
            realized = r.meta["realized_variant"]
            row = {"algo": algo, "variant": label, "realized": realized,
                   "iterations": r.iterations, "wall_ms": wall * 1e3,
                   "ms_per_superstep": wall * 1e3 / max(r.iterations, 1),
                   "kernel_launches": launched}
            rows.append(row)
            log("engine " + json.dumps(row))
            if realized != variant:
                fail(f"{algo}: variant {variant} fell back to {realized}")
            if label == "fused":
                if launched < r.iterations or launched == 0:
                    fail(f"{algo}: fused run launched the kernel {launched} "
                         f"times in {r.iterations} supersteps")
            elif launched:
                fail(f"{algo}: {label} launched the fused kernel")
            val = r.value.contiguous().view(torch.uint8)
            if base is None:
                base = (val, r.iterations)
            elif not torch.equal(val, base[0]) or r.iterations != base[1]:
                fail(f"{algo}: {label} differs from dense")
    return rows


# --------------------------------------------------------------- phase 4

def platform_phase(coo):
    import torch
    from repro_torch.core import graph as G
    from repro_torch.core.query import GraphPlatform, GraphQuery
    from repro_torch.kernels.pregel_superstep import ops
    V = coo.n_vertices
    plat = GraphPlatform(coo)
    # PageRank folds 1/outdeg into the raw weights, so it is a probability
    # iteration only on unit weights: it runs on the unit-weight view of
    # the same edges (pads keep weight 0)
    unit = GraphPlatform(G.GraphCOO(coo.src, coo.dst,
                                    (coo.w > 0).to(torch.float32), V,
                                    coo.n_edges, coo.symmetric))
    sources = tuple((i * V // 4 + 12345) % V for i in range(4))
    sssp_src = V // 3
    queries = [
        ("cc", plat, GraphQuery.connected_components()),
        ("cc_count", plat, GraphQuery.connected_components(count_only=True)),
        ("pagerank", unit, GraphQuery.pagerank(tol=PAGERANK_HALT_L1 / V)),
        ("bfs", plat, GraphQuery.bfs(sources, max_iters=BFS_HOPS)),
        ("sssp", plat, GraphQuery.sssp(sssp_src, max_iters=BFS_HOPS)),
        ("cc_repeat", plat, GraphQuery.connected_components()),
    ]
    out, rows = {}, []
    for name, p, q in queries:
        plan = p.plan(q)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        k0 = ops.KERNEL_LAUNCHES
        t0 = time.perf_counter()
        r = p.query(q)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        row = {"query": name, "wall_ms": wall * 1e3,
               "iterations": r.iterations, "engine": plan.engine,
               "planned_variant": plan.variant,
               "realized_variant": r.meta.get("realized_variant"),
               "kernel_launches": ops.KERNEL_LAUNCHES - k0,
               "cache": r.meta.get("cache", "miss"),
               "max_memory_allocated_gb":
                   torch.cuda.max_memory_allocated() / 1e9}
        rows.append(row)
        log("query " + json.dumps(row))
        out[name] = r
    if out["cc_repeat"].meta.get("cache") != "hit":
        fail("the repeated CC query was not a result-cache hit")
    check_oracles(coo, out, sources, sssp_src)
    return rows


def check_oracles(coo, out, sources, sssp_src):
    """Host oracles: scipy's connected components (reduced to min-id
    labels) and depth-limited BFS are exact.  SSSP is held to scipy's
    Dijkstra over the same weights, limited to distance BFS_HOPS: every
    weight is at least 1, so a vertex within that distance has a shortest
    path of at most BFS_HOPS edges, which BFS_HOPS supersteps find
    exactly (the weights are multiples of 1/4, so float32 sums are
    exact); every other vertex must read more than BFS_HOPS.  PageRank
    is a float64 power iteration of the same formulation for the same
    number of iterations (tens, at the PAGERANK_HALT_L1 halt), compared
    in L1.  The port computes in float32 with atomics in another order:
    per entry a relative error of order 1e-7 per superstep, damped by
    alpha, so the L1 distance over ranks summing to 1 stays near 1e-6;
    PAGERANK_L1_TOL = 1e-4 leaves two orders of margin."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components, dijkstra
    t0 = time.perf_counter()
    V = coo.n_vertices
    src = coo.src[: coo.n_edges].cpu().numpy()
    dst = coo.dst[: coo.n_edges].cpu().numpy()
    m = csr_matrix((np.ones(src.size), (src, dst)), shape=(V, V))

    ncomp, lab = connected_components(m, directed=False)
    first = np.full(ncomp, V, dtype=np.int64)
    uniq, idx = np.unique(lab, return_index=True)
    first[uniq] = idx
    want_cc = first[lab].astype(np.int32)
    if not np.array_equal(out["cc"].value.cpu().numpy(), want_cc):
        fail("CC labels differ from scipy's components")
    if out["cc_count"].value != ncomp:
        fail(f"CC count {out['cc_count'].value} != scipy's {ncomp}")

    hop = dijkstra(m, directed=True, indices=list(sources), unweighted=True,
                   limit=BFS_HOPS, min_only=True)
    if not np.array_equal(out["bfs"].value.cpu().numpy().astype(np.float64),
                          hop):
        fail("BFS distances differ from scipy's")
    w = coo.w[: coo.n_edges].cpu().numpy().astype(np.float64)
    sp = dijkstra(csr_matrix((w, (src, dst)), shape=(V, V)), directed=True,
                  indices=sssp_src, limit=BFS_HOPS, min_only=True)
    got = out["sssp"].value.cpu().numpy().astype(np.float64)
    near = np.isfinite(sp)
    if not np.array_equal(got[near], sp[near]):
        fail("SSSP distances differ from scipy's Dijkstra")
    if not np.all(got[~near] > BFS_HOPS):
        fail(f"SSSP reads a distance of at most {BFS_HOPS} where scipy's "
             f"Dijkstra finds none")
    if near.sum() < 100 or not np.any(sp[near] != np.round(sp[near])):
        fail("SSSP check holds too few weighted distances")

    if out["pagerank"].iterations < 10:
        fail(f"PageRank halted after {out['pagerank'].iterations} "
             "iterations: its check would hold a near-uniform vector")
    alpha = 0.85
    outdeg = np.bincount(src, minlength=V).astype(np.float64)
    inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1.0), 0.0)
    mt = m.T.tocsr()
    x = np.full(V, 1.0 / V)
    for _ in range(out["pagerank"].iterations):
        dm = x[outdeg == 0].sum()
        x = (1 - alpha) / V + alpha * (mt @ (x * inv) + dm / V)
    l1 = float(np.abs(out["pagerank"].value.cpu().numpy() - x).sum())
    log(f"oracles: {ncomp} components, "
        f"{int(np.isfinite(hop).sum())} vertices within {BFS_HOPS} hops, "
        f"{int(near.sum())} within weighted distance {BFS_HOPS}, pagerank L1 {l1:.3e} after {out['pagerank'].iterations} "
        f"iterations (tolerance {PAGERANK_L1_TOL}), "
        f"{time.perf_counter() - t0:.1f} s")
    if not l1 <= PAGERANK_L1_TOL:
        fail(f"PageRank L1 {l1} exceeds {PAGERANK_L1_TOL}")


# ------------------------------------------------------------------ main

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()

    # 0. card
    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # 1. build
    from repro_torch.kernels import _build
    from repro_torch.kernels.pregel_superstep import ops
    ops.library()
    info = _build.BUILD_LOG["pregel_superstep"]
    lines = info["log"].splitlines()
    regs = sorted({ln.split("Used ")[1].split(",")[0]
                   for ln in lines if "Used " in ln})
    spills = any("spill stores" in ln and not (
        " 0 bytes spill stores" in ln and " 0 bytes spill loads" in ln)
        for ln in lines)
    log(f"build pregel_superstep: {info['seconds']:.1f} s, "
        f"registers per thread {regs}, spills {spills}")

    # graphs (host build; the main-path graph is reused by phases 2 and 4)
    g3 = identifier_graph(PHASE3_LOG2V, seed=0)
    g4 = identifier_graph(MAIN_LOG2V, seed=3)

    # 2. kernel vs plain on the card
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    checks = []
    for v, k in ((1000, 37), (777, 5), (300, 1), (64, 0), (500, 33),
                 (2000, 200)):
        check_kernel(f"ragged {v}x{k}", *_ragged(v, k, gen), gen, False,
                     checks)
    for label, g in ((f"in-ELL 2^{PHASE3_LOG2V}", g3),
                     (f"in-ELL 2^{MAIN_LOG2V}", g4)):
        ell = in_ell(g)
        check_kernel(label, ell.nbr, ell.mask, ell.w, gen, True, checks)
        del ell
    torch.cuda.empty_cache()

    # 3-4. the main path; kernel launches are counted from here
    ops.KERNEL_LAUNCHES = 0
    engine_rows = engine_phase(g3)
    platform_rows = platform_phase(g4)
    launches = ops.KERNEL_LAUNCHES
    if launches == 0:
        fail("the main path never launched pregel_superstep")
    by_path = {
        f"LocalEngine.run V=2^{PHASE3_LOG2V}":
            sum(r["kernel_launches"] for r in engine_rows),
        f"GraphPlatform.query V=2^{MAIN_LOG2V}":
            sum(r["kernel_launches"] for r in platform_rows)}
    if sum(by_path.values()) != launches:
        fail(f"launches by path {by_path} do not add up to {launches}")

    main_row = next(r for r in checks
                    if r["layout"] == f"in-ELL 2^{MAIN_LOG2V}"
                    and r["combo"] == "cc")
    log(json.dumps({"summary": {
        "engine": engine_rows, "platform": platform_rows,
        "seconds": time.perf_counter() - t_start}}))
    log(card)
    log(json.dumps({"kernels": [{
        "name": "pregel_superstep", "route": "cuda",
        "source": "src/repro_torch/kernels/pregel_superstep/csrc/"
                  "superstep.cu",
        "replaces": "src/repro/kernels/pregel_superstep/kernel.py:43",
        "launches": launches, "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in checks),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": f"connected components (int32, msg_src, min) over the "
                 f"V=2^{MAIN_LOG2V} in-ELL, K={main_row['K']}"}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
