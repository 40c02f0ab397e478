#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a host with one CUDA card::

    python3 chip_smoke.py

It builds the port's CUDA kernels from the checkout's sources, holds each
against its plain PyTorch version on the card, drives the port's paths
(graph queries through ``LocalEngine.run`` and ``GraphPlatform.query``,
``LocalEngine._spmv``, and Gemma-2 2B serving through ``greedy_generate``)
and checks the answers against host oracles (scipy, numpy) and the plain
versions on the card.  Phases, in order; any failure exits non-zero and
prints no result line:

  0. card     nvidia-smi's name and power limit, torch's device name
  1. build    nvcc builds every kernel library, all at once (seconds and
              ptxas' register report); cuobjdump counts the HGMMA (wgmma)
              and UTMALDG (TMA tensor load) instructions of the bf16 flash
              kernel, and the run fails without either, or when ptxas
              reports that it serialised the kernel's wgmma (C7514)
  2. kernels  kernel vs plain version on the card:
              pregel_superstep for every (state dtype, edge program,
              monoid, channel dtype) the slice uses, on ragged shapes (K
              = 0 to 3000), masks with holes and rows off 16-byte
              alignment, and on the uncapped in-ELL layouts of the
              phase-3 and phase-4 graphs, the 2^24 one also under a
              seeded permutation of its ids;
              ell_intersect on sorted row pairs (K = 1, 9, 31, 32, 33,
              ragged K, K = 3000, all-sentinel and identical rows) and on
              runs of one eu that cross warps and blocks; ell_spmv
              (ell_combine) on ragged shapes and on masks with holes,
              misaligned rows, clamped ids and inf/NaN behind dead slots;
              flash_attention at the Gemma-2 2B prefill shapes
              (B = 2, S = 8192, GQA 8/4, D = 256, bf16, softcap 50, window
              4096 and 0), SmolLM's (2 x 8192, 15/5, D = 64) and
              Granite's (1 x 8192, 32/8, D = 128), and ragged float32 MQA
              shapes; the softcap rows once more with q scaled by 10,
              logits at the cap.  min/max and intersection counts
              bit-identical, float sums within rtol 1e-5, attention within
              ``REL_TOL`` of each output's size (|want| plus its row's
              RMS: 1e-2 bf16, 1e-4 float32) and, on unit-normal inputs,
              within 2e-2 (bf16) and 1e-4 (float32) absolute; planted
              faults (softcap dropped, window a tile short, first kv tile
              dropped) must fail that check; timed with CUDA events
              (median of 10 samples of 10 back-to-back calls; the plain
              versions at the main-path shapes 3 samples of 1) beside
              the bound and, where one PyTorch call computes the same
              function, its time (at the Gemma-2 global shape also SDPA
              without the softcap, a yardstick that does less work)
  3. engine   on the V = 2^20 identifier graph through ``LocalEngine.run``:
              CC, BFS (4 sources), SSSP and k-core (k = 4) with variant
              dense, fused and frontier, and fused once more with
              ``use_kernels=False`` (the plain version on the card):
              byte-equal values, equal iteration counts, the fused runs
              launch pregel_superstep once per superstep and no other run
              launches it; triangle counting (intersect: ell_intersect,
              one launch) against scipy and k-core against its peeling
              oracle; on the V = 2^14 graph the bitset variant equals the
              intersect variant equals scipy.  Then (outside the path's
              count) the fused BFS and SSSP once more with CUDA events
              around every pregel_superstep launch call (launch latency
              included: an upper bound of the kernel's share) beside the
              wall time per superstep, and the share of the kernel's
              back-to-back time from phase 2
  4. platform ``GraphPlatform`` on the V = 2^24 identifier graph (~130 M
              directed edges, the paper's "combined connected users"):
              CC, CC count, BFS and weighted SSSP (64-superstep bound), a
              repeat CC served from the result cache, PageRank on the
              graph's unit-weight view; then triangle count (planned
              local/intersect, ell_intersect launched), k-core (k = 4)
              and its size at k = 8, and degree statistics, each cold and
              warm; checked against scipy and numpy oracles and the plain
              intersect version on the card
  5. spmv     ``LocalEngine._spmv`` (ell_spmv) sum/min/max over the
              platform's degree-capped ELL (K = 128)
  6. serve    Gemma-2 2B at full width (26 layers, bf16 activations over
              float32 master weights drawn from seed 0, flash attention):
              two batches of requests through ``greedy_generate`` (the
              code path of ``repro_torch.launch.serve``), 2 prompts of
              8192 tokens + 16 generated and 8 prompts of 512 + 32;
              flash_attention launched once per layer in each prefill and
              never in a decode step; the prefill's last logits against
              the same model with ``use_kernels=False`` (the plain
              attention on the card) and a float32 model on the same
              weights, on these and three more batches, within limits
              scaled by the bf16 run's own distance from float32; planted
              faults (the window a kv tile short) must break those limits;
              greedy first tokens equal wherever the plain run's top-2
              margin exceeds twice the measured error; ``decode_step`` at
              position S against ``forward`` over S + 1 tokens; prefill
              wall time, decode ms per token, tokens/s, peak device
              memory, the kernel's device time inside the prefill (CUDA
              events around its 26 launches) and its share

Kernel checks at the main-path shapes (ell_intersect over the V = 2^24
``OrientedELL``, and over one built from the same edges under the
seeded permutation of ids, ell_spmv over the capped ELL) run after
phases 4-5, on the platform's own derived state, and are timed there.  Every graph
carries random link weights from the seed, multiples of 1/4 in [1, 4]:
float32 path sums are exact, so SSSP is checked exactly and a kernel that
misreads ``w`` disagrees.  Kernel launches are counted per path: every
count is set to 0 just before a path runs and read just after.  The line
before the last is ``{"kernels": [...]}`` (launches in total and per
path, and each kernel's numbers at its main-path shape); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PHASE3_LOG2V = 20          # fits SUPERSTEP_ELL_BUDGET: fused/frontier run
BITSET_LOG2V = 14          # bitset triangles: [E, V/32] words per edge
MAIN_LOG2V = 24            # the main-path graph (dense path: over budget)
KCORE_K = 4
KCORE_K_COUNT = 8
BFS_HOPS = 64              # superstep bound of the phase-4 BFS/SSSP queries
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense
PERMUTATION_SEED = 16      # the permuted-id copies of the 2^24 graph
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


def _bound(mask, vx, prog_reads_w, x, out, program_adds):
    """Least time for the call on the card: bytes over memory rate vs
    operations over the float32 rate; the larger bounds it.  What this
    data needs: the mask in full (it decides which slots are live), nbr
    and, for the programs that read it, w at the live slots only, x and
    the output once; one operation per live slot (two with an add)."""
    v, k = mask.shape
    live = int(mask.sum())
    nbytes = v * k + live * (4 + (4 if prog_reads_w else 0)) \
        + x.element_size() * vx + out.element_size() * v
    ops = live * (2 if program_adds else 1)
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
            bound, by = _bound(mask, V, reads_w, x, got,
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


def permuted_in_ell(nbr, mask, w, perm):
    """The same in-ELL under a permutation of the vertex ids, built on the
    card: row perm[v] holds row v with every id j < V renamed perm[j]
    (the sentinel V kept); degrees, K and live slots are unchanged."""
    import torch
    V = nbr.shape[0]
    rows = perm.long()
    nbr_p = torch.empty_like(nbr)
    nbr_p[rows] = torch.where((nbr >= 0) & (nbr < V),
                              perm[nbr.clamp(0, V - 1).long()], nbr)
    mask_p = torch.empty_like(mask)
    mask_p[rows] = mask
    w_p = torch.empty_like(w)
    w_p[rows] = w
    return nbr_p, mask_p, w_p


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


def _ids(rng, e, k, vx, fill=0.6):
    """Random sorted, deduplicated, sentinel-padded rows (the
    OrientedELL row invariant); sentinel == vx."""
    import numpy as np
    rows = np.full((e, k), vx, dtype=np.int32)
    for i in range(e):
        n = rng.integers(0, int(k * fill) + 1)
        vals = rng.choice(vx, size=min(n, vx), replace=False)
        vals.sort()
        rows[i, : len(vals)] = vals
    return rows


def _runs(k):
    """An orientation-shaped input: rows of at most k sorted ids and the
    all-sentinel row V; edges grouped by eu in runs of 1 to 300 (across
    warps and blocks of 256 edges), then padding edges eu = ev = V."""
    import numpy as np
    rng = np.random.default_rng(k)
    V = 700
    nbr = _ids(rng, V + 1, k, V, fill=1.0)
    nbr[V] = V
    lengths = [1, 31, 32, 33, 255, 256, 257, 300, 2, 3, 64, 7]
    eu = np.repeat(np.sort(rng.choice(V, len(lengths), replace=False)),
                   lengths)
    ev = rng.integers(0, V, eu.size)
    eu = np.concatenate([eu, np.full(100, V)]).astype(np.int32)
    ev = np.concatenate([ev, np.full(100, V)]).astype(np.int32)
    return nbr, (eu, ev), V


def check_intersect_rows(results):
    """ell_intersect on sorted row pairs: ragged shapes, K = 1, K past
    the reference's 2048-slot VMEM bound, all-sentinel and identical
    rows; exact equality with the plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels.ell_intersect import ops as iops
    from repro_torch.kernels.ell_intersect.ref import ell_intersect_plain
    cases = []
    for e, k, vx in ((16, 8, 40), (100, 37, 64), (256, 128, 500),
                     (7, 200, 300), (64, 1, 10), (1000, 33, 2000),
                     (40, 3000, 100000), (700, 9, 300), (300, 31, 1000),
                     (300, 32, 1000)):
        rng = np.random.default_rng(e * k)
        cases.append((f"rows {e}x{k}", _ids(rng, e, k, vx),
                      _ids(rng, e, k, vx), vx))
    sent = np.full((8, 16), 32, dtype=np.int32)
    one = sent.copy()
    one[0, :3] = [1, 5, 9]
    cases.append(("all-sentinel rows", sent, one, 32))
    same = np.tile(np.array([2, 3, 5, 7, 11, 100, 100, 100], np.int32),
                   (8, 1))
    cases.append(("identical rows", same, same.copy(), 100))
    for k in (9, 32, 33):
        cases.append((f"runs of eu, K = {k}",) + _runs(k))
    for label, a, b, vx in cases:
        if label.startswith("runs"):        # (nbr, (eu, ev)): one launch
            ta = torch.from_numpy(a).cuda()
            eu, ev = (torch.from_numpy(t).cuda() for t in b)
            got = iops._launch(ta, eu, ev, vx)
            torch.cuda.synchronize()
            want = ell_intersect_plain(ta[eu.long()], ta[ev.long()], vx)
        else:
            ta, tb = (torch.from_numpy(t).cuda() for t in (a, b))
            got = iops.ell_intersect(ta, tb, vx)
            torch.cuda.synchronize()
            want = ell_intersect_plain(ta, tb, vx)
        ok = torch.equal(got, want)
        if label == "all-sentinel rows":
            ok = ok and not bool(got.any())
        if label == "identical rows":
            ok = ok and bool((got == 5).all())
        row = {"kernel": "ell_intersect", "layout": label,
               "K": int(a.shape[1]), "ok": bool(ok),
               "max_abs_err": max_abs_err(got, want),
               "total": int(want.sum())}
        results.append(row)
        log("kernel " + json.dumps(row))
        if not ok:
            fail(f"ell_intersect disagrees with its plain version: {row}")


def _plain_by_rows(fn, nbr, mask, w, x, op, rows=1 << 21):
    """The plain version over row blocks (rows are independent), so its
    [V, K] temporaries stay a few GB at the main-path shape."""
    import torch
    return torch.cat([fn(nbr[i:i + rows], mask[i:i + rows], w[i:i + rows],
                         x, op=op) for i in range(0, nbr.shape[0], rows)])


def _holey(v, k, off, gen):
    """An ELL layout whose masks have holes (live slots not a prefix of
    the row) and all-dead rows, with negative and sentinel ids at live
    slots, inf and NaN in x (and inf in w) only behind dead slots, and
    the mask's rows misaligned by ``off`` bytes from 16."""
    import torch
    dev = torch.device("cuda", 0)
    vx = v + 2
    nbr = torch.randint(-2, vx + 2, (v, k), generator=gen, device=dev,
                        dtype=torch.int32)
    live = torch.rand((v, k), generator=gen, device=dev) < 0.4
    live[::5] = False
    if k > 1:
        live[1::5, 0] = False
        live[1::5, -1] = True
    nbr[live & ((nbr == 5) | (nbr == 6))] = 7
    nbr[~live] = 5 + (torch.arange(v * k, device=dev).view(v, k)[~live]
                      % 2).int()
    mask = torch.zeros(v * k + off, dtype=torch.bool, device=dev)[off:]
    mask = mask.view(v, k)
    mask.copy_(live)
    w = torch.rand((v, k), generator=gen, device=dev) + 0.1
    w[~live] = float("inf")
    x = torch.rand(vx, generator=gen, device=dev)
    x[5], x[6] = float("inf"), float("nan")
    return nbr, mask, w, x


def check_combine(label, nbr, mask, w, x, timed, results, path_out=None):
    """ell_spmv (the ell_combine kernel) vs ell_combine_plain for sum,
    min and max on one layout; ``path_out`` (op -> output) holds what a
    path computed on the same inputs, which must be the same bytes."""
    import torch
    from repro_torch.kernels.ell_combine import ops as cops
    from repro_torch.kernels.ell_combine.ref import ell_combine_plain
    V, K = nbr.shape
    for op in ("sum", "min", "max"):
        got = cops.ell_spmv(nbr, mask, w, x, op=op)
        torch.cuda.synchronize()
        want = _plain_by_rows(ell_combine_plain, nbr, mask, w, x, op)
        if op == "sum":
            ok = torch.allclose(got, want, rtol=1e-5, atol=0.0)
        else:
            ok = bits_equal(got, want)
        if path_out is not None:
            ok = ok and bits_equal(path_out[op], got)
        row = {"kernel": "ell_combine", "layout": label, "op": op, "V": V,
               "K": K, "ok": bool(ok), "max_abs_err": max_abs_err(got, want)}
        if timed:
            bound, by = _bound(mask, V, op == "sum", x, got, op == "sum")
            row.update(
                ms=cuda_ms(lambda: cops.ell_spmv(nbr, mask, w, x, op=op)),
                plain_ms=cuda_ms(lambda: _plain_by_rows(
                    ell_combine_plain, nbr, mask, w, x, op), reps=3,
                    calls=1, warmup=1),
                bound_ms=bound, bound_by=by, library_ms=None)
            if op == "sum":
                row["library_ms"] = _library_spmv_ms(nbr, mask, w, x, want)
            else:
                row["library"] = ("n/a: no single PyTorch call computes a "
                                  "masked ELL row min/max")
        results.append(row)
        log("kernel " + json.dumps(row))
        if not ok:
            fail(f"ell_spmv disagrees with its plain version: {row}")


def check_intersect_main(o, results, label):
    """ell_intersect_counts over a main-shape OrientedELL: kernel vs
    plain exactly, timed, beside its bounds."""
    import torch
    from repro_torch.kernels.ell_intersect import ops as iops
    from repro_torch.kernels.ell_intersect.ref import \
        ell_intersect_counts_plain
    got = iops.ell_intersect_counts(o)
    torch.cuda.synchronize()
    want = ell_intersect_counts_plain(o)
    ok = torch.equal(got, want)
    V, (rows, K) = o.n_vertices, o.nbr.shape
    E = int(o.eu.shape[0])
    lengths = (o.nbr < V).sum(dim=1)
    # What this data needs: eu, ev read and c written once (12 B per
    # padded edge) and each row's valid ids plus the sentinel that ends it
    # (the kernel's length search reads at most that); a merge of the two
    # rows makes len(u) + len(v) integer comparisons per edge, counted at
    # the card's non-tensor float32 rate.  Beside it: nbr read in full,
    # and with each edge's two K-slot rows gathered from device memory
    # (nbr, ~1 GB at V = 2^24, exceeds the 50 MB L2).
    nbytes = 12 * E + 4 * int((lengths + (lengths < K)).sum())
    full_bytes = 12 * E + 4 * rows * K
    ops = int((lengths[o.eu.long()] + lengths[o.ev.long()]).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else \
        (t_ops, "operations")
    row = {"kernel": "ell_intersect", "layout": label,
           "V": V, "K": K, "padded_edges": E, "edges": o.n_edges,
           "mean_fill": float(lengths[:V].double().mean()),
           "ok": bool(ok), "max_abs_err": max_abs_err(got, want),
           "total": int(want.sum(dtype=torch.int64)),
           "ms": cuda_ms(lambda: iops.ell_intersect_counts(o)),
           "plain_ms": cuda_ms(lambda: ell_intersect_counts_plain(o),
                               reps=3, calls=1, warmup=1),
           "bound_ms": bound, "bound_by": by,
           "full_nbr_bound_ms": full_bytes / HBM_BYTES_PER_S * 1e3,
           "gather_bound_ms": (full_bytes + 8 * K * E) / HBM_BYTES_PER_S
           * 1e3,
           "library_ms": None,
           "library": ("n/a: no single PyTorch call computes per-edge "
                       "sorted-row intersection counts")}
    results.append(row)
    log("kernel " + json.dumps(row))
    if not ok:
        fail(f"ell_intersect disagrees with its plain version: {row}")


# (label, B, Hq, Hkv, S, D, dtype, options, SDPA computes the same?,
#  q scale).  Unit-normal q, k, v give scaled logits of about N(0, 1),
#  which a softcap of 50 moves by under 0.02; the "at the cap" rows scale
#  q by 10 (logits of std 10, up to about 50), where it bends them hard.
FLASH_SHAPES = [
    ("gemma2-2b local", 2, 8, 4, 8192, 256, "bfloat16",
     dict(causal=True, window=4096, softcap=50.0), False, 1.0),
    ("gemma2-2b global", 2, 8, 4, 8192, 256, "bfloat16",
     dict(causal=True, softcap=50.0), False, 1.0),
    ("gemma2-2b local, logits at the cap", 2, 8, 4, 8192, 256, "bfloat16",
     dict(causal=True, window=4096, softcap=50.0), False, 10.0),
    ("gemma2-2b global, logits at the cap", 2, 8, 4, 8192, 256, "bfloat16",
     dict(causal=True, softcap=50.0), False, 10.0),
    ("smollm-360m", 2, 15, 5, 8192, 64, "bfloat16", dict(causal=True), True,
     1.0),
    ("granite-8b", 1, 32, 8, 8192, 128, "bfloat16", dict(causal=True), True,
     1.0),
    ("ragged MQA causal", 1, 8, 1, 1000, 32, "float32", dict(causal=True),
     False, 1.0),
    ("ragged MQA", 1, 8, 1, 1000, 32, "float32", dict(causal=False), False,
     1.0),
    ("ragged MQA window", 3, 8, 1, 77, 64, "float32",
     dict(causal=True, window=5), False, 1.0),
    ("ragged MQA softcap, logits at the cap", 2, 8, 1, 1000, 64, "float32",
     dict(causal=True, window=300, softcap=50.0), False, 10.0),
]
# Each output is held to both bounds.  Absolute, on unit-normal inputs
# (the reference's own bf16 tolerance): at the cap single keys carry the
# rows, whose outputs run to |o| of 4-5, where one bf16 ulp is 0.03.
# Relative (``rel_err``: each error over |want| plus its row's RMS):
# ``REL_TOL``, one bf16 rounding of each side; the absolute bound alone
# is as large as a long row's typical output.
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# a key tile of the kernel at D = 256 (128 keys at D <= 128 in bf16)
FLASH_TILE = 64


def valid_pairs(s, causal, window=0, **_):
    """(query, key) pairs the masks leave open, for one head."""
    import numpy as np
    i = np.arange(s, dtype=np.int64)
    hi = i if causal else np.full(s, s - 1)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(s, int)
    return int((hi - lo + 1).clip(min=0).sum())


def flash_bound(b, hq, hkv, s, d, dtype, kw):
    """Least time for the call: 4 D operations per open pair and query
    head (q.k and p.v) at the type's peak (bf16 tensor cores; float32
    outside them), against q, k, v read once and o written once."""
    es = 2 if dtype == "bfloat16" else 4
    ops = 4 * d * valid_pairs(s, **kw) * b * hq
    nbytes = es * s * d * (2 * b * hq + 2 * b * hkv)
    t_ops = ops / (BF16_OPS_PER_S if dtype == "bfloat16"
                   else F32_OPS_PER_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes
            else (t_bytes, "bytes")), ops


def flash_faults(q, k, v, kw, scale, want, fops, mha_plain):
    """Planted faults the check must reject, as (name, output): the
    kernel launched without its softcap (logits at the cap) or with the
    window one tile short, and, for a causal global layer, the plain
    version with the first kv tile dropped for every query past it."""
    import torch
    faults = []
    if kw.get("softcap") and scale > 1:
        faults.append(("softcap dropped", fops.flash_attention(
            q, k, v, **{**kw, "softcap": 0.0})))
    if kw.get("window", 0) > FLASH_TILE:
        faults.append(("window short by a tile", fops.flash_attention(
            q, k, v, **{**kw, "window": kw["window"] - FLASH_TILE})))
    elif kw.get("causal") and not kw.get("window") and scale == 1:
        t = FLASH_TILE
        tail = mha_plain(q[:, :, t:], k[:, :, t:], v[:, :, t:], **kw)
        faults.append(("first kv tile dropped",
                       torch.cat([want[:, :, :t], tail], dim=2)))
    return faults


def check_flash(results):
    """flash_attention vs mha_plain on the card at the serving shapes and
    on ragged MQA shapes, each timed beside its bound, its plain version
    and, where one exists, SDPA (timed here only; the port never calls
    it); each planted fault must fail the same check."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (REL_TOL, mha_plain,
                                                         rel_err)
    gen = torch.Generator(device="cuda").manual_seed(13)
    for label, b, hq, hkv, s, d, dtype, kw, sdpa, scale in FLASH_SHAPES:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda")
                   for h in (hq, hkv, hkv))
        q, k, v = (q * scale).to(dt), k.to(dt), v.to(dt)
        got = fops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = mha_plain(q, k, v, **kw)
        err, rel = max_abs_err(got.float(), want.float()), rel_err(got, want)
        abs_tol = FLASH_TOL[dtype] if scale == 1 else None
        ok = got.dtype == dt and rel <= REL_TOL[dt] and (
            abs_tol is None or err <= abs_tol)
        (bound, by), ops = flash_bound(b, hq, hkv, s, d, dtype, kw)
        row = {"kernel": "flash_attention", "layout": label,
               "shape": [b, hq, hkv, s, d], "dtype": dtype,
               "options": kw, "q_scale": scale, "ok": bool(ok),
               "max_abs_err": err, "tolerance": abs_tol, "rel_err": rel,
               "rel_tolerance": REL_TOL[dt], "operations": ops}
        row["faults"] = [
            {"fault": name, "rel_err": rel_err(out, want),
             "max_abs_err": max_abs_err(out.float(), want.float())}
            for name, out in flash_faults(q, k, v, kw, scale, want, fops,
                                          mha_plain)]
        del want
        row.update(
            ms=cuda_ms(lambda: fops.flash_attention(q, k, v, **kw)),
            plain_ms=cuda_ms(lambda: mha_plain(q, k, v, **kw), reps=3,
                             calls=1, warmup=1),
            bound_ms=bound, bound_by=by, library_ms=None)
        row["tflops"] = ops / row["ms"] / 1e9
        if sdpa:
            def lib():
                return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)
            lerr = max_abs_err(lib().float(), got.float())
            if not lerr <= FLASH_TOL[dtype]:
                fail(f"SDPA disagrees with the kernel at {label}: {lerr}")
            row["library_ms"] = cuda_ms(lib)
            row["library"] = ("F.scaled_dot_product_attention(is_causal="
                              "True, enable_gqa=True)")
        elif kw.get("softcap"):
            row["library"] = ("n/a: no single PyTorch call applies a logit "
                              "softcap")
        else:
            row["library"] = "not timed (a check shape, not a path's)"
        results.append(row)
        log("kernel " + json.dumps(row))
        if not ok:
            fail(f"flash_attention disagrees with its plain version: {row}")
        for f in row["faults"]:
            if not f["rel_err"] > REL_TOL[dt]:
                fail(f"flash check at {label} cannot see a planted fault: "
                     f"{f}")
        del q, k, v, got
    torch.cuda.empty_cache()


# ------------------------------------------------------- launch counting

def _ops_modules() -> dict:
    from repro_torch.kernels.ell_combine import ops as cops
    from repro_torch.kernels.ell_intersect import ops as iops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.pregel_superstep import ops as sops
    return {"pregel_superstep": sops, "ell_intersect": iops,
            "ell_combine": cops, "flash_attention": fops}


def launch_counts() -> dict:
    return {n: m.KERNEL_LAUNCHES for n, m in _ops_modules().items()}


def reset_counts() -> None:
    for m in _ops_modules().values():
        m.KERNEL_LAUNCHES = 0


def launched_since(before: dict) -> dict:
    now = launch_counts()
    return {n: now[n] - before[n] for n in now}


# ---------------------------------------------------------------- oracles

def _host_edges(coo):
    return (coo.src[: coo.n_edges].cpu().numpy(),
            coo.dst[: coo.n_edges].cpu().numpy())


def triangles_oracle(coo) -> int:
    """scipy: orient every edge from the lower id to the higher (any
    total order counts each triangle once) and sum (L @ L) .* L."""
    import numpy as np
    from scipy.sparse import csr_matrix
    src, dst = _host_edges(coo)
    up = src < dst
    V = coo.n_vertices
    L = csr_matrix((np.ones(int(up.sum()), np.int64), (src[up], dst[up])),
                   shape=(V, V))
    return int((L @ L).multiply(L).sum())


# --------------------------------------------------------------- phase 3

def engine_phase(coo, coo_small):
    import importlib

    import torch
    from repro_torch.core.engines import LocalEngine
    TT = importlib.import_module("repro_torch.core.algorithms.triangles")
    V = coo.n_vertices
    eng = LocalEngine(coo)
    plain = LocalEngine(coo, use_kernels=False)   # parity: no kernel
    rows = []
    sources = tuple(i * V // 4 for i in range(4))
    for algo, params in (("connected_components", {}),
                         ("bfs", {"sources": sources}),
                         ("sssp", {"source": V // 3}),
                         ("k_core", {"k": KCORE_K})):
        base = None
        for label, e, variant in (("dense", eng, "dense"),
                                  ("fused", eng, "fused"),
                                  ("frontier", eng, "frontier"),
                                  ("fused_plain", plain, "fused")):
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = e.run(algo, params, variant=variant)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = launched_since(before)
            n_step = launched["pregel_superstep"]
            realized = r.meta["realized_variant"]
            row = {"algo": algo, "variant": label, "realized": realized,
                   "iterations": r.iterations, "wall_ms": wall * 1e3,
                   "ms_per_superstep": wall * 1e3 / max(r.iterations, 1),
                   "launches": launched}
            rows.append(row)
            log("engine " + json.dumps(row))
            if realized != variant:
                fail(f"{algo}: variant {variant} fell back to {realized}")
            if label == "fused":
                if n_step < r.iterations or n_step == 0:
                    fail(f"{algo}: fused run launched the kernel {n_step} "
                         f"times in {r.iterations} supersteps")
            elif n_step:
                fail(f"{algo}: {label} launched the fused kernel")
            if launched["ell_intersect"] or launched["ell_combine"]:
                fail(f"{algo}: {label} launched another kernel: {launched}")
            val = r.value.contiguous().view(torch.uint8)
            if base is None:
                base = (val, r.iterations, r.value)
            elif not torch.equal(val, base[0]) or r.iterations != base[1]:
                fail(f"{algo}: {label} differs from dense")
        if algo == "k_core":
            want = TT.k_core_reference(*_host_edges(coo), V, KCORE_K)
            if not (base[2].cpu().numpy() == want).all():
                fail("k-core membership differs from the peeling oracle")
            log(f"oracle: {KCORE_K}-core of {int(want.sum())} vertices "
                f"after {base[1]} supersteps")
    rows += triangle_rows(eng, plain, coo, f"2^{PHASE3_LOG2V}")
    small = LocalEngine(coo_small)
    rows += triangle_rows(small, None, coo_small, f"2^{BITSET_LOG2V}",
                          bitset=True)
    return rows, eng


def superstep_breakdown(eng, engine_rows, checks):
    """The fused BFS and SSSP of phase 3 once more, with CUDA events
    around every pregel_superstep launch, beside the wall time per
    superstep.  Every superstep ends in a halt read, so the device is
    idle when each launch call starts: an event pair spans the call's
    launch latency as well as the kernel, and its sum over the run is an
    upper bound of the kernel's device time.  The kernel's time alone is
    its back-to-back time at this layout from phase 2 (the same combo on
    the 2^20 in-ELL, random state).  The rest of a superstep is the host:
    the wrapper, the superstep's other operations and the halt read
    (``.item()``)."""
    import torch
    from repro_torch.kernels.pregel_superstep import ops as sops
    V = eng.coo.n_vertices
    rows = []
    for algo, params in (("bfs", {"sources": tuple(i * V // 4
                                                   for i in range(4))}),
                         ("sssp", {"source": V // 3})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timed_launches(sops, "pregel_superstep") as events:
            r = eng.run(algo, params, variant="fused")
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / r.iterations
        if len(events) != r.iterations:
            fail(f"{algo}: {len(events)} timed launches in "
                 f"{r.iterations} supersteps")
        upper = sum(a.elapsed_time(e) for a, e in events) / r.iterations
        untimed = next(x for x in engine_rows if x.get("algo") == algo
                       and x.get("variant") == "fused")["ms_per_superstep"]
        back_to_back = next(x for x in checks if x.get("combo") == algo
                            and x["layout"] == f"in-ELL 2^{PHASE3_LOG2V}"
                            )["ms"]
        # both shares are of the phase's superstep wall without events
        row = {"algo": algo, "supersteps": r.iterations,
               "wall_ms_per_superstep_with_events": wall,
               "launch_and_kernel_ms_per_superstep": upper,
               "wall_ms_per_superstep": untimed,
               "kernel_share_upper_bound": upper / untimed,
               "kernel_back_to_back_ms": back_to_back,
               "kernel_share_back_to_back": back_to_back / untimed}
        rows.append(row)
        log("superstep breakdown " + json.dumps(row))
    return rows


def triangle_rows(eng, plain, coo, size, bitset=False):
    """Triangle count through ``LocalEngine.run``: intersect (one
    ell_intersect launch), the plain intersect on the card (none) and, on
    a small graph, bitset (none); all equal scipy."""
    import torch
    want = triangles_oracle(coo)
    runs = [("intersect", eng, "intersect")]
    if plain is not None:
        runs.append(("intersect_plain", plain, "intersect"))
    if bitset:
        runs.append(("bitset", eng, "bitset"))
    rows = []
    for label, e, variant in runs:
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = e.run("triangle_count", variant=variant)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = launched_since(before)
        row = {"algo": "triangle_count", "graph": size, "variant": label,
               "value": r.value, "oracle": want, "wall_ms": wall * 1e3,
               "launches": launched,
               "max_memory_allocated_gb":
                   torch.cuda.max_memory_allocated() / 1e9}
        rows.append(row)
        log("engine " + json.dumps(row))
        expect = 1 if label == "intersect" else 0
        if launched["ell_intersect"] != expect or \
                launched["pregel_superstep"] or launched["ell_combine"]:
            fail(f"triangles {label} at {size}: launches {launched}")
        if r.value != want:
            fail(f"triangles {label} at {size}: {r.value} != scipy's {want}")
    return rows


# --------------------------------------------------------------- phase 4

def platform_phase(coo):
    import torch
    from repro_torch.core import graph as G
    from repro_torch.core.query import GraphPlatform, GraphQuery
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
        r, row = _timed_query(name, p, q)
        rows.append(row)
        out[name] = r
    if out["cc_repeat"].meta.get("cache") != "hit":
        fail("the repeated CC query was not a result-cache hit")
    del unit
    check_oracles(coo, out, sources, sssp_src)
    rows += cohesion_queries(plat, coo)
    return plat, rows


def _timed_query(name, p, q, temp=None):
    import torch
    plan = p.plan(q)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    before = launch_counts()
    t0 = time.perf_counter()
    r = p.query(q)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row = {"query": name, "wall_ms": wall * 1e3,
           "iterations": r.iterations, "engine": plan.engine,
           "planned_variant": plan.variant,
           "realized_variant": r.meta.get("realized_variant"),
           "launches": launched_since(before),
           "cache": r.meta.get("cache", "miss"),
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9}
    if temp is not None:
        row["run"] = temp
    log("query " + json.dumps(row))
    return r, row


def cohesion_queries(plat, coo):
    """Triangle count, k-core and its size, degree statistics through
    ``GraphPlatform.query``: each cold (derived state built, e.g. the
    OrientedELL) and warm (the result cache emptied first, derived state
    kept), against host oracles and the plain intersect on the card."""
    import importlib

    import numpy as np
    from repro_torch.core.query import GraphQuery
    TT = importlib.import_module("repro_torch.core.algorithms.triangles")
    V = coo.n_vertices
    queries = [("triangles", GraphQuery.triangle_count()),
               ("kcore", GraphQuery.k_core(KCORE_K)),
               ("kcore_count", GraphQuery.k_core(KCORE_K_COUNT,
                                                 count_only=True)),
               ("degrees", GraphQuery.degree_stats())]
    plan = plat.plan(queries[0][1])
    if (plan.engine, plan.variant) != ("local", "intersect"):
        fail(f"triangle_count planned {plan.engine}/{plan.variant}, not "
             "local/intersect")
    out, rows = {}, []
    for name, q in queries:
        for temp in ("cold", "warm"):
            plat._result_cache.clear()
            r, row = _timed_query(name, plat, q, temp)
            rows.append(row)
            if row["cache"] == "hit":
                fail(f"{name} ({temp}) was served from the result cache")
            if name == "triangles" and row["launches"]["ell_intersect"] == 0:
                fail(f"triangle_count ({temp}) never launched ell_intersect")
            if name in out and r.iterations != out[name].iterations:
                fail(f"{name}: warm run differs from the cold one")
            out[name] = r
    t0 = time.perf_counter()
    plain, _ = TT.triangle_count_intersect(plat.coo,
                                           oriented=plat.local.oriented,
                                           use_kernels=False)
    plain_s = time.perf_counter() - t0
    src, dst = _host_edges(coo)
    t0 = time.perf_counter()
    want_tri = triangles_oracle(coo)
    tri_s = time.perf_counter() - t0
    if not out["triangles"].value == plain == want_tri:
        fail(f"triangles {out['triangles'].value}: plain on the card "
             f"{plain}, scipy {want_tri}")
    t0 = time.perf_counter()
    want_core = TT.k_core_reference(src, dst, V, KCORE_K)
    want_count = int(TT.k_core_reference(src, dst, V, KCORE_K_COUNT).sum())
    core_s = time.perf_counter() - t0
    if not (out["kcore"].value.cpu().numpy() == want_core).all():
        fail("k-core membership differs from the peeling oracle")
    if out["kcore_count"].value != want_count:
        fail(f"{KCORE_K_COUNT}-core size {out['kcore_count'].value} != "
             f"{want_count}")
    outd = np.bincount(src, minlength=V)
    ind = np.bincount(dst, minlength=V)
    want_deg = {"n_vertices": V, "n_edges": coo.n_edges,
                "max_out_degree": int(outd.max()),
                "max_in_degree": int(ind.max()),
                "mean_degree": float(coo.n_edges / V),
                "dangling": int((outd == 0).sum())}
    if out["degrees"].value != want_deg:
        fail(f"degree stats {out['degrees'].value} != numpy's {want_deg}")
    o = plat.local.oriented
    log(f"oracles: {want_tri} triangles (plain intersect on the card "
        f"{plain_s * 1e3:.1f} ms, scipy {tri_s:.1f} s), OrientedELL K = "
        f"{o.max_out_degree} over {o.n_edges} oriented edges; "
        f"{KCORE_K}-core of {int(want_core.sum())} vertices, "
        f"{KCORE_K_COUNT}-core of {want_count} (peeling oracle "
        f"{core_s:.1f} s); degrees {json.dumps(want_deg)}")
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


# --------------------------------------------------------------- phase 5

def spmv_path(plat, gen):
    """``LocalEngine._spmv`` (bound to ell_spmv) for sum, min and max over
    the platform's degree-capped ELL, on one random state vector."""
    import torch
    eng = plat.local
    t0 = time.perf_counter()
    ell = eng.ell
    torch.cuda.synchronize()
    log(f"capped ELL V=2^{MAIN_LOG2V} K={ell.max_degree}: built in "
        f"{time.perf_counter() - t0:.1f} s, {ell.nbytes() / 1e9:.2f} GB, "
        f"{ell.lost_fraction:.3g} of edges over the cap")
    x = torch.rand(ell.nbr.shape[0], generator=gen, device=ell.nbr.device)
    outs, rows = {}, []
    for op in ("sum", "min", "max"):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[op] = eng._spmv(ell.nbr, ell.mask, ell.w, x, op)
        torch.cuda.synchronize()
        row = {"path": "LocalEngine._spmv", "op": op,
               "wall_ms": (time.perf_counter() - t0) * 1e3,
               "launches": launched_since(before)}
        rows.append(row)
        log("spmv " + json.dumps(row))
    return ell, x, outs, rows


# --------------------------------------------------------------- phase 6

SERVE_ARCH = "gemma2-2b"
SERVE_PATH = f"DenseLM serve {SERVE_ARCH}"
# (prompts, prompt tokens, generated tokens): S = 8192 is past the
# 4096-token window, so the local layers really mask
SERVE_BATCHES = ((2, 8192, 16), (8, 512, 32))
# more request batches of 8 x 512 tokens, read for accuracy only (the
# prompts' seeds): further sound readings of the bf16 runs' spread
SERVE_ACCURACY_SEEDS = (101, 102, 103)
# Model-level limits.  Random-weight bf16 logits carry the rounding of
# bf16 activations through 26 layers, so the scale of a sound difference
# is the plain bf16 run's own distance from the float32 model on the
# same weights ("noise", max abs over the batch's last logits), read in
# the same run.  The kernel's run may differ from the plain one by at
# most SERVE_NOISE_FACTOR noises (max abs), and its mean distance from
# the float32 model may be at most SERVE_F32_RATIO times the plain run's.
# Both are set from readings on both sides (PERF.md, Findings): sound
# batches, and planted faults, which phase 6 runs and must reject.
SERVE_NOISE_FACTOR = 2.0
SERVE_F32_RATIO = 2.0
# prefill's last logits against forward's at the same position: the same
# kernel over the same rows (read: 8e-6 to 1e-5)
PREFILL_FORWARD_TOL = 1e-3


def _argmax_tokens(logits):
    import torch
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)


@contextlib.contextmanager
def timed_launches(ops_module, entry):
    """CUDA events around every call of a kernel library's C entry point
    (``ops_module.library()``'s ``entry``) in the block, recorded on the
    launch's stream: the kernel's own device time inside a path, the
    wrapper's checks on the host left out (yields the list of event
    pairs)."""
    import torch
    lib = ops_module.library()
    events, launch = [], getattr(lib, entry)

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = launch(*args)
        end.record()
        events.append((start, end))
        return rc
    setattr(lib, entry, timed)
    try:
        yield events
    finally:
        setattr(lib, entry, launch)


def last_logits(m, batch, s):
    """``m``'s prefill logits at the last prompt position."""
    import torch
    before = launch_counts()
    logits, _ = m.prefill(batch, cache_len=s)
    torch.cuda.synchronize()
    if not m.use_kernels and sum(launched_since(before).values()):
        fail("serve: use_kernels=False launched a kernel")
    return logits


def serve_accuracy(logits, plain_logits, ref32) -> dict:
    """A run's last logits against the plain attention's (same bf16
    model and weights), and both against the float32 model's."""
    noise = max_abs_err(plain_logits, ref32)
    err = max_abs_err(logits, plain_logits)
    row = {"logits_max_abs_err": err, "f32_noise": noise,
           "err_over_noise": err / noise,
           "f32_mean_abs_dist_kernel": float((logits - ref32).abs().mean()),
           "f32_mean_abs_dist_plain":
               float((plain_logits - ref32).abs().mean())}
    row["f32_ratio"] = (row["f32_mean_abs_dist_kernel"]
                        / row["f32_mean_abs_dist_plain"])
    return row


def serve_rejects(acc) -> bool:
    """Do the model-level limits reject this reading?"""
    return not (acc["err_over_noise"] <= SERVE_NOISE_FACTOR
                and acc["f32_ratio"] <= SERVE_F32_RATIO)


def serve_phase():
    """Gemma-2 2B serving through ``greedy_generate`` (the path), then per
    batch: the prefill (with the kernel's launches timed inside it) and
    the decode steps timed alone with their launch counts, the kernel's
    prefill against the plain attention's; decode against forward; and
    planted faults, which the limits must reject."""
    import dataclasses

    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import serve
    from repro_torch.models.transformer import DenseLM
    from repro_torch.train.serve_step import greedy_generate
    t_phase = t0 = time.perf_counter()
    model = serve.build(SERVE_ARCH, attn_impl="flash", seed=0)
    cfg = model.cfg

    def sibling(use_kernels=True, **changes):
        """The model on the same (shared) master weights, with ``changes``
        to its config."""
        return DenseLM(dataclasses.replace(cfg, **changes),
                       device=model.device, params=_param_tree(model.params),
                       use_kernels=use_kernels)
    plain = sibling(use_kernels=False)
    f32 = sibling(use_kernels=False, dtype="float32")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serve: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params} parameters in float32, activations {cfg.dtype}) "
        f"built in {time.perf_counter() - t0:.1f} s")
    if cfg.dtype != "bfloat16" or cfg.n_layers != 26:
        fail(f"serve: unexpected config {cfg}")
    reqs = [(serve.prompts(cfg, b, s, seed=b, device=model.device), s, g)
            for b, s, g in SERVE_BATCHES]

    # the path: every count 0 just before, read just after
    reset_counts()
    rows = []
    for batch, s, g in reqs:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        before = launch_counts()
        t0 = time.perf_counter()
        out = greedy_generate(model, batch, steps=g, cache_len=s + g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = launched_since(before)
        b = batch["tokens"].shape[0]
        rows.append({"batch": b, "prompt": s, "generated": g,
                     "cache_len": s + g, "generate_wall_ms": wall * 1e3,
                     "launches": launched, "tokens": out,
                     "max_memory_allocated_gb":
                         torch.cuda.max_memory_allocated() / 1e9})
        if out.shape != (b, g) or not bool(
                ((out >= 0) & (out < cfg.vocab_size)).all()):
            fail(f"serve: bad tokens {tuple(out.shape)}")
        if launched["flash_attention"] != cfg.n_layers or \
                sum(launched.values()) != cfg.n_layers:
            fail(f"serve: one generate launched {launched}, not one flash "
                 f"launch per layer ({cfg.n_layers})")
    path_counts = launch_counts()

    for i, (row, (batch, s, g)) in enumerate(zip(rows, reqs)):
        tokens = row.pop("tokens")
        # prefill alone, the kernel's launches timed inside it
        torch.cuda.synchronize()
        before = launch_counts()
        t0 = time.perf_counter()
        with timed_launches(fops, "flash_attention_fwd") as events:
            logits, cache = model.prefill(batch, cache_len=s + g)
            torch.cuda.synchronize()
        row["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        if launched_since(before)["flash_attention"] != cfg.n_layers or \
                len(events) != cfg.n_layers:
            fail("serve: a prefill did not launch the kernel once per layer")
        row["flash_ms_in_prefill"] = sum(a.elapsed_time(e)
                                         for a, e in events)
        row["flash_share_of_prefill"] = (row["flash_ms_in_prefill"]
                                         / row["prefill_ms"])
        # the decode steps alone: no kernel launch in any
        tok = _argmax_tokens(logits)
        seq = [tok]
        before = launch_counts()
        t0 = time.perf_counter()
        for j in range(g - 1):
            lg, cache = model.decode_step(tok, cache, s + j)
            tok = _argmax_tokens(lg)
            seq.append(tok)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / (g - 1)
        if sum(launched_since(before).values()):
            fail("serve: a decode step launched a kernel")
        b = row["batch"]
        row.update(decode_ms_per_step=step_ms,
                   decode_tokens_per_s=b / step_ms * 1e3,
                   repeat_tokens_equal=bool(torch.equal(
                       torch.cat(seq, dim=1), tokens)))
        del cache
        # kernel vs plain attention, same model and weights
        plain_logits = last_logits(plain, batch, s)
        ref32 = last_logits(f32, batch, s)
        acc = serve_accuracy(logits, plain_logits, ref32)
        if i == 0:
            refs = plain_logits, ref32           # for the planted faults
        before = launch_counts()
        plain_tokens = greedy_generate(plain, batch, steps=g,
                                       cache_len=s + g)
        torch.cuda.synchronize()
        if sum(launched_since(before).values()):
            fail("serve: use_kernels=False launched a kernel")
        err = acc["logits_max_abs_err"]
        top2 = torch.topk(plain_logits[:, -1], 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * err
        first_k = _argmax_tokens(logits)[:, 0]
        first_p = _argmax_tokens(plain_logits)[:, 0]
        row.update(acc, logits_tolerance=SERVE_NOISE_FACTOR * acc["f32_noise"],
                   first_tokens_clear=int(clear.sum()),
                   first_tokens_equal=int((first_k == first_p).sum()),
                   all_tokens_equal_fraction=float(
                       (tokens == plain_tokens).float().mean()))
        if serve_rejects(acc):
            fail(f"serve: the kernel's logits are out of the limits: {acc}")
        if not bool((first_k == first_p)[clear].all()):
            fail("serve: a first token differs where the plain top-2 margin "
                 "exceeds twice the error")
        del logits, plain_logits, ref32
    # further sound readings: more batches of 8 x 512 prompts
    sound = [{k: r[k] for k in ("err_over_noise", "f32_ratio")}
             for r in rows]
    for seed in SERVE_ACCURACY_SEEDS:
        batch = serve.prompts(cfg, 8, 512, seed=seed, device=model.device)
        acc = serve_accuracy(*(last_logits(m, batch, 512)
                               for m in (model, plain, f32)))
        sound.append({"seed": seed, **acc})
        if serve_rejects(acc):
            fail(f"serve: the kernel's logits are out of the limits at "
                 f"seed {seed}: {acc}")
    # planted faults at 2 x 8192 (past the window), which the limits
    # must reject: the local layers' window a kv tile short, the softcap
    # dropped (reported: random weights keep the logits far below it)
    batch, s, _ = reqs[0]
    faults = []
    for name, changes, must_reject in (
            ("window short by a tile", {"window": cfg.window - FLASH_TILE},
             True),
            ("softcap dropped", {"attn_logit_softcap": 0.0}, False)):
        acc = serve_accuracy(last_logits(sibling(**changes), batch, s),
                             *refs)
        acc.update(fault=name, rejected=serve_rejects(acc))
        faults.append(acc)
        if must_reject and not acc["rejected"]:
            fail(f"serve: the limits cannot see a planted fault: {acc}")
    # decode at position S against forward over S + 1 tokens
    batch, s, g = reqs[1]
    sub = batch["tokens"][:2]
    last, cache = model.prefill({"tokens": sub}, cache_len=s + 2)
    nxt = _argmax_tokens(last)
    full = model.forward({"tokens": torch.cat([sub, nxt], dim=1)})
    # a planted fault on a copy of the cache: the token decoded one
    # position late (an empty slot before it, rope one step on)
    late = {k: v.clone() for k, v in cache.items()}
    lg, _ = model.decode_step(nxt, cache, s)
    lg_late, _ = model.decode_step(nxt, late, s + 1)
    pre_err = max_abs_err(last[:, 0], full[:, s - 1])
    dec_err = max_abs_err(lg[:, 0], full[:, s])
    late_err = max_abs_err(lg_late[:, 0], full[:, s])
    dec_tol = SERVE_NOISE_FACTOR * rows[1]["f32_noise"]
    rows[1].update(prefill_vs_forward_max_abs_err=pre_err,
                   prefill_vs_forward_tolerance=PREFILL_FORWARD_TOL,
                   decode_vs_forward_max_abs_err=dec_err,
                   decode_vs_forward_tolerance=dec_tol,
                   decode_one_position_late_max_abs_err=late_err)
    del full, cache, late
    if not late_err > dec_tol:
        fail(f"serve: decode vs forward cannot see a token decoded one "
             f"position late ({late_err} <= {dec_tol})")
    for row in rows:
        log("serve " + json.dumps(row))
    log("serve sound " + json.dumps(sound))
    log("serve faults " + json.dumps(faults))
    if not (dec_err <= dec_tol and pre_err <= PREFILL_FORWARD_TOL):
        fail(f"serve: prefill / decode_step vs forward differ by {pre_err} "
             f"/ {dec_err}")
    del model, plain, f32
    torch.cuda.empty_cache()
    log(f"serve: phase 6 took {time.perf_counter() - t_phase:.1f} s")
    return path_counts, rows


def _param_tree(params):
    import torch
    return {k: _param_tree(v) if isinstance(v, torch.nn.ParameterDict)
            else v.detach() for k, v in params.items()}


# ------------------------------------------------------------------ main

def build_all():
    """Every kernel library at once: one nvcc per library, in threads."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ell_combine import ops as cops
    from repro_torch.kernels.ell_intersect import ops as iops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.pregel_superstep import ops as sops
    errors = []

    def build(fn):
        try:
            fn()
        except Exception as e:        # reported below, in this thread
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(f,))
               for f in (sops.library, iops.library, cops.library,
                         fops.library)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for name in ("pregel_superstep", "ell_intersect", "ell_combine",
                 "flash_attention"):
        info = _build.BUILD_LOG[name]
        lines = info["log"].splitlines()
        regs = sorted({ln.split("Used ")[1].split(",")[0]
                       for ln in lines if "Used " in ln})
        spills = any("spill stores" in ln and not (
            " 0 bytes spill stores" in ln and " 0 bytes spill loads" in ln)
            for ln in lines)
        log(f"build {name}: {info['seconds']:.1f} s, registers per thread "
            f"{regs}, spills {spills}")
    log(f"build: all libraries in {time.perf_counter() - t0:.1f} s")
    # ptxas serialises every wgmma of a kernel (its warning C7514) when a
    # path may read an accumulator while a wgmma writing it is in flight:
    # the kernel stays right but loses its overlap of softmax and products
    serial = [ln for ln in _build.BUILD_LOG["flash_attention"]["log"]
              .splitlines() if "C7514" in ln]
    if serial:
        fail(f"ptxas serialised the flash kernel's wgmma: {serial[0]}")
    return flash_sass(_build.BUILD_LOG["flash_attention"]["path"])


def cuobjdump_path() -> str:
    """cuobjdump from the CUDA toolkit that builds the kernels (beside
    nvcc)."""
    from repro_torch.kernels import _build
    here = Path(_build.nvcc_path()).parent / "cuobjdump"
    if not here.exists():
        fail(f"cuobjdump not found beside nvcc: {here}")
    return str(here)


def flash_sass(lib: str) -> dict:
    """Counts of Hopper's warpgroup MMA (HGMMA) and TMA (UTMALDG, UBLKCP)
    instructions in the SASS of the bf16 flash kernel; fails when either
    is missing."""
    out = subprocess.run([cuobjdump_path(), "-sass", lib],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump failed: {out.stderr.strip()[:2000]}")
    counts = {k: 0 for k in ("HGMMA", "UTMALDG", "UBLKCP")}
    in_bf16 = False
    for line in out.stdout.splitlines():
        if "Function :" in line:
            in_bf16 = "flash_fwd_wgmma_kernel" in line
        elif in_bf16:
            for k in counts:
                if k in line:
                    counts[k] += 1
    log(f"build flash_attention: SASS of the bf16 kernel {json.dumps(counts)}")
    if counts["HGMMA"] == 0 or counts["UTMALDG"] == 0:
        fail(f"the bf16 flash kernel has no wgmma or no TMA tensor load in "
             f"its SASS: {counts}")
    return counts


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
    # float32 products in full float32 (the plain versions and the
    # unembedding are float32 references): no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 0. card
    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # 1. build
    sass = build_all()

    # graphs (host build; the main-path graph is reused by phases 2 and 4)
    g3 = identifier_graph(PHASE3_LOG2V, seed=0)
    g_small = identifier_graph(BITSET_LOG2V, seed=1)
    g4 = identifier_graph(MAIN_LOG2V, seed=3)

    # 2. kernel vs plain on the card
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    checks = []
    for v, k in ((1000, 37), (777, 5), (300, 1), (64, 0), (500, 33),
                 (2000, 200), (1000, 19), (1001, 20), (300, 128),
                 (40, 3000)):
        check_kernel(f"ragged {v}x{k}", *_ragged(v, k, gen), gen, False,
                     checks)
    for v, k, off in ((1000, 19, 3), (500, 129, 5), (40, 3000, 1)):
        nbr, mask, w, _ = _holey(v, k, off, gen)
        check_kernel(f"holes {v}x{k}, rows off 16 B by {off}", nbr, mask, w,
                     gen, False, checks)
    # the main-shape layouts, and the 2^24 one under a seeded permutation
    # of its ids (production ids carry no locality; the identifier
    # graph's small id offsets make its gathers nearly sequential)
    perm_gen = torch.Generator(device="cuda")
    perm_gen.manual_seed(PERMUTATION_SEED)
    perm = torch.randperm(2 ** MAIN_LOG2V, generator=perm_gen,
                          device="cuda").int()
    for label, g in ((f"in-ELL 2^{PHASE3_LOG2V}", g3),
                     (f"in-ELL 2^{MAIN_LOG2V}", g4)):
        ell = in_ell(g)
        check_kernel(label, ell.nbr, ell.mask, ell.w, gen, True, checks)
        if g is g4:
            permuted = permuted_in_ell(ell.nbr, ell.mask, ell.w, perm)
            del ell
            check_kernel(f"{label} permuted ids", *permuted, gen, True,
                         checks)
            del permuted
        else:
            del ell
    torch.cuda.empty_cache()
    check_intersect_rows(checks)
    check_flash(checks)
    for v, k in ((1000, 37), (300, 1), (64, 0), (2000, 200)):
        nbr, mask, w = _ragged(v, k, gen)
        check_combine(f"ragged {v}x{k}", nbr, mask, w,
                      torch.rand(v, generator=gen, device="cuda"), False,
                      checks)
    for v, k, off in ((1000, 7, 3), (4096, 128, 0), (500, 129, 5),
                      (40, 3000, 1)):
        check_combine(f"holes {v}x{k}, rows off 16 B by {off}",
                      *_holey(v, k, off, gen), False, checks)

    # 3-5. the paths; every count is set to 0 just before a path runs
    # and read just after it
    paths = {}
    reset_counts()
    engine_rows, eng3 = engine_phase(g3, g_small)
    paths[f"LocalEngine.run V=2^{PHASE3_LOG2V} and 2^{BITSET_LOG2V}"] = \
        launch_counts()
    breakdown = superstep_breakdown(eng3, engine_rows, checks)
    del eng3
    reset_counts()
    plat, platform_rows = platform_phase(g4)
    paths[f"GraphPlatform.query V=2^{MAIN_LOG2V}"] = launch_counts()
    reset_counts()
    ell, x, outs, spmv_rows = spmv_path(plat, gen)
    paths[f"LocalEngine._spmv V=2^{MAIN_LOG2V}"] = launch_counts()

    # kernel vs plain at the main-path shapes, on the platform's own
    # derived state (launches here are checks, not a path's)
    check_intersect_main(plat.local.oriented, checks,
                         f"OrientedELL 2^{MAIN_LOG2V}")
    from repro_torch.core import graph as G
    src, dst = _host_edges(g4)
    p = perm.cpu().numpy()
    t0 = time.perf_counter()
    o_perm = G.build_oriented_ell(p[src], p[dst], g4.n_vertices)
    log(f"OrientedELL of the permuted ids: host build "
        f"{time.perf_counter() - t0:.1f} s")
    check_intersect_main(o_perm, checks,
                         f"OrientedELL 2^{MAIN_LOG2V} permuted ids")
    del o_perm, src, dst, p, perm
    check_combine(f"capped ELL 2^{MAIN_LOG2V}", ell.nbr, ell.mask, ell.w, x,
                  True, checks, path_out=outs)
    del ell, outs, plat, g3, g4, g_small
    gc.collect()
    torch.cuda.empty_cache()

    # 6. LM serving (the counts are reset inside, just before the path)
    paths[SERVE_PATH], serve_rows = serve_phase()
    must = {f"LocalEngine.run V=2^{PHASE3_LOG2V} and 2^{BITSET_LOG2V}":
                ("pregel_superstep", "ell_intersect"),
            f"GraphPlatform.query V=2^{MAIN_LOG2V}": ("ell_intersect",),
            f"LocalEngine._spmv V=2^{MAIN_LOG2V}": ("ell_combine",),
            SERVE_PATH: ("flash_attention",)}
    for path, names in must.items():
        for name in names:
            if paths[path][name] == 0:
                fail(f"the path {path} never launched {name}")
    log("launches by path " + json.dumps(paths))

    def by_path(name):
        return {p: c[name] for p, c in paths.items()}

    def errs(kernel):
        return max(r["max_abs_err"] for r in checks
                   if r.get("kernel", "pregel_superstep") == kernel)

    step = next(r for r in checks
                if r["layout"] == f"in-ELL 2^{MAIN_LOG2V}"
                and r.get("combo") == "cc")
    step_perm = next(r for r in checks
                     if r["layout"] == f"in-ELL 2^{MAIN_LOG2V} permuted ids"
                     and r.get("combo") == "cc")
    inter = next(r for r in checks
                 if r["layout"] == f"OrientedELL 2^{MAIN_LOG2V}")
    inter_perm = next(r for r in checks if r["layout"] ==
                      f"OrientedELL 2^{MAIN_LOG2V} permuted ids")
    comb = next(r for r in checks
                if r["layout"] == f"capped ELL 2^{MAIN_LOG2V}"
                and r["op"] == "sum")
    attn = next(r for r in checks if r["layout"] == "gemma2-2b global")
    log(json.dumps({"summary": {
        "engine": engine_rows, "superstep_breakdown": breakdown,
        "platform": platform_rows,
        "spmv": spmv_rows, "serve": serve_rows,
        "seconds": time.perf_counter() - t_start}}))
    log(card)
    numbers = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [
        {"name": "pregel_superstep", "route": "cuda",
         "source": "src/repro_torch/kernels/pregel_superstep/csrc/"
                   "superstep.cu",
         "replaces": "src/repro/kernels/pregel_superstep/kernel.py:43",
         "launches": sum(by_path("pregel_superstep").values()),
         "launches_by_path": by_path("pregel_superstep"),
         "max_abs_err": errs("pregel_superstep"),
         **{k: step[k] for k in numbers},
         "permuted_ids": {k: step_perm[k] for k in numbers},
         "shape": f"connected components (int32, msg_src, min) over the "
                  f"V=2^{MAIN_LOG2V} in-ELL, K={step['K']}"},
        {"name": "ell_intersect", "route": "cuda",
         "source": "src/repro_torch/kernels/ell_intersect/csrc/"
                   "intersect.cu",
         "replaces": "src/repro/kernels/ell_intersect/kernel.py:43",
         "launches": sum(by_path("ell_intersect").values()),
         "launches_by_path": by_path("ell_intersect"),
         "max_abs_err": errs("ell_intersect"),
         **{k: inter[k] for k in numbers},
         "full_nbr_bound_ms": inter["full_nbr_bound_ms"],
         "gather_bound_ms": inter["gather_bound_ms"],
         "permuted_ids": {k: inter_perm[k] for k in numbers + ("K",)},
         "library": inter["library"],
         "shape": f"per-edge counts over the V=2^{MAIN_LOG2V} OrientedELL, "
                  f"K={inter['K']}, {inter['padded_edges']} padded edges"},
        {"name": "ell_combine", "route": "cuda",
         "source": "src/repro_torch/kernels/ell_combine/csrc/"
                   "ell_combine.cu",
         "replaces": "src/repro/kernels/ell_combine/kernel.py:37",
         "launches": sum(by_path("ell_combine").values()),
         "launches_by_path": by_path("ell_combine"),
         "max_abs_err": errs("ell_combine"),
         **{k: comb[k] for k in numbers},
         "shape": f"ell_spmv sum (x*w) over the V=2^{MAIN_LOG2V} capped "
                  f"ELL, K={comb['K']}"},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/flash.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:30",
         "launches": sum(by_path("flash_attention").values()),
         "launches_by_path": by_path("flash_attention"),
         "max_abs_err": errs("flash_attention"),
         "rel_err": max(r["rel_err"] for r in checks
                        if r.get("kernel") == "flash_attention"),
         **{k: attn[k] for k in numbers},
         "library": attn["library"],
         "sass": sass,
         "shape": "Gemma-2 2B global layer in prefill: B=2, S=8192, "
                  "Hq/Hkv=8/4, D=256, bf16, causal, softcap 50"}]}))
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
