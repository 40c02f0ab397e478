#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a host with one CUDA card::

    python3 chip_smoke.py

It builds the port's CUDA kernels from the checkout's sources, holds each
against its plain PyTorch version on the card, drives the port's paths
(graph queries through ``LocalEngine.run``, ``LocalEngine.run_batch`` and
``GraphPlatform.query``, the service's fused batches, ``LocalEngine._spmv``,
two-hop, label propagation, HITS, the ETL pipeline, the graph CLI,
Gemma-2 2B serving through ``greedy_generate`` and training through
``make_train_step``, the supervised restart of ``launch/train.py``, and
OLMoE, Hymba, xLSTM, Whisper and PaliGemma serving through
``greedy_generate``)
and checks the answers against host oracles (scipy, numpy), the plain
versions on the card and float32 models; then the distributed engine on
a device mesh (a 1 x 1 NCCL mesh in this process, a 2 x 2 gloo mesh of
four processes on the one card), and the LM on a device mesh (a 1 x 1
NCCL mesh in this process, a 2 x 2 gloo mesh of four processes), and
the dry run's predicted peaks against what phases 6 and 8 measured, and
last the service tier (the incremental catalog, the hybrid-cloud pools,
the runtime and obs, and the calibration fitter) on a 2^22 snapshot.
Phases, in the order they run: 0, 1, 2 (its small checks), 6, 8, 9, 2
(its main-path shapes), 3, 4, 5, 7 (service fusion), 10, 7 (the rest),
11, 12, 13; any failure exits non-zero and prints no result line.  Host
work runs beside the card's phases: a helper process (``--host-work``)
computes the dry run's predictions and HITS's float64 oracle, another
(``--host-graph``) the 2^24 graph's host build (read after phase 9) and
then phase 13's 2^22 one, and a thread phase 5's OrientedELL of permuted
ids and phase 7's LPA and HITS graphs (beside phases 3-10).

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
              seeded permutation of its ids; its CSR entry (the dense
              superstep) on the benchmark's graph500-s21 graph, BFS and
              SSSP, against its plain version and the dense PyTorch path;
              ell_intersect on sorted row pairs (K = 1, 9, 31, 32, 33,
              ragged K, K = 3000, all-sentinel and identical rows) and on
              runs of one eu that cross warps and blocks; ell_spmv
              (ell_combine) on ragged shapes and on masks with holes,
              misaligned rows, clamped ids and inf/NaN behind dead slots;
              flash_attention at the Gemma-2 2B prefill shapes
              (B = 2, S = 8192, GQA 8/4, D = 256, bf16, softcap 50, window
              4096 and 0), SmolLM's (2 x 8192, 15/5, D = 64),
              Granite's (1 x 8192, 32/8, D = 128), OLMoE's (2 x 2048,
              16/16, D = 128), Hymba's (2 x 4096, 25/5, D = 64, window
              1024 and 0), and ragged float32 MQA shapes; the softcap
              rows once more with q scaled by 10, logits at the cap.  min/max and intersection counts
              bit-identical, float sums within rtol 1e-5, attention within
              ``REL_TOL`` of each output's size (|want| plus its row's
              RMS: 1e-2 bf16, 1e-4 float32) and, on unit-normal inputs,
              within 2e-2 (bf16) and 1e-4 (float32) absolute; planted
              faults (softcap dropped, window a tile short, first kv tile
              dropped) must fail that check; pregel_superstep's batched
              entry (state [Vx, B], B = 1, 3, 4, 8, 16, 33, 64, and x
              4 bytes off 16-byte alignment at B = 4, 8, 16;
              min/max/sum, int32/float32) on the ragged and holey
              layouts, and at the fused batches' shapes (B = 16 on the
              2^20 in-ELL, B = 8 on the 2^24 one and on its permuted
              ids); timed with CUDA events
              (median of 10 samples of 10 back-to-back calls; the plain
              versions at the main-path shapes 3 samples of 1) beside
              the bound and, where one PyTorch call computes the same
              function, its time (SDPA: causal, or at Hymba's window a
              boolean band mask over k and v repeated to the query heads;
              none applies a softcap)
  3. engine   on the V = 2^20 identifier graph through ``LocalEngine.run``:
              CC, BFS (4 sources) and SSSP (each to 2048 supersteps) and
              k-core
              (k = 4) with variant dense on the plain engine
              (``use_kernels=False``: PyTorch ops, no kernel), which every
              other run is held to, dense, fused and frontier, and fused
              once more on the plain engine (the plain version on the
              card): byte-equal values, equal iteration counts, the fused
              runs launch pregel_superstep once per superstep and no other
              run launches it, the dense run of CC, BFS and SSSP launches
              the CSR entry once per superstep and no other run launches
              it; triangle counting (intersect: ell_intersect,
              one launch) against scipy and k-core against its peeling
              oracle; on the V = 2^14 graph the bitset variant equals the
              intersect variant equals scipy.  Then (outside the path's
              count) the fused BFS and SSSP once more with CUDA events
              around every pregel_superstep launch call (launch latency
              included: an upper bound of the kernel's share) beside the
              wall time per superstep, and the share of the kernel's
              back-to-back time from phase 2.  Then 16 BFS source sets
              and 16 SSSP sources (64 supersteps), each alone, as one
              ``LocalEngine.run_batch`` (the engine's own variant) and as
              one ``run_superstep(batched_spec(...), variant="fused")``:
              every column byte-equal to its query alone, the batched
              kernel launched once a superstep
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
  7. slice    on the phase-4 platform, 8 batch-tier BFS tickets (64
              supersteps) and 8 Jaccard tickets of 4096 pairs, each kind
              fused into one execution by the service, byte-equal to the
              queries alone and (Jaccard) to a numpy set oracle; two-hop
              on the safety graph (2^20 users, 2^18 identifiers, cap 48)
              against a numpy expansion of the same rows, and its count
              fast path; label propagation at 2^22 (deterministic,
              communities inside scipy's components, card == CPU at
              2^20); HITS on the 2^22 user-follow graph against the
              float64 oracle; a SnapshotStore under ``build/`` through
              ``GraphETL``, a CC query and ``ResultSink`` (store deleted
              after); ``python -m repro_torch.launch.run_graph --job
              two-hop`` as a subprocess on the card
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

  8. train    Gemma-2 2B training at full width (bf16 params over a float32
              master, remat, chunked attention; random weights from seed
              0): 4 steps of batch 2 x 4096 (``SyntheticTokens``, a seeded
              quarter of the labels masked) through ``make_train_step``,
              timed (step ms, tokens/s, peak memory, model TFLOP/s and MFU
              from ``utils/analytic`` over the card's dense bf16 peak);
              every loss and gradient norm finite; no kernel launched;
              step 0's loss against the float32 CE of ``forward()``'s
              logits on the same weights, within limits scaled by the bf16
              model's distance from a float32 model on the same weights,
              with planted faults (the -1 mask ignored, the labels one
              position late) that must land outside; one step at
              microbatches=2 from the same state against microbatches=1
              (gradient norm and updated masters), with a planted fault
              (the second microbatch dropped) that must break a limit.
              Then SmolLM-360M at full width through three
              ``python -m repro_torch.launch.train`` processes at once
              (deterministic kernels, checkpoints under ``build/``,
              deleted after), 32 steps: uninterrupted, failing at step
              25 and restarted from its step-20 checkpoint, and with int8
              gradient compression; the restarted run's final state files
              equal the uninterrupted run's byte for byte, and every run's
              loss falls
 10. mesh     (runs after phase 7's service fusion, on the phase-4
              graph) the distributed engine on a ``DeviceMesh``: (a) a
              1 x 1 NCCL mesh in this process: CC, PageRank, BFS and SSSP
              (64 supersteps) through ``DistributedEngine(coo, mesh=...)``
              and ``GraphPlatform(coo, mesh=...)``, byte-equal to phase
              4's answers (PageRank within PAGERANK_L1_TOL), no kernel
              launched; ms per BFS superstep on the mesh against the
              meshless dense path over the same shard, in turns.  (b) four
              processes (``chip_smoke.py --mesh-rank R``) on a 2 x 2 gloo
              mesh on the one card (NCCL refuses two ranks on one GPU),
              CUDA tensors staged through the host by gloo, layouts (2, 1)
              and (2, 2): CC, PageRank, BFS / SSSP (64 supersteps), LPA,
              k-core and HITS on ``user_follow_graph(2**20, 5.0, seed=3)``
              (symmetrized for CC, LPA, k-core), bitset triangles at 2^14,
              each against LocalEngine on the card (exact answers
              byte-equal, PageRank within 1e-6, HITS within 1e-4), no
              kernel launched, and a planted fault (one rank's data shard
              without edges) that must show; then 10 service tickets (4 BFS
              and 4 SSSP fused, 2 CC) through ``submit`` and
              ``drain(workers=1)`` on the (2, 2) mesh, rank 1 with planted
              divergences (another interactive threshold, its queues
              reversed): every rank's execution log rank 0's, answers
              byte-equal to LocalEngine's (the check must see another
              ticket's answer), ``drain(workers=2)`` refused; its times
              check wiring and are not a multi-card measure.  Every
              process group has a 120 s timeout
  9. families the other LM families at full width, one model at a time
              (bf16 activations over float32 masters from seed 0, freed
              before the next), each through ``greedy_generate`` with 2
              prompts and 16 generated tokens: OLMoE-1B-7B (2048 tokens),
              Hymba-1.5B (2048, past its 1024 window), xLSTM-125M (512),
              Whisper-large-v3 (1500 audio frames, 224 tokens) and
              PaliGemma-3B (256 patches, 512 tokens); flash_attention
              launched once per layer in the OLMoE and Hymba prefills and
              never elsewhere; the last logits against a float32 model on
              the same weights and, for OLMoE and Hymba, the plain
              attention's, within phase 6's noise-scaled limits, with a
              planted fault (a window a kv tile short) they must reject;
              xLSTM, Whisper and PaliGemma within limits of twice their
              own distance from float32, with planted faults (xLSTM's
              state reset before the last 8 tokens, Whisper's cross
              attention causal, PaliGemma's image prefix causal) above
              them;
              MoE's share of dropped (token, choice) pairs at capacity
              1.25; ``decode_step`` at position S against ``forward`` over
              S + 1 tokens (MoE at capacity 100, as the reference's test),
              with a planted fault (one position late; PaliGemma's prefix
              left out of the index; xLSTM's state reset), and
              PaliGemma's once more on the float32 model within the
              reference's 2e-3, where one position late must show;
              prefill and decode times, tokens/s, peak memory, flash's
              device time in the prefill
 11. lm mesh  (after 7) the LM on a ``DeviceMesh``: (a) a 1 x 1 NCCL mesh
              in this process at full width and depth: Gemma-2 2B served
              with the params placed by ``param_spec`` and the cache by
              ``cache_spec`` (phase 6's first request: the same greedy
              tokens, the last logits within phase 6's limits, 26 flash
              launches a prefill and none a decode step), and two train
              steps with ``dp_spec``, ``grad_spec = param_spec()`` and the
              state laid out by ``state_spec`` against phase 8's first
              two (the loss within its noises, grad_norm within 1e-2, the
              masters within 0.1 lr), with a planted fault (gradients
              halved) that must break a limit; ms a prefill, a decode
              step and a train step beside the meshless ones.  (b) four
              processes (``chip_smoke.py --lm-mesh-rank R``) on a 2 x 2
              gloo mesh on the one card: Gemma-2 2B at full width, 4
              layers, FSDP, 2 steps of 4 x 1024 at microbatches 1 (and
              1 at 2) against rank 0's meshless steps on the same weights
              and batches, then a step with a planted fault (each
              gradient block reduced twice); SmolLM-360M (2 layers)
              checkpointed from the (2, 2) state and restored onto (4, 1)
              and onto no mesh, byte-equal;
              Granite-8B at full width, 2 layers, a ring prefill of 2 x
              8192 over "model" against each rank's meshless chunked
              prefill (last logits and the last layer's k cache by halves
              of the sequence, within twice the bf16 run's distance from
              float32), with a planted fault (the ring without its query
              offset) that must break the second half alone; Gemma-2 2B's
              step 2 again under ``act_spec = P("data", "model", None)``
              (its own peak beside the plain step's) and Granite-8B's ring
              train step (2 layers, 2 x 2048) against rank 0's meshless
              steps (phase 8's limits), each with a planted fault (the
              layer gather's gradient sliced; the ring output's gradient
              summed); no kernel launched; peaks a rank.  Every process
              group has a 300 s timeout
 12. dry run  the dry run (``launch/dryrun.py``: one rank, meta tensors,
              computed by the host-work helper) of phase 8's train step
              and phase 6's first prefill: the predicted peak within 15 %
              of the measured one, and a planted fault (the optimizer
              state, the parameters left out of the count) outside it
 13. service  (last) the service tier on ``user_follow_graph(2**22, 4.0,
              seed=5)``, symmetrized (about 3.4e7 directed edges; host
              build in the graph helper): (a) the incremental catalog:
              CC, BFS and SSSP from the top-degree vertex, k-core (k = 4)
              and PageRank cold on version 0, then an add-only delta of
              0.1 % and one of 1 % of the edge set (drawn as
              ``fig_incremental``'s ``_delta_edges``, seed 23) and a 0.1 %
              removal: CC, BFS, SSSP repaired ("incremental"), PageRank
              warm-started (fewer supersteps than cold on the 0.1 %
              delta), k-core cold on the additions and repaired on the
              removal, each against a cold engine run on the same
              version in the variant the service reports it ran
              (byte-equal; PageRank L1 < 1e-4); three seeded calls
              traced (cProfile and torch.profiler); ``as_of=0``
              returns version 0's bytes and ``metrics()["incremental"]``
              counts 7 repairs and 2 warm starts; planted faults: a label
              changed, a repair seeded from the wrong parent.  (b)
              ``default_pools()`` (both pools alias the card), the
              snapshot resident on onprem: the first ticket placed on
              cloud moves the snapshot's bytes once (``TransferLedger``)
              and makes cloud resident; a batch queue past its capacity
              spills to onprem; cloud marked unhealthy bumps the
              generation, re-costs the cached plan and fails later
              tickets over to onprem; every ticket's bytes equal the
              engine's alone; after a delta the failover answers the new
              version; planted faults: the ledger entry dropped, the old
              pool's cached bytes.  (c) a planted transient failure (the
              first call raises) retried to the same bytes,
              ``Backpressure`` at the batch tier's depth, every numeric
              leaf of ``metrics()`` parsed back from ``metrics_text()``
              under its documented name (but the bucket names that
              collide, ROADMAP.md §3), and the ``PlanAccuracyMeter``'s
              calibration samples (as many as ``metrics()`` counts)
              through ``fit_profile``.  (d) ``launch/calibrate.py``'s
              ``main`` in this process at ``--scales 2**18 --repeats 1``
              into ``build/`` (deleted after): loaded (the generation
              bumps), round-tripped through JSON, printed beside the
              checked-in profile; its triangle runs must launch
              ell_intersect.  Launches counted per sub-phase

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

import collections
import contextlib
import dataclasses
import gc
import json
import math
import re
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
# algorithms whose dense supersteps go through pregel_superstep's CSR
# entry on the card (min/max programs; k-core sums)
CSR_ALGOS = ("connected_components", "bfs", "sssp")
CSR_CONFIG = ROOT / "bench" / "configs" / "graph500-s21.json"
CSR_SEED = 2147481101      # the graph500-s21 check's label permutation
CSR_LAYOUT = "graph500-s21 CSR"
BFS_HOPS = 64              # superstep bound of the phase-4 BFS/SSSP queries
# superstep bounds of phase 3's BFS and SSSP (uncapped they run 14,528 and
# 67,651 supersteps on the ring lattice, SSSP 141 s over its five runs);
# every variant still runs the same supersteps and is compared byte for
# byte.  2048 each (4096 until phase 11 came; SSSP 8192 and BFS uncapped
# until phase 10)
PHASE3_BFS_ITERS = 2048
PHASE3_SSSP_ITERS = 2048
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense
PERMUTATION_SEED = 16      # the permuted-id copies of the 2^24 graph
PAGERANK_HALT_L1 = 1e-5    # PageRank halts when an iteration moves < this
PAGERANK_L1_TOL = 1e-4
BATCH_WIDTH = 16           # phase-3 batches: BFS source sets, SSSP sources
RUN_BATCH_PATH = f"LocalEngine.run_batch V=2^{PHASE3_LOG2V}"
FORCED_BATCH_PATH = (f"LocalEngine.run_superstep(batched_spec, 'fused') "
                     f"V=2^{PHASE3_LOG2V}")
SERVICE_TICKETS = 8        # phase-7 service fusion: tickets of each kind
# widths of phase 2's batched checks on small layouts: one column, columns
# that are not 4-column groups, 4-column groups, past one pass of 32
BATCHED_WIDTHS = (1, 3, 4, 8, 16, 33, 64)
JACCARD_PAIRS = 4096       # pairs in one Jaccard ticket
TWO_HOP_USERS_LOG2 = 20    # the safety graph: 2^20 users,
TWO_HOP_IDS_LOG2 = 18      # 2^18 identifiers,
TWO_HOP_CAP = 48           # hubs of 48 users, MaxAdjacentNodes 48
SLICE_LOG2V = 22           # label propagation and HITS graphs
LPA_CPU_ITERS = 2          # supersteps of the card-vs-CPU LPA check
                           # (5, 25-29 s on the CPU, until phase 11 came)
HITS_ATOL = 1e-4           # tests/test_hits.py's tolerance
# phase 7's HITS at 2^22 and its float64 oracle stop at this many
# supersteps (they ran to convergence, 42, until phase 11 came; the
# oracle then took 86-137 s of the card host's time): both follow the
# same schedule, so the check compares the same iterate
HITS_MAX_ITERS = 20
HITS_REL_L2 = 1e-2         # relative L2 distance to the float64 oracle
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
            and torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                            b.contiguous().reshape(-1).view(torch.uint8)))


def max_abs_err(a, b) -> float:
    import torch
    a, b = a.double(), b.double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(fin, torch.isfinite(a)) or \
            not torch.equal(a[~fin], b[~fin]):
        return float("inf")
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def identifier_graph(log2v: int, seed: int, device=None):
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
    coo = G.build_coo(src, dst, V, w=w, symmetrize=True, device=device)
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


def _bound(mask, prog_reads_w, x, out, program_adds):
    """Least time for the call on the card: bytes over memory rate vs
    operations over the float32 rate; the larger bounds it.  What this
    data needs: the mask in full (it decides which slots are live), nbr
    and, for the programs that read it, w at the live slots only, x and
    the output once; one operation per live slot and column (two with an
    add).  State [Vx, B] and output [V, B] count B columns."""
    v, k = mask.shape
    live = int(mask.sum())
    cols = out.numel() // max(v, 1)
    nbytes = v * k + live * (4 + (4 if prog_reads_w else 0)) \
        + x.element_size() * x.numel() + out.element_size() * out.numel()
    ops = live * cols * (2 if program_adds else 1)
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
            bound, by = _bound(mask, reads_w, x, got,
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


def _batched_combos():
    """The 1-D combos and, for the batched entry, max over int32 ids and
    over float32 distances."""
    import numpy as np
    from repro_torch.kernels.pregel_superstep import ops
    imax = int(np.iinfo(np.int32).max)
    return _combos() + [
        ("cc_max", "int32", ops.msg_src, "max", None, -imax - 1),
        ("sssp_max", "float32", ops.msg_src_plus_w, "max", None,
         -float("inf")),
    ]


def _misaligned(x):
    """A contiguous copy of ``x`` that starts 4 bytes past a 16-byte
    boundary (a view at an odd offset)."""
    import torch
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    if view.data_ptr() % 16 != 4 or not view.is_contiguous():
        fail("could not make a view 4 bytes off 16-byte alignment")
    return view


def check_batched(label, nbr, mask, w, gen, widths, timed, results,
                  names=None, misaligned=False):
    """pregel_superstep's [Vx, B] entry (``pregel_superstep_batched``, the
    fused batch of B queries) vs the plain version on one layout, for
    each width B: min/max and int32 sums bit-identical, float sums within
    rtol 1e-5.  ``misaligned``: x is a view 4 bytes off 16-byte alignment
    (the entry's 4-byte loads)."""
    import torch
    from repro_torch.core.pregel import Lifted
    from repro_torch.kernels.pregel_superstep import ops
    from repro_torch.kernels.pregel_superstep.ref import superstep_plain
    V, K = nbr.shape
    for b in widths:
        for name, _, msg, op, md, ident in _batched_combos():
            if names is not None and name not in names:
                continue
            kind = {"cc_max": "cc", "sssp_max": "sssp"}.get(name, name)
            x = torch.stack([_state(kind, V, gen) for _ in range(b)],
                            dim=1).contiguous()
            if misaligned:
                x = _misaligned(x)
            kw = dict(message=Lifted(msg, (-1, None)), op=op,
                      identity=ident, message_dtype=md)
            got = ops.fused_superstep(nbr, mask, w, x, **kw)
            torch.cuda.synchronize()
            want = _plain_by_rows(superstep_plain, nbr, mask, w, x, **kw)
            if op == "sum" and got.dtype != torch.int32:
                ok = got.dtype == want.dtype and torch.allclose(
                    got, want, rtol=1e-5, atol=0.0)
            else:
                ok = bits_equal(got, want)
            row = {"kernel": "pregel_superstep_batched", "layout": label,
                   "combo": name, "V": V, "K": K, "B": b, "ok": bool(ok),
                   "max_abs_err": max_abs_err(got, want)}
            if misaligned:
                row["x_offset_bytes"] = x.data_ptr() % 16
            if timed:
                reads_w = msg in (ops.msg_src_plus_w, ops.msg_src_times_w)
                bound, by = _bound(mask, reads_w, x, got,
                                   msg is not ops.msg_src)
                row.update(
                    ms=cuda_ms(lambda: ops.fused_superstep(nbr, mask, w, x,
                                                           **kw)),
                    plain_ms=cuda_ms(lambda: _plain_by_rows(
                        superstep_plain, nbr, mask, w, x, **kw),
                                     reps=3, calls=1, warmup=1),
                    bound_ms=bound, bound_by=by, library_ms=None,
                    library="n/a: no single PyTorch call gathers x[nbr] "
                            "rows, applies the edge program and reduces "
                            "each masked ELL row per column")
            results.append(row)
            log("kernel " + json.dumps(row))
            if not ok:
                fail(f"the batched kernel disagrees with its plain version: "
                     f"{row}")
            del x, got, want


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


def _plain_by_rows(fn, nbr, mask, w, x, rows=1 << 21, **kw):
    """The plain version over row blocks (rows are independent), so its
    [V, K] (or [V, K, B]) temporaries stay a few GB at the main-path
    shapes."""
    import torch
    return torch.cat([fn(nbr[i:i + rows], mask[i:i + rows], w[i:i + rows],
                         x, **kw) for i in range(0, nbr.shape[0], rows)])


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


def check_csr_main(gen, results):
    """pregel_superstep's CSR entry at the main path's shape, the
    benchmark's graph500-s21 graph (Kronecker scale 21, edge factor 16,
    symmetrized and weighted, as ``bench/run.py`` builds it; labels
    permuted by CSR_SEED), through the layout the dense path reads
    (``LocalEngine.sharded.csr_index()``): BFS (x + 1) and SSSP (x + w)
    under min on float32 state with 40 % inf, bit-identical to the plain
    version on the card (``csr_superstep_plain``) and to the dense
    PyTorch path it replaces (gather, message, ``_local_combine``), and a
    planted fault (one source's state lowered) must show.  Timed: the
    kernel, the plain version and the PyTorch path, beside the byte
    bound (each edge's 4-byte id and, for SSSP, its 4-byte weight, the
    row offsets and the output once)."""
    import torch
    from bench.run import make_graph
    from repro_torch.core import pregel
    from repro_torch.core.engines import LocalEngine
    from repro_torch.kernels.pregel_superstep import ops
    from repro_torch.kernels.pregel_superstep.ref import csr_superstep_plain
    cfg = json.loads(CSR_CONFIG.read_text())
    t0 = time.perf_counter()
    _, coo = make_graph(cfg, CSR_SEED, "cuda")
    sg = LocalEngine(coo).sharded
    lay = sg.csr_index()
    torch.cuda.synchronize()
    V = sg.n_vertices
    nnz = int(lay.rowptr[-1])
    log(f"graph500-s21: V={V}, {nnz} directed edges, {len(lay.tiles) - 1} "
        f"tiles, built in {time.perf_counter() - t0:.1f} s")
    src_idx = sg.gather_index("src", V)
    seg = sg.combine_index()
    x = torch.rand(V, generator=gen, device="cuda") * 10
    x[torch.rand(V, generator=gen, device="cuda") < 0.4] = float("inf")
    hub = int(torch.argmax(lay.rowptr.diff()))
    for name, msg, reads_w in (("bfs", ops.msg_src_plus_one, False),
                               ("sssp", ops.msg_src_plus_w, True)):
        kw = dict(message=msg, op="min", identity=float("inf"))

        def kernel(state=x):
            return ops.csr_superstep(lay, sg.src, sg.w, state, **kw)

        def plain():
            return csr_superstep_plain(lay.rowptr, sg.src, sg.w, x, **kw)

        def path():
            return pregel._local_combine(msg(x.index_select(0, src_idx),
                                             sg.w), seg, V, "min",
                                         float("inf"))
        got = kernel()
        want, via_path = plain(), path()
        torch.cuda.synchronize()
        ok = bits_equal(got, want) and bits_equal(got, via_path)
        # the fault: the hub's first source reads a state below every
        # other, so the hub's row must change
        bad = x.clone()
        bad[sg.src[int(lay.rowptr[hub])].long()] = -1.0
        fault_seen = not bits_equal(kernel(bad), want)
        nbytes = nnz * (8 if reads_w else 4) + (V + 1) * 4 + V * 4
        row = {"kernel": "pregel_superstep_csr", "layout": CSR_LAYOUT,
               "combo": name, "V": V, "edges": nnz, "ok": bool(ok),
               "fault_seen": fault_seen,
               "max_abs_err": max(max_abs_err(got, want),
                                  max_abs_err(got, via_path)),
               "ms": cuda_ms(kernel),
               "plain_ms": cuda_ms(plain, reps=3, calls=1),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes",
               "library_ms": cuda_ms(path, reps=3, calls=1),
               "library": "the dense PyTorch path: index_select, message, "
                          "scatter_reduce"}
        results.append(row)
        log("kernel " + json.dumps(row))
        if not ok:
            fail(f"the CSR entry disagrees with its plain version or the "
                 f"PyTorch path: {row}")
        if not fault_seen:
            fail(f"the CSR check cannot see a lowered source state: {row}")
    del sg, lay, src_idx, seg, coo, x


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
        want = _plain_by_rows(ell_combine_plain, nbr, mask, w, x, op=op)
        if op == "sum":
            ok = torch.allclose(got, want, rtol=1e-5, atol=0.0)
        else:
            ok = bits_equal(got, want)
        if path_out is not None:
            ok = ok and bits_equal(path_out[op], got)
        row = {"kernel": "ell_combine", "layout": label, "op": op, "V": V,
               "K": K, "ok": bool(ok), "max_abs_err": max_abs_err(got, want)}
        if timed:
            bound, by = _bound(mask, op == "sum", x, got, op == "sum")
            row.update(
                ms=cuda_ms(lambda: cops.ell_spmv(nbr, mask, w, x, op=op)),
                plain_ms=cuda_ms(lambda: _plain_by_rows(
                    ell_combine_plain, nbr, mask, w, x, op=op), reps=3,
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


# (label, B, Hq, Hkv, S, D, dtype, options, the SDPA call that computes
#  the same: "causal" (is_causal), "band" (a boolean mask of the causal
#  window) or None, q scale).  Unit-normal q, k, v give scaled logits of
#  about N(0, 1), which a softcap of 50 moves by under 0.02; the "at the
#  cap" rows scale q by 10 (logits of std 10, up to about 50), where it
#  bends them hard.
FLASH_SHAPES = [
    ("gemma2-2b local", 2, 8, 4, 8192, 256, "bfloat16",
     dict(causal=True, window=4096, softcap=50.0), None, 1.0),
    ("gemma2-2b global", 2, 8, 4, 8192, 256, "bfloat16",
     dict(causal=True, softcap=50.0), None, 1.0),
    ("gemma2-2b local, logits at the cap", 2, 8, 4, 8192, 256, "bfloat16",
     dict(causal=True, window=4096, softcap=50.0), None, 10.0),
    ("gemma2-2b global, logits at the cap", 2, 8, 4, 8192, 256, "bfloat16",
     dict(causal=True, softcap=50.0), None, 10.0),
    ("smollm-360m", 2, 15, 5, 8192, 64, "bfloat16", dict(causal=True),
     "causal", 1.0),
    ("granite-8b", 1, 32, 8, 8192, 128, "bfloat16", dict(causal=True),
     "causal", 1.0),
    ("olmoe-1b-7b", 2, 16, 16, 2048, 128, "bfloat16", dict(causal=True),
     "causal", 1.0),
    ("hymba-1.5b local", 2, 25, 5, 4096, 64, "bfloat16",
     dict(causal=True, window=1024), "band", 1.0),
    ("hymba-1.5b global", 2, 25, 5, 4096, 64, "bfloat16", dict(causal=True),
     "causal", 1.0),
    ("ragged MQA causal", 1, 8, 1, 1000, 32, "float32", dict(causal=True),
     None, 1.0),
    ("ragged MQA", 1, 8, 1, 1000, 32, "float32", dict(causal=False), None,
     1.0),
    ("ragged MQA window", 3, 8, 1, 77, 64, "float32",
     dict(causal=True, window=5), None, 1.0),
    ("ragged MQA softcap, logits at the cap", 2, 8, 1, 1000, 64, "float32",
     dict(causal=True, window=300, softcap=50.0), None, 10.0),
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
        if sdpa == "causal":
            def lib():
                return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)
            row["library"] = ("F.scaled_dot_product_attention(is_causal="
                              "True, enable_gqa=True)")
        elif sdpa == "band":
            # the window as a boolean [S, S] mask, and k, v repeated to the
            # query heads, both made outside the timing
            i = torch.arange(s, device="cuda")
            band = (i[None] <= i[:, None]) & (i[None] > i[:, None]
                                               - kw["window"])
            kr, vr = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))

            def lib():
                return F.scaled_dot_product_attention(q, kr, vr,
                                                      attn_mask=band)
            row["library"] = ("F.scaled_dot_product_attention(attn_mask="
                              "the causal window as a bool [S, S] band) on "
                              "k, v repeated to the query heads")
        elif kw.get("softcap"):
            row["library"] = ("n/a: no single PyTorch call applies a logit "
                              "softcap")
        else:
            row["library"] = "not timed (a check shape, not a path's)"
        if sdpa:
            lerr = max_abs_err(lib().float(), got.float())
            if not lerr <= FLASH_TOL[dtype]:
                fail(f"SDPA disagrees with the kernel at {label}: {lerr}")
            row["library_ms"] = cuda_ms(lib)
            row["library_max_abs_err"] = lerr
            del lib
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
    """Launches per kernel; ``pregel_superstep`` counts both of its ELL
    entries, ``pregel_superstep_batched`` the [Vx, B] entry alone,
    ``pregel_superstep_csr`` the dense superstep's CSR entry (in neither
    of the other two)."""
    mods = _ops_modules()
    counts = {n: m.KERNEL_LAUNCHES for n, m in mods.items()}
    counts["pregel_superstep_batched"] = \
        mods["pregel_superstep"].BATCHED_LAUNCHES
    counts["pregel_superstep_csr"] = mods["pregel_superstep"].CSR_LAUNCHES
    return counts


def reset_counts() -> None:
    for m in _ops_modules().values():
        m.KERNEL_LAUNCHES = 0
    _ops_modules()["pregel_superstep"].BATCHED_LAUNCHES = 0
    _ops_modules()["pregel_superstep"].CSR_LAUNCHES = 0


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
                         ("bfs", {"sources": sources,
                                  "max_iters": PHASE3_BFS_ITERS}),
                         ("sssp", {"source": V // 3,
                                   "max_iters": PHASE3_SSSP_ITERS}),
                         ("k_core", {"k": KCORE_K})):
        base = None
        # the plain engine's dense run (PyTorch ops, no kernel) is what
        # every other run is held to
        for label, e, variant in (("dense_plain", plain, "dense"),
                                  ("dense", eng, "dense"),
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
            n_csr = launched["pregel_superstep_csr"]
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
            # the dense variant of a min/max program goes through the CSR
            # entry once a superstep; nothing else launches it
            want_csr = r.iterations if label == "dense" \
                and algo in CSR_ALGOS else 0
            if n_csr != want_csr:
                fail(f"{algo}: {label} launched the CSR entry {n_csr} times "
                     f"in {r.iterations} supersteps (want {want_csr})")
            if launched["ell_intersect"] or launched["ell_combine"]:
                fail(f"{algo}: {label} launched another kernel: {launched}")
            val = r.value.contiguous().view(torch.uint8)
            if base is None:
                base = (val, r.iterations, r.value)
            elif not torch.equal(val, base[0]) or r.iterations != base[1]:
                fail(f"{algo}: {label} differs from the plain dense run")
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
                                                   for i in range(4)),
                                  "max_iters": PHASE3_BFS_ITERS}),
                         ("sssp", {"source": V // 3,
                                   "max_iters": PHASE3_SSSP_ITERS})):
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


def batch_phase(eng, paths):
    """Fused batches at 2^20 through ``LocalEngine``: BATCH_WIDTH BFS
    source sets and BATCH_WIDTH SSSP sources (BFS_HOPS supersteps), each
    first alone (``run``), then as one ``run_batch`` under the engine's
    own choice of variant (frontier at this size: it launches no
    kernel), then as one ``run_superstep(batched_spec(...),
    variant="fused")``, which launches the batched kernel once a
    superstep.  Every column byte-equal to its query alone.  The launches
    of the two batched runs go into ``paths`` under RUN_BATCH_PATH and
    FORCED_BATCH_PATH, the counts set to 0 just before each run."""
    import importlib

    import numpy as np
    import torch
    from repro_torch.core.pregel import batched_spec
    TR = importlib.import_module("repro_torch.core.algorithms.traversal")
    V = eng.coo.n_vertices
    rng = np.random.default_rng(17)
    bfs = [{"sources": tuple(int(s) for s in
                             rng.choice(V, 1 + i % 3, replace=False)),
            "max_iters": BFS_HOPS} for i in range(BATCH_WIDTH)]
    sssp = [{"source": int(s), "max_iters": BFS_HOPS}
            for s in rng.choice(V, BATCH_WIDTH, replace=False)]
    rows = []
    for algo, ps, spec in (("bfs", bfs, TR._BFS_SPEC),
                           ("sssp", sssp, TR._SSSP_SPEC)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solo = [eng.run(algo, p) for p in ps]
        torch.cuda.synchronize()
        solo_ms = (time.perf_counter() - t0) * 1e3
        reset_counts()
        t0 = time.perf_counter()
        fused = eng.run_batch(algo, ps)
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) * 1e3
        auto = launch_counts()
        for i, (a, b) in enumerate(zip(solo, fused)):
            if not bits_equal(a.value, b.value):
                fail(f"{algo} run_batch column {i} differs from its query "
                     "alone")
        init = torch.full((V, len(ps)), float("inf"), device=eng.device)
        for b, p in enumerate(ps):
            init[list(p.get("sources", (p.get("source"),))), b] = 0.0
        reset_counts()
        t0 = time.perf_counter()
        dist, iters = eng.run_superstep(batched_spec(spec), init, BFS_HOPS,
                                        variant="fused")
        torch.cuda.synchronize()
        forced_ms = (time.perf_counter() - t0) * 1e3
        forced = launch_counts()
        for path, got in ((RUN_BATCH_PATH, auto), (FORCED_BATCH_PATH, forced)):
            total = paths.setdefault(path, dict.fromkeys(got, 0))
            for name, n in got.items():
                total[name] += n
        if forced["pregel_superstep_batched"] != iters or \
                forced["pregel_superstep"] != iters:
            fail(f"{algo}: the forced fused batch launched {forced} in "
                 f"{iters} supersteps")
        for i, a in enumerate(solo):
            if not bits_equal(a.value, dist[:, i].contiguous()):
                fail(f"{algo}: fused-kernel column {i} differs from its "
                     "query alone")
        row = {"algo": algo, "batch": len(ps), "max_iters": BFS_HOPS,
               "solo_variant": solo[0].meta.get("realized_variant"),
               "solo_ms_total": solo_ms,
               "run_batch_variant": fused[0].meta.get("realized_variant"),
               "run_batch_ms": batch_ms, "run_batch_launches": auto,
               "fused_supersteps": int(iters), "fused_ms": forced_ms,
               "fused_ms_per_superstep": forced_ms / max(int(iters), 1),
               "fused_launches": forced}
        rows.append(row)
        log("batch " + json.dumps(row))
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

def phase4_queries(V: int) -> dict:
    """Phase 4's queries by name, in the order they run (PageRank on the
    unit-weight view); phase 10(a) asks the same of the mesh."""
    from repro_torch.core.query import GraphQuery
    sources = tuple((i * V // 4 + 12345) % V for i in range(4))
    return {
        "cc": GraphQuery.connected_components(),
        "cc_count": GraphQuery.connected_components(count_only=True),
        "pagerank": GraphQuery.pagerank(tol=PAGERANK_HALT_L1 / V),
        "bfs": GraphQuery.bfs(sources, max_iters=BFS_HOPS),
        "sssp": GraphQuery.sssp(V // 3, max_iters=BFS_HOPS),
        "cc_repeat": GraphQuery.connected_components(),
    }


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
    qs = phase4_queries(V)
    sources, sssp_src = qs["bfs"].params["sources"], qs["sssp"].params["source"]
    queries = [(name, unit if name == "pagerank" else plat, q)
               for name, q in qs.items()]
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
    return plat, rows, out


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
        if i == 0:
            first_tokens = tokens           # phase 11 serves them again
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
    # what phase 11 holds its mesh run to: the first request, its tokens,
    # the plain and float32 logits and the times
    ref = {"request": reqs[0], "tokens": first_tokens, "refs": refs,
           "prefill_ms": rows[0]["prefill_ms"],
           "decode_ms_per_step": rows[0]["decode_ms_per_step"]}
    return path_counts, rows, ref


def _param_tree(params):
    import torch
    return {k: _param_tree(v) if isinstance(v, torch.nn.ParameterDict)
            else v.detach() for k, v in params.items()}


# --------------------------------------------------------------- phase 7

def _timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def service_fusion(plat, coo):
    """Batch-tier tickets on the platform's service at 2^24: SERVICE_TICKETS
    BFS queries (BFS_HOPS supersteps) and SERVICE_TICKETS Jaccard queries
    of JACCARD_PAIRS pairs each, each group coalesced into one fused
    execution.  The tier threshold is set to 0 for the submissions (a
    calibration profile, as production would), so every ticket is batch
    work.  Each result byte-equal to its query alone (result cache
    emptied first); Jaccard also equal to a numpy set oracle over the
    capped ELL rows."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import planner as P
    from repro_torch.core.query import GraphQuery
    V = coo.n_vertices
    svc = plat.service
    rng = np.random.default_rng(23)
    bfs = [GraphQuery.bfs(tuple(int(s) for s in rng.choice(V, 2)),
                          max_iters=BFS_HOPS)
           for _ in range(SERVICE_TICKETS)]
    # pairs a few ids apart: the identifier graph links nearby ids, so
    # their neighbourhoods overlap (random pairs would score 0)
    jac = []
    for _ in range(SERVICE_TICKETS):
        u = rng.integers(0, V, JACCARD_PAIRS)
        jac.append(GraphQuery.of("jaccard", u=u,
                                 v=(u + rng.integers(0, 8, u.size)) % V))
    prev = P.active_calibration()
    P.set_calibration(dataclasses.replace(prev, interactive_threshold_s=0.0))
    results, drain_ms = [], {}
    try:
        before_batches = svc.stats["fused_batches"]
        for kind, qs in (("bfs", bfs), ("jaccard", jac)):
            tickets = [svc.submit(plat.GRAPH, q) for q in qs]
            if any(t.tier != "batch" for t in tickets):
                fail("service tickets did not land in the batch tier")
            _, drain_ms[kind] = _timed(svc.drain)
            results += [svc.result(t) for t in tickets]
    finally:
        P.set_calibration(prev)
    fused_batches = svc.stats["fused_batches"] - before_batches
    if fused_batches != 2:
        fail(f"{fused_batches} fused executions for BFS and Jaccard tickets")
    for r in results:
        if r.meta.get("fused", {}).get("batch_size") != SERVICE_TICKETS:
            fail(f"a ticket was not part of a fused batch of "
                 f"{SERVICE_TICKETS}: {r.meta.get('fused')}")
    plat._result_cache.clear()
    solo, solo_ms = [], {"bfs": 0.0, "jaccard": 0.0}
    for kind, q in [("bfs", q) for q in bfs] + [("jaccard", q) for q in jac]:
        r, ms = _timed(lambda: plat.query(q))
        if r.meta.get("cache") == "hit":
            fail("a solo query was served from the result cache")
        solo.append(r)
        solo_ms[kind] += ms
    for i, (a, b) in enumerate(zip(results, solo)):
        if not bits_equal(a.value, b.value):
            fail(f"fused ticket {i} differs from its query alone")
    ell = plat.local.ell
    n_checked = 0
    for q, r in zip(jac, results[SERVICE_TICKETS:]):
        u = torch.as_tensor(np.asarray(q.params["u"]), device=ell.nbr.device)
        v = torch.as_tensor(np.asarray(q.params["v"]), device=ell.nbr.device)
        nu, mu = ell.nbr[u].cpu().numpy(), ell.mask[u].cpu().numpy()
        nv, mv = ell.nbr[v].cpu().numpy(), ell.mask[v].cpu().numpy()
        want = np.zeros(u.shape[0], dtype=np.float32)
        for k in range(u.shape[0]):
            a, b = set(nu[k][mu[k]].tolist()), set(nv[k][mv[k]].tolist())
            inter, union = len(a & b), len(a | b)
            if union:
                want[k] = np.float32(inter) / np.float32(union)
        if r.value.cpu().numpy().tobytes() != want.tobytes():
            fail("fused Jaccard differs from the numpy set oracle")
        n_checked += int((want > 0).sum())
    if n_checked < SERVICE_TICKETS * JACCARD_PAIRS // 4:
        fail(f"the Jaccard check holds only {n_checked} non-zero scores")
    row = {"path": "service fusion", "graph": f"2^{MAIN_LOG2V}",
           "tickets": len(results), "fused_batches": fused_batches,
           "bfs_variant": results[0].meta.get("realized_variant"),
           "fused_drain_ms": drain_ms, "solo_ms_total": solo_ms,
           "fused_over_solo": {k: drain_ms[k] / solo_ms[k] for k in solo_ms},
           "jaccard_nonzero": n_checked}
    log("slice " + json.dumps(row))
    return row


def two_hop_phase():
    """The multi-account two-hop motif through ``GraphPlatform`` on the
    safety graph (2^20 users, 2^18 identifiers, hubs of 48, cap 48):
    distinct pairs against a numpy expansion of the same capped rows, the
    count fast path against sum d(d-1)/2 over exact identifier degrees;
    peak device memory of the expansion and its sort."""
    import numpy as np
    import torch
    from repro_torch.core import graph as G
    from repro_torch.core.query import GraphPlatform, GraphQuery
    from repro_torch.data import synthetic
    n_users, n_ids = 2 ** TWO_HOP_USERS_LOG2, 2 ** TWO_HOP_IDS_LOG2
    t0 = time.perf_counter()
    u, i = synthetic.safety_bipartite_graph(n_users, n_ids,
                                            hub_degree=TWO_HOP_CAP, seed=2)
    V = int(max(u.max(), i.max())) + 1
    coo = G.build_coo(u, i, V)
    build_s = time.perf_counter() - t0
    plat = GraphPlatform(coo, local_max_degree=TWO_HOP_CAP)
    q = GraphQuery.two_hop(n_users=n_users)
    plan = plat.plan(q)
    if plan.engine != "local":
        fail(f"two-hop planned on {plan.engine}: the oracle reads the local "
             "engine's capped rows")
    ell = plat.local.ell
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    r, ms = _timed(lambda: plat.query(q))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pairs, valid, count = r.value
    got = pairs[valid].cpu().numpy().astype(np.int64)
    slots = int(pairs.shape[0])
    del pairs, valid, r
    plat._result_cache.clear()
    torch.cuda.empty_cache()
    got_keys = (got[:, 0] << 32) | got[:, 1]
    nbr, mask = ell.nbr.cpu().numpy(), ell.mask.cpu().numpy()
    deg = mask.sum(axis=1)
    K = nbr.shape[1]
    if not (mask == (np.arange(K)[None, :] < deg[:, None])).all():
        fail("the capped ELL rows are not packed left")
    t0 = time.perf_counter()
    keys = []
    for d in range(2, K + 1):
        rows = np.flatnonzero(deg == d)
        if rows.size == 0:
            continue
        R = nbr[rows, :d].astype(np.int64)
        a, b = np.triu_indices(d, k=1)
        lo, hi = np.minimum(R[:, a], R[:, b]), np.maximum(R[:, a], R[:, b])
        keep = lo != hi
        keys.append((lo[keep] << 32) | hi[keep])
    want = np.unique(np.concatenate(keys))
    oracle_s = time.perf_counter() - t0
    if count != want.size or not np.array_equal(got_keys, want):
        fail(f"two-hop pairs: {count} on the card, {want.size} in numpy's "
             "expansion of the same rows")
    rc, count_ms = _timed(lambda: plat.query(
        GraphQuery.two_hop(n_users=n_users, count_only=True)))
    d = np.bincount(i, minlength=V).astype(np.int64)
    want_count = int((d * (d - 1) // 2).sum())
    if rc.value != want_count:
        fail(f"two-hop count {rc.value} != sum d(d-1)/2 = {want_count}")
    row = {"path": "two-hop", "users": n_users, "identifiers": n_ids,
           "edges": coo.n_edges, "cap": TWO_HOP_CAP, "rows": V,
           "pair_slots": slots, "engine": plan.engine, "pairs": int(count),
           "ms": ms, "max_memory_allocated_gb": peak_gb,
           "memory_before_gb": base_gb, "count_only": want_count,
           "count_ms": count_ms, "max_identifier_degree": int(d.max()),
           "host_build_s": build_s, "oracle_s": oracle_s}
    log("slice " + json.dumps(row))
    return row


def _scipy_components(coo):
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    src, dst = _host_edges(coo)
    V = coo.n_vertices
    _, lab = connected_components(
        csr_matrix((np.ones(src.size), (src, dst)), shape=(V, V)),
        directed=False)
    return lab


class Prebuilt:
    """Host builds of later phases' graphs in a thread beside the card's
    phases (numpy sorts release the GIL): ``get(name)`` waits for one."""

    def __init__(self, builds: dict):
        self._builds = builds
        self._out = {}
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for name, fn in self._builds.items():
            t0 = time.perf_counter()
            try:
                self._out[name] = (fn(), time.perf_counter() - t0)
            except BaseException as e:       # re-raised by get()
                self._out[name] = (e, None)

    def get(self, name: str):
        """``(value, its build's seconds)``."""
        while name not in self._out:
            if not self._thread.is_alive() and name not in self._out:
                fail(f"prebuilt {name}: the build thread ended without it")
            time.sleep(0.2)
        value, secs = self._out.pop(name)
        if secs is None:
            raise value
        return value, secs


def permuted_oriented(coo, perm):
    """The OrientedELL of ``coo`` with its ids relabelled by ``perm``."""
    from repro_torch.core import graph as G
    src, dst = _host_edges(coo)
    p = perm.cpu().numpy()
    return G.build_oriented_ell(p[src], p[dst], coo.n_vertices)


def hits_graph():
    """HITS's user-follow graph at 2^SLICE_LOG2V (mean degree 8): its
    host edges and the COO on the card."""
    from repro_torch.core import graph as G
    from repro_torch.data import synthetic
    V = 2 ** SLICE_LOG2V
    src, dst = synthetic.user_follow_graph(V, 8.0, seed=5)
    return src, dst, G.build_coo(src, dst, V)


def lpa_phase(g20, pre):
    """Label propagation through ``GraphPlatform`` on the symmetrized
    identifier graph at 2^SLICE_LOG2V: two runs give the same bytes, every
    community lies inside one of scipy's components, and the count query
    equals the number of labels; on the 2^20 graph (LPA_CPU_ITERS
    supersteps) the card's labels equal the port's own run on the CPU."""
    import numpy as np
    import torch
    from repro_torch.core.engines import LocalEngine
    from repro_torch.core.query import GraphPlatform, GraphQuery
    coo, _ = pre.get("lpa")
    plat = GraphPlatform(coo)
    q = GraphQuery.label_propagation()
    torch.cuda.reset_peak_memory_stats()
    r1, ms1 = _timed(lambda: plat.query(q))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    plat._result_cache.clear()
    r2, ms2 = _timed(lambda: plat.query(q))
    if not bits_equal(r1.value, r2.value) or r1.iterations != r2.iterations:
        fail("label propagation is not deterministic on the card")
    labels = r1.value.cpu().numpy()
    comp = _scipy_components(coo)
    if not (comp[labels] == comp).all():
        fail("a community crosses a connected component")
    n_comm = int(np.unique(labels).size)
    rc = plat.query(GraphQuery.label_propagation(count_only=True))
    if rc.value != n_comm:
        fail(f"num_communities {rc.value} != {n_comm} labels")
    gpu, cpu = LocalEngine(g20), LocalEngine(g20.to("cpu"), device="cpu")
    params = {"max_iters": LPA_CPU_ITERS}
    a, ms_small = _timed(lambda: gpu.run("label_propagation", params))
    t0 = time.perf_counter()
    b = cpu.run("label_propagation", params)
    cpu_s = time.perf_counter() - t0
    if not bits_equal(a.value.cpu(), b.value) or a.iterations != b.iterations:
        fail("label propagation on the card differs from the CPU at 2^20")
    row = {"path": "label propagation", "graph": f"2^{SLICE_LOG2V}",
           "edges": coo.n_edges, "engine": r1.engine,
           "iterations": r1.iterations, "ms": ms1, "ms_repeat": ms2,
           "ms_per_superstep": ms1 / max(r1.iterations, 1),
           "max_memory_allocated_gb": peak_gb, "communities": n_comm,
           "components": int(np.unique(comp).size),
           "cpu_check": {"graph": f"2^{PHASE3_LOG2V}",
                         "iterations": a.iterations, "card_ms": ms_small,
                         "cpu_s": cpu_s}}
    log("slice " + json.dumps(row))
    return row


def hits_oracle(src, dst, V: int, max_iters: int = 50, tol: float = 1e-6):
    """``hits_reference``'s schedule (simultaneous updates, each half
    renormalised, the tol test each superstep) in float64 over the same
    distinct (src, dst) pairs, its products by scipy's sparse matrices:
    the numpy oracle's bincounts took 86-137 s at 2^22 on the card's
    host."""
    import numpy as np
    import scipy.sparse as sp
    key = np.unique(src.astype(np.int64) * V + dst)
    A = sp.csr_matrix((np.ones(key.size), (key // V, key % V)), shape=(V, V))
    AT = A.T.tocsr()

    def unit(x):
        return x / max(np.linalg.norm(x), 1e-12)
    h = np.full(V, 1.0 / np.sqrt(max(V, 1)))
    a = h.copy()
    iters = 0
    while iters < max_iters:
        nh, na = unit(A @ a), unit(AT @ h)
        iters += 1
        converged = (np.max(np.abs(nh - h), initial=0.0) < tol
                     and np.max(np.abs(na - a), initial=0.0) < tol)
        h, a = nh, na
        if converged:
            break
    return {"hubs": h.astype(np.float32),
            "authorities": a.astype(np.float32)}, iters


def hits_phase(helper, pre):
    """HITS through ``GraphPlatform`` on the user-follow graph at
    2^SLICE_LOG2V (mean degree 8) against ``hits_oracle`` (float64,
    computed by the host-work helper on the same seed's edges) within
    HITS_ATOL, as ``tests/test_hits.py`` holds it, and the relative L2
    distance of each score vector within HITS_REL_L2."""
    import numpy as np
    from repro_torch.core import graph as G
    from repro_torch.core.query import GraphPlatform, GraphQuery
    from repro_torch.data import synthetic
    (src, dst, coo), build_s = pre.get("hits")
    plat = GraphPlatform(coo)
    r, ms = _timed(lambda: plat.query(GraphQuery.of(
        "hits", max_iters=HITS_MAX_ITERS)))
    with np.load(host_work_wait(helper, "hits.npz")) as z:
        want = {k: z[k] for k in ("hubs", "authorities")}
        want_iters, oracle_s = int(z["iters"]), float(z["seconds"])
    errs = {}
    for k in ("hubs", "authorities"):
        got = r.value[k].cpu().numpy().astype(np.float64)
        ref = want[k].astype(np.float64)
        errs[k] = {"max_abs_err": float(np.abs(got - ref).max()),
                   "rel_l2": float(np.linalg.norm(got - ref)
                                   / max(np.linalg.norm(ref), 1e-30)),
                   "max_score": float(ref.max())}
        if not (errs[k]["max_abs_err"] <= HITS_ATOL
                and errs[k]["rel_l2"] <= HITS_REL_L2):
            fail(f"HITS {k} differs from the float64 oracle: {errs[k]}")
    row = {"path": "hits", "graph": f"user-follow 2^{SLICE_LOG2V}",
           "edges": coo.n_edges, "engine": r.engine,
           "iterations": r.iterations, "oracle_iterations": want_iters,
           "ms": ms, "ms_per_superstep": ms / max(r.iterations, 1),
           "errors": errs, "host_build_s": build_s, "oracle_s": oracle_s}
    log("slice " + json.dumps(row))
    return row


def etl_phase():
    """The ETL pipeline on the card: two daily snapshots and a delta
    partition in a ``SnapshotStore`` under ``build/``, resolved and built
    by ``GraphETL`` (symmetrized, capped at 100) into a COO on the card,
    a CC query through ``GraphPlatform`` against scipy, and the labels
    through ``ResultSink`` and back.  The store is deleted after."""
    import shutil

    import numpy as np
    from repro_torch.core.query import GraphPlatform, GraphQuery
    from repro_torch.data import synthetic
    from repro_torch.data.etl import (GraphETL, ResultSink, Snapshot,
                                      SnapshotDelta, SnapshotStore)
    root = ROOT / "build" / "chip_smoke_etl"
    shutil.rmtree(root, ignore_errors=True)
    V = 2 ** PHASE3_LOG2V
    try:
        store = SnapshotStore(str(root / "snapshots"))
        sets = synthetic.identifier_edge_sets(V, n_sets=2, mean_degree=1.5,
                                              seed=6)
        for day, (s, d) in enumerate(sets):
            store.write(Snapshot(f"d{day}", s, d))
        rng = np.random.default_rng(6)
        store.write_delta(SnapshotDelta(
            "d2", "d1", rng.integers(0, V, 5000), rng.integers(0, V, 5000),
            sets[1][0][:5000], sets[1][1][:5000]))
        snaps = [store.resolve("d0"), store.resolve("d2")]
        (coo, ell, report), build_ms = _timed(lambda: GraphETL(
            max_adjacent_nodes=100, symmetrize=True).build(snaps,
                                                           n_vertices=V))
        if coo.device.type != "cuda":
            fail(f"GraphETL built its graph on {coo.device}")
        r, ms = _timed(lambda: GraphPlatform(coo).query(
            GraphQuery.connected_components()))
        lab = _scipy_components(coo)
        first = np.full(lab.max() + 1, V, dtype=np.int64)
        np.minimum.at(first, lab, np.arange(V))
        if not np.array_equal(r.value.cpu().numpy(),
                              first[lab].astype(np.int32)):
            fail("CC of the ETL graph differs from scipy's components")
        sink = ResultSink(str(root / "results"))
        sink.write("cc_labels", {"labels": r.value},
                   {"snapshots": "d0+d2", "hash": report.content_hash})
        arrays, manifest = sink.read("cc_labels")
        if arrays["labels"].tobytes() != r.value.cpu().numpy().tobytes() \
                or manifest["arrays"]["labels"] != [V]:
            fail("ResultSink did not return the labels it was given")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row = {"path": "etl", "snapshots": ["d0", "d2 (delta of d1)"],
           "edges_in": report.n_edges_in, "edges": coo.n_edges,
           "lost_fraction": report.lost_fraction, "etl_ms": build_ms,
           "cc_ms": ms, "components": int(np.unique(lab).size),
           "store_deleted": not root.exists()}
    log("slice " + json.dumps(row))
    return row


def cli_phase():
    """One subprocess of ``python -m repro_torch.launch.run_graph --job
    two-hop`` on the card; its pair count against the same query in this
    process."""
    import os
    import re

    from repro_torch.core import graph as G
    from repro_torch.core.query import GraphPlatform, GraphQuery
    from repro_torch.data import synthetic
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.run_graph",
                          "--job", "two-hop"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"run_graph exited {out.returncode}: {out.stderr[-2000:]}")
    done = [ln for ln in out.stdout.splitlines() if ln.startswith("[done]")]
    m = re.search(r", (\d+)\)$", done[-1]) if done else None
    if not m or "device=cuda" not in done[-1]:
        fail(f"run_graph printed no result on the card: {out.stdout[-2000:]}")
    n = 20_000                              # run_graph's default --vertices
    u, i = synthetic.safety_bipartite_graph(n, n // 4, seed=0)
    coo = G.build_coo(u, i, int(max(u.max(), i.max())) + 1)
    want = GraphPlatform(coo).query(GraphQuery.two_hop(n_users=n)).value[2]
    if int(m.group(1)) != want:
        fail(f"run_graph counted {m.group(1)} pairs, this process {want}")
    row = {"path": "run_graph --job two-hop", "wall_s": wall,
           "pairs": want, "stdout": out.stdout.strip().splitlines()[-2:]}
    log("slice " + json.dumps(row))
    return row


# ------------------------------------------------------------ host work
#
# Work on the host alone, in a helper process (``chip_smoke.py
# --host-work``) started before phase 1 so that it overlaps the card's
# phases: the dry run's predicted peaks (phase 12) and HITS's float64
# oracle (phase 7; 86-137 s at 2^22 on the card's host).  One thread.

HOST_WORK_DIR = ROOT / "build" / "host_work"
HOST_GRAPH_DIR = ROOT / "build" / "host_graph"   # the 2^24 graph's build
HOST_WORK_DEADLINE_S = 900.0
# phase 12: the dry run's predicted peak within DRYRUN_PEAK_TOL of the
# measured one, for phase 8's train step and phase 6's first request
DRYRUN_PEAK_TOL = 0.15


def dryrun_predictions() -> dict:
    """The dry run (``launch/dryrun.py``, one rank, no mesh, meta
    tensors) of phase 8's step and of phase 6's first prefill: the
    predicted peak, by category, and each prediction with a planted
    fault: the optimizer state (train) or the parameters (serve) left
    out of the count."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as D
    b, s, _ = SERVE_BATCHES[0]
    out = {}
    for tag, arch, shape, kw, left_out in (
            ("train", TRAIN_ARCH,
             ShapeSpec("phase8", "train", TRAIN_SEQ, TRAIN_BATCH),
             {"microbatches": 1}, "opt"),
            ("serve", SERVE_ARCH, ShapeSpec("phase6a", "prefill", s, b),
             {"param_dtype": "float32"}, "params")):
        t0 = time.perf_counter()
        program, _ = D.lower_cell(arch, shape, None, **kw)
        got = D.measure(program)
        mem = got["memory"]
        out[tag] = {"shape": [shape.global_batch, shape.seq_len],
                    "peak_gb": mem["peak"] / 1e9,
                    "memory_gb": {k: v / 1e9 for k, v in mem.items()},
                    "fault": f"{left_out} left out of the count",
                    "fault_peak_gb": (mem["peak"] - mem[left_out]) / 1e9,
                    "ops": got["ops"],
                    "seconds": time.perf_counter() - t0}
        del program
    return out


def host_work_main(outdir: str) -> int:
    """``chip_smoke.py --host-work DIR``: the dry run's predictions, then
    HITS's oracle; results to DIR."""
    import numpy as np
    import torch
    from repro_torch.data import synthetic
    torch.set_num_threads(1)
    out = Path(outdir)
    t0 = time.perf_counter()
    pred = dryrun_predictions()
    pred["seconds"] = time.perf_counter() - t0
    with _whole(out / "dryrun.json") as f:
        f.write(json.dumps(pred).encode())
    t0 = time.perf_counter()
    src, dst = synthetic.user_follow_graph(2 ** SLICE_LOG2V, 8.0, seed=5)
    want, iters = hits_oracle(src, dst, 2 ** SLICE_LOG2V,
                              max_iters=HITS_MAX_ITERS)
    with _whole(out / "hits.npz") as f:
        np.savez(f, iters=iters, seconds=time.perf_counter() - t0, **want)
    return 0


@contextlib.contextmanager
def _whole(path: Path):
    """A file that appears under ``path`` only once it is written whole
    (written beside it, then renamed), for a reader that polls."""
    import os
    tmp = path.with_name(path.name + ".part")
    with open(tmp, "wb") as f:
        yield f
    os.replace(tmp, path)


_CHILDREN = []             # helper processes, stopped when main ends


def host_graph_main(outdir: str) -> int:
    """``chip_smoke.py --host-graph DIR``: the main-path graph's host
    build (phases 2-5, 7, 10), to DIR (``g4.pt``, then ``g4.json``), then
    phase 13's (``g13.pt``, ``g13.json``)."""
    import torch
    out = Path(outdir)
    for name, build in (
            ("g4", lambda: identifier_graph(MAIN_LOG2V, seed=3,
                                            device="cpu")),
            ("g13", lambda: service_graph(SERVICE_LOG2V, device="cpu"))):
        t0 = time.perf_counter()
        coo = build()
        with _whole(out / f"{name}.pt") as f:
            torch.save(coo, f)
        del coo
        with _whole(out / f"{name}.json") as f:
            f.write(json.dumps(
                {"seconds": time.perf_counter() - t0}).encode())
    return 0


def host_work_start(flag: str = "--host-work", where: Path = HOST_WORK_DIR):
    import os
    import shutil
    shutil.rmtree(where, ignore_errors=True)
    where.mkdir(parents=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             flag, str(where)], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.where = where
    _CHILDREN.append(proc)
    return proc


def host_work_wait(proc, name: str) -> Path:
    """The helper's result file ``name`` (each written whole, then the
    next), waiting while the helper runs."""
    path = proc.where / name
    deadline = time.monotonic() + HOST_WORK_DEADLINE_S
    while not path.exists() and proc.poll() is None \
            and time.monotonic() < deadline:
        time.sleep(0.5)
    if not path.exists():
        if proc.poll() is None:
            proc.kill()
        o, _ = proc.communicate()
        fail(f"host work ended {proc.returncode} without {name}:\n"
             f"{(o or '')[-3000:]}")
    return path


# -------------------------------------------------------------- phase 10
#
# The distributed engine on a device mesh.  (a) A 1 x 1 NCCL mesh in
# this process, on the phase-4 graph: the mesh path's answers against
# phase 4's, and its ms per superstep beside the meshless dense path's
# (the difference is the path's own collectives and halt reduction).
# (b) A 2 x 2 mesh of four processes on the one card over gloo (NCCL
# refuses two ranks on one GPU), CUDA tensors staged through the host by
# gloo: every collective's wiring on real CUDA tensors, against
# LocalEngine on the card.  Its times are not a multi-card measure.

MESH_TIMEOUT_S = 120.0     # every process group of phase 10
MESH_GLOO_LOG2V = 20       # the four-rank world's user-follow graph
MESH_GLOO_DIR = ROOT / "build" / "mesh_gloo"
MESH_GLOO_WORLD = 4
MESH_GLOO_DEADLINE_S = 300.0
MESH_NCCL_PATH = f"DistributedEngine/GraphPlatform mesh 1x1 NCCL V=2^{MAIN_LOG2V}"
MESH_GLOO_PATH = (f"DistributedEngine mesh 2x2 gloo V=2^{MESH_GLOO_LOG2V} "
                  f"(4 ranks on one card)")
PAGERANK_MESH_ATOL = 1e-6  # tests/test_pregel.py's mesh PageRank
HITS_MESH_ATOL = 1e-4      # tests/test_hits.py's tolerance
# (name, graph, algorithm, params) of the four-rank world; graphs: "d"
# directed, unit weights; "w" directed, weights multiples of 1/4 in
# [1, 4]; "s" symmetrized; "t" the 2^14 one, symmetrized, no self-loops
MESH_GLOO_QUERIES = (
    ("cc", "s", "connected_components", {}),
    ("pagerank", "d", "pagerank", {"max_iters": 30, "tol": 1e-9}),
    ("bfs", "d", "bfs", {"sources": (0, 7), "max_iters": BFS_HOPS}),
    ("sssp", "w", "sssp", {"source": 0, "max_iters": BFS_HOPS}),
    ("lpa", "s", "label_propagation", {"max_iters": 10, "n_channels": 16}),
    ("kcore", "s", "k_core", {"k": 3}),
    ("hits", "d", "hits", {"max_iters": 20, "tol": 1e-6}),
    ("triangles", "t", "triangle_count", {}),
)


# the service's queues on the mesh: (graph, query) of each ticket, in
# submission order; rank MESH_DIVERGENT_RANK plans with another
# interactive threshold and reverses its queues before the drain
MESH_DIVERGENT_RANK = 1


def mesh_service_tickets():
    from repro_torch.core.query import GraphQuery
    sources = (0, 7, 100, 1000)
    return ([("d", GraphQuery.bfs([s], max_iters=BFS_HOPS)) for s in sources]
            + [("w", GraphQuery.sssp(s, max_iters=BFS_HOPS))
               for s in sources]
            + [("s", GraphQuery.of("connected_components")),
               ("t", GraphQuery.of("connected_components"))])


def mesh_gloo_graphs(device):
    """The four-rank world's graphs, from seeds (every rank builds the
    same ones)."""
    import numpy as np
    from repro_torch.core import graph as G
    from repro_torch.data import synthetic
    V = 2 ** MESH_GLOO_LOG2V
    src, dst = synthetic.user_follow_graph(V, 5.0, seed=3)
    w = (1.0 + np.random.default_rng(4).integers(0, 13, src.size) / 4.0
         ).astype(np.float32)
    s14, d14 = synthetic.user_follow_graph(2 ** BITSET_LOG2V, 5.0, seed=3)
    keep = s14 != d14
    return {"d": G.build_coo(src, dst, V, device=device),
            "w": G.build_coo(src, dst, V, w=w, device=device),
            "s": G.build_coo(src, dst, V, symmetrize=True, device=device),
            "t": G.build_coo(s14[keep], d14[keep], 2 ** BITSET_LOG2V,
                             symmetrize=True, device=device)}


def _values(r) -> dict:
    """A query's value as host arrays by field."""
    import numpy as np
    v = r.value
    if isinstance(v, dict):
        return {k: x.cpu().numpy() for k, x in v.items()}
    if isinstance(v, (int, float)):
        return {"value": np.asarray(v)}
    return {"value": v.cpu().numpy()}


def mesh_gloo_rank(rank: int) -> int:
    """One rank of phase 10(b) (``chip_smoke.py --mesh-rank R``)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core.engines import DistributedEngine
    from repro_torch.launch import mesh as M
    mesh = M.make_mesh((2, 2), device_type="cuda", backend="gloo",
                       init_method="file://" + str(MESH_GLOO_DIR / "rdv"),
                       world_size=MESH_GLOO_WORLD, rank=rank,
                       timeout_s=MESH_TIMEOUT_S)
    dev = torch.device("cuda", torch.cuda.current_device())
    gs = mesh_gloo_graphs(dev)
    out, meta = {}, {"rank": rank, "coordinate": list(mesh.get_coordinate()),
                     "device": str(dev), "rows": []}
    reset_counts()
    for nm in (1, 2):
        tag = f"2x{nm}"
        engines = {k: DistributedEngine(g, mesh=mesh, n_model=nm)
                   for k, g in gs.items()}
        for name, gk, algo, params in MESH_GLOO_QUERIES:
            eng = engines[gk]
            variant = "bitset" if algo == "triangle_count" else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = eng.run(algo, params, variant=variant)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for k, v in _values(r).items():
                out[f"{name}/{tag}/{k}"] = v
            meta["rows"].append({"query": name, "layout": tag,
                                 "iterations": r.iterations,
                                 "wall_ms": wall * 1e3,
                                 "realized_variant":
                                     r.meta.get("realized_variant")})
        del engines
    # the service's queues on the mesh: submit, drain(workers=1); rank 1's
    # divergence (every ticket interactive, its queues reversed) must give
    # way to rank (0, 0)'s schedule; drain(workers=2) must raise
    from repro_torch.core.service import GraphAnalyticsService
    svc = GraphAnalyticsService(interactive_threshold_s=(
        1e9 if rank == MESH_DIVERGENT_RANK else 0.0))
    for k in ("d", "w", "s", "t"):
        svc.add_graph(k, gs[k], mesh=mesh, n_data=2, n_model=2,
                      force_engine="distributed")
    tickets = [svc.submit(g, q) for g, q in mesh_service_tickets()]
    if rank == MESH_DIVERGENT_RANK:
        for q in svc._queues.values():
            q.reverse()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc.drain(workers=1)
    torch.cuda.synchronize()
    meta["service"] = {"drain_ms": (time.perf_counter() - t0) * 1e3,
                       "log": [dict(e) for e in svc.execution_log]}
    for i, t in enumerate(tickets):
        for k, v in _values(svc.result(t)).items():
            out[f"service/{i}/{k}"] = v
    try:
        svc.drain(workers=2)
        meta["service"]["threads_refused"] = None
    except ValueError as e:
        meta["service"]["threads_refused"] = str(e)
    del svc, tickets
    meta["launches"] = launch_counts()
    # the planted fault: rank 1 drops its data shard's edges (1-D layout)
    eng = DistributedEngine(gs["s"], mesh=mesh)
    if rank == 1:
        sh = eng.sharded
        eng._sharded = dataclasses.replace(
            sh, dst=torch.full_like(sh.dst, gs["s"].n_vertices),
            _index_cache={})
    out["fault/cc"] = _values(eng.run("connected_components"))["value"]
    torch.cuda.synchronize()
    np.savez(MESH_GLOO_DIR / f"rank{rank}.npz", **out)
    (MESH_GLOO_DIR / f"rank{rank}.json").write_text(json.dumps(meta))
    torch.distributed.destroy_process_group()
    return 0


def mesh_nccl_phase(g4, phase4):
    """Phase 10(a): a 1 x 1 NCCL mesh in this process on the phase-4
    graph, through ``DistributedEngine(coo, mesh=...)`` and
    ``GraphPlatform(coo, mesh=..., force_engine="distributed")``;
    byte-equal to phase 4's answers
    (PageRank within PAGERANK_L1_TOL in L1), no kernel launched; then
    ms per superstep of a 64-superstep BFS on the mesh against the
    meshless dense path over the same shard, in turns."""
    import importlib

    import torch
    from repro_torch.core import graph as G
    from repro_torch.core.engines import DistributedEngine
    from repro_torch.core.pregel import run_pregel
    from repro_torch.core.query import GraphPlatform
    from repro_torch.launch import mesh as M
    rdv = ROOT / "build" / "mesh_nccl_rdv"
    rdv.parent.mkdir(parents=True, exist_ok=True)
    rdv.unlink(missing_ok=True)
    t_phase = time.perf_counter()
    mesh = M.make_mesh((1, 1), device_type="cuda",
                       init_method=f"file://{rdv}", world_size=1, rank=0,
                       timeout_s=MESH_TIMEOUT_S)
    V = g4.n_vertices
    unit = G.GraphCOO(g4.src, g4.dst, (g4.w > 0).to(torch.float32), V,
                      g4.n_edges, g4.symmetric)
    queries = phase4_queries(V)
    rows = []
    reset_counts()
    for via in ("DistributedEngine", "GraphPlatform"):
        if via == "DistributedEngine":
            runners = {"w": DistributedEngine(g4, mesh=mesh),
                       "unit": DistributedEngine(unit, mesh=mesh)}
        else:
            # forced onto the mesh's engine: at one chip the planner
            # routes these to the local engine
            runners = {"w": GraphPlatform(g4, mesh=mesh,
                                          force_engine="distributed"),
                       "unit": GraphPlatform(unit, mesh=mesh,
                                             force_engine="distributed")}
        for name in ("cc", "pagerank", "bfs", "sssp"):
            q = queries[name]
            p = runners["unit" if name == "pagerank" else "w"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = p.run(q.algorithm, q.params) if via == "DistributedEngine" \
                else p.query(q)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            want = phase4[name]
            if name == "pagerank":
                err = float((r.value - want.value).abs().sum())
                ok = err <= PAGERANK_L1_TOL
            else:
                err = max_abs_err(r.value, want.value)
                ok = bits_equal(r.value, want.value)
            if not ok or r.iterations != want.iterations:
                fail(f"mesh 1x1 {via} {name}: differs from phase 4 "
                     f"(error {err}, {r.iterations} against "
                     f"{want.iterations} iterations)")
            row = {"path": via, "query": name, "engine": r.engine,
                   "iterations": r.iterations, "wall_ms": wall * 1e3,
                   "ms_per_superstep": wall * 1e3 / max(r.iterations, 1),
                   "error_vs_phase4": err}
            if via == "GraphPlatform":
                row["plan"] = r.meta["plan"].engine
            log("mesh " + json.dumps(row))
            rows.append(row)
        del runners
    counts = launch_counts()
    if any(counts.values()):
        fail(f"the 1x1 mesh path launched kernels: {counts}")
    # ms per superstep: the same BFS over the same edge shard through
    # run_pregel on the mesh and without it, in turns (host clock,
    # synchronised): the difference is the mesh path's collectives
    TR = importlib.import_module("repro_torch.core.algorithms.traversal")
    sg = DistributedEngine(g4, mesh=mesh).sharded
    init = TR._init_distances(queries["bfs"].params["sources"], sg.n_pad,
                              g4.device)
    run_pregel(TR._BFS_SPEC, sg, init, BFS_HOPS, mesh=mesh)   # warm-up
    turns = []
    for label in ("meshless", "mesh", "mesh", "meshless"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, it = run_pregel(TR._BFS_SPEC, sg, init, BFS_HOPS,
                           mesh=mesh if label == "mesh" else None)
        torch.cuda.synchronize()
        turns.append((label, (time.perf_counter() - t0) * 1e3 / it))
    timing = {"query": "bfs", "supersteps": it,
              "ms_per_superstep": {
                  k: [round(t, 4) for lab, t in turns if lab == k]
                  for k in ("mesh", "meshless")}}
    del sg, init, unit
    torch.distributed.destroy_process_group()
    row = {"rows": rows, "timing": timing,
           "phase_s": time.perf_counter() - t_phase}
    log("mesh nccl " + json.dumps(timing))
    return row, counts


def mesh_gloo_phase():
    """Phase 10(b): four ranks (``chip_smoke.py --mesh-rank R``) on a 2 x 2
    gloo mesh on this card, layouts (2, 1) and (2, 2); while they run,
    this process answers the same queries on LocalEngine on the card.
    Exact answers byte-equal on every rank, PageRank within 1e-6 and
    HITS within 1e-4 (max abs); the planted fault (rank 1's data shard
    without edges) must differ; no rank launched a kernel."""
    import os
    import shutil

    import numpy as np
    import torch
    from repro_torch.core.engines import LocalEngine
    t_phase = time.perf_counter()
    shutil.rmtree(MESH_GLOO_DIR, ignore_errors=True)
    MESH_GLOO_DIR.mkdir(parents=True)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--mesh-rank", str(r)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(MESH_GLOO_WORLD)]
    try:
        gs = mesh_gloo_graphs("cuda")
        want = {}
        for name, gk, algo, params in MESH_GLOO_QUERIES:
            variant = "bitset" if algo == "triangle_count" else None
            r = LocalEngine(gs[gk]).run(algo, params, variant=variant)
            want[name] = (_values(r), r.iterations)
        want_service = [_values(LocalEngine(gs[gk]).run(q.algorithm,
                                                         q.params))
                        for gk, q in mesh_service_tickets()]
        del gs
        deadline = time.monotonic() + MESH_GLOO_DEADLINE_S
        outs = []
        for p in procs:
            o, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
            outs.append(o)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t_phase
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"mesh rank {r} exited {p.returncode}:\n{o[-3000:]}")
    metas, faults, launches = [], [], {}
    for r in range(MESH_GLOO_WORLD):
        with np.load(MESH_GLOO_DIR / f"rank{r}.npz") as z:
            got = dict(z)
        meta = json.loads((MESH_GLOO_DIR / f"rank{r}.json").read_text())
        metas.append(meta)
        for k, c in meta["launches"].items():
            launches[k] = launches.get(k, 0) + c
        for name, _, _, _ in MESH_GLOO_QUERIES:
            vals, iters = want[name]
            for tag in ("2x1", "2x2"):
                for k, v in vals.items():
                    g = got[f"{name}/{tag}/{k}"]
                    if name in ("pagerank", "hits"):
                        tol = PAGERANK_MESH_ATOL if name == "pagerank" \
                            else HITS_MESH_ATOL
                        err = float(np.abs(g.astype(np.float64) - v).max())
                        ok = err <= tol
                    else:
                        ok = g.dtype == v.dtype and g.shape == v.shape \
                            and g.tobytes() == v.tobytes()
                        err = 0.0 if ok else float("inf")
                    if not ok:
                        fail(f"mesh rank {r} {name} {tag} {k}: differs from "
                             f"LocalEngine (error {err})")
                row = next(x for x in meta["rows"] if x["query"] == name
                           and x["layout"] == tag)
                row["max_abs_err"] = err
                # the 2-D layout runs CC without pointer jumping (the
                # reference's rule), so in more supersteps
                same_program = not (name == "cc" and tag == "2x2")
                if name not in ("pagerank", "hits") and same_program and \
                        row["iterations"] != iters:
                    fail(f"mesh rank {r} {name} {tag}: {row['iterations']} "
                         f"supersteps, LocalEngine {iters}")
        faults.append(got["fault/cc"].tobytes()
                      == want["cc"][0]["value"].tobytes())
        for i, vals in enumerate(want_service):
            for k, v in vals.items():
                g = got[f"service/{i}/{k}"]
                if not (g.dtype == v.dtype and g.tobytes() == v.tobytes()):
                    fail(f"mesh rank {r} service ticket {i} {k}: differs "
                         "from LocalEngine")
        if meta["service"]["log"] != metas[0]["service"]["log"]:
            fail(f"mesh rank {r}: its service ran other units than rank "
                 f"(0, 0)'s: {meta['service']['log']}")
        if not meta["service"]["threads_refused"]:
            fail(f"mesh rank {r}: drain(workers=2) ran on the mesh service")
        if r == 0:
            # the check's own planted fault: ticket 0 (BFS from 0) held to
            # ticket 1's answer (BFS from 7) must differ
            service_fault_seen = got["service/0/value"].tobytes() != \
                want_service[1]["value"].tobytes()
    if not service_fault_seen:
        fail("mesh service: the answer check cannot see another ticket's "
             "answer")
    if all(faults):
        fail("the planted fault (rank 1's data shard without edges) was "
             "not seen")
    if any(launches.values()):
        fail(f"the gloo mesh launched kernels: {launches}")
    shutil.rmtree(MESH_GLOO_DIR, ignore_errors=True)
    rows = [dict(x, rank=m["rank"]) for m in metas for x in m["rows"]
            if m["rank"] == 0]
    out = {"rows": rows, "fault_seen_on_ranks":
           [r for r, same in enumerate(faults) if not same],
           "service": {"drain_ms": [m["service"]["drain_ms"] for m in metas],
                       "units": metas[0]["service"]["log"],
                       "divergent_rank": MESH_DIVERGENT_RANK,
                       "answer_fault_seen": service_fault_seen},
           "phase_s": wall,
           "note": "gloo on one card: a wiring check, not a multi-card "
                   "measure"}
    for x in rows:
        log("mesh gloo " + json.dumps(x))
    log(f"mesh gloo: {MESH_GLOO_WORLD} ranks on {metas[0]['device']}, "
        f"fault seen on ranks {out['fault_seen_on_ranks']}, "
        f"{wall:.1f} s")
    return out, launches


# --------------------------------------------------------------- phase 8

TRAIN_ARCH = "gemma2-2b"
TRAIN_PATH = f"DenseLM train {TRAIN_ARCH}"
# train_4k's sequence; its global batch of 256 (a pod's) cut to 2 for one
# card
TRAIN_BATCH, TRAIN_SEQ = 2, 4096
TRAIN_STEPS = 4
TRAIN_SEED = 0
# AdamWConfig's default peak.  launch/train.py's default, 3e-3, suits its
# --reduced models: at full width the first steps move every weight by
# about lr * sign(g), 15 % of a 0.02-scale embedding, and the loss rose
TRAIN_LR = 3e-4
# labels masked (-1) at a seeded quarter of the positions, as padding
# would be: the loss check's planted fault "mask ignored" needs them
TRAIN_MASK_FRACTION = 0.25
# Step 0's loss against the float32 CE of forward()'s logits on the same
# weights and batch: within TRAIN_NOISE_FACTOR noises, a noise being the
# bf16 model's own distance from the float32 model on the same weights
# (the CE of each one's forward logits), read in the same run.  Planted
# faults in the CE (the -1 mask ignored; the labels one position late)
# must land outside.
TRAIN_NOISE_FACTOR = 2.0
# One step at microbatches=2 against microbatches=1 from the same state:
# grad_norm within a relative 1e-2 (bf16 gradients summed in another
# grouping), and the updated masters within a mean |difference| of 0.1
# lr (AdamW's first step moves an element by about lr * sign(g), so this
# is 5 % of the elements flipping sign; only elements with |g| near the
# bf16 rounding of g can).  A planted fault (the second microbatch
# dropped: a step on the first half of the batch) must break a limit.
MB_GNORM_RTOL = 1e-2
MB_UPDATE_TOL = 0.1
BF16_PEAK_FLOPS = 989e12   # H100 SXM dense bf16 (data sheet)
# the restart path: SmolLM-360M at full width through launch/train.py,
# uninterrupted, failing at step 25 (checkpoints every 20 steps), and with
# int8 gradient compression.  From random weights on SyntheticTokens
# (uniform over 49,152 tokens) its loss falls slowly, against a spread of
# a few 1e-2 from step to step: at a peak lr of 3e-4 or more it rose for
# stretches before it fell, at 1e-4 it fell steadily.  So the runs take
# 1e-4 and 32 steps of 4096 tokens (60, failing at 45 after a checkpoint
# at 36, until phase 11 came), and the check compares the means of the
# first and the last RESTART_LOSS_WINDOW steps.
RESTART_ARCH = "smollm-360m"
RESTART_ARGS = ("--steps", "32", "--batch", "8", "--seq", "512",
                "--lr", "1e-4", "--log-every", "1", "--seed", "0",
                "--deterministic")
RESTART_FAIL_AT, RESTART_CKPT_EVERY = 25, 20
RESTART_LOSS_WINDOW = 5


def masked_batch(data, step, gen_seed):
    """``data``'s batch at ``step`` on the card, with a seeded
    TRAIN_MASK_FRACTION of its labels set to -1."""
    import numpy as np
    import torch
    b = data.batch_at(step)
    rng = np.random.default_rng((gen_seed, step))
    b["labels"][rng.random(b["labels"].shape) < TRAIN_MASK_FRACTION] = -1
    return {k: torch.from_numpy(v).cuda() for k, v in b.items()}


def ce_stats(logits, batch, chunk=512):
    """Mean next-token CE from float32 ``logits`` (sums in float64): the
    sound version and the planted faults ``mask ignored`` (every
    position counts, -1 read as token 0) and ``labels one late`` (the
    target at i is the label of i - 1, the input token itself)."""
    import torch
    labels, tokens = batch["labels"].long(), batch["tokens"].long()
    sums = {"sound": 0.0, "mask ignored": 0.0, "labels one late": 0.0}
    counts = dict.fromkeys(sums, 0)
    for j in range(0, logits.shape[1], chunk):
        lg = logits[:, j:j + chunk]
        lab, tok = labels[:, j:j + chunk], tokens[:, j:j + chunk]
        logz = torch.logsumexp(lg, dim=-1)

        def ce(target):
            return logz - lg.gather(-1, target.clamp(min=0)[..., None])[..., 0]
        valid, sound = lab >= 0, ce(lab)
        for name, vals, mask in (
                ("sound", sound, valid),
                ("mask ignored", sound, torch.ones_like(valid)),
                ("labels one late", ce(tok), valid)):
            sums[name] += float(torch.where(mask, vals, 0.0).double().sum())
            counts[name] += int(mask.sum())
    return {k: sums[k] / max(counts[k], 1) for k in sums}


def _host_copy(tree):
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def master_distance(master, host_master, lr):
    """Mean and max |master - host_master| / lr over every element."""
    import torch
    from repro_torch.utils.tree import tree_leaves
    tot, n, top = 0.0, 0, 0.0
    for a, b in zip(tree_leaves(master), tree_leaves(host_master)):
        d = (a - b.to(a.device)).abs_().div_(lr)
        tot += float(d.double().sum())
        n += d.numel()
        top = max(top, float(d.max()))
        del d
    torch.cuda.empty_cache()
    return tot / n, top


def profile_step(step):
    """One more step under ``torch.profiler``: its wall (host clock), the
    CUDA kernels' summed device time and the share of the wall they
    leave idle (one stream, so the kernels do not overlap), and the ten
    kernels with the most device time.  "not measured" where the trace
    holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        return {"profiled_step_ms": wall * 1e3,
                "device_busy_ms": "not measured"}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {"profiled_step_ms": wall * 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1 - busy_us / 1e6 / wall,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:90],
                             "ms": e.self_device_time_total / 1e3,
                             "share": e.self_device_time_total / busy_us,
                             "calls": e.count} for e in top]}


def train_phase(card):
    """Gemma-2 2B training at full width (bf16 params, float32 master,
    remat, chunked attention): 4 steps timed, step 0's loss against the
    float32 CE of ``forward()``, and microbatches=2 against 1."""
    import dataclasses

    import torch
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.models.transformer import DenseLM
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.utils.analytic import cost_cell
    from repro_torch.utils.tree import param_bytes
    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    if not (cfg.dtype == "bfloat16" and cfg.remat
            and cfg.attn_impl == "chunked" and cfg.n_layers == 26):
        fail(f"train: unexpected config {cfg}")
    # launch/train.py's optimizer for --steps 4 --lr TRAIN_LR (no warmup)
    opt_cfg = AdamWConfig(peak_lr=TRAIN_LR,
                          warmup_steps=min(50, TRAIN_STEPS // 5),
                          total_steps=TRAIN_STEPS)
    data = SyntheticTokens(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                           seed=TRAIN_SEED)
    batches = [masked_batch(data, i, TRAIN_SEED) for i in range(TRAIN_STEPS)]

    def fresh_state():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(TRAIN_SEED)
        model = DenseLM(cfg, device="cuda", generator=gen)
        state = init_train_state(model)
        torch.cuda.synchronize()
        return model, state

    t0 = time.perf_counter()
    model, state = fresh_state()
    log(f"train: {cfg.name} state built in {time.perf_counter() - t0:.1f} s: "
        f"{param_bytes(state.params) / 1e9:.2f} GB bf16 params, "
        f"{param_bytes(state.opt) / 1e9:.2f} GB float32 master, m and v")
    # the oracle before step 0 updates the state in place
    ce_bf16 = ce_stats(model.forward(batches[0]), batches[0])
    f32 = DenseLM(dataclasses.replace(cfg, dtype="float32"), device="cuda",
                  params=state.opt["master"])
    ce_f32 = ce_stats(f32.forward(batches[0]), batches[0])["sound"]
    del f32
    torch.cuda.empty_cache()

    # the path: 4 steps; every count 0 just before, read just after
    step_fn = make_train_step(model, opt_cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    walls, metrics = [], []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        m = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        metrics.append(m)
        if i == 0:
            master1 = _host_copy(state.opt["master"])
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if counts["flash_attention"] != 0 or sum(counts.values()):
        fail(f"train: the train steps launched {counts}")
    profile = profile_step(lambda: step_fn(state, batches[0]))
    for i, m in enumerate(metrics):
        if not all(map(math.isfinite, (m["loss"], m["grad_norm"]))):
            fail(f"train: step {i} is not finite: {m}")
    del model, state, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    loss0 = metrics[0]["loss"]
    noise = abs(ce_bf16["sound"] - ce_f32)
    limit = TRAIN_NOISE_FACTOR * noise
    loss_check = {"loss0": loss0, "ce_forward_bf16": ce_bf16["sound"],
                  "ce_forward_f32_model": ce_f32, "noise": noise,
                  "limit": limit,
                  "err": abs(loss0 - ce_bf16["sound"]),
                  "faults": {k: abs(v - loss0) for k, v in ce_bf16.items()
                             if k != "sound"}}
    loss_check["err_over_noise"] = loss_check["err"] / noise
    if not loss_check["err"] <= limit:
        fail(f"train: step 0's loss is off the forward CE: {loss_check}")
    for name, dist in loss_check["faults"].items():
        if not dist > limit:
            fail(f"train: the loss check cannot see a planted fault "
                 f"({name}): {loss_check}")

    # microbatches=2 (and the planted fault, half the batch at mb=1) from
    # the same state as step 0
    mb = {"grad_norm_mb1": metrics[0]["grad_norm"]}
    for name, micro, batch in (
            ("mb2", 2, batches[0]),
            ("fault: second microbatch dropped", 1,
             {k: v[:TRAIN_BATCH // 2] for k, v in batches[0].items()})):
        model, state = fresh_state()
        torch.cuda.reset_peak_memory_stats()
        state, m = make_train_step(model, opt_cfg, microbatches=micro)(
            state, batch)
        step_peak = torch.cuda.max_memory_allocated()
        mean_d, max_d = master_distance(state.opt["master"], master1,
                                        float(m["lr"]))
        rel = abs(float(m["grad_norm"]) - mb["grad_norm_mb1"]) \
            / mb["grad_norm_mb1"]
        mb[name] = {"grad_norm": float(m["grad_norm"]),
                    "grad_norm_rel_diff": rel,
                    "master_mean_abs_diff_over_lr": mean_d,
                    "master_max_abs_diff_over_lr": max_d,
                    "max_memory_allocated_gb": step_peak / 1e9,
                    "rejected": not (rel <= MB_GNORM_RTOL
                                     and mean_d <= MB_UPDATE_TOL)}
        del model, state
        gc.collect()
        torch.cuda.empty_cache()
    if mb["mb2"]["rejected"]:
        fail(f"train: microbatches=2 disagrees with 1: {mb}")
    if not mb["fault: second microbatch dropped"]["rejected"]:
        fail(f"train: the microbatch limits cannot see a planted fault: {mb}")

    step_s = statistics.median(walls[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    cost = cost_cell(cfg, ShapeSpec("train_4k", "train", TRAIN_SEQ,
                                    TRAIN_BATCH), {"data": 1})
    row = {"arch": cfg.name, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "card": card, "step_ms": [w * 1e3 for w in walls],
           "step_ms_median_2_4": step_s * 1e3,
           "tokens_per_s": tokens / step_s,
           "max_memory_allocated_gb": peak / 1e9,
           "analytic_flops_per_step": cost.flops_hlo_equiv,
           "analytic_flops_ideal_per_step": cost.flops_ideal,
           "model_tflops_per_s": cost.flops_hlo_equiv / step_s / 1e12,
           "mfu": cost.flops_hlo_equiv / step_s / BF16_PEAK_FLOPS,
           "mfu_ideal": cost.flops_ideal / step_s / BF16_PEAK_FLOPS,
           "losses": [m["loss"] for m in metrics],
           "grad_norms": [m["grad_norm"] for m in metrics],
           "lr": [m["lr"] for m in metrics], "launches": counts,
           "profile": profile,
           "loss_check": loss_check, "microbatches": mb}
    log("train " + json.dumps(row))
    log(f"train: phase 8(a) took {time.perf_counter() - t_phase:.1f} s")
    # what phase 11 holds its mesh steps to (the masters after step 0 on
    # the host)
    ref = {"opt_cfg": opt_cfg, "batches": batches, "metrics": metrics,
           "master1": master1, "noise": noise,
           "step_ms": [w * 1e3 for w in walls]}
    return counts, row, ref


def _train_cli(root, *extra):
    """``python -m repro_torch.launch.train`` for RESTART_ARCH on the card
    with checkpoints under ``root``, deterministic kernels."""
    import os
    # three such processes share the host's cores with this one
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUBLAS_WORKSPACE_CONFIG=":4096:8", OMP_NUM_THREADS="2")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         RESTART_ARCH, *RESTART_ARGS, "--ckpt-dir", str(root), *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _final_files(root, step):
    d = Path(root) / f"step_{step:08d}"
    return {f.name: f.read_bytes() for f in sorted(d.glob("*.npy"))}


def restart_phase(card):
    """Three launch/train.py processes at once (SmolLM-360M at full
    width): uninterrupted, failing at step RESTART_FAIL_AT, and with int8
    compression.  The interrupted run's final state files equal the
    uninterrupted run's byte for byte, and so does every loss it prints;
    every run's loss falls (the mean of its last RESTART_LOSS_WINDOW
    steps below that of its first)."""
    import shutil
    t0 = time.perf_counter()
    base = ROOT / "build" / "train_restart"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)          # the heartbeat files live here
    steps = int(RESTART_ARGS[RESTART_ARGS.index("--steps") + 1])
    runs = {"uninterrupted": ("--ckpt-every", str(RESTART_CKPT_EVERY)),
            "failed and restarted": ("--ckpt-every", str(RESTART_CKPT_EVERY),
                                     "--simulate-failure-at",
                                     str(RESTART_FAIL_AT)),
            "int8": ("--ckpt-every", str(steps), "--compression", "int8")}
    procs = {}
    try:
        for k, a in runs.items():
            procs[k] = _train_cli(base / k.replace(" ", "_"), *a)
        outs = {}
        for k, p in procs.items():
            out, err = p.communicate(timeout=900)
            if p.returncode != 0:
                fail(f"restart: the {k} run exited {p.returncode}: "
                     f"{err[-3000:]}")
            outs[k] = out
        rows = {}
        for k, out in outs.items():
            lines = out.splitlines()
            # step -> loss; a step run again after the restart overwrites
            by_step = {int(ln.split()[1]): float(ln.split()[3])
                       for ln in lines if ln.startswith("step ")}
            losses = [by_step[i] for i in sorted(by_step)]
            w = RESTART_LOSS_WINDOW
            rows[k] = {"losses": losses,
                       "first_mean": statistics.mean(losses[:w]),
                       "last_mean": statistics.mean(losses[-w:]),
                       "restores": [ln for ln in lines
                                    if ln.startswith("[restore]")],
                       "done": next((ln for ln in lines
                                     if ln.startswith("[done]")), None)}
            if len(losses) != steps or \
                    not rows[k]["last_mean"] < rows[k]["first_mean"]:
                fail(f"restart: the {k} run's loss did not fall: {rows[k]}")
        rec = rows["failed and restarted"]
        want = f"[restore] resumed from step {RESTART_CKPT_EVERY}"
        if rec["restores"] != [want] or "restarts=1" not in (rec["done"]
                                                             or ""):
            fail(f"restart: the failed run did not restart from step "
                 f"{RESTART_CKPT_EVERY}: {rec}")
        if rec["losses"] != rows["uninterrupted"]["losses"]:
            fail("restart: the restarted run printed other losses than the "
                 "uninterrupted run")
        a = _final_files(base / "uninterrupted", steps)
        b = _final_files(base / "failed_and_restarted", steps)
        params = [f for f in a if f.startswith("[<flat index 0>]")]
        row = {"arch": RESTART_ARCH, "args": " ".join(RESTART_ARGS),
               "card": card, "runs": rows, "state_files": len(a),
               "state_bytes": sum(len(v) for v in a.values()),
               "param_files": len(params),
               "params_bit_equal": bool(params) and all(
                   a[f] == b.get(f) for f in params),
               "state_bit_equal": a.keys() == b.keys() and all(
                   a[f] == b[f] for f in a),
               "wall_s": time.perf_counter() - t0}
        log("restart " + json.dumps(row))
        if not (row["params_bit_equal"] and row["state_bit_equal"]):
            fail("restart: the restarted run's final state differs from the "
                 "uninterrupted run's")
        return row
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(base, ignore_errors=True)


# --------------------------------------------------------------- phase 9

# (arch, prompts, prompt tokens, generated tokens, decode-check prompt):
# Hymba's 2048 tokens are past its 1024-token window, so its local layers
# really mask (Hymba's 4096 and xLSTM's 2048 were cut to 2048 and 512
# when phase 11 came, to keep the run under 1000 s); Whisper's prompt is 224 decoder tokens beside its 1500
# audio frames, PaliGemma's 512 text tokens after its 256 patches.  The
# decode check runs 2 prompts of the last length (xLSTM's shorter: its
# time loop runs a step at a time)
FAMILY_RUNS = (("olmoe-1b-7b", 2, 2048, 16, 2048),
               ("hymba-1.5b", 2, 2048, 16, 2048),
               ("xlstm-125m", 2, 512, 16, 512),
               ("whisper-large-v3", 2, 224, 16, 224),
               ("paligemma-3b", 2, 512, 16, 512))
# the reference's decode-vs-forward check raises the MoE capacity factor
# to 100 (``tests/test_models.py``): a decode step's block holds B tokens,
# a prefill's B * S, so at 1.25 the dropped pairs would differ
FAMILY_CHECK_CAPACITY = 100.0
# Families without the kernel: the bf16 run's mean distance from the
# float32 model on the same weights, over the float32 logits' mean
# absolute deviation, at most this: twice each model's reading (0.0727,
# 0.0161, 0.0123 at seed 0 on the H100, the same in every run), as phase
# 6's limits are 2 noises; each model's planted faults
# (``family_faults``) must read above it
FAMILY_F32_REL = {"xlstm-125m": 0.15, "whisper-large-v3": 0.032,
                  "paligemma-3b": 0.025}
# PaliGemma's decode check runs once more on the float32 model, where a
# token decoded one position late shows (in bf16 it moves the logits
# less than the noise: one zero key among 769); the reference's own
# decode-vs-forward tolerance (``tests/test_models.py``), absolute only
F32_DECODE_TOL = 2e-3


def family_path(arch: str) -> str:
    return f"{arch} serve (greedy_generate)"


def moe_drop_share(model, batch, cache_len: int) -> dict:
    """Share of (token, choice) pairs past their expert's capacity in one
    prefill at the config's capacity factor, in all and layer by layer
    (each block's routing counted once more beside the block)."""
    from repro_torch.models import moe
    block = moe.moe_apply_block
    tally = []

    def counted(p, xt, cfg, capacity, group=None):
        keep = moe.route(p, xt, cfg, capacity)[-1]
        tally.append((int((~keep).sum()), keep.numel()))
        return block(p, xt, cfg, capacity, group)
    moe.moe_apply_block = counted
    try:
        model.prefill(batch, cache_len=cache_len)
    finally:
        moe.moe_apply_block = block
    n = len(tally) // model.cfg.n_layers            # blocks a layer
    layers = [tally[i:i + n] for i in range(0, len(tally), n)]
    return {"share": sum(d for d, _ in tally) / sum(t for _, t in tally),
            "by_layer": [sum(d for d, _ in part) / sum(t for _, t in part)
                         for part in layers]}


def f32_rel(logits, ref32, vocab: int) -> float:
    """Mean distance of ``logits`` from the float32 model's over the
    float32 logits' mean absolute deviation (real vocabulary only)."""
    a, r = logits[..., :vocab].double(), ref32[..., :vocab].double()
    return float((a - r).abs().mean()) / float(
        (r - r.mean(dim=-1, keepdim=True)).abs().mean())


def family_faults(model, sibling, batch, cache_len):
    """Planted faults of a family without the kernel, as (name, its
    prefill's last logits): xLSTM's state reset before the last 8
    tokens, Whisper's cross attention masked causally, PaliGemma's image
    prefix masked causally."""
    cfg = model.cfg
    if cfg.family == "ssm":
        return [("state reset before the last 8 tokens",
                 last_logits(model, dict(batch,
                                         tokens=batch["tokens"][:, -8:]),
                             cache_len))]
    if cfg.family == "vlm":
        return [("prefix masked causally",
                 last_logits(sibling(prefix_len=0), batch, cache_len))]
    cross_causal = sibling()
    attend = cross_causal._attend
    cross_causal._attend = lambda q, k, v, qpos, kpos, causal: attend(
        q, k, v, qpos, kpos, causal=causal or k.shape[1] != q.shape[1])
    return [("cross attention causal", last_logits(cross_causal, batch,
                                                   cache_len))]


def family_phase(arch, b, s, g, s_check):
    """One family's model at full width: ``greedy_generate`` (the path,
    counts set to 0 just before and read just after), then the prefill
    alone (the kernel's launches timed inside it) and the decode steps
    alone; the last logits against a float32 model on the same weights
    and, where the flash kernel runs, against the plain attention's, with
    a planted fault the limits must reject (else each model's own limit
    and ``family_faults``); MoE's dropped share; decode at position S
    against forward over S + 1 tokens, with a planted fault (PaliGemma's
    also on the float32 model).  Returns ``(launch counts of the path,
    row)``."""
    import dataclasses

    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import serve
    from repro_torch.models.registry import build_model
    from repro_torch.train.serve_step import greedy_generate
    t_phase = t0 = time.perf_counter()
    model = serve.build(arch, seed=0)
    cfg = model.cfg

    def sibling(use_kernels=True, **changes):
        """The model on the same (shared) master weights, with ``changes``
        to its config."""
        return build_model(dataclasses.replace(cfg, **changes),
                           device=model.device,
                           params=_param_tree(model.params),
                           use_kernels=use_kernels)
    torch.cuda.synchronize()
    full = get_config(arch)
    if cfg.dtype != "bfloat16" or (cfg.n_layers, cfg.d_model) != (
            full.n_layers, full.d_model):
        fail(f"families: unexpected config {cfg}")
    kernel = cfg.attn_impl == "flash"
    want_flash = cfg.n_layers if kernel else 0
    row = {"arch": arch, "family": cfg.family, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "attn_impl": cfg.attn_impl,
           "parameters": sum(p.numel() for p in model.parameters()),
           "build_s": time.perf_counter() - t0, "batch": b, "prompt": s,
           "generated": g, "prefix": cfg.prefix_len,
           "encoder_frames": cfg.encoder_seq}
    batch = serve.prompts(cfg, b, s, seed=b, device=model.device)
    cache_len = s + g + cfg.prefix_len
    start = s + cfg.prefix_len

    # the path: every count 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    tokens = greedy_generate(model, batch, steps=g, cache_len=cache_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    row.update(generate_wall_ms=wall * 1e3, launches=counts,
               generate_tokens_per_s=b * g / wall,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 1e9)
    if tokens.shape != (b, g) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        fail(f"families: {arch} made bad tokens {tuple(tokens.shape)}")
    if counts["flash_attention"] != want_flash or \
            sum(counts.values()) != want_flash:
        fail(f"families: {arch}'s generate launched {counts}, not "
             f"{want_flash} flash launches (one a layer in the prefill)")

    # the prefill alone, the kernel's launches timed inside it
    torch.cuda.synchronize()
    before = launch_counts()
    t0 = time.perf_counter()
    with timed_launches(fops, "flash_attention_fwd") as events:
        logits, cache = model.prefill(batch, cache_len=cache_len)
        torch.cuda.synchronize()
    row["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    if launched_since(before)["flash_attention"] != want_flash or \
            len(events) != want_flash:
        fail(f"families: {arch}'s prefill did not launch the kernel once "
             "a layer")
    row["flash_ms_in_prefill"] = sum(a.elapsed_time(e) for a, e in events)
    row["flash_share_of_prefill"] = (row["flash_ms_in_prefill"]
                                     / row["prefill_ms"])
    # the decode steps alone: no kernel launch in any
    tok = _argmax_tokens(logits)
    seq = [tok]
    before = launch_counts()
    t0 = time.perf_counter()
    for j in range(g - 1):
        lg, cache = model.decode_step(tok, cache, start + j)
        tok = _argmax_tokens(lg)
        seq.append(tok)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (g - 1)
    if sum(launched_since(before).values()):
        fail(f"families: a decode step of {arch} launched a kernel")
    row.update(decode_ms_per_step=step_ms,
               decode_tokens_per_s=b / step_ms * 1e3,
               repeat_tokens_equal=bool(torch.equal(torch.cat(seq, dim=1),
                                                    tokens)))
    del cache, lg

    # accuracy: float32 model on the same weights; the plain attention
    ref32 = last_logits(sibling(use_kernels=False, dtype="float32"), batch,
                        cache_len)
    if kernel:
        plain = last_logits(sibling(use_kernels=False), batch, cache_len)
        acc = serve_accuracy(logits, plain, ref32)
        # planted: the window a kv tile short (Hymba's local layers), or
        # for global attention a window that leaves the first kv tile out
        # of the last query's keys
        short = (cfg.window or s) - FLASH_TILE
        fault = serve_accuracy(last_logits(sibling(window=short), batch,
                                           cache_len), plain, ref32)
        fault.update(fault=f"window {short}", rejected=serve_rejects(fault))
        row.update(accuracy=acc, fault=fault)
        if serve_rejects(acc):
            fail(f"families: {arch}'s logits are out of the limits: {acc}")
        if not fault["rejected"]:
            fail(f"families: the limits cannot see a planted fault in "
                 f"{arch}: {fault}")
        del plain
    else:
        limit = FAMILY_F32_REL[arch]
        acc = {"f32_noise": max_abs_err(logits, ref32),
               "f32_rel": f32_rel(logits, ref32, cfg.vocab_size),
               "f32_rel_limit": limit}
        acc["faults"] = [
            {"fault": name, "f32_rel": f32_rel(lg, ref32, cfg.vocab_size)}
            for name, lg in family_faults(model, sibling, batch, cache_len)]
        row["accuracy"] = acc
    noise = acc["f32_noise"]
    del ref32, logits
    if cfg.family == "moe":
        row["dropped_pairs"] = moe_drop_share(model, batch, cache_len)
        row["capacity_factor"] = cfg.capacity_factor

    # decode at position S against forward over S + 1 tokens
    check = (sibling(capacity_factor=FAMILY_CHECK_CAPACITY)
             if cfg.family == "moe" else model)
    sub = serve.prompts(cfg, 2, s_check, seed=7, device=model.device)
    p = cfg.prefix_len
    last, cache = check.prefill(sub, cache_len=s_check + p + 2)
    nxt = _argmax_tokens(last)
    fwd = check.forward(dict(sub, tokens=torch.cat([sub["tokens"], nxt],
                                                   dim=1)))
    # a planted fault on a copy of the cache: the token decoded one
    # position late; the VLM's decoded at its text position, the image
    # prefix left out of the index (one position late moves its logits
    # less than the bf16 noise, a zero key among 769: the float32 check
    # below holds that fault); xLSTM's state knows no position, so it
    # decodes from a fresh state
    late = {k: v.clone() for k, v in cache.items()}
    late_index, decode_fault = s_check + p + 1, "one position late"
    if cfg.family == "ssm":
        late, decode_fault = check.init_cache(2, s_check + 2), "state reset"
    elif cfg.family == "vlm":
        late_index, decode_fault = s_check, "prefix left out of the index"
    lg, _ = check.decode_step(nxt, cache, s_check + p)
    lg_late, _ = check.decode_step(nxt, late, late_index)
    tol = SERVE_NOISE_FACTOR * noise
    row.update(check_prompt=s_check,
               prefill_vs_forward_max_abs_err=max_abs_err(
                   last[:, 0], fwd[:, s_check - 1]),
               decode_vs_forward_max_abs_err=max_abs_err(lg[:, 0],
                                                         fwd[:, s_check]),
               decode_vs_forward_tolerance=tol,
               decode_fault=decode_fault,
               decode_fault_max_abs_err=max_abs_err(lg_late[:, 0],
                                                    fwd[:, s_check]))
    if cfg.family == "vlm":
        # the float32 model: the token one position late must show
        m32 = sibling(use_kernels=False, dtype="float32")
        last, cache = m32.prefill(sub, cache_len=s_check + p + 2)
        fwd = m32.forward(dict(sub, tokens=torch.cat([sub["tokens"], nxt],
                                                     dim=1)))[:, s_check]
        late = {k: v.clone() for k, v in cache.items()}
        lg, _ = m32.decode_step(nxt, cache, s_check + p)
        lg_late, _ = m32.decode_step(nxt, late, s_check + p + 1)
        row["f32_decode"] = {
            "vs_forward_max_abs_err": max_abs_err(lg[:, 0], fwd),
            "tolerance": F32_DECODE_TOL, "fault": "one position late",
            "fault_max_abs_err": max_abs_err(lg_late[:, 0], fwd)}
        del m32
    del check, cache, late, fwd, model
    gc.collect()
    torch.cuda.empty_cache()
    row["phase_s"] = time.perf_counter() - t_phase
    log("families " + json.dumps(row))
    if not (row["prefill_vs_forward_max_abs_err"] <= tol
            and row["decode_vs_forward_max_abs_err"] <= tol):
        fail(f"families: {arch}'s prefill / decode_step vs forward differ "
             f"by {row['prefill_vs_forward_max_abs_err']} / "
             f"{row['decode_vs_forward_max_abs_err']} (limit {tol})")
    if not row["decode_fault_max_abs_err"] > tol:
        fail(f"families: {arch}'s decode check cannot see its planted "
             f"fault ({row['decode_fault_max_abs_err']} <= {tol})")
    acc = row["accuracy"]
    if "f32_rel" in acc:
        if not acc["f32_rel"] <= acc["f32_rel_limit"]:
            fail(f"families: {arch}'s bf16 logits are far from float32: "
                 f"{acc}")
        for f in acc["faults"]:
            if not f["f32_rel"] > acc["f32_rel_limit"]:
                fail(f"families: the limit cannot see a planted fault in "
                     f"{arch}: {f}")
    d32 = row.get("f32_decode")
    if d32 and not (d32["vs_forward_max_abs_err"] <= F32_DECODE_TOL
                    < d32["fault_max_abs_err"]):
        fail(f"families: {arch}'s float32 decode check failed: {d32}")
    return counts, row


# -------------------------------------------------------------- phase 11
#
# The LM on a device mesh.  (a) A 1 x 1 NCCL mesh in this process, at full
# width and depth (Gemma-2 2B): serving with the params placed by
# ``param_spec`` and the cache by ``cache_spec`` (the flash kernel on
# every prefill layer), against phase 6's tokens and limits; two train
# steps with ``dp_spec``, ``grad_spec = param_spec()`` and the state laid
# out by ``state_spec``, against phase 8's meshless steps from the same
# seed.  (b) A 2 x 2 mesh of four processes on the one card over gloo
# (CUDA tensors handed to gloo as host copies): Gemma-2 2B at full width
# and 4 layers with FSDP trained at microbatches 1 and 2 against one
# rank's meshless steps; a checkpoint written from a (2, 2) state and
# restored onto (4, 1) and onto no mesh; Granite-8B at full width and 2
# layers prefilling 2 x 8192 with ring attention over "model" against the
# meshless chunked prefill.  Its times are not a multi-card measure.

LM_MESH_TIMEOUT_S = 300.0  # every process group of phase 11
LM_MESH_NCCL_PATH = f"DenseLM serve+train {SERVE_ARCH} mesh 1x1 NCCL"
LM_MESH_GLOO_PATH = ("DenseLM train/ring prefill mesh 2x2 gloo "
                     "(4 ranks on one card)")
LM_MESH_DIR = ROOT / "build" / "lm_mesh_gloo"
LM_MESH_WORLD = 4
LM_MESH_DEADLINE_S = 400.0
LM_GLOO_LAYERS = 4         # depth cut: full width, 4 layers
LM_GLOO_BATCH, LM_GLOO_SEQ = 4, 1024
LM_GLOO_STEPS = 2
# (microbatches, steps) of (b)'s mesh runs; microbatches=2 one step (a
# second one, 19 s over gloo, went when the run neared its time limit)
LM_GLOO_RUNS = ((1, LM_GLOO_STEPS), (2, 1))
LM_CKPT_ARCH, LM_CKPT_LAYERS = "smollm-360m", 2
LM_RING_ARCH = "granite-8b"
LM_RING_LAYERS = 2         # depth cut: full width, 2 layers (4 took 2 x
                           # 18 s over gloo)
LM_RING_BATCH, LM_RING_SEQ = 2, 8192
# the ring's train step (Granite-8B, LM_RING_LAYERS layers), a quarter
# of the ring prefill's prompt: one step against rank 0's meshless
# chunked step, one more with a planted fault
LM_RING_TRAIN_BATCH, LM_RING_TRAIN_SEQ = 2, 2048
# (b)'s train steps against rank 0's meshless ones: grad_norm within
# MB_GNORM_RTOL, the masters within MB_UPDATE_TOL (phase 8's microbatch
# limits), and at microbatches=1 the loss within a relative
# LM_LOSS_RTOL (the same bf16 forward over the rows split two ways)
LM_LOSS_RTOL = 1e-3


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


def train_rejects(m, ref, noise) -> bool:
    """Phase 8's limits on a step against its meshless twin from the
    same state: the loss within TRAIN_NOISE_FACTOR noises, grad_norm
    within MB_GNORM_RTOL."""
    return not (abs(m["loss"] - ref["loss"]) <= TRAIN_NOISE_FACTOR * noise
                and _rel(m["grad_norm"], ref["grad_norm"]) <= MB_GNORM_RTOL)


def lm_mesh_nccl_phase(serve_ref, train_ref):
    """Phase 11(a)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve
    from repro_torch.models.transformer import DenseLM
    from repro_torch.train.serve_step import greedy_generate
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step, state_spec)
    from repro_torch.utils import sharding as SH
    t_phase = time.perf_counter()
    rdv = ROOT / "build" / "lm_mesh_nccl_rdv"
    rdv.parent.mkdir(parents=True, exist_ok=True)
    rdv.unlink(missing_ok=True)
    mesh = M.make_mesh((1, 1), device_type="cuda",
                       init_method=f"file://{rdv}", world_size=1, rank=0,
                       timeout_s=LM_MESH_TIMEOUT_S)
    # serving: the path, every count 0 just before and read just after
    model = serve.build(SERVE_ARCH, attn_impl="flash", seed=0).to_mesh(mesh)
    cfg = model.cfg
    batch, s, g = serve_ref["request"]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = greedy_generate(model, batch, steps=g, cache_len=s + g)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    if counts["flash_attention"] != cfg.n_layers or \
            sum(counts.values()) != cfg.n_layers:
        fail(f"lm mesh: one generate launched {counts}, not one flash "
             f"launch per layer ({cfg.n_layers})")
    if not torch.equal(tokens, serve_ref["tokens"]):
        fail("lm mesh: the 1x1 mesh's greedy tokens differ from phase 6's")
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(batch, cache_len=s + g)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    pre = launched_since(before)
    tok = _argmax_tokens(logits)
    before = launch_counts()
    t0 = time.perf_counter()
    for j in range(g - 1):
        lg, cache = model.decode_step(tok, cache, s + j)
        tok = _argmax_tokens(lg)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (g - 1)
    dec = launched_since(before)
    acc = serve_accuracy(logits, *serve_ref["refs"])
    serve_row = {"batch": batch["tokens"].shape[0], "prompt": s,
                 "generated": g, "generate_wall_ms": gen_ms,
                 "prefill_ms": prefill_ms,
                 "prefill_ms_meshless": serve_ref["prefill_ms"],
                 "decode_ms_per_step": step_ms,
                 "decode_ms_per_step_meshless":
                     serve_ref["decode_ms_per_step"],
                 "flash_launches_per_prefill": pre["flash_attention"],
                 "launches_per_decode_steps": sum(dec.values()),
                 "tokens_equal_phase6": True,
                 "max_memory_allocated_gb":
                     torch.cuda.max_memory_allocated() / 1e9, **acc}
    log("lm mesh serve " + json.dumps(serve_row))
    if pre["flash_attention"] != cfg.n_layers or sum(dec.values()):
        fail(f"lm mesh: prefill launched {pre}, decode steps {dec}")
    if serve_rejects(acc):
        fail(f"lm mesh: the 1x1 mesh's logits are out of phase 6's limits: "
             f"{acc}")
    del model, cache, logits, lg
    gc.collect()
    torch.cuda.empty_cache()

    # training: phase 8's first steps on the mesh, from the same seed
    tcfg = get_config(TRAIN_ARCH)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(TRAIN_SEED)
    model = DenseLM(tcfg, device="cuda", generator=gen).to_mesh(mesh)
    state = init_train_state(model)
    SH.tree_specs(state_spec(model), state)     # laid out by state_spec
    step = make_train_step(model, train_ref["opt_cfg"], dp_spec="data",
                           grad_spec=model.param_spec())
    torch.cuda.reset_peak_memory_stats()
    metrics, walls = [], []
    for i, b in enumerate(train_ref["batches"][:2]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        m = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        metrics.append(m)
        if i == 0:
            mean_d, max_d = master_distance(state.opt["master"],
                                            train_ref["master1"], m["lr"])
    peak = torch.cuda.max_memory_allocated()
    refs = train_ref["metrics"]
    noise = train_ref["noise"]
    sound = [train_rejects(m, r, noise) for m, r in zip(metrics, refs)]
    # a planted fault: the gradients divided by a data size of 2 on this
    # data axis of 1 (step 2, against phase 8's step 2)
    orig = SH.reduce_to
    SH.reduce_to = lambda *a: orig(*a) * 0.5
    try:
        state, m = step(state, train_ref["batches"][2])
    finally:
        SH.reduce_to = orig
    fault = {k: float(v) for k, v in m.items()}
    train_row = {
        "arch": tcfg.name, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "step_ms": [w * 1e3 for w in walls],
        "step_ms_meshless": train_ref["step_ms"][:2],
        "losses": [m["loss"] for m in metrics],
        "losses_meshless": [r["loss"] for r in refs[:2]],
        "grad_norms": [m["grad_norm"] for m in metrics],
        "grad_norms_meshless": [r["grad_norm"] for r in refs[:2]],
        "loss_noise": noise,
        "master_mean_abs_diff_over_lr": mean_d,
        "master_max_abs_diff_over_lr": max_d,
        "max_memory_allocated_gb": peak / 1e9,
        "fault": {"fault": "gradients divided by a data size of 2",
                  "grad_norm": fault["grad_norm"],
                  "grad_norm_meshless": refs[2]["grad_norm"],
                  "rejected": train_rejects(fault, refs[2], noise)}}
    log("lm mesh train " + json.dumps(train_row))
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    if any(sound) or mean_d > MB_UPDATE_TOL:
        fail(f"lm mesh: the 1x1 mesh's train steps are off phase 8's: "
             f"{train_row}")
    if not train_row["fault"]["rejected"]:
        fail(f"lm mesh: the train limits cannot see a planted fault: "
             f"{train_row['fault']}")
    return ({"serve": serve_row, "train": train_row,
             "phase_s": time.perf_counter() - t_phase}, counts)


def _gathered_distance(tree, spec_tree, mesh, ref, lr, dev):
    """Mean and max |leaf - ref leaf| / lr over every element of a tree
    of blocks, gathered one leaf at a time (``ref``: host leaves by name,
    or None on the ranks that do not compare)."""
    from repro_torch.utils import sharding as SH
    from repro_torch.utils.tree import flatten_with_paths
    tot, n, top = 0.0, 0, 0.0
    for (name, leaf), sp in zip(flatten_with_paths(tree),
                                SH.tree_specs(spec_tree, tree)):
        full = SH.gather(leaf, sp, mesh)
        if ref is not None:
            d = (full.float() - ref[name].to(dev)).abs_().div_(lr)
            tot += float(d.double().sum())
            n += d.numel()
            top = max(top, float(d.max()))
        del full
    return (tot / n, top) if ref is not None else (None, None)


def _halves(got, want, noise_of):
    """Max |got - want| over each half of the sequence (dim 1), and the
    same of the noise pair ``noise_of``."""
    s = got.shape[1] // 2
    return [{"err": max_abs_err(got[:, h], want[:, h]),
             "noise": max_abs_err(*(t[:, h] for t in noise_of))}
            for h in (slice(0, s), slice(s, None))]


def _clone_state(state):
    import dataclasses

    from repro_torch.utils.tree import tree_map
    return dataclasses.replace(
        state, params=tree_map(lambda t: t.clone(), state.params),
        opt=tree_map(lambda t: t.clone(), state.opt))


def _step_base() -> float:
    """Start a step's own peak: the bytes allocated before it."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _step_peak(base) -> dict:
    import torch
    torch.cuda.synchronize()
    top = torch.cuda.max_memory_allocated()
    return {"peak_gb": top / 1e9, "over_base_gb": (top - base) / 1e9}


def _act_spec_step(model, step, state, batch, run, mesh, ref_master, lr,
                   dev, plain_gb) -> dict:
    """The step of ``state`` on ``batch`` once more under ``act_spec =
    P("data", "model", None)`` (its masters against ``ref_master``, the
    meshless step's), its own peak beside ``plain_gb`` (the same step
    without it), and a planted fault on a copy of the state: the layer
    gather's gradient sliced where each rank's share must be summed."""
    from repro_torch.train.train_step import state_spec
    from repro_torch.utils import sharding as SH
    model.act_spec = SH.P("data", "model", None)
    try:
        bad = _clone_state(state)
        gather_seq = SH.gather_seq
        SH.gather_seq = lambda x, dim, axes, mesh_, grad="sum": gather_seq(
            x, dim, axes, mesh_, grad="slice")
        try:
            _, fault, _ = run(step, bad, batch)
        finally:
            SH.gather_seq = gather_seq
        del bad
        base = _step_base()
        state, m, ms = run(step, state, batch)
        mine = _step_peak(base)
        mean_d, max_d = _gathered_distance(
            state.opt["master"], state_spec(model).opt["master"], mesh,
            ref_master, lr, dev)
    finally:
        model.act_spec = None
    return {"metrics": m, "step_ms": ms, "memory": mine,
            "memory_without": plain_gb,
            "master_mean_abs_diff_over_lr": mean_d,
            "master_max_abs_diff_over_lr": max_d, "fault": fault}


def lm_mesh_gloo_rank(rank: int) -> int:
    """One rank of phase 11(b) (``chip_smoke.py --lm-mesh-rank R``)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.launch import mesh as M
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import DenseLM
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step, state_spec)
    from repro_torch.utils import sharding as SH
    from repro_torch.utils.tree import flatten_with_paths
    mesh = M.make_mesh((2, 2), device_type="cuda", backend="gloo",
                       init_method="file://" + str(LM_MESH_DIR / "rdv"),
                       world_size=LM_MESH_WORLD, rank=rank,
                       timeout_s=LM_MESH_TIMEOUT_S)
    m41 = M.make_mesh((4, 1), device_type="cuda", backend="gloo",
                      timeout_s=LM_MESH_TIMEOUT_S)
    dev = torch.device("cuda", torch.cuda.current_device())
    d = SH.mesh_coords(mesh)["data"]
    meta = {"rank": rank, "coordinate": list(mesh.get_coordinate()),
            "device": str(dev), "peak_gb": {}}
    t_rank = time.perf_counter()

    def peak(tag):
        torch.cuda.synchronize()
        meta["peak_gb"][tag] = torch.cuda.max_memory_allocated() / 1e9
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # 1. train: Gemma-2 2B at full width, LM_GLOO_LAYERS layers, FSDP
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=LM_GLOO_LAYERS,
                              fsdp=True)
    opt_cfg = AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=0)
    data = SyntheticTokens(cfg.vocab_size, LM_GLOO_SEQ, LM_GLOO_BATCH,
                           seed=TRAIN_SEED)
    # LM_GLOO_STEPS sound steps, then one with a planted fault
    batches = [masked_batch(data, i, TRAIN_SEED)
               for i in range(LM_GLOO_STEPS + 1)]

    def fresh(on_mesh):
        gen = torch.Generator(device=dev)
        gen.manual_seed(TRAIN_SEED)
        model = DenseLM(cfg, device=dev, generator=gen)
        if on_mesh:
            model.to_mesh(mesh)
        return model, init_train_state(model)

    def run(step, state, b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        m = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        return state, m, (time.perf_counter() - t0) * 1e3

    ref_masters = None
    if rank == 0:       # the meshless steps on the same weights and batches
        model, state = fresh(False)
        step = make_train_step(model, opt_cfg)
        meta["meshless"], meta["meshless_step_ms"], ref_masters = [], [], []
        for b in batches:
            state, m, ms = run(step, state, b)
            meta["meshless"].append(m)
            meta["meshless_step_ms"].append(ms)
            ref_masters.append({n: x.cpu() for n, x in
                                flatten_with_paths(state.opt["master"])})
        del model, state, step
        peak("meshless train")
    # a planted fault: each gradient block reduced over the data axis twice
    orig = SH.reduce_to

    def twice(x, spec, mesh_, batch_axes):
        y = orig(x, spec, mesh_, batch_axes)
        for a in batch_axes:
            y = SH.all_reduce(y, mesh_.get_group(a))
        return y
    meta["train"] = {}
    for mb, n in LM_GLOO_RUNS:
        model, state = fresh(True)
        step = make_train_step(model, opt_cfg, microbatches=mb,
                               dp_spec="data", grad_spec=model.param_spec())
        metrics, walls = [], []
        for i, b in enumerate(batches[:n]):
            if mb == 1 and i == n - 1:     # act_spec's step starts here
                before_last = _clone_state(state)
                base_gb = _step_base()
            state, m, ms = run(step, state, b)
            metrics.append(m)
            walls.append(ms)
            if mb == 1 and i == n - 1:
                step_gb = _step_peak(base_gb)
        mean_d, max_d = _gathered_distance(
            state.opt["master"], state_spec(model).opt["master"], mesh,
            None if ref_masters is None else ref_masters[n - 1],
            opt_cfg.peak_lr, dev)
        meta["train"][f"mb{mb}"] = {
            "metrics": metrics, "step_ms": walls,
            "master_mean_abs_diff_over_lr": mean_d,
            "master_max_abs_diff_over_lr": max_d}
        if mb == 1:     # the fault on the next step, from the same state
            SH.reduce_to = twice
            try:
                state, meta["fault_train"], _ = run(step, state, batches[n])
            finally:
                SH.reduce_to = orig
            del state
            meta["act_spec"] = _act_spec_step(
                model, step, before_last, batches[n - 1], run, mesh,
                None if ref_masters is None else ref_masters[n - 1],
                opt_cfg.peak_lr, dev, step_gb)
            del before_last
        else:
            del state
        del model, step
        peak(f"train mb{mb}")
    del ref_masters

    # 2. a checkpoint written from a (2, 2) state, restored onto (4, 1)
    # and onto no mesh
    ccfg = dataclasses.replace(get_config(LM_CKPT_ARCH),
                               n_layers=LM_CKPT_LAYERS, fsdp=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(TRAIN_SEED)
    model = DenseLM(ccfg, device=dev, generator=gen).to_mesh(mesh)
    state = init_train_state(model)
    cdata = SyntheticTokens(ccfg.vocab_size, LM_GLOO_SEQ, LM_GLOO_BATCH,
                            seed=TRAIN_SEED)
    state, _ = make_train_step(model, opt_cfg, dp_spec="data",
                               grad_spec=model.param_spec())(
        state, masked_batch(cdata, 0, TRAIN_SEED))
    sspec = state_spec(model)
    root = str(LM_MESH_DIR / "ckpt")
    t0 = time.perf_counter()
    save_checkpoint(root, 1, state, shardings=(sspec, mesh))
    meta["ckpt_save_ms"] = (time.perf_counter() - t0) * 1e3
    on41, _ = restore_checkpoint(root, state, 1, device=dev,
                                 shardings=(sspec, m41))
    plain, _ = restore_checkpoint(root, state, 1, device=dev)
    specs = SH.tree_specs(sspec, state)
    equal41 = equal_plain = True
    for (name, leaf), (_, l41), (_, lp), sp in zip(
            flatten_with_paths(state), flatten_with_paths(on41),
            flatten_with_paths(plain), specs):
        full = SH.gather(leaf, sp, mesh)
        equal41 &= bits_equal(SH.gather(l41, sp, m41), full)
        equal_plain &= bits_equal(lp, full)
    meta["ckpt"] = {"leaves": len(specs), "restored_4x1_equal": equal41,
                    "restored_meshless_equal": equal_plain}
    del model, state, on41, plain
    peak("checkpoint")

    # 3. Granite-8B at full width, LM_RING_LAYERS layers: a prefill of
    # LM_RING_BATCH x LM_RING_SEQ with ring attention over "model",
    # against the meshless chunked prefill of this rank's row (and the
    # float32 model's, whose distance is the noise)
    gcfg = dataclasses.replace(get_config(LM_RING_ARCH),
                               n_layers=LM_RING_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(TRAIN_SEED)
    plain_model = DenseLM(gcfg, device=dev, generator=gen)
    tokens = torch.from_numpy(np.random.default_rng(TRAIN_SEED).integers(
        0, gcfg.vocab_size, (LM_RING_BATCH, LM_RING_SEQ)).astype(np.int32)
    ).to(dev)
    mine = {"tokens": tokens[d:d + 1]}
    want_logits, want_cache = plain_model.prefill(mine)
    f32 = DenseLM(dataclasses.replace(gcfg, dtype="float32"), device=dev,
                  params=_param_tree(plain_model.params))
    f32_logits, f32_cache = f32.prefill(mine)
    want_k = want_cache["k"][-1].float()
    f32_k = f32_cache["k"][-1].float()
    del f32, f32_cache, want_cache
    ring = DenseLM(dataclasses.replace(gcfg, attn_impl="ring"), device=dev,
                   params=_param_tree(plain_model.params))
    del plain_model
    ring.ring_mesh = mesh
    ring.to_mesh(mesh)
    peak("ring models")
    cspec = ring.cache_spec(multi_pod=False)["k"]

    def ring_prefill():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = ring.prefill({"tokens": tokens})
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        # the last layer's k of this rank's row, every head
        k = SH.gather(cache["k"], cspec, mesh)[-1, d:d + 1].float()
        return logits[d:d + 1], k, ms
    logits, k, ms = ring_prefill()
    meta["ring"] = {
        "prefill_ms": ms,
        "logits": {"err": max_abs_err(logits, want_logits),
                   "noise": max_abs_err(want_logits, f32_logits)},
        "k_cache_halves": _halves(k, want_k, (want_k, f32_k))}
    # a planted fault: the ring without the shard's query offset
    orig_block = L._online_block

    def no_offset(q, k_, v, qpos, kpos, *a, **kw):
        return orig_block(q, k_, v, qpos - qpos[0], kpos, *a, **kw)
    L._online_block = no_offset
    try:
        _, k_bad, _ = ring_prefill()
    finally:
        L._online_block = orig_block
    meta["ring_fault"] = _halves(k_bad, want_k, (want_k, f32_k))
    del ring, k, k_bad
    peak("ring prefill")

    # 4. the ring's train step: Granite-8B at LM_RING_LAYERS layers, one
    # step with attn_impl="ring" over "model" against rank 0's meshless
    # chunked step from the same seed; then a step with a planted fault
    # (the gathered ring output's gradient summed over "model" where every
    # rank computed the same rows and it must be sliced)
    tdata = SyntheticTokens(gcfg.vocab_size, LM_RING_TRAIN_SEQ,
                            LM_RING_TRAIN_BATCH, seed=TRAIN_SEED)
    tbatches = [masked_batch(tdata, i, TRAIN_SEED) for i in range(2)]

    def fresh_ring(on_mesh):
        gen = torch.Generator(device=dev)
        gen.manual_seed(TRAIN_SEED)
        model = DenseLM(dataclasses.replace(
            gcfg, attn_impl="ring" if on_mesh else "chunked"), device=dev,
            generator=gen)
        if on_mesh:
            model.ring_mesh = mesh
            model.to_mesh(mesh)
        return model, init_train_state(model)
    ring_ref_masters = None
    if rank == 0:
        model, state = fresh_ring(False)
        step = make_train_step(model, opt_cfg)
        meta["ring_train_meshless"] = []
        for i, b in enumerate(tbatches):
            state, m, _ = run(step, state, b)
            meta["ring_train_meshless"].append(m)
            if i == 0:
                ring_ref_masters = {n: x.cpu() for n, x in
                                    flatten_with_paths(state.opt["master"])}
        del model, state, step
    model, state = fresh_ring(True)
    step = make_train_step(model, opt_cfg, dp_spec="data",
                           grad_spec=model.param_spec())
    state, m, ms = run(step, state, tbatches[0])
    mean_d, max_d = _gathered_distance(
        state.opt["master"], state_spec(model).opt["master"], mesh,
        ring_ref_masters, opt_cfg.peak_lr, dev)
    meta["ring_train"] = {"metrics": m, "step_ms": ms,
                          "master_mean_abs_diff_over_lr": mean_d,
                          "master_max_abs_diff_over_lr": max_d}
    gather_seq = SH.gather_seq
    SH.gather_seq = lambda x, dim, axes, mesh_, grad="sum": gather_seq(
        x, dim, axes, mesh_, grad="sum")
    try:
        _, meta["ring_train_fault"], _ = run(step, state, tbatches[1])
    finally:
        SH.gather_seq = gather_seq
    del model, state, step, ring_ref_masters
    peak("ring train")
    meta["launches"] = launch_counts()
    meta["rank_s"] = time.perf_counter() - t_rank
    (LM_MESH_DIR / f"rank{rank}.json").write_text(json.dumps(meta))
    torch.distributed.destroy_process_group()
    return 0


def lm_mesh_gloo_phase():
    """Phase 11(b): four ranks (``chip_smoke.py --lm-mesh-rank R``) on a
    2 x 2 gloo mesh on this card; their checks, the planted faults that
    must show, and their times and peaks."""
    import os
    import shutil
    t_phase = time.perf_counter()
    shutil.rmtree(LM_MESH_DIR, ignore_errors=True)
    LM_MESH_DIR.mkdir(parents=True)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--lm-mesh-rank", str(r)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(LM_MESH_WORLD)]
    outs = []
    try:
        deadline = time.monotonic() + LM_MESH_DEADLINE_S
        for p in procs:
            o, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
            outs.append(o)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t_phase
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"lm mesh rank {r} exited {p.returncode}:\n{o[-3000:]}")
    metas = [json.loads((LM_MESH_DIR / f"rank{r}.json").read_text())
             for r in range(LM_MESH_WORLD)]
    shutil.rmtree(LM_MESH_DIR, ignore_errors=True)
    launches = {}
    for meta in metas:
        for k, c in meta["launches"].items():
            launches[k] = launches.get(k, 0) + c
    ref = metas[0]["meshless"]
    noise = abs(ref[0]["loss"]) * LM_LOSS_RTOL
    for meta in metas:
        r = meta["rank"]
        for tag, run in meta["train"].items():
            if metas[0]["train"][tag]["metrics"] != run["metrics"]:
                fail(f"lm mesh rank {r} {tag}: metrics differ from rank 0's")
        for tag, run in metas[0]["train"].items():
            for i, (m, want) in enumerate(zip(run["metrics"], ref)):
                if _rel(m["grad_norm"], want["grad_norm"]) > MB_GNORM_RTOL \
                        or (tag == "mb1" and abs(m["loss"] - want["loss"])
                            > noise):
                    fail(f"lm mesh {tag} step {i}: {m} against the meshless "
                         f"{want}")
            if run["master_mean_abs_diff_over_lr"] > MB_UPDATE_TOL:
                fail(f"lm mesh {tag}: the masters moved off the meshless "
                     f"ones: {run}")
        ck = meta["ckpt"]
        if not (ck["restored_4x1_equal"] and ck["restored_meshless_equal"]):
            fail(f"lm mesh rank {r}: the checkpoint round trip: {ck}")
        ring = meta["ring"]
        halves = ring["k_cache_halves"]
        if ring["logits"]["err"] > SERVE_NOISE_FACTOR * \
                ring["logits"]["noise"] or any(
                    h["err"] > SERVE_NOISE_FACTOR * h["noise"]
                    for h in halves):
            fail(f"lm mesh rank {r}: the ring prefill is off the meshless "
                 f"one: {ring}")
        first, second = meta["ring_fault"]
        if first["err"] > SERVE_NOISE_FACTOR * first["noise"] or \
                second["err"] <= SERVE_NOISE_FACTOR * second["noise"]:
            fail(f"lm mesh rank {r}: the planted ring fault (no query "
                 f"offset) does not show on the second half alone: "
                 f"{meta['ring_fault']}")
    # act_spec's step 2 against the meshless step 2; the ring's train
    # step against rank 0's meshless chunked one; each planted fault
    ring_ref = metas[0]["ring_train_meshless"]
    for meta in metas:
        r = meta["rank"]
        for key in ("act_spec", "ring_train"):
            if meta[key]["metrics"] != metas[0][key]["metrics"]:
                fail(f"lm mesh rank {r} {key}: metrics differ from rank 0's")
    checks = (("act_spec", metas[0]["act_spec"], ref[LM_GLOO_STEPS - 1],
               metas[0]["act_spec"]["fault"], ref[LM_GLOO_STEPS - 1]),
              ("ring_train", metas[0]["ring_train"], ring_ref[0],
               metas[0]["ring_train_fault"], ring_ref[1]))
    new_faults = {}
    for key, got, want, bad, bad_want in checks:
        m = got["metrics"]
        if _rel(m["grad_norm"], want["grad_norm"]) > MB_GNORM_RTOL or \
                abs(m["loss"] - want["loss"]) > abs(want["loss"]) * \
                LM_LOSS_RTOL or \
                got["master_mean_abs_diff_over_lr"] > MB_UPDATE_TOL:
            fail(f"lm mesh {key}: {got} against the meshless {want}")
        new_faults[key] = _rel(bad["grad_norm"], bad_want["grad_norm"])
        if new_faults[key] <= MB_GNORM_RTOL:
            fail(f"lm mesh {key}: the planted fault is within the limits: "
                 f"{bad} against {bad_want}")
    fault = metas[0]["fault_train"]
    fault_rejected = _rel(fault["grad_norm"],
                          ref[LM_GLOO_STEPS]["grad_norm"]) > MB_GNORM_RTOL
    if not fault_rejected:
        fail(f"lm mesh: the train limits cannot see a planted fault "
             f"(a block reduced twice): {fault}")
    if launches.get("flash_attention", 0) or sum(launches.values()):
        fail(f"lm mesh: the gloo world launched kernels: {launches}")
    out = {"meshless_step_ms": metas[0]["meshless_step_ms"],
           "train": metas[0]["train"],
           "fault_train": {"fault": "each gradient block reduced over the "
                                    "data axis twice",
                           "step": LM_GLOO_STEPS,
                           "grad_norm": fault["grad_norm"],
                           "grad_norm_meshless":
                               ref[LM_GLOO_STEPS]["grad_norm"],
                           "rejected": fault_rejected},
           "act_spec": metas[0]["act_spec"],
           "act_spec_fault": {"fault": "the layer gather's gradient sliced "
                                       "where it must be summed",
                              "grad_norm_rel_err": new_faults["act_spec"]},
           "ring_train": metas[0]["ring_train"],
           "ring_train_meshless": ring_ref,
           "ring_train_fault": {"fault": "the ring output's gradient "
                                         "summed where it must be sliced",
                                "grad_norm_rel_err":
                                    new_faults["ring_train"]},
           "ckpt": metas[0]["ckpt"], "ckpt_save_ms": metas[0]["ckpt_save_ms"],
           "ring": [m["ring"] for m in metas],
           "ring_fault": [m["ring_fault"] for m in metas],
           "peak_gb_by_rank": [m["peak_gb"] for m in metas],
           "rank_s": [m["rank_s"] for m in metas], "phase_s": wall,
           "note": "gloo on one card: a wiring check, not a multi-card "
                   "measure"}
    log("lm mesh gloo " + json.dumps(out))
    return out, launches


# -------------------------------------------------------------- phase 12
#
# The dry run on the card's host (``launch/dryrun.py``: one rank, meta
# tensors, in the host-work helper): its predicted peak for phase 8's
# train step and phase 6's first request against what they measured,
# within DRYRUN_PEAK_TOL, and a planted fault outside it.

def dryrun_phase(helper, train_row, serve_rows) -> dict:
    t0 = time.perf_counter()
    pred = json.loads(host_work_wait(helper, "dryrun.json").read_text())
    o, _ = helper.communicate(timeout=HOST_WORK_DEADLINE_S)
    if helper.returncode != 0:
        fail(f"host work exited {helper.returncode}:\n{o[-3000:]}")
    measured = {"train": train_row["max_memory_allocated_gb"],
                "serve": serve_rows[0]["max_memory_allocated_gb"]}
    out = {"seconds": pred["seconds"], "tol": DRYRUN_PEAK_TOL}
    for tag, got in measured.items():
        p = pred[tag]
        rel = (p["peak_gb"] - got) / got
        fault_rel = (p["fault_peak_gb"] - got) / got
        row = dict(p, measured_gb=got, rel_err=rel, fault_rel_err=fault_rel)
        if abs(rel) > DRYRUN_PEAK_TOL:
            fail(f"dry run: the predicted {tag} peak {p['peak_gb']:.2f} GB "
                 f"is {rel:+.1%} off the measured {got:.2f} GB")
        if abs(fault_rel) <= DRYRUN_PEAK_TOL:
            fail(f"dry run: the planted fault ({p['fault']}) is within the "
                 f"limit: {row}")
        out[tag] = row
    out["phase_s"] = time.perf_counter() - t0
    log("dryrun " + json.dumps(out))
    return out


# -------------------------------------------------------------- phase 13
#
# The service tier on the card, on a daily snapshot's slice: the
# user-follow graph at 2^SERVICE_LOG2V (mean degree 4, seed 5),
# symmetrized, self-loops dropped, built by the --host-graph helper.
# (a) the incremental catalog: cold answers on version 0, then two
# add-only deltas (SERVICE_DELTAS of the edge set, drawn as
# ``benchmarks/fig_incremental.py``'s ``_delta_edges`` draws them) and a
# removal delta; (b) the hybrid-cloud pools of ``default_pools()`` (both
# alias the one card); (c) the runtime (a planted transient failure,
# backpressure) and obs (the metrics exposition, the plan-accuracy
# meter's calibration samples); (d) the calibration fitter at
# CALIBRATE_SCALES.  Every comparison has a planted fault it must
# reject.

SERVICE_LOG2V = 22
SERVICE_DELTAS = (0.001, 0.01)   # add-only deltas, shares of the edge set
SERVICE_REMOVAL = 0.001          # the removal delta, a share of the edges
SERVICE_DELTA_SEED = 23
SERVICE_CAPACITY = 2             # (b) each pool's batch-tier capacity
SERVICE_QUERIES = ("cc", "bfs", "sssp", "k_core", "pagerank")
CALIBRATE_SCALES = "2**18"       # (d) the fitter's sweep on the card
# (d)'s path: the sweep's triangle runs launch ell_intersect
CALIBRATE_PATH = "service tier (d) calibration V=2^18"


def service_graph(log2v: int = SERVICE_LOG2V, device="cpu"):
    """Phase 13's snapshot (host build in the --host-graph helper)."""
    from repro_torch.core import graph as G
    from repro_torch.data import synthetic as S
    V = 2 ** log2v
    src, dst = S.user_follow_graph(V, 4.0, seed=5)
    keep = src != dst
    return G.build_coo(src[keep], dst[keep], V, symmetrize=True,
                       device=device)


def _service_queries(coo) -> dict:
    """The five queries of (a); BFS and SSSP from the highest-degree
    vertex."""
    import torch
    from repro_torch.core.query import GraphQuery as Q
    V = coo.n_vertices
    hub = int(torch.bincount(coo.dst[: coo.n_edges].long(),
                             minlength=V).argmax())
    return {"cc": Q.of("connected_components"),
            "bfs": Q.of("bfs", sources=(hub,)),
            "sssp": Q.of("sssp", source=hub),
            "k_core": Q.of("k_core", k=KCORE_K),
            "pagerank": Q.of("pagerank", tol=PAGERANK_HALT_L1 / V)}


def trace_call(fn):
    """``fn()`` under cProfile and ``torch.profiler`` (host and device):
    its wall (host clock, to a synchronise), the CUDA kernels' summed
    device time and the share of the wall they leave idle, the host
    functions with the most own time, and the host ops with the most
    own time.  Returns ``(fn's result, that dict)``."""
    import cProfile
    import pstats

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    pr = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pr.enable()
        out = fn()
        torch.cuda.synchronize()
        pr.disable()
        wall = time.perf_counter() - t0
    funcs = sorted(pstats.Stats(pr).stats.items(), key=lambda kv: -kv[1][2])
    host = [{"function": f"{Path(f).name}:{line}({name})",
             "own_ms": tt * 1e3, "calls": nc}
            for (f, line, name), (_, nc, tt, _, _) in funcs[:8]]
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA)
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_cpu_time_total)[:6]
    row = {"traced_wall_ms": wall * 1e3, "host_functions": host,
           "host_ops": [{"op": e.key[:60],
                         "own_ms": e.self_cpu_time_total / 1e3,
                         "calls": e.count} for e in ops]}
    if busy_us:
        row.update(device_busy_ms=busy_us / 1e3,
                   device_idle_share=1 - busy_us / 1e6 / wall)
    else:
        row["device_busy_ms"] = "not measured"
    return out, row


def _timed_call(svc, name, q, **kw):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = svc.call(name, q, **kw)
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t0) * 1e3


def _l1(a, b) -> float:
    return float((a.double() - b.double()).abs().sum())


def _agrees(tag, r, cold) -> bool:
    """A seeded answer against the cold one: byte for byte, PageRank
    within PAGERANK_L1_TOL (L1)."""
    if tag == "pagerank":
        return _l1(r.value, cold.value) < PAGERANK_L1_TOL
    return bits_equal(r.value, cold.value)


def _fresh_pairs(coo, share, rng):
    """``share`` of the edge set as new (src, dst) pairs, drawn as
    ``fig_incremental._delta_edges`` draws them."""
    import numpy as np
    V, n = coo.n_vertices, max(int(coo.n_edges * share), 1)
    return np.stack([rng.integers(0, V, n), rng.integers(0, V, n)], axis=1)


def _present_pairs(coo, share, rng):
    """``share`` of the edge set's undirected pairs, to remove."""
    import numpy as np
    src, dst = _host_edges(coo)
    sel = np.flatnonzero(src < dst)
    pick = rng.choice(sel, max(int(sel.size * share), 1), replace=False)
    return np.stack([src[pick], dst[pick]], axis=1)


# (a)'s seeded calls traced on the host and the device: each version's
# first query (it meets the version's derived state unbuilt) and a warm
# PageRank
SERVICE_TRACED = {(1, "cc"), (1, "pagerank"), (3, "k_core")}


def incremental_catalog(coo) -> dict:
    """(a): versions 0 (cold), 1 and 2 (add-only deltas), 3 (removal)."""
    import numpy as np
    import torch
    from repro_torch.core.service import GraphAnalyticsService
    rng = np.random.default_rng(SERVICE_DELTA_SEED)
    qs = _service_queries(coo)
    svc = GraphAnalyticsService()
    t0 = time.perf_counter()
    svc.add_snapshot("g", coo, as_of=0)
    rows, cold0 = {"add_snapshot_ms": [(time.perf_counter() - t0) * 1e3]}, {}
    for tag in SERVICE_QUERIES:
        r, ms = _timed_call(svc, "g", qs[tag])
        cold0[tag] = r
        rows[f"v0 {tag}"] = {"wall_ms": ms, "iterations": r.iterations,
                             "mode": r.meta.get("mode")}
    results = {0: cold0}
    edits = [("added", share, _fresh_pairs(coo, share, rng))
             for share in SERVICE_DELTAS]
    version = 0
    for kind, share, pairs in edits + [("removed", SERVICE_REMOVAL, None)]:
        version += 1
        if kind == "removed":
            pairs = _present_pairs(svc.context("g").coo, SERVICE_REMOVAL, rng)
        t0 = time.perf_counter()
        svc.add_snapshot("g", as_of=version, **{kind: pairs})
        rows["add_snapshot_ms"].append((time.perf_counter() - t0) * 1e3)
        ctx = svc.context("g")
        results[version] = {}
        tags = SERVICE_QUERIES if kind == "added" else ("k_core",)
        for tag in tags:
            # a cold run under the cold plan first builds the version's
            # derived state, so the seeded call and the timed cold run
            # after it both find it
            q = qs[tag]
            pre = ctx.plan(q)
            ctx.engine(pre.engine).run(q.algorithm, q.params,
                                       variant=pre.variant)
            trace = None
            if (version, tag) in SERVICE_TRACED:
                (r, ms), trace = trace_call(
                    lambda: _timed_call(svc, "g", q))
            else:
                r, ms = _timed_call(svc, "g", q)
            # the cold answer in the variant the service reports it ran
            plan, realized = r.meta["plan"], r.meta.get("realized_variant")
            eng = ctx.engine(plan.engine)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cold = eng.run(q.algorithm, q.params,
                           variant=realized or plan.variant)
            torch.cuda.synchronize()
            cold_ms = (time.perf_counter() - t0) * 1e3
            if cold.meta.get("realized_variant") != realized:
                fail(f"service v{version} {tag}: the service reports "
                     f"{realized!r}, the engine asked for it ran "
                     f"{cold.meta.get('realized_variant')!r}")
            mode = r.meta.get("mode")
            want = {"cc": "incremental", "bfs": "incremental",
                    "sssp": "incremental", "pagerank": "warm",
                    "k_core": "incremental" if kind == "removed" else None}
            if mode != want[tag]:
                fail(f"service v{version} {tag}: mode {mode!r}, expected "
                     f"{want[tag]!r}")
            if not _agrees(tag, r, cold):
                fail(f"service v{version} {tag}: the {mode} answer differs "
                     "from a cold run on the same snapshot")
            # the warm start saves supersteps on the 0.1 % delta; on the
            # 1 % one, under phase 4's halt, it takes more than a cold
            # run, in both packages (ROADMAP.md §3)
            if tag == "pagerank" and share <= SERVICE_DELTAS[0] and \
                    not r.iterations < cold.iterations:
                fail(f"service v{version} pagerank: warm {r.iterations} "
                     f"iterations, cold {cold.iterations}")
            results[version][tag] = r
            rows[f"v{version} {tag}"] = {
                "delta": f"{kind} {len(pairs)}", "mode": mode,
                "wall_ms": ms, "iterations": r.iterations,
                "cold_wall_ms": cold_ms, "cold_iterations": cold.iterations,
                "plan": [plan.engine, plan.variant, plan.pool, plan.mode],
                "realized_variant": realized}
            log(f"service (a) v{version} {tag} "
                + json.dumps(rows[f"v{version} {tag}"]))
            if trace is not None:
                rows[f"v{version} {tag} trace"] = trace
                log(f"service (a) v{version} {tag} trace "
                    + json.dumps(trace))
    # as_of=0 is the parent's answer, byte for byte
    for tag in SERVICE_QUERIES:
        again = svc.call("g", qs[tag], as_of=0)
        if not bits_equal(again.value, cold0[tag].value):
            fail(f"service as_of=0 {tag}: not the parent's bytes")
    meter = svc.metrics()["incremental"]
    n_inc = 3 * len(SERVICE_DELTAS) + 1
    if meter["incremental_runs"] != n_inc or \
            meter["warm_hits"] != len(SERVICE_DELTAS):
        fail(f"service metrics: {meter}, expected {n_inc} incremental runs "
             f"and {len(SERVICE_DELTAS)} warm hits")
    # planted faults the same check must reject: version 1's labels with
    # one changed, and version 1 repaired from the wrong parent's seed
    # (version 2's labels)
    good = results[1]["cc"]
    bad = dataclasses.replace(good, value=good.value.clone())
    bad.value[0] += 1
    if _agrees("cc", bad, good):
        fail("service: the check cannot see one label changed")
    ctx1 = svc.context("g", as_of=1)
    wrong = ctx1.engine("local").run("connected_components", {},
                                     seed=results[2]["cc"],
                                     delta=ctx1.coo.delta)
    if wrong.meta.get("mode") != "incremental" or \
            _agrees("cc", wrong, good):
        fail("service: a repair seeded from the wrong parent went unseen")
    rows["metrics"] = meter
    rows["planted"] = ["one label changed", "seed from the wrong parent"]
    rows["snapshot"] = {"vertices": coo.n_vertices, "edges": coo.n_edges,
                        "versions": svc.snapshot_versions("g")}
    return rows, svc


def _pool_ledger(svc) -> dict:
    """Each pool's transfer ledger as ``metrics()`` reports it."""
    return {name: {k: row[k] for k in ("transfer_bytes", "transfers")}
            for name, row in svc.metrics()["pools"].items()}


def _ledger_holds(ledger: dict, coo) -> bool:
    """The snapshot's bytes moved to cloud exactly once, and none to
    onprem, where it was resident from the start."""
    return ledger.get("cloud") == {"transfer_bytes": coo.nbytes(),
                                   "transfers": 1} and \
        ledger.get("onprem") == {"transfer_bytes": 0, "transfers": 0}


def hybrid_pools(coo, child) -> dict:
    """(b): ``default_pools()``, the snapshot resident on onprem only."""
    from repro_torch.core import pools as PL
    from repro_torch.core.query import GraphQuery as Q
    from repro_torch.core.service import GraphAnalyticsService
    ps = PL.default_pools(link_bandwidth=1e15, cloud_compute_scale=0.01,
                          capacity=SERVICE_CAPACITY)
    if ps.get("onprem").devices != ps.get("cloud").devices:
        fail(f"pools: one card, yet {ps.get('onprem').devices} and "
             f"{ps.get('cloud').devices}")
    svc = GraphAnalyticsService(pools=ps, interactive_threshold_s=0.0)
    svc.add_snapshot("g", coo, as_of=0, pools=["onprem"])
    ctx = svc.context("g")
    base = ctx.engine("local")
    V, rows, tickets = coo.n_vertices, {}, []

    def bfs(i):
        return Q.bfs([(i * 7919) % V])

    # 1. the cheap cloud pool: one transfer, recorded once, then resident
    t = svc.submit("g", bfs(0))
    if t.pool != "cloud" or t.plan.transfer_s <= 0:
        fail(f"pools: the first ticket went to {t.pool} "
             f"(transfer_s {t.plan.transfer_s})")
    svc.drain()
    tickets.append(t)
    ledger = _pool_ledger(svc)
    if not _ledger_holds(ledger, coo) or "cloud" not in ctx.residency:
        fail(f"pools: ledger {ledger}, expected one transfer of "
             f"{coo.nbytes()} bytes to cloud; residency "
             f"{sorted(ctx.residency)}")
    if _ledger_holds({k: v for k, v in ledger.items() if k != "cloud"},
                     coo):
        fail("pools: the ledger check cannot see a dropped entry")
    # 2. cloud's batch queue filled to capacity spills to onprem
    burst = [svc.submit("g", bfs(i)) for i in range(1, SERVICE_CAPACITY + 3)]
    pools = [x.pool for x in burst]
    if pools != ["cloud"] * SERVICE_CAPACITY + ["onprem"] * 2 or \
            svc.stats["spilled"] != 2:
        fail(f"pools: spill placed {pools}, spilled {svc.stats['spilled']}")
    svc.drain()
    tickets += burst
    # 3. cloud unhealthy: generation bump, plans re-costed, failover
    q = bfs(99)
    cached = ctx.plan(q)
    gen = ps.generation
    svc.set_pool_health("cloud", False)
    replan = ctx.plan(q)
    if ps.generation != gen + 1 or replan is cached or \
            replan.pool != "onprem":
        fail(f"pools: after cloud failed, generation {gen} -> "
             f"{ps.generation}, plan on {replan.pool}")
    later = [svc.submit("g", bfs(i)) for i in (99, 100)]
    if [x.pool for x in later] != ["onprem", "onprem"]:
        fail(f"pools: failover placed {[x.pool for x in later]}")
    svc.drain()
    tickets += later
    for x in tickets:
        want_v = base.run("bfs", dict(x.query.params)).value
        if not bits_equal(svc.result(x).value, want_v):
            fail(f"pools: ticket #{x.ticket_id} on {x.pool} differs from "
                 "the engine alone")
    # 4. a delta lands; the failover answers the new version, not the
    # old pool's cached bytes
    old = svc.result(tickets[0]).value
    svc.add_snapshot("g", child, as_of=1, pools=["onprem"])
    after = svc.submit("g", tickets[0].query)
    svc.drain()
    want_v = svc.context("g").engine("local").run(
        "bfs", dict(after.query.params)).value
    if after.pool != "onprem" or \
            not bits_equal(svc.result(after).value, want_v):
        fail(f"pools: after the delta the failover on {after.pool} "
             "differs from a cold run on the new version")
    if bits_equal(old, want_v):
        fail("pools: the check cannot see the old pool's cached bytes")
    rows.update({
        "pools": {p.name: [str(d) for d in p.devices] for p in ps.pools()},
        "ledger": ledger, "spilled": svc.stats["spilled"],
        "ticket_pools": [x.pool for x in tickets + [after]],
        "generation": ps.generation,
        "planted": ["ledger entry dropped",
                    "the old pool's cached bytes after a delta"]})
    return rows


def _leaves(value, path=()):
    """``(path, leaf)`` of a nested dict / list, keys as strings."""
    if isinstance(value, dict):
        for k, v in value.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, value


def runtime_and_obs(coo) -> dict:
    """(c): a planted transient failure retried, backpressure, the
    metrics exposition and the plan-accuracy meter."""
    from repro_torch.core import obs
    from repro_torch.core import registry as R
    from repro_torch.core import runtime as RT
    from repro_torch.core.query import GraphQuery as Q
    from repro_torch.core.service import GraphAnalyticsService
    from repro_torch.launch.calibrate import fit_profile
    V = coo.n_vertices
    svc = GraphAnalyticsService(
        interactive_threshold_s=0.0, trace_depth=16,
        tier_depth={"batch": 2},
        retry=RT.RetryPolicy(max_attempts=3, base_s=1e-3, cap_s=1e-2))
    svc.add_graph("g", coo)
    base = svc.context("g").engine("local")
    R.install_fault("bfs", R.FailNTimes(1))
    try:
        t = svc.submit("g", Q.bfs([1]))
        svc.drain()
    finally:
        R.uninstall_fault("bfs")
    want = base.run("bfs", {"sources": (1,)}).value
    if t.status != "done" or t.attempts != 2 or \
            not bits_equal(svc.result(t).value, want):
        fail(f"runtime: the retried ticket {t.status} after {t.attempts} "
             "attempts, or its bytes differ")
    svc.submit("g", Q.bfs([2]))
    svc.submit("g", Q.bfs([3]))
    try:
        svc.submit("g", Q.bfs([4]))
        fail("runtime: no backpressure at the batch tier's depth budget")
    except RT.Backpressure as e:
        bp = {"tier": e.tier, "depth": e.depth, "budget": e.budget}
    svc.drain()
    svc.call("g", Q.pagerank(tol=PAGERANK_HALT_L1 / V, max_iters=8))
    m = svc.metrics()
    parsed = obs.parse_prometheus(svc.metrics_text())
    # every numeric leaf of metrics() under its documented name (``gas``
    # and the path's keys, each with [^a-zA-Z0-9_] as "_"), but the
    # names two leaves share (the latency buckets, ROADMAP.md §3)
    names = [("_".join(re.sub(r"[^a-zA-Z0-9_]", "_", p)
                        for p in ("gas",) + path), value)
             for path, value in _leaves(m)]
    counts = collections.Counter(n for n, _ in names)
    colliding = sorted(n for n, c in counts.items() if c > 1)
    checked = 0
    for name, value in names:
        if counts[name] > 1 or isinstance(value, str):
            continue
        back = parsed.get(name)
        if back is None or (value is None and not math.isnan(back)) or \
                (value is not None and not math.isclose(
                    back, float(value), rel_tol=1e-9, abs_tol=1e-12)):
            fail(f"obs: {name} = {value} parsed back as {back}")
        checked += 1
    # the meter's calibration samples (not in metrics()): one a resolved
    # execution, as many as metrics() counts
    samples = svc._accuracy.calibration_samples()
    if not samples or not all(samples.values()) or \
            sum(map(len, samples.values())) != m["accuracy"]["samples"]:
        fail(f"obs: calibration samples {samples} against "
             f"{m['accuracy']['samples']} counted")
    fitted = fit_profile(samples, source="chip_smoke phase 13 (c)")
    if set(fitted.algo_time_scale) != set(samples):
        fail(f"obs: fit_profile fitted {sorted(fitted.algo_time_scale)} "
             f"from samples of {sorted(samples)}")
    return {"retry": {"status": t.status, "attempts": t.attempts},
            "backpressure": bp, "metrics_checked": checked,
            "colliding_names": colliding,
            "calibration_samples": {k: len(v) for k, v in samples.items()},
            "fitted_scale": dict(fitted.algo_time_scale),
            "counters": m["counters"]}


def calibration_run() -> dict:
    """(d): ``launch/calibrate.py`` at CALIBRATE_SCALES into ``build/``,
    in this process so its launches are counted; the result loaded (the
    generation bumps), round-tripped, and set beside the checked-in
    profile, which is active again afterwards."""
    import shutil

    from repro_torch.core import planner as P
    from repro_torch.launch import calibrate
    out = ROOT / "build" / "calibration" / "profile.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    calibrate.main(["--scales", CALIBRATE_SCALES, "--repeats", "1",
                    "--out", str(out)])
    secs = time.perf_counter() - t0
    gen = P.calibration_generation()
    fitted = P.load_calibration(out)
    if P.calibration_generation() != gen + 1 or \
            P.active_calibration() is not fitted:
        fail("calibration: loading the profile did not bump the generation")
    again = out.with_name("again.json")
    fitted.to_json(again)
    if P.CalibrationProfile.from_json(again) != fitted:
        fail("calibration: the profile does not round-trip through JSON")
    checked_in = P.load_reference_calibration()
    shutil.rmtree(out.parent, ignore_errors=True)
    return {"seconds": secs, "source": fitted.source,
            "fitted": {"algo_time_scale": dict(fitted.algo_time_scale),
                       "superstep_edge_bytes":
                           dict(fitted.superstep_edge_bytes),
                       "interactive_threshold_s":
                           fitted.interactive_threshold_s},
            "checked_in": {"source": checked_in.source,
                           "algo_time_scale":
                               dict(checked_in.algo_time_scale),
                           "superstep_edge_bytes":
                               dict(checked_in.superstep_edge_bytes),
                           "interactive_threshold_s":
                               checked_in.interactive_threshold_s}}


def service_tier_phase(coo, paths) -> dict:
    """Phase 13: (a)-(d) in turn, each sub-phase's launches counted from
    0 into ``paths``."""
    import torch
    out, t_phase = {}, time.perf_counter()
    size = f"V=2^{round(math.log2(coo.n_vertices))}"
    state = {}

    def catalog():
        row, svc = incremental_catalog(coo)
        state["child"] = svc.context("g", as_of=1).coo   # (b)'s delta
        return row

    for key, path, run in (
            ("a", f"service tier (a) incremental catalog {size}", catalog),
            ("b", f"service tier (b) hybrid-cloud pools {size}",
             lambda: hybrid_pools(coo, state.pop("child"))),
            ("c", f"service tier (c) runtime and obs {size}",
             lambda: runtime_and_obs(coo)),
            ("d", CALIBRATE_PATH, calibration_run)):
        reset_counts()
        t0 = time.perf_counter()
        row = run()
        paths[path] = launch_counts()
        row["seconds"] = time.perf_counter() - t0
        row["launches"] = paths[path]
        log(f"service ({key}) " + json.dumps(row, default=str))
        out[key] = row
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


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

    # the host's own work in helper processes beside the card's phases:
    # the dry run and HITS's oracle (read by phases 7 and 12), and the
    # main-path graph's host build (read after phase 9)
    helper = host_work_start()
    graph_helper = host_work_start("--host-graph", HOST_GRAPH_DIR)

    # 1. build
    sass = build_all()

    # graphs (host build; the main-path graph is reused by phases 2 and 4)
    g3 = identifier_graph(PHASE3_LOG2V, seed=0)
    g_small = identifier_graph(BITSET_LOG2V, seed=1)

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
    # the batched entry ([Vx, B] state) on the same kinds of layouts, at
    # widths of 4-column groups and not, and x 4 bytes off alignment
    for v, k in ((1000, 37), (300, 1), (64, 0), (2000, 200), (1001, 20),
                 (40, 3000)):
        check_batched(f"ragged {v}x{k}", *_ragged(v, k, gen), gen,
                      BATCHED_WIDTHS, False, checks)
    for v, k, off in ((1000, 19, 3), (500, 129, 5), (40, 3000, 1)):
        nbr, mask, w, _ = _holey(v, k, off, gen)
        check_batched(f"holes {v}x{k}, rows off 16 B by {off}", nbr, mask,
                      w, gen, BATCHED_WIDTHS, False, checks)
        check_batched(f"holes {v}x{k}, rows off 16 B by {off}, x off 4 B",
                      nbr, mask, w, gen, (4, 8, 16), False, checks,
                      misaligned=True)
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
    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 2's small "
        "checks done")

    # 6, 8, 9. the LM phases, while the main-path graph builds on the host
    # (each path's counts are reset inside, just before it)
    paths = {}
    paths[SERVE_PATH], serve_rows, serve_ref = serve_phase()
    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 6 done")
    gc.collect()
    torch.cuda.empty_cache()
    paths[TRAIN_PATH], train_row, train_ref = train_phase(card)
    restart_row = restart_phase(card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 8 done")
    family_rows = []
    t_phase = time.perf_counter()
    for run in FAMILY_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        paths[family_path(run[0])], row = family_phase(*run)
        family_rows.append(row)
    log(f"families: phase 9 took {time.perf_counter() - t_phase:.1f} s")
    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 9 done")
    gc.collect()
    torch.cuda.empty_cache()

    # 2 (main shapes). the main-path graph from its helper process
    t0 = time.perf_counter()
    built = json.loads(host_work_wait(graph_helper, "g4.json").read_text())
    g4 = torch.load(HOST_GRAPH_DIR / "g4.pt", weights_only=False).to("cuda")
    (HOST_GRAPH_DIR / "g4.pt").unlink()   # the helper goes on to phase 13's
    log(f"graph V=2^{MAIN_LOG2V}=2**{MAIN_LOG2V} seed=3: {g4.n_edges} "
        f"directed edges, host build {built['seconds']:.1f} s beside phases "
        f"2-9 (waited and loaded {time.perf_counter() - t0:.1f} s)")
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
        # the fused batches' shapes: 16 queries at 2^20, 8 at 2^24
        check_batched(label, ell.nbr, ell.mask, ell.w, gen,
                      (BATCH_WIDTH if g is g3 else SERVICE_TICKETS,), True,
                      checks, names=("cc", "bfs", "sssp", "sssp_max"))
        if g is g4:
            permuted = permuted_in_ell(ell.nbr, ell.mask, ell.w, perm)
            del ell
            check_kernel(f"{label} permuted ids", *permuted, gen, True,
                         checks)
            check_batched(f"{label} permuted ids", *permuted, gen,
                          (SERVICE_TICKETS,), True, checks, names=("bfs",))
            del permuted
        else:
            del ell
    torch.cuda.empty_cache()
    # the dense superstep's CSR entry at the benchmark's graph500-s21
    check_csr_main(gen, checks)
    torch.cuda.empty_cache()

    # phase 5's OrientedELL of the permuted ids and phase 7's graphs,
    # built on the host beside phases 3-10
    pre = Prebuilt({"oriented_perm": lambda: permuted_oriented(g4, perm),
                    "lpa": lambda: identifier_graph(SLICE_LOG2V, seed=4),
                    "hits": hits_graph})

    # 3-5. the paths; every count is set to 0 just before a path runs
    # and read just after it
    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 2 done")
    reset_counts()
    engine_rows, eng3 = engine_phase(g3, g_small)
    paths[f"LocalEngine.run V=2^{PHASE3_LOG2V} and 2^{BITSET_LOG2V}"] = \
        launch_counts()
    breakdown = superstep_breakdown(eng3, engine_rows, checks)
    batch_rows = batch_phase(eng3, paths)
    del eng3
    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 3 done")
    reset_counts()
    plat, platform_rows, phase4 = platform_phase(g4)
    paths[f"GraphPlatform.query V=2^{MAIN_LOG2V}"] = launch_counts()
    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 4 done")
    reset_counts()
    ell, x, outs, spmv_rows = spmv_path(plat, gen)
    paths[f"LocalEngine._spmv V=2^{MAIN_LOG2V}"] = launch_counts()

    # kernel vs plain at the main-path shapes, on the platform's own
    # derived state (launches here are checks, not a path's)
    check_intersect_main(plat.local.oriented, checks,
                         f"OrientedELL 2^{MAIN_LOG2V}")
    t0 = time.perf_counter()
    o_perm, build_s = pre.get("oriented_perm")
    log(f"OrientedELL of the permuted ids: host build {build_s:.1f} s "
        f"(beside phases 3-4; waited {time.perf_counter() - t0:.1f} s)")
    check_intersect_main(o_perm, checks,
                         f"OrientedELL 2^{MAIN_LOG2V} permuted ids")
    del o_perm, perm
    check_combine(f"capped ELL 2^{MAIN_LOG2V}", ell.nbr, ell.mask, ell.w, x,
                  True, checks, path_out=outs)
    del ell, outs
    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 5 and the "
        "main-shape checks done")

    # 7. the rest of the graph platform (before phase 6, while the phase-4
    # platform is alive for the service's fused batches)
    slice_rows = []
    t_phase = time.perf_counter()
    reset_counts()
    slice_rows.append(service_fusion(plat, g4))
    paths[f"service fusion V=2^{MAIN_LOG2V}"] = launch_counts()
    fusion_s = time.perf_counter() - t_phase
    del plat, g_small
    gc.collect()
    torch.cuda.empty_cache()

    # 10. the distributed engine on a device mesh (on the phase-4 graph,
    # while it is alive; the rest of phase 7 follows); the counts are
    # reset inside, just before each mesh path
    t_phase = time.perf_counter()
    mesh_nccl, paths[MESH_NCCL_PATH] = mesh_nccl_phase(g4, phase4)
    del g4, phase4
    gc.collect()
    torch.cuda.empty_cache()
    mesh_gloo, paths[MESH_GLOO_PATH] = mesh_gloo_phase()
    mesh_rows = {"nccl_1x1": mesh_nccl, "gloo_2x2": mesh_gloo}
    log(f"mesh: phase 10 took {time.perf_counter() - t_phase:.1f} s")
    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 10 done")
    t_phase = time.perf_counter()
    reset_counts()
    for run in (two_hop_phase, lambda: lpa_phase(g3, pre),
                lambda: hits_phase(helper, pre), etl_phase, cli_phase):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        slice_rows.append(run())
        slice_rows[-1]["phase_s"] = time.perf_counter() - t0
    paths["two-hop, LPA, HITS, ETL, CLI"] = launch_counts()
    del g3
    gc.collect()
    torch.cuda.empty_cache()
    log(f"slice: phase 7 took "
        f"{fusion_s + time.perf_counter() - t_phase:.1f} s")
    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 7 done")

    # 11. the LM on a device mesh (the counts are reset inside, just
    # before each mesh path)
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    lm_nccl, paths[LM_MESH_NCCL_PATH] = lm_mesh_nccl_phase(serve_ref,
                                                           train_ref)
    del serve_ref, train_ref
    gc.collect()
    torch.cuda.empty_cache()
    lm_gloo, paths[LM_MESH_GLOO_PATH] = lm_mesh_gloo_phase()
    lm_mesh_rows = {"nccl_1x1": lm_nccl, "gloo_2x2": lm_gloo}
    log(f"lm mesh: phase 11 took {time.perf_counter() - t_phase:.1f} s")
    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 11 done")

    # 12. the dry run's predicted peaks (computed by the host-work helper
    # beside the card's phases) against phases 8 and 6
    dry_row = dryrun_phase(helper, train_row, serve_rows)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 12 done")

    # 13. the service tier on phase 13's snapshot, built by the graph
    # helper beside phases 2-12 (the counts are reset inside, just before
    # each sub-phase)
    t0 = time.perf_counter()
    built13 = json.loads(host_work_wait(graph_helper, "g13.json")
                         .read_text())
    g13 = torch.load(HOST_GRAPH_DIR / "g13.pt",
                     weights_only=False).to("cuda")
    o, _ = graph_helper.communicate(timeout=HOST_WORK_DEADLINE_S)
    if graph_helper.returncode != 0:
        fail(f"the graph helper exited {graph_helper.returncode}:\n"
             f"{o[-3000:]}")
    import shutil
    shutil.rmtree(HOST_GRAPH_DIR, ignore_errors=True)
    log(f"graph V=2^{SERVICE_LOG2V} user-follow seed=5: {g13.n_edges} "
        f"directed edges, host build {built13['seconds']:.1f} s beside "
        f"phases 2-12 (waited and loaded {time.perf_counter() - t0:.1f} s)")
    service_row = service_tier_phase(g13, paths)
    del g13
    log(f"service: phase 13 took {service_row['phase_s']:.1f} s")
    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 13 done")
    must = {f"LocalEngine.run V=2^{PHASE3_LOG2V} and 2^{BITSET_LOG2V}":
                ("pregel_superstep", "pregel_superstep_csr", "ell_intersect"),
            f"GraphPlatform.query V=2^{MAIN_LOG2V}": ("ell_intersect",),
            FORCED_BATCH_PATH: ("pregel_superstep_batched",),
            f"LocalEngine._spmv V=2^{MAIN_LOG2V}": ("ell_combine",),
            SERVE_PATH: ("flash_attention",),
            LM_MESH_NCCL_PATH: ("flash_attention",),
            family_path("olmoe-1b-7b"): ("flash_attention",),
            family_path("hymba-1.5b"): ("flash_attention",),
            CALIBRATE_PATH: ("ell_intersect",)}
    for path, names in must.items():
        for name in names:
            if paths[path][name] == 0:
                fail(f"the path {path} never launched {name}")
    log("launches by path " + json.dumps(paths))

    def by_path(name):
        if name == "pregel_superstep":      # its 1-D entry alone
            return {p: c[name] - c["pregel_superstep_batched"]
                    for p, c in paths.items()}
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

    def batched(layout):
        return next(r for r in checks
                    if r.get("kernel") == "pregel_superstep_batched"
                    and r["layout"] == layout and r["combo"] == "bfs")
    def csr(combo):
        return next(r for r in checks if r.get("kernel") ==
                    "pregel_superstep_csr" and r["combo"] == combo)
    csr_sssp, csr_bfs = csr("sssp"), csr("bfs")
    bat = batched(f"in-ELL 2^{MAIN_LOG2V}")
    bat_perm = batched(f"in-ELL 2^{MAIN_LOG2V} permuted ids")
    bat20 = batched(f"in-ELL 2^{PHASE3_LOG2V}")
    log(json.dumps({"summary": {
        "engine": engine_rows, "superstep_breakdown": breakdown,
        "batch": batch_rows, "platform": platform_rows,
        "spmv": spmv_rows, "slice": slice_rows, "serve": serve_rows,
        "train": train_row, "restart": restart_row,
        "families": family_rows, "mesh": mesh_rows,
        "lm_mesh": lm_mesh_rows, "dryrun": dry_row,
        "service": service_row,
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
        {"name": "pregel_superstep_batched", "route": "cuda",
         "source": "src/repro_torch/kernels/pregel_superstep/csrc/"
                   "superstep.cu",
         "replaces": "src/repro/kernels/pregel_superstep/kernel.py:43",
         "launches": sum(by_path("pregel_superstep_batched").values()),
         "launches_by_path": by_path("pregel_superstep_batched"),
         "max_abs_err": errs("pregel_superstep_batched"),
         **{k: bat[k] for k in numbers},
         "library": bat["library"],
         "permuted_ids": {k: bat_perm[k] for k in numbers},
         f"at_2^{PHASE3_LOG2V}_x{bat20['B']}": {k: bat20[k] for k in numbers},
         "shape": f"BFS (float32, x+1, min) over [V, {bat['B']}] state on "
                  f"the V=2^{MAIN_LOG2V} in-ELL, K={bat['K']}"},
        {"name": "pregel_superstep_csr", "route": "cuda",
         "source": "src/repro_torch/kernels/pregel_superstep/csrc/"
                   "superstep.cu",
         "replaces": None,
         "launches": sum(by_path("pregel_superstep_csr").values()),
         "launches_by_path": by_path("pregel_superstep_csr"),
         "max_abs_err": errs("pregel_superstep_csr"),
         **{k: csr_sssp[k] for k in numbers},
         "library": csr_sssp["library"],
         "bfs": {k: csr_bfs[k] for k in numbers},
         "shape": f"SSSP (float32, x+w, min) over the dense superstep's "
                  f"CSR of graph500-s21, V={csr_sssp['V']}, "
                  f"{csr_sssp['edges']} edges"},
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
         "family_shapes": {r["layout"]: {k: r[k] for k in numbers}
                           for r in checks
                           if r.get("kernel") == "flash_attention"
                           and r["layout"].startswith(("olmoe", "hymba"))},
         "sass": sass,
         "shape": "Gemma-2 2B global layer in prefill: B=2, S=8192, "
                  "Hq/Hkv=8/4, D=256, bf16, causal, softcap 50"}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def mesh_worker_main(argv) -> int:
    """``chip_smoke.py --mesh-rank R``: one rank of phase 10(b);
    ``--lm-mesh-rank R``: one of phase 11(b); ``--host-work DIR``: the
    host-work helper; ``--host-graph DIR``: the 2^24 graph's helper."""
    import torch
    if not torch.cuda.is_available() or \
            not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: a mesh rank needs CUDA and the checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    for flag, run in (("--mesh-rank", mesh_gloo_rank),
                      ("--lm-mesh-rank", lm_mesh_gloo_rank)):
        if flag in argv:
            return run(int(argv[argv.index(flag) + 1]))
    if "--host-work" in argv:
        return host_work_main(argv[argv.index("--host-work") + 1])
    if "--host-graph" in argv:
        return host_graph_main(argv[argv.index("--host-graph") + 1])
    return 2


if __name__ == "__main__":
    try:
        if any(f in sys.argv for f in ("--mesh-rank", "--lm-mesh-rank",
                                       "--host-work", "--host-graph")):
            sys.exit(mesh_worker_main(sys.argv))
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    finally:
        for child in _CHILDREN:
            if child.poll() is None:
                child.kill()
                child.wait()
