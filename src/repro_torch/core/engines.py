"""The two engines of the hybrid platform.

``LocalEngine``        — the Neo4j analogue: one device, graph resident
                         in device memory, count-only fast paths that
                         never materialize results; on the card its fused
                         superstep runs the hand-written CUDA kernel.
``DistributedEngine``  — the Spark/GraphFrames analogue: edge-partitioned
                         BSP supersteps over a ``DeviceMesh`` (SPMD on
                         ``torch.distributed``: every rank runs the same
                         query on its own edge shard), or meshless with
                         its ``n_data`` shards combined on one device.

Both are the *same* generic executor (``Engine``) configured differently:
all per-algorithm behaviour lives in the algorithm registry
(``repro_torch.core.registry``), and the engine only owns graph state —
the exact COO, the cached ``ShardedCOO`` edge shards, the cached
degree-capped ELL adjacency, the uncapped superstep ELL layouts, and a
per-algorithm memo for runner-specific state (e.g. PageRank's normalized
partition).  ``Engine.run(defn, params)`` executes any registered
definition; adding an algorithm therefore never touches this file.

Legacy per-algorithm methods (``eng.pagerank(...)``,
``eng.num_components()``) still work: they dispatch through the
registry's method table via ``__getattr__``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.core import planner as P
from repro_torch.core import registry as R
from repro_torch.core.partition import ShardedCOO, partition
from repro_torch.core.pregel import (
    MeshAxes,
    PregelSpec,
    SuperstepVariant,
    run_pregel,
    run_pregel_frontier,
    run_pregel_fused,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.ell_combine import ops as ell_ops
from repro_torch.kernels.pregel_superstep.ref import as_dtype

# Byte budget for the *uncapped* ELL layouts the fused/frontier superstep
# variants execute over (every edge retained — no MaxAdjacentNodes cap,
# else results would diverge from the dense oracle).  A star graph makes
# the uncapped width V and the layout O(V^2); past this budget the
# variants silently fall back to the dense path.  The value is the
# reference's, kept for parity of variant choices; what budget suits an
# 80 GB card is an open question (ROADMAP).
SUPERSTEP_ELL_BUDGET = 512 * 1024 * 1024


@dataclasses.dataclass
class QueryResult:
    value: object                 # scalar, tensor, or (pairs, valid, count)
    engine: str                   # 'local' | 'distributed'
    iterations: Optional[int] = None
    meta: dict = dataclasses.field(default_factory=dict)


class Engine:
    """Generic registry-driven executor over cached graph state.

    ``device=None`` places the engine on the first CUDA device (raising
    without one), or on a mesh on this rank's device; a graph built
    elsewhere is moved there once.  On a mesh every rank partitions the
    same graph and keeps only its own edge shard on its device.
    ``use_kernels=True`` (the default) runs the fused superstep variant
    through the hand-written kernel's wrapper — the CUDA kernel on the
    card, its plain version on the CPU; ``False`` forces the plain
    PyTorch version everywhere, for parity runs."""

    name = "engine"

    def __init__(self, coo: G.GraphCOO, mesh=None, n_data: int = 1,
                 n_model: int = 1, max_degree: int = 128, device=None,
                 use_kernels: bool = True):
        self._device = resolve_device(device, mesh=mesh)
        self.coo = coo.to(self._device)
        self.mesh = mesh
        self.n_data = n_data
        self.n_model = n_model
        self.max_degree = max_degree
        self.use_kernels = use_kernels
        self._sharded: Optional[ShardedCOO] = None
        self._ell: Optional[G.GraphELL] = None
        self._oriented: Optional[G.OrientedELL] = None
        # Uncapped ELL layouts for the fused ('in') and frontier ('out')
        # superstep variants, built lazily per direction.
        self._superstep_ell: dict = {}
        # Per-algorithm memo: runners stash reusable derived state here
        # (PageRank's normalized partition).
        self.cache: dict = {}
        self.n_runs = 0               # executed queries (cache-hit probe)
        # Measured structure observed while building derived state,
        # fed back into GraphStats by the service/platform layer.
        self._measured: dict = {}
        # Device pool binding (hybrid-cloud federation): ``pool`` is the
        # DevicePool this engine executes on (None = the process
        # default), and ``_pool_twins`` caches one pool-bound twin per
        # pool name — each twin owns its *own* derived state.
        self.pool = None
        self._pool_twins: dict = {}
        # One execution at a time per engine instance (the service
        # runtime runs one worker per engine).  RLock: runners re-enter
        # the lazy properties from inside run().
        self._exec_lock = threading.RLock()
        # Superstep profile sink: ``run(profile=True)`` installs a list
        # here (under _exec_lock) and ``run_superstep`` appends one
        # counter dict per pregel execution it performs.
        self._profile_sink: Optional[list] = None
        # Realized superstep variants of the current run(), in order:
        # what ran after any precondition fallback (meta
        # ['realized_variant'] reports the last).
        self._realized: Optional[list] = None
        # Measurements are read by the *planner* path while a worker may
        # hold _exec_lock — a separate lock keeps submit latency flat.
        self._meta_lock = threading.Lock()

    @property
    def device(self) -> torch.device:
        """Where this engine's derived state and vertex state live: the
        pool's first device for a pool-bound twin, else the engine's."""
        devs = getattr(self.pool, "devices", ()) if self.pool is not None \
            else ()
        return torch.device(devs[0]) if devs else self._device

    def _edges_host(self):
        coo = self.coo
        return (G.to_numpy(coo.src[: coo.n_edges]),
                G.to_numpy(coo.dst[: coo.n_edges]),
                G.to_numpy(coo.w[: coo.n_edges]))

    # -- cached graph state -------------------------------------------------
    @property
    def sharded(self) -> ShardedCOO:
        """Edge shards, packed once — repeated interactive queries must
        not repay the O(E) host-side partition."""
        with self._exec_lock:
            if self._sharded is None:
                self._sharded = self.partition_of(self.coo)
            return self._sharded

    def partition_of(self, g: G.GraphCOO) -> ShardedCOO:
        """``g``'s edge shards for this engine: all of them on its
        device, or on a mesh this rank's one (the partition is built on
        the host, and only the shard moves to the device)."""
        if self.mesh is None:
            return partition(g, self.n_data, self.n_model,
                             device=self.device)
        ax = MeshAxes(self.mesh)
        sg = partition(g, self.n_data, self.n_model, device="cpu")
        return sg.shard(ax.d, ax.m if self.n_model > 1 else 0,
                        device=self.device)

    @property
    def ell(self) -> G.GraphELL:
        """Degree-capped ELL adjacency (in-direction), built once."""
        with self._exec_lock:
            if self._ell is None:
                coo = self.coo
                src, dst, w = self._edges_host()
                if coo.n_edges:
                    # the true (uncapped) max in-degree falls out of the
                    # ELL build for free — record it for planner stats
                    md = int(np.bincount(
                        dst, minlength=coo.n_vertices).max())
                    with self._meta_lock:
                        self._measured["max_degree"] = md
                self._ell = G.build_ell(src, dst, coo.n_vertices,
                                        self.max_degree, w=w,
                                        direction="in", device=self.device)
            return self._ell

    @property
    def oriented(self) -> G.OrientedELL:
        """Degree-ordered sorted-neighbor orientation, built once
        (requires a symmetrized graph)."""
        with self._exec_lock:
            if self._oriented is None:
                coo = self.coo
                G.require_symmetric(coo, "oriented adjacency")
                src, dst, _ = self._edges_host()
                self._oriented = G.build_oriented_ell(
                    src, dst, coo.n_vertices, device=self.device)
                with self._meta_lock:
                    self._measured["oriented_width"] = \
                        self._oriented.max_out_degree
            return self._oriented

    def _measured_degree(self, direction: str) -> int:
        """True (uncapped) max in- or out-degree, computed host-side
        once and cached — sizes the superstep ELL layouts and feeds the
        planner's measured stats."""
        key = "max_degree" if direction == "in" else "max_out_degree"
        with self._meta_lock:
            v = self._measured.get(key)
        if v is None:
            coo = self.coo
            col = coo.dst if direction == "in" else coo.src
            arr = G.to_numpy(col[: coo.n_edges])
            v = int(np.bincount(arr, minlength=coo.n_vertices).max()) \
                if arr.size else 0
            with self._meta_lock:
                self._measured[key] = v
        return v

    def superstep_ell(self, direction: str) -> G.GraphELL:
        """Uncapped ELL layout for the superstep variants: ``'in'`` for
        the fused kernel (row v = sources into v), ``'out'`` for the
        frontier scan (row u = destinations of u).  Every edge retained.
        ``superstep_supported`` gates on the byte budget before this is
        built."""
        with self._exec_lock:
            got = self._superstep_ell.get(direction)
            if got is None:
                coo = self.coo
                src, dst, w = self._edges_host()
                kmax = max(self._measured_degree(direction), 1)
                got = G.build_ell(src, dst, coo.n_vertices, kmax, w=w,
                                  direction=direction, device=self.device)
                self._superstep_ell[direction] = got
            return got

    def superstep_supported(self, spec: PregelSpec, variant: str) -> bool:
        """Do this engine + spec satisfy the variant's preconditions?

        Dense always holds.  Fused/frontier need: single-device vertex
        state (no mesh, no model sharding), an elementwise single-monoid
        message, and an uncapped ELL within the byte budget; frontier
        additionally needs a declared (and matching) ``frontier_mode``.
        These are the reference's preconditions and nothing more: a fused
        run on the card whose message is not one of the kernel's compiled
        edge programs reaches the kernel's wrapper and raises there.
        """
        if variant == "dense":
            return True
        if variant not in ("fused", "frontier"):
            raise ValueError(f"unknown superstep variant {variant!r}")
        if self.mesh is not None or self.n_model > 1:
            return False
        if (not spec.elementwise_message or spec.needs_dst_state
                or isinstance(spec.combine, tuple)):
            return False
        V = self.coo.n_vertices
        if V == 0:
            return False
        if variant == "frontier":
            if spec.frontier_mode == "monotone":
                if spec.combine not in ("min", "max"):
                    return False
            elif spec.frontier_mode == "delta":
                if spec.combine != "sum":
                    return False
            else:
                return False
        direction = "in" if variant == "fused" else "out"
        kmax = max(self._measured_degree(direction), 1)
        return V * kmax * 9 <= SUPERSTEP_ELL_BUDGET

    def run_superstep(self, spec: PregelSpec, init_state, max_iters: int,
                      variant: Optional[str] = None, init_active=None):
        """Single dispatch point for superstep execution strategies.

        ``'dense'``/``None`` is the gather/segment-combine path
        (``run_pregel`` — the correctness oracle).  ``'fused'`` runs the
        ELL-blocked fused kernel, ``'frontier'`` the packed active-list
        loop; both fall back to dense when ``superstep_supported`` says
        no, so a planner-forced variant never errors on the reference's
        preconditions and the variants contract (identical results
        everywhere) holds unconditionally.  On the card the fused
        variant launches the CUDA kernel (``use_kernels=True``) or runs
        the plain version on request (``False``); it never substitutes
        one for the other.
        ``'auto'`` prefers frontier, then fused, then dense.

        ``init_active`` (optional ``bool [V]``) seeds the frontier
        variant's first active set — the incremental-maintenance seam.

        Inside ``run`` the realized variant is reported as
        ``meta['realized_variant']``.  With a profile sink installed
        (``run(profile=True)``), each execution appends a superstep
        counter dict — realized variant,
        iterations, halt step, message traffic, per-round frontier
        occupancy.  Results are identical either way.
        """
        v = variant or "dense"
        if v == "auto":
            if self.superstep_supported(spec, "frontier"):
                v = "frontier"
            elif self.superstep_supported(spec, "fused"):
                v = "fused"
            else:
                v = "dense"
        sink = self._profile_sink
        if v == "fused" and self.superstep_supported(spec, "fused"):
            V = self.coo.n_vertices
            ell = self.superstep_ell("in")
            state, iters = run_pregel_fused(
                spec, ell, init_state[:V], max_iters,
                use_kernels=self.use_kernels)
            self._ran("fused")
            if sink is not None:
                sink.append(self._superstep_profile(
                    "fused", spec, init_state, iters, max_iters,
                    slots_per_iter=int(ell.nbr.numel())))
            return state, iters
        if v == "frontier" and self.superstep_supported(spec, "frontier"):
            V = self.coo.n_vertices
            active = None if init_active is None else init_active[:V]
            ell = self.superstep_ell("out")
            self._ran("frontier")
            if sink is None:
                return run_pregel_frontier(
                    spec, ell, init_state[:V], max_iters,
                    init_active=active)
            state, iters, occ = run_pregel_frontier(
                spec, ell, init_state[:V], max_iters,
                init_active=active, profile=True)
            n = int(iters)
            occupancy = [int(c) for c in occ[:n].tolist()]
            # slots counted in the reference's 1024-row frontier blocks,
            # so these counters read as the reference's do
            B = min(1024, max(V, 1))
            K = int(ell.nbr.shape[1])
            slots = sum(-(-c // B) * B * K for c in occupancy)
            prof = self._superstep_profile(
                "frontier", spec, init_state, iters, max_iters,
                slots_total=slots)
            prof["frontier_occupancy"] = occupancy
            prof["block_rows"] = B
            sink.append(prof)
            return state, iters
        state, iters = run_pregel(spec, self.sharded, init_state,
                                  max_iters, mesh=self.mesh)
        self._ran("dense")
        if sink is not None:
            sink.append(self._superstep_profile(
                "dense", spec, init_state, iters, max_iters,
                slots_per_iter=int(self.coo.n_edges)))
        return state, iters

    def _ran(self, variant: str) -> None:
        if self._realized is not None:
            self._realized.append(variant)

    def _superstep_profile(self, variant: str, spec: PregelSpec,
                           init_state, iters, max_iters: int,
                           slots_per_iter: Optional[int] = None,
                           slots_total: Optional[int] = None) -> dict:
        """One execution's superstep counters.  Message traffic is
        counted in *slots* (gather/scatter positions the variant
        scans per run: E per dense round, the full ELL per fused
        round, the active blocks per frontier round) times the message
        element size."""
        n = int(iters)
        if slots_total is None:
            slots_total = int(slots_per_iter or 0) * n
        dtype = (as_dtype(spec.message_dtype)
                 if spec.message_dtype is not None else init_state.dtype)
        itemsize = torch.empty((), dtype=dtype).element_size()
        return {
            "variant": variant,
            "iterations": n,
            "max_iters": int(max_iters),
            "halted": n < int(max_iters),
            "halt_step": n,
            "message_slots": int(slots_total),
            "message_bytes": int(slots_total) * int(itemsize),
        }

    # -- device pools -------------------------------------------------------
    def for_pool(self, pool) -> "Engine":
        """The pool-bound twin of this engine (cached per pool name).

        The twin shares the exact COO but owns separate derived state —
        its ShardedCOO/ELL builds land on (and stay resident on) the
        pool's first device.  ``None`` (or this engine's own pool)
        returns ``self``; results are contractually identical wherever
        they run.
        """
        if pool is None:
            return self
        if self.pool is not None and self.pool.name == pool.name:
            return self
        with self._meta_lock:
            twin = self._pool_twins.get(pool.name)
            if twin is None:
                twin = self._clone()
                twin.pool = pool
                if twin.device != twin.coo.device:
                    twin.coo = twin.coo.to(twin.device)
                self._pool_twins[pool.name] = twin
            return twin

    def _clone(self) -> "Engine":
        """A fresh engine over the same COO and configuration, with no
        derived state — subclasses override to keep their extras."""
        return Engine(self.coo, mesh=self.mesh, n_data=self.n_data,
                      n_model=self.n_model, max_degree=self.max_degree,
                      device=self._device, use_kernels=self.use_kernels)

    def pool_twins(self) -> dict:
        """Snapshot of the pool-bound twins built so far (the service
        merges their measured structure alongside this engine's)."""
        with self._meta_lock:
            return dict(self._pool_twins)

    def _device_scope(self):
        """Execution placement: a CUDA engine makes its device current
        for the duration of a run (the counterpart of the reference's
        default-device scope); a CPU engine runs unscoped."""
        dev = self.device
        if dev.type == "cuda":
            return torch.cuda.device(dev)
        return contextlib.nullcontext()

    def measurements(self) -> dict:
        """Measured graph structure observed so far (only fields whose
        derived state this engine has actually built) — the feedback
        path that replaces the planner's analytic stand-ins.  Safe to
        call from the submit/plan path while a worker is executing."""
        with self._meta_lock:
            return dict(self._measured)

    # -- generic execution --------------------------------------------------
    def run(self, algorithm, params: Optional[dict] = None,
            count_only: bool = False,
            variant: Optional[str] = None,
            seed=None, delta=None, profile: bool = False) -> QueryResult:
        """Execute any registered algorithm on this engine's graph.

        ``variant`` selects one of the definition's registered execution
        strategies (the platform passes the planner's choice through).
        Left ``None`` on a multi-variant definition, the engine resolves
        the cheapest feasible variant for *its own* graph via the cost
        hook.

        ``seed`` is an ancestor snapshot's cached result for the same
        query (any object with ``.value``); ``delta`` the
        ``GraphDelta`` between that ancestor and this engine's graph.
        With both present and the definition declaring an
        ``incremental`` hook, the engine repairs the seed against the
        delta; with only a seed and a ``warm_start`` hook, it restarts
        the fixpoint from the seed.  Either hook may decline (return
        ``None``) — execution falls back to the cold runner, so seeds
        affect time, never correctness.  ``meta['mode']`` records the
        realized path ('incremental' | 'warm').

        ``meta['realized_variant']`` is the superstep variant the last
        vertex program dispatched by this engine actually ran ('dense' |
        'fused' | 'frontier'), after any precondition fallback; absent
        when none was (a result-cache hit, or a runner with a loop of its
        own such as PageRank's power iteration).

        ``profile=True`` collects superstep counters from any pregel
        loop the execution runs and attaches the last (outermost)
        one as ``meta['superstep']``.
        """
        defn = R.get(algorithm) if isinstance(algorithm, str) else algorithm
        if self.name not in defn.engines:
            raise ValueError(
                f"{defn.name!r} supports engine(s) {defn.engines}, "
                f"not {self.name!r}")
        p = defn.validate(params)
        if defn.requires_symmetric:
            G.require_symmetric(self.coo, defn.name)
        if variant is None and defn.variants:
            variant = self._select_variant(defn, p, count_only)
        mode = None
        count_fast = False
        sink = None
        realized = None
        with self._exec_lock, self._device_scope():
            self.n_runs += 1
            self._realized = []
            if profile:
                self._profile_sink = []
            try:
                # the fault-injection seam: per attempt, so the service's
                # retry loop re-triggers an installed policy on every try
                R.apply_fault(defn.name)
                count_fast = count_only and defn.count_run is not None
                if count_fast:
                    value, iters = self._invoke(defn.count_run, defn, p)
                else:
                    got = None
                    if seed is not None and delta is not None \
                            and defn.incremental is not None:
                        got = defn.incremental(self, p, seed, delta)
                        if got is not None:
                            mode = "incremental"
                    if got is None and seed is not None \
                            and defn.warm_start is not None:
                        got = defn.warm_start(self, p, seed)
                        if got is not None:
                            mode = "warm"
                    if got is not None:
                        value, iters = got
                        iters = int(iters) if iters is not None else None
                    else:
                        value, iters = self._invoke(
                            defn.runner_for(variant), defn, p)
            finally:
                realized, self._realized = self._realized, None
                if profile:
                    sink, self._profile_sink = self._profile_sink, None
        if not count_fast:
            if count_only and defn.count is not None:
                value = defn.count(value)
        meta = {}
        if not count_fast:
            if variant is not None:
                meta["variant"] = variant
            if mode is not None:
                meta["mode"] = mode
        if realized:
            meta["realized_variant"] = realized[-1]
        if sink:
            meta["superstep"] = sink[-1]
        return QueryResult(value, self.name, iters, meta)

    def run_batch(self, algorithm, params_list,
                  count_only=None, profile: bool = False) -> list:
        """Execute B compatible queries of one algorithm as a single
        fused program (the service's batch-packing path, NScale-style).

        The caller guarantees compatibility — same algorithm, same graph
        (this engine's), equal ``fuse`` keys.  Returns one
        ``QueryResult`` per entry of ``params_list``, in order; each
        value is bit-identical to ``run`` on the same params alone.
        ``count_only`` is per-query: fused tickets that only want the
        count get the registered reducer applied to their slice.  Every
        member's meta carries ``fused`` (batch size, its index, the
        runner's counters) and, as ``run`` reports it, the superstep
        variant the fused program realized.
        """
        defn = R.get(algorithm) if isinstance(algorithm, str) else algorithm
        if defn.batch_runner is None:
            raise ValueError(f"{defn.name!r} has no batch runner")
        if self.name not in defn.engines:
            raise ValueError(
                f"{defn.name!r} supports engine(s) {defn.engines}, "
                f"not {self.name!r}")
        co = list(count_only) if count_only is not None \
            else [False] * len(params_list)
        if len(co) != len(params_list):
            raise ValueError("count_only length mismatch")
        ps = [defn.validate(p) for p in params_list]
        if defn.requires_symmetric:
            G.require_symmetric(self.coo, defn.name)
        sink = None
        realized = None
        with self._exec_lock, self._device_scope():
            self.n_runs += 1
            self._realized = []
            if profile:
                self._profile_sink = []
            try:
                R.apply_fault(defn.name)  # one fused execution, one fault
                values, iters, fused_meta = defn.batch_runner(self, ps)
            finally:
                realized, self._realized = self._realized, None
                if profile:
                    sink, self._profile_sink = self._profile_sink, None
        if len(values) != len(ps):
            raise ValueError(
                f"{defn.name}: batch runner returned {len(values)} values "
                f"for {len(ps)} queries")
        iters = int(iters) if iters is not None else None
        out = []
        for i, (value, c) in enumerate(zip(values, co)):
            if c and defn.count is not None:
                value = defn.count(value)
            meta = {"fused": {"batch_size": len(ps), "index": i,
                              **(fused_meta or {})}}
            if realized:
                meta["realized_variant"] = realized[-1]
            if sink:
                # one fused execution -> the same shared counters on
                # every member's result (stripped, like 'fused', from
                # cached re-serves)
                meta["superstep"] = sink[-1]
            out.append(QueryResult(value, self.name, iters, meta))
        return out

    def _select_variant(self, defn: R.AlgorithmDef, params: dict,
                        count_only: bool) -> Optional[str]:
        """Cheapest feasible variant for this engine's graph (the same
        cost hook the planner consults, restricted to this engine,
        including any structure this engine has already measured)."""
        if defn.cost is None:
            return None
        stats = P.GraphStats.of(self.coo).with_measurements(
            self.measurements())
        specs = defn.cost(stats, params, count_only)
        if isinstance(specs, P.QuerySpec):
            return specs.variant
        best = P.best_spec_for_engine(stats, specs, self.name,
                                      max(self.n_data * self.n_model, 1))
        return best.variant

    def _invoke(self, runner, defn: R.AlgorithmDef, params: dict):
        if isinstance(runner, SuperstepVariant):
            state, max_iters = defn.init(self, params)
            state, iters = self.run_superstep(runner.spec, state,
                                              max_iters,
                                              variant=runner.mode)
            return state[: self.coo.n_vertices], int(iters)
        if isinstance(runner, PregelSpec):
            state, max_iters = defn.init(self, params)
            state, iters = run_pregel(runner, self.sharded, state,
                                      max_iters, mesh=self.mesh)
            self._ran("dense")
            if self._profile_sink is not None:
                self._profile_sink.append(self._superstep_profile(
                    "dense", runner, state, iters, max_iters,
                    slots_per_iter=int(self.coo.n_edges)))
            return state[: self.coo.n_vertices], int(iters)
        value, iters = runner(self, **params)
        return value, (int(iters) if iters is not None else None)

    # -- registry-backed method dispatch ------------------------------------
    def __getattr__(self, name: str):
        # only reached when normal attribute lookup fails
        if name.startswith("_"):
            raise AttributeError(name)
        entry = R.method_table().get(name)
        if entry is None:
            raise AttributeError(
                f"{type(self).__name__!r} object has no attribute {name!r}")
        defn, count_only = entry
        order = [p.name for p in defn.params]

        def call(*args, variant=None, **kw):
            if len(args) > len(order):
                raise TypeError(
                    f"{name}() takes at most {len(order)} positional "
                    f"arguments ({len(args)} given)")
            merged = dict(zip(order, args))
            dup = set(merged) & set(kw)
            if dup:
                raise TypeError(
                    f"{name}() got multiple values for {sorted(dup)}")
            merged.update(kw)
            return self.run(defn, merged, count_only=count_only,
                            variant=variant)

        call.__name__ = name
        call.__doc__ = defn.doc
        return call


class LocalEngine(Engine):
    """Single-device in-memory engine (Neo4j analogue).

    Holds the graph in exact COO (+ the degree-capped ELL for motif/
    similarity queries).  ``use_kernels`` is the counterpart of the
    reference's ``use_pallas``: on by default (the reference's service
    never turns ``use_pallas`` on; the port's service runs the CUDA
    kernels on the card), ``False`` for plain-version parity runs.
    ``_spmv`` is the ELL gather + combine under the same switch: the
    ``ell_combine`` wrapper (the kernel on the card) or its plain version.
    """

    name = "local"

    def __init__(self, coo: G.GraphCOO, max_degree: int = 128,
                 use_kernels: bool = True, device=None):
        super().__init__(coo, mesh=None, n_data=1, n_model=1,
                         max_degree=max_degree, device=device,
                         use_kernels=use_kernels)
        self._spmv = ell_ops.ell_spmv if use_kernels else ell_ops.ell_spmv_ref

    def _clone(self) -> "LocalEngine":
        return LocalEngine(self.coo, max_degree=self.max_degree,
                           use_kernels=self.use_kernels, device=self._device)


class DistributedEngine(Engine):
    """Edge-partitioned BSP engine over a device mesh (Spark analogue).

    On a ``DeviceMesh`` the shard counts are the mesh's: ``n_data`` its
    ``data`` axis, ``n_model`` its ``model`` axis when ``n_model > 1``
    asks for the 2-D layout (else 1: a replicated model axis).  Without
    one, the ``n_data`` edge shards are combined on one device."""

    name = "distributed"

    def __init__(self, coo: G.GraphCOO, mesh=None,
                 n_data: Optional[int] = None, n_model: int = 1,
                 max_degree: int = 128, device=None,
                 use_kernels: bool = True):
        if mesh is not None:
            axis_sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
            nd = int(axis_sizes.get("data", 1))
            nm = int(axis_sizes.get("model", 1)) if n_model > 1 else 1
        else:
            nd = n_data or 1
            nm = n_model
        super().__init__(coo, mesh=mesh, n_data=nd, n_model=nm,
                         max_degree=max_degree, device=device,
                         use_kernels=use_kernels)

    def _clone(self) -> "DistributedEngine":
        return DistributedEngine(self.coo, mesh=self.mesh,
                                 n_data=self.n_data, n_model=self.n_model,
                                 max_degree=self.max_degree,
                                 device=self._device,
                                 use_kernels=self.use_kernels)
