"""GraphAnalyticsService — the platform as a shared analytics service.

The paper's system is not a one-query-at-a-time library: it fields many
concurrent analytics queries over a catalog of graph snapshots, routing
each across the interactive/batch divide (Sections III–IV; the companion
SQL-serving paper makes the admission/routing layer explicit).  This
module is that service tier:

* **Catalog** — named graph snapshots, content-digest-deduplicated: two
  names over byte-identical snapshots share one :class:`GraphContext`
  (engines, derived state, plan cache), and every graph shares one
  result cache keyed on content digests, so a query answered for any
  snapshot is a hit for every byte-identical reload.
* **Admission & tiers** — ``submit`` plans the query first, classifies
  it *interactive* vs *batch* from the planner's cost estimate
  (thresholds come from the active :class:`~repro_torch.core.planner.
  CalibrationProfile` unless overridden), and rejects over-budget
  queries up front with the plan attached — the user sees *why* before
  any engine burns a cycle.  Queues are bounded: a tier at its depth
  budget rejects with a typed :class:`~repro_torch.core.runtime.Backpressure`
  instead of accreting unbounded work.
* **Concurrent runtime** — ``drain(workers=N)`` runs the queues on a
  worker pool (one execution at a time per engine instance, enforced by
  the engine's own lock), so a fused batch on one engine overlaps
  interactive traffic on the other.  Workers *preempt at dequeue time*:
  every scan serves all interactive queues before any batch queue, so
  queued interactive tickets jump every batch group that has not
  started yet.  Per-ticket results are byte-identical to a serial
  ``drain()`` — the fusion contract (slices bit-identical to solo runs)
  makes results order-independent.
* **Retry & dead-letter** — a failed execution retries under the
  service's :class:`~repro_torch.core.runtime.RetryPolicy` (jittered
  exponential backoff, deterministic per ticket given the service
  seed); schema-class errors and tickets out of attempts land in the
  ``dead-letter`` state keeping their full exception chain, ``result``
  re-raises, and the drain continues with the rest of the queue.
* **Fused batch execution** — the NScale insight: many small per-source
  computations over one graph should run as *one* shared execution.
  The scheduler coalesces queued batch tickets with equal
  ``(graph, algorithm, fuse-key)`` into a single
  ``AlgorithmDef.batch_runner`` call — K BFS/SSSP frontiers as one
  ``[V, K]`` pregel program, K jaccard pair-batches as one kernel
  call — and scatters the per-ticket results (each bit-identical to a
  solo run) back through the shared result cache.
* **Metrics** — ``metrics()`` snapshots queue depths, per-tier latency
  histograms, cache hit rates, fusion widths and retry/dead-letter
  counters under one lock — the in-process analogue of the exemplar
  queue-worker stacks' Prometheus gauges.
* **Time-versioned catalog** — ``add_snapshot(name, ..., as_of=...)``
  registers the daily reload of a graph as a new *version* of the same
  catalog name, either from full bytes or from a delta applied to the
  previous version (``added=``/``removed=`` edge lists).  Versions form
  a lineage chain through each snapshot's recorded ``parent_digest``;
  ``submit``/``call`` take ``as_of`` and resolve the newest version at
  or before that timestamp.  When a query arrives for a snapshot whose
  ancestor already answered the same query, the catalog finds that
  result through the digest-keyed result cache and hands it to the
  engine as a *seed*: exact monotone algorithms run a localized
  incremental repair from the delta's touched vertices (byte-identical
  to the cold run), fixpoint algorithms warm-start from the converged
  vector (same answer within tolerance, fewer iterations).  The
  planner prices incremental-vs-full per query
  (:func:`~repro_torch.core.planner.price_incremental`), so an over-large
  delta falls back to a full recompute.
* **Federation** — a service built over a non-trivial
  :class:`~repro_torch.core.pools.PoolSet` plans every query over
  (pool, engine, variant): ``add_graph(..., pools=[...])`` declares
  where each snapshot is *resident*, the planner prices non-resident
  placements with the pool's link bandwidth, queues become
  per-(pool, engine, tier), a :class:`~repro_torch.core.runtime.PoolGate`
  caps per-pool in-flight work, and batch tickets **spill** to another
  resident pool when the preferred pool's batch queue is at its
  capacity.  Executing on a previously non-resident pool records the
  snapshot bytes in a :class:`~repro_torch.core.runtime.TransferLedger` and
  marks the pool resident (bumping the context's residency generation,
  which plan and result cache keys include).  Results stay
  bit-identical regardless of the pool that runs them.

``GraphPlatform`` (``repro_torch.core.query``) survives as a thin per-graph
facade over these primitives: its synchronous ``query`` is
:meth:`GraphAnalyticsService.call` on a one-entry catalog.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Iterable, Optional, Sequence

from repro_torch.core import graph as G
from repro_torch.core import obs
from repro_torch.core import planner as P
from repro_torch.core import pools as PL
from repro_torch.core import registry as R
from repro_torch.core import runtime as RT
from repro_torch.core.engines import DistributedEngine, LocalEngine, QueryResult
from repro_torch.core.pregel import MeshAxes
from repro_torch.device import resolve_device

# re-exported so service users see one import surface for the typed
# submit-time rejections (AdmissionRejected lives here, Backpressure in
# runtime.py next to the policies that drive it)
Backpressure = RT.Backpressure


class AdmissionRejected(Exception):
    """Raised by ``submit`` when a query's estimated cost exceeds the
    admission budget.  Carries the plan, so the caller sees the engine
    choice and both estimates that sank the query."""

    def __init__(self, graph_name: str, query, plan: P.Plan, est_s: float,
                 budget_s: float):
        self.graph_name = graph_name
        self.query = query
        self.plan = plan
        self.est_s = est_s
        self.budget_s = budget_s
        super().__init__(
            f"query {query.algorithm!r} on {graph_name!r} rejected: "
            f"estimated {est_s:.3g}s exceeds the admission budget "
            f"{budget_s:.3g}s ({plan.reason})")


@dataclasses.dataclass
class QueryTicket:
    """One admitted query: its plan, its tier, and its place in line.

    The ticket pins the ``GraphContext`` it was planned against, so a
    later ``add_graph`` rebinding the same catalog name (or a
    ``remove_graph``) never redirects queued work onto a different
    snapshot — the ticket executes against the bytes it was admitted
    for.  ``fuse_key`` is computed once at submit (over validated
    params); ``None`` means unfusable.

    Lifecycle: ``queued`` → ``running`` (claimed by a worker or an
    inline ``result``) → ``done`` | ``dead-letter``.  A dead-lettered
    ticket keeps its exception chain in ``error`` (attempt k's error is
    the ``__cause__`` of attempt k+1's) and ``attempts`` records how
    many executions it consumed."""

    ticket_id: int
    graph_name: str
    query: Any                    # GraphQuery (duck-typed to avoid cycle)
    plan: P.Plan
    tier: str                     # 'interactive' | 'batch'
    est_s: float
    status: str = "queued"        # | 'running' | 'done' | 'dead-letter'
    context: Any = dataclasses.field(default=None, repr=False)
    fuse_key: Any = dataclasses.field(default=None, repr=False)
    error: Optional[BaseException] = dataclasses.field(default=None,
                                                       repr=False)
    attempts: int = 0
    queued_at: float = dataclasses.field(default=0.0, repr=False)
    pool: Optional[str] = None    # placement pool (None = legacy/trivial)
    # warm-start seed (an ancestor snapshot's QueryResult) pinned at
    # submit for plans whose mode is not 'full'; None otherwise
    seed: Any = dataclasses.field(default=None, repr=False)


class GraphContext:
    """One graph snapshot's service primitives: lazy engines over shared
    derived state, measured-stats feedback, and a per-shape plan cache.

    This is the machinery ``GraphPlatform`` used to own inline; the
    platform is now a facade over a single-entry catalog of these.
    """

    def __init__(self, coo: G.GraphCOO, mesh=None, n_data: int = 1,
                 n_model: int = 1, local_max_degree: int = 128,
                 force_engine: Optional[str] = None,
                 plan_cache_size: int = 128,
                 pools: Optional[PL.PoolSet] = None,
                 residency: Optional[Iterable[str]] = None,
                 device=None):
        # the snapshot's home device: ``None`` is the first CUDA device
        # (raising without one), on a mesh this rank's; a graph built
        # elsewhere moves here once
        self.device = resolve_device(device, mesh=mesh)
        coo = coo.to(self.device)
        self.coo = coo
        self.mesh = mesh
        self.force_engine = force_engine
        # -- federation: the service's poolset and this snapshot's
        # residency.  ``_declared`` pools come from add_graph; the
        # ``_materialized`` set grows when an execution builds derived
        # state on a pool the snapshot was not declared on.  Effective
        # residency is their union; every change bumps the residency
        # generation, which the plan cache (below) and the service's
        # result-cache keys incorporate.
        self._pools = pools
        self._declared: set = set(residency or ())
        self._materialized: set = set()
        self._residency_generation = 0
        self._seen_residency_gen = 0
        self._pools_generation = (pools.generation
                                  if pools is not None else 0)
        self._base_stats = P.GraphStats.of(coo)
        self.stats = self._base_stats
        self._local: Optional[LocalEngine] = None
        self._dist: Optional[DistributedEngine] = None
        self._local_max_degree = local_max_degree
        self._n_data, self._n_model = n_data, n_model
        # on a mesh every rank plans; rank (0, 0)'s plan is the one all
        # of them run (see ``plan``)
        self._axes = MeshAxes(mesh) if mesh is not None else None
        self.n_chips = int(mesh.mesh.numel()) if mesh is not None \
            else max(n_data * n_model, 1)
        self._plan_cache_size = plan_cache_size
        self._plan_cache: OrderedDict = OrderedDict()
        self._applied_measurements: dict = {}
        self._profile_generation = P.calibration_generation()
        # submit-time planning may race worker-thread executions that
        # feed measurements back; the plan cache and stats swap are the
        # shared state (engine construction is also guarded here)
        self._lock = threading.RLock()

    def config_key(self) -> tuple:
        """What must match for two catalog entries to share this context."""
        return (id(self.mesh), self._n_data, self._n_model,
                self._local_max_degree, self.force_engine, str(self.device))

    # lazy engine construction: building ELL/partitions is ETL work we
    # only pay when the planner actually routes there.
    @property
    def local(self) -> LocalEngine:
        with self._lock:
            if self._local is None:
                self._local = LocalEngine(self.coo, self._local_max_degree,
                                          device=self.device)
            return self._local

    @property
    def distributed(self) -> DistributedEngine:
        with self._lock:
            if self._dist is None:
                self._dist = DistributedEngine(self.coo, mesh=self.mesh,
                                               n_data=self._n_data,
                                               n_model=self._n_model,
                                               device=self.device)
            return self._dist

    def engine(self, name: str, pool=None):
        """The engine for ``name`` — the process-default instance, or
        its pool-bound twin when a :class:`~repro_torch.core.pools.DevicePool`
        is given (the ``Engine.for_pool`` seam)."""
        base = self.local if name == "local" else self.distributed
        if pool is None:
            return base
        return base.for_pool(pool)

    def pool_for_plan(self, plan: P.Plan):
        """Resolve a plan's pool name to the DevicePool to execute on;
        ``None`` for legacy plans and trivial (single default) poolsets,
        which keeps the pre-federation execution path byte-for-byte."""
        if self._pools is None or plan.pool is None or self._pools.trivial:
            return None
        return self._pools.get(plan.pool)

    # -- residency ----------------------------------------------------------
    def _residency_change(self, declared=None, materialize=None) -> bool:
        before = self._declared | self._materialized
        if declared is not None:
            self._declared = set(declared)
        if materialize is not None:
            self._materialized.add(materialize)
        changed = (self._declared | self._materialized) != before
        if changed:
            self._residency_generation += 1
        return changed

    @property
    def residency(self) -> frozenset:
        """Pool names where this snapshot is resident (declared at
        add_graph plus pools materialized by execution)."""
        with self._lock:
            return frozenset(self._declared | self._materialized)

    @property
    def residency_generation(self) -> int:
        with self._lock:
            return self._residency_generation

    def declare_residency(self, names: Iterable[str]) -> bool:
        """Replace the declared residency set (the service recomputes it
        as the union over catalog names sharing this context).  Returns
        whether the effective residency changed (generation bumped)."""
        with self._lock:
            return self._residency_change(declared=names)

    def mark_resident(self, pool_name: str) -> bool:
        """Record that an execution materialized derived state on
        ``pool_name``.  True iff the pool was newly resident — the
        moment the service charges the transfer ledger."""
        with self._lock:
            return self._residency_change(materialize=pool_name)

    def current_stats(self) -> P.GraphStats:
        """Stats with every measurement the engines have fed back so far
        (observed max in-degree, built ``OrientedELL`` width).  A change
        invalidates the plan cache, and so does a calibration-profile
        swap: cached plans were costed on constants (analytic stand-ins,
        old profile) that just got replaced."""
        with self._lock:
            meas: dict = {}
            for eng in (self._local, self._dist):
                if eng is not None:
                    meas.update(eng.measurements())
                    for twin in eng.pool_twins().values():
                        meas.update(twin.measurements())
            if meas != self._applied_measurements:
                self._applied_measurements = meas
                self.stats = self._base_stats.with_measurements(meas)
                self._plan_cache.clear()
            gen = P.calibration_generation()
            if gen != self._profile_generation:
                self._profile_generation = gen
                self._plan_cache.clear()
            # federation invalidation: a pool-health flip (poolset
            # generation) or a residency change (replica removed, pool
            # materialized) re-costs every cached plan
            if self._pools is not None:
                pg = self._pools.generation
                if pg != self._pools_generation:
                    self._pools_generation = pg
                    self._plan_cache.clear()
            if self._residency_generation != self._seen_residency_gen:
                self._seen_residency_gen = self._residency_generation
                self._plan_cache.clear()
            return self.stats

    @staticmethod
    def _query_key(q):
        try:
            key = q.key()
            hash(key)           # force the check: freeze() may pass
            return key          # exotic values through unhashed
        except TypeError:       # unhashable parameter value: skip caching
            return None

    def _placement_pools(self):
        """Pools the planner minimizes over, or ``None`` for the legacy
        (engine, variant)-only path.  A trivial poolset (one pool, unit
        scale) stays on the legacy path so its plans — estimates, reason
        strings, ``pool=None`` — match the pre-federation planner
        exactly."""
        if self._pools is None or self._pools.trivial:
            return None
        return self._pools.pools()

    def plan(self, q, seed_mode: Optional[str] = None) -> P.Plan:
        """Cost every (pool, engine, variant) placement and pick one
        (cached per query shape; the cache is cleared on measurement,
        calibration, pool-health and residency changes).

        ``seed_mode`` (from the service's lineage lookup) prices the
        incremental/warm path against the chosen full recompute —
        :func:`~repro_torch.core.planner.price_incremental`.  It joins the
        cache key: the same query shape plans differently once an
        ancestor's result appears in the cache, and the delta itself is
        immutable per context (``self.coo.delta``) so it need not.

        On a device mesh every rank plans and then takes the plan of the
        rank at ``(0, 0)`` (one ``broadcast_object_list`` along each
        axis): the choice rests on measured timings and calibration,
        which may differ between ranks, and two ranks that run different
        engines or variants call different collectives and hang.  The
        reference's single controller plans once for the whole mesh."""
        with self._lock:
            plan = self._plan_local(q, seed_mode)
            if self._axes is not None:
                plan = self._axes.broadcast_object(plan)
            return plan

    def _plan_local(self, q, seed_mode: Optional[str]) -> P.Plan:
        stats = self.current_stats()
        qkey = self._query_key(q)
        key = None if qkey is None else (qkey, seed_mode)
        if key is not None and key in self._plan_cache:
            self._plan_cache.move_to_end(key)
            return self._plan_cache[key]
        pools = self._placement_pools()
        plan = self._plan_uncached(
            q, stats, pools,
            self.residency if pools is not None else None,
            seed_mode=seed_mode)
        if key is not None and self._plan_cache_size:
            self._plan_cache[key] = plan
            while len(self._plan_cache) > self._plan_cache_size:
                self._plan_cache.popitem(last=False)
        return plan

    def plan_for_pools(self, q, pool_names: Sequence[str]) -> P.Plan:
        """Re-place ``q`` restricted to ``pool_names`` — the service's
        batch-spill path.  Never cached: the restriction reflects live
        queue depths, not the query's shape."""
        with self._lock:
            stats = self.current_stats()
            pools = [self._pools.get(n) for n in pool_names]
            return self._plan_uncached(q, stats, pools, self.residency)

    def _plan_uncached(self, q, stats, pools, resident,
                       seed_mode: Optional[str] = None) -> P.Plan:
        """One planning pipeline for both the legacy and the pool-aware
        paths: cost-model choice, then force_engine, then the
        capability clamp (which wins over both), then variant re-pick
        for the overridden engine, then — exactly once, on the final
        plan — the incremental-vs-full pricing."""
        defn = R.get(q.algorithm)
        specs = P.specs_for(q.algorithm, stats,
                            count_only=q.count_only, **q.params)

        def priced(plan):
            if seed_mode is None:
                return plan
            spec = next((s for s in specs if s.variant == plan.variant),
                        specs[0])
            return P.price_incremental(
                plan, stats, spec, delta=getattr(self.coo, "delta", None),
                seed_mode=seed_mode)

        if pools is None:
            plan = P.choose_plan(stats, specs, self.n_chips)
        else:
            plan = P.choose_plan(stats, specs, self.n_chips,
                                 pools=pools, resident=resident)
        chosen_engine = plan.engine
        target = why = None
        if self.force_engine:
            target, why = self.force_engine, f"forced: {self.force_engine}"
        if (target or plan.engine) not in defn.engines:
            # capability clamp wins over the cost model and forcing
            target = defn.engines[0]
            why = f"{q.algorithm} runs on {'/'.join(defn.engines)} only"
        if target is None:
            return priced(plan)
        if pools is not None:
            # re-run the placement with the engine axis pinned, so the
            # override still picks the best (pool, variant) for it
            if target != chosen_engine:
                plan = P.choose_plan(stats, specs, self.n_chips,
                                     pools=pools, resident=resident,
                                     engines=(target,))
            return priced(dataclasses.replace(
                plan, reason=f"{why}; {plan.reason}"))
        plan = dataclasses.replace(plan, engine=target, reason=why)
        if len(specs) > 1 and target != chosen_engine:
            # engine was overridden: re-pick its cheapest variant
            best = P.best_spec_for_engine(stats, specs, target,
                                          self.n_chips)
            plan = dataclasses.replace(plan, variant=best.variant)
        return priced(plan)

    def execute(self, q, plan: P.Plan, seed=None,
                profile: bool = False) -> QueryResult:
        """Run the plan.  ``seed`` (an ancestor snapshot's QueryResult)
        is forwarded to the engine only for non-full plans; incremental
        plans also hand over this snapshot's recorded delta so the
        algorithm's localized-repair hook can seed its frontier.  A
        hook that declines falls back to the cold run inside
        ``Engine.run`` — the answer is the same either way.
        ``profile`` asks the engine for superstep counters
        (``meta['superstep']``); result values are identical either
        way."""
        kw = {}
        if seed is not None and plan.mode != "full":
            kw["seed"] = seed
            if plan.mode == "incremental":
                kw["delta"] = getattr(self.coo, "delta", None)
        r = self.engine(plan.engine, self.pool_for_plan(plan)).run(
            q.algorithm, q.params, count_only=q.count_only,
            variant=plan.variant, profile=profile, **kw)
        r.meta["plan"] = plan
        return r


@dataclasses.dataclass
class _WorkUnit:
    """One dequeued execution: a solo interactive ticket or a fused
    batch group.  ``busy_key`` identifies the (context, engine) pair the
    unit will occupy — the runtime never hands two units with the same
    key to different workers (the engine lock would just serialize them
    while an idle engine starves)."""

    kind: str                     # 'solo' | 'group'
    engine: str
    tickets: list
    pool: Optional[str] = None    # placement pool (gate slot to release)

    @property
    def busy_key(self) -> tuple:
        return (id(self.tickets[0].context), self.pool, self.engine)


class GraphAnalyticsService:
    """Catalog + admission + concurrent runtime + fusion over
    GraphContexts.

    One instance serves many snapshots and many in-flight queries.  The
    result cache is shared across the whole catalog and keyed on
    ``(content digest, algorithm, frozen params, count_only)`` — engine-
    and variant-free, because results are contractually independent of
    both — so byte-identical snapshots hit each other's entries no
    matter which engine answered first.

    ``workers`` sets the default drain parallelism (1 = the serial
    reference schedule); ``retry`` the backoff/dead-letter policy;
    ``tier_depth`` the per-tier queue depth budget (int for both tiers,
    or ``{"interactive": ..., "batch": ...}``; ``None`` = unbounded);
    ``seed`` makes every backoff schedule deterministic per ticket;
    ``pools`` the federation topology — a
    :class:`~repro_torch.core.pools.PoolSet` (or a DevicePool sequence),
    defaulting to a trivial single pool that reproduces the
    pre-federation service exactly.
    """

    ENGINE_ORDER = ("local", "distributed")
    TIER_ORDER = ("interactive", "batch")

    def __init__(self, cache_size: int = 256,
                 result_cache: Optional[OrderedDict] = None,
                 interactive_threshold_s: Optional[float] = None,
                 admission_budget_s: Optional[float] = None,
                 history_size: int = 1024,
                 workers: int = 1,
                 retry: Optional[RT.RetryPolicy] = None,
                 tier_depth=None,
                 seed: int = 0,
                 pools=None,
                 trace_depth: int = 0,
                 tracer: Optional[obs.Tracer] = None):
        if pools is None:
            self.pools = PL.single_pool()
        elif isinstance(pools, PL.PoolSet):
            self.pools = pools
        else:
            self.pools = PL.PoolSet(pools)
        self._pool_gate = RT.PoolGate(
            {p.name: p.max_inflight for p in self.pools})
        self._ledger = RT.TransferLedger()
        self._pool_spills = {p.name: 0 for p in self.pools}
        self._name_pools: dict[str, tuple] = {}   # name -> declared pools
        self._catalog: dict[str, GraphContext] = {}
        self._by_digest: dict[tuple, GraphContext] = {}
        # -- time-versioned catalog: name -> [version dicts] sorted by
        # as_of (each {'as_of', 'ctx', 'digest', 'parent'}), plus a
        # digest -> context index for walking lineage chains when a
        # query hunts for an ancestor's cached result to seed from
        self._versions: dict[str, list] = {}
        self._digest_ctx: dict[str, GraphContext] = {}
        self._meter = RT.IncrementalMeter()
        self.cache_size = cache_size
        self._result_cache: OrderedDict = (
            OrderedDict() if result_cache is None else result_cache)
        self.cache_stats = {"hits": 0, "misses": 0}
        # None -> follow the active calibration profile (so a
        # load_calibration() retunes live services)
        self._interactive_threshold_s = interactive_threshold_s
        self._admission_budget_s = admission_budget_s
        # tickets/results/log are bounded: a long-lived service fielding
        # continuous traffic must not accrete one ticket + one O(V)
        # result per query forever.  Only *resolved* tickets age out
        # (oldest first, once history_size is exceeded); pending tickets
        # are never evicted.
        self.history_size = history_size
        self._tickets: dict[int, QueryTicket] = {}
        self._results: dict[int, QueryResult] = {}
        self._resolved_order: deque = deque()
        self._next_ticket = 0
        # (pool, engine, tier) -> tickets; pool is None for plans from
        # the legacy/trivial-poolset path
        self._queues: dict[tuple, deque] = {}
        self.execution_log: deque = deque(maxlen=history_size)
        self.stats = {"submitted": 0, "rejected": 0, "backpressure": 0,
                      "executed": 0, "failed": 0, "retries": 0,
                      "dead_letters": 0, "fused_batches": 0,
                      "fused_tickets": 0, "spilled": 0}
        # -- runtime ---------------------------------------------------
        self.workers = max(int(workers), 1)
        self.retry = RT.RetryPolicy() if retry is None else retry
        self.seed = int(seed)
        if tier_depth is None:
            self._tier_depth: dict[str, Optional[int]] = {}
        elif isinstance(tier_depth, int):
            self._tier_depth = {t: tier_depth for t in self.TIER_ORDER}
        else:
            self._tier_depth = dict(tier_depth)
        # one lock for all scheduler/bookkeeping state; the condition
        # wakes workers when new work or a completion arrives, and
        # result() waiters when a ticket resolves
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._busy: set = set()        # busy (context, pool, engine)
        self._inflight = 0             # units currently executing
        self._hist = {t: RT.LatencyHistogram() for t in self.TIER_ORDER}
        self._fusion_widths: deque = deque(maxlen=4096)
        # -- observability ---------------------------------------------
        # ``trace_depth > 0`` (or an explicit tracer) turns on span
        # tracing: per-ticket span trees bounded to the newest
        # trace_depth tickets, superstep profiling on every traced
        # execution, and process-wide fault/transfer events routed in
        # through the observer seam.  Off (the default) every hook is a
        # single ``is not None`` check.  The PlanAccuracyMeter is
        # always on — recording two floats per execution is cheaper
        # than the estimate it corrects.
        if tracer is not None:
            self.tracer: Optional[obs.Tracer] = tracer
        elif trace_depth > 0:
            self.tracer = obs.Tracer(trace_depth=trace_depth)
        else:
            self.tracer = None
        if self.tracer is not None:
            obs.install_observer(self.tracer)
        self._accuracy = obs.PlanAccuracyMeter()

    # -- tier thresholds ----------------------------------------------------
    @property
    def interactive_threshold_s(self) -> float:
        if self._interactive_threshold_s is not None:
            return self._interactive_threshold_s
        return P.active_calibration().interactive_threshold_s

    @property
    def admission_budget_s(self) -> float:
        if self._admission_budget_s is not None:
            return self._admission_budget_s
        return P.active_calibration().admission_budget_s

    # -- catalog ------------------------------------------------------------
    def add_graph(self, name: str, coo: G.GraphCOO, mesh=None,
                  n_data: int = 1, n_model: int = 1,
                  local_max_degree: int = 128,
                  force_engine: Optional[str] = None,
                  plan_cache_size: Optional[int] = None,
                  pools: Optional[Sequence[str]] = None,
                  device=None) -> GraphContext:
        """Register a snapshot under ``name``.  Byte-identical snapshots
        with the same engine configuration share one ``GraphContext`` —
        the catalog-level dedup that makes reloading a snapshot free.
        ``pools`` names the pools the snapshot is *resident* on
        (default: all of them — the pre-federation behaviour); replicas
        of the same bytes under different names merge into one context
        whose residency is the union of their declarations.
        ``plan_cache_size`` defaults to the service's ``cache_size``, so
        ``cache_size=0`` disables plan caching alongside result caching.
        ``device`` places the snapshot and its engines (``None``: the
        first CUDA device; pass ``"cpu"`` to run on the host)."""
        declared = (self.pools.names() if pools is None
                    else self.pools.validate_names(pools))
        ctx = GraphContext(coo, mesh=mesh, n_data=n_data, n_model=n_model,
                           local_max_degree=local_max_degree,
                           force_engine=force_engine,
                           plan_cache_size=(self.cache_size
                                            if plan_cache_size is None
                                            else plan_cache_size),
                           pools=self.pools, residency=declared,
                           device=device)
        with self._lock:
            dedup_key = (coo.content_digest(),) + ctx.config_key()
            existing = self._by_digest.get(dedup_key)
            if existing is not None:
                ctx = existing
            else:
                self._by_digest[dedup_key] = ctx
            self._catalog[name] = ctx
            self._name_pools[name] = tuple(declared)
            self._refresh_residency(ctx)
            return ctx

    def remove_graph(self, name: str) -> None:
        """Drop ``name`` from the catalog — the eviction path for
        rolling-snapshot traffic.  Pending tickets pinned their context
        at submit, so they still execute against the snapshot they were
        admitted for; the context's device state is freed once the
        catalog, the dedup map and every live ticket release it.
        Removing one replica of a multi-pool snapshot shrinks the
        shared context's declared residency — a residency-generation
        bump that invalidates cached plans placed on the gone pool."""
        with self._lock:
            ctx = self._catalog.pop(name, None)
            self._name_pools.pop(name, None)
            if ctx is None:
                return
            if ctx not in self._catalog.values():
                self._by_digest = {k: v for k, v in self._by_digest.items()
                                   if v is not ctx}
            else:
                self._refresh_residency(ctx)

    def _refresh_residency(self, ctx: GraphContext) -> None:
        """Re-derive ``ctx``'s declared residency as the union over the
        catalog names that share it (caller holds the lock)."""
        union: set = set()
        for name, c in self._catalog.items():
            if c is ctx:
                union |= set(self._name_pools.get(name, ()))
        ctx.declare_residency(union)

    def set_pool_health(self, name: str, healthy: bool) -> PL.DevicePool:
        """Flip one pool's health.  A real change bumps the poolset
        generation, so every context's cached plans (and the result-
        cache keys) that priced the old topology are invalidated."""
        return self.pools.set_health(name, healthy)

    # -- time-versioned catalog ---------------------------------------------
    def add_snapshot(self, name: str, coo: Optional[G.GraphCOO] = None, *,
                     as_of=None, added=None, removed=None, added_w=None,
                     **kw) -> GraphContext:
        """Register one *version* of the rolling snapshot ``name``.

        Two forms:

        * ``add_snapshot(name, coo, as_of=t)`` — full bytes.  If ``coo``
          came out of :meth:`~repro_torch.core.graph.GraphCOO.apply_delta` its
          recorded ``parent_digest``/``delta`` lineage rides along.
        * ``add_snapshot(name, as_of=t, added=..., removed=...)`` — the
          daily-delta form: the edge lists are applied to the *latest*
          registered version of ``name`` (``GraphCOO.apply_delta``), so
          the catalog never rebuilds the unchanged bulk of the graph.

        ``as_of`` is any totally ordered timestamp (int day number, ISO
        date string, ...) and must be strictly greater than the previous
        version's; it defaults to ``last + 1`` (or 0 for the first
        version).  The bare catalog name always resolves to the newest
        version; ``context``/``call``/``submit`` accept ``as_of`` to pin
        an older one.  Engine keyword arguments (``mesh``, ``pools``,
        ``force_engine``, ...) pass through to :meth:`add_graph`.
        """
        with self._lock:
            chain = self._versions.get(name, [])
            if coo is None:
                if added is None and removed is None:
                    raise ValueError(
                        "add_snapshot needs either a graph or a delta "
                        "(added=/removed= edge lists)")
                if not chain:
                    raise KeyError(
                        f"no base version of {name!r} to apply a delta "
                        f"to; register the first snapshot with full bytes")
                coo = chain[-1]["ctx"].coo.apply_delta(
                    added=added, removed=removed, added_w=added_w)
            elif added is not None or removed is not None:
                raise ValueError(
                    "pass either a graph or added=/removed=, not both")
            if as_of is None:
                as_of = chain[-1]["as_of"] + 1 if chain else 0
            if chain and not chain[-1]["as_of"] < as_of:
                raise ValueError(
                    f"snapshot versions must advance: as_of {as_of!r} is "
                    f"not after {name!r}'s latest {chain[-1]['as_of']!r}")
            ctx = self.add_graph(name, coo, **kw)
            digest = coo.content_digest()
            self._versions.setdefault(name, []).append({
                "as_of": as_of, "ctx": ctx, "digest": digest,
                "parent": getattr(coo, "parent_digest", None)})
            self._digest_ctx[digest] = ctx
            return ctx

    def snapshot_versions(self, name: str) -> list:
        """The registered ``as_of`` timestamps of ``name``, oldest
        first (empty for graphs added via plain ``add_graph``)."""
        with self._lock:
            return [e["as_of"] for e in self._versions.get(name, ())]

    def graph_names(self) -> list[str]:
        with self._lock:
            return sorted(self._catalog)

    def context(self, graph_name: str, as_of=None) -> GraphContext:
        """The context serving ``graph_name`` — its newest version, or
        with ``as_of`` the newest *version at or before* that timestamp
        (catalog time travel; older versions stay queryable after the
        bare name moved on)."""
        with self._lock:
            if as_of is not None:
                chain = self._versions.get(graph_name)
                if not chain:
                    raise KeyError(
                        f"graph {graph_name!r} has no time-versioned "
                        f"snapshots (register them with add_snapshot); "
                        f"catalog: {self.graph_names()}")
                cands = [e for e in chain if e["as_of"] <= as_of]
                if not cands:
                    raise KeyError(
                        f"no version of {graph_name!r} at or before "
                        f"{as_of!r}; versions: "
                        f"{[e['as_of'] for e in chain]}")
                return cands[-1]["ctx"]
            try:
                return self._catalog[graph_name]
            except KeyError:
                raise KeyError(
                    f"unknown graph {graph_name!r}; catalog: "
                    f"{self.graph_names()}") from None

    # -- lineage seeding ----------------------------------------------------
    def _peek_ancestor_result(self, digest: str, qkey) \
            -> Optional[QueryResult]:
        """The cached result of ``qkey`` on the snapshot whose content
        digest is ``digest``, without touching hit/miss counters or LRU
        order — a seed probe, not a cache hit."""
        ctx = self._digest_ctx.get(digest)
        if ctx is None:
            return None
        key = (digest, ctx.residency_generation,
               self.pools.generation) + qkey
        with self._lock:
            return self._result_cache.get(key)

    def _seed_for(self, ctx: GraphContext, q):
        """Hunt the lineage chain for a warm-start seed for ``q`` on
        ``ctx``'s snapshot.  Returns ``(seed, mode)``:

        * ``(result, 'incremental')`` — the *direct parent* answered
          ``q`` and this snapshot records the delta that produced it
          (the only ancestor whose delta describes the edit, so the
          only one a localized repair may seed from);
        * ``(result, 'warm')`` — some ancestor within 4 hops answered
          ``q`` and the algorithm can warm-start a fixpoint from it;
        * ``(None, None)`` — no lineage, no cached ancestor result, or
          the algorithm registered neither hook.
        """
        qkey = ctx._query_key(q)
        if qkey is None:
            return None, None
        parent = getattr(ctx.coo, "parent_digest", None)
        if parent is None:
            return None, None
        defn = R.get(q.algorithm)
        if defn.incremental is not None \
                and getattr(ctx.coo, "delta", None) is not None:
            seed = self._peek_ancestor_result(parent, qkey)
            if seed is not None:
                return seed, "incremental"
        if defn.warm_start is not None:
            digest = parent
            for _ in range(4):
                if digest is None:
                    break
                seed = self._peek_ancestor_result(digest, qkey)
                if seed is not None:
                    return seed, "warm"
                anc = self._digest_ctx.get(digest)
                digest = getattr(anc.coo, "parent_digest", None) \
                    if anc is not None else None
        return None, None

    def _record_incremental(self, r: QueryResult, seed,
                            ctx: GraphContext) -> None:
        """Feed the meter after a seeded execution resolved.  The mode
        in ``r.meta`` is what the engine *actually* ran (a declining
        hook leaves no mode — the cold fallback is not a hit)."""
        mode = r.meta.get("mode")
        if mode is None:
            return
        saved = 0
        prev_iters = getattr(seed, "iterations", None)
        if prev_iters is not None and r.iterations is not None:
            saved = max(int(prev_iters) - int(r.iterations), 0)
        delta = getattr(ctx.coo, "delta", None) \
            if mode == "incremental" else None
        self._meter.record(mode, iterations_saved=saved,
                           delta_bytes=delta.nbytes() if delta else 0)

    # -- result cache -------------------------------------------------------
    def _result_key(self, ctx: GraphContext, q):
        qkey = ctx._query_key(q)
        if qkey is None:
            return None
        # content digest, not id(): a recycled address must never alias
        # a dead graph's results, and byte-identical reloads must share.
        # Engine and variant are deliberately absent — results are
        # contractually identical across both, so either one's answer
        # serves the query (the PR-3 variant argument, finished).  The
        # residency and poolset generations ARE present: a replica
        # removal or health flip must not replay entries admitted under
        # the old topology (they start at 0 everywhere, so fresh
        # services sharing a cache still hit each other's entries).
        return (ctx.coo.content_digest(), ctx.residency_generation,
                self.pools.generation) + qkey

    def _cache_get(self, key) -> Optional[QueryResult]:
        with self._lock:
            if key is None or key not in self._result_cache:
                self.cache_stats["misses"] += 1
                return None
            self._result_cache.move_to_end(key)
            self.cache_stats["hits"] += 1
            hit = self._result_cache[key]
            return dataclasses.replace(hit,
                                       meta={**hit.meta, "cache": "hit"})

    def _cache_put(self, key, r: QueryResult) -> None:
        with self._lock:
            if key is None or not self.cache_size:
                return
            self._result_cache[key] = r
            while len(self._result_cache) > self.cache_size:
                self._result_cache.popitem(last=False)

    # -- synchronous path (GraphPlatform.query) -----------------------------
    def call(self, graph_name: str, q, as_of=None) -> QueryResult:
        """Plan → cache → execute, synchronously.  No admission control:
        this is the library-compatible single-query path.  ``as_of``
        pins a time-versioned snapshot; lineage seeding (incremental
        repair / warm start from an ancestor's cached result) applies
        exactly as on the ``submit`` path."""
        ctx = self.context(graph_name, as_of)
        key = self._result_key(ctx, q)
        hit = self._cache_get(key)
        if hit is not None:
            return hit
        seed, seed_mode = self._seed_for(ctx, q)
        plan = ctx.plan(q, seed_mode=seed_mode)
        self._account_transfer(ctx, plan)
        t0 = time.perf_counter()
        r = ctx.execute(q, plan, seed=seed)
        self._accuracy.record(q.algorithm, plan.engine, plan.variant,
                              plan.pool, est_s=P.plan_cost(plan),
                              wall_s=time.perf_counter() - t0,
                              mode=plan.mode)
        with self._lock:
            self.stats["executed"] += 1
        self._record_incremental(r, seed, ctx)
        # re-key: accounting may have just materialized the pool
        # (residency-generation bump), and the entry must be findable
        # under the keys later lookups will compute
        self._cache_put(self._result_key(ctx, q), self._strip_run_meta(r))
        return r

    def _account_transfer(self, ctx: GraphContext, plan: P.Plan,
                          tickets: Sequence[QueryTicket] = ()) -> None:
        """Executing on a pool materializes the snapshot's derived state
        there: the first time charges the snapshot bytes to the transfer
        ledger and marks the pool resident (declared-resident pools were
        never charged — the replica was already in place).  A charged
        transfer is marked on each involved ticket's trace."""
        if plan.pool is None:
            return
        if ctx.mark_resident(plan.pool):
            self._ledger.record(plan.pool, ctx.stats.bytes_coo)
            if self.tracer is not None and tickets:
                self.tracer.ticket_event(
                    [t.ticket_id for t in tickets], "transfer",
                    {"pool": plan.pool, "bytes": ctx.stats.bytes_coo})

    # -- submission ---------------------------------------------------------
    def submit(self, graph_name: str, q, as_of=None) -> QueryTicket:
        """Admit one query: plan it, classify its tier, queue it.

        Raises :class:`AdmissionRejected` (plan attached) when the
        estimate exceeds the admission budget, and
        :class:`~repro_torch.core.runtime.Backpressure` when the destination
        queue is at its tier's depth budget.  Admitted tickets queue
        FIFO per (pool, engine, tier); nothing executes until ``drain``
        or ``result``.  Batch tickets whose preferred pool's batch
        queue is at the pool's ``capacity`` *spill*: they re-place onto
        another healthy pool where the snapshot is resident (tier and
        admission estimate unchanged).

        ``as_of`` resolves a time-versioned snapshot; when an ancestor
        of that snapshot already answered ``q``, the ticket carries the
        ancestor's result as a warm-start seed and its plan is priced
        (and tiered) on the incremental estimate.  Seeded tickets never
        fuse — the seed is per-snapshot state a shared batch program
        cannot carry.
        """
        ctx = self.context(graph_name, as_of)
        seed, seed_mode = self._seed_for(ctx, q)
        plan = ctx.plan(q, seed_mode=seed_mode)
        if plan.mode == "full":
            seed = None
        est = P.plan_cost(plan)
        with self._lock:
            # an infinite estimate means the planner itself declared the
            # (forced/clamped) engine infeasible — reject even under the
            # default infinite budget, where `inf > inf` would admit it
            if est > self.admission_budget_s or est == float("inf"):
                self.stats["rejected"] += 1
                if self.tracer is not None:
                    self.tracer.record_event("admission-rejected", {
                        "graph": graph_name, "algorithm": q.algorithm,
                        "est_s": est, "budget_s": self.admission_budget_s})
                raise AdmissionRejected(graph_name, q, plan, est,
                                        self.admission_budget_s)
            tier = ("interactive" if est <= self.interactive_threshold_s
                    else "batch")
            planned = plan
            if tier == "batch":
                plan = self._maybe_spill(ctx, q, plan)
            budget = self._tier_depth.get(tier)
            if budget is not None:
                depth = self._queue_depth(plan.engine, tier)
                if depth >= budget:
                    self.stats["backpressure"] += 1
                    if self.tracer is not None:
                        self.tracer.record_event("backpressure", {
                            "graph": graph_name,
                            "algorithm": q.algorithm, "tier": tier,
                            "depth": depth, "budget": budget})
                    raise RT.Backpressure(graph_name, q, plan.engine,
                                          tier, depth, budget)
            defn = R.get(q.algorithm)
            fusable = defn.fusable and plan.mode == "full"
            ticket = QueryTicket(
                self._next_ticket, graph_name, q, plan, tier, est,
                context=ctx,
                fuse_key=self._fuse_key(defn, q) if fusable else None,
                queued_at=time.perf_counter(),
                pool=plan.pool,
                seed=seed)
            self._next_ticket += 1
            self._tickets[ticket.ticket_id] = ticket
            self._queues.setdefault((plan.pool, plan.engine, tier),
                                    deque()).append(ticket)
            self.stats["submitted"] += 1
            if self.tracer is not None:
                original = None
                if plan is not planned:    # _maybe_spill re-placed it
                    original = {"pool": planned.pool,
                                "engine": planned.engine,
                                "variant": planned.variant,
                                "est_s": planned.est_s}
                self.tracer.on_submit(
                    ticket, ticket.queued_at,
                    admission={"est_s": est,
                               "budget_s": self.admission_budget_s,
                               "threshold_s": self.interactive_threshold_s,
                               "tier": tier},
                    plan_attrs={"engine": plan.engine,
                                "variant": plan.variant,
                                "pool": plan.pool, "mode": plan.mode,
                                "est_s": P.plan_cost(plan),
                                "reason": plan.reason},
                    candidates=plan.candidates,
                    original_placement=original)
            self._cond.notify_all()       # wake a parked worker
            return ticket

    def _maybe_spill(self, ctx: GraphContext, q, plan: P.Plan) -> P.Plan:
        """Batch-tier spill (caller holds the lock): when the planned
        pool's batch queue is at the pool's ``capacity``, re-place onto
        the cheapest other healthy pool where the snapshot is resident
        and whose own batch queue has room.  No candidate (or no
        capacity configured) keeps the original plan — spill sheds
        load, it never strands a query."""
        if plan.pool is None or len(self.pools) < 2:
            return plan
        pool = self.pools.get(plan.pool)
        if pool.capacity is None:
            return plan
        depth = self._pool_batch_depth(plan.pool)
        if depth < pool.capacity:
            return plan
        resident = ctx.residency
        cands = [p.name for p in self.pools
                 if p.healthy and p.name != plan.pool
                 and p.name in resident
                 and (p.capacity is None
                      or self._pool_batch_depth(p.name) < p.capacity)]
        if not cands:
            return plan
        try:
            spilled = ctx.plan_for_pools(q, cands)
        except ValueError:
            return plan
        self.stats["spilled"] += 1
        self._pool_spills[plan.pool] += 1
        return dataclasses.replace(
            spilled,
            reason=f"spilled from {plan.pool} (batch depth {depth} >= "
                   f"capacity {pool.capacity}); {spilled.reason}")

    def _queue_depth_key(self, key: tuple) -> int:
        """Live (still-queued) depth of one queue — resolved-out-of-band
        tickets linger in the deque until a dequeue skips them, so
        ``len`` alone over-counts."""
        q = self._queues.get(key)
        if not q:
            return 0
        return sum(1 for t in q if t.status == "queued")

    def _queue_depth(self, engine: str, tier: str) -> int:
        """Depth of one (engine, tier) aggregated over pools — the view
        tier backpressure budgets and ``metrics()['queue_depths']``
        keep from before federation."""
        return sum(self._queue_depth_key(k) for k in self._queues
                   if k[1] == engine and k[2] == tier)

    def _pool_batch_depth(self, pool_name: str) -> int:
        """Queued batch tickets bound for one pool (the spill trigger)."""
        return sum(self._queue_depth_key((pool_name, e, "batch"))
                   for e in self.ENGINE_ORDER)

    # -- resolution ---------------------------------------------------------
    def drain(self, workers: Optional[int] = None) -> list[QueryTicket]:
        """Run every queued ticket to completion and return the tickets
        finished by this call, in completion order.

        ``workers=1`` (the default unless the service was built with
        more) is the deterministic serial reference: engines in fixed
        order, every interactive queue strictly before any batch queue,
        each queue FIFO, batch tickets coalesced into fused executions
        where the registry allows.  ``workers>=2`` runs the same
        dequeue protocol from a thread pool — at most one in-flight
        unit per (context, engine), interactive still preempting batch
        at every dequeue — and per-ticket results are byte-identical to
        the serial schedule (the fusion/caching contracts make results
        order-independent)."""
        n = self.workers if workers is None else max(int(workers), 1)
        finished: list[QueryTicket] = []
        if n == 1:
            while True:
                with self._lock:
                    unit = self._next_unit()
                if unit is None:
                    break
                try:
                    self._execute_unit(unit, finished)
                finally:
                    self._pool_gate.release(unit.pool)
            return finished
        threads = [
            threading.Thread(target=self._worker_loop, args=(finished,),
                             name=f"gas-worker-{i}", daemon=True)
            for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        return finished

    def result(self, ticket: QueryTicket) -> QueryResult:
        """The ticket's result, executing work as needed.  Interactive
        tickets bypass the batch queue entirely: only the ticket itself
        runs.  Batch tickets drain the service (their fuse group rides
        along for free).  A ticket currently executing on a worker is
        awaited, not re-run."""
        with self._lock:
            t = self._tickets.get(ticket.ticket_id)
            if t is not ticket:
                raise ValueError(
                    f"ticket #{ticket.ticket_id} was not issued by this "
                    f"service (ids are per-service), or its result aged "
                    f"out of the {self.history_size}-entry history")
        while True:
            claimed = drain_needed = False
            with self._cond:
                if t.status == "done":
                    return self._results[t.ticket_id]
                if t.status == "dead-letter":
                    raise t.error
                if t.status == "running":
                    self._cond.wait(0.05)     # a worker owns it: await
                    continue
                # queued: claim it (interactive) or drain the service
                if t.tier == "interactive":
                    t.status = "running"
                    if self.tracer is not None:
                        self.tracer.on_dequeue([t.ticket_id])
                    claimed = True
                else:
                    drain_needed = True
            if claimed:
                # inline interactive execution deliberately bypasses the
                # pool gate: the caller is already blocked on this one
                # result, and the engine lock still serializes the pool's
                # actual device work
                self._execute_unit(_WorkUnit("solo", t.plan.engine, [t],
                                             pool=t.plan.pool), [])
            elif drain_needed:
                self.drain()

    def pending(self) -> list[QueryTicket]:
        with self._lock:
            return [t for t in self._tickets.values()
                    if t.status in ("queued", "running")]

    # -- metrics ------------------------------------------------------------
    def metrics(self) -> dict:
        """One consistent snapshot of the service's observable state:
        live queue depths, counters, cache hit rate, per-tier latency
        (submit→resolution) histograms with exact p50/p99 over the
        sample window, fusion widths, and the retry policy's counters.
        See docs/architecture.md for the field table."""
        with self._lock:
            depths = {f"{e}.{t}": self._queue_depth(e, t)
                      for e in self.ENGINE_ORDER for t in self.TIER_ORDER}
            hits = self.cache_stats["hits"]
            misses = self.cache_stats["misses"]
            total = hits + misses
            widths = list(self._fusion_widths)
            return {
                "workers": self.workers,
                "queue_depths": depths,
                "tier_depth_budget": dict(self._tier_depth),
                "counters": dict(self.stats),
                "cache": {"hits": hits, "misses": misses,
                          "hit_rate": (hits / total) if total else None},
                "tier_latency_s": {t: h.snapshot()
                                   for t, h in self._hist.items()},
                "fusion": {
                    "batches": self.stats["fused_batches"],
                    "tickets": self.stats["fused_tickets"],
                    "mean_width": (sum(widths) / len(widths)
                                   if widths else None),
                    "max_width": max(widths, default=None)},
                "retry": {"max_attempts": self.retry.max_attempts,
                          "retries": self.stats["retries"],
                          "dead_letters": self.stats["dead_letters"]},
                "incremental": self._meter.snapshot(),
                "pools": {p.name: self._pool_metrics(p)
                          for p in self.pools},
                "accuracy": self._accuracy.snapshot(),
                "trace": (self.tracer.counters_snapshot()
                          if self.tracer is not None
                          else {"enabled": 0, "depth": 0, "retained": 0,
                                "tickets": 0, "spans": 0, "evicted": 0,
                                "events": 0}),
            }

    def metrics_text(self) -> str:
        """Prometheus-style text exposition of :meth:`metrics` — every
        numeric field flattened to a ``gas_``-prefixed sample line
        (``None`` becomes ``NaN``), non-numeric fields preserved as
        comment lines.  ``obs.parse_prometheus`` round-trips it."""
        return obs.render_prometheus(self.metrics())

    def explain(self, ticket) -> str:
        """Human-readable span tree for one ticket: admission verdict,
        the full plan-candidate table (losers annotated with why they
        lost), queue wait, each attempt with retry/fault events, the
        superstep counters of the execution that served it, and the
        resolution.  ``ticket`` is a :class:`QueryTicket` or a raw
        ticket id.  Requires the service to have been built with
        ``trace_depth > 0`` (or an explicit tracer)."""
        if self.tracer is None:
            raise RuntimeError(
                "tracing is off — construct the service with "
                "trace_depth > 0 (or pass tracer=) to record span trees")
        tid = getattr(ticket, "ticket_id", ticket)
        trace = self.tracer.trace(tid)
        if trace is None:
            raise KeyError(
                f"no trace retained for ticket #{tid}: it was never "
                f"submitted here, or it aged out of the "
                f"{self.tracer.trace_depth}-ticket trace ring")
        return obs.render_trace(trace)

    def _pool_metrics(self, p: PL.DevicePool) -> dict:
        """One pool's metrics row (caller holds the lock).  On a
        trivial poolset plans carry ``pool=None``, so the default
        pool's depths are read from the ``None``-keyed queues — the
        row always reflects the work actually bound for the pool."""
        key_pool = None if self.pools.trivial else p.name
        return {
            "healthy": p.healthy,
            "capacity": p.capacity,
            "max_inflight": p.max_inflight,
            "inflight": self._pool_gate.inflight(p.name),
            "queue_depths": {
                f"{e}.{t}": self._queue_depth_key((key_pool, e, t))
                for e in self.ENGINE_ORDER for t in self.TIER_ORDER},
            "transfer_bytes": self._ledger.bytes_for(p.name),
            "transfers": self._ledger.transfers_for(p.name),
            "spilled_away": self._pool_spills.get(p.name, 0),
        }

    # -- scheduling internals -----------------------------------------------
    @staticmethod
    def _fuse_key(defn: R.AlgorithmDef, q):
        """The query's fuse compatibility key, computed once at submit
        over *validated* params (the registry's fuse contract) — a
        directly-constructed query without schema defaults filled must
        not crash the scheduler.  ``None`` means unfusable: the ticket
        runs solo and any schema error surfaces at execution, attributed
        to that ticket."""
        try:
            return (defn.name, defn.fuse(defn.validate(q.params)))
        except Exception:
            return None

    def _next_unit(self, skip_busy: bool = False) -> Optional[_WorkUnit]:
        """Dequeue the next work unit (caller holds the lock).

        Interactive preemption lives here: every scan visits ALL
        interactive queues before ANY batch queue, so an interactive
        ticket submitted while batch work is queued is served by the
        next free worker.  Per queue the order is strictly FIFO — a
        head blocked on a busy (context, pool, engine) or a full pool
        gate parks its whole queue rather than letting younger tickets
        overtake it.  Dequeued tickets flip to ``running`` before the
        lock is released, so no two workers (or a worker and an inline
        ``result``) ever claim the same ticket.  The returned unit
        holds a pool-gate slot; the caller releases it after
        ``_execute_unit``."""
        for tier in self.TIER_ORDER:
            for engine in self.ENGINE_ORDER:
                for pool in self._pool_scan_order():
                    q = self._queues.get((pool, engine, tier))
                    while q:
                        head = q[0]
                        if head.status != "queued":  # resolved elsewhere
                            q.popleft()
                            continue
                        if skip_busy and \
                                (id(head.context), pool, engine) \
                                in self._busy:
                            break                 # queue parked; next one
                        if not self._pool_gate.try_acquire(pool):
                            break                 # pool at max_inflight
                        q.popleft()
                        if tier == "interactive":
                            head.status = "running"
                            if self.tracer is not None:
                                self.tracer.on_dequeue([head.ticket_id])
                            return _WorkUnit("solo", engine, [head],
                                             pool=pool)
                        group = self._take_fuse_group(q, head)
                        for t in group:
                            t.status = "running"
                        if self.tracer is not None:
                            self.tracer.on_dequeue(
                                [t.ticket_id for t in group])
                        return _WorkUnit("group", engine, group,
                                         pool=pool)
        return None

    def _pool_scan_order(self) -> tuple:
        """Queue-key pool axis in deterministic scan order: the
        ``None`` key (legacy/trivial plans) first, then pool order."""
        return (None,) + self.pools.names()

    @staticmethod
    def _take_fuse_group(queue: Optional[deque],
                         head: QueryTicket) -> list[QueryTicket]:
        """Pull every queued ticket fusable with ``head`` (same pinned
        context, equal precomputed fuse key) out of ``queue``,
        preserving the FIFO order of everything left behind."""
        group = [head]
        if queue is None or head.fuse_key is None:
            return group
        keep = deque()
        while queue:
            t = queue.popleft()
            if t.status != "queued":
                continue
            if t.context is head.context and t.fuse_key == head.fuse_key:
                group.append(t)
            else:
                keep.append(t)
        queue.extend(keep)
        return group

    def _worker_loop(self, finished: list) -> None:
        """One pool thread: claim units until the queues are empty and
        nothing is in flight.  An in-flight unit never *creates* queued
        work (retries run inline), but concurrent ``submit`` may — the
        condition wakes parked workers for both new work and freed
        (context, engine) pairs."""
        while True:
            with self._cond:
                unit = self._next_unit(skip_busy=True)
                if unit is None:
                    if self._inflight == 0 and not self._any_queued():
                        return
                    self._cond.wait(0.05)
                    continue
                self._inflight += 1
                self._busy.add(unit.busy_key)
            try:
                self._execute_unit(unit, finished)
            finally:
                self._pool_gate.release(unit.pool)
                with self._cond:
                    self._inflight -= 1
                    self._busy.discard(unit.busy_key)
                    self._cond.notify_all()

    def _any_queued(self) -> bool:
        return any(t.status == "queued"
                   for q in self._queues.values() for t in q)

    # -- execution internals ------------------------------------------------
    def _backoff_seed(self, ticket_id: int) -> int:
        # stable across runs for a fixed service seed and ticket id —
        # the determinism the stress harness replays
        return self.seed * 1_000_003 + ticket_id

    def _run_with_retries(self, thunk, seed_id: int, tickets: list,
                          fused: bool = False):
        """Execute ``thunk`` under the retry policy.  Returns
        ``(result, None)`` on success or ``(None, error)`` once the
        policy gives up; ``error`` carries the full attempt chain
        (attempt k's exception is the ``__cause__`` of attempt k+1's).
        Sleeps follow the jittered schedule seeded per ticket, so a
        replayed drain backs off identically.  Each attempt opens one
        attempt span per ticket around a shared execute span (tracing
        on); the final failure's span carries the whole chain."""
        schedule = self.retry.schedule(self._backoff_seed(seed_id))
        ids = [t.ticket_id for t in tickets]
        last: Optional[BaseException] = None
        for attempt in range(1, self.retry.max_attempts + 1):
            for t in tickets:
                t.attempts = attempt
            handle = None
            if self.tracer is not None:
                handle = self.tracer.on_attempt_start(ids, attempt,
                                                      fused=fused)
            try:
                out = thunk()
            except Exception as e:
                if last is not None and e is not last \
                        and e.__cause__ is None:
                    e.__cause__ = last       # preserve the attempt chain
                last = e
                if handle is not None:
                    self.tracer.on_attempt_end(handle, e)
                if not self.retry.retryable(e) \
                        or attempt >= self.retry.max_attempts:
                    return None, e
                with self._lock:
                    self.stats["retries"] += 1
                if self.tracer is not None:
                    self.tracer.on_retry(ids, attempt,
                                         schedule[attempt - 1])
                time.sleep(schedule[attempt - 1])
            else:
                if handle is not None:
                    self.tracer.on_attempt_end(handle)
                return out, None
        return None, last                    # pragma: no cover

    def _execute_unit(self, unit: _WorkUnit, finished: list) -> None:
        """Run one dequeued unit to resolution (outside the lock; only
        bookkeeping re-acquires it)."""
        if unit.kind == "solo":
            self._execute_solo(unit.tickets[0], finished)
        else:
            self._execute_group(unit.engine, unit.tickets, finished)

    def _execute_solo(self, t: QueryTicket, finished: list) -> None:
        ctx = t.context
        key = self._result_key(ctx, t.query)
        hit = self._cache_get(key)
        if hit is not None:
            if self.tracer is not None:
                self.tracer.ticket_event([t.ticket_id], "cache-hit")
            self._finish(t, hit)
            finished.append(t)
            return
        self._account_transfer(ctx, t.plan, [t])
        profile = self.tracer is not None
        t0 = time.perf_counter()
        r, err = self._run_with_retries(
            lambda: ctx.execute(t.query, t.plan, seed=t.seed,
                                profile=profile),
            t.ticket_id, [t])
        wall = time.perf_counter() - t0
        if err is not None:
            self._dead_letter([t], err)
            finished.append(t)
            return
        self._accuracy.record(t.query.algorithm, t.plan.engine,
                              t.plan.variant, t.plan.pool,
                              est_s=t.est_s, wall_s=wall,
                              mode=t.plan.mode)
        if self.tracer is not None:
            self.tracer.on_execute_result(
                [t.ticket_id], engine=r.engine,
                attrs=self._result_attrs(r, wall))
        self._record_incremental(r, t.seed, ctx)
        with self._lock:
            self.stats["executed"] += 1
            # re-key: accounting may have materialized the pool
            self._cache_put(self._result_key(ctx, t.query),
                            self._strip_run_meta(r))
            self._finish(t, r)
            self._log(t.plan.engine, t.tier, [t], fused=False,
                      algorithm=t.query.algorithm)
        finished.append(t)

    @staticmethod
    def _result_attrs(r: QueryResult, wall: float) -> dict:
        """Execute-span annotations from what actually ran."""
        attrs = {"wall_s": wall, "iterations": r.iterations}
        for k in ("variant", "realized_variant", "mode"):
            if k in r.meta:
                attrs[k] = r.meta[k]
        if "superstep" in r.meta:
            attrs["superstep"] = dict(r.meta["superstep"])
        return attrs

    @staticmethod
    def _strip_run_meta(r: QueryResult,
                        also: Sequence[str] = ()) -> QueryResult:
        """The cacheable copy of a result: drop meta keys that describe
        THIS execution (superstep counters, realized variant, fusion
        shape) — a later cache hit replaying them would claim an
        execution that never happened for that caller."""
        drop = {"superstep", "realized_variant", *also}
        if not (drop & r.meta.keys()):
            return r
        return dataclasses.replace(
            r, meta={k: v for k, v in r.meta.items() if k not in drop})

    def _execute_group(self, engine: str, group: list[QueryTicket],
                       finished: list) -> None:
        """Execute one fuse group: cached tickets answered for free, the
        rest as a single fused batch program (or solo when only one —
        or the algorithm has no batch path — remains).  A failing fused
        execution retries (and dead-letters) as a unit: every ticket in
        it shares the attempt chain."""
        ctx = group[0].context
        run: list[QueryTicket] = []
        for t in group:
            hit = self._cache_get(self._result_key(ctx, t.query))
            if hit is not None:
                if self.tracer is not None:
                    self.tracer.ticket_event([t.ticket_id], "cache-hit")
                self._finish(t, hit)
                finished.append(t)
            else:
                run.append(t)
        if not run:
            return
        defn = R.get(group[0].query.algorithm)
        if len(run) == 1 or not defn.fusable:
            for t in run:
                self._execute_solo(t, finished)
            return
        self._account_transfer(ctx, run[0].plan, run)
        pool = ctx.pool_for_plan(run[0].plan)
        profile = self.tracer is not None
        t0 = time.perf_counter()
        r, err = self._run_with_retries(
            lambda: ctx.engine(engine, pool).run_batch(
                defn, [t.query.params for t in run],
                count_only=[t.query.count_only for t in run],
                profile=profile),
            run[0].ticket_id, run, fused=True)
        wall = time.perf_counter() - t0
        if err is not None:
            self._dead_letter(run, err)
            finished.extend(run)
            return
        # one fused execution, one accuracy sample: the group's shared
        # wall against the head ticket's estimate, width recorded
        head = run[0]
        self._accuracy.record(head.query.algorithm, head.plan.engine,
                              head.plan.variant, head.plan.pool,
                              est_s=head.est_s, wall_s=wall,
                              mode=head.plan.mode, width=len(run))
        if self.tracer is not None:
            self.tracer.on_execute_result(
                [t.ticket_id for t in run], engine=r[0].engine,
                attrs={**self._result_attrs(r[0], wall),
                       "batch_size": len(run)},
                per_ticket={t.ticket_id: {"est_s": t.est_s,
                                          "index": i}
                            for i, t in enumerate(run)})
        with self._lock:
            self.stats["executed"] += 1
            self.stats["fused_batches"] += 1
            self.stats["fused_tickets"] += len(run)
            self._fusion_widths.append(len(run))
            for t, res in zip(run, r):
                res.meta["plan"] = t.plan
                # the cached copy drops 'fused' (and the superstep
                # counters) — they describe THIS run; a later hit
                # replaying them would claim a fusion that never
                # happened for that caller (the ticket keeps the full
                # meta)
                cached = self._strip_run_meta(res, also=("fused",))
                self._cache_put(self._result_key(ctx, t.query), cached)
                self._finish(t, res)
            self._log(engine, "batch", run, fused=True,
                      algorithm=defn.name)
        finished.extend(run)

    def _finish(self, t: QueryTicket, r: QueryResult) -> None:
        with self._cond:
            t.status = "done"
            self._results[t.ticket_id] = r
            self._hist[t.tier].observe(time.perf_counter() - t.queued_at)
            self._age_out(t)
            self._cond.notify_all()
        if self.tracer is not None:
            self.tracer.on_resolve([t.ticket_id], "done")

    def _dead_letter(self, tickets, error: BaseException) -> None:
        """The retry policy gave up: the tickets must not be stranded
        (out of every queue, forever pending).  They land in the
        ``dead-letter`` state keeping the attempt chain, ``result``
        re-raises, and the drain continues with the rest of the queue."""
        with self._cond:
            for t in tickets:
                t.status = "dead-letter"
                t.error = error
                self._hist[t.tier].observe(
                    time.perf_counter() - t.queued_at)
                self._age_out(t)
            self.stats["failed"] += len(tickets)
            self.stats["dead_letters"] += len(tickets)
            self._cond.notify_all()
        if self.tracer is not None:
            self.tracer.on_resolve([t.ticket_id for t in tickets],
                                   "dead-letter", error)

    def _age_out(self, t: QueryTicket) -> None:
        """Record ``t`` as resolved and evict the oldest resolved
        tickets (and their stored results) beyond ``history_size``."""
        self._resolved_order.append(t.ticket_id)
        while len(self._resolved_order) > max(self.history_size, 0):
            old = self._resolved_order.popleft()
            self._tickets.pop(old, None)
            self._results.pop(old, None)

    def _log(self, engine: str, tier: str, tickets, fused: bool,
             algorithm: str) -> None:
        self.execution_log.append({
            "engine": engine, "tier": tier, "fused": fused,
            "algorithm": algorithm,
            "tickets": [t.ticket_id for t in tickets]})
