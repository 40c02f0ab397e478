"""Cost-based engine router — the paper's Fig. 5 finding made executable.

The paper's empirical law:

* small/medium graph, small output  -> local engine (Neo4j) wins
  ("Neo4j takes <2 s to return the count, Spark spends ~10 min");
* very large graph OR very large output -> distributed engine (Spark)
  wins; beyond single-instance memory it is the only option;
* the crossover sits around ~10M vertices for per-vertex outputs on their
  hardware (Fig. 5) and "less than 100 million edges and vertices" is the
  paper's rule of thumb for Neo4j.

Instead of a hard-coded threshold we keep an analytic cost model (device
memory bandwidth for the local engine, per-superstep launch + collective
volume for the distributed engine, host egress for outputs).  The model
intentionally has few terms — it must be explainable to the user in the
query plan, like the paper's rule of thumb was.

The analytic constants below are the JAX reference package's, kept
unchanged so that both packages choose the same (engine, variant) for
the same query; they are not measurements of any GPU.  The port ships no
fitted calibration profile yet, so it always starts on these defaults.

Two feedback loops replace analytic guesses with measurements:

* ``GraphStats`` carries optional *measured* fields (observed max
  in-degree, the built ``OrientedELL`` row width) that engines feed back
  from derived state they have already paid to build — cost hooks prefer
  them over their analytic stand-ins.
* The model constants live in a :class:`CalibrationProfile` that a
  calibration sweep writes from wall-clock measurements and
  :func:`load_calibration` applies process-wide —
  including the service tier thresholds (interactive-vs-batch
  classification and the admission budget).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping, Optional, Sequence

from repro_torch.core import registry

# The reference package's analytic defaults (sized for its original
# accelerator, not for a GPU) that seed CalibrationProfile; estimates read
# the *active profile*, so load_calibration overrides these without
# touching module globals.
HBM_BW = 819e9            # B/s
LINK_BW = 50e9            # B/s per inter-chip link
HOST_EGRESS_BW = 4e9      # B/s device->host for result materialization
LOCAL_DISPATCH_S = 2e-4   # query launch
DIST_STEP_S = 1.5e-3      # per-superstep launch + sync on a mesh
LOCAL_MEM_BUDGET = 12e9   # usable device memory for the local engine's graph

# Analytic per-superstep edge-traffic multipliers for the superstep
# execution variants (relative to the dense gather/segment-combine
# path's raw edge bytes).  The fused kernel streams the same edges but
# skips the [E] message materialization and the segment-sort; the
# frontier path touches only edges incident to active vertices —
# averaged over a BFS-like run the active fraction is small.  A fitted
# CalibrationProfile (``superstep_edge_bytes``) overrides these.
_SUPERSTEP_EDGE_BYTES = {"dense": 1.0, "fused": 0.75, "frontier": 0.15}


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """Static graph shape plus optional *measured* structure.

    ``max_degree`` (observed max in-degree) and ``oriented_width`` (the
    built ``OrientedELL`` row width) default to ``None`` — unknown until
    an engine has built the corresponding derived state and fed it back
    (``Engine.measurements``).  Cost hooks fall back to analytic
    estimates when a field is ``None``.
    """

    n_vertices: int
    n_edges: int
    bytes_coo: int
    max_degree: Optional[int] = None
    oriented_width: Optional[int] = None
    max_out_degree: Optional[int] = None

    @classmethod
    def of(cls, graph) -> "GraphStats":
        return cls(graph.n_vertices, graph.n_edges, graph.nbytes())

    def with_measurements(self, meas: Mapping[str, int]) -> "GraphStats":
        """Stats with measured fields merged in (unknown keys rejected,
        ``None`` values ignored)."""
        fields = {"max_degree", "oriented_width", "max_out_degree"}
        unknown = sorted(set(meas) - fields)
        if unknown:
            raise ValueError(f"unknown measurement(s) {unknown}")
        updates = {k: int(v) for k, v in meas.items() if v is not None}
        return dataclasses.replace(self, **updates) if updates else self


# ---------------------------------------------------------------------------
# Calibration profile — the model constants as loadable data
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CalibrationProfile:
    """Every constant the cost model and the service tiering consume.

    ``algo_time_scale`` maps an algorithm name to a measured/modeled
    wall-clock ratio: a calibration sweep
    fits one multiplier per algorithm from its timing sweep, so the
    planner's relative estimates are anchored to real executions instead
    of the analytic bandwidth terms alone.  ``interactive_threshold_s``
    and ``admission_budget_s`` are the service tier thresholds
    (interactive tickets bypass the batch queue; queries estimated above
    the budget are rejected at submit with the plan attached).
    """

    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW
    host_egress_bw: float = HOST_EGRESS_BW
    local_dispatch_s: float = LOCAL_DISPATCH_S
    dist_step_s: float = DIST_STEP_S
    local_mem_budget: float = LOCAL_MEM_BUDGET
    interactive_threshold_s: float = 0.05
    admission_budget_s: float = float("inf")
    algo_time_scale: Mapping[str, float] = dataclasses.field(
        default_factory=dict)
    # Per-superstep edge-traffic multipliers for the superstep execution
    # variants (overrides of _SUPERSTEP_EDGE_BYTES; fitted by a
    # calibration sweep from per-variant timings).
    superstep_edge_bytes: Mapping[str, float] = dataclasses.field(
        default_factory=dict)
    source: str = "analytic-defaults"

    def scale(self, algorithm: str) -> float:
        return float(self.algo_time_scale.get(algorithm, 1.0))

    def superstep_factor(self, variant: str) -> float:
        """Edge-bytes multiplier for a superstep variant."""
        base = _SUPERSTEP_EDGE_BYTES.get(variant, 1.0)
        return float(self.superstep_edge_bytes.get(variant, base))

    def to_json(self, path) -> None:
        d = dataclasses.asdict(self)
        d["algo_time_scale"] = dict(self.algo_time_scale)
        d["superstep_edge_bytes"] = dict(self.superstep_edge_bytes)
        if d["admission_budget_s"] == float("inf"):
            d["admission_budget_s"] = None        # JSON has no inf
        with open(path, "w") as f:
            json.dump(d, f, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, path) -> "CalibrationProfile":
        with open(path) as f:
            d = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"calibration profile {path}: unknown "
                             f"field(s) {unknown}")
        if d.get("admission_budget_s") is None:
            d["admission_budget_s"] = float("inf")
        d["algo_time_scale"] = {
            str(k): float(v)
            for k, v in (d.get("algo_time_scale") or {}).items()}
        d["superstep_edge_bytes"] = {
            str(k): float(v)
            for k, v in (d.get("superstep_edge_bytes") or {}).items()}
        return cls(**d)


#: Where a fitted calibration profile is looked for at import.  The port
#: ships none (no GPU calibration sweep exists yet), so the import-time
#: load finds nothing and the analytic defaults stay active; a profile
#: dropped here is auto-loaded.
_REFERENCE_PROFILE = os.path.join(os.path.dirname(__file__),
                                  "calibration", "reference_profile.json")


def reference_profile_path() -> str:
    return _REFERENCE_PROFILE


def _load_reference() -> Optional["CalibrationProfile"]:
    try:
        return CalibrationProfile.from_json(_REFERENCE_PROFILE)
    except (OSError, ValueError, TypeError):
        return None


_REFERENCE = _load_reference()
#: True when the checked-in reference profile parsed and became the
#: import-time default (the calibration-residue contract).
AUTO_LOADED_REFERENCE = _REFERENCE is not None

_ACTIVE_PROFILE = _REFERENCE if _REFERENCE is not None \
    else CalibrationProfile()
_PROFILE_GENERATION = 0    # bumped on every swap; plan caches key on it


def active_calibration() -> CalibrationProfile:
    return _ACTIVE_PROFILE


def calibration_generation() -> int:
    """Monotone counter of profile swaps — cached plans costed under an
    older generation are stale and must be re-costed."""
    return _PROFILE_GENERATION


def set_calibration(profile: Optional[CalibrationProfile]) \
        -> CalibrationProfile:
    """Install ``profile`` process-wide (``None`` restores the analytic
    defaults).  Returns the now-active profile."""
    global _ACTIVE_PROFILE, _PROFILE_GENERATION
    _ACTIVE_PROFILE = profile if profile is not None else CalibrationProfile()
    _PROFILE_GENERATION += 1
    return _ACTIVE_PROFILE


def load_calibration(path) -> CalibrationProfile:
    """Load a ``--emit-calibration`` profile and make it active."""
    return set_calibration(CalibrationProfile.from_json(path))


def load_reference_calibration() -> CalibrationProfile:
    """(Re-)install the checked-in reference profile — the explicit form
    of the import-time auto-load (tests that pinned the analytic
    defaults use this to opt back in)."""
    return load_calibration(_REFERENCE_PROFILE)


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """What the planner needs to know about a query.

    output_rows: expected result cardinality (1 for counts; V for
    per-vertex tables; pair-count estimates for motifs).
    iterations: expected supersteps (1 for motifs/degrees).
    row_bytes: bytes per output row.
    state_bytes_per_vertex: per-superstep vertex-state traffic (8 for
    scalar programs; triangle counting's neighborhood bitsets are
    ~V/8 bytes per vertex — the term that pushes it distributed early).
    edge_bytes_factor: message-volume multiplier over the raw edge bytes
    (1 for scalar messages; label propagation's 2C-channel structured
    messages move ~2C*4/12 times the edge list per superstep).
    variant: when an algorithm registers several execution strategies
    (triangle counting's bitset vs ELL-intersect paths), its cost hook
    returns one QuerySpec per variant and ``choose_plan`` picks the
    cheapest feasible (engine, variant) pair.
    """
    algorithm: str
    output_rows: int
    iterations: int = 1
    row_bytes: int = 8
    state_bytes_per_vertex: float = 8.0
    edge_bytes_factor: float = 1.0
    variant: Optional[str] = None


def superstep_specs(algorithm: str, *, output_rows: int, iterations: int,
                    row_bytes: int = 8, state_bytes_per_vertex: float = 8.0,
                    frontier: bool = True) -> tuple:
    """Per-variant QuerySpecs for a superstep-variant algorithm.

    One spec per execution strategy (dense / fused / frontier), differing
    only in ``edge_bytes_factor`` — the active profile's per-variant
    multiplier.  Dense comes first so cost ties keep the oracle path
    (``choose_plan`` prefers earlier specs on ties).
    """
    pr = _ACTIVE_PROFILE
    names = ("dense", "fused", "frontier") if frontier \
        else ("dense", "fused")
    return tuple(
        QuerySpec(algorithm, output_rows, iterations=iterations,
                  row_bytes=row_bytes,
                  state_bytes_per_vertex=state_bytes_per_vertex,
                  edge_bytes_factor=pr.superstep_factor(v), variant=v)
        for v in names)


@dataclasses.dataclass(frozen=True)
class PlanCandidate:
    """One row of the planner's candidate table — a
    (pool, engine, variant, mode) combination with its cost terms.

    ``choose_plan`` records every combination it costed (not just the
    winner) on ``Plan.candidates``, so ``service.explain()`` can show
    the losing placements and why they lost.  ``feasible=False`` rows
    were never in the running (infinite cost, unhealthy pool, engine
    excluded by a capability clamp) and carry the ``note``; exactly one
    row has ``chosen=True``.
    """

    engine: str
    variant: Optional[str] = None
    pool: Optional[str] = None
    mode: str = "full"
    est_s: float = float("inf")
    compute_s: float = float("inf")
    transfer_s: float = 0.0
    feasible: bool = True
    chosen: bool = False
    note: str = ""


def mark_chosen(candidates, engine, variant=None, pool=None,
                mode="full", note="") -> tuple:
    """Re-mark the candidate table after the winner changed outside
    ``choose_plan`` (the service's ``force_engine`` / capability-clamp
    re-plan, ``price_incremental`` mode flips).  Exactly the matching
    (engine, variant, pool, mode) row becomes chosen; if no row matches
    (the override picked a combination the table never costed) a
    synthetic chosen row is appended with ``note``."""
    out, hit = [], False
    for c in candidates:
        chosen = (not hit and c.engine == engine and c.variant == variant
                  and c.pool == pool and c.mode == mode)
        hit = hit or chosen
        if c.chosen != chosen:
            c = dataclasses.replace(c, chosen=chosen)
        out.append(c)
    if not hit:
        out.append(PlanCandidate(engine, variant, pool, mode,
                                 chosen=True, note=note))
    return tuple(out)


@dataclasses.dataclass
class Plan:
    engine: str                   # 'local' | 'distributed'
    est_local_s: float
    est_dist_s: float
    reason: str
    variant: Optional[str] = None  # chosen execution variant, if any
    # -- federation axis ----------------------------------------------------
    # pool: the DevicePool the plan places onto (None on the legacy
    # poolset-free path).  est_s: the chosen pool's *total* estimate —
    # compute (scaled by the pool's compute_scale) plus transfer_s, the
    # data-locality term (0 when the snapshot is resident on the pool,
    # else bytes_coo / pool.link_bandwidth).  ``price_incremental`` also
    # writes est_s when it flips the mode, so ``plan_cost`` always
    # reflects the path the plan actually prescribes.
    pool: Optional[str] = None
    est_s: Optional[float] = None
    transfer_s: float = 0.0
    # -- incremental axis ---------------------------------------------------
    # 'full' recomputes from scratch; 'incremental' seeds a localized
    # repair from the parent snapshot's result + the recorded delta;
    # 'warm' restarts a fixpoint from an ancestor's converged vector.
    # Execution treats non-full modes as advisory: an algorithm hook
    # that declines (removals under an add-only repair, exhausted
    # iteration budget) falls back to the cold run, so the mode affects
    # cost estimates and tiering, never correctness.
    mode: str = "full"
    # -- observability ------------------------------------------------------
    # The full candidate table the planner costed (PlanCandidate rows,
    # the winner marked chosen) — what ``service.explain()`` renders.
    # Empty on hand-built plans; never consulted by execution.
    candidates: tuple = ()


def estimate_local_cost(g: GraphStats, q: QuerySpec,
                        profile: Optional[CalibrationProfile] = None) -> float:
    """One device streams the edge set from HBM each superstep, then
    egresses the output to the host once."""
    pr = profile or _ACTIVE_PROFILE
    if g.bytes_coo + q.state_bytes_per_vertex * g.n_vertices \
            > pr.local_mem_budget:
        return float("inf")
    touched = (g.bytes_coo * q.edge_bytes_factor
               + q.state_bytes_per_vertex * g.n_vertices) * q.iterations
    return pr.scale(q.algorithm) * (
        pr.local_dispatch_s
        + touched / pr.hbm_bw
        + q.output_rows * q.row_bytes / pr.host_egress_bw)


def estimate_dist_cost(g: GraphStats, q: QuerySpec, n_chips: int,
                       vertex_replicated: bool = True,
                       profile: Optional[CalibrationProfile] = None) -> float:
    """Each chip streams E/P edges; every superstep pays a launch/sync and
    a ring all-reduce of the vertex aggregate; output egress parallelizes
    over hosts."""
    pr = profile or _ACTIVE_PROFILE
    n_chips = max(n_chips, 1)
    touched = (g.bytes_coo * q.edge_bytes_factor / n_chips
               + q.state_bytes_per_vertex * g.n_vertices) * q.iterations
    coll = 0.0
    if vertex_replicated and n_chips > 1:
        ring = 2.0 * (n_chips - 1) / n_chips
        coll = (q.state_bytes_per_vertex * g.n_vertices * ring / pr.link_bw) \
            * q.iterations
    egress = q.output_rows * q.row_bytes / (
        pr.host_egress_bw * max(n_chips // 4, 1))
    return pr.scale(q.algorithm) * (
        pr.dist_step_s * q.iterations + touched / pr.hbm_bw + coll + egress)


def plan_cost(plan: Plan) -> float:
    """The estimate for the plan's *chosen* engine — what the service's
    admission/tier classification keys on.  Pool-aware plans carry the
    total (compute-scaled + transfer) in ``est_s``; legacy plans fall
    back to the raw per-engine estimate."""
    if plan.est_s is not None:
        return plan.est_s
    return plan.est_local_s if plan.engine == "local" else plan.est_dist_s


# -- incremental-vs-full pricing -------------------------------------------
#
# The repair wavefront from a delta's touched vertices does not stay on
# those vertices: each superstep it can spill one hop outward.  The
# analytic stand-in multiplies the touched fraction by a constant
# expansion factor — crude, but it creates the crossover the catalog
# needs (a 0.1% delta prices far below a full recompute, a 30% delta
# prices above it).  Warm starts run the *full* iteration body, just
# fewer rounds; power iterations on the daily graph typically restart
# within a constant fraction of the cold iteration count.
INCR_WAVEFRONT_EXPANSION = 4.0
WARM_ITER_FRACTION = 0.5


def full_traffic_cost(g: GraphStats, q: QuerySpec,
                      profile: Optional[CalibrationProfile] = None) -> float:
    """The cold run's edge/state traffic seconds — the *variable* term
    of :func:`estimate_local_cost`, without the fixed dispatch and
    output-egress costs a seeded run pays identically."""
    pr = profile or _ACTIVE_PROFILE
    touched = (g.bytes_coo * q.edge_bytes_factor
               + q.state_bytes_per_vertex * g.n_vertices) * q.iterations
    return pr.scale(q.algorithm) * touched / pr.hbm_bw


def estimate_incremental_cost(g: GraphStats, q: QuerySpec, delta,
                              profile: Optional[CalibrationProfile] = None,
                              ) -> float:
    """Traffic seconds of a localized incremental repair: the repair
    wavefront touches ``frac`` of the per-round edge/state traffic and
    converges in proportionally fewer rounds (it must re-cover the
    touched region, not the whole graph's diameter).  At ``frac=1``
    the estimate degenerates to :func:`full_traffic_cost`, so huge
    deltas always price ``'full'``.  The delta bytes themselves are
    NOT charged here — they were ingested once when the snapshot was
    registered (``delta size x touched-frontier estimate`` is the
    comparison, amortized over every query the version serves).
    ``delta`` needs ``n_touched`` — :class:`repro_torch.core.graph.
    GraphDelta` or anything shaped like it."""
    pr = profile or _ACTIVE_PROFILE
    V = max(g.n_vertices, 1)
    frac = min(1.0, INCR_WAVEFRONT_EXPANSION * delta.n_touched / V)
    iters = max(1.0, q.iterations * frac)
    touched = (g.bytes_coo * q.edge_bytes_factor
               + q.state_bytes_per_vertex * g.n_vertices) * frac * iters
    return pr.scale(q.algorithm) * touched / pr.hbm_bw


def price_incremental(plan: Plan, g: GraphStats, q: QuerySpec,
                      delta=None, seed_mode: Optional[str] = None,
                      profile: Optional[CalibrationProfile] = None) -> Plan:
    """Re-price ``plan`` given an available warm-start seed.

    ``seed_mode`` is what the catalog found: ``'incremental'`` (the
    direct parent's converged result plus the recorded delta) or
    ``'warm'`` (an ancestor's converged vector, no usable delta).  The
    comparison is between the two *traffic* terms — fixed dispatch and
    output egress are identical either way and cancel.  When the
    repair's traffic beats the cold traffic the plan's ``mode`` flips
    and ``est_s`` carries the adjusted total; a delta too large to win
    keeps ``mode='full'`` (ties too — the cold path needs no seed
    plumbing).  Applied exactly once per plan, at the end of the
    planning pipeline.  ``None`` seed_mode returns the plan
    untouched."""
    if seed_mode is None:
        return plan

    def with_mode_row(mode: str, est: float, chosen: bool,
                      note: str = "") -> tuple:
        row = PlanCandidate(plan.engine, plan.variant, plan.pool, mode,
                            est_s=est, compute_s=est - plan.transfer_s,
                            transfer_s=plan.transfer_s, note=note)
        table = plan.candidates + (row,)
        if chosen:
            return mark_chosen(table, plan.engine, plan.variant,
                               plan.pool, mode)
        return table

    full = plan_cost(plan)
    if seed_mode == "incremental" and delta is not None:
        cold_traffic = full_traffic_cost(g, q, profile)
        inc_traffic = estimate_incremental_cost(g, q, delta, profile)
        est = max(full - cold_traffic + inc_traffic, 0.0)
        if inc_traffic < cold_traffic:
            return dataclasses.replace(
                plan, mode="incremental", est_s=est,
                candidates=with_mode_row("incremental", est, True),
                reason=f"incremental repair ({delta.n_touched} touched, "
                       f"{est*1e3:.2f} ms vs full {full*1e3:.2f} ms); "
                       f"{plan.reason}")
        return dataclasses.replace(
            plan,
            candidates=with_mode_row(
                "incremental", est, False,
                note="repair traffic loses to full recompute"),
            reason=f"full recompute beats incremental (traffic "
                   f"{cold_traffic*1e3:.3f} ms vs {inc_traffic*1e3:.3f} "
                   f"ms); {plan.reason}")
    if seed_mode == "warm":
        warm = full * WARM_ITER_FRACTION
        return dataclasses.replace(
            plan, mode="warm", est_s=warm,
            candidates=with_mode_row("warm", warm, True),
            reason=f"warm start from ancestor result "
                   f"(~{warm*1e3:.2f} ms vs cold {full*1e3:.2f} ms); "
                   f"{plan.reason}")
    return plan


def _engine_candidates(q: QuerySpec, tl: float, td: float,
                       winner: str) -> tuple:
    """The legacy path's two candidate rows for one spec."""
    return (
        PlanCandidate("local", q.variant, est_s=tl, compute_s=tl,
                      feasible=tl != float("inf"),
                      chosen=winner == "local",
                      note="" if tl != float("inf")
                      else "exceeds local memory budget"),
        PlanCandidate("distributed", q.variant, est_s=td, compute_s=td,
                      chosen=winner == "distributed"),
    )


def choose_engine(g: GraphStats, q: QuerySpec, n_chips: int) -> Plan:
    tl = estimate_local_cost(g, q)
    td = estimate_dist_cost(g, q, n_chips)
    if tl == float("inf"):
        need = g.bytes_coo + q.state_bytes_per_vertex * g.n_vertices
        return Plan("distributed", tl, td,
                    f"graph + vertex state ({need/1e9:.1f} GB) exceeds "
                    f"local budget", variant=q.variant,
                    candidates=_engine_candidates(q, tl, td, "distributed"))
    if tl <= td:
        why = ("small output" if q.output_rows <= 1024 else "medium graph")
        return Plan("local", tl, td, f"local wins ({why}): "
                    f"{tl*1e3:.2f} ms vs {td*1e3:.2f} ms", variant=q.variant,
                    candidates=_engine_candidates(q, tl, td, "local"))
    return Plan("distributed", tl, td,
                f"distributed wins (scale/output): {td*1e3:.2f} ms vs {tl*1e3:.2f} ms",
                variant=q.variant,
                candidates=_engine_candidates(q, tl, td, "distributed"))


def transfer_seconds(g: GraphStats, pool) -> float:
    """Time to materialize a non-resident snapshot onto ``pool`` — the
    data-locality term the federation planner adds for remote pools."""
    bw = float(getattr(pool, "link_bandwidth", 0.0) or 0.0)
    if bw <= 0:
        return float("inf")
    return g.bytes_coo / bw


def choose_plan(g: GraphStats, specs: Sequence[QuerySpec],
                n_chips: int, pools=None, resident=None,
                engines: Sequence[str] = ("local", "distributed")) -> Plan:
    """Pick the cheapest feasible placement.

    Without ``pools`` (the legacy path) this minimizes over
    (engine, variant): with one spec it is exactly :func:`choose_engine`
    (same Plan, same reason strings); with several — one per registered
    execution variant — every (spec, engine) combination is costed and
    the global minimum wins; a variant whose state fits one device can
    keep a query local that another variant's memory footprint would
    force distributed (triangle counting's ELL-intersect vs bitset
    paths).  Ties prefer earlier specs, so the registration order is
    the tie-break for interactive-scale graphs.

    With ``pools`` (a sequence of :class:`~repro_torch.core.pools.DevicePool`
    or anything shaped like one) the minimum runs over
    **(pool, engine, variant)**: each healthy pool's cost is
    ``compute_scale * engine_estimate(pool chips) + transfer``, where
    the transfer term is zero when the pool's name is in ``resident``
    and ``bytes_coo / link_bandwidth`` otherwise — a resident replica
    is the locality discount the paper's snapshot placement buys.
    ``engines`` restricts the engine axis (the ``force_engine`` /
    capability-clamp re-plan path).  Ties prefer earlier pools, then
    earlier specs, then the local engine — so a trivial one-pool set
    reproduces the legacy choice exactly.
    """
    specs = list(specs)
    if pools is None:
        if len(specs) == 1:
            return choose_engine(g, specs[0], n_chips)
        best, best_cost, table = None, float("inf"), []
        for q in specs:
            plan = choose_engine(g, q, n_chips)
            table += [dataclasses.replace(c, chosen=False)
                      for c in plan.candidates]
            # the distributed estimate is always finite, so every spec
            # has a finite comparison cost and the first seeds ``best``
            cost = plan.est_local_s if plan.engine == "local" \
                else plan.est_dist_s
            if best is None or cost < best_cost:
                best, best_cost = plan, cost
        best = dataclasses.replace(
            best, candidates=mark_chosen(table, best.engine, best.variant))
        if best.variant is not None:
            best = dataclasses.replace(
                best, reason=f"variant {best.variant}: {best.reason}")
        return best

    resident = frozenset(resident or ())
    healthy = [p for p in pools if getattr(p, "healthy", True)]
    if not healthy:
        raise ValueError(
            f"no healthy pool to place onto (pools: "
            f"{[getattr(p, 'name', '?') for p in pools]})")
    best = best_pool = None
    best_cost = float("inf")
    table = []
    for pool in pools:
        pool_ok = getattr(pool, "healthy", True)
        pn = getattr(pool, "n_chips", None) or n_chips
        scale = float(getattr(pool, "compute_scale", 1.0))
        transfer = 0.0 if pool.name in resident else transfer_seconds(g, pool)
        for q in specs:
            tl = estimate_local_cost(g, q)
            td = estimate_dist_cost(g, q, pn)
            for engine, base in (("local", tl), ("distributed", td)):
                total = scale * base + transfer
                if not pool_ok:
                    note = "pool unhealthy"
                elif engine not in engines:
                    note = "engine excluded (forced engine or " \
                           "capability clamp)"
                elif total == float("inf"):
                    note = ("exceeds local memory budget"
                            if base == float("inf")
                            else "no link bandwidth to transfer")
                else:
                    note = ""
                table.append(PlanCandidate(
                    engine, q.variant, pool.name, est_s=total,
                    compute_s=scale * base, transfer_s=transfer,
                    feasible=not note, note=note))
                # infinite totals still seed ``best`` (an over-budget
                # plan must surface so admission can reject it with the
                # estimate attached); unhealthy pools and clamped
                # engines never do.
                if not pool_ok or engine not in engines:
                    continue
                if best is None or total < best_cost:
                    best = Plan(engine, tl, td, "", variant=q.variant,
                                pool=pool.name, est_s=total,
                                transfer_s=transfer)
                    best_pool, best_cost = pool, total
    if best is None:
        raise ValueError(f"no engine among {tuple(engines)} to place onto")
    best.candidates = mark_chosen(table, best.engine, best.variant,
                                  best.pool)
    locality = "resident" if best.transfer_s == 0.0 else \
        f"+{best.transfer_s * 1e3:.2f} ms transfer"
    why = (f"{best.engine} on pool {best_pool.name} ({locality}): "
           f"{best_cost * 1e3:.2f} ms est")
    if best.variant is not None:
        why = f"variant {best.variant}: {why}"
    best.reason = why
    return best


def best_spec_for_engine(g: GraphStats, specs: Sequence[QuerySpec],
                         engine: str, n_chips: int = 1) -> QuerySpec:
    """Cheapest feasible variant *given* an engine — how an engine called
    directly (no platform/plan in sight) resolves a variant, and how the
    platform re-picks after ``force_engine`` or a capability clamp."""
    specs = list(specs)

    def cost(q):
        if engine == "local":
            return estimate_local_cost(g, q)
        return estimate_dist_cost(g, q, n_chips)

    return min(specs, key=cost)


# Query specs come from each algorithm's registered cost hook --------------

def specs_for(algorithm: str, g: GraphStats, count_only: bool = False,
              **params) -> tuple[QuerySpec, ...]:
    """All of an algorithm's QuerySpecs — one per execution variant.

    ``params`` are merged over the schema defaults, so user-supplied
    caps (``max_iters``) and planner hints (``expected_pairs``,
    ``n_channels``) flow into the estimate.  Algorithms without a cost
    hook get a conservative per-vertex-output, one-superstep spec.
    Single-variant cost hooks return a bare QuerySpec; multi-variant
    hooks return a sequence with ``variant`` set on every entry.
    """
    defn = registry.get(algorithm)
    merged = defn.validate(params, partial=True)
    if defn.cost is None:
        return (QuerySpec(algorithm, 1 if count_only else g.n_vertices),)
    spec = defn.cost(g, merged, count_only)
    if isinstance(spec, QuerySpec):
        return (spec,)
    return tuple(spec)


def spec_for(algorithm: str, g: GraphStats, count_only: bool = False,
             **params) -> QuerySpec:
    """The algorithm's *primary* spec (first registered variant) — the
    single-spec view most callers and calibration sweeps want; variant
    routing goes through :func:`specs_for` + :func:`choose_plan`."""
    return specs_for(algorithm, g, count_only, **params)[0]
