"""Algorithm registry — the platform's single extension point.

The paper's platform (Section III-A) puts one unified interface above
heterogeneous engines so adding a use case does not mean re-plumbing
every layer.  This module is that property made concrete: an algorithm
is *data* — an ``AlgorithmDef`` carrying its parameter schema, its
runner, its count-only fast path, its planner cost hook and its engine
capability flags — and every layer (engines, planner, query, benchmarks,
tests) iterates the registry instead of hard-coding names.

Registering a new workload means creating one module under
``repro_torch/core/algorithms/`` that calls :func:`register` at import time.
Nothing else changes: ``ensure_loaded`` auto-discovers every module in
the package, so the engines, the planner and ``GraphQuery`` pick the new
algorithm up without edits (see ``algorithms/pagerank.py`` for the
canonical example).
"""
from __future__ import annotations

import dataclasses
import importlib
import pkgutil
import threading
import time
from typing import Any, Callable, Mapping, Optional

import numpy as np

from repro_torch.core import obs


class _Required:
    """Sentinel for parameters without a default."""

    def __repr__(self) -> str:  # pragma: no cover - repr cosmetics
        return "<required>"


REQUIRED = _Required()


@dataclasses.dataclass(frozen=True)
class Param:
    """One entry of an algorithm's parameter schema.

    ``default=REQUIRED`` marks a mandatory parameter.  ``normalize`` maps
    user input to the canonical (hashable) form — e.g. a source list to
    a tuple of ints — so validated params can key the platform's result
    cache.  ``check`` receives the normalized value and returns whether
    it is admissible.  Both are skipped for ``None`` values (``None``
    uniformly means "auto" in this codebase).
    """

    name: str
    default: Any = REQUIRED
    check: Optional[Callable[[Any], bool]] = None
    normalize: Optional[Callable[[Any], Any]] = None
    doc: str = ""

    @property
    def required(self) -> bool:
        return self.default is REQUIRED


@dataclasses.dataclass(frozen=True)
class AlgorithmDef:
    """Everything the platform needs to serve one algorithm.

    run     : the full-result runner.  Either a callable
              ``(engine, **params) -> (value, iterations_or_None)`` or a
              ``PregelSpec`` — in the latter case ``init`` must map
              ``(engine, params) -> (init_state, max_iters)`` and the
              engine drives ``run_pregel`` generically.
    count   : optional reducer ``value -> count`` for ``count_only``
              queries that post-process the full result (e.g.
              ``num_components``).
    count_run: optional *dedicated* count-only runner for algorithms
              whose fast path never materializes the full result at all
              (two-hop's degree-sum bound — the paper's '<2 s count vs
              ~10 min table' class).  Takes the same signature as a
              callable ``run`` and may ignore parameters.
    cost    : planner hook ``(GraphStats, params, count_only) ->
              QuerySpec`` — or a *sequence* of QuerySpecs, one per
              execution variant (each with ``variant`` set); receives
              schema defaults merged under any user-supplied params, so
              user caps like ``max_iters`` flow into the cost model.
    variants: optional mapping ``variant name -> runner`` for algorithms
              with several execution strategies that produce identical
              results (triangle counting's bitset vs ELL-intersect
              paths).  The planner picks the cheapest feasible variant
              per (graph, engine) from the cost hook's QuerySpecs; an
              engine invoked without a plan resolves one the same way.
              ``run`` stays the fallback when no variant is selected.
    batch_runner: optional *fused* executor
              ``(engine, [params, ...]) -> (values, iterations, meta)``
              that answers K compatible queries in ONE stacked/vmapped
              execution (K BFS frontiers as one ``[V, K]`` pregel
              program; K jaccard pair-batches as one kernel call) and
              returns one value per query, scatter-ready.  Each value
              must be bit-identical to running its query alone — the
              service's fusion contract.
    fuse    : compatibility key hook ``validated params -> hashable``;
              two queries may share one ``batch_runner`` call iff they
              target the same algorithm on the same graph and their fuse
              keys are equal (BFS fuses across ``sources`` but never
              across differing ``max_iters``).  ``None`` disables
              fusion even when a ``batch_runner`` exists.
    engines : capability flags; which engines can execute the
              definition (``("local",)`` for ELL-batch workloads that
              are inherently single-device).
    requires_symmetric : undirected semantics — the engine rejects
              non-symmetrized edge lists up front.
    method / count_method : engine method aliases (``eng.k_core(...)``,
              ``eng.k_core_size(...)``); ``method`` defaults to ``name``.
    example_params : a representative parameter set (satisfying the
              schema) used by the generic benchmark sweep and the parity
              test suite; ``None`` opts out of generic sweeps.
    warm_start : optional seeded runner
              ``(engine, params, seed) -> (value, iterations) | None``
              for fixpoint algorithms that can start iterating from a
              previous snapshot's converged result (``seed`` is a
              ``CachedResult``-like object with ``.value``).  Returning
              ``None`` declines — the engine falls back to the cold
              runner, so a bad seed can cost time but never correctness.
              The answer must equal the cold answer within the
              algorithm's stated tolerance; only iterations may differ.
    incremental : optional delta-maintenance runner
              ``(engine, params, seed, delta) -> (value, iters) | None``
              for algorithms that can repair a previous result against a
              ``GraphDelta`` (seeding the frontier from
              ``delta.touched``) instead of recomputing the whole graph.
              Must be *exact*: byte-identical to cold recompute, or
              decline with ``None`` (e.g. a monotone-add algorithm
              handed a delta containing removals).
    """

    name: str
    run: Any
    params: tuple[Param, ...] = ()
    init: Optional[Callable[[Any, dict], tuple]] = None
    count: Optional[Callable[[Any], Any]] = None
    count_run: Optional[Callable[..., tuple]] = None
    cost: Optional[Callable[..., Any]] = None
    variants: Optional[Mapping[str, Any]] = None
    batch_runner: Optional[Callable[..., tuple]] = None
    fuse: Optional[Callable[[dict], Any]] = None
    engines: tuple[str, ...] = ("local", "distributed")
    requires_symmetric: bool = False
    method: Optional[str] = None
    count_method: Optional[str] = None
    example_params: Optional[Mapping[str, Any]] = dataclasses.field(
        default_factory=dict)
    doc: str = ""
    warm_start: Optional[Callable[..., Optional[tuple]]] = None
    incremental: Optional[Callable[..., Optional[tuple]]] = None

    @property
    def has_count_path(self) -> bool:
        return self.count is not None or self.count_run is not None

    @property
    def fusable(self) -> bool:
        """Whether the service scheduler may coalesce compatible queries
        into one fused execution."""
        return self.batch_runner is not None and self.fuse is not None

    def runner_for(self, variant: Optional[str]):
        """Resolve the runner for ``variant`` (None -> default ``run``)."""
        if variant is None:
            return self.run
        if not self.variants or variant not in self.variants:
            known = sorted(self.variants or ())
            raise ValueError(
                f"{self.name}: unknown variant {variant!r}; "
                f"registered: {known}")
        return self.variants[variant]

    def defaults(self) -> dict:
        """Schema defaults (required parameters omitted)."""
        return {p.name: p.default for p in self.params if not p.required}

    def validate(self, params: Optional[Mapping[str, Any]] = None,
                 partial: bool = False) -> dict:
        """Check ``params`` against the schema; returns the normalized
        dict with defaults filled in.

        ``partial=True`` tolerates missing required parameters (the
        planner costs queries it cannot yet run — e.g. a spec sweep).
        Unknown parameter names are always an error.
        """
        params = dict(params or {})
        known = {p.name for p in self.params}
        unknown = sorted(set(params) - known)
        if unknown:
            raise ValueError(
                f"{self.name}: unknown parameter(s) {unknown}; "
                f"schema: {sorted(known)}")
        out = {}
        for p in self.params:
            if p.name in params:
                v = params[p.name]
            elif p.required:
                if partial:
                    continue
                raise ValueError(
                    f"{self.name}: missing required parameter {p.name!r}")
            else:
                v = p.default
            if v is not None:
                if p.normalize is not None:
                    v = p.normalize(v)
                if p.check is not None and not p.check(v):
                    raise ValueError(
                        f"{self.name}: invalid value {v!r} for "
                        f"parameter {p.name!r}")
            out[p.name] = v
        return out


# ---------------------------------------------------------------------------
# The registry proper
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, AlgorithmDef] = {}
_METHOD_TABLE: Optional[dict] = None
_LOADED = False
_LOADING = False

_ALGORITHMS_PKG = "repro_torch.core.algorithms"


def register(defn: AlgorithmDef, replace: bool = False) -> AlgorithmDef:
    """Add a definition; modules call this at import time."""
    global _METHOD_TABLE
    if not replace and defn.name in _REGISTRY \
            and _REGISTRY[defn.name] is not defn:
        raise ValueError(f"algorithm {defn.name!r} is already registered")
    _REGISTRY[defn.name] = defn
    _METHOD_TABLE = None
    return defn


def unregister(name: str) -> None:
    """Remove a definition (tests registering throwaway algorithms)."""
    global _METHOD_TABLE
    _REGISTRY.pop(name, None)
    _METHOD_TABLE = None


def ensure_loaded() -> None:
    """Import every module under ``repro_torch.core.algorithms`` so their
    ``register`` calls have run.  Auto-discovery is what makes adding an
    algorithm a one-file change: a new module in the package is found
    here without touching any dispatch table.

    Marked loaded only once every import succeeded — a failing module
    (e.g. a broken user algorithm) raises on *every* call rather than
    leaving a silently half-populated registry."""
    global _LOADED, _LOADING
    if _LOADED or _LOADING:      # _LOADING: reentrant import of this pkg
        return
    _LOADING = True
    try:
        pkg = importlib.import_module(_ALGORITHMS_PKG)
        for mod in pkgutil.iter_modules(pkg.__path__):
            importlib.import_module(f"{_ALGORITHMS_PKG}.{mod.name}")
        _LOADED = True
    finally:
        _LOADING = False


def get(name: str) -> AlgorithmDef:
    ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown algorithm {name!r}; registered: {names()}") from None


def names() -> list[str]:
    ensure_loaded()
    return sorted(_REGISTRY)


def items() -> list[tuple[str, AlgorithmDef]]:
    ensure_loaded()
    return sorted(_REGISTRY.items())


def method_table() -> dict[str, tuple[AlgorithmDef, bool]]:
    """Engine method name -> (definition, count_only) — the table behind
    ``Engine.__getattr__`` dispatch (``eng.num_components()`` ==
    ``eng.run("connected_components", count_only=True)``).  Memoized;
    ``register``/``unregister`` invalidate."""
    global _METHOD_TABLE
    ensure_loaded()
    if _METHOD_TABLE is None:
        table: dict[str, tuple[AlgorithmDef, bool]] = {}
        for defn in _REGISTRY.values():
            table[defn.method or defn.name] = (defn, False)
            if defn.count_method:
                table[defn.count_method] = (defn, True)
        _METHOD_TABLE = table
    return _METHOD_TABLE


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------
#
# The registry is where runners live, so it is also the seam where the
# service's failure paths are driven deterministically: a FaultPolicy
# installed against an algorithm name wraps every execution of that
# algorithm (the engines call ``apply_fault`` immediately before
# invoking the runner — solo and fused paths alike).  Production code
# never installs one; the runtime test harness uses them to exercise
# retry, dead-letter and slow-batch behaviour without flaky sleeps or
# monkeypatching engine internals.

class FaultInjected(RuntimeError):
    """The error a fault policy raises — a *retryable* runtime failure
    (unlike schema ``ValueError``s, which dead-letter immediately)."""


class FaultPolicy:
    """One injected failure behaviour.  ``apply`` runs right before the
    algorithm's runner; it may raise (failure) or sleep (delay).  Stock
    policies below; anything with an ``apply(algorithm)`` works."""

    def apply(self, algorithm: str) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


class FailNTimes(FaultPolicy):
    """Fail the first ``n`` executions, then succeed forever — the
    retry-then-success driver.  Thread-safe: concurrent workers see
    exactly ``n`` failures in total."""

    def __init__(self, n: int, message: str = "injected fault"):
        self.n = int(n)
        self.message = message
        self._remaining = int(n)
        self._lock = threading.Lock()

    def apply(self, algorithm: str) -> None:
        with self._lock:
            if self._remaining <= 0:
                return
            self._remaining -= 1
            k = self.n - self._remaining
        raise FaultInjected(
            f"{algorithm}: {self.message} ({k}/{self.n})")


class FailAlways(FaultPolicy):
    """Every execution fails — the dead-letter driver."""

    def __init__(self, message: str = "injected fault"):
        self.message = message

    def apply(self, algorithm: str) -> None:
        raise FaultInjected(f"{algorithm}: {self.message}")


class Delay(FaultPolicy):
    """Every execution sleeps ``seconds`` first — the slow-batch-ticket
    driver for latency/overlap tests (optionally failing afterwards)."""

    def __init__(self, seconds: float, then_fail: bool = False):
        self.seconds = float(seconds)
        self.then_fail = then_fail

    def apply(self, algorithm: str) -> None:
        time.sleep(self.seconds)
        if self.then_fail:
            raise FaultInjected(f"{algorithm}: injected fault after "
                                f"{self.seconds}s delay")


_FAULTS: dict[str, FaultPolicy] = {}
_FAULTS_LOCK = threading.Lock()


def install_fault(name: str, policy: FaultPolicy) -> FaultPolicy:
    """Install ``policy`` against algorithm ``name`` (replacing any
    previous one).  Returns the policy for chaining."""
    with _FAULTS_LOCK:
        _FAULTS[name] = policy
    return policy


def uninstall_fault(name: Optional[str] = None) -> None:
    """Remove one algorithm's fault policy, or all of them (``None``)."""
    with _FAULTS_LOCK:
        if name is None:
            _FAULTS.clear()
        else:
            _FAULTS.pop(name, None)


def apply_fault(name: str) -> None:
    """Run the installed fault policy for ``name``, if any — the hook
    the engines call per execution attempt.  Injections surface on the
    observability event stream (``obs.emit``) so traced drains can see
    which attempts a policy actually hit."""
    with _FAULTS_LOCK:
        policy = _FAULTS.get(name)
    if policy is not None:
        try:
            policy.apply(name)
        except BaseException as e:
            obs.emit("fault", algorithm=name,
                     policy=type(policy).__name__, error=repr(e))
            raise
        else:
            obs.emit("fault", algorithm=name,
                     policy=type(policy).__name__, error=None)


# ---------------------------------------------------------------------------
# Cache keys
# ---------------------------------------------------------------------------

def freeze(value: Any) -> Any:
    """Recursively convert a parameter value into a hashable key
    component (dicts to sorted item tuples, arrays to bytes)."""
    if isinstance(value, Mapping):
        return tuple(sorted((k, freeze(v)) for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return tuple(freeze(v) for v in value)
    if isinstance(value, (set, frozenset)):
        return tuple(sorted(freeze(v) for v in value))
    if isinstance(value, np.ndarray):
        return (value.dtype.str, value.shape, value.tobytes())
    if isinstance(value, (int, float, bool, str, bytes, type(None))):
        return value
    if hasattr(value, "__array__"):          # torch tensors and friends
        if hasattr(value, "cpu"):
            value = value.detach().cpu()
        arr = np.asarray(value)
        return (arr.dtype.str, arr.shape, arr.tobytes())
    return value                              # trust it to be hashable


# ---------------------------------------------------------------------------
# Superstep execution variants
# ---------------------------------------------------------------------------

def superstep_variants(spec) -> dict:
    """The standard ``variants`` mapping for a PregelSpec runner.

    ``dense`` is the spec itself (the gather/segment-combine oracle),
    ``fused`` the ELL-blocked fused-kernel strategy, and — when the spec
    declares a ``frontier_mode`` — ``frontier`` the packed active-list
    strategy.  All three produce bit-identical results (the engine falls
    back to dense whenever a strategy's preconditions fail), so the
    planner is free to pick per (graph, engine) from the cost hook's
    per-variant QuerySpecs.
    """
    from repro_torch.core.pregel import SuperstepVariant

    out = {"dense": spec, "fused": SuperstepVariant(spec, "fused")}
    if spec.frontier_mode is not None:
        out["frontier"] = SuperstepVariant(spec, "frontier")
    return out
