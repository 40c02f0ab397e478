"""GraphQuery — the unified interface layer (paper Section III-A).

The paper's stack puts "a unified user interface ... and code templates"
above the engines so users never pick Spark-vs-Neo4j by hand.  This is
that layer: a small declarative query object + ``GraphPlatform`` which
owns both engines and routes through the cost-based planner.

    platform = GraphPlatform(coo)            # on cuda:0 unless told otherwise
    r = platform.query(GraphQuery.connected_components(count_only=True))
    r.value, r.engine, r.meta['plan']

Queries target any algorithm in the registry: the named classmethods are
thin wrappers over the generic, schema-validated constructor

    GraphQuery.of("hits", max_iters=50)

so a newly registered algorithm is queryable with zero edits here.

``GraphPlatform`` is a thin per-graph facade over the service layer
(``repro_torch.core.service``): one ``GraphAnalyticsService`` with a
single-entry catalog.  The service owns the plan cache (cost model +
routing per distinct query shape) and the *result* cache keyed on
``(graph content digest, algorithm, frozen params, count_only)`` — a
repeated identical query on a resident graph returns the cached result
without re-tracing or re-running anything.  Keying on the content
digest (not ``id()``, which CPython recycles the moment a graph is
garbage-collected) makes the cache sound across graph lifetimes and
lets byte-identical reloaded snapshots share entries: pass one mapping
as ``result_cache`` to several platforms and a query answered for a
graph is a hit for every later platform built over the same bytes.
The engine is deliberately *not* in the key — results are
contractually engine-independent, so a re-plan onto the other engine
(``force_engine`` toggled, chip count changed) still hits.

Multi-graph catalogs, admission tiers and fused batch execution live
one level up: build a ``GraphAnalyticsService`` directly and ``submit``
queries for tickets instead of calling ``query`` synchronously.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

from repro_torch.core import graph as G
from repro_torch.core import registry as R
from repro_torch.core.engines import LocalEngine, DistributedEngine, QueryResult
from repro_torch.core.service import GraphAnalyticsService


@dataclasses.dataclass(frozen=True)
class GraphQuery:
    """One declarative query; ``algorithm`` is any registered name
    (``repro_torch.core.registry.names()``).

    ``count_only=True`` selects the algorithm's count-only fast path
    (the paper's '<2 s count vs ~10 min table' query class) where one
    exists; it is a no-op for algorithms whose result is already a
    scalar summary.
    """

    algorithm: str
    count_only: bool = False
    params: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def of(cls, algorithm: str, count_only: bool = False,
           **params) -> "GraphQuery":
        """Generic constructor: validates ``params`` against the
        algorithm's registered schema (unknown names, missing required
        parameters and out-of-range values all raise here, not at
        execution time) and fills in schema defaults."""
        defn = R.get(algorithm)
        return cls(algorithm, count_only, defn.validate(params))

    def key(self):
        """Hashable identity of this query (cache key component)."""
        return (self.algorithm, R.freeze(self.params), self.count_only)

    # -- named constructors (thin wrappers over ``of``) ---------------------
    @classmethod
    def pagerank(cls, alpha=0.85, tol=1e-8, max_iters=100):
        return cls.of("pagerank", alpha=alpha, tol=tol, max_iters=max_iters)

    @classmethod
    def connected_components(cls, count_only=False, max_iters=200):
        return cls.of("connected_components", count_only,
                      max_iters=max_iters)

    @classmethod
    def degree_stats(cls):
        return cls.of("degree_stats", True)

    @classmethod
    def bfs(cls, sources, count_only=False, max_iters=None):
        """Hop distances from a source set; ``count_only`` returns the
        size of the reachable set instead of the distance table.
        ``max_iters=None`` guarantees convergence."""
        return cls.of("bfs", count_only, sources=tuple(sources),
                      max_iters=max_iters)

    @classmethod
    def sssp(cls, source: int, max_iters=None):
        """Single-source weighted shortest paths (non-negative weights)."""
        return cls.of("sssp", source=source, max_iters=max_iters)

    @classmethod
    def triangle_count(cls):
        """Global triangle count (inherently count-only)."""
        return cls.of("triangle_count", True)

    @classmethod
    def k_core(cls, k: int, count_only=False, max_iters=None):
        """k-core membership; ``count_only`` returns the core size."""
        return cls.of("k_core", count_only, k=k, max_iters=max_iters)


class GraphPlatform:
    """Per-graph facade over :class:`GraphAnalyticsService`: one graph,
    both engines, synchronous queries routed through the planner and
    served from the service's shared result cache.

    ``device=None`` runs on the first CUDA device and raises where CUDA
    is absent; ``device="cpu"`` asks for the host explicitly.  A graph
    built on another device is moved once, at construction."""

    GRAPH = "default"

    def __init__(self, coo: G.GraphCOO, mesh=None, n_data: int = 1,
                 n_model: int = 1, local_max_degree: int = 128,
                 force_engine: Optional[str] = None, cache_size: int = 128,
                 result_cache: Optional[OrderedDict] = None, device=None):
        self.mesh = mesh
        # a caller-supplied result_cache mapping may be shared across
        # platforms (the reloaded-snapshot case); entries are keyed on
        # content digests so sharing can never serve a stale result
        self.service = GraphAnalyticsService(cache_size=cache_size,
                                             result_cache=result_cache)
        self._ctx = self.service.add_graph(
            self.GRAPH, coo, mesh=mesh, n_data=n_data, n_model=n_model,
            local_max_degree=local_max_degree, force_engine=force_engine,
            device=device)
        self.coo = self._ctx.coo          # on the resolved device

    # -- service-layer delegates -------------------------------------------
    @property
    def stats(self):
        return self._ctx.current_stats()

    @property
    def force_engine(self) -> Optional[str]:
        return self._ctx.force_engine

    @property
    def n_chips(self) -> int:
        return self._ctx.n_chips

    @property
    def cache_size(self) -> int:
        return self.service.cache_size

    @property
    def cache_stats(self) -> dict:
        return self.service.cache_stats

    @property
    def local(self) -> LocalEngine:
        return self._ctx.local

    @property
    def distributed(self) -> DistributedEngine:
        return self._ctx.distributed

    # engine memos are service-context state now, but tests and callers
    # probe them to check lazy construction — keep the names working
    @property
    def _local(self) -> Optional[LocalEngine]:
        return self._ctx._local

    @property
    def _dist(self) -> Optional[DistributedEngine]:
        return self._ctx._dist

    @property
    def _result_cache(self) -> OrderedDict:
        return self.service._result_cache

    def plan(self, q: GraphQuery):
        """Cost every (engine, variant) pair and pick one (cached per
        query shape)."""
        return self._ctx.plan(q)

    def query(self, q: GraphQuery) -> QueryResult:
        return self.service.call(self.GRAPH, q)

    def metrics(self) -> dict:
        """The service tier's observability snapshot (queue depths,
        latency histograms, cache hit rate, retry counters) for this
        platform's one-graph service — see
        :meth:`GraphAnalyticsService.metrics`."""
        return self.service.metrics()
