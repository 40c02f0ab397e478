"""Service-runtime primitives: backpressure, retry schedules, latency
histograms.

The paper's platform fields interactive and batch analytics *side by
side* — a 10-minute batch table job must not freeze the "<2 s count"
traffic.  ``GraphAnalyticsService`` gets there with a small concurrent
runtime (``service.py``); this module holds the runtime's pure, testable
pieces:

* :class:`Backpressure` — the typed ``submit``-time rejection raised
  when a tier's queue is at its depth budget.  Like
  ``AdmissionRejected`` it carries enough context (tier, depth, budget)
  for the caller to decide between shedding and waiting.
* :class:`RetryPolicy` — jittered-exponential-backoff schedule for
  failed executions, fully deterministic given a seed: the k-th retry
  sleeps somewhere in ``[base_s, min(cap_s, base_s * multiplier**k)]``,
  so the *bounds* are monotone non-decreasing and every sleep lies in
  ``[base_s, cap_s]`` (the properties the hypothesis suite pins).
  ``max_attempts`` counts executions, not retries: a ticket is tried at
  most ``max_attempts`` times and the schedule therefore has
  ``max_attempts - 1`` entries.
* :class:`LatencyHistogram` — per-tier submit-to-resolution latency:
  log-spaced bucket counts for the ``metrics()`` snapshot plus a
  bounded raw-sample window for exact small-N percentiles (the
  benchmark's p50/p99 and the "interactive beats batch" assertion).
* :class:`PoolGate` — the per-pool in-flight cap of the federation
  runtime: workers claiming a unit bound for pool P must acquire P's
  slot first, so a pool with ``max_inflight=1`` never runs two units
  at once even when several contexts could.
* :class:`TransferLedger` — per-pool transfer accounting: every
  non-resident execution records the snapshot bytes it had to move,
  the number behind ``metrics()['pools'][*]['transfer_bytes']``.
"""
from __future__ import annotations

import bisect
import dataclasses
import random
import threading
from collections import deque
from typing import Any, Mapping, Optional

from repro_torch.core import obs


class Backpressure(Exception):
    """Raised by ``submit`` when the destination queue is at its tier's
    depth budget.  The query was *not* admitted; nothing is queued.
    Carries the tier and the depths so callers can tell load shedding
    ("batch is full, come back later") from a misconfigured budget."""

    def __init__(self, graph_name: str, query: Any, engine: str, tier: str,
                 depth: int, budget: int):
        self.graph_name = graph_name
        self.query = query
        self.engine = engine
        self.tier = tier
        self.depth = depth
        self.budget = budget
        super().__init__(
            f"query {query.algorithm!r} on {graph_name!r} rejected: "
            f"{tier} queue for engine {engine!r} is at its depth budget "
            f"({depth}/{budget})")


# ---------------------------------------------------------------------------
# Retry / backoff
# ---------------------------------------------------------------------------

#: Exception types that retrying can never fix: schema violations and
#: lookup errors are properties of the query, not of the attempt.
PERMANENT_ERRORS = (ValueError, TypeError, KeyError)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff with a dead-letter bound.

    ``max_attempts`` is the total number of *executions* a ticket may
    consume (first try included); after the last one fails the ticket
    dead-letters.  The sleep before retry ``k`` (0-indexed) is drawn
    uniformly from ``[base_s, bound_k]`` with
    ``bound_k = min(cap_s, base_s * multiplier**k)`` — full jitter above
    a floor, so concurrent retries decorrelate while the schedule's
    upper envelope stays monotone and capped.
    """

    max_attempts: int = 3
    base_s: float = 0.002
    cap_s: float = 0.25
    multiplier: float = 2.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0 <= self.base_s <= self.cap_s:
            raise ValueError("need 0 <= base_s <= cap_s")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")

    def bounds(self) -> tuple[float, ...]:
        """Upper bound of each retry's sleep — monotone non-decreasing,
        clipped at ``cap_s``; one entry per retry (``max_attempts - 1``)."""
        return tuple(min(self.cap_s, self.base_s * self.multiplier ** k)
                     for k in range(self.max_attempts - 1))

    def schedule(self, seed: int) -> tuple[float, ...]:
        """The actual jittered sleeps for one ticket, deterministic in
        ``seed`` (the service derives it from its own seed and the
        ticket id, so a replayed drain sleeps identically)."""
        rng = random.Random(int(seed))
        return tuple(self.base_s + rng.random() * (b - self.base_s)
                     for b in self.bounds())

    @staticmethod
    def retryable(error: BaseException) -> bool:
        """Whether another attempt could plausibly succeed.  Schema and
        lookup errors (:data:`PERMANENT_ERRORS`) are deterministic
        functions of the query — they dead-letter immediately instead
        of burning ``max_attempts`` identical failures."""
        return not isinstance(error, PERMANENT_ERRORS)


# ---------------------------------------------------------------------------
# Latency histograms
# ---------------------------------------------------------------------------

def _log_bounds() -> tuple[float, ...]:
    # 10 us .. 100 s, half-decade steps — wide enough for both a cache
    # hit and a 10-minute batch job's neighbours.
    return tuple(10.0 ** (k / 2.0) for k in range(-10, 5))


class LatencyHistogram:
    """Latency recorder behind ``metrics()``: log-spaced bucket counts
    (cheap, unbounded history) plus a bounded window of raw samples for
    exact percentiles.  Not thread-safe on its own — the service
    observes under its runtime lock."""

    def __init__(self, max_samples: int = 4096):
        self.bounds = _log_bounds()
        self.counts = [0] * (len(self.bounds) + 1)   # last = overflow
        self.count = 0
        self.total_s = 0.0
        self._samples: deque = deque(maxlen=max_samples)

    def observe(self, seconds: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, seconds)] += 1
        self.count += 1
        self.total_s += seconds
        self._samples.append(seconds)

    def percentile(self, p: float) -> Optional[float]:
        """Exact percentile over the retained sample window (the whole
        history while fewer than ``max_samples`` observations)."""
        if not self._samples:
            return None
        xs = sorted(self._samples)
        rank = min(len(xs) - 1, max(0, int(round(p / 100.0 * (len(xs) - 1)))))
        return xs[rank]

    def snapshot(self) -> dict:
        """The ``metrics()`` view: totals, p50/p99 over the retained
        window, and cumulative ``le``-style bucket counts.

        The quantiles are **exact only while every observation is still
        retained** (``count <= max_samples``); under longer drains the
        raw window is a bounded deque, the oldest samples age out, and
        p50/p99 silently become *window-local* quantiles over the most
        recent ``window_size`` observations.  ``window_exact`` makes
        that visible: ``True`` means whole-history quantiles,
        ``False`` means rolling-window.  The bucket counts are always
        whole-history (they never age out) — percentiles needing exact
        long-horizon answers should derive from ``buckets``."""
        cum, acc = {}, 0
        for b, c in zip(self.bounds, self.counts):
            acc += c
            cum[f"le_{b:.0e}"] = acc
        cum["le_inf"] = self.count
        return {
            "count": self.count,
            "mean_s": (self.total_s / self.count) if self.count else None,
            "p50_s": self.percentile(50),
            "p99_s": self.percentile(99),
            "window_exact": self.count <= self._samples.maxlen,
            "window_size": len(self._samples),
            "buckets": cum,
        }


# ---------------------------------------------------------------------------
# Federation runtime primitives
# ---------------------------------------------------------------------------

class PoolGate:
    """Per-pool in-flight caps for the worker pool.

    ``caps`` maps pool name to its ``max_inflight`` (``None`` or a
    missing name = unbounded — unknown pools, and the poolset-free
    legacy path, always pass).  ``try_acquire`` is non-blocking: a
    worker that cannot enter a pool parks the queue and scans on, the
    same protocol as a busy (context, engine) pair.
    """

    def __init__(self, caps: Optional[Mapping[str, Optional[int]]] = None):
        self._caps = dict(caps or {})
        self._inflight: dict[str, int] = {}
        self._lock = threading.Lock()

    def try_acquire(self, pool: Optional[str]) -> bool:
        if pool is None:
            return True
        with self._lock:
            cap = self._caps.get(pool)
            n = self._inflight.get(pool, 0)
            if cap is not None and n >= cap:
                return False
            self._inflight[pool] = n + 1
            return True

    def release(self, pool: Optional[str]) -> None:
        if pool is None:
            return
        with self._lock:
            n = self._inflight.get(pool, 0)
            if n <= 0:
                raise RuntimeError(f"release of idle pool {pool!r}")
            self._inflight[pool] = n - 1

    def inflight(self, pool: str) -> int:
        with self._lock:
            return self._inflight.get(pool, 0)


class TransferLedger:
    """Thread-safe per-pool transfer accounting: how many snapshot
    bytes each pool pulled across the link to serve non-resident work
    (and how many distinct transfers)."""

    def __init__(self):
        self._bytes: dict[str, int] = {}
        self._count: dict[str, int] = {}
        self._lock = threading.Lock()

    def record(self, pool: str, n_bytes: int) -> None:
        with self._lock:
            self._bytes[pool] = self._bytes.get(pool, 0) + int(n_bytes)
            self._count[pool] = self._count.get(pool, 0) + 1
        obs.emit("transfer", pool=pool, bytes=int(n_bytes))

    def bytes_for(self, pool: str) -> int:
        with self._lock:
            return self._bytes.get(pool, 0)

    def transfers_for(self, pool: str) -> int:
        with self._lock:
            return self._count.get(pool, 0)

    def snapshot(self) -> dict:
        with self._lock:
            return {p: {"transfer_bytes": self._bytes.get(p, 0),
                        "transfers": self._count.get(p, 0)}
                    for p in sorted(set(self._bytes) | set(self._count))}


class IncrementalMeter:
    """Thread-safe counters for the incremental/warm-start execution
    paths: how often the catalog's lineage actually paid off.

    ``warm_hits`` counts executions seeded from an ancestor's converged
    vector; ``incremental_runs`` counts localized repairs seeded from
    the direct parent's result plus the recorded delta;
    ``iterations_saved`` accumulates the per-run iteration reduction
    (the seed's converged iteration count minus the seeded run's — the
    ancestor's cold cost standing in for this snapshot's, since the
    whole point is never paying the cold run); ``delta_bytes_applied``
    accumulates the delta payloads consumed by incremental repairs.
    """

    def __init__(self):
        self._warm = 0
        self._incremental = 0
        self._iters_saved = 0
        self._delta_bytes = 0
        self._lock = threading.Lock()

    def record(self, mode: str, iterations_saved: int = 0,
               delta_bytes: int = 0) -> None:
        with self._lock:
            if mode == "warm":
                self._warm += 1
            elif mode == "incremental":
                self._incremental += 1
            self._iters_saved += max(int(iterations_saved), 0)
            self._delta_bytes += max(int(delta_bytes), 0)

    def snapshot(self) -> dict:
        with self._lock:
            return {"warm_hits": self._warm,
                    "incremental_runs": self._incremental,
                    "iterations_saved": self._iters_saved,
                    "delta_bytes_applied": self._delta_bytes}
