"""The traffic generator and the loops that drive the service.

A traffic mix is a JSON file of parameters (``bench/traffic/<mix>.json``)
that :func:`build` reads; its ``kind`` picks one of two loops:

* ``open``: queries arrive at a fixed rate (``rate_per_s``) whatever the
  service does.  The gaps between arrivals are the quantiles of the
  exponential distribution at that rate, so a window holds a fixed number
  of arrivals, and the queries of each algorithm are in the proportions
  of ``mix``.  The order of the gaps and of the algorithms is a schedule
  drawn once from the file's ``pattern_seed``, the same for every run:
  the tail of a queue at four fifths of its capacity swings by a third
  from one arrival order to the next over a window of tens of seconds,
  which no bound could hold.  The graph and the roots come from the
  generator and the run's seed (below).  A query is submitted once it is
  due and the loop is free; the oldest submitted ticket's result is
  taken next (an interactive ticket then runs alone, so each completion
  is seen).  Latency runs from the due time to the answer complete on
  the card.  Arrivals stop when the window closes, and the loop finishes
  what is due.
* ``waves``: a closed loop.  Each wave asks every algorithm of
  ``algorithms`` for each of ``accounts_per_wave`` accounts, is submitted
  whole and drained; the next follows at once while the window is open.
  ``warmup_waves`` waves run before the window: enough to fill the
  service's result history, so the window sees the steady state in which
  each answer takes the place of the oldest (while it filled, a ticket
  took a third more time on an H100).

Roots are drawn without repeats among the vertices of degree >= 1, so no
``(algorithm, root)`` pair repeats inside a run and the result cache
serves nothing; the generator may fix the order they are drawn in
(``EdgeList.order``).  The warm-up (of the open loop: one query of each
algorithm) draws its roots outside the run's sequence.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from bench.gen import EdgeList, generator, stream_seed


@dataclasses.dataclass
class Query:
    index: int
    algorithm: str
    root: int
    max_iters: Optional[int]
    due: float = 0.0              # seconds after the window opens (open)
    wave: int = -1                # wave number (waves)
    ticket: object = None
    submitted: float = math.nan
    done: float = math.nan
    failed: bool = False
    value: object = None          # the answer (``hold``) while needed
    iterations: int = 0           # supersteps of the unit that served it
    variant: Optional[str] = None  # superstep variant the engine realized
    unit: int = -1                # executed unit (a fused group is one)
    unit_head: bool = False       # first ticket of its unit
    in_slice: bool = False        # ran while the profiler recorded
    dequeued: float = math.nan    # from the service's spans (traced run)


@dataclasses.dataclass
class Plan:
    kind: str
    queries: list                 # open: every query; waves: built lazily
    warmup: list                  # waves of queries run before the window
    traffic: dict
    roots: np.ndarray             # waves: the accounts in order

    def wave(self, w: int) -> list:
        """The queries of wave ``w`` (waves only)."""
        t = self.traffic
        per = int(t["accounts_per_wave"])
        accounts = self.roots[w * per:(w + 1) * per]
        if len(accounts) < per:
            raise RuntimeError("the traffic ran out of distinct roots")
        algos = list(t["algorithms"])
        return [Query(w * per * len(algos) + k, a, int(r), t["max_iters"],
                      wave=w)
                for k, (r, a) in enumerate((r, a) for r in accounts
                                           for a in algos)]


def distinct_roots(edges: EdgeList, count: Optional[int], seed: int,
                   device) -> np.ndarray:
    """``count`` distinct vertices of degree >= 1 (all of them where
    ``count`` is None), in the generator's order or else in an order drawn
    from the seed (on the device, one permutation)."""
    order = edges.order
    if order is None:
        g = generator(seed, "roots", device)
        order = torch.randperm(edges.n_vertices, generator=g, device=device)
    cand = order[edges.degrees()[order] > 0]
    count = cand.numel() if count is None else count
    if cand.numel() < count:
        raise ValueError(f"the graph has {cand.numel()} vertices of degree "
                         f">= 1; the traffic needs {count}")
    return cand[:count].cpu().numpy()


def build(traffic: dict, edges: EdgeList, seed: int, seconds: float,
          device) -> Plan:
    kind = traffic["kind"]
    mi = traffic.get("max_iters")
    if kind == "open":
        rate = float(traffic["rate_per_s"])
        n = max(1, int(round(rate * seconds)))
        gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
        rng = np.random.default_rng(
            stream_seed(int(traffic["pattern_seed"]), "pattern"))
        due = np.cumsum(rng.permutation(gaps))
        n = max(1, int((due < seconds).sum()))
        mix = traffic["mix"]
        names = sorted(mix)
        total = sum(float(mix[a]) for a in names)
        counts = [int(n * float(mix[a]) / total) for a in names]
        counts[0] += n - sum(counts)
        algos = rng.permutation(np.repeat(names, counts))
        roots = distinct_roots(edges, n + len(names), seed, device)
        queries = [Query(i, str(algos[i]), int(roots[i]), mi,
                         due=float(due[i]))
                   for i in range(n)]
        warm = [Query(-1 - k, a, int(roots[n + k]), mi)
                for k, a in enumerate(names)]
        return Plan(kind, queries, [warm], traffic, roots[:n])
    if kind == "waves":
        algos = list(traffic["algorithms"])
        roots = distinct_roots(edges, None, seed, device)
        per = int(traffic["accounts_per_wave"])
        spare = roots[len(roots) - per * int(traffic["warmup_waves"]):]
        warm = [[Query(-1 - k, a, int(r), mi)
                 for k, (r, a) in enumerate((r, a) for r in wave
                                            for a in algos)]
                for wave in np.split(spare, len(spare) // per)]
        return Plan(kind, [], warm, traffic, roots[:len(roots) - len(spare)])
    raise ValueError(f"unknown traffic kind {kind!r}")


# ------------------------------------------------------------------ driving

def graph_query(q: Query):
    from repro_torch.core.query import GraphQuery
    if q.algorithm == "bfs":
        return GraphQuery.bfs([q.root], max_iters=q.max_iters)
    if q.algorithm == "sssp":
        return GraphQuery.sssp(q.root, max_iters=q.max_iters)
    raise ValueError(f"the benchmark has no reference for {q.algorithm!r}")


def resolved(ticket) -> bool:
    return ticket.status in ("done", "dead-letter")


def hold(value: torch.Tensor):
    """An answer held for the comparison, in the smaller of two forms: the
    tensor itself, or its length with the positions (int32) and values of
    its entries other than +inf (a NaN is kept).  A 4-hop answer reaches a
    few of 4e6 vertices; a converged one most of them."""
    v = value.flatten()
    idx = torch.nonzero(v != float("inf")).flatten()
    if 2 * idx.numel() >= v.numel():
        return v
    return v.numel(), idx.to(torch.int32), v[idx]


def unhold(held) -> torch.Tensor:
    """The answer again from what :func:`hold` kept."""
    if isinstance(held, torch.Tensor):
        return held
    n, idx, vals = held
    out = torch.full((n,), float("inf"), dtype=vals.dtype,
                     device=vals.device)
    out[idx.long()] = vals
    return out


class NoSlice:
    """Stand-in for ``trace.Slice`` in an untraced run."""

    active = False

    def boundary(self, now: float) -> None:
        pass

    def mark(self, name: str):
        return contextlib.nullcontext()

    def close(self) -> None:
        pass


class Driver:
    """Submits queries to one graph of a service and takes their results.

    ``sync`` waits for the device (``torch.cuda.synchronize``), so a
    completion time is that of the answer on the card."""

    def __init__(self, svc, graph: str, sync: Callable[[], None],
                 clock: Callable[[], float] = time.perf_counter):
        self.svc = svc
        self.graph = graph
        self.sync = sync
        self.clock = clock
        self.start = 0.0
        self.units = 0
        self.by_ticket: dict = {}
        self.wave_ends: list = []

    def now(self) -> float:
        return self.clock() - self.start

    def submit(self, q: Query) -> bool:
        from repro_torch.core.service import AdmissionRejected, Backpressure
        q.submitted = self.now()
        try:
            q.ticket = self.svc.submit(self.graph, graph_query(q))
        except (AdmissionRejected, Backpressure):
            q.failed = True
            return False
        self.by_ticket[q.ticket.ticket_id] = q
        return True

    def collect(self, q: Query, in_slice: bool,
                done: Optional[float] = None) -> None:
        """Take a ticket's answer (running it if it is still queued), wait
        for the card, and record the answer and its unit.  ``done`` is
        the completion time where the caller already waited."""
        try:
            r = self.svc.result(q.ticket)
        except Exception:            # dead-lettered: the answer never came
            r = None
        if done is None:
            self.sync()
            done = self.now()
        q.done = done
        q.in_slice = in_slice
        if r is None:
            q.failed = True
            return
        fused = r.meta.get("fused")
        q.unit_head = fused is None or fused.get("index", 0) == 0
        if q.unit_head:
            self.units += 1
        q.unit = self.units
        q.iterations = int(r.iterations or 0)
        q.variant = r.meta.get("realized_variant")
        q.value = hold(r.value)

    def warm_up(self, waves: list) -> None:
        for wave in waves:
            for q in wave:
                if not self.submit(q):
                    raise RuntimeError(f"the warm-up query {q} was refused")
            self.svc.drain()
        self.sync()
        self.by_ticket.clear()

    def run_open(self, plan: Plan, seconds: float, slice_) -> float:
        qs = plan.queries
        queue: collections.deque = collections.deque()
        i = 0
        self.start = self.clock()
        while i < len(qs) or queue:
            now = self.now()
            while i < len(qs) and qs[i].due <= now:
                with slice_.mark("bench.submit"):
                    if self.submit(qs[i]):
                        queue.append(qs[i])
                i += 1
            slice_.boundary(now)
            if not queue:
                with slice_.mark("bench.wait_for_arrival"):
                    time.sleep(max(0.0, qs[i].due - self.now()))
                continue
            q = queue.popleft()
            with slice_.mark("bench.result"):
                self.collect(q, slice_.active)
            # a batch-tier ticket drains the service: collect what it ran
            for other in [o for o in queue
                          if o.ticket.status != "queued"]:
                queue.remove(other)
                self.collect(other, slice_.active, q.done)
        self.svc.drain()
        return seconds

    def run_waves(self, plan: Plan, seconds: float, slice_) -> float:
        w = 0
        self.start = self.clock()
        while self.now() < seconds:
            slice_.boundary(self.now())
            qs = plan.wave(w)
            plan.queries.extend(qs)
            with slice_.mark("bench.submit"):
                for q in qs:
                    self.submit(q)
            with slice_.mark("bench.drain"):
                finished = self.svc.drain()
                self.sync()
            done = self.now()
            self.wave_ends.append(done)
            for t in finished:
                q = self.by_ticket.get(t.ticket_id)
                if q is not None and resolved(t):
                    self.collect(q, slice_.active, done)
            for q in qs:                # drained but never resolved
                if q.ticket is not None and not resolved(q.ticket):
                    q.failed = True
            w += 1
        return self.now()

    def read_spans(self) -> None:
        """Dequeue times from the service's own tracer (traced runs)."""
        tracer = self.svc.tracer
        if tracer is None:
            return
        for tid, q in self.by_ticket.items():
            tr = tracer.trace(tid)
            span = tr.find("queue-wait") if tr is not None else None
            if span is not None and span.t1 is not None:
                q.dequeued = span.t1 - self.start
