"""End-to-end query observability: span traces, superstep profiles, and
the planner's estimate-vs-actual feedback loop.

The service makes many invisible decisions per ticket — pool placement,
engine, variant, incremental-vs-full mode, fusion, spill, retries — and
until now exposed only aggregate counters.  This module is the answer to
"where did my query spend its time, and why did the planner put it
there?", the per-query monitoring the paper's companion SQL-serving
system runs its interactive tiers against:

* :class:`Tracer` — a thread-safe recorder producing one **span tree
  per ticket** (submit → admission → plan → queue-wait → attempt[n] →
  execute → resolve).  The plan span carries the *full* candidate table
  the planner considered (every (pool, engine, variant, mode) with its
  cost terms — :class:`repro_torch.core.planner.PlanCandidate`), not just the
  winner; execute spans carry the superstep counters the engine
  collected (iterations, per-round frontier occupancy, message bytes,
  halt step).  Traces live in a ring buffer bounded by ``trace_depth``
  (the ``history_size`` idiom), so a long-lived service never accretes
  unbounded spans.  Tracing observes — it never changes scheduling,
  results, or the determinism digests.
* :class:`PlanAccuracyMeter` — records planner ``est_s`` against the
  measured execution wall per (algorithm, engine, variant, pool), the
  measured-vs-modeled residue the ROADMAP's calibration item needs.
  :meth:`PlanAccuracyMeter.calibration_samples` emits the
  ``{algorithm: [(measured, modeled), ...]}`` shape that
  ``benchmarks/algo_suite.emit_calibration`` fits, so refits can source
  from production traces instead of dedicated sweeps.  (The estimates
  already include the active profile's per-algorithm scale, so a refit
  from these pairs is a *relative* correction on top of it.)
* Surfaces — :func:`render_trace` (the human-readable tree behind
  ``service.explain``), :meth:`Tracer.export_chrome_trace`
  (Chrome/Perfetto trace-event JSON, validated by
  :func:`validate_chrome_trace`), and :func:`render_prometheus`
  (text exposition of the ``metrics()`` dict; :func:`parse_prometheus`
  is the round-trip check).
* A process-wide **observer seam** (:func:`install_observer` /
  :func:`emit`) for layers with no tracer in reach: the registry's
  fault-injection hook and the runtime's transfer ledger emit events
  through it.  With no observers installed, ``emit`` is one falsy check
  — the off path stays free.
* **Regions on the device's timeline** — :meth:`Tracer.region` marks a
  region of the service's work as the profiler range ``gas.<name>``
  (:data:`REGION_PREFIX`) and times it on the tracer's clock, so the
  spans share a ``torch.profiler`` trace's clock and every idle gap of
  the device is put down to the region the host was in.  The service
  marks ``gas.submit`` ⊃ ``gas.plan``, ``gas.admit`` (the submit,
  plan and admission spans, timed where the work happens),
  ``gas.execute`` (one unit, cache lookup to bookkeeping) and
  ``gas.finish`` (result cache and history); the engine marks
  ``gas.init`` (the start state built and put on the device),
  ``gas.loop`` (the superstep loop) and one ``gas.sync`` a host read of
  a device value inside it (:class:`repro_torch.core.pregel.Timeline`).
  The start state's host seconds (``init_wall_s``), the count of host
  syncs (``host_syncs``) and the loop's span on the device, the
  milliseconds between a CUDA event at its entry and one at its exit
  (``loop_span_ms``), ride on the execute span as its ``timeline``
  attribute; a reading the device reports late is taken when the trace
  is next read (:meth:`Tracer.settle`), never inside the loop.
  ``explain`` leaves the timeline out: the profiler's trace is where it
  is read.

This module is deliberately pure stdlib (no torch, no sibling imports),
so every core layer can import it without cycles: the service hands the
tracer its annotation factory (``pregel.profiler_range``, a
``torch.profiler.record_function`` range while a profiler records).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Iterable, Optional

__all__ = [
    "Span", "TicketTrace", "Tracer", "PlanAccuracyMeter",
    "render_trace", "render_prometheus", "parse_prometheus",
    "validate_chrome_trace", "install_observer", "uninstall_observer",
    "emit", "Region", "REGION_PREFIX",
]

# the prefix of the profiler ranges the service and the engine mark
REGION_PREFIX = "gas."


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Span:
    """One timed node of a ticket's trace tree.

    ``t0``/``t1`` are ``time.perf_counter`` seconds (``t1`` is ``None``
    while the span is open).  ``attrs`` hold structured payloads (the
    plan span's candidate table, the execute span's superstep
    counters); ``events`` are instantaneous ``(t, name, attrs)`` marks
    (cache hits, transfers, retries).  A span may be *shared* between
    tickets — a fused group's execute span appears in every member's
    attempt, carrying one per-ticket child span each (``span_id``
    identifies it across trees)."""

    span_id: int
    name: str
    t0: float
    t1: Optional[float] = None
    attrs: dict = dataclasses.field(default_factory=dict)
    children: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)

    @property
    def duration_s(self) -> Optional[float]:
        if self.t1 is None:
            return None
        return self.t1 - self.t0

    def child(self, span_id: int, name: str, t0: float,
              **attrs) -> "Span":
        s = Span(span_id, name, t0, attrs=dict(attrs))
        self.children.append(s)
        return s

    def event(self, t: float, name: str, attrs: Optional[dict] = None) \
            -> None:
        self.events.append((t, name, dict(attrs or {})))

    def find(self, name: str) -> Optional["Span"]:
        """First span named ``name`` in this subtree (depth-first)."""
        for s in self.walk():
            if s.name == name:
                return s
        return None

    def find_all(self, name: str) -> list:
        return [s for s in self.walk() if s.name == name]

    def walk(self) -> Iterable["Span"]:
        yield self
        for c in self.children:
            yield from c.walk()


@dataclasses.dataclass
class TicketTrace:
    """One ticket's span tree plus the identifying header fields."""

    ticket_id: int
    graph_name: str
    algorithm: str
    tier: str
    root: Span

    def find(self, name: str) -> Optional[Span]:
        return self.root.find(name)

    def find_all(self, name: str) -> list:
        return self.root.find_all(name)


class Region:
    """One pass through a traced region: its host interval (``t0``,
    ``t1``) on the tracer's clock; ``t1`` is ``None`` while it runs."""

    __slots__ = ("t0", "t1")

    def __init__(self, t0: float):
        self.t0 = t0
        self.t1: Optional[float] = None


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------

class Tracer:
    """Bounded, thread-safe span recorder for the service runtime.

    ``trace_depth`` caps the number of *retained ticket traces* (ring
    buffer: finishing trace N+1 evicts the oldest, counted in
    ``counters['evicted']``) and the global event stream
    (fault/transfer events arriving through the observer seam).  All
    mutation happens under one lock; the service calls in from its own
    locked sections, and the tracer never calls back out, so the lock
    order is acyclic.

    Timing uses ``time.perf_counter`` — wall-clock content varies run
    to run, but the tree *structure* per ticket is a pure function of
    the schedule, and recording never perturbs the schedule or the
    results (the determinism digests hold bit-identical with tracing
    on).
    """

    def __init__(self, trace_depth: int = 256,
                 clock=time.perf_counter):
        if trace_depth < 1:
            raise ValueError("trace_depth must be >= 1")
        self.trace_depth = int(trace_depth)
        self.clock = clock
        # the profiler's range factory (name -> context manager), set by
        # the service to ``pregel.profiler_range``: :meth:`region` enters
        # one ``gas.<name>`` range a region; None times them on the clock
        self.annotate = None
        self._lock = threading.RLock()
        self._traces: OrderedDict[int, TicketTrace] = OrderedDict()
        self._next_span = 0
        self.counters = {"tickets": 0, "spans": 0, "evicted": 0,
                         "events": 0}
        self.events: deque = deque(maxlen=self.trace_depth * 4)
        # execute spans' timelines holding a reading the device reports
        # late (a callable), oldest first; bounded like the traces
        self._unsettled: deque = deque(maxlen=self.trace_depth)

    # -- internals ----------------------------------------------------------
    def _sid(self) -> int:
        self._next_span += 1
        self.counters["spans"] += 1
        return self._next_span

    def _span(self, name: str, t0: float, **attrs) -> Span:
        return Span(self._sid(), name, t0, attrs=dict(attrs))

    def trace(self, ticket_id: int) -> Optional[TicketTrace]:
        self.settle()
        with self._lock:
            return self._traces.get(ticket_id)

    def traces(self) -> list:
        self.settle()
        with self._lock:
            return list(self._traces.values())

    @contextlib.contextmanager
    def region(self, name: str):
        """Mark a region of the service's work: the profiler range
        ``gas.<name>`` around the block (where :attr:`annotate` is set)
        and the block's host interval on this tracer's clock, the
        yielded :class:`Region`."""
        reg = Region(self.clock())
        mark = (contextlib.nullcontext() if self.annotate is None
                else self.annotate(REGION_PREFIX + name))
        with mark:
            try:
                yield reg
            finally:
                reg.t1 = self.clock()

    def settle(self) -> None:
        """Take the readings the device reports late: each callable in
        an execute span's ``timeline`` (the superstep loop's span on the
        device, between two CUDA events) is called and its value put in
        its place.  Reading waits for the device to pass the
        events, so it happens here, when a trace is read, and never
        while the work runs."""
        with self._lock:
            pending = list(self._unsettled)
            self._unsettled.clear()
        for timeline in pending:
            for key, value in list(timeline.items()):
                if callable(value):
                    timeline[key] = value()

    def counters_snapshot(self) -> dict:
        with self._lock:
            return {"enabled": 1, "depth": self.trace_depth,
                    "retained": len(self._traces), **self.counters}

    # -- lifecycle hooks (called by the service) ----------------------------
    def on_submit(self, ticket, t_submit: float, *,
                  admission: dict, plan_attrs: dict, planned: tuple,
                  candidates: tuple = (),
                  original_placement: Optional[dict] = None) -> None:
        """Open a ticket's trace: root + submit(admission, plan) spans,
        then the queue-wait span.  The submit span runs from
        ``t_submit`` to now (the ticket queued); ``planned`` is the
        ``(start, end)`` of planning, the plan span's interval, and
        admission runs from its end to now.  ``original_placement``
        records the pre-spill plan when the submit path re-placed the
        ticket."""
        now = self.clock()
        t_plan, t_admit = planned
        with self._lock:
            root = self._span("ticket", t_submit,
                              ticket_id=ticket.ticket_id,
                              graph=ticket.graph_name,
                              algorithm=ticket.query.algorithm,
                              tier=ticket.tier, est_s=ticket.est_s)
            submit = root.child(self._sid(), "submit", t_submit)
            submit.t1 = now
            adm = submit.child(self._sid(), "admission", t_admit,
                               **admission)
            adm.t1 = now
            plan = submit.child(self._sid(), "plan", t_plan,
                                **plan_attrs)
            plan.t1 = t_admit
            plan.attrs["candidates"] = [
                dataclasses.asdict(c) if dataclasses.is_dataclass(c)
                else dict(c) for c in candidates]
            if original_placement is not None:
                plan.attrs["spilled"] = True
                plan.attrs["original_placement"] = dict(
                    original_placement)
            root.child(self._sid(), "queue-wait", now)
            tr = TicketTrace(ticket.ticket_id, ticket.graph_name,
                             ticket.query.algorithm, ticket.tier, root)
            self._traces[ticket.ticket_id] = tr
            self.counters["tickets"] += 1
            while len(self._traces) > self.trace_depth:
                self._traces.popitem(last=False)
                self.counters["evicted"] += 1

    def on_dequeue(self, ticket_ids: Iterable[int]) -> None:
        """Close the queue-wait span — the ticket was claimed."""
        now = self.clock()
        with self._lock:
            for tid in ticket_ids:
                tr = self._traces.get(tid)
                if tr is None:
                    continue
                qw = tr.find("queue-wait")
                if qw is not None and qw.t1 is None:
                    qw.t1 = now
                    qw.attrs["wait_s"] = now - qw.t0

    def on_attempt_start(self, ticket_ids: list, attempt: int,
                         fused: bool = False) -> dict:
        """Open attempt spans (one per ticket) around one shared
        execute span.  Solo units share trivially (one ticket); a
        fused group's members all point at the *same* execute Span
        object, which carries one ``ticket[i]`` child per member —
        the 'one execution, K tickets' shape made visible."""
        now = self.clock()
        with self._lock:
            execute = self._span("execute", now, fused=fused)
            if fused:
                execute.attrs["group"] = list(ticket_ids)
                for tid in ticket_ids:
                    execute.child(self._sid(), "ticket", now,
                                  ticket_id=tid)
            attempts = {}
            for tid in ticket_ids:
                tr = self._traces.get(tid)
                if tr is None:
                    continue
                span = tr.root.child(self._sid(), "attempt", now,
                                     attempt=attempt)
                span.children.append(execute)
                attempts[tid] = span
            return {"execute": execute, "attempts": attempts,
                    "attempt": attempt}

    def on_attempt_end(self, handle: dict,
                       error: Optional[BaseException] = None) -> None:
        """Close one attempt.  A failure records the error — and, on
        the final attempt of a dead-lettering ticket, the full
        ``__cause__`` chain rides along (attempt k's error is the
        cause of attempt k+1's)."""
        now = self.clock()
        with self._lock:
            execute = handle["execute"]
            if execute.t1 is None:
                execute.t1 = now
            for child in execute.children:
                if child.t1 is None:
                    child.t1 = now
            for span in handle["attempts"].values():
                span.t1 = now
                if error is not None:
                    span.attrs["error"] = repr(error)
                    span.attrs["error_chain"] = _error_chain(error)

    def on_retry(self, ticket_ids: Iterable[int], attempt: int,
                 sleep_s: float) -> None:
        self.ticket_event(ticket_ids, "retry",
                          {"after_attempt": attempt, "sleep_s": sleep_s})

    def on_execute_result(self, ticket_ids: list, *, engine: str,
                          attrs: dict,
                          per_ticket: Optional[dict] = None) -> None:
        """Annotate the most recent execute span with what actually ran
        (engine, realized variant/mode, iterations, superstep
        counters).  ``per_ticket`` adds attrs onto a fused group's
        per-ticket child spans."""
        with self._lock:
            execute = self._last_execute(ticket_ids)
            if execute is None:
                return
            execute.attrs["engine"] = engine
            execute.attrs.update(attrs)
            timeline = execute.attrs.get("timeline")
            if timeline and any(callable(v) for v in timeline.values()):
                self._unsettled.append(timeline)
            if per_ticket:
                for child in execute.children:
                    tid = child.attrs.get("ticket_id")
                    if tid in per_ticket:
                        child.attrs.update(per_ticket[tid])

    def _last_execute(self, ticket_ids: list) -> Optional[Span]:
        for tid in ticket_ids:
            tr = self._traces.get(tid)
            if tr is None:
                continue
            attempts = tr.find_all("attempt")
            if not attempts:
                continue
            for child in attempts[-1].children:
                if child.name == "execute":
                    return child
        return None

    def on_resolve(self, ticket_ids: Iterable[int], status: str,
                   error: Optional[BaseException] = None) -> None:
        """Close the root: the ticket reached ``done`` /
        ``dead-letter`` (or resolved straight from the cache)."""
        now = self.clock()
        with self._lock:
            for tid in ticket_ids:
                tr = self._traces.get(tid)
                if tr is None:
                    continue
                resolve = tr.root.child(self._sid(), "resolve", now,
                                        status=status)
                resolve.t1 = now
                if error is not None:
                    resolve.attrs["error"] = repr(error)
                tr.root.t1 = now
                tr.root.attrs["status"] = status

    def ticket_event(self, ticket_ids: Iterable[int], name: str,
                     attrs: Optional[dict] = None) -> None:
        """Record an instantaneous event on each ticket's root span
        (cache hits, transfers, spills, retries)."""
        now = self.clock()
        with self._lock:
            for tid in ticket_ids:
                tr = self._traces.get(tid)
                if tr is not None:
                    tr.root.event(now, name, attrs)

    # -- observer seam ------------------------------------------------------
    def record_event(self, kind: str, attrs: dict) -> None:
        """Sink for :func:`emit` — the global (non-ticket-scoped) event
        stream: registry fault injections, ledger transfers."""
        with self._lock:
            self.events.append((self.clock(), kind, dict(attrs)))
            self.counters["events"] += 1

    # -- chrome trace export ------------------------------------------------
    def export_chrome_trace(self, path=None) -> dict:
        """Write (and return) the trace in Chrome/Perfetto trace-event
        JSON: one timeline row (``tid``) per ticket, complete ('X')
        events for spans, instant ('i') events for marks.  A fused
        group's shared execute span is emitted on every member's row
        (same ``args.span_id``) so each ticket's timeline is complete
        on its own."""
        events = []
        for tr in self.traces():
            for s in tr.root.walk():
                t1 = s.t1 if s.t1 is not None else s.t0
                events.append({
                    "name": s.name, "cat": "service", "ph": "X",
                    "ts": s.t0 * 1e6, "dur": max(t1 - s.t0, 0.0) * 1e6,
                    "pid": 1, "tid": tr.ticket_id,
                    "args": _json_safe({"span_id": s.span_id, **s.attrs}),
                })
                for (t, name, attrs) in s.events:
                    events.append({
                        "name": name, "cat": "event", "ph": "i",
                        "ts": t * 1e6, "s": "t",
                        "pid": 1, "tid": tr.ticket_id,
                        "args": _json_safe(attrs),
                    })
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


def _error_chain(error: BaseException) -> list:
    chain, e = [], error
    while e is not None and len(chain) < 32:
        chain.append(f"{type(e).__name__}: {e}")
        e = e.__cause__
    return chain


def _json_safe(value):
    if isinstance(value, dict):
        return {str(k): _json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    if isinstance(value, float) and not math.isfinite(value):
        return repr(value)
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return repr(value)


def validate_chrome_trace(doc) -> int:
    """Validate trace-event JSON structure (a path, a JSON string, or
    the loaded object).  Returns the event count; raises ``ValueError``
    on the first violation — the CI schema gate."""
    if isinstance(doc, str):
        try:
            with open(doc) as f:
                doc = json.load(f)
        except OSError:
            doc = json.loads(doc)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("chrome trace: top level must be an object "
                         "with a 'traceEvents' array")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("chrome trace: 'traceEvents' must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"chrome trace: event {i} is not an object")
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                raise ValueError(
                    f"chrome trace: event {i} missing {field!r}")
        if not isinstance(ev["name"], str):
            raise ValueError(f"chrome trace: event {i} name not a string")
        if ev["ph"] not in ("X", "i", "B", "E", "M"):
            raise ValueError(
                f"chrome trace: event {i} has unknown phase "
                f"{ev['ph']!r}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            raise ValueError(f"chrome trace: event {i} bad ts")
        if ev["ph"] == "X":
            if not isinstance(ev.get("dur"), (int, float)) \
                    or ev["dur"] < 0:
                raise ValueError(
                    f"chrome trace: complete event {i} needs dur >= 0")
    return len(events)


# ---------------------------------------------------------------------------
# explain() rendering
# ---------------------------------------------------------------------------

def _ms(seconds: Optional[float]) -> str:
    if seconds is None:
        return "open"
    return f"{seconds * 1e3:.2f} ms"


def _candidate_lines(plan_span: Span) -> list:
    cands = plan_span.attrs.get("candidates") or []
    if not cands:
        return []
    chosen = [c for c in cands if c.get("chosen")]
    chosen_est = chosen[0]["est_s"] if chosen else None
    lines = ["candidates (pool/engine/variant/mode):"]

    def order(c):
        est = c.get("est_s")
        return (not c.get("chosen"), not c.get("feasible", True),
                est if isinstance(est, (int, float))
                and math.isfinite(est) else float("inf"))

    for c in sorted(cands, key=order):
        where = "/".join(str(c.get(k)) if c.get(k) is not None else "-"
                         for k in ("pool", "engine", "variant", "mode"))
        est = c.get("est_s")
        est_txt = (f"{est * 1e3:9.3f} ms"
                   if isinstance(est, (int, float)) and math.isfinite(est)
                   else "      inf   ")
        if c.get("chosen"):
            why = "<- chosen"
        elif not c.get("feasible", True):
            why = f"infeasible: {c.get('note') or 'cost is infinite'}"
        elif chosen_est is not None and isinstance(est, (int, float)):
            why = f"+{(est - chosen_est) * 1e3:.3f} ms vs chosen"
        else:
            why = c.get("note") or ""
        lines.append(f"  {where:<42} {est_txt}  {why}")
    return lines


def _span_lines(span: Span, depth: int) -> list:
    pad = "  " * depth
    head = f"{pad}{span.name} [{_ms(span.duration_s)}]"
    # the timeline is the profiler's to show (Tracer.region)
    skip = {"candidates", "error_chain", "group", "span_id", "timeline"}
    attrs = {k: v for k, v in span.attrs.items() if k not in skip}
    if attrs:
        head += "  " + " ".join(
            f"{k}={_fmt_attr(v)}" for k, v in sorted(attrs.items()))
    lines = [head]
    if span.name == "plan":
        lines += [f"{pad}  {ln}" for ln in _candidate_lines(span)]
    if "error_chain" in span.attrs:
        for i, entry in enumerate(span.attrs["error_chain"]):
            lines.append(f"{pad}  cause[{i}]: {entry}")
    for (_, name, attrs_) in span.events:
        detail = " ".join(f"{k}={_fmt_attr(v)}"
                          for k, v in sorted(attrs_.items()))
        lines.append(f"{pad}  * {name}" + (f" {detail}" if detail else ""))
    for child in span.children:
        lines += _span_lines(child, depth + 1)
    return lines


def _fmt_attr(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    if isinstance(v, (list, tuple)) and len(v) > 16:
        return f"[{len(v)} entries]"
    return str(v)


def render_trace(trace: TicketTrace) -> str:
    """The human-readable span tree behind ``service.explain`` — spans
    with durations, the plan span's losing candidates and why they
    lost, superstep counters, events, and error chains."""
    header = (f"ticket #{trace.ticket_id} "
              f"{trace.algorithm!r} on {trace.graph_name!r} "
              f"tier={trace.tier} "
              f"status={trace.root.attrs.get('status', 'pending')}")
    return "\n".join([header] + _span_lines(trace.root, 0))


# ---------------------------------------------------------------------------
# Plan accuracy meter — estimate vs measured wall
# ---------------------------------------------------------------------------

class PlanAccuracyMeter:
    """Thread-safe planner-feedback recorder.

    One sample per resolved execution: the plan's estimate next to the
    measured wall, keyed by (algorithm, engine, variant, pool).  Fused
    groups record one sample (the shared execution's wall against the
    head ticket's estimate, with the group width noted); cache hits
    record nothing — no execution happened.  Per-key sample windows are
    bounded (``max_samples``), so a long-lived service keeps a rolling
    view.
    """

    def __init__(self, max_samples: int = 512):
        self.max_samples = int(max_samples)
        self._samples: dict[tuple, deque] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(algorithm: str, engine: str, variant, pool) -> tuple:
        return (str(algorithm), str(engine),
                variant if variant is None else str(variant),
                pool if pool is None else str(pool))

    def record(self, algorithm: str, engine: str, variant, pool,
               est_s: float, wall_s: float, mode: str = "full",
               width: int = 1) -> None:
        key = self._key(algorithm, engine, variant, pool)
        with self._lock:
            dq = self._samples.get(key)
            if dq is None:
                dq = self._samples[key] = deque(maxlen=self.max_samples)
            dq.append((float(est_s), float(wall_s), str(mode),
                       int(width)))

    def snapshot(self) -> dict:
        """The ``metrics()['accuracy']`` block: total samples, the
        overall mean absolute relative error of the estimates, and a
        per-key row with mean estimate, mean wall, and the mean
        wall/est ratio (the multiplier a refit would fold in)."""
        with self._lock:
            by_key, errs, n_total = {}, [], 0
            for key, dq in sorted(self._samples.items(),
                                  key=lambda kv: kv[0]):
                ests = [s[0] for s in dq]
                walls = [s[1] for s in dq]
                n = len(dq)
                n_total += n
                ratios = [w / e for e, w in zip(ests, walls) if e > 0]
                errs += [abs(w - e) / e
                         for e, w in zip(ests, walls) if e > 0]
                algorithm, engine, variant, pool = key
                name = "|".join((algorithm, engine, variant or "-",
                                 pool or "-"))
                by_key[name] = {
                    "n": n,
                    "est_s_mean": sum(ests) / n,
                    "wall_s_mean": sum(walls) / n,
                    "wall_over_est": (sum(ratios) / len(ratios)
                                      if ratios else None),
                }
            return {
                "samples": n_total,
                "mean_abs_rel_err": (sum(errs) / len(errs)
                                     if errs else None),
                "by_key": by_key,
            }

    def calibration_samples(self) -> dict:
        """``{algorithm: [(measured_wall_s, estimated_s), ...]}`` — the
        exact pair shape ``benchmarks.algo_suite.emit_calibration``
        fits per-algorithm scales from, sourced from production traces
        instead of a dedicated sweep."""
        with self._lock:
            out: dict[str, list] = {}
            for (algorithm, _, _, _), dq in self._samples.items():
                out.setdefault(algorithm, []).extend(
                    (wall, est) for est, wall, _, _ in dq if est > 0)
            return out


# ---------------------------------------------------------------------------
# Prometheus-style text exposition
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(prefix: str, path: tuple) -> str:
    parts = [_NAME_RE.sub("_", str(p)) for p in (prefix,) + path]
    name = "_".join(p for p in parts if p)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _flatten(value, path: tuple, out: list) -> None:
    if isinstance(value, dict):
        for k, v in value.items():
            _flatten(v, path + (k,), out)
        return
    if isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            _flatten(v, path + (str(i),), out)
        return
    out.append((path, value))


def render_prometheus(metrics: dict, prefix: str = "gas") -> str:
    """Flatten a (possibly nested) metrics dict into Prometheus text
    exposition.  Every scalar leaf becomes one sample named by its
    sanitized path — booleans as 1/0, ``None`` as ``NaN`` (Prometheus
    has no null; :func:`parse_prometheus` maps it back).  The output
    round-trips every leaf of ``GraphAnalyticsService.metrics()``."""
    leaves: list = []
    _flatten(metrics, (), leaves)
    lines = []
    for path, value in leaves:
        name = _metric_name(prefix, path)
        if value is None:
            txt = "NaN"
        elif isinstance(value, bool):
            txt = "1" if value else "0"
        elif isinstance(value, (int, float)):
            txt = repr(float(value)) if isinstance(value, float) \
                else str(value)
        else:
            lines.append(f"# {name} {value!r}")
            continue
        lines.append(f"{name} {txt}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict:
    """Parse :func:`render_prometheus` output back into
    ``{name: float}`` (``NaN`` values included — compare with
    ``math.isnan``).  The round-trip half of the exposition tests."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        out[name] = float(value)
    return out


# ---------------------------------------------------------------------------
# Observer seam — events from layers with no tracer in reach
# ---------------------------------------------------------------------------

_OBSERVERS: "weakref.WeakSet" = weakref.WeakSet()


def install_observer(observer) -> None:
    """Register an object with ``record_event(kind, attrs)`` (a
    :class:`Tracer`) for process-wide events.  Held weakly: a dropped
    tracer unregisters itself."""
    _OBSERVERS.add(observer)


def uninstall_observer(observer) -> None:
    _OBSERVERS.discard(observer)


def emit(kind: str, **attrs) -> None:
    """Broadcast one event to every installed observer.  The hot-path
    contract: with no observers this is a single falsy check, so the
    registry's fault hook and the ledger's transfer recorder cost
    nothing when tracing is off."""
    if not _OBSERVERS:
        return
    for obs in list(_OBSERVERS):
        try:
            obs.record_event(kind, attrs)
        except Exception:
            pass
