"""What the per-layer metrics of the program's own spans read from a finished
run: each ticket's span tree, which the ticket hands out while the service's
tracer keeps it (``QueryTicket.trace()``; a traced run keeps every ticket's).

* the ``plan`` span: planning a ticket (seed lookup and ``ctx.plan``), host
  seconds;
* the execute span's ``timeline``: the start state's host seconds
  (``init_wall_s``), the superstep loop's host syncs (``host_syncs``) and its
  span on the device, the milliseconds between a CUDA event at the loop's
  entry and one at its exit (``loop_span_ms``; launch gaps and syncs inside).

A reader returns ``None`` where the run holds nothing to read: an untraced
run, a program whose tickets hand out no trace, a run off the card for the
loop's span.  Every unit is counted once, through its first ticket.
"""
from __future__ import annotations

import numpy as np


def ticket_trace(q):
    """The query's ticket's span tree, or None."""
    trace = getattr(q.ticket, "trace", None) if q.ticket is not None \
        else None
    return trace() if callable(trace) else None


def plan_ms(run) -> list:
    """Each window ticket's plan span, in milliseconds."""
    out = []
    for q in run.queries:
        tr = ticket_trace(q)
        span = tr.find("plan") if tr is not None else None
        if span is not None and span.t1 is not None:
            out.append((span.t1 - span.t0) * 1e3)
    return out


def unit_timelines(run) -> list:
    """``(supersteps, timeline)`` of each unit the window executed: the
    timeline of its last attempt's execute span."""
    out = []
    for q in run.queries:
        if not q.unit_head:
            continue
        tr = ticket_trace(q)
        execs = tr.find_all("execute") if tr is not None else []
        timeline = execs[-1].attrs.get("timeline") if execs else None
        if timeline:
            out.append((q.iterations, timeline))
    return out


def median(xs: list):
    return float(np.median(xs)) if xs else None


def plan_ms_p50(run):
    return median(plan_ms(run))


def init_ms_p50(run):
    return median([tl["init_wall_s"] * 1e3 for _, tl in unit_timelines(run)
                   if "init_wall_s" in tl])


def per_superstep(run, key: str):
    """A timeline count or time summed over the units that hold it, over
    those units' supersteps."""
    total = steps = 0
    for n, tl in unit_timelines(run):
        if key in tl:
            total += tl[key]
            steps += n
    return total / steps if steps else None


def syncs_per_superstep(run):
    return per_superstep(run, "host_syncs")


def loop_span_ms_per_superstep(run):
    return per_superstep(run, "loop_span_ms")
