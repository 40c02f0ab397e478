"""What the metric files of ``bench/metrics/`` read from a finished run.

A reader takes the run (``run.RunData``) and returns the metric's value,
or ``None`` where the run holds nothing to read; the harness then leaves
the metric out of the result line.  Times on the host's clock are
``time.perf_counter`` seconds from the window's start.
"""
from __future__ import annotations

import math

import numpy as np


def latencies_s(run) -> list:
    """Due time to the answer complete on the card, for every query due
    in the window; a query that failed or never came counts as infinitely
    late."""
    return [q.done - q.due if not q.failed and not math.isnan(q.done)
            else math.inf for q in run.queries]


def query_p95_ms(run):
    lat = latencies_s(run)
    if not lat:
        return None
    with np.errstate(invalid="ignore"):     # inf - inf among failures
        p = float(np.percentile(np.asarray(lat), 95))
    return p * 1e3 if math.isfinite(p) else None


def query_rate(run):
    done = sum(1 for q in run.queries
               if not q.failed and q.done <= run.window_s)
    return done / run.window_s if run.window_s > 0 else None


def queue_wait_p50_ms(run):
    waits = [q.dequeued - q.due for q in run.queries
             if not math.isnan(q.dequeued)]
    return float(np.median(waits)) * 1e3 if waits else None


def tickets_per_unit(run):
    before, after = run.counters
    units = after["executed"] - before["executed"]
    tickets = after["submitted"] - before["submitted"]
    return tickets / units if units > 0 else None


def _supersteps(run, in_slice: bool = False) -> dict:
    """Supersteps by realized variant, each executed unit counted once
    (a fused group's members share one loop)."""
    out: dict = {}
    for q in run.queries:
        if q.unit_head and (q.in_slice or not in_slice):
            key = q.variant or "none"
            out[key] = out.get(key, 0) + q.iterations
    return out


def dense_share(run):
    steps = _supersteps(run)
    total = sum(steps.values())
    return 100.0 * steps.get("dense", 0) / total if total else None


def device_ms_per_superstep(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    n = sum(_supersteps(run, in_slice=True).values())
    return run.trace.busy_s * 1e3 / n if n else None


def superstep_roofline(run):
    """The least bytes of the slice's answers (``reference.relax``) over
    the bytes the card could move in the slice's device time."""
    bw = run.peaks.get("hbm_bytes_per_s") if run.peaks else None
    if run.trace is None or run.trace.busy_s <= 0 or not bw \
            or not run.slice_bytes:
        return None
    return 100.0 * run.slice_bytes / (run.trace.busy_s * bw)


def device_idle(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
