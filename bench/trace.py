"""The traced slice of a ``--trace 1`` run and its reduction.

``torch.profiler`` records one slice of the window: it starts at the
first unit boundary after ``start_s`` and stops at the first after
``start_s + length_s``, so every unit of work lies wholly inside or
wholly outside it (the loops wait for the card between units).  The
slice is bracketed by a ``bench.slice`` annotation, whose length is
``window_s``.  :func:`reduce` reads the exported Chrome trace:

* ``busy_s``: the union of the device's kernel, copy and set intervals
  inside the slice;
* ``device_ops``: device time by launching host operator and kernel
  name, most first;
* ``idle_gaps``: the slice's device-idle time, each gap named by the
  innermost host operation (a PyTorch operator, a CUDA runtime call or
  one of the loops' ``bench.*`` annotations) at its midpoint, summed by
  name, most first.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time
from typing import Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SLICE = "bench.slice"
TOP = 10


@dataclasses.dataclass
class Summary:
    busy_s: float
    window_s: float
    device_ops: list
    idle_gaps: list


def union_length(intervals: list) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals: list, lo: float, hi: float) -> list:
    """The sub-intervals of ``[lo, hi]`` that no interval covers."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def innermost(points: list, spans: list) -> dict:
    """For each ``(t, key)`` of ``points``, the name of the innermost of
    the nested ``(start, end, name)`` host ``spans`` that holds ``t``
    (the one that started last), or None."""
    spans = sorted(spans)
    out, active, j = {}, [], 0
    for t, key in sorted(points):
        while j < len(spans) and spans[j][0] <= t:
            active.append(spans[j])
            j += 1
        active = [h for h in active if h[1] >= t]
        out[key] = max(active, key=lambda h: (h[0], h[0] - h[1]))[2] \
            if active else None
    return out


def reduce(events: list) -> Optional[Summary]:
    """Reduce Chrome trace events (``ts``/``dur`` in microseconds) to the
    slice's device time.  ``None`` where the trace holds no slice.  A
    device operation is named by the host operator that launched it (its
    CUDA runtime call's correlation id) and its kernel's name."""
    marks = [e for e in events if e.get("name") == SLICE
             and e.get("cat") == "user_annotation" and "dur" in e]
    if not marks:
        return None
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    dev, host, ops, launches = [], [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat")
        name = str(e.get("name", "?"))
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                dev.append((a, b, name, corr))
        elif cat in HOST_CATS and name != SLICE:
            host.append((a, b, name))
            if cat in ("cpu_op", "user_annotation"):
                ops.append((a, b, name))
            elif corr is not None:
                launches.append((a, corr))
    launcher = innermost(launches, ops)
    by_name: dict = {}
    for a, b, name, corr in dev:
        op = launcher.get(corr) or "?"
        key = f"{op} | {name}"[:160]
        by_name[key] = by_name.get(key, 0.0) + (b - a)
    holes = gaps([(a, b) for a, b, _, _ in dev], lo, hi)
    at = innermost([(0.5 * (a + b), k) for k, (a, b) in enumerate(holes)],
                   host)
    idle: dict = {}
    for k, (a, b) in enumerate(holes):
        name = at[k] or "host: no traced operation"
        idle[name] = idle.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary(union_length([(a, b) for a, b, _, _ in dev]) * 1e-6,
                   (hi - lo) * 1e-6,
                   [[n, s * 1e-6] for n, s in top],
                   [[n, s * 1e-6] for n, s in top_idle])


class Slice:
    """Records ``[start_s, start_s + length_s)`` of the window (on unit
    boundaries) with ``torch.profiler``."""

    def __init__(self, start_s: float, length_s: float):
        self.start_s = start_s
        self.stop_s = start_s + length_s
        self.active = False
        self.done = False
        self._prof = None
        self._mark = None

    @staticmethod
    def warm_up() -> None:
        """Profile a trivial device call once, so the profiler's first
        start (CUPTI's set-up) falls in set-up, not in the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def boundary(self, now: float) -> None:
        if self.done:
            return
        if not self.active and now >= self.start_s:
            from torch.autograd.profiler import record_function
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.start()
            self._mark = record_function(SLICE)
            self._mark.__enter__()
            self.active = True
        elif self.active and now >= self.stop_s:
            self.close()

    def mark(self, name: str):
        """A host annotation while the slice records, else nothing."""
        if not self.active:
            return contextlib.nullcontext()
        from torch.autograd.profiler import record_function
        return record_function(name)

    def close(self) -> None:
        if self.active:
            self._mark.__exit__(None, None, None)
            self._prof.stop()
            self.active = False
        self.done = True

    def summary(self) -> Optional[Summary]:
        """Export the recorded slice and reduce it (after ``close``)."""
        if self._prof is None:
            return None
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            t0 = time.perf_counter()
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        self.export_s = time.perf_counter() - t0
        events = doc.get("traceEvents", doc) if isinstance(doc, dict) \
            else doc
        return reduce(events)
