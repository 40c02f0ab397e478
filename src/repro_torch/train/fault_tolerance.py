"""Fault-tolerance machinery: heartbeats, failure injection, straggler
watchdog, and the restart supervisor.

A copy of the reference's ``train/fault_tolerance.py`` (standard library
only).  On a real deployment the coordinator restarts dead workers and
the job restores from the last committed checkpoint; here that control
flow runs with *injected* failures (tests/test_torch_fault_tolerance.py
kills the step loop mid-run and asserts bit-exact continuation from the
checkpoint).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional, Sequence


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Raises at the given steps (once each) — models preemption/crash."""
    fail_at_steps: Sequence[int] = ()

    def __post_init__(self):
        self._pending = set(self.fail_at_steps)

    def check(self, step: int):
        if step in self._pending:
            self._pending.discard(step)
            raise SimulatedFailure(f"injected failure at step {step}")


class Heartbeat:
    """Periodic liveness file; a monitor (or test) detects stalls."""

    def __init__(self, path: str, interval_s: float = 5.0):
        self.path = path
        self.interval_s = interval_s
        self._last = 0.0

    def beat(self, step: int, force: bool = False):
        now = time.time()
        if force or now - self._last >= self.interval_s:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"time": now, "step": step}, f)
            os.replace(tmp, self.path)
            self._last = now

    def age(self) -> Optional[float]:
        try:
            with open(self.path) as f:
                return time.time() - json.load(f)["time"]
        except (FileNotFoundError, json.JSONDecodeError):
            return None


class StragglerWatchdog:
    """EWMA step-time monitor.  On a real cluster a flagged host triggers a
    re-slice; here we record the event stream for the supervisor/tests."""

    def __init__(self, factor: float = 2.0, alpha: float = 0.2,
                 warmup: int = 3):
        self.factor = factor
        self.alpha = alpha
        self.warmup = warmup
        self.ewma: Optional[float] = None
        self.count = 0
        self.events: list[dict] = []

    def record(self, step: int, step_time_s: float) -> bool:
        self.count += 1
        if self.ewma is None:
            self.ewma = step_time_s
            return False
        is_straggler = (self.count > self.warmup
                        and step_time_s > self.factor * self.ewma)
        if is_straggler:
            self.events.append({"step": step, "time": step_time_s,
                                "ewma": self.ewma})
        # EWMA excludes outliers so one straggler doesn't mask the next
        if not is_straggler:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_time_s
        return is_straggler


@dataclasses.dataclass
class SupervisorReport:
    restarts: int
    completed_steps: int
    straggler_events: int
    final_metrics: dict


def run_supervised(
    train_loop: Callable[[Optional[int]], dict],
    max_restarts: int = 3,
) -> SupervisorReport:
    """Restart-on-failure driver.

    ``train_loop(resume_step)`` runs until done (returns metrics) or
    raises.  The loop is responsible for checkpoint/restore; the
    supervisor just re-invokes it — same division of labour as a real
    cluster controller.
    """
    restarts = 0
    while True:
        try:
            metrics = train_loop(None)
            return SupervisorReport(
                restarts=restarts,
                completed_steps=metrics.get("steps", 0),
                straggler_events=metrics.get("straggler_events", 0),
                final_metrics=metrics,
            )
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
