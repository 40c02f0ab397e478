"""The readers of the program's own spans (``bench/spans.py``): each on a
hand-made run, silent where nothing was recorded, and on a tiny cell run on
the host."""
from __future__ import annotations

import types

import pytest

from bench import spans
from bench.conftest import SECONDS
from bench.run import RunData
from bench.traffic import Query
from repro_torch.core import obs

NEW = ("plan_ms_p50", "init_ms_p50", "syncs_per_superstep",
       "loop_span_ms_per_superstep")


def span(name, t0, t1, children=(), **attrs):
    s = obs.Span(0, name, t0, t1, attrs=attrs)
    s.children.extend(children)
    return s


def ticket(plan_s=None, timeline=None, attempts=1):
    """A ticket that hands out a trace holding a plan span of ``plan_s``
    seconds and ``attempts`` execute spans, the last with ``timeline``."""
    sub = [span("plan", 1.0, 1.0 + plan_s)] if plan_s is not None else []
    execs = [span("attempt", 2.0, 3.0,
                  [span("execute", 2.0, 3.0,
                        **({"timeline": timeline}
                           if timeline and k == attempts - 1 else {}))])
             for k in range(attempts)]
    root = span("ticket", 0.0, 3.0, [span("submit", 0.5, 1.5, sub)] + execs)
    tr = obs.TicketTrace(0, "g", "bfs", "interactive", root)
    return types.SimpleNamespace(trace=lambda: tr)


def q(tk, iterations=0, head=True):
    return Query(0, "bfs", 0, None, ticket=tk, iterations=iterations,
                 unit_head=head, done=1.0)


def run_of(queries):
    return RunData(queries, window_s=10.0, setup_s=1.0,
                   counters=({"executed": 0, "submitted": 0},
                             {"executed": 1, "submitted": 1}))


def test_plan_median_over_every_ticket():
    run = run_of([q(ticket(plan_s=s)) for s in (0.001, 0.004, 0.002)]
                 + [q(ticket())])            # no plan span: left out
    assert spans.plan_ms_p50(run) == pytest.approx(2.0)


def test_init_median_over_units_read_once_a_unit():
    run = run_of([q(ticket(timeline={"init_wall_s": 0.003}), 4),
                  q(ticket(timeline={"init_wall_s": 0.009}), 4,
                    head=False),              # a fused member: not again
                  q(ticket(timeline={"init_wall_s": 0.005}), 4),
                  q(ticket(timeline={"host_syncs": 3}), 1)])
    assert spans.init_ms_p50(run) == pytest.approx(4.0)


def test_syncs_and_device_time_per_superstep():
    run = run_of([
        q(ticket(timeline={"host_syncs": 9, "loop_span_ms": 2.0}), 4),
        # a retried unit: the last attempt's timeline counts
        q(ticket(timeline={"host_syncs": 5, "loop_span_ms": 6.0},
                 attempts=2), 2),
        q(ticket(timeline={"init_wall_s": 0.1}), 7),   # no loop ran
    ])
    assert spans.syncs_per_superstep(run) == pytest.approx(14 / 6)
    assert spans.loop_span_ms_per_superstep(run) == pytest.approx(8 / 6)


@pytest.mark.parametrize("queries", [
    [],                                                  # an empty window
    [Query(0, "bfs", 0, None)],                          # never submitted
    [q(types.SimpleNamespace(ticket_id=1), 3)],          # no trace kept
    [q(types.SimpleNamespace(trace=lambda: None), 3)],   # untraced
    [q(ticket(), 3)],                                    # no timeline
], ids=["empty", "unsubmitted", "older-program", "untraced", "bare"])
def test_silent_where_nothing_was_recorded(queries):
    run = run_of(queries)
    for name in NEW:
        assert getattr(spans, name)(run) is None, name


def test_device_time_silent_off_the_card():
    run = run_of([q(ticket(plan_s=0.001,
                           timeline={"init_wall_s": 0.002,
                                     "host_syncs": 3}), 3)])
    assert spans.loop_span_ms_per_superstep(run) is None
    assert spans.syncs_per_superstep(run) == pytest.approx(1.0)


def test_metric_files_read_a_traced_cell_on_the_host(tiny):
    """Each cell's traced run reports the new metrics its readers find on
    the host; the loop's span on the device stays silent off the card."""
    from bench import run as R
    for cell in tiny.doc["workloads"]:
        out = R.run_cell(tiny, cell["name"], 6, SECONDS, True, "cpu")
        assert out["correct"]
        got = out["metrics"]
        suffix = cell["name"].rsplit(".", 1)[1]
        for name in NEW[:3]:
            assert f"{name}.{suffix}" in got, name
            assert got[f"{name}.{suffix}"]["value"] >= 0
        assert f"loop_span_ms_per_superstep.{suffix}" not in got
        syncs = got[f"syncs_per_superstep.{suffix}"]["value"]
        # dense: one halt read a superstep; frontier: and a pack, plus one
        # (cut to the host's size, both cells fit the frontier's budget)
        assert 1.0 <= syncs <= 3.0
        untraced = R.run_cell(tiny, cell["name"], 6, SECONDS, False, "cpu")
        assert not set(untraced["metrics"]) & {f"{n}.{suffix}" for n in NEW}
