"""The metric arithmetic: the slice's busy and idle time, the tail over all
requests, the per-layer ratios."""
from __future__ import annotations

import math

import pytest

from bench import readers, trace
from bench.run import RunData
from bench.traffic import Query


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


TIMELINE = [
    ev("user_annotation", "bench.slice", 1000, 100),
    ev("kernel", "before the slice", 900, 50, 1),
    ev("cpu_op", "aten::index_select", 1005, 10),
    ev("cuda_runtime", "cudaLaunchKernel", 1008, 2, 7),
    ev("kernel", "gather", 1012, 20, 7),
    ev("cpu_op", "aten::scatter_reduce_", 1020, 5),
    ev("cuda_runtime", "cudaLaunchKernel", 1021, 2, 8),
    ev("kernel", "segment_min", 1022, 8, 8),       # inside the gather
    ev("gpu_memcpy", "Memcpy HtoD", 1090, 20, 9),  # runs past the slice
    ev("user_annotation", "bench.wait_for_arrival", 1040, 45),
]


def test_busy_time_is_the_union_inside_the_slice():
    s = trace.reduce(TIMELINE)
    assert s.window_s == pytest.approx(100e-6)
    # gather 1012-1032 with segment_min inside it, the copy 1090-1100
    assert s.busy_s == pytest.approx(30e-6)
    ops = dict(s.device_ops)
    assert ops["aten::index_select | gather"] == pytest.approx(20e-6)
    assert ops["aten::scatter_reduce_ | segment_min"] == pytest.approx(8e-6)
    assert ops["? | Memcpy HtoD"] == pytest.approx(10e-6)


def test_idle_gaps_are_named_by_the_host():
    s = trace.reduce(TIMELINE)
    idle = dict(s.idle_gaps)
    # 1000-1012: mid 1006 inside index_select; 1032-1090: mid 1061 in the
    # wait for an arrival
    assert idle["aten::index_select"] == pytest.approx(12e-6)
    assert idle["bench.wait_for_arrival"] == pytest.approx(58e-6)
    assert sum(idle.values()) + s.busy_s == pytest.approx(s.window_s)


def test_no_slice_no_summary():
    assert trace.reduce([ev("kernel", "k", 0, 5)]) is None


def run_of(queries, **kw):
    base = dict(window_s=10.0, setup_s=1.0,
                counters=({"executed": 0, "submitted": 0},
                          {"executed": 4, "submitted": 8}))
    return RunData(queries, **{**base, **kw})


def q(due, done, failed=False, **kw):
    return Query(0, "bfs", 0, None, due=due, done=done, failed=failed, **kw)


def test_p95_is_over_every_request_and_counts_failures_as_late():
    qs = [q(0.0, 0.001 * (i + 1)) for i in range(100)]
    assert readers.query_p95_ms(run_of(qs)) == pytest.approx(95.05)
    # six failures: the 95th percentile lies among them
    qs[:6] = [q(0.0, math.nan, failed=True) for _ in range(6)]
    assert readers.query_p95_ms(run_of(qs)) is None
    qs[:6] = [q(0.0, 0.5) for _ in range(6)]
    assert readers.query_p95_ms(run_of(qs)) == pytest.approx(500.0)


def test_rate_counts_what_resolved_in_the_window():
    qs = [q(0.0, 1.0)] * 5 + [q(0.0, 11.0), q(0.0, math.nan, failed=True)]
    assert readers.query_rate(run_of(qs)) == pytest.approx(0.5)


def test_queue_wait_and_tickets_per_unit():
    qs = [q(1.0, 2.0, dequeued=1.0 + 0.01 * i) for i in range(5)]
    qs.append(q(1.0, 2.0))                  # no span read: left out
    assert readers.queue_wait_p50_ms(run_of(qs)) == pytest.approx(20.0)
    assert readers.queue_wait_p50_ms(run_of([q(0, 1)])) is None
    assert readers.tickets_per_unit(run_of([])) == pytest.approx(2.0)


def test_supersteps_count_a_fused_group_once():
    qs = [q(0, 1, unit_head=True, iterations=10, variant="dense",
            in_slice=True),
          # a fused group of three: one loop of 6 supersteps
          q(0, 1, unit_head=True, iterations=6, variant="fused",
            in_slice=True),
          q(0, 1, unit_head=False, iterations=6, variant="fused",
            in_slice=True),
          q(0, 1, unit_head=False, iterations=6, variant="fused",
            in_slice=True),
          q(0, 1, unit_head=True, iterations=4, variant="dense")]
    run = run_of(qs, trace=trace.Summary(0.032, 0.1, [], []),
                 slice_bytes=10**9, peaks={"hbm_bytes_per_s": 3.35e12})
    assert readers.dense_share(run) == pytest.approx(100 * 14 / 20)
    assert readers.device_ms_per_superstep(run) == pytest.approx(2.0)
    assert readers.device_idle(run) == pytest.approx(68.0)
    assert readers.superstep_roofline(run) == pytest.approx(
        100 * 1e9 / (0.032 * 3.35e12))


def test_device_metrics_are_silent_without_a_trace():
    run = run_of([q(0, 1, unit_head=True, iterations=3, variant="dense")])
    for read in (readers.device_ms_per_superstep, readers.device_idle,
                 readers.superstep_roofline):
        assert read(run) is None
    idle = run_of([], trace=trace.Summary(0.0, 1.0, [], []))
    assert readers.superstep_roofline(idle) is None


@pytest.mark.parametrize("reached", [3, 90])
def test_held_answers_come_back_whole(reached):
    import torch
    from bench.traffic import hold, unhold
    v = torch.full((100,), float("inf"))
    v[:reached] = torch.arange(reached, dtype=torch.float32)
    v[reached - 1] = float("nan")          # a fault must survive holding
    held = hold(v)
    assert isinstance(held, torch.Tensor) == (reached >= 50)
    back = unhold(held)
    assert torch.equal(back[:reached - 1], v[:reached - 1])
    assert torch.isnan(back[reached - 1])
    assert torch.equal(back[reached:], v[reached:])


def test_memory_peak_in_gb_and_none_without_a_card():
    from bench.run import Benchmark
    from bench.conftest import REPO
    bench = Benchmark(REPO)
    metric = {"name": "memory_peak_gb"}
    card = run_of([], peaks={"fp32_tflops": 1.0},
                  memory_peak_bytes=17_770_000_000)
    assert bench.read(metric, card) == pytest.approx(17.77)
    assert bench.read(metric, run_of([])) is None
