"""The reader of ``dense_kernel_share.open``: the program's count of dense
supersteps run through the kernel's CSR entry, over the window's
supersteps; silent on a program that counts none."""
from __future__ import annotations

import pytest

from bench.conftest import REPO
from bench.run import Benchmark
from bench.test_bench_spans import q, run_of, ticket

METRIC = {"name": "dense_kernel_share.open"}


def share(queries):
    return Benchmark(REPO).read(METRIC, run_of(queries))


def test_share_of_supersteps_through_the_csr_entry():
    assert share([
        q(ticket(timeline={"host_syncs": 7, "kernel_supersteps": 7}), 7),
        q(ticket(timeline={"host_syncs": 3, "kernel_supersteps": 0}), 3),
        q(ticket(timeline={"host_syncs": 9, "kernel_supersteps": 9},
                 attempts=2), 9),
    ]) == pytest.approx(100.0 * 16 / 19)


@pytest.mark.parametrize("timeline", [
    {"host_syncs": 7, "init_wall_s": 0.002},    # a program without the count
    {"init_wall_s": 0.002},                     # no loop ran
    None,                                       # untraced
])
def test_silent_where_the_program_counts_nothing(timeline):
    assert share([q(ticket(timeline=timeline), 7)]) is None


def test_the_port_counts_its_loops_on_the_host():
    """A traced dense query on the CPU runs no kernel: the count is there,
    and 0."""
    from repro_torch.core import graph as G
    from repro_torch.core.service import GraphAnalyticsService
    from repro_torch.core.query import GraphQuery
    svc = GraphAnalyticsService(trace_depth=16)
    g = G.build_coo([0, 1, 2, 3], [1, 2, 3, 0], 4, symmetrize=True,
                    device="cpu")
    svc.add_graph("g", g, device="cpu", force_engine="local")
    t = svc.submit("g", GraphQuery.bfs([0]))
    svc.drain()
    tl = t.trace().find_all("execute")[-1].attrs["timeline"]
    assert tl["kernel_supersteps"] == 0 and tl["host_syncs"] > 0
