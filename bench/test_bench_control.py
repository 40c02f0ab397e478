"""The comparison that decides ``correct`` fails its control and every
planted fault a cell can have, driven through the rest of a run on the
host (the chip check skipped)."""
from __future__ import annotations

import contextlib
import dataclasses
import itertools

import pytest
import torch

from bench.conftest import SECONDS

CELLS = ["graph500-s21.open", "idsets-s22.backlog"]


def run(tiny, cell, seed=9):
    from bench import run as R
    return R.run_cell(tiny, cell, seed, SECONDS, False, "cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(tiny, cell):
    out = run(tiny, cell)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_messages_fail(tiny, cell):
    """The control: the program's own bfloat16 message channel.  Hop
    counts survive it exactly; SSSP's float32 path sums do not."""
    from bench import control
    with control.bf16_messages():
        out = run(tiny, cell)
    assert not out["correct"]
    checks = out["checks"]
    assert checks["bfs_wrong"]["value"] == 0
    assert checks["sssp_gap"]["value"] > 1e-4
    # switched off again: sound
    assert run(tiny, cell)["correct"]


@contextlib.contextmanager
def relaxations(**changes):
    """BFS and SSSP registered with their vertex program changed."""
    from repro_torch.core import registry as REG
    saved = {n: REG.get(n) for n in ("bfs", "sssp")}
    try:
        for d in saved.values():
            spec = dataclasses.replace(d.run, **changes)
            REG.register(dataclasses.replace(
                d, run=spec, variants=REG.superstep_variants(spec)),
                replace=True)
        yield
    finally:
        for d in saved.values():
            REG.register(d, replace=True)


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_returns_its_state_unchanged_fails(tiny, cell):
    with relaxations(apply=lambda dist, agg, ids, gval: dist):
        out = run(tiny, cell)
    assert not out["correct"]
    assert out["checks"]["bfs_wrong"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced_fails(tiny, cell,
                                                      monkeypatch):
    from repro_torch.core.service import GraphAnalyticsService
    finish = GraphAnalyticsService._finish

    def altered(self, t, r):
        v = r.value.clone()
        v[torch.nonzero(torch.isfinite(v)).flatten()[-1]] += 0.5
        finish(self, t, dataclasses.replace(r, value=v))

    monkeypatch.setattr(GraphAnalyticsService, "_finish", altered)
    out = run(tiny, cell)
    assert not out["correct"]
    c = out["checks"]
    assert c["bfs_wrong"]["value"] > 0 or c["sssp_gap"]["value"] > 0


def test_half_of_a_wave_left_out_fails(tiny, monkeypatch):
    """Every second unit a drain dequeues is never run: its ticket never
    resolves, and the run counts it missing instead of waiting on it."""
    from repro_torch.core.service import GraphAnalyticsService
    execute = GraphAnalyticsService._execute_unit
    turn = itertools.count()

    def half(self, unit, finished):
        if next(turn) % 2 == 0:
            execute(self, unit, finished)

    monkeypatch.setattr(GraphAnalyticsService, "_execute_unit", half)
    out = run(tiny, "idsets-s22.backlog")
    assert not out["correct"]
    assert out["checks"]["missing"]["value"] > 0
    assert out["failed"] == out["checks"]["missing"]["value"]
