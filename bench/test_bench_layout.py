"""A configuration, a traffic mix or a metric is added by adding a file
(and its entry in ``BENCHMARK.json``): no file of the harness changes."""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

from bench.conftest import SECONDS


def digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "bench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_and_a_metric_come_from_added_files(tiny):
    from bench import run as R
    root = tiny.root
    before = digests(root)
    bench_dir = root / "bench"
    # a deployment, a traffic mix and a per-layer metric, each a new file
    cfg = json.loads((bench_dir / "configs" / "graph500-s21.json").read_text())
    (bench_dir / "configs" / "graph500-s8.json").write_text(
        json.dumps({**cfg, "scale": 8}))
    (bench_dir / "traffic" / "burst.json").write_text(json.dumps(
        {"kind": "waves", "accounts_per_wave": 8,
         "algorithms": ["sssp", "bfs"], "max_iters": None,
         "warmup_waves": 1}))
    (bench_dir / "metrics" / "supersteps_per_ticket.burst.py").write_text(
        "def read(run):\n"
        "    return sum(q.iterations for q in run.queries) / "
        "len(run.queries)\n")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "graph500-s8", "source": "test",
                           "file": "bench/configs/graph500-s8.json",
                           "reduced": ["scale"], "why": "test"})
    doc["workloads"].append({"name": "graph500-s8.burst",
                             "config": "graph500-s8", "traffic": "burst",
                             "chips": 1, "why": "test"})
    tail = next(m for m in doc["end_to_end"]
                if m["name"] == "query_p95_ms")
    tail["workloads"].append("graph500-s8.burst")
    doc["per_layer"].append({"name": "supersteps_per_ticket.burst",
                             "unit": "supersteps", "better": "lower",
                             "source": "program_counter", "layer": "pregel loop",
                             "moves": "query_p95_ms",
                             "workloads": ["graph500-s8.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    grown = R.Benchmark(root)
    e2e = R.run_cell(grown, "graph500-s8.burst", 3, SECONDS, False, "cpu")
    assert e2e["correct"]
    assert set(e2e["metrics"]) == {"query_p95_ms", "setup_s"}
    layer = R.run_cell(grown, "graph500-s8.burst", 4, SECONDS, True, "cpu")
    assert layer["correct"]
    assert layer["metrics"]["supersteps_per_ticket.burst"]["value"] > 1
    after = digests(root)
    assert all(after[p] == d for p, d in before.items()), \
        "an existing file of the harness changed"
    assert len(after) == len(before) + 3


def test_every_named_file_exists(cells):
    from bench.conftest import REPO
    doc = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in doc["configs"]:
        assert (REPO / c["file"]).is_file()
    for w in doc["workloads"]:
        assert (REPO / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert (REPO / "bench" / "metrics" / f"{m['name']}.py").is_file()
        for cell in m.get("workloads", cells):
            assert cell in cells
