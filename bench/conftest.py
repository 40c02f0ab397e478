"""Fixtures of the benchmark's CPU tests: a copy of the benchmark cut to a
size a test run holds, run on the host with the port's ``device="cpu"``."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

# the cells' sizes cut for the host; everything else as the cells run
TINY_CONFIG = {"graph500-s21": {"scale": 9}, "idsets-s22": {"n_users": 4096}}
TINY_TRAFFIC = {"open": {"rate_per_s": 60.0}}
SECONDS = 0.4


def make_tiny(root: Path) -> Path:
    """``BENCHMARK.json`` and ``bench/`` copied under ``root``, with the
    configurations and traffic cut to ``TINY_*``."""
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    for name, cut in TINY_CONFIG.items():
        path = root / "bench" / "configs" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **cut}))
    for name, cut in TINY_TRAFFIC.items():
        path = root / "bench" / "traffic" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **cut}))
    return root


@pytest.fixture
def tiny(tmp_path):
    """A ``run.Benchmark`` over a tiny copy of the benchmark."""
    from bench import run as R
    return R.Benchmark(make_tiny(tmp_path))


@pytest.fixture
def cells():
    return [c["name"] for c in
            json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
