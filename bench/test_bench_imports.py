"""Nothing the runner loads is JAX or the JAX package ``repro``, compared by
whole top-level names (the port ``repro_torch`` begins with ``repro``)."""
from __future__ import annotations

import json
import os
import subprocess
import sys

from bench.conftest import REPO, SECONDS

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

PROBE = f"""
import json, sys
from pathlib import Path
from bench import run as R
from bench import control, sweep  # noqa: F401  (the chip-side tools too)
from bench.conftest import make_tiny
root = make_tiny(Path(sys.argv[1]))
b = R.Benchmark(root)
outs = [R.run_cell(b, c["name"], 5, {SECONDS}, t, "cpu")["correct"]
        for c in b.doc["workloads"] for t in (False, True)]
print(json.dumps({{"correct": outs, "forbidden": R.forbidden_modules(),
                  "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_runner_loads_no_jax_and_no_reference_package(tmp_path):
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(REPO / "src"), str(REPO)])}
    out = subprocess.run([sys.executable, "-c", PROBE, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(got["correct"])
    assert got["forbidden"] == []
    assert not FORBIDDEN & set(got["tops"])
    assert "repro_torch" in got["tops"]


def test_forbidden_names_are_compared_whole():
    from bench import run as R
    assert R.forbidden_modules(["repro_torch.core.service", "jaxtyping",
                                "flaxen", "os"]) == []
    assert R.forbidden_modules(["repro.core.graph", "jax.numpy",
                                "repro_torch"]) == ["jax", "repro"]


def test_the_command_needs_a_card(tmp_path):
    """With no CUDA device the run prints nothing and exits with 2."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "bench.run", "--workload",
                          "graph500-s21.open", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert out.stdout == ""
