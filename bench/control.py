"""The control of the comparison that decides ``correct``, beside sound runs.

    python3 -m bench.control --workload <cell> --seeds 11,12,13 --seconds <s>

For each seed it makes the cell's graph once and runs the cell on it
twice, as ``bench.run`` does: first the program as it stands (a sound
run), then with the program's own reduced-precision path switched on:
BFS's and SSSP's messages pass through a bfloat16 channel
(``pregel.reduced_precision``), the step a later change might take to
save bytes.  Each run prints its compared numbers as one JSON line.  The
sound runs give the lower readings of the limits, the control the
upper: it has to come out as not correct, since SSSP's float32 path
sums cannot survive bfloat16 (BFS's small hop counts do, exactly).

Where the configuration fixes its structure (``structure_seed``), each
seed here draws a structure of its own, so the readings cover as many
graphs as seeds.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path


@contextlib.contextmanager
def bf16_messages():
    """BFS and SSSP registered with a bfloat16 message channel, for the
    block's duration."""
    import torch
    from repro_torch.core import registry as REG
    from repro_torch.core.algorithms import traversal as TV
    from repro_torch.core.pregel import reduced_precision
    saved = {n: REG.get(n) for n in ("bfs", "sssp")}
    specs = (TV._BFS_SPEC, TV._SSSP_SPEC)
    try:
        for name, d in saved.items():
            spec = reduced_precision(d.run, torch.bfloat16)
            REG.register(dataclasses.replace(
                d, run=spec, variants=REG.superstep_variants(spec)),
                replace=True)
        TV._BFS_SPEC = reduced_precision(specs[0], torch.bfloat16)
        TV._SSSP_SPEC = reduced_precision(specs[1], torch.bfloat16)
        yield
    finally:
        for d in saved.values():
            REG.register(d, replace=True)
        TV._BFS_SPEC, TV._SSSP_SPEC = specs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    root = Path.cwd()
    sys.path.insert(0, str(root / "src"))
    import torch
    from bench import run as R
    if not torch.cuda.is_available():
        R.log("no CUDA device")
        return 2
    bench = R.Benchmark(root)
    cfg = bench.config(bench.cell(args.workload))
    for seed in (int(s) for s in args.seeds.split(",")):
        if "structure_seed" in cfg:
            cfg = {**cfg, "structure_seed": seed}
        graph = R.make_graph(cfg, seed, "cuda")
        for name, ctx in (("sound", contextlib.nullcontext),
                          ("bf16_messages", bf16_messages)):
            with ctx():
                out = R.run_cell(bench, args.workload, seed, args.seconds,
                                 False, "cuda", time.perf_counter(), graph)
            print(json.dumps({"run": name, "seed": seed,
                              "structure_seed": cfg.get("structure_seed"),
                              "correct": out["correct"],
                              "checks": out["checks"]}), flush=True)
        del graph
    return 0


if __name__ == "__main__":
    sys.exit(main())
