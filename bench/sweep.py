"""Find the knee of an open-loop cell: the highest rate it sustains.

    python3 -m bench.sweep --workload <cell> --seed <n> --seconds <s> --rates 10,20,30

makes the cell's graph once, then for each rate registers it with a new
service, warms up and offers the cell's traffic at that rate for
``--seconds``.  Each rate prints one JSON line: queries completed per
second, latency quantiles, and the work left at the window's close (the
queries due in the window still unanswered then, and how long after the
close the last answer came).  A rate is sustained when that work is
served within ``SUSTAINED_S`` of the close: a queue that keeps up holds
a few queries at any time, one that grows holds (rate - capacity) x
window of them.  The last line names the knee, the highest rate up to
which every rate swept was sustained, and the cell's rate, 0.8 of it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

SUSTAINED_S = 1.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    root = Path.cwd()
    sys.path.insert(0, str(root / "src"))
    import torch
    from bench import run as R
    from bench import traffic as TR
    if not torch.cuda.is_available():
        R.log("no CUDA device")
        return 2
    bench = R.Benchmark(root)
    cell = bench.cell(args.workload)
    mix = bench.traffic(cell)
    if mix["kind"] != "open":
        R.log("the sweep is for open-loop cells")
        return 2
    edges, coo = R.make_graph(bench.config(cell), args.seed, "cuda")
    knee, kept_up = None, True
    for k, rate in enumerate(sorted(float(r) for r in args.rates.split(","))):
        plan = TR.build({**mix, "rate_per_s": rate}, edges, args.seed + k,
                        args.seconds, "cuda")
        t0 = time.perf_counter()
        driver, window, _, _, _ = R.serve(coo, plan, args.seconds, False,
                                          "cuda", t0, torch.cuda.synchronize)
        qs = plan.queries
        lat = np.array([q.done - q.due for q in qs])
        last = max(q.done for q in qs)
        sustained = last - args.seconds <= SUSTAINED_S
        kept_up = kept_up and sustained
        if kept_up:
            knee = rate
        print(json.dumps({
            "rate": rate, "queries": len(qs),
            "completed_per_s": len(qs) / last,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p95_ms": float(np.percentile(lat, 95)) * 1e3,
            "left_at_close": sum(1 for q in qs if q.done > args.seconds),
            "finished_after_close_s": last - args.seconds,
            "sustained": sustained,
            "mean_service_ms": R.mean_service_s(qs) * 1e3,
            "mean_iterations": float(np.mean([q.iterations for q in qs]))}),
            flush=True)
        driver.svc = None
        for q in qs:
            q.value = None
        torch.cuda.empty_cache()
    print(json.dumps({"knee": knee, "cell_rate":
                      None if knee is None else round(0.8 * knee, 1)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
