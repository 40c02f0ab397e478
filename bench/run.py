"""Run one cell of ``BENCHMARK.json`` on the card; print one JSON line.

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run makes its graph on the card from
``--seed`` (the configuration's generator), builds it with the port's
own ETL (``build_coo(..., symmetrize=True)``), registers it with a
``GraphAnalyticsService`` built with its defaults, warms it up with the
traffic's own warm-up queries, then drives the traffic mix for
``--seconds`` through ``submit``, ``drain`` and the tickets' results.
Once the window has closed it reads the peak memory, frees the service
and holds every answer against the plain reference (``check.py``).

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` turns on
the service's span tracer and records a slice of the window with
``torch.profiler``, and prints the per-layer metrics.  Progress goes to
standard error; its last lines are the compared numbers and their
limits.  With no CUDA device, or fewer than the cell asks for, the run
prints nothing on standard output and exits with 2; if ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded once the
window has closed, with 3.
"""
import time

T0 = time.perf_counter()      # the process's start, as near as it is seen

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GRAPH = "bench"


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)



# ------------------------------------------------------------ the files

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Benchmark:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.doc = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for c in self.doc["workloads"]:
            if c["name"] == name:
                return c
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == cell["config"]:
                return load_json(self.root / c["file"])
        raise SystemExit(f"no config {cell['config']!r} in BENCHMARK.json")

    def traffic(self, cell: dict) -> dict:
        return load_json(self.root / "bench" / "traffic"
                         / f"{cell['traffic']}.json")

    def metrics(self, cell: dict, trace: bool) -> list:
        """The metric entries this cell reports in a run of this kind."""
        group = self.doc["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def read(self, metric: dict, run) -> Optional[float]:
        path = self.root / "bench" / "metrics" / f"{metric['name']}.py"
        spec = importlib.util.spec_from_file_location(
            "bench.metrics." + metric["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(run)
        if value is None or not math.isfinite(value):
            return None
        return float(value)

    def peaks(self, kind: str) -> dict:
        for key, row in load_json(self.root / "bench" / "peaks.json").items():
            if key in kind:
                return row
        return {}


@dataclasses.dataclass
class RunData:
    """What the metric readers see of a finished run."""

    queries: list
    window_s: float
    setup_s: float
    counters: tuple               # the service's counters before, after
    trace: object = None          # trace.Summary of the traced slice
    slice_bytes: int = 0          # least bytes of the slice's answers
    memory_peak_bytes: int = 0    # the card's peak from add_graph on
    peaks: dict = dataclasses.field(default_factory=dict)


# ------------------------------------------------------------- the run

def make_graph(cfg: dict, seed: int, device):
    """The configuration's edge list, made on ``device`` from the seed,
    and the port's COO of it (built on the host by ``build_coo``).  The
    generators emit simple graphs, so the COO's deduplication would find
    nothing and is not asked for: the same edges, in another order within
    each destination."""
    import torch
    from repro_torch.core import graph as G
    gen = importlib.import_module(f"bench.gen.{cfg['generator']}")
    t = time.perf_counter()
    edges = gen.generate(cfg, seed, device)
    lo, hi, w = (x.cpu().numpy() for x in (edges.lo, edges.hi, edges.w))
    t_gen = time.perf_counter() - t
    t = time.perf_counter()
    coo = G.build_coo(lo, hi, edges.n_vertices, w=w, symmetrize=True,
                      dedup=False, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    log(f"graph {cfg['generator']}: {edges.n_vertices} vertices, "
        f"{edges.n_pairs} pairs, {coo.n_edges} directed edges, max degree "
        f"{int(edges.degrees().max())}; generated "
        f"in {t_gen:.3f} s, build_coo {time.perf_counter() - t:.3f} s")
    return edges, coo


def serve(coo, plan, seconds: float, trace: bool, device, t0: float,
          sync):
    """Register the graph, warm up, and drive the window.  Returns the
    driver (its service still alive), the window's length, set-up
    seconds, counters before the window, and the slice."""
    from bench import trace as T
    from bench.traffic import Driver, NoSlice
    from repro_torch.core.service import GraphAnalyticsService
    t = time.perf_counter()
    svc = GraphAnalyticsService(trace_depth=(1 << 20) if trace else 0)
    svc.add_graph(GRAPH, coo, device=device)
    t_add = time.perf_counter() - t
    driver = Driver(svc, GRAPH, sync)
    t = time.perf_counter()
    driver.warm_up(plan.warmup)
    t_warm = time.perf_counter() - t
    if trace and torch_cuda(device):
        T.Slice.warm_up()
    setup_s = time.perf_counter() - t0
    log(f"add_graph {t_add:.3f} s, warm-up {t_warm:.3f} s, "
        f"set-up {setup_s:.3f} s")
    before = svc.metrics()["counters"]
    r0 = resource.getrusage(resource.RUSAGE_SELF)
    third = seconds / 3.0
    slice_ = T.Slice(third, min(third, 5.0)) if trace else NoSlice()
    if plan.kind == "open":
        window = driver.run_open(plan, seconds, slice_)
    else:
        window = driver.run_waves(plan, seconds, slice_)
    slice_.close()
    r1 = resource.getrusage(resource.RUSAGE_SELF)
    log(f"host in the window: {r1.ru_minflt - r0.ru_minflt} minor page "
        f"faults, {r1.ru_nivcsw - r0.ru_nivcsw} involuntary context "
        f"switches, user {r1.ru_utime - r0.ru_utime:.3f} s, system "
        f"{r1.ru_stime - r0.ru_stime:.3f} s")
    return driver, window, setup_s, before, slice_


def torch_cuda(device) -> bool:
    import torch
    return torch.device(device).type == "cuda"


def judge(edges, queries: list, device):
    """Hold every answer against the reference; count the least bytes of
    the traced slice's answers.  Frees each answer once compared."""
    from bench import check, reference
    from bench.traffic import unhold
    tally = check.Tally()
    adj = reference.Adjacency(edges, device)
    slice_bytes = 0
    for q in queries:
        if q.failed or math.isnan(q.done):
            tally.add_missing()
            continue
        ans = reference.relax(adj, q.root, q.algorithm == "sssp",
                              q.max_iters)
        tally.add(q.algorithm, unhold(q.value), ans.dist)
        q.value = None
        if q.in_slice:
            slice_bytes += ans.least_bytes
    return tally, slice_bytes


def mean_service_s(queries: list) -> float:
    """A query's mean time in service, the loop being one server that
    serves in order: from its submission, or the previous answer if
    later, to its answer."""
    service, free = [], 0.0
    for q in sorted((q for q in queries if not q.failed),
                    key=lambda q: q.done):
        service.append(q.done - max(q.submitted, free))
        free = q.done
    return sum(service) / max(len(service), 1)


def wave_thirds(ends: list) -> str:
    import numpy as np
    if len(ends) < 3:
        return "-"
    d = np.diff([0.0] + list(ends))
    return "/".join(f"{x.mean():.4f}" for x in np.array_split(d, 3))


def percentiles(xs: list) -> str:
    import numpy as np
    if not xs:
        return "-"
    return "/".join(f"{v:.4g}" for v in np.percentile(xs, [5, 50, 95]))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def run_cell(bench: Benchmark, name: str, seed: int, seconds: float,
             trace: bool, device="cuda", t0: Optional[float] = None,
             graph=None) -> dict:
    """One run of the cell ``name``; returns the result line's object
    (with the ``checks`` key last).  ``graph``, an ``(edges, coo)`` pair
    from :func:`make_graph`, stands in for the cell's own."""
    import torch
    from bench import traffic as TR
    t0 = time.perf_counter() if t0 is None else t0
    cuda = torch_cuda(device)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cell = bench.cell(name)
    cfg = bench.config(cell)
    mix = bench.traffic(cell)
    log(f"{time.perf_counter() - t0:.3f} s from the start: making the graph")
    edges, coo = graph or make_graph(cfg, seed, device)
    plan = TR.build(mix, edges, seed, seconds, device)
    edges = edges.to("cpu")            # the reference's, after the window
    if cuda:                           # the peak from here on is the port's
        torch.cuda.reset_peak_memory_stats()
    driver, window, setup_s, before, slice_ = serve(
        coo, plan, seconds, trace, device, t0, sync)
    del coo
    svc = driver.svc
    metrics = svc.metrics()
    after = metrics["counters"]
    queries = plan.queries
    late = [q.submitted - q.due for q in queries] \
        if plan.kind == "open" else []
    log(f"window {window:.3f} s: {len(queries)} queries, counters "
        f"{after}, cache {metrics['cache']}"
        + (f", submitted late by max {max(late):.4f} s" if late else ""))
    for algo in sorted({q.algorithm for q in queries}):
        its = [q.iterations for q in queries if q.algorithm == algo]
        lat = [q.done - q.due for q in queries
               if q.algorithm == algo and not q.failed]
        log(f"{algo}: {len(its)} answers, supersteps p5/p50/p95 "
            f"{percentiles(its)}" + (f", latency s {percentiles(lat)}"
                                     if plan.kind == "open" else ""))
    if plan.kind == "open":
        log(f"mean service {mean_service_s(queries) * 1e3:.3f} ms")
    else:
        ends = driver.wave_ends
        log(f"{len(ends)} waves; seconds a wave in each third of the "
            f"window: {wave_thirds(ends)}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    driver.read_spans()
    summary = slice_.summary() if trace else None
    if summary is not None:
        log(f"trace: slice {summary.window_s:.3f} s, busy "
            f"{summary.busy_s:.3f} s, exported and read in "
            f"{slice_.export_s:.1f} s")
    driver.svc = svc = None            # the program's state goes
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    tally, slice_bytes = judge(edges, queries, device)
    log(f"reference: {tally.compared} answers compared in "
        f"{time.perf_counter() - t:.3f} s")
    run = RunData(queries, window, setup_s, (before, after), trace=summary,
                  slice_bytes=slice_bytes, peaks=bench.peaks(kind),
                  memory_peak_bytes=int(peak))
    values = {}
    for m in bench.metrics(cell, trace):
        v = bench.read(m, run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": tally.correct(), "attempted": len(queries),
           "failed": sum(1 for q in queries
                         if q.failed or math.isnan(q.done)),
           "metrics": values, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
    if cuda:
        log(f"card: {card_line()}")
    for line in tally.lines():
        log(line)
    out["checks"] = tally.as_json()
    return out


def forbidden_modules(names=None) -> list:
    """The top-level names among ``names`` (by default the loaded modules)
    that the benchmark must not load, compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    bench = Benchmark(root)
    cell = bench.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        log(f"the cell needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    sys.path.insert(0, str(root / "src"))
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", T0)
    bad = forbidden_modules()
    if bad:
        log(f"modules the benchmark must not load are loaded: {bad}")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
