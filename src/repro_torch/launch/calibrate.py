"""Fit the planner's calibration profile on this process's device.

    PYTHONPATH=src python -m repro_torch.launch.calibrate \\
        --scales 2**18,2**20 --repeats 3           # on the card
    PYTHONPATH=src python -m repro_torch.launch.calibrate \\
        --scales 2000 --device cpu --out build/profile.json

The port's counterpart of the reference's calibration sweep (the sample
collection of ``benchmarks/algo_suite.py``'s ``run(samples=...)`` and
its ``emit_calibration``); the sweep's CSV rows of distributed runs,
other variants and crossover projections are not part of it.  At each
scale, over ``user_follow_graph(V, 4.0, seed=1)`` with self-loops
dropped (symmetrised for the algorithms that need it), it collects:

* per algorithm with ``example_params``: the local engine's measured
  wall against ``estimate_local_cost`` under the analytic
  ``CalibrationProfile()`` (so a loaded profile never skews a re-fit);
* the dense / fused / frontier walls of each superstep algorithm, where
  all three ran as asked (past ``SUPERSTEP_ELL_BUDGET`` the engine runs
  fused and frontier as dense, and such walls are not the variants');
* the count-path walls.

A wall is the median of three host-clock runs to
``torch.cuda.synchronize()`` after one warm-up run, and with
``--repeats R`` each sample is the median of its walls over R passes of
the sweep (one sample a scale, as the reference's).  ``fit_profile`` is
the reference's fit rule, a plain function of those samples.  The
written profile is what ``planner.load_calibration`` applies; checked in
as ``core/calibration/reference_profile.json`` (the default ``--out``)
it is auto-loaded at import.  Runs on ``cuda:0`` unless ``--device``
names another device; nothing falls back to the CPU.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.core import planner as P
from repro_torch.core import registry as R
from repro_torch.core.engines import LocalEngine
from repro_torch.data import synthetic as S
from repro_torch.device import resolve_device

SUPERSTEP_VARIANTS = ("dense", "fused", "frontier")


def csv_row(name: str, seconds: float, derived: str = "") -> str:
    return f"{name},{seconds * 1e6:.1f},{derived}"


def build_graph(n_vertices: int, symmetric: bool, device) -> G.GraphCOO:
    """The reference sweep's graph (``algo_suite._build``)."""
    src, dst = S.user_follow_graph(n_vertices, 4.0, seed=1)
    keep = src != dst
    return G.build_coo(src[keep], dst[keep], n_vertices,
                       symmetrize=symmetric, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_wall(fn: Callable, device: torch.device, warmup: int = 1,
              iters: int = 3):
    """Median host-clock seconds of ``fn()`` to a device synchronise,
    and ``fn``'s last result."""
    for _ in range(warmup):
        fn()
        _sync(device)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        r = fn()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), r


def suite():
    """Registered algorithms that declared representative parameters."""
    return [(name, defn) for name, defn in R.items()
            if defn.example_params is not None]


def collect_samples(scales: Sequence[int], device=None,
                    out: Callable[[str], None] = print,
                    repeats: int = 1) -> dict:
    """The sweep: ``{algorithm: [(measured_s, modeled_s), ...],
    "_superstep_times": [{variant: s}, ...], "_count_times": [s, ...]}``,
    the reference's samples dict.  Each scale is swept ``repeats``
    times over the same graph; a sample's wall is the median of its
    passes' walls."""
    dev = resolve_device(device)
    samples: dict = {}
    for n in scales:
        graphs = {sym: build_graph(n, sym, dev) for sym in (False, True)}
        engines = {sym: LocalEngine(g, device=dev)
                   for sym, g in graphs.items()}
        # per algorithm: local walls, {variant: walls}, count walls
        local, variants, counts, fell_back = {}, {}, {}, set()
        for _ in range(repeats):
            for name, defn in suite():
                eng = engines[defn.requires_symmetric]
                params = dict(defn.example_params)
                t_local, _ = time_wall(lambda: eng.run(defn, params), dev)
                out(csv_row(f"calibrate/{name}_local_v{n}", t_local))
                local.setdefault(name, []).append(t_local)
                if set(SUPERSTEP_VARIANTS) <= set(defn.variants or ()):
                    for var in SUPERSTEP_VARIANTS:
                        t_var, r = time_wall(
                            lambda: eng.run(defn, params, variant=var), dev)
                        realized = r.meta.get("realized_variant")
                        out(csv_row(f"calibrate/{name}_{var}_v{n}", t_var,
                                    f"realized={realized}"))
                        variants.setdefault(name, {}).setdefault(
                            var, []).append(t_var)
                        # a variant whose layout passes SUPERSTEP_ELL_BUDGET
                        # falls back to dense: its wall is dense's, not a
                        # sample of it
                        if realized != var:
                            fell_back.add(name)
                if defn.has_count_path:
                    t_count, _ = time_wall(
                        lambda: eng.run(defn, params, count_only=True), dev)
                    out(csv_row(f"calibrate/{name}_count_v{n}", t_count))
                    counts.setdefault(name, []).append(t_count)
        for name, defn in suite():
            params = dict(defn.example_params)
            stats = P.GraphStats.of(graphs[defn.requires_symmetric])
            spec = P.best_spec_for_engine(
                stats, P.specs_for(name, stats, **params), "local")
            modeled = P.estimate_local_cost(
                stats, spec, profile=P.CalibrationProfile())
            if np.isfinite(modeled):
                samples.setdefault(name, []).append(
                    (float(np.median(local[name])), modeled))
            if name in variants and name not in fell_back:
                samples.setdefault("_superstep_times", []).append(
                    {var: float(np.median(ts))
                     for var, ts in variants[name].items()})
            if name in counts:
                samples.setdefault("_count_times", []).append(
                    float(np.median(counts[name])))
        del graphs, engines
    return samples


def fit_profile(samples: dict, source: str = "repro_torch/launch/calibrate.py"
                ) -> P.CalibrationProfile:
    """The reference's fit (``algo_suite.emit_calibration``): per
    algorithm the median measured/modeled ratio; the interactive
    threshold ``max(10 * max(count times), 1e-3)``; per superstep
    variant ``dense factor * median(t_v / t_dense)``.  Empty samples
    give the analytic defaults."""
    scales = {}
    for name, pairs in samples.items():
        if name.startswith("_") or not pairs:
            continue
        ratios = sorted(t / m for t, m in pairs if m > 0)
        scales[name] = float(np.median(ratios))
    kwargs = {}
    count_times = samples.get("_count_times") or []
    if count_times:
        kwargs["interactive_threshold_s"] = float(
            max(10.0 * max(count_times), 1e-3))
    superstep = samples.get("_superstep_times") or []
    if superstep:
        fitted = {"dense": P._SUPERSTEP_EDGE_BYTES["dense"]}
        for var in ("fused", "frontier"):
            ratios = sorted(vt[var] / vt["dense"] for vt in superstep
                            if vt["dense"] > 0)
            if ratios:
                fitted[var] = float(fitted["dense"] * np.median(ratios))
        kwargs["superstep_edge_bytes"] = fitted
    return P.CalibrationProfile(algo_time_scale=scales, source=source,
                                **kwargs)


def card_name(device: torch.device) -> str:
    """``name, power limit`` as ``nvidia-smi`` reports the device (the
    host for a CPU run)."""
    if device.type != "cuda":
        return "cpu"
    smi = shutil.which("nvidia-smi")
    if smi is not None:
        q = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30)
        if q.returncode == 0 and q.stdout.strip():
            return q.stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(device)


def parse_scales(text: str) -> list:
    """``"2**18,2**20"`` or ``"2000,20000"`` -> vertex counts."""
    scales = []
    for item in text.split(","):
        base, _, exp = item.strip().partition("**")
        scales.append(int(base) ** int(exp) if exp else int(base))
    return scales


def main(argv: Optional[Sequence[str]] = None) -> P.CalibrationProfile:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scales", default="2**18,2**20",
                    help="comma-separated vertex counts (a**b allowed)")
    ap.add_argument("--out", default=P.reference_profile_path(),
                    help="where to write the profile (default: the "
                         "checked-in profile the planner auto-loads)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="passes of the sweep a scale; each sample is the "
                         "median of its walls over the passes")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    scales = parse_scales(args.scales)
    samples = collect_samples(scales, dev, repeats=args.repeats)
    profile = fit_profile(
        samples, source=(f"repro_torch/launch/calibrate.py --scales "
                         f"{args.scales} --repeats {args.repeats} on "
                         f"{card_name(dev)}"))
    profile.to_json(args.out)
    print(csv_row("calibrate/profile_written", 0.0,
                  f"path={args.out} algorithms={len(profile.algo_time_scale)}"))
    return profile


if __name__ == "__main__":
    main()
