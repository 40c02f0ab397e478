"""Both packages side by side, for the mirrors of the service tier's
tests (``tests/test_torch_{service_tier,pools,obs,incremental,registry,
service_runtime,planner}.py`` and their ``*_properties.py``).

A mirror writes the reference test's body once, as a function of a
package namespace ``M`` (``REF``: the JAX package; ``PORT``: the port on
CPU tensors), keeps the reference's own assertions (they hold for both
packages) and records what the two must agree on.  ``both(case, ...)``
runs the case on each package and holds the two records to the North
star's contract (ROADMAP.md): values byte for byte (dtype, shape and
bytes), floats exactly, ``approx`` entries (PageRank, HITS) within the
tolerance they carry, and plans, decisions, ledgers and metrics (wall
times taken out) entry for entry.

Both packages run on the host; the port is asked for it with
``device="cpu"`` at every entry point that places data (``build_coo``,
the engines, the platform, the service's ``add_graph``), through the
thin subclasses below.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
import types

import numpy as np
import torch

CPU = "cpu"

_MODULES = {
    "G": "core.graph", "P": "core.planner", "R": "core.registry",
    "PL": "core.pools", "RT": "core.runtime", "OBS": "core.obs",
    "SV": "core.service", "Q": "core.query", "E": "core.engines",
    "PR": "core.pregel", "S": "data.synthetic", "ETL": "data.etl",
}


def _namespace(pkg: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(name=pkg)
    for key, mod in _MODULES.items():
        setattr(ns, key, importlib.import_module(f"{pkg}.{mod}"))
    ns.alg = lambda name: importlib.import_module(
        f"{pkg}.core.algorithms.{name}")
    ns.GraphQuery = ns.Q.GraphQuery
    ns.Engine = ns.E.Engine
    ns.AdmissionRejected = ns.SV.AdmissionRejected
    ns.QueryTicket = ns.SV.QueryTicket
    ns.Backpressure = ns.RT.Backpressure
    ns.RetryPolicy = ns.RT.RetryPolicy
    ns.LatencyHistogram = ns.RT.LatencyHistogram
    ns.SnapshotStore = ns.ETL.SnapshotStore
    ns.SnapshotDelta = ns.ETL.SnapshotDelta
    ns.Snapshot = ns.ETL.Snapshot
    return ns


REF = _namespace("repro")
PORT = _namespace("repro_torch")
REF.build_coo = REF.G.build_coo
REF.LocalEngine = REF.E.LocalEngine
REF.DistributedEngine = REF.E.DistributedEngine
REF.GraphPlatform = REF.Q.GraphPlatform
REF.GraphAnalyticsService = REF.SV.GraphAnalyticsService


def _port_build_coo(*a, device=CPU, **kw):
    return PORT.G.build_coo(*a, device=device, **kw)


class _PortLocal(PORT.E.LocalEngine):
    def __init__(self, coo, *a, device=CPU, **kw):
        super().__init__(coo, *a, device=device, **kw)


class _PortDistributed(PORT.E.DistributedEngine):
    def __init__(self, coo, *a, device=CPU, **kw):
        super().__init__(coo, *a, device=device, **kw)


class _PortPlatform(PORT.Q.GraphPlatform):
    def __init__(self, coo, *a, device=CPU, **kw):
        super().__init__(coo, *a, device=device, **kw)


class _PortService(PORT.SV.GraphAnalyticsService):
    def add_graph(self, *a, device=CPU, **kw):
        return super().add_graph(*a, device=device, **kw)


PORT.build_coo = _port_build_coo
PORT.LocalEngine = _PortLocal
PORT.DistributedEngine = _PortDistributed
PORT.GraphPlatform = _PortPlatform
PORT.GraphAnalyticsService = _PortService

PACKAGES = (REF, PORT)


class Pair(dict):
    """One fixture value per package, keyed by the namespace's name."""

    @classmethod
    def build(cls, fn):
        return cls({M.name: fn(M) for M in PACKAGES})


def pin_analytic():
    """Both planners on their analytic constants."""
    REF.P.set_calibration(None)
    PORT.P.set_calibration(None)


# ---------------------------------------------------------------- records

@dataclasses.dataclass(frozen=True)
class Approx:
    """A float array compared within ``tol`` (absolute) across packages."""
    value: np.ndarray
    tol: float


def host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def approx(x, tol: float) -> Approx:
    return Approx(np.asarray(host(x), np.float64), tol)


# keys the two packages do not share: host-clock readings, the port's
# own ``realized_variant`` (the superstep variant that ran) and its own
# ``timeline`` (host seconds, host syncs and device time of an execution)
_UNSHARED_KEYS = frozenset({"wall_s", "t0", "t1", "duration_s", "wait_s",
                         "queued_at", "ts", "dur", "elapsed_s",
                         "realized_variant", "timeline"})


def norm(x):
    """A package-neutral, comparable form of ``x``."""
    if isinstance(x, Approx):
        return x
    if x is None or isinstance(x, (bool, str, bytes)):
        return x
    if isinstance(x, (int, np.integer)) and not isinstance(x, bool):
        return ("int", int(x))
    if isinstance(x, (float, np.floating)):
        return ("float", float(x))
    if isinstance(x, torch.Tensor) or hasattr(x, "__array__"):
        a = np.ascontiguousarray(host(x))
        return ("array", a.dtype.str, a.shape, a.tobytes())
    if isinstance(x, dict):
        return ("dict", tuple((str(k), norm(v)) for k, v in
                              sorted(x.items(), key=lambda kv: str(kv[0]))))
    if isinstance(x, (list, tuple)):
        return ("seq", tuple(norm(v) for v in x))
    if isinstance(x, (set, frozenset)):
        return ("set", tuple(sorted(repr(norm(v)) for v in x)))
    if isinstance(x, BaseException):
        return ("exception", type(x).__name__)
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, tuple(
            (f.name, norm(getattr(x, f.name)))
            for f in dataclasses.fields(x)))
    raise TypeError(f"no package-neutral form for {type(x).__name__}")


def result(r, *, tol=None):
    """A ``QueryResult``'s comparable parts: value (within ``tol`` for
    float fixpoints), engine, iterations and its meta without host-clock
    readings and the port's ``realized_variant``."""
    meta = {k: v for k, v in r.meta.items()
            if k not in _UNSHARED_KEYS}
    if "superstep" in meta:
        meta["superstep"] = unclocked(meta["superstep"])
    value = r.value if tol is None else approx_tree(r.value, tol)
    return {"value": value, "engine": r.engine,
            "iterations": r.iterations, "meta": meta}


def approx_tree(v, tol):
    """``v`` (an array, or a dict or tuple of them) within ``tol``."""
    if isinstance(v, dict):
        return {k: approx_tree(x, tol) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(approx_tree(x, tol) for x in v)
    return approx(v, tol)


def unclocked(x):
    """``x`` with host-clock readings (seconds, latencies) taken out."""
    if isinstance(x, dict):
        return {k: unclocked(v) for k, v in x.items()
                if k not in _UNSHARED_KEYS and not _is_clock_key(k)}
    if isinstance(x, (list, tuple)):
        return type(x)(unclocked(v) for v in x)
    return x


def _is_clock_key(k) -> bool:
    k = str(k)
    return k.endswith(("_s", "_ms")) and any(
        t in k for t in ("wall", "latency", "wait", "p50", "p99", "mean",
                         "max_s", "sum", "duration", "sleep"))


def same(a, b, path="record"):
    """Assert two ``norm``-ed records agree (``Approx`` within tol)."""
    if isinstance(a, Approx) or isinstance(b, Approx):
        assert isinstance(a, Approx) and isinstance(b, Approx), path
        assert a.value.shape == b.value.shape, (path, a.value.shape,
                                                b.value.shape)
        np.testing.assert_allclose(b.value, a.value, rtol=0,
                                   atol=max(a.tol, b.tol), err_msg=path)
        return
    if isinstance(a, tuple) and isinstance(b, tuple):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
        return
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return
    assert a == b, (path, a, b)


def both(case, *args, **kw):
    """Run ``case(M, *args, **kw)`` on each package (a ``Pair`` argument
    gives each its own value), hold the two records to each other and
    return them as ``(reference's, port's)``."""
    recs = []
    for M in PACKAGES:
        a = [x[M.name] if isinstance(x, Pair) else x for x in args]
        k = {n: (x[M.name] if isinstance(x, Pair) else x)
             for n, x in kw.items()}
        recs.append(case(M, *a, **k))
    same(norm(recs[0]), norm(recs[1]))
    return recs


def raised(fn, *a, **kw):
    """The exception type name ``fn`` raised (None if it returned)."""
    try:
        fn(*a, **kw)
    except Exception as e:            # the record is the type alone
        return type(e).__name__
    return None


def bits(v):
    """Canonical bytes of a result value (arrays, scalars, dicts,
    tuples), as the reference's tests take them."""
    if isinstance(v, dict):
        return b"{" + b";".join(
            str(k).encode() + b"=" + bits(v[k]) for k in sorted(v)) + b"}"
    if isinstance(v, (tuple, list)):
        return b"(" + b";".join(bits(x) for x in v) + b")"
    return np.ascontiguousarray(host(v)).tobytes()


def plan_rec(plan):
    """A plan's choices and prices (the fields both packages compute)."""
    return {"engine": plan.engine, "variant": plan.variant,
            "pool": plan.pool, "mode": plan.mode, "est_s": plan.est_s,
            "est_local_s": plan.est_local_s, "est_dist_s": plan.est_dist_s,
            "transfer_s": plan.transfer_s, "reason": plan.reason,
            "candidates": plan.candidates}


def edges(g):
    """Host copies of a graph's live ``(src, dst, w)``."""
    n = g.n_edges
    return host(g.src)[:n], host(g.dst)[:n], host(g.w)[:n]
