#!/usr/bin/env python3
"""Time versions of the superstep and intersect kernels side by side on
one GPU, at the main path's shapes, each held to its plain version.

Run from the root of a checkout, on a host with one CUDA card::

    python3 compare_kernels.py --superstep A.cu B.cu:lanes \\
                               --intersect C.cu D.cu:lanes

Each argument is a CUDA source with the C entry point of
``kernels/pregel_superstep/csrc/superstep.cu`` (``pregel_superstep``) or
``kernels/ell_intersect/csrc/intersect.cu`` (``ell_intersect``), for
instance the checkout's own file, or an older or tentative version of it
(``git show REV:path > file``).  The entry points' last integer argument
is read two ways: by default as the checkout's wrappers pass it
(``ops._rows_per_tile`` for the superstep, ``ops._lanes_log2`` for
intersect); with the suffix ``:lanes`` as log2 of the lanes that share a
row or an edge, the launch rule both kernels had before they were
redesigned (the power of two at or above K/16, between 2 and 32).

Every source is built with nvcc (``kernels/_build.py``, all at once) and
checked first on the small layouts of ``chip_smoke.py`` (ragged rows,
masks with holes, misaligned rows, K up to 3000; intersect row pairs and
runs of one eu across warps and blocks): every superstep combination
bit-equal to ``superstep_plain`` (float sums within rtol 1e-5), every
count equal to the plain intersect.  Then each is timed (CUDA events,
``chip_smoke.cuda_ms``) on the V = 2^24 identifier graph of
``chip_smoke.py`` (seed 3) and on its copy under the seeded permutation
of ids (``chip_smoke.PERMUTATION_SEED``): the superstep's CC (int32 min)
and SSSP (x + w, min) over the uncapped in-ELL, intersect over the
OrientedELL.  The sources are timed in the order given and then in the
reverse order, in one process, so drift of the card shows as a
difference between the two passes.  One JSON line per reading; any
disagreement exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def lanes_log2(k: int) -> int:
    """The launch rule before the redesigns: log2 of the power of two at
    or above K/16, between 2 and 32."""
    target = min(-(-max(k, 1) // 16), 32)
    g = 1
    while (1 << g) < target:
        g += 1
    return g


class Variant:
    """One kernel source: its library and how its last argument is read."""

    def __init__(self, spec: str, entry: str):
        path, _, rule = spec.partition(":")
        if rule not in ("", "lanes"):
            raise SystemExit(f"unknown launch rule {rule!r} in {spec}")
        self.path = Path(path).resolve()
        if not self.path.is_file():
            raise SystemExit(f"no such source: {path}")
        self.name = spec
        self.entry = entry
        self.lanes = rule == "lanes"
        self.fn = None

    def build(self, index: int) -> None:
        import ctypes

        from repro_torch.kernels import _build
        lib = _build.load(f"compare_{self.entry}_{index}", [self.path])
        fn = getattr(lib, self.entry)
        fn.restype = ctypes.c_int
        if self.entry == "pregel_superstep":
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
                           + [ctypes.c_int] * 4
                           + [ctypes.c_double, ctypes.c_int,
                              ctypes.c_void_p])
        else:
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4
                           + [ctypes.c_int, ctypes.c_void_p])
        self.fn = fn

    def superstep(self, nbr, mask, w, x, *, message, op, identity,
                  message_dtype):
        import torch

        from repro_torch.kernels.pregel_superstep import ops
        from repro_torch.kernels.pregel_superstep.ref import fill_value
        V, K = nbr.shape
        out_dtype = ops.kernel_out_dtype(x, message, message_dtype)
        out = torch.empty(V, dtype=out_dtype, device=x.device)
        last = lanes_log2(K) if self.lanes else ops._rows_per_tile(K)
        rc = self.fn(nbr.data_ptr(), mask.data_ptr(), w.data_ptr(),
                     x.data_ptr(), out.data_ptr(), V, K, x.shape[0],
                     ops._DTYPES[x.dtype], ops.EDGE_PROGRAMS[message],
                     ops._OPS[op], ops._DTYPES[out_dtype],
                     float(fill_value(op, identity)), last,
                     torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc}")
        return out

    def intersect(self, nbr, eu, ev, sentinel):
        import torch

        from repro_torch.kernels.ell_intersect import ops as iops
        E, K = eu.shape[0], nbr.shape[1]
        out = torch.empty(E, dtype=torch.int32, device=nbr.device)
        last = lanes_log2(K) if self.lanes else iops._lanes_log2(K)
        rc = self.fn(nbr.data_ptr(), eu.data_ptr(), ev.data_ptr(),
                     out.data_ptr(), E, K, nbr.shape[0], int(sentinel), last,
                     torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc}")
        return out


def agrees(got, want, op) -> bool:
    import torch

    import chip_smoke as cs
    if op == "sum":
        return got.dtype == want.dtype and torch.allclose(
            got, want, rtol=1e-5, atol=0.0)
    return cs.bits_equal(got, want)


def check_supersteps(variants, gen) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.pregel_superstep.ref import superstep_plain
    layouts = [(f"ragged {v}x{k}",) + cs._ragged(v, k, gen)
               for v, k in ((1000, 37), (300, 1), (64, 0), (500, 33),
                            (2000, 200), (1000, 19), (1001, 20), (300, 128),
                            (40, 3000))]
    layouts += [(f"holes {v}x{k} off {off}",) + cs._holey(v, k, off, gen)[:3]
                for v, k, off in ((1000, 19, 3), (500, 129, 5),
                                  (40, 3000, 1))]
    for label, nbr, mask, w in layouts:
        for name, _, msg, op, md, ident in cs._combos():
            x = cs._state(name, nbr.shape[0], gen)
            kw = dict(message=msg, op=op, identity=ident, message_dtype=md)
            want = superstep_plain(nbr, mask, w, x, **kw)
            for var in variants:
                got = var.superstep(nbr, mask, w, x, **kw)
                torch.cuda.synchronize()
                if not agrees(got, want, op):
                    raise AssertionError(f"{var.name} disagrees on {label} "
                                         f"{name}")
    print(json.dumps({"checked": "superstep", "layouts": len(layouts),
                      "variants": [v.name for v in variants]}), flush=True)


def check_intersects(variants) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.ell_intersect.ref import ell_intersect_plain
    cases = []
    for k in (1, 8, 9, 16, 17, 31, 32, 33, 64):
        nbr, (eu, ev), vx = cs._runs(k)
        cases.append((f"runs K={k}", nbr, eu, ev, vx))
    for e, k, vx in ((16, 8, 40), (100, 37, 64), (64, 1, 10),
                     (700, 9, 300), (300, 31, 1000), (300, 32, 1000),
                     (40, 3000, 100000)):
        rng = np.random.default_rng(e * k)
        a, b = cs._ids(rng, e, k, vx), cs._ids(rng, e, k, vx)
        ids = np.arange(e, dtype=np.int32)
        cases.append((f"rows {e}x{k}", np.concatenate([a, b]), ids, ids + e,
                      vx))
    for label, nbr, eu, ev, vx in cases:
        tn, tu, tv = (torch.from_numpy(t).cuda() for t in (nbr, eu, ev))
        want = ell_intersect_plain(tn[tu.long()], tn[tv.long()], vx)
        for var in variants:
            got = var.intersect(tn, tu, tv, vx)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{var.name} disagrees on {label}")
    print(json.dumps({"checked": "intersect", "cases": len(cases),
                      "variants": [v.name for v in variants]}), flush=True)


def time_supersteps(variants, ell, perm, gen) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.pregel_superstep import ops
    from repro_torch.kernels.pregel_superstep.ref import superstep_plain
    combos = {c[0]: c for c in cs._combos()}
    layouts = (("identifier ids", ell),
               ("permuted ids", cs.permuted_in_ell(*ell, perm)))
    for label, (nbr, mask, w) in layouts:
        for combo in ("cc", "sssp"):
            name, _, msg, op, md, ident = combos[combo]
            x = cs._state(name, nbr.shape[0], gen)
            kw = dict(message=msg, op=op, identity=ident, message_dtype=md)
            want = superstep_plain(nbr, mask, w, x, **kw)
            reads_w = msg in (ops.msg_src_plus_w, ops.msg_src_times_w)
            bound, _ = cs._bound(mask, nbr.shape[0], reads_w, x, want,
                                 msg is not ops.msg_src)
            for p, order in enumerate((variants, variants[::-1])):
                for var in order:
                    got = var.superstep(nbr, mask, w, x, **kw)
                    torch.cuda.synchronize()
                    if not agrees(got, want, op):
                        raise AssertionError(f"{var.name} disagrees on the "
                                             f"2^24 in-ELL, {label} {combo}")
                    ms = cs.cuda_ms(lambda: var.superstep(nbr, mask, w, x,
                                                          **kw))
                    print(json.dumps({
                        "kernel": "pregel_superstep", "source": var.name,
                        "layout": f"in-ELL 2^24, {label}", "combo": combo,
                        "K": nbr.shape[1], "pass": p, "ms": ms,
                        "bound_ms": bound}), flush=True)
        del nbr, mask, w
    torch.cuda.empty_cache()


def time_intersects(variants, coo, perm) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.core import graph as G
    from repro_torch.kernels.ell_intersect.ref import \
        ell_intersect_counts_plain
    src, dst = cs._host_edges(coo)
    p = perm.cpu().numpy()
    for label, (s, d) in (("identifier ids", (src, dst)),
                          ("permuted ids", (p[src], p[dst]))):
        t0 = time.perf_counter()
        o = G.build_oriented_ell(s, d, coo.n_vertices)
        print(json.dumps({"built": f"OrientedELL 2^24, {label}",
                          "host_s": time.perf_counter() - t0}), flush=True)
        want = ell_intersect_counts_plain(o)
        E = o.n_edges
        for pss, order in enumerate((variants, variants[::-1])):
            for var in order:
                got = var.intersect(o.nbr, o.eu, o.ev, o.n_vertices)
                torch.cuda.synchronize()
                if not torch.equal(got[:E], want):
                    raise AssertionError(f"{var.name} disagrees on the 2^24 "
                                         f"OrientedELL, {label}")
                ms = cs.cuda_ms(lambda: var.intersect(o.nbr, o.eu, o.ev,
                                                      o.n_vertices))
                print(json.dumps({
                    "kernel": "ell_intersect", "source": var.name,
                    "layout": f"OrientedELL 2^24, {label}",
                    "K": o.nbr.shape[1], "pass": pss, "ms": ms}), flush=True)
        del o, want
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--superstep", nargs="*", default=[])
    ap.add_argument("--intersect", nargs="*", default=[])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_kernels: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    supersteps = [Variant(s, "pregel_superstep") for s in args.superstep]
    intersects = [Variant(s, "ell_intersect") for s in args.intersect]
    print(cs.card_line(), flush=True)
    errors = []

    def build(var, i):
        try:
            var.build(i)
        except Exception as e:        # reported below, in this thread
            errors.append(e)

    threads = [threading.Thread(target=build, args=(v, i))
               for i, v in enumerate(supersteps + intersects)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    from repro_torch.kernels import _build
    for i, var in enumerate(supersteps + intersects):
        report = _build.BUILD_LOG[f"compare_{var.entry}_{i}"]["log"]
        print(json.dumps({"built": var.name, "ptxas": [
            ln.split("ptxas info    : ")[-1] for ln in report.splitlines()
            if "Used " in ln or "spill" in ln]}), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    check_supersteps(supersteps, gen)
    check_intersects(intersects)
    coo = cs.identifier_graph(cs.MAIN_LOG2V, seed=3)
    perm_gen = torch.Generator(device="cuda")
    perm_gen.manual_seed(cs.PERMUTATION_SEED)
    perm = torch.randperm(2 ** cs.MAIN_LOG2V, generator=perm_gen,
                          device="cuda").int()
    if supersteps:
        ell = cs.in_ell(coo)
        time_supersteps(supersteps, (ell.nbr, ell.mask, ell.w), perm, gen)
        del ell
    if intersects:
        time_intersects(intersects, coo, perm)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
