#!/usr/bin/env python3
"""Time versions of the superstep and intersect kernels side by side on
one GPU, at the main path's shapes, each held to its plain version.

Run from the root of a checkout, on a host with one CUDA card::

    python3 compare_kernels.py --superstep A.cu B.cu:lanes \\
                               --batched A.cu E.cu \\
                               --intersect C.cu D.cu:lanes

Each argument is a CUDA source with the C entry point of
``kernels/pregel_superstep/csrc/superstep.cu`` (``pregel_superstep`` for
``--superstep``, ``pregel_superstep_batched`` for ``--batched``) or
``kernels/ell_intersect/csrc/intersect.cu`` (``ell_intersect``), for
instance the checkout's own file, or an older or tentative version of it
(``git show REV:path > file``).  The entry points' launch arguments are
read two ways: by default as the checkout's wrappers pass them
(``ops._rows_per_tile`` for the superstep, ``ops._batched_geometry`` for
the batched entry, ``ops._lanes_log2`` for intersect); with the suffix
``:lanes`` the last integer is log2 of the lanes that share a row or an
edge, the launch rule both 1-D kernels had before they were redesigned
(the power of two at or above K/16, between 2 and 32).  A batched source
whose entry takes no launch geometry in its signature (the warp-per-row
design before the tiled one) is called without it.

``--batched`` checks every source on the small layouts at widths 1, 3,
4, 8, 16, 33 and 64 (and a state whose rows are 4 bytes off 16-byte
alignment) against ``superstep_plain`` and against each other: every
combination, float sums included, bit-equal across the sources.  It then
times BFS, SSSP and a weighted sum over ``[V, 8]`` state on the 2^24
in-ELL and ``[V, 16]`` state on the 2^20 one (``chip_smoke.py``'s graphs
of seeds 3 and 0), each under identifier and permuted ids.

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


def _takes_geometry(source: str) -> bool:
    """Whether a source's ``pregel_superstep_batched`` takes the launch
    geometry of ``ops._batched_geometry`` (the warp-per-row design's did
    not)."""
    head = source.partition('extern "C" int pregel_superstep_batched(')[2]
    return "rows_per_tile" in head.partition(")")[0]


class Variant:
    """One kernel source: its library and how its last argument is read."""

    def __init__(self, spec: str, entry: str):
        path, _, rule = spec.partition(":")
        rules = ("",) if entry == "pregel_superstep_batched" \
            else ("", "lanes")
        if rule not in rules:
            raise SystemExit(f"unknown launch rule {rule!r} in {spec}")
        self.path = Path(path).resolve()
        if not self.path.is_file():
            raise SystemExit(f"no such source: {path}")
        self.name = spec
        self.entry = entry
        self.lanes = rule == "lanes"
        # a batched entry whose signature takes the launch geometry
        self.geometry = entry == "pregel_superstep_batched" \
            and _takes_geometry(self.path.read_text())
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
        elif self.entry == "pregel_superstep_batched":
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4
                           + [ctypes.c_int] * 4 + [ctypes.c_double]
                           + [ctypes.c_int] * (5 if self.geometry else 0)
                           + [ctypes.c_void_p])
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

    def batched(self, nbr, mask, w, x, *, message, op, identity,
                message_dtype):
        import torch

        from repro_torch.kernels.pregel_superstep import ops
        from repro_torch.kernels.pregel_superstep.ref import fill_value
        V, K = nbr.shape
        out_dtype = ops.kernel_out_dtype(x, message, message_dtype)
        out = torch.empty((V, x.shape[1]), dtype=out_dtype, device=x.device)
        geo = ops._batched_geometry(
            x.shape[1], K,
            x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0) \
            if self.geometry else ()
        rc = self.fn(nbr.data_ptr(), mask.data_ptr(), w.data_ptr(),
                     x.data_ptr(), out.data_ptr(), V, K, x.shape[0],
                     x.shape[1], ops._DTYPES[x.dtype],
                     ops.EDGE_PROGRAMS[ops.base_program(message)],
                     ops._OPS[op], ops._DTYPES[out_dtype],
                     float(fill_value(op, identity)), *geo,
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
    if op == "sum" and got.dtype != torch.int32:
        return got.dtype == want.dtype and torch.allclose(
            got, want, rtol=1e-5, atol=0.0)
    return cs.bits_equal(got, want)


def ptxas_by_kernel(log):
    """nvcc's ``-Xptxas -v`` report, by kernel name (the template
    instances of one kernel together): the range of registers a thread
    and the most bytes spilled."""
    import re
    kernels, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            names = re.findall(r"[a-z][a-z_]*_kernel", m.group(1))
            name = names[-1] if names else m.group(1)
            continue
        if name is None:
            continue
        k = kernels.setdefault(name, {"registers": [], "spill_bytes": 0})
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            k["registers"].append(int(m.group(1)))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            k["spill_bytes"] = max(k["spill_bytes"], int(m.group(1)),
                                   int(m.group(2)))
    return {n: {"registers": [min(k["registers"]), max(k["registers"])],
                "spill_bytes": k["spill_bytes"]}
            for n, k in kernels.items() if k["registers"]}


def superstep_bound(mask, x, out, message):
    """``chip_smoke._bound`` of one superstep call (either entry): the
    least time in ms and what bounds it."""
    import chip_smoke as cs
    from repro_torch.kernels.pregel_superstep import ops
    program = ops.base_program(message)
    reads_w = program in (ops.msg_src_plus_w, ops.msg_src_times_w)
    return cs._bound(mask, reads_w, x, out, program is not ops.msg_src)


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
            bound, _ = superstep_bound(mask, x, want, msg)
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


#: the batched entry's widths on the small layouts
BATCHED_WIDTHS = (1, 3, 4, 8, 16, 33, 64)


def _batched_x(kind, vx, b, gen, misaligned=False):
    """[vx, b] state of chip_smoke's kind, contiguous; ``misaligned``:
    a view 4 bytes past a 16-byte boundary."""
    import torch

    import chip_smoke as cs
    x = torch.stack([cs._state(kind, vx, gen) for _ in range(b)],
                    dim=1).contiguous()
    return cs._misaligned(x) if misaligned else x


def _run_batched(variants, label, nbr, mask, w, x, kw):
    """Every source on one input: each agrees with the plain version, and
    all give the same bytes (float sums too: one slot order).  Returns
    the plain output."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.pregel_superstep.ref import superstep_plain
    want = cs._plain_by_rows(superstep_plain, nbr, mask, w, x, **kw)
    first = None
    for var in variants:
        got = var.batched(nbr, mask, w, x, **kw)
        torch.cuda.synchronize()
        if not agrees(got, want, kw["op"]):
            raise AssertionError(f"{var.name} disagrees with the plain "
                                 f"version on {label}")
        if first is None:
            first = (var.name, got)
        elif not cs.bits_equal(got, first[1]):
            raise AssertionError(f"{var.name} and {first[0]} differ in "
                                 f"bytes on {label}")
    return want


def check_batched(variants, gen) -> None:
    from repro_torch.core.pregel import Lifted

    import chip_smoke as cs
    layouts = [(f"ragged {v}x{k}",) + cs._ragged(v, k, gen)
               for v, k in ((1000, 37), (300, 1), (64, 0), (2000, 200),
                            (1001, 20), (40, 3000))]
    layouts += [(f"holes {v}x{k} off {off}",) + cs._holey(v, k, off, gen)[:3]
                for v, k, off in ((1000, 19, 3), (500, 129, 5),
                                  (40, 3000, 1))]
    n = 0
    for label, nbr, mask, w in layouts:
        for b in BATCHED_WIDTHS:
            for name, _, msg, op, md, ident in cs._batched_combos():
                kind = {"cc_max": "cc", "sssp_max": "sssp"}.get(name, name)
                kw = dict(message=Lifted(msg, (-1, None)), op=op,
                          identity=ident, message_dtype=md)
                for misaligned in ((False, True) if b in (4, 8) and
                                   label.startswith("holes") else (False,)):
                    x = _batched_x(kind, nbr.shape[0] + 2, b, gen,
                                   misaligned)
                    _run_batched(variants, f"{label} B={b} {name}"
                                 f"{' x off 4 B' if misaligned else ''}",
                                 nbr, mask, w, x, kw)
                    n += 1
    print(json.dumps({"checked": "pregel_superstep_batched", "cases": n,
                      "widths": BATCHED_WIDTHS,
                      "variants": [v.name for v in variants]}), flush=True)


def time_batched(variants, shapes, gen) -> None:
    """``shapes``: (label, (nbr, mask, w), B) of the timed layouts."""
    import torch

    import chip_smoke as cs
    from repro_torch.core.pregel import Lifted
    combos = {c[0]: c for c in cs._combos()}
    for label, (nbr, mask, w), b in shapes:
        for combo in ("bfs", "sssp", "spmv"):
            name, _, msg, op, md, ident = combos[combo]
            x = _batched_x(name, nbr.shape[0], b, gen)
            kw = dict(message=Lifted(msg, (-1, None)), op=op,
                      identity=ident, message_dtype=md)
            want = _run_batched(variants, f"{label} x {b} {combo}", nbr,
                                mask, w, x, kw)
            bound, _ = superstep_bound(mask, x, want, kw["message"])
            for p, order in enumerate((variants, variants[::-1])):
                for var in order:
                    ms = cs.cuda_ms(lambda: var.batched(nbr, mask, w, x,
                                                        **kw))
                    print(json.dumps({
                        "kernel": "pregel_superstep_batched",
                        "source": var.name, "layout": label, "B": b,
                        "combo": combo, "K": nbr.shape[1], "pass": p,
                        "ms": ms, "bound_ms": bound}), flush=True)
            del x, want
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


def _perm(log2v):
    """The seeded permutation of 2^log2v ids (``chip_smoke``'s)."""
    import torch

    import chip_smoke as cs
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.PERMUTATION_SEED)
    return torch.randperm(2 ** log2v, generator=gen, device="cuda").int()


def _id_layouts(ell, log2v, b):
    """The in-ELL at width ``b`` under identifier and permuted ids (a
    generator: the permuted copy is built when its turn comes)."""
    import chip_smoke as cs
    yield (f"in-ELL 2^{log2v}, identifier ids", (ell.nbr, ell.mask, ell.w),
           b)
    yield (f"in-ELL 2^{log2v}, permuted ids",
           cs.permuted_in_ell(ell.nbr, ell.mask, ell.w, _perm(log2v)), b)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--superstep", nargs="*", default=[])
    ap.add_argument("--batched", nargs="*", default=[])
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
    batched = [Variant(s, "pregel_superstep_batched") for s in args.batched]
    intersects = [Variant(s, "ell_intersect") for s in args.intersect]
    variants = supersteps + batched + intersects
    print(cs.card_line(), flush=True)
    errors = []

    def build(var, i):
        try:
            var.build(i)
        except Exception as e:        # reported below, in this thread
            errors.append(e)

    threads = [threading.Thread(target=build, args=(v, i))
               for i, v in enumerate(variants)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    from repro_torch.kernels import _build
    for i, var in enumerate(variants):
        built = _build.BUILD_LOG[f"compare_{var.entry}_{i}"]
        print(json.dumps({"built": var.name, "seconds": built["seconds"],
                          "ptxas": ptxas_by_kernel(built["log"])}),
              flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    check_supersteps(supersteps, gen)
    if batched:
        check_batched(batched, gen)
    check_intersects(intersects)
    if batched:
        g20 = cs.identifier_graph(cs.PHASE3_LOG2V, seed=0)
        ell = cs.in_ell(g20)
        del g20
        time_batched(batched, _id_layouts(ell, cs.PHASE3_LOG2V,
                                          cs.BATCH_WIDTH), gen)
        del ell
        torch.cuda.empty_cache()
    if not (supersteps or batched or intersects):
        return 0
    coo = cs.identifier_graph(cs.MAIN_LOG2V, seed=3)
    perm = _perm(cs.MAIN_LOG2V)
    if supersteps or batched:
        ell = cs.in_ell(coo)
        if supersteps:
            time_supersteps(supersteps, (ell.nbr, ell.mask, ell.w), perm,
                            gen)
        if batched:
            time_batched(batched, _id_layouts(ell, cs.MAIN_LOG2V,
                                              cs.SERVICE_TICKETS), gen)
        del ell
        torch.cuda.empty_cache()
    if intersects:
        time_intersects(intersects, coo, perm)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
