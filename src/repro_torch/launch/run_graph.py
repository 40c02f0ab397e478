"""Graph-analytics job launcher — the platform CLI the paper's interface
layer would call.

    PYTHONPATH=src python -m repro_torch.launch.run_graph \\
        --job cc --vertices 20000 --count-only
    PYTHONPATH=src python -m repro_torch.launch.run_graph \\
        --job two-hop --vertices 5000 --device cpu

runs on ``cuda:0`` (raising without CUDA) unless ``--device`` names
another device.  ``--engine distributed`` runs the meshless distributed
engine: ``--n-data`` edge shards combined on that one device, as the
reference's CLI does.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import graph as G
from repro_torch.core.query import GraphQuery, GraphPlatform
from repro_torch.data import synthetic as S
from repro_torch.device import resolve_device


def _show(val):
    """A result for one log line: large tensors by shape only."""
    if isinstance(val, tuple):
        return tuple(_show(v) for v in val)
    if isinstance(val, torch.Tensor) and val.numel() > 8:
        return f"tensor{tuple(val.shape)}"
    return val


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--job", choices=["pagerank", "cc", "two-hop", "stats"],
                    default="cc")
    ap.add_argument("--vertices", type=int, default=20_000)
    ap.add_argument("--mean-degree", type=float, default=5.0)
    ap.add_argument("--count-only", action="store_true")
    ap.add_argument("--engine", choices=["auto", "local", "distributed"],
                    default="auto")
    ap.add_argument("--n-data", type=int, default=1,
                    help="edge shards for the distributed engine "
                         "(meshless: combined on one device)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n = args.vertices
    if args.job == "two-hop":
        u, i = S.safety_bipartite_graph(n, max(n // 4, 10), seed=0)
        coo = G.build_coo(u, i, int(max(u.max(), i.max())) + 1, device=dev)
        query = GraphQuery.two_hop(n_users=n, count_only=args.count_only)
    else:
        src, dst = S.user_follow_graph(n, args.mean_degree, seed=0)
        sym = args.job == "cc"
        coo = G.build_coo(src, dst, n, symmetrize=sym, device=dev)
        query = {"pagerank": GraphQuery.pagerank(),
                 "cc": GraphQuery.connected_components(
                     count_only=args.count_only),
                 "stats": GraphQuery.degree_stats()}[args.job]

    platform = GraphPlatform(
        coo, n_data=args.n_data,
        force_engine=None if args.engine == "auto" else args.engine,
        device=dev)
    plan = platform.plan(query)
    print(f"[plan] engine={plan.engine} | {plan.reason}")
    t0 = time.time()
    r = platform.query(query)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"[done] engine={r.engine} device={dev} iters={r.iterations} "
          f"wall={dt:.3f}s result={_show(r.value)}")
    return r


if __name__ == "__main__":
    main()
