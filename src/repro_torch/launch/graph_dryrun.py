"""Graph-engine dry run at the paper's scale: would the distributed BSP
PageRank run, and fit, on the production meshes (the reference's
``launch/graph_dryrun.py``)?

    multi-account graph:      14.89 G vertices, 30.86 G edges
    combined connected users:  2.41 G vertices,  1.50 G edges

    PYTHONPATH=src python -m repro_torch.launch.graph_dryrun --mesh single
    PYTHONPATH=src python -m repro_torch.launch.graph_dryrun --mesh multi

Three torch bodies keep the reference's communication, each run SPMD on
a mesh of ``launch/mesh.py``:

* ``lower_pagerank`` (the 1-D baseline): ``x`` split over ``model``,
  all-gathered whole every superstep; edges split over every rank; the
  aggregates summed over the data axes.
* ``lower_pagerank_grid`` (the 2-D grid): shard ``(d, m)`` holds the
  edges with source in range ``d`` and destination in range ``m``; ``x``
  is held by source range over the data axes, so nothing gathers it;
  the new state, computed by destination range, goes back to source
  ranges through one all-reduce over ``model`` of a masked block (the
  reference's code; its docstring calls this reshard an all-to-all).
* ``state_bf16``: the grid with bf16 state (float32 messages).

``main`` runs each at both scales as rank 0 of a fake world
(``launch/dryrun.py``), on meta tensors, for ``--iters`` supersteps,
and records the reference's analytic terms a superstep (on the H100
constants of ``utils/roofline.py``; every axis of 16 ranks spans two
nodes of 8 and takes InfiniBand), the counted ones, and the peak bytes
a rank.  As in the reference, vertex ids are int32, so the 14.89 G
vertex count is taken modulo ``2**31 - 2`` (2,005,098,124), a quirk the
port copies: the edge count, which sets the cost, stays true.
"""
from __future__ import annotations

import argparse
import functools
import json
import os

import torch

from repro_torch.core.graph import round_up
from repro_torch.core.pregel import _all_gather, _all_reduce
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import n_chips
from repro_torch.utils import roofline as RL

WORKLOADS = {
    # paper scale, MaxAdjacentNodes=uncapped edge counts
    "multi_account_30.9B": dict(n_vertices=14_890_000_000 % (2**31 - 2),
                                n_edges=30_860_000_000),
    "connected_users_1.5B": dict(n_vertices=2_410_000_000 % (2**31 - 2),
                                 n_edges=1_500_000_000),
}


def _layout(mesh):
    sizes = dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))
    coord = dict(zip(mesh.mesh_dim_names,
                     (int(c) for c in mesh.get_coordinate())))
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    n_data = sizes.get("data", 1) * sizes.get("pod", 1)
    d_idx = coord.get("pod", 0) * sizes.get("data", 1) + coord.get("data", 0)
    return sizes, data_axes, n_data, sizes.get("model", 1), d_idx, \
        coord.get("model", 0)


def pagerank_1d(mesh, src, dst, w, x, n_vertices: int, v_local: int,
                n_iters: int):
    """The 1-D baseline's supersteps on this rank: ``src``/``dst``/``w``
    its edge shard, ``x`` its ``[v_local]`` block by ``model``."""
    sizes, data_axes, _, n_model, _, m_idx = _layout(mesh)
    V = n_vertices
    start = m_idx * v_local
    for _ in range(n_iters):
        full = _all_gather(x, mesh.get_group("model"), n_model) \
            if n_model > 1 else x
        msgs = full[torch.clamp(src, 0, full.shape[0] - 1)] * w
        local_dst = torch.where(dst >= V, v_local,
                                torch.clamp(dst - start, 0, v_local))
        agg = torch.zeros(v_local + 1, dtype=msgs.dtype, device=x.device)
        agg = agg.index_add_(0, local_dst.long(), msgs)[:v_local]
        for ax in data_axes:
            if sizes[ax] > 1:
                agg = _all_reduce(agg, "sum", mesh.get_group(ax))
        x = 0.15 / V + 0.85 * agg
        del full, msgs           # before the next superstep's gather
    return x


def pagerank_grid(mesh, src, dst, w, x_d, n_vertices: int, v_loc_d: int,
                  v_loc_m: int, n_iters: int):
    """The 2-D grid's supersteps on this rank: ``x_d`` its ``[v_loc_d]``
    block by source range (bf16 or float32: messages are float32)."""
    sizes, data_axes, _, n_model, d_idx, m_idx = _layout(mesh)
    V = n_vertices
    sdt = x_d.dtype
    src_start, dst_start = d_idx * v_loc_d, m_idx * v_loc_m
    for _ in range(n_iters):
        local_src = torch.clamp(src - src_start, 0, v_loc_d - 1)
        msgs = x_d[local_src].float() * w
        local_dst = torch.where(dst >= V, v_loc_m,
                                torch.clamp(dst - dst_start, 0, v_loc_m))
        agg = torch.zeros(v_loc_m + 1, dtype=torch.float32, device=w.device)
        agg = agg.index_add_(0, local_dst.long(), msgs)[:v_loc_m]
        for ax in data_axes:
            if sizes[ax] > 1:
                agg = _all_reduce(agg, "sum", mesh.get_group(ax))
        new_m = (0.15 / V + 0.85 * agg).to(sdt)
        mine = new_m if m_idx == d_idx else torch.zeros_like(new_m)
        new_d = _all_reduce(mine, "sum", mesh.get_group("model")) \
            if n_model > 1 else mine
        if v_loc_d != v_loc_m:
            new_d = new_d[:v_loc_d]
        x_d = new_d
    return x_d


def _shard_tensors(e_shard: int, v_len: int, sdt, device):
    return (torch.zeros(e_shard, dtype=torch.int32, device=device),
            torch.zeros(e_shard, dtype=torch.int32, device=device),
            torch.zeros(e_shard, dtype=torch.float32, device=device),
            torch.zeros(v_len, dtype=sdt, device=device))


def lower_pagerank_grid(mesh, n_vertices: int, n_edges: int,
                        n_iters: int = 20, state_bf16: bool = False):
    """The 2-D grid on ``mesh``, on meta tensors of the production scale:
    ``(program, meta)`` with the reference's analytic terms a superstep
    (``flops``, ``bytes``, ``coll_bytes``)."""
    _, _, n_data, n_model, _, _ = _layout(mesh)
    e_shard = round_up(-(-n_edges // (n_data * n_model)), 1024)
    v_loc_d = round_up(-(-n_vertices // n_data), 8)     # x by src range
    v_loc_m = round_up(-(-n_vertices // n_model), 8)    # agg by dst range
    sdt = torch.bfloat16 if state_bf16 else torch.float32
    src, dst, w, x = _shard_tensors(e_shard, v_loc_d, sdt, "meta")
    program = D.Program(
        functools.partial(pagerank_grid, mesh, src, dst, w, x, n_vertices,
                          v_loc_d, v_loc_m, n_iters),
        {"edges": [src, dst, w], "state": [x]})
    sb = 2 if state_bf16 else 4
    return program, {
        "e_shard": e_shard, "v_local": v_loc_m, "chips": n_chips(mesh),
        "flops": 2.0 * e_shard + 5.0 * v_loc_d,
        "bytes": e_shard * 12 + (v_loc_d + v_loc_m) * 2 * sb,
        # psum of dst aggregates (f32, ring over data) + masked-psum
        # reshard (state dtype, ring over model) — both O(V/16)
        "coll_bytes": (v_loc_m * 4 * 2 * (n_data - 1) / n_data
                       + v_loc_m * sb * 2 * (n_model - 1) / n_model),
    }


def lower_pagerank(mesh, n_vertices: int, n_edges: int, n_iters: int = 20,
                   vertex_sharded: bool = True):
    """The 1-D baseline on ``mesh``, on meta tensors of the production
    scale: ``(program, meta)`` with the reference's analytic terms a
    superstep."""
    _, _, n_data, n_model, _, _ = _layout(mesh)
    e_shard = round_up(-(-n_edges // (n_data * n_model)), 1024)
    v_local = round_up(-(-n_vertices // n_model), 8)
    V = n_vertices
    src, dst, w, x = _shard_tensors(e_shard, v_local, torch.float32, "meta")
    program = D.Program(
        functools.partial(pagerank_1d, mesh, src, dst, w, x, n_vertices,
                          v_local, n_iters),
        {"edges": [src, dst, w], "state": [x]})
    return program, {
        "e_shard": e_shard, "v_local": v_local, "chips": n_chips(mesh),
        # analytic per-superstep terms, per chip
        "flops": 2.0 * e_shard + 5.0 * v_local,
        "bytes": e_shard * 12 + v_local * 16 + V * 4,   # edges + state + gathered x
        "coll_bytes": (V * 4 * (n_model - 1) / n_model          # all_gather x
                       + v_local * 4 * 2 * (n_data - 1) / n_data),  # psum agg
    }


def analyze(program, meta: dict, n_iters: int) -> dict:
    """Run ``program`` under the dry run's counters: the reference's
    record (analytic terms a superstep, the dominant one, GB a rank)
    and the counted terms a superstep beside them."""
    got = D.measure(program)
    coll = got["coll"]
    per_step = {
        "compute_s": meta["flops"] / RL.PEAK_FLOPS_BF16,
        "memory_s": meta["bytes"] / RL.HBM_BW,
        # every axis of the production meshes spans nodes: InfiniBand
        "collective_s": meta["coll_bytes"] / RL.IB_BW,
    }
    dom = max(per_step, key=per_step.get)
    return {
        **meta, **per_step, "dominant": dom,
        "mem_per_dev_gb": got["memory"]["peak"] / 1e9,
        "edges_gb": got["memory"]["edges"] / 1e9,
        "counted": {
            "flops": got["flops"] / n_iters, "bytes": got["bytes"] / n_iters,
            "coll_link_bytes": coll.total_link_bytes / n_iters,
            "collective_s": coll.seconds / n_iters,
            "coll_counts": {k: v / n_iters for k, v in coll.counts.items()}},
    }


VARIANTS = (("baseline_1d", lower_pagerank),
            ("grid_2d", lower_pagerank_grid),
            ("grid_2d_bf16", functools.partial(lower_pagerank_grid,
                                               state_bf16=True)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="build/graph_dryrun.json")
    args = ap.parse_args(argv)
    multi = args.mesh == "multi"
    results = {}
    with D.fake_world(512 if multi else 256):
        mesh = D.production_mesh(multi)
        for name, w in WORKLOADS.items():
            for variant, lower in VARIANTS:
                program, meta = lower(mesh, w["n_vertices"], w["n_edges"],
                                      n_iters=args.iters)
                rr = analyze(program, meta, args.iters)
                results[f"{name}/{variant}"] = rr
                print(f"{name}/{variant}: chips={meta['chips']} "
                      f"e_shard={meta['e_shard']:,} "
                      f"mem/dev={rr['mem_per_dev_gb']:.2f}GB "
                      f"dominant={rr['dominant']} "
                      f"superstep={max(rr['compute_s'], rr['memory_s'], rr['collective_s']) * 1e3:.2f}ms",
                      flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2, default=str)
    return results


if __name__ == "__main__":
    main()
