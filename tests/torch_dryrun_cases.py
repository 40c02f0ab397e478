"""Worlds for ``tests/test_torch_dryrun.py`` (no ``test_`` prefix: not
collected): the dry run's counts and the graph dry run's bodies on a real
four-rank gloo world.

``rank_main`` is one rank of a four-rank gloo world on the CPU, on a
``(2, 2)`` mesh.  It counts one reduced train cell on real tensors
(``lower_cell(..., fake=False)``) and writes the counts, and runs the
graph dry run's three PageRank bodies on a real graph of ``V`` vertices,
writing the whole state after ``ITERS`` supersteps.  ``fake_counts``
counts the same cell as rank 0 of a fake world of 4 (meta tensors).
``reference_main`` compiles the reference's ``lower_pagerank`` and
``lower_pagerank_grid`` at ``V`` on a ``(2, 2)`` virtual mesh and runs
them on the same graph; it must start in a fresh interpreter with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set before JAX
starts.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

from torch_lm_mesh_cases import _env

WORLD = 4
TIMEOUT_S = 60.0
MESH = (2, 2)
V = 4096
E = 40_000
ITERS = 20
CELL = ("smollm-360m", "train", 32, 8)    # arch, kind, seq, global batch
MICROBATCHES = 2
VARIANTS = ("baseline_1d", "grid_2d", "grid_2d_bf16")


def graph():
    """``(src, dst, w)``: ``E`` random edges, ``w`` = 1 / out-degree."""
    rng = np.random.default_rng(3)
    src = rng.integers(0, V, E).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    deg = np.bincount(src, minlength=V)
    w = (1.0 / deg[src]).astype(np.float32)
    return src, dst, w


def layouts():
    """Per variant ``(n_edges for the lowering, src, dst, w)``: the global
    edge arrays, shard ``i = d * 2 + m`` at block ``i`` of ``e_shard``.
    The 1-D layout puts an edge in the model range of its destination;
    the grid in the data range of its source and the model range of its
    destination.  Padding: destination ``V`` (dropped), weight 0."""
    src, dst, w = graph()
    nd, nm = MESH
    half = V // 2
    out = {}
    for variant in VARIANTS:
        grid = variant != "baseline_1d"
        shards = [[] for _ in range(nd * nm)]
        for e in range(E):
            m = dst[e] // half
            d = src[e] // half if grid else e % nd
            shards[d * nm + m].append(e)
        e_shard = -(-max(len(s) for s in shards) // 1024) * 1024
        gs, gd, gw = (np.zeros(nd * nm * e_shard, np.int32),
                      np.full(nd * nm * e_shard, V, np.int32),
                      np.zeros(nd * nm * e_shard, np.float32))
        for i, s in enumerate(shards):
            sl = slice(i * e_shard, i * e_shard + len(s))
            gs[sl], gd[sl], gw[sl] = src[s], dst[s], w[s]
        out[variant] = (e_shard * nd * nm, gs, gd, gw)
    return out


def cell_shape():
    from repro_torch.configs.base import ShapeSpec
    arch, kind, s, b = CELL
    return arch, ShapeSpec("cell", kind, s, b)


def counts(rec: dict) -> dict:
    return {"flops": rec["counted"]["flops"],
            "coll_link_bytes": rec["counted"]["coll_link_bytes"],
            "coll_counts": rec["coll_counts"], "coll_raw": rec["coll_raw"]}


def fake_counts() -> dict:
    """The cell's counts as rank 0 of a fake world of 4 (meta tensors)."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as M
    arch, shape = cell_shape()
    with D.fake_world(WORLD):
        mesh = M.make_mesh(MESH, device_type="cpu", backend="fake")
        program, meta = D.lower_cell(arch, shape, mesh, reduced=True,
                                     microbatches=MICROBATCHES)
        return counts(D.analyze_cell(program, meta))


def rank_main(rank: int, world: int, init_method: str, outdir: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import graph_dryrun as GD
    from repro_torch.launch import mesh as M
    from repro_torch.utils import sharding as SH
    mesh = M.make_mesh(MESH, device_type="cpu", init_method=init_method,
                       world_size=world, rank=rank, timeout_s=TIMEOUT_S)
    out, meta = {}, {"rank": rank}
    t0 = time.perf_counter()
    arch, shape = cell_shape()
    program, cmeta = D.lower_cell(arch, shape, mesh, reduced=True,
                                  microbatches=MICROBATCHES, fake=False)
    meta["cell"] = counts(D.analyze_cell(program, cmeta))
    meta["seconds/cell"] = time.perf_counter() - t0
    d, m = (int(c) for c in mesh.get_coordinate())
    nd, nm = MESH
    half = V // 2
    for variant, (_, gs, gd, gw) in layouts().items():
        e_shard = gs.size // (nd * nm)
        sl = slice((d * nm + m) * e_shard, (d * nm + m + 1) * e_shard)
        src, dst, w = (torch.from_numpy(a[sl].copy()) for a in (gs, gd, gw))
        if variant == "baseline_1d":
            x = torch.full((half,), 1.0 / V)
            x = GD.pagerank_1d(mesh, src, dst, w, x, V, half, ITERS)
            whole = SH.gather(x, SH.P("model"), mesh)
        else:
            sdt = torch.bfloat16 if variant.endswith("bf16") \
                else torch.float32
            x = torch.full((half,), 1.0 / V, dtype=sdt)
            x = GD.pagerank_grid(mesh, src, dst, w, x, V, half, half, ITERS)
            whole = SH.gather(x, SH.P("data"), mesh)
        out[f"pagerank/{variant}"] = whole.float().numpy()
    meta["seconds/total"] = time.perf_counter() - t0
    dist.barrier()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


def run_world(outdir: str, timeout_s: float = 300.0) -> list:
    """Start ``WORLD`` ranks of ``rank_main`` in fresh interpreters,
    rendezvous through a file under ``outdir``; returns each rank's
    ``(returncode, output)``.  Every rank still running at the deadline
    is killed."""
    init = "file://" + os.path.join(outdir, "rendezvous")
    procs = []
    for r in range(WORLD):
        code = (f"import torch_dryrun_cases as c; "
                f"c.rank_main({r}, {WORLD}, {init!r}, {outdir!r})")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=_env(OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout_s
    got = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            o, _ = p.communicate()
            o = (o or "") + "\n[killed at the world's deadline]"
        got.append((p.returncode, o))
    return got


# ------------------------------------------------------------ the reference

def reference_main(outdir: str) -> None:
    """The reference's compiled PageRank lowerings at ``V`` on a ``(2,
    2)`` virtual mesh, run on the same graph, and their analytic terms."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as JP
    from repro.launch.graph_dryrun import lower_pagerank, lower_pagerank_grid
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(MESH), ("data", "model"))
    lowers = {"baseline_1d": lower_pagerank,
              "grid_2d": lower_pagerank_grid,
              "grid_2d_bf16": functools.partial(lower_pagerank_grid,
                                                state_bf16=True)}
    out, meta = {}, {}
    edge = NamedSharding(mesh, JP(("data", "model")))
    for variant, (n_edges, gs, gd, gw) in layouts().items():
        compiled, m = lowers[variant](mesh, V, n_edges, n_iters=ITERS)
        grid = variant != "baseline_1d"
        sdt = jnp.bfloat16 if variant.endswith("bf16") else jnp.float32
        x = jax.device_put(jnp.full((V,), 1.0 / V, sdt),
                           NamedSharding(mesh, JP("data" if grid
                                                  else "model")))
        got = compiled(jax.device_put(gs, edge), jax.device_put(gd, edge),
                       jax.device_put(gw, edge), x)
        out[f"pagerank/{variant}"] = np.asarray(got.astype(jnp.float32))
        meta[variant] = {k: v for k, v in m.items() if k != "compile_s"}
    meta["cells"] = reference_cells(mesh)
    np.savez(os.path.join(outdir, "reference.npz"), **out)
    with open(os.path.join(outdir, "reference.json"), "w") as f:
        json.dump(meta, f)


def reference_cells(mesh) -> dict:
    """For every arch (reduced) and shape of ``SHAPES``: whether the
    reference's ``shape_applicable`` runs it, its ``model_flops_for``,
    and the bytes of rank (0, 0)'s blocks of the train state's params
    and optimizer state under ``state_spec`` on ``mesh``.  Imported
    after the mesh is built: ``repro.launch.dryrun`` sets ``XLA_FLAGS``
    for 512 devices when imported, which JAX reads only at start."""
    import jax
    from jax.sharding import NamedSharding
    from repro.configs.base import (SHAPES, get_config, list_archs,
                                    reduced_config, shape_applicable)
    from repro.launch.dryrun import model_flops_for
    from repro.models.registry import build_model
    from repro.train.train_step import init_train_state, state_spec
    from repro.utils.tree import flatten_with_paths
    out = {}
    for arch in list_archs():
        cfg = reduced_config(get_config(arch))
        model = build_model(cfg)
        params_sds = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        rec = {"runs": {}, "model_flops": {}}
        for name, shape in SHAPES.items():
            rec["runs"][name] = shape_applicable(cfg, shape)[0]
            rec["model_flops"][name] = model_flops_for(cfg, model,
                                                       params_sds, shape)
        state = jax.eval_shape(lambda k: init_train_state(model, k),
                               jax.random.PRNGKey(0))
        spec = state_spec(model)
        for part in ("params", "opt"):
            specs = dict(flatten_with_paths(getattr(spec, part)))
            total = 0
            for leaf_name, leaf in flatten_with_paths(getattr(state, part)):
                shard = NamedSharding(mesh, specs[leaf_name]).shard_shape(
                    leaf.shape)
                total += int(np.prod(shard)) * leaf.dtype.itemsize
            rec[f"{part}_bytes"] = total
        out[arch] = rec
    return out


def start_reference(outdir: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", "import torch_dryrun_cases as c; "
         f"c.reference_main({outdir!r})"],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
