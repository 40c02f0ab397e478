"""Worlds for ``tests/test_torch_lm_mesh.py`` (no ``test_`` prefix: not
collected): the port's LM on a device mesh.

``rank_main`` is one rank of a four-rank gloo world on the CPU.  On a
``(2, 2)`` mesh over ``("data", "model")`` and a ``(4, 1)`` one it runs
ring attention, the train step (dense and MoE, microbatches 1 and 2,
compression none, int8 and top-k), sharded serving of the six families,
a ring prefill, the checkpoint round trip across mesh shapes, the
refusals (``act_spec``, the ring under autograd) and a rank that skips a
collective, and writes what it got to ``rank{r}.npz`` / ``.json``.
``reference_main`` runs the JAX package's side on 8 virtual devices
(``devices_indices_map``, ``attn_ring``, ``make_train_step`` under
GSPMD with the same specs; greedy serving) in two parts and writes
``reference_<part>.npz`` / ``.json``; it must start in a fresh interpreter with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` set before JAX
starts.  Both sides take the same weights: the port's ``init_params``
from a seeded generator, as numpy arrays.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

WORLD = 4
TIMEOUT_S = 60.0                 # every process group of the world
SKIP_TIMEOUT_S = 5.0             # the mesh whose rank 1 skips a step
ROOT = Path(__file__).resolve().parents[1]
AXES = ("data", "model")
LR = 1e-3
TOPK = 0.25
S = 16
B_TRAIN = 8
B_SERVE = 4
GEN = 6

# shard_index against devices_indices_map: meshes and (shape, spec) pairs
SHARD_MESHES = {"1x1": ((1, 1), AXES), "2x2": ((2, 2), AXES),
                "4x1": ((4, 1), AXES), "1x4": ((1, 4), AXES),
                "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
SHARD_SPECS = (
    ((8, 6), ("data", "model")), ((8, 6), ("model", "data")),
    ((4, 64, 32), (None, "data", "model")), ((4, 32, 64), (None, "model",
                                                           "data")),
    ((16, 8), (("data", "model"), None)), ((16, 8), (("model", "data"),)),
    ((8,), (None,)), ((), ()), ((6, 4), ("data", None)),
    ((5, 4), ("data",)), ((8, 6), ("model", None)),
    ((8, 8), (("pod", "data"), "model")), ((8, 8), (("data", "pod"),
                                                   "model")),
    ((2, 8, 4), (None, ("pod", "data"), "model")), ((8, 4), ("pod",)),
    ((4, 4), ("data", "data")),
)

RING_SHAPE = (4, 64, 6, 2, 32)       # B, S, Hq, Hkv, Dh (the reference test's)
RING_CHUNK = 16
RING_CASES = {"causal": dict(causal=True),
              "window17": dict(causal=True, window=17),
              "softcap20": dict(causal=True, softcap=20.0),
              "bidirectional": dict(causal=False)}

# name -> (arch, mesh shape, microbatches, compression, grad_spec, fsdp)
TRAIN_CASES = {
    "dense_2x2": ("smollm-360m", (2, 2), 1, "none", "param", True),
    "dense_2x2_mb2_int8": ("smollm-360m", (2, 2), 2, "int8", "param", True),
    "dense_4x1_mb2_topk_dp": ("smollm-360m", (4, 1), 2, "topk", None, True),
    "moe_2x2": ("olmoe-1b-7b", (2, 2), 1, "none", "param", False),
    "moe_2x2_mb2_topk": ("olmoe-1b-7b", (2, 2), 2, "topk", "param", True),
    "moe_4x1_int8_dp": ("olmoe-1b-7b", (4, 1), 1, "int8", None, True),
}
MOE_CAPACITY = 0.5               # low enough that pairs drop

# arch -> mesh shape (MQA families: their one kv head cannot split over
# model, in the reference either)
SERVE_ARCHS = {"gemma2-2b": (2, 2), "olmoe-1b-7b": (2, 2),
               "hymba-1.5b": (4, 1), "xlstm-125m": (2, 2),
               "whisper-large-v3": (2, 2), "paligemma-3b": (4, 1)}
RING_ARCH = "granite-8b"         # window 0: the ring prefill


def tconfig(arch, **changes):
    """The port's reduced config of ``arch`` (granite with 8 heads, so its
    kv heads split over model)."""
    from repro_torch.configs import base as CB
    extra = {"n_heads": 8} if arch == RING_ARCH else {}
    cfg = CB.reduced_config(CB.get_config(arch), **extra)
    if cfg.family == "moe":
        changes = {"capacity_factor": MOE_CAPACITY, **changes}
    return dataclasses.replace(cfg, **changes)


def jconfig(arch, **changes):
    from repro.configs.base import get_config, reduced_config
    extra = {"n_heads": 8} if arch == RING_ARCH else {}
    cfg = reduced_config(get_config(arch), **extra)
    if cfg.family == "moe":
        changes = {"capacity_factor": MOE_CAPACITY, **changes}
    return dataclasses.replace(cfg, **changes)


def weights(cfg, seed: int = 0) -> dict:
    """The port's ``init_params`` of ``cfg`` from ``seed``, as numpy."""
    import torch
    from repro_torch.models.registry import init_params
    from repro_torch.utils.tree import tree_map
    tree = init_params(cfg, "cpu", torch.Generator().manual_seed(seed))
    return tree_map(lambda t: t.numpy(), tree)


def make_batch(cfg, seed, b, s=S):
    """Tokens, next-token labels (the last two and a few scattered ones
    masked), and the stub frontends' embeddings."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    lab = np.roll(tok, -1, axis=1)
    lab[:, -2:] = -1
    lab[rng.random((b, s)) < 0.1] = -1
    batch = {"tokens": tok, "labels": lab}
    if cfg.family == "encdec":
        batch["audio_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return batch


def ring_inputs():
    rng = np.random.default_rng(0)
    b, s, hq, hkv, dh = RING_SHAPE
    return (rng.standard_normal((b, s, hq, dh)).astype(np.float32),
            rng.standard_normal((b, s, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, s, hkv, dh)).astype(np.float32))


def train_inputs(name):
    arch, _, _, _, _, fsdp = TRAIN_CASES[name]
    return fsdp, make_batch(tconfig(arch), 11, B_TRAIN)


def serve_cache_len(cfg):
    return S + GEN + cfg.prefix_len


def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if str(x.dtype) == "torch.bfloat16":
            x = x.float()
        x = x.numpy()
    return np.asarray(x)


# ------------------------------------------------------------- the ranks

def _run_train(name, mesh, out, meta):
    """One train case on ``mesh``: the gathered state after one step."""
    import torch
    from repro_torch.models.registry import build_model, params_from_numpy
    from repro_torch.train.compression import CompressionConfig
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step, state_spec)
    from repro_torch.utils import sharding as SH
    from repro_torch.utils.tree import flatten_with_paths
    arch, _, mb, kind, gspec, _ = TRAIN_CASES[name]
    fsdp, batch = train_inputs(name)
    cfg = tconfig(arch, fsdp=fsdp)
    model = build_model(cfg, device="cpu",
                        params=params_from_numpy(cfg, weights(cfg), "cpu"))
    model.to_mesh(mesh)
    comp = CompressionConfig(kind=kind, topk_fraction=TOPK)
    state = init_train_state(model, compression=comp)
    step = make_train_step(model, AdamWConfig(peak_lr=LR, warmup_steps=0),
                           microbatches=mb, compression=comp,
                           dp_spec="data",
                           grad_spec=None if gspec is None
                           else model.param_spec())
    state, met = step(state, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    sspec = state_spec(model, comp)
    specs = SH.tree_specs(sspec, state)
    placed = True
    for (leaf_name, leaf), sp in zip(flatten_with_paths(state), specs):
        full = SH.gather(leaf, sp, mesh)
        placed &= bool(torch.equal(SH.shard_of(full, sp, mesh), leaf))
        out[f"train/{name}/{leaf_name}"] = _np(full)
    meta[f"train/{name}/metrics"] = {k: float(v) for k, v in met.items()}
    meta[f"train/{name}/placed_by_state_spec"] = placed
    return model, state, sspec


def _run_serve(arch, mesh, out):
    import torch
    from repro_torch.models.registry import build_model, params_from_numpy
    from repro_torch.train.serve_step import greedy_generate
    cfg = tconfig(arch)
    model = build_model(cfg, device="cpu",
                        params=params_from_numpy(cfg, weights(cfg, 1), "cpu"))
    model.to_mesh(mesh)
    batch = make_batch(cfg, 12, B_SERVE)
    del batch["labels"]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    cl = serve_cache_len(cfg)
    out[f"serve/{arch}/tokens"] = _np(greedy_generate(model, tb, GEN, cl))
    logits, cache = model.prefill(tb, cache_len=cl)
    out[f"serve/{arch}/prefill"] = _np(logits)
    nxt = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    lg, _ = model.decode_step(nxt, cache, S + cfg.prefix_len)
    out[f"serve/{arch}/decode"] = _np(lg)


def rank_main(rank: int, world: int, init_method: str, outdir: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as M
    from repro_torch.models import layers as L
    from repro_torch.models.registry import build_model, params_from_numpy
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    from repro_torch.utils import sharding as SH
    from repro_torch.utils.tree import flatten_with_paths, tree_map
    out, meta = {}, {"rank": rank}
    meshes = {(2, 2): M.make_mesh((2, 2), device_type="cpu",
                                  init_method=init_method, world_size=world,
                                  rank=rank, timeout_s=TIMEOUT_S)}
    meshes[(4, 1)] = M.make_mesh((4, 1), device_type="cpu",
                                 timeout_s=TIMEOUT_S)
    mesh = meshes[(2, 2)]
    meta["coordinate"] = list(mesh.get_coordinate())
    t0 = time.perf_counter()
    # ring attention: this rank's rows (data index), the whole sequence
    q, k, v = (torch.from_numpy(a) for a in ring_inputs())
    grp = SH.BatchGroup(mesh, ("data",))
    for case, kw in RING_CASES.items():
        o = L.attn_ring(grp.rows(q), grp.rows(k), grp.rows(v), mesh=mesh,
                        chunk_k=RING_CHUNK, **kw)
        out[f"ring/{case}"] = _np(o)
    meta["seconds/ring"] = time.perf_counter() - t0
    # the train step
    for name, (_, shape, *_rest) in TRAIN_CASES.items():
        t1 = time.perf_counter()
        model, state, sspec = _run_train(name, meshes[shape], out, meta)
        meta[f"seconds/train/{name}"] = time.perf_counter() - t1
        if name == "dense_2x2":
            ckpt_model, ckpt_state, ckpt_spec = model, state, sspec
    # the checkpoint: written from the (2, 2) state, restored onto (4, 1)
    # and onto no mesh
    root = os.path.join(outdir, "ckpt")
    save_checkpoint(root, 1, ckpt_state, shardings=(ckpt_spec, mesh))
    whole = {n: out[f"train/dense_2x2/{n}"]
             for n, _ in flatten_with_paths(ckpt_state)}
    m41 = meshes[(4, 1)]
    got41, _ = restore_checkpoint(root, ckpt_state, 1, device="cpu",
                                  shardings=(ckpt_spec, m41))
    same41 = all(
        _np(SH.gather(leaf, sp, m41)).tobytes() == whole[n].tobytes()
        for (n, leaf), sp in zip(flatten_with_paths(got41),
                                 SH.tree_specs(ckpt_spec, got41)))
    full, _ = restore_checkpoint(root, ckpt_state, 1, device="cpu")
    same_full = all(_np(leaf).tobytes() == whole[n].tobytes()
                    for n, leaf in flatten_with_paths(full))
    meta["ckpt/restored_4x1_equal"] = bool(same41)
    meta["ckpt/restored_meshless_equal"] = bool(same_full)
    if rank == 0:
        # the files equal those of the unsharded state saved meshless
        plain = os.path.join(outdir, "ckpt_plain")
        save_checkpoint(plain, 1, tree_map(torch.from_numpy, whole))
        meta["ckpt/files_equal_unsharded"] = all(
            open(os.path.join(root, "step_00000001", f), "rb").read()
            == open(os.path.join(plain, "step_00000001", f), "rb").read()
            for f in os.listdir(os.path.join(plain, "step_00000001"))
            if f.endswith(".npy"))
    # sharded serving
    for arch, shape in SERVE_ARCHS.items():
        t1 = time.perf_counter()
        _run_serve(arch, meshes[shape], out)
        meta[f"seconds/serve/{arch}"] = time.perf_counter() - t1
    # a ring prefill: the sequence over model, inside the model
    cfg = tconfig(RING_ARCH, attn_impl="ring")
    model = build_model(cfg, device="cpu",
                        params=params_from_numpy(cfg, weights(cfg, 2), "cpu"))
    model.ring_mesh = mesh
    model.to_mesh(mesh)
    batch = make_batch(cfg, 13, B_SERVE)
    logits, cache = model.prefill({"tokens": torch.from_numpy(
        batch["tokens"])}, cache_len=S + 2)
    out["ring_prefill/logits"] = _np(logits)
    for kk, c in cache.items():
        out[f"ring_prefill/cache/{kk}"] = _np(SH.gather(
            c, model.cache_spec(multi_pod=False)[kk], mesh))
    # refusals: act_spec on a mesh, the ring under autograd
    ckpt_model.act_spec = SH.P("data", "model", None)
    try:
        ckpt_model.forward({"tokens": torch.zeros((4, S), dtype=torch.int32)})
        meta["refuse/act_spec"] = None
    except NotImplementedError as e:
        meta["refuse/act_spec"] = str(e)
    try:
        L.attn_ring(grp.rows(q).requires_grad_(), grp.rows(k), grp.rows(v),
                    mesh=mesh)
        meta["refuse/ring_grad"] = None
    except RuntimeError as e:
        meta["refuse/ring_grad"] = str(e)
    dist.barrier()
    # a rank that skips a collective: on a mesh with a short timeout rank
    # 1 runs no train step; every rank that waits on it must fail
    quick = M.make_mesh((2, 2), device_type="cpu", timeout_s=SKIP_TIMEOUT_S)
    cfg = tconfig("smollm-360m", fsdp=True)
    model = build_model(cfg, device="cpu",
                        params=params_from_numpy(cfg, weights(cfg), "cpu"))
    model.to_mesh(quick)
    state = init_train_state(model)
    step = make_train_step(model, AdamWConfig(), dp_spec="data",
                           grad_spec=model.param_spec())
    _, batch = train_inputs("dense_2x2")
    t1 = time.perf_counter()
    meta["skip/error"] = None
    if rank != 1:
        try:
            step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        except Exception as e:             # the group's timeout
            meta["skip/error"] = type(e).__name__ + ": " + str(e)[:200]
    meta["skip/seconds"] = time.perf_counter() - t1
    meta["seconds/total"] = time.perf_counter() - t0
    # every rank stays until the others have timed out: a rank that
    # leaves closes its connections, and a peer still waiting on it
    # would see the close instead of its own timeout
    time.sleep(max(0.0, t1 + 3 * SKIP_TIMEOUT_S - time.perf_counter()))
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    # the process groups are broken by the planted skip: leave without
    # tearing them down
    sys.stdout.flush()
    os._exit(0)


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.update(extra)
    return env


def run_world(outdir: str, timeout_s: float = 300.0) -> list:
    """Start ``WORLD`` ranks of ``rank_main`` in fresh interpreters,
    rendezvous through a file under ``outdir``; returns each rank's
    ``(returncode, output)``.  Every rank still running at the deadline
    is killed."""
    init = "file://" + os.path.join(outdir, "rendezvous")
    procs = []
    for r in range(WORLD):
        code = (f"import torch_lm_mesh_cases as c; "
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

def _jmesh(shape, axes):
    import jax
    from jax.sharding import Mesh
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)


def _shard_maps(meta):
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP
    for tag, (shape, axes) in SHARD_MESHES.items():
        mesh = _jmesh(shape, axes)
        for i, (arr, spec) in enumerate(SHARD_SPECS):
            key = f"shard/{tag}/{i}"
            try:
                idx = NamedSharding(mesh, JP(*spec)).devices_indices_map(arr)
            except Exception as e:             # JAX refuses the pair
                meta[key] = {"error": type(e).__name__}
                continue
            blocks = []
            for coord in np.ndindex(*shape):
                sl = idx[mesh.devices[coord]]
                blocks.append([list(coord), [[s.indices(n)[0],
                                              s.indices(n)[1]]
                                             for s, n in zip(sl, arr)]])
            meta[key] = {"blocks": blocks}


def _reference_train(name, out, meta):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP
    from repro.models.registry import build_model
    from repro.train.compression import CompressionConfig, init_error_state
    from repro.train.optimizer import AdamWConfig, init_opt_state
    from repro.train.train_step import (TrainState, make_train_step,
                                        state_spec)
    from repro.utils.tree import flatten_with_paths
    arch, shape, mb, kind, gspec, _ = TRAIN_CASES[name]
    fsdp, batch = train_inputs(name)
    cfg = jconfig(arch, fsdp=fsdp)
    model = build_model(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, weights(tconfig(arch,
                                                                 fsdp=fsdp)))
    comp = CompressionConfig(kind=kind, topk_fraction=TOPK)
    state = TrainState(params, init_opt_state(params),
                       init_error_state(params) if kind != "none" else None)
    mesh = _jmesh(shape, AXES)
    is_p = lambda x: isinstance(x, JP)  # noqa: E731
    shard = lambda sp: NamedSharding(mesh, sp)  # noqa: E731
    s_sh = jax.tree_util.tree_map(shard, state_spec(model, comp),
                                  is_leaf=is_p)
    b_sh = {k: NamedSharding(mesh, JP("data", *([None] * (v.ndim - 1))))
            for k, v in batch.items()}
    step = make_train_step(model, AdamWConfig(peak_lr=LR, warmup_steps=0),
                           microbatches=mb, compression=comp, dp_spec="data",
                           grad_spec=None if gspec is None
                           else model.param_spec())
    with mesh:
        state = jax.device_put(state, s_sh)
        jb = {k: jax.device_put(jnp.asarray(v), b_sh[k])
              for k, v in batch.items()}
        state, met = jax.jit(step, out_shardings=(s_sh, None))(state, jb)
    for leaf_name, leaf in flatten_with_paths(state):
        out[f"train/{name}/{leaf_name}"] = np.asarray(leaf)
    meta[f"train/{name}/metrics"] = {k: float(v) for k, v in met.items()}


def _reference_serve(arch, out):
    import jax
    import jax.numpy as jnp
    from repro.models.registry import build_model
    from repro.train.serve_step import greedy_generate
    cfg = jconfig(arch)
    model = build_model(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, weights(tconfig(arch), 1))
    batch = make_batch(tconfig(arch), 12, B_SERVE)
    del batch["labels"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    cl = serve_cache_len(cfg)
    out[f"serve/{arch}/tokens"] = np.asarray(greedy_generate(
        model, params, jb, steps=GEN, cache_len=cl))
    logits, cache = model.prefill(params, jb, cache_len=cl)
    out[f"serve/{arch}/prefill"] = np.asarray(logits)
    nxt = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    lg, _ = model.decode_step(params, nxt, cache,
                              jnp.int32(S + cfg.prefix_len))
    out[f"serve/{arch}/decode"] = np.asarray(lg)


def reference_main(outdir: str, part: str) -> None:
    """The JAX package's side on 8 virtual devices (run in a fresh
    interpreter with the XLA flag set), in two parts that run side by
    side: ``"mesh"`` (the block maps, the ring, the train steps) and
    ``"serve"``."""
    import jax
    import jax.numpy as jnp
    from repro.models.layers import attn_ring
    out, meta = {}, {}
    if part == "mesh":
        _shard_maps(meta)
        mesh = _jmesh((2, 2), AXES)
        q, k, v = (jnp.asarray(a) for a in ring_inputs())
        with mesh:
            for case, kw in RING_CASES.items():
                out[f"ring/{case}"] = np.asarray(jax.jit(
                    lambda q, k, v, kw=kw: attn_ring(
                        q, k, v, mesh=mesh, chunk_k=RING_CHUNK, **kw))(
                    q, k, v))
        for name in TRAIN_CASES:
            _reference_train(name, out, meta)
    else:
        for arch in SERVE_ARCHS:
            _reference_serve(arch, out)
    np.savez(os.path.join(outdir, f"reference_{part}.npz"), **out)
    with open(os.path.join(outdir, f"reference_{part}.json"), "w") as f:
        json.dump(meta, f)


REFERENCE_PARTS = ("mesh", "serve")


def start_reference(outdir: str) -> list:
    """Both parts of ``reference_main``, each in its own interpreter."""
    return [subprocess.Popen(
        [sys.executable, "-c", "import torch_lm_mesh_cases as c; "
         f"c.reference_main({outdir!r}, {part!r})"],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                 JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for part in REFERENCE_PARTS]
