"""Worlds for ``tests/test_torch_lm_seqpar.py`` (no ``test_`` prefix: not
collected): the ring's backward and ``act_spec`` on a device mesh.

``rank_main`` is one rank of a four-rank gloo world on the CPU.  On a
``(2, 2)`` and a ``(1, 4)`` mesh over ``("data", "model")`` it runs the
gradients of q, k and v through ``attn_ring`` (and once with the planted
fault of a backward that shifts forward), a Granite-style ring train
step with and without ``act_spec``, and the train step and prefill of
the dense, MoE, hybrid, xLSTM and Whisper families under ``act_spec =
P("data", "model", None)`` (and once with the planted fault of the
layer gather's gradient sliced where it must be summed), and writes what
it got to ``rank{r}.npz`` / ``.json``.  ``reference_main`` runs the JAX
package's side (``jax.grad`` through its ``attn_ring``, its
``make_train_step`` and ``prefill`` under GSPMD with the same
``act_spec`` and ring) on 4 virtual devices, in three parts that run
side by side; it must start in a fresh interpreter with ``XLA_FLAGS=
--xla_force_host_platform_device_count=4`` set before JAX starts.  Both
sides take the same weights (``torch_lm_mesh_cases.weights``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

from torch_lm_mesh_cases import (AXES, B_SERVE, B_TRAIN, LR, RING_ARCH,
                                 RING_CASES, RING_CHUNK, RING_SHAPE, S, _env,
                                 _jmesh, _np, jconfig, make_batch,
                                 ring_inputs, tconfig, weights)

WORLD = 4
TIMEOUT_S = 60.0                 # every process group of the world
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
FAMILIES = {"dense": "smollm-360m", "moe": "olmoe-1b-7b",
            "hybrid": "hymba-1.5b", "xlstm": "xlstm-125m",
            "encdec": "whisper-large-v3"}
ACT = ("data", "model", None)
RING_TRAIN = {"ring": False, "ring_act": True}     # name -> act_spec on
FAULT_MESH = "1x4"               # M = 4: a shift forward differs from back


def ring_cotangent():
    b, s, hq, _, dh = RING_SHAPE
    return np.random.default_rng(1).standard_normal(
        (b, s, hq, dh)).astype(np.float32)


def family_cfg(fam):
    return tconfig(FAMILIES[fam])


def ring_cfg():
    return tconfig(RING_ARCH, attn_impl="ring")


def prefill_cache_len(cfg):
    return S + 2 + cfg.prefix_len


# ------------------------------------------------------------- the ranks

def _state(state, mesh, sspec, out, prefix):
    from repro_torch.utils import sharding as SH
    from repro_torch.utils.tree import flatten_with_paths
    for (name, leaf), sp in zip(flatten_with_paths(state),
                                SH.tree_specs(sspec, state)):
        out[prefix + name] = _np(SH.gather(leaf, sp, mesh))


def _train(cfg, params_np, batch, mesh, out, meta, prefix, act=False,
           ring=False):
    import torch
    from repro_torch.models.registry import build_model, params_from_numpy
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step, state_spec)
    from repro_torch.utils import sharding as SH
    model = build_model(cfg, device="cpu",
                        params=params_from_numpy(cfg, params_np, "cpu"))
    if ring:
        model.ring_mesh = mesh
    if act:
        model.act_spec = SH.P(*ACT)
    model.to_mesh(mesh)
    step = make_train_step(model, AdamWConfig(peak_lr=LR, warmup_steps=0),
                           dp_spec="data", grad_spec=model.param_spec())
    state, met = step(init_train_state(model),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    _state(state, mesh, state_spec(model), out, prefix)
    meta[prefix + "metrics"] = {k: float(v) for k, v in met.items()}


def _prefill(cfg, params_np, batch, mesh, out, prefix):
    import torch
    from repro_torch.models.registry import build_model, params_from_numpy
    from repro_torch.utils import sharding as SH
    model = build_model(cfg, device="cpu",
                        params=params_from_numpy(cfg, params_np, "cpu"))
    model.act_spec = SH.P(*ACT)
    model.to_mesh(mesh)
    tb = {k: torch.from_numpy(v) for k, v in batch.items() if k != "labels"}
    logits, cache = model.prefill(tb, cache_len=prefill_cache_len(cfg))
    out[prefix + "logits"] = _np(logits)
    specs = model.cache_spec(multi_pod=False)
    for k, c in cache.items():
        out[f"{prefix}cache/{k}"] = _np(SH.gather(c, specs[k], mesh))


def _ring_grads(mesh, tag, out, cases, prefix="ring_grad"):
    import torch
    from repro_torch.models import layers as L
    from repro_torch.utils import sharding as SH
    grp = SH.BatchGroup(mesh, ("data",))
    q, k, v = (torch.from_numpy(a) for a in ring_inputs())
    w = grp.rows(torch.from_numpy(ring_cotangent()))
    for case in cases:
        ts = [grp.rows(t).clone().requires_grad_() for t in (q, k, v)]
        o = L.attn_ring(*ts, mesh=mesh, chunk_k=RING_CHUNK,
                        **RING_CASES[case])
        (o * w).sum().backward()
        for n, t in zip("qkv", ts):
            out[f"{prefix}/{tag}/{case}/{n}"] = _np(grp.gather_rows(t.grad))


def _shift_forward_backward(ctx, *grads):
    """The planted fault: the ring's backward shifting forward, not back."""
    import torch
    from repro_torch.models import layers as L
    group, n, i = ctx.args
    grads = [torch.zeros(s, dtype=d, device=dev) if g is None else g
             for g, (s, d, dev) in zip(grads, ctx.like)]
    return (None, None, None, *L._shift(grads, group, n, i, 1))


def rank_main(rank: int, world: int, init_method: str, outdir: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as M
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.utils import sharding as SH
    out, meta = {}, {"rank": rank}
    meshes = {"2x2": M.make_mesh((2, 2), device_type="cpu",
                                 init_method=init_method, world_size=world,
                                 rank=rank, timeout_s=TIMEOUT_S)}
    meshes["1x4"] = M.make_mesh((1, 4), device_type="cpu",
                                timeout_s=TIMEOUT_S)
    t0 = time.perf_counter()
    for tag, mesh in meshes.items():
        meta[f"coordinate/{tag}"] = list(mesh.get_coordinate())
        _ring_grads(mesh, tag, out, RING_CASES)
    # the planted fault: the backward shifts forward
    good = L._RingShift.backward
    L._RingShift.backward = staticmethod(_shift_forward_backward)
    try:
        _ring_grads(meshes[FAULT_MESH], FAULT_MESH, out, ("causal",),
                    prefix="ring_grad_fault")
    finally:
        L._RingShift.backward = good
    meta["seconds/ring_grad"] = time.perf_counter() - t0
    # the ring's train step, with and without act_spec
    cfg = ring_cfg()
    batch = make_batch(cfg, 14, B_TRAIN)
    for name, act in RING_TRAIN.items():
        for tag, mesh in meshes.items():
            _train(cfg, weights(cfg, 4), batch, mesh, out, meta,
                   f"{name}/{tag}/", act=act, ring=True)
    meta["seconds/ring_train"] = time.perf_counter() - t0
    # act_spec: the families' train steps and prefills; the rows each
    # layer keeps between layers
    kept = []
    keep = T.SeqSplit.keep

    def recording_keep(self, x):
        y = keep(self, x)
        kept.append(int(y.shape[1]))
        return y
    T.SeqSplit.keep = recording_keep
    for fam in FAMILIES:
        cfg = family_cfg(fam)
        batch = make_batch(cfg, 15, B_TRAIN)
        for tag, mesh in meshes.items():
            kept.clear()
            _train(cfg, weights(cfg, 3), batch, mesh, out, meta,
                   f"act/{fam}/{tag}/", act=True)
            meta[f"act/{fam}/{tag}/kept_rows"] = sorted(set(kept))
            _prefill(cfg, weights(cfg, 3), make_batch(cfg, 16, B_SERVE),
                     mesh, out, f"act_prefill/{fam}/{tag}/")
        meta[f"seconds/act/{fam}"] = time.perf_counter() - t0
    T.SeqSplit.keep = keep
    # the planted fault: the layer gather's gradient sliced, not summed
    gather_seq = SH.gather_seq
    SH.gather_seq = lambda x, dim, axes, mesh, grad="sum": gather_seq(
        x, dim, axes, mesh, grad="slice")
    try:
        cfg = family_cfg("dense")
        _train(cfg, weights(cfg, 3), make_batch(cfg, 15, B_TRAIN),
               meshes[FAULT_MESH], out, meta, f"act_fault/{FAULT_MESH}/",
               act=True)
    finally:
        SH.gather_seq = gather_seq
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
        code = (f"import torch_lm_seqpar_cases as c; "
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

def _ref_train(cfg_t, cfg_j, seed, batch, shape, out, meta, prefix,
               act=False, ring=False):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP
    from repro.models.registry import build_model
    from repro.train.optimizer import AdamWConfig, init_opt_state
    from repro.train.train_step import (TrainState, make_train_step,
                                        state_spec)
    from repro.utils.tree import flatten_with_paths
    mesh = _jmesh(shape, AXES)
    model = build_model(cfg_j)
    if ring:
        model.ring_mesh = mesh
    if act:
        model.act_spec = JP(*ACT)
    params = jax.tree_util.tree_map(jnp.asarray, weights(cfg_t, seed))
    state = TrainState(params, init_opt_state(params), None)
    is_p = lambda x: isinstance(x, JP)  # noqa: E731
    s_sh = jax.tree_util.tree_map(lambda sp: NamedSharding(mesh, sp),
                                  state_spec(model), is_leaf=is_p)
    b_sh = {k: NamedSharding(mesh, JP("data", *([None] * (v.ndim - 1))))
            for k, v in batch.items()}
    step = make_train_step(model, AdamWConfig(peak_lr=LR, warmup_steps=0),
                           dp_spec="data", grad_spec=model.param_spec())
    with mesh:
        state = jax.device_put(state, s_sh)
        jb = {k: jax.device_put(jnp.asarray(v), b_sh[k])
              for k, v in batch.items()}
        state, met = jax.jit(step, out_shardings=(s_sh, None))(state, jb)
    for name, leaf in flatten_with_paths(state):
        out[prefix + name] = np.asarray(leaf)
    meta[prefix + "metrics"] = {k: float(v) for k, v in met.items()}


def _ref_prefill(fam, shape, out, prefix):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP
    from repro.models.registry import build_model
    cfg_t, cfg_j = family_cfg(fam), jconfig(FAMILIES[fam])
    mesh = _jmesh(shape, AXES)
    model = build_model(cfg_j)
    model.act_spec = JP(*ACT)
    params = jax.tree_util.tree_map(jnp.asarray, weights(cfg_t, 3))
    batch = make_batch(cfg_t, 16, B_SERVE)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "labels"}
    cl = prefill_cache_len(cfg_t)
    with mesh:
        logits, cache = jax.jit(
            lambda p, b: model.prefill(p, b, cache_len=cl))(params, jb)
    out[prefix + "logits"] = np.asarray(logits)
    for k, c in cache.items():
        out[f"{prefix}cache/{k}"] = np.asarray(c)


def reference_main(outdir: str, part: str) -> None:
    """The JAX package's side on 4 virtual devices, one part of three
    (``"ring"``: the ring's gradients and train steps; ``"train"``: the
    families' act_spec steps; ``"prefill"``: their act_spec prefills)."""
    import jax
    import jax.numpy as jnp
    from repro.models.layers import attn_ring
    out, meta = {}, {}
    if part == "ring":
        q, k, v = (jnp.asarray(a) for a in ring_inputs())
        w = jnp.asarray(ring_cotangent())
        for tag, shape in MESHES.items():
            mesh = _jmesh(shape, AXES)
            with mesh:
                for case, kw in RING_CASES.items():
                    def f(q, k, v, kw=kw):
                        return jnp.sum(attn_ring(q, k, v, mesh=mesh,
                                                 chunk_k=RING_CHUNK, **kw)
                                       * w)
                    grads = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
                    for n, g in zip("qkv", grads):
                        out[f"ring_grad/{tag}/{case}/{n}"] = np.asarray(g)
        cfg_t = ring_cfg()
        cfg_j = jconfig(RING_ARCH, attn_impl="ring")
        batch = make_batch(cfg_t, 14, B_TRAIN)
        for name, act in RING_TRAIN.items():
            for tag, shape in MESHES.items():
                _ref_train(cfg_t, cfg_j, 4, batch, shape, out, meta,
                           f"{name}/{tag}/", act=act, ring=True)
    elif part == "train":
        for fam, arch in FAMILIES.items():
            cfg_t = family_cfg(fam)
            batch = make_batch(cfg_t, 15, B_TRAIN)
            for tag, shape in MESHES.items():
                _ref_train(cfg_t, jconfig(arch), 3, batch, shape, out, meta,
                           f"act/{fam}/{tag}/", act=True)
    else:
        for fam in FAMILIES:
            for tag, shape in MESHES.items():
                _ref_prefill(fam, shape, out, f"act_prefill/{fam}/{tag}/")
    np.savez(os.path.join(outdir, f"reference_{part}.npz"), **out)
    with open(os.path.join(outdir, f"reference_{part}.json"), "w") as f:
        json.dump(meta, f)


REFERENCE_PARTS = ("ring", "train", "prefill")


def start_reference(outdir: str) -> list:
    """Every part of ``reference_main``, each in its own interpreter."""
    return [subprocess.Popen(
        [sys.executable, "-c", "import torch_lm_seqpar_cases as c; "
         f"c.reference_main({outdir!r}, {part!r})"],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for part in REFERENCE_PARTS]
