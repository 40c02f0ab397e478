"""Dry run: run every (arch x shape x mesh) cell as one rank of a fake
world on the production meshes, and read the roofline terms off what it
counted (the reference's ``launch/dryrun.py``, which lowers each cell on
512 virtual devices and reads XLA's compiled artifacts).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out build/dryrun

The port has no compiler to ask, so it runs its own SPMD program: rank
0 of a world of 256 (``16 x 16``) or 512 (``2 x 16 x 16``) ranks of
``torch.distributed``'s ``fake`` backend, whose collectives move nothing,
with every tensor on the ``meta`` device (shapes and dtypes, no storage;
``FakeTensorMode`` counted the same bytes in 2.5 times the time).  One
call of the cell's function (a train step, a prefill, a decode step) is
counted:

* FLOPs by ``torch.utils.flop_counter``'s rules for each operation that
  has one (the matrix products and convolutions);
* bytes: each operation's inputs read once and outputs written once
  (views free), an unfused upper bound of XLA's "bytes accessed";
* collective bytes where the port issues its collectives
  (``utils.roofline.CollectiveCounter``);
* per-rank memory: the peak of live storages, split into parameters and
  optimizer state (live before the call), activations (the rest, live
  when the forward ends) and temporaries (the rest of the peak).

A path that reads data on the host (``.item()``, ``nonzero``) cannot run
on meta tensors; its cell is recorded as ``error`` with the reason
(``HostRead``), as is a cell past ``MAX_OPS`` dispatched operations.
``fake=False`` runs the same counts on real CPU tensors (the tests hold
a real gloo world's counts to the fake world's).

Private torch modules, imported here only: ``torch.testing._internal.
distributed.fake_pg`` (``FakeStore``) and ``torch.utils._python_dispatch``
(``TorchDispatchMode``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import (
    SHAPES, ShapeSpec, get_config, list_archs, reduced_config,
    shape_applicable)
from repro_torch.launch.mesh import (make_production_mesh, mesh_axis_sizes,
                                     n_chips)
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import _as_parameters, _tensors
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.utils import roofline as RL
from repro_torch.utils.sharding import P
from repro_torch.utils.tree import flatten_with_paths, tree_leaves, tree_map

MAX_OPS = 20_000_000       # dispatched operations a cell may take


class SkipCell(Exception):
    pass


class HostRead(Exception):
    """The cell's path reads data on the host."""


class TooManyOps(Exception):
    """The cell took more than ``MAX_OPS`` operations."""


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A ``fake``-backend world of ``world_size`` ranks in which this
    process is ``rank``; torn down on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is running already")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_mesh(multi_pod: bool):
    """``make_production_mesh`` over the fake world (which must have its
    size)."""
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu",
                                backend="fake")


def _host_read(e: BaseException) -> bool:
    """An error a meta tensor raises where a path reads its data."""
    return isinstance(e, (RuntimeError, NotImplementedError)) \
        and "meta" in str(e)


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

class _Counter(TorchDispatchMode):
    """FLOPs, bytes each operation reads and writes (views free),
    operations, and the live storages: their bytes now, at the peak, and
    by category."""

    def __init__(self, state: dict, max_ops: int):
        from torch.utils.flop_counter import flop_registry
        super().__init__()
        self.rules = flop_registry
        self.flops = 0
        self.bytes = 0.0
        self.ops = 0
        self.max_ops = max_ops
        self.live: dict = {}
        self.refs: dict = {}
        self.cur = 0
        self.peak = 0
        self.by_cat = {}
        self.activations = 0
        for cat, tensors in state.items():
            n0 = self.cur
            for t in tensors:
                self._track(t)
            self.by_cat[cat] = self.cur - n0

    def _track(self, t) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.cur += n
        if self.cur > self.peak:
            self.peak = self.cur
        self.refs[key] = weakref.ref(st, lambda _, k=key: self._free(k))

    def _free(self, key) -> None:
        self.cur -= self.live.pop(key, 0)
        self.refs.pop(key, None)

    def mark_forward_end(self) -> None:
        """The activations: what lives beyond the state when the forward
        ends (the largest over microbatches)."""
        state = sum(self.by_cat.values())
        self.activations = max(self.activations, self.cur - state)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        if self.ops > self.max_ops:
            raise TooManyOps(f"more than {self.max_ops} operations")
        outs = _tensors_in(out)
        rule = self.rules.get(func._overloadpacket)
        if rule is not None:
            self.flops += rule(*args, **(kwargs or {}), out_val=out)
        if not func.is_view:
            ins = _tensors_in(args)
            if kwargs:
                ins += _tensors_in(tuple(kwargs.values()))
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


def _tensors_in(x) -> list:
    """The tensors of an operation's arguments or results (tensors, and
    lists and tuples of them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors_in(e)]
    return []


@dataclasses.dataclass
class Program:
    """One cell's call, ready to count: ``fn()`` runs it once; ``state``
    maps a memory category to the tensors live before the call;
    ``model`` is the model it runs (its ``loss`` marks the forward's
    end)."""
    fn: object
    state: dict
    model: object = None


def measure(program: Program) -> dict:
    """Run ``program`` once under the counters: ``{"flops", "bytes",
    "ops", "coll" (CollectiveStats), "memory": {"params", "opt",
    "activations", "temp", "peak"}}`` (bytes a rank).  Raises
    ``HostRead`` where the path reads data on the host."""
    model = program.model
    counter = None
    loss = model.loss if model is not None else None
    if loss is not None:
        def marked(*a, **kw):
            out = loss(*a, **kw)
            counter.mark_forward_end()
            return out
        model.loss = marked
    try:
        with RL.CollectiveCounter() as cc, \
                _Counter(program.state, MAX_OPS) as counter:
            program.fn()
    except (RuntimeError, NotImplementedError) as e:
        if _host_read(e):
            raise HostRead(f"{type(e).__name__}: {e}") from e
        raise
    finally:
        if loss is not None:
            del model.loss
    state = sum(counter.by_cat.values())
    mem = dict(counter.by_cat)
    mem["activations"] = counter.activations
    mem["temp"] = counter.peak - state - counter.activations
    mem["peak"] = counter.peak
    return {"flops": float(counter.flops),
            "bytes": counter.bytes,
            "ops": counter.ops, "coll": cc.stats, "memory": mem}


# ---------------------------------------------------------------------------
# helpers (the reference's)
# ---------------------------------------------------------------------------

def usable_dp(batch: int, mesh) -> tuple:
    """Data-parallel axes that evenly divide the batch (batch=1 cells
    replicate over dp instead of sharding unevenly)."""
    if mesh is None:
        return ()
    sizes = mesh_axis_sizes(mesh)
    axes = []
    rem = batch
    for ax in ("pod", "data"):
        if ax in sizes and rem % sizes[ax] == 0:
            axes.append(ax)
            rem //= sizes[ax]
    return tuple(axes)


def _retarget_cache_spec(tree, dp: tuple):
    def fix(s):
        parts = list(s)
        # cache layouts put batch at index 1 (after the layer axis)
        if len(parts) >= 2:
            parts[1] = dp if dp else None
        return P(*parts)
    return tree_map(fix, tree)


def model_flops_for(cfg, model, params_sds, shape) -> float:
    """6·N·D (train) / 2·N·D (inference) with N = non-embedding params
    (active params for MoE)."""
    n = 0
    for name, leaf in flatten_with_paths(params_sds):
        if "embedding" in name or "lm_head" in name:
            continue
        sz = int(np.prod(leaf.shape))
        if cfg.family == "moe" and "/mlp/w_" in name:
            sz = sz * cfg.top_k // max(cfg.n_experts, 1)
        n += sz
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n * tokens


def _inputs(model, shape, multi_pod: bool, device) -> dict:
    """The cell's global batch: zeros of the reference's input shapes and
    dtypes (meta tensors in the dry run)."""
    arrays = model.input_specs(shape, multi_pod=multi_pod)["arrays"]
    return {k: torch.zeros(a.shape, dtype=a.dtype, device=device)
            for k, a in arrays.items()}


def _state_tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


# ---------------------------------------------------------------------------
# cell lowering
# ---------------------------------------------------------------------------

def lower_cell(arch: str, shape_name, mesh, *, reduced: bool = False,
               microbatches: int = 4, overrides: dict | None = None,
               remap_tp: bool = False, strip_attn_tp: bool = False,
               fake: bool = True, param_dtype: str | None = None):
    """Build one (arch x shape x mesh) cell: ``(program, meta)``.

    ``shape_name`` names one of ``SHAPES`` (or is a ``ShapeSpec``);
    ``mesh`` is a mesh of the running world, or None for one rank with
    no mesh.  The options are the reference's: ``overrides`` replaces
    config fields (``attn_impl="ring"`` sets the ring's mesh),
    ``remap_tp`` splits the batch over ``model`` too, ``strip_attn_tp``
    takes ``model`` out of the attention's specs; train and prefill cells
    whose sequence divides by 16 run under ``act_spec = P(dp, "model",
    None)``, and the multi-pod mesh's FSDP axes are ``("data", "pod")``.
    ``fake=False`` builds real CPU tensors (random weights), else meta
    tensors.  ``param_dtype``:
    the serving cells' parameters (default ``bfloat16``, the
    reference's; ``float32`` is the port's serving)."""
    cfg = get_config(arch)
    if reduced:
        cfg = reduced_config(cfg)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = shape_name if isinstance(shape_name, ShapeSpec) \
        else SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise SkipCell(why)
    names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
    multi_pod = "pod" in names
    dp = usable_dp(shape.global_batch, mesh)
    if remap_tp and mesh is not None:
        rem = shape.global_batch
        dp = []
        for ax in ("pod", "data", "model"):
            if ax in names and rem % mesh_axis_sizes(mesh)[ax] == 0:
                dp.append(ax)
                rem //= mesh_axis_sizes(mesh)[ax]
        dp = tuple(dp)
    device = "meta" if fake else "cpu"
    gen = torch.Generator().manual_seed(0)
    model = build_model(cfg, device=device, generator=gen)
    if strip_attn_tp:
        model.strip_tp = True
    if multi_pod and cfg.fsdp and not remap_tp:
        model.fsdp_axes = ("data", "pod")
    if shape.kind in ("train", "prefill") and shape.seq_len % 16 == 0 \
            and not remap_tp and mesh is not None:
        model.act_spec = P(dp if dp else None, "model", None)
    if cfg.attn_impl == "ring" and mesh is not None:
        model.ring_mesh = mesh
        model.ring_batch_axes = dp if dp else ()
    params_sds = model.init_params(cfg, "meta")
    if mesh is not None:
        model.to_mesh(mesh)
        model.batch_axes = dp
    batch = _inputs(model, shape, multi_pod, device)
    meta = {
        "arch": arch, "shape": shape.name,
        "mesh": ("x".join(str(s) for s in mesh.shape)
                 if mesh is not None else "1"),
        "chips": n_chips(mesh) if mesh is not None else 1,
        "model_flops": model_flops_for(cfg, model, params_sds, shape),
        "kind": shape.kind,
    }
    if shape.kind == "train":
        mb = microbatches if shape.global_batch % max(microbatches, 1) \
            == 0 else 1
        meta["microbatches"] = mb
        step = make_train_step(model, AdamWConfig(), microbatches=mb,
                               dp_spec=dp if dp else None,
                               grad_spec=model.param_spec())
        state = init_train_state(model)
        program = Program(lambda: step(state, batch),
                          {"params": _state_tensors(state.params),
                           "opt": _state_tensors(state.opt)},
                          model)
    else:
        dt = getattr(torch, param_dtype or "bfloat16")
        model.params = _as_parameters(tree_map(
            lambda t: t.to(dt) if t.is_floating_point() else t,
            _tensors(model.params)))
        if mesh is not None:
            orig = model.cache_spec
            model.cache_spec = lambda multi_pod=True: \
                _retarget_cache_spec(orig(multi_pod), dp)
        params = {"params": _state_tensors(_tensors(model.params))}
        if shape.kind == "prefill":
            def run():
                with torch.no_grad():
                    model.prefill(batch, cache_len=shape.seq_len)
            program = Program(run, params, None)
        else:
            rows = model._rows(batch["tokens"]).shape[0]
            cache = model._mesh_cache(model.init_cache(rows,
                                                       shape.seq_len))
            params["cache"] = _state_tensors(cache)

            def run():
                with torch.no_grad():
                    model.decode_step(batch["tokens"], cache,
                                      shape.seq_len - 1)
            program = Program(run, params, None)
    return program, meta


def analyze_cell(program: Program, meta: dict) -> dict:
    """Count one call of ``program`` and build its record: the
    reference's roofline keys, ``memory_detail`` by category, and
    ``counted``, the raw counts."""
    t0 = time.time()
    got = measure(program)
    mem = got["memory"]
    report = RL.analyze(
        name=f"{meta['arch']}/{meta['shape']}/{meta['mesh']}",
        cost={"flops": got["flops"], "bytes accessed": got["bytes"]},
        coll=got["coll"], chips=meta["chips"],
        model_flops_global=meta["model_flops"], memory_bytes=mem["peak"])
    rec = dataclasses.asdict(report)
    rec.update(meta)
    rec["memory_detail"] = mem
    rec["roofline_fraction"] = report.roofline_fraction
    rec["bound_s"] = report.bound_s
    rec["counted"] = {"flops": got["flops"], "bytes": got["bytes"],
                      "ops": got["ops"],
                      "coll_link_bytes": dict(got["coll"].link_bytes)}
    rec["compile_s"] = time.time() - t0      # the counted call's wall
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             reduced: bool = False, force: bool = False,
             microbatches: int = 4, overrides: dict | None = None,
             remap_tp: bool = False, strip_attn_tp: bool = False,
             tag: str = "") -> dict:
    """One cell on its production mesh, in a fake world of its own;
    the record is written to ``out_dir`` (and read back from there
    unless ``force``)."""
    os.makedirs(out_dir, exist_ok=True)
    fname = os.path.join(out_dir,
                         f"{arch}__{shape_name}__{mesh_kind}{tag}.json")
    if os.path.exists(fname) and not force:
        with open(fname) as f:
            return json.load(f)
    multi = mesh_kind == "multi"
    t0 = time.time()
    try:
        with fake_world(512 if multi else 256):
            mesh = production_mesh(multi)
            program, meta = lower_cell(
                arch, shape_name, mesh, reduced=reduced,
                microbatches=microbatches, overrides=overrides,
                remap_tp=remap_tp, strip_attn_tp=strip_attn_tp)
            rec = analyze_cell(program, meta)
            del program
        rec["status"] = "ok"
    except SkipCell as e:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "skip", "reason": str(e)}
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    rec["wall_s"] = time.time() - t0
    with open(fname, "w") as f:
        json.dump(rec, f, indent=2, default=str)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale configs (CI of the dry-run itself)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatches", type=int, default=4)
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]

    n_ok = n_skip = n_err = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mesh_kind, args.out,
                               reduced=args.reduced, force=args.force,
                               microbatches=args.microbatches)
                status = rec.get("status")
                n_ok += status == "ok"
                n_skip += status == "skip"
                n_err += status == "error"
                line = f"[{status:5s}] {arch:22s} {shape:12s} {mesh_kind:6s}"
                if status == "ok":
                    line += (f" mem/dev={rec.get('memory_per_device_gb', 0):.2f}GB"
                             f" dominant={rec.get('dominant')}"
                             f" bound={rec.get('bound_s', 0):.4f}s"
                             f" wall={rec.get('wall_s', 0):.0f}s")
                elif status == "error":
                    line += " " + rec.get("error", "")[:90]
                print(line, flush=True)
    print(f"done: {n_ok} ok, {n_skip} skip, {n_err} error", flush=True)
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
