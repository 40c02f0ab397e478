"""Device meshes for the distributed engine, on ``torch.distributed``.

The reference builds a jax ``Mesh`` over the devices one controller
sees.  The port runs SPMD instead: one process a rank, every rank runs
the same program, and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
world, with axes ``("data", "model")``.

    mesh = make_mesh((2, 2), init_method="file:///shared/rendezvous",
                     world_size=4, rank=r)          # one call per rank

The backend is explicit: NCCL for ``device_type="cuda"``, gloo for
``"cpu"``.  A caller may ask for gloo on ``"cuda"`` by name (several
ranks on one card: NCCL refuses two ranks on one GPU); nothing falls
back from NCCL to gloo, or from the card to the host, on its own.  The
dry run (``launch/dryrun.py``) builds its meshes on ``"cpu"`` over a
world of the ``fake`` backend, which moves no byte.

Each rank of a CUDA mesh runs on ``cuda:{local_rank % device_count}``,
made current with ``torch.cuda.set_device`` before the process group
starts (``LOCAL_RANK`` where a launcher sets it, else the global rank).
Every process group of the mesh carries ``timeout_s``, so a rank that
skips a collective fails the others within it instead of hanging them.

Functions, not module-level constants, so importing this module never
touches a process group.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
DEFAULT_TIMEOUT_S = 300.0


def _local_rank(rank: Optional[int]) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if rank is not None:
        return int(rank)
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def init_world(backend: str, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Start the default process group unless one is running.  Without
    ``init_method`` it reads the launcher's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``)."""
    if dist.is_initialized():
        return
    kw = {}
    if world_size is not None:
        kw["world_size"] = int(world_size)
    if rank is not None:
        kw["rank"] = int(rank)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        timeout=datetime.timedelta(seconds=timeout_s), **kw)


def make_mesh(shape: Sequence[int], axes: Sequence[str] = AXES,
              device_type: str = "cuda", backend: Optional[str] = None,
              init_method: Optional[str] = None,
              world_size: Optional[int] = None, rank: Optional[int] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S):
    """A ``DeviceMesh`` of ``shape`` over the whole world, rank ``r`` at
    the row-major coordinate of ``r``.  Starts the world's process group
    if none runs (``init_method``, ``world_size``, ``rank``), and builds
    one group per line of every axis, each with ``timeout_s``."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if device_type not in BACKENDS:
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    backend = backend or BACKENDS[device_type]
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device_type='cuda'): no CUDA "
                               "device; ask for device_type='cpu'")
        torch.cuda.set_device(_local_rank(rank) % torch.cuda.device_count())
    elif backend not in ("gloo", "fake"):
        raise ValueError(f"backend {backend!r} on the CPU: only gloo (or "
                         "the dry run's fake world)")
    init_world(backend, init_method, world_size, rank, timeout_s)
    n = int(np.prod(shape))
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {shape} needs {n} ranks; the world "
                         f"has {dist.get_world_size()}")
    ranks = np.arange(n).reshape(shape)
    timeout = datetime.timedelta(seconds=timeout_s)
    me = dist.get_rank()
    groups = []
    for i in range(len(shape)):
        mine = None
        # every rank creates every group, in the same order
        for line in np.moveaxis(ranks, i, -1).reshape(-1, shape[i]):
            g = dist.new_group([int(r) for r in line], timeout=timeout,
                               backend=backend)
            if me in line:
                mine = g
        groups.append(mine)
    return DeviceMesh.from_group(groups, device_type,
                                 mesh=torch.from_numpy(ranks),
                                 mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, **kw):
    """16 x 16 (256 ranks) or 2 x 16 x 16 (512); raises unless the world
    has that size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else AXES
    return make_mesh(shape, axes, **kw)


def make_local_mesh(n_data: int = 1, n_model: int = 1, **kw):
    """Development mesh over the ranks of the world (``world_size``, the
    running world's, or the launcher's ``WORLD_SIZE``), clamped as the
    reference clamps to its devices.  The port's mesh spans the whole
    world, so a clamp that leaves ranks out raises."""
    n = kw.get("world_size") or (dist.get_world_size()
                                 if dist.is_initialized()
                                 else int(os.environ.get("WORLD_SIZE", 1)))
    n_data = min(n_data, n)
    n_model = max(1, min(n_model, n // n_data))
    return make_mesh((n_data, n_model), AXES, **kw)


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def n_chips(mesh) -> int:
    return int(mesh.mesh.numel())
