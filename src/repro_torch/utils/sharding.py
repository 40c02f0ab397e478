"""Partition specs and sharded trees on a ``torch.distributed`` device mesh:
the port's form of ``jax.sharding``.

The reference writes a ``PartitionSpec`` for every leaf and lets GSPMD
partition the program.  The port runs SPMD instead (one process a rank,
``launch/mesh.py``), and this module does by hand what GSPMD does with
a spec:

* ``P(*entries)``: a spec, entry for entry the reference's
  ``PartitionSpec`` (each entry ``None``, a mesh axis name or a tuple of
  names; a tuple of one name is that name, an empty one ``None``, as JAX
  normalises them).  It is a tuple, and a leaf of ``utils.tree``.
* ``shard_index(shape, spec, mesh_shape, axes, coords)``: the block of a
  global array that the device at ``coords`` holds, as JAX's
  ``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives it.  A
  dimension split over several axes is split major to minor in the order
  listed.  Like JAX it refuses a dimension that its axes do not divide,
  an axis the mesh lacks and an axis named twice.
* ``place`` / ``shard_of``: each rank keeps its block of a global tree.
* ``gather``: a block back to the global array, along the axes its spec
  names (one ``all_gather`` per named axis, minor axis first).
* ``reduce_to``: a rank's partial of a global array (a gradient of its
  batch rows) summed over the batch axes, down to the block a spec gives
  the rank: a ``reduce_scatter`` along a dimension split over a batch
  axis, a slice along one split over any other axis (ranks there hold
  equal values), an ``all_reduce`` over a batch axis the spec does not
  name.
* ``gather_for_compute``: ``gather`` under autograd, with ``reduce_to``
  as its backward (the ZeRO-3 pattern: a layer's weights gathered for
  its compute, their gradients reduced back to the shard).
* ``BatchGroup``: the ranks that split a batch's rows (``rows``,
  ``gather_rows``, sums and gathers in row order).

Collectives use the mesh's own groups (``mesh.get_group(axis)``) and the
list forms ``all_gather``, ``reduce_scatter``, ``all_reduce`` and
``batch_isend_irecv``.  A group over gloo whose tensors live on a card
is handed host copies (``wire``: gloo took some collectives on CUDA
tensors and aborted the process on others).  An axis of size 1 issues
no collective, so a 1 x 1 mesh runs every path without moving a byte.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.utils.tree import flatten_with_paths, tree_map


class P(tuple):
    """A partition spec: one entry a dimension, each ``None``, an axis
    name or a tuple of axis names (the reference's ``PartitionSpec``)."""

    is_tree_leaf = True          # a leaf of utils.tree, not a sequence

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self))


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        if not e:
            return None
        return e[0] if len(e) == 1 else e
    return e


def names(entry) -> tuple:
    """The axis names of one spec entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec) -> tuple:
    """Every axis a spec names, in order."""
    return tuple(a for e in spec for a in names(e))


# ------------------------------------------------------------------ layout

def _check(shape, spec, sizes: dict) -> list:
    """The names of each dimension of ``shape`` under ``spec``; raises
    where JAX refuses the pair."""
    shape = tuple(shape)
    spec = tuple(spec)
    if len(spec) > len(shape) and any(e is not None
                                      for e in spec[len(shape):]):
        raise ValueError(f"{P(*spec)} has more named entries than the "
                         f"array's {len(shape)} dimensions")
    seen = set()
    dims = []
    for d, size in enumerate(shape):
        ns = names(spec[d]) if d < len(spec) else ()
        for a in ns:
            if a not in sizes:
                raise ValueError(f"Resource axis: {a} of {P(*spec)} is not "
                                 f"found in mesh: {tuple(sizes)}.")
            if a in seen:
                raise ValueError(f"{P(*spec)} maps the mesh axis {a!r} to "
                                 "more than one dimension")
            seen.add(a)
        n = math.prod(sizes[a] for a in ns)
        if size % n:
            raise ValueError(f"{P(*spec)} implies that array axis {d} is "
                             f"partitioned {n} times, but the dimension "
                             f"size is {size}")
        dims.append(ns)
    return dims


def shard_index(shape, spec, mesh_shape, axes, coords) -> tuple:
    """The block of a global array of ``shape`` that the device at
    ``coords`` of a mesh (``mesh_shape`` over ``axes``) holds under
    ``spec``: a tuple of slices, one a dimension."""
    sizes = dict(zip(axes, (int(s) for s in mesh_shape)))
    pos = dict(zip(axes, (int(c) for c in coords)))
    out = []
    for size, ns in zip(shape, _check(shape, spec, sizes)):
        n, idx = 1, 0
        for a in ns:
            idx = idx * sizes[a] + pos[a]
            n *= sizes[a]
        c = size // n
        out.append(slice(idx * c, (idx + 1) * c))
    return tuple(out)


def mesh_sizes(mesh) -> dict:
    # ``mesh.shape``: ``mesh.mesh`` rebuilds a tensor on every read
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def mesh_coords(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names,
                    (int(c) for c in mesh.get_coordinate())))


def shard_of(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the global ``x`` (a view)."""
    return x[shard_index(x.shape, spec, mesh.shape, mesh.mesh_dim_names,
                         mesh.get_coordinate())]


def place(tree, spec_tree, mesh):
    """A global tree as this rank's blocks, each a contiguous copy (the
    global leaves may then be freed)."""
    return tree_map(lambda x, sp: shard_of(x, sp, mesh).clone(), tree,
                    spec_tree)


def live_axes(spec, mesh) -> tuple:
    """The axes of size > 1 that ``spec`` names, in the mesh's order."""
    sizes = mesh_sizes(mesh)
    named = set(spec_axes(spec))
    return tuple(a for a in sizes if a in named and sizes[a] > 1)


def replicated(tree):
    """A spec tree that keeps every leaf of ``tree`` whole."""
    return tree_map(lambda x: P(), tree)


# ------------------------------------------------------------- collectives

def wire(t: torch.Tensor, group):
    """The tensor a collective over ``group`` is handed: a host copy
    where the group is gloo's and ``t`` lives on a card."""
    import torch.distributed as dist
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t


def _all_gather0(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """``[n, *x.shape]``: every rank's ``x`` of the group in group-rank
    order."""
    import torch.distributed as dist
    xs = wire(x.contiguous(), group)
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                      device=xs.device)
    dist.all_gather(list(out.unbind(0)), xs, group=group)
    return out.to(x.device)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (or ``"max"``) of ``x`` over the group (a new tensor)."""
    import torch.distributed as dist
    xs = wire(x.contiguous(), group)
    xs = xs.clone() if xs is x else xs
    dist.all_reduce(xs, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return xs.to(x.device)


def _reduce_scatter(x: torch.Tensor, dim: int, group, n: int,
                    idx: int) -> torch.Tensor:
    """The sum over the group of block ``idx`` of ``n`` along ``dim``."""
    import torch.distributed as dist
    parts = [wire(p.contiguous(), group) for p in x.chunk(n, dim=dim)]
    out = torch.empty_like(parts[idx])
    dist.reduce_scatter(out, parts, group=group)
    return out.to(x.device)


def gather(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The global array of this rank's block ``x`` under ``spec``: along
    each named axis of size > 1, an ``all_gather`` (minor axis first),
    so a replicated leaf comes back as it is."""
    sizes = mesh_sizes(mesh)
    for d, entry in enumerate(tuple(spec)[:x.dim()]):
        for a in reversed(names(entry)):
            n = sizes[a]
            if n == 1:
                continue
            g = _all_gather0(x, mesh.get_group(a), n)      # [n, ...]
            x = g.movedim(0, d).reshape(
                x.shape[:d] + (n * x.shape[d],) + x.shape[d + 1:])
    return x


def reduce_to(x: torch.Tensor, spec, mesh, batch_axes: Sequence[str]):
    """This rank's block under ``spec`` of the sum of ``x`` (a global-
    shape partial, such as the gradient of the rank's rows) over the
    ranks of ``batch_axes``.  Along an axis outside ``batch_axes`` the
    ranks hold equal partials, so that block is sliced, not summed."""
    sizes, pos = mesh_sizes(mesh), mesh_coords(mesh)
    batch = {a for a in batch_axes if sizes[a] > 1}
    spec = tuple(spec)
    named = set()
    for d, entry in enumerate(spec[:x.dim()]):
        for a in names(entry):                     # major first
            named.add(a)
            n = sizes[a]
            if n == 1:
                continue
            if a in batch:
                x = _reduce_scatter(x, d, mesh.get_group(a), n, pos[a])
            else:
                x = x.chunk(n, dim=d)[pos[a]]
    for a in sorted(batch - named, key=list(sizes).index):
        x = all_reduce(x, mesh.get_group(a))
    return x


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, grad_spec, mesh, batch_axes):
        ctx.args = (spec, grad_spec, mesh, batch_axes)
        out = gather(x, spec, mesh)
        return out.clone() if out is x else out

    @staticmethod
    def backward(ctx, g):
        spec, grad_spec, mesh, batch_axes = ctx.args
        g = reshard(reduce_to(g, grad_spec, mesh, batch_axes), grad_spec,
                    spec, mesh)
        return g, None, None, None, None


def gather_for_compute(x: torch.Tensor, spec, mesh, batch_axes,
                       grad_spec) -> torch.Tensor:
    """``gather(x, spec, mesh)`` for a layer's compute.  Where ``x``
    requires a gradient, the gradient of the global array comes back
    through ``reduce_to(.., grad_spec, mesh, batch_axes)``, then cut to
    ``x``'s block (``grad_spec`` picks the reduction: a reduce-scatter to
    the blocks it names, an all-reduce of what it keeps whole)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x, spec, grad_spec, mesh, tuple(batch_axes))
    return gather(x, spec, mesh)


def reshard(x: torch.Tensor, src, dst, mesh) -> torch.Tensor:
    """A block under ``src`` as the block under ``dst`` (no copy where
    the two agree)."""
    if tuple(src) == tuple(dst):
        return x
    full = gather(x, src, mesh)
    return shard_of(full, dst, mesh)


def tree_specs(spec_tree, tree) -> list:
    """``spec_tree``'s leaves matched to ``tree``'s by name, in
    ``tree``'s order (raises where a name is missing)."""
    specs = dict(flatten_with_paths(spec_tree))
    out = []
    for name, _ in flatten_with_paths(tree):
        if name not in specs:
            raise ValueError(f"no spec for the leaf {name!r}")
        out.append(specs[name])
    return out


# ------------------------------------------------------------------ batches

class BatchGroup:
    """The ranks of a mesh that split a batch's rows: the axes
    ``axes`` (each of size >= 1), combined major to minor as a spec entry
    ``axes`` splits a dimension.  Ranks that differ along another axis
    hold the same rows."""

    def __init__(self, mesh, axes: Sequence[str]):
        sizes, pos = mesh_sizes(mesh), mesh_coords(mesh)
        self.mesh = mesh
        self.axes = tuple(axes)
        for a in self.axes:
            if a not in sizes:
                raise ValueError(f"batch axis {a!r} is not an axis of the "
                                 f"mesh {tuple(sizes)}")
        self.size = math.prod(sizes[a] for a in self.axes)
        self.index = 0
        for a in self.axes:
            self.index = self.index * sizes[a] + pos[a]
        self._live = [a for a in self.axes if sizes[a] > 1]

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch tensor (a view)."""
        b = x.shape[0]
        if b % self.size:
            raise ValueError(f"a batch of {b} rows does not split over "
                             f"{self.size} ranks of {self.axes}")
        n = b // self.size
        return x[self.index * n:(self.index + 1) * n]

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows in row order (the inverse of ``rows``)."""
        return gather(x, P(self.axes), self.mesh)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[size, *x.shape]``: every rank's ``x`` in row order."""
        return gather(x[None], P(self.axes), self.mesh)

    def sum(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        for a in self._live:
            x = all_reduce(x, self.mesh.get_group(a), op)
        return x


def axes_of(entry) -> tuple:
    """A spec entry (a name, a tuple of names or None) as a tuple."""
    return names(_entry(entry))


def sharded_global_norm(tree, spec_tree, mesh) -> torch.Tensor:
    """The L2 norm (float32) of a tree of blocks as of the global tree:
    each element counted once.  The squares of the leaves split over the
    same axes are summed here, then over those axes' groups; a leaf's
    replicas along the other axes are not added again."""
    leaves = [x for _, x in flatten_with_paths(tree)]
    sums = {}
    for x, sp in zip(leaves, tree_specs(spec_tree, tree)):
        key = live_axes(sp, mesh)
        sq = x.float().square().sum()
        sums[key] = sq if key not in sums else sums[key] + sq
    total = None
    for key in sorted(sums):
        s = sums[key]
        for a in key:
            s = all_reduce(s, mesh.get_group(a))
        total = s if total is None else total + s
    return torch.sqrt(total)


def all_reduce_mesh(x: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over every rank of the mesh (one axis at a time)."""
    for a, n in mesh_sizes(mesh).items():
        if n > 1:
            x = all_reduce(x, mesh.get_group(a), op)
    return x
