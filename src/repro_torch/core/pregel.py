"""BSP vertex-centric superstep engine — the Spark/GraphFrames analogue.

One Pregel superstep (Malewicz et al., the model GraphFrames ultimately
lowers to) is::

    gather   : read source-vertex state along edges        (local gather /
               all_gather over the ``model`` axis when vertex-sharded)
    message  : per-edge compute
    combine  : segment-reduce messages to destinations     (local)
    shuffle  : merge partial aggregates across edge shards (all_reduce
               SUM/MIN/MAX over the ``data`` axis of a DeviceMesh — Spark's
               shuffle becomes one collective)
    apply    : per-vertex state update

Everything is statically shaped: padded edges carry the sentinel vertex
id and are dropped at the segment-combine.  PyTorch runs eagerly, so the
superstep loop is a Python loop, and convergence is read on the host:
one ``.item()`` synchronisation per superstep (the reference decides it
on the device inside one ``lax.while_loop``; on a mesh the ranks first
sum their unconverged shards with one more ``all_reduce``).  Iteration
counts are the reference's exactly.  The per-superstep sync is the first
thing a later change removes, by capturing the loop in a CUDA graph.

Three strategies execute a superstep: the dense gather/segment-combine
path (``run_pregel``, the correctness oracle), the fused ELL kernel
(``run_pregel_fused``, the hand-written CUDA kernel on the card) and the
packed frontier (``run_pregel_frontier``).  They return bit-identical
states for min/max monoids and integer-valued sums.  On the card the
dense path runs a min/max program's superstep through the kernel's CSR
entry where ``csr_engages`` says it may, in one pass over the
destination-sorted edges, unless the caller asks for the plain version
(``use_kernels=False``, the oracle of parity runs); every other case
keeps the PyTorch ops.

A profiled execution hands each loop a :class:`Timeline`: the loop runs
as a ``gas.loop`` range on the profiler's timeline and each host read of
a device value in it as a ``gas.sync`` range, counted; without one the
loops do nothing more.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time
from typing import Callable, Optional

import torch
from torch.profiler import record_function

from repro_torch.core.obs import REGION_PREFIX
from repro_torch.core.partition import ShardedCOO
from repro_torch.kernels.pregel_superstep import ops as superstep_ops
from repro_torch.kernels.pregel_superstep.ref import as_dtype, superstep_plain
from repro_torch.utils.roofline import count_collective


@dataclasses.dataclass(frozen=True)
class PregelSpec:
    """One vertex program.

    message : (src_state[E], w[E]) -> msg[E] or msg[E, M]; with
              ``needs_dst_state`` the signature is
              (src_state, w, dst_state) — an *edge* program that can read
              both endpoints.
    combine : the message monoid.  Either a single op ('sum'|'min'|'max')
              applied to the whole message, or a tuple of ``(op, width)``
              column groups for *structured* messages: the message's last
              axis is split into contiguous groups, each combined with its
              own monoid.
    apply   : (old_state[Vl], agg, vertex_ids[Vl], gval) -> new_state
    identity: identity element of the monoid — a scalar, or a tuple of
              per-group identities matching a grouped ``combine`` (fills
              vertices with no incoming message)
    halt    : optional (old, new, valid[Vl]) -> bool tensor ("converged");
              None runs exactly ``max_iters``.
    global_value : optional (state[Vl], ids, valid) -> scalar (or small
              tensor), fed to ``apply`` as ``gval`` (PageRank uses this
              for the dangling-mass redistribution).
    global_over_agg : compute ``global_value`` over the *new* combined
              aggregate instead of the pre-superstep state.

    Execution-strategy declarations (all optional; defaults keep the
    dense gather/segment-combine path, which remains the correctness
    oracle):

    elementwise_message : the message is elementwise torch code in
              ``(src_state, w)`` and shape-polymorphic — callable on
              ``[E]`` edge vectors (dense path) and ``[V, K]`` gathered
              ELL tiles (fused kernel) alike.  Prerequisite for the
              fused and frontier variants.  On the card the fused
              variant additionally needs one of the kernel's compiled
              edge programs (``kernels.pregel_superstep.ops``).
    frontier_mode : how sparse-active supersteps may skip inactive
              vertices.  ``'monotone'`` (min/max combines whose apply
              folds the aggregate into state with the same monoid —
              BFS/SSSP/CC) or ``'delta'`` (sum combines with
              integer-valued messages).  Both are *exact* — bit-identical
              trajectories to the dense path — under those conditions.
    frontier_init : optional ``state -> bool[V]`` activity predicate
              for the first frontier (monotone mode); default is
              ``state != identity``.
    message_dtype : reduced-precision message channel ('bfloat16' /
              'float16').  Messages are cast to this dtype right after
              the edge program, before the combine.  min/max monoids
              always tolerate this; sum monoids require
              ``allow_inexact_sum``.
    allow_inexact_sum : explicit opt-in for ``message_dtype`` on a sum
              monoid (the result is then approximate).
    """

    message: Callable
    combine: object
    apply: Callable
    identity: object
    halt: Optional[Callable] = None
    global_value: Optional[Callable] = None
    needs_dst_state: bool = False
    global_over_agg: bool = False
    elementwise_message: bool = False
    frontier_mode: Optional[str] = None
    frontier_init: Optional[Callable] = None
    message_dtype: Optional[str] = None
    allow_inexact_sum: bool = False


@dataclasses.dataclass(frozen=True)
class SuperstepVariant:
    """A planner-visible execution strategy for a PregelSpec runner.

    Registered in an AlgorithmDef's ``variants`` mapping next to the
    dense spec, so the cost model picks dense vs fused vs frontier per
    graph.  Engines dispatch it through ``Engine.run_superstep`` — which
    falls back to the dense path when the strategy's preconditions don't
    hold on that engine, keeping the variants contract (identical results
    on every variant) unconditional.
    """

    spec: PregelSpec
    mode: str  # 'fused' | 'frontier'


def _dtype_name(dtype) -> str:
    if isinstance(dtype, str):
        return str(as_dtype(dtype)).removeprefix("torch.")
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return getattr(dtype, "name", str(dtype))


def check_precision(spec: PregelSpec) -> None:
    """Validate the reduced-precision declaration of a spec.

    min/max monoids are always safe (rounding is per-message; the
    combine itself is exact in any order).  Inexact sums are only
    allowed behind the explicit opt-in, and structured (grouped-monoid)
    messages can't take a single channel dtype at all.
    """
    if spec.message_dtype is None:
        return
    if isinstance(spec.combine, tuple):
        raise ValueError(
            "message_dtype: structured (grouped-monoid) messages do not "
            "support a reduced-precision channel")
    if spec.combine == "sum" and not spec.allow_inexact_sum:
        raise ValueError(
            "message_dtype with a 'sum' monoid accumulates rounding "
            "error; opt in explicitly with allow_inexact_sum=True")


def reduced_precision(spec: PregelSpec, dtype,
                      allow_inexact_sum: Optional[bool] = None) -> PregelSpec:
    """Derive a spec whose message channel runs in ``dtype`` (a name or a
    ``torch.dtype``)."""
    s = dataclasses.replace(
        spec, message_dtype=_dtype_name(dtype),
        allow_inexact_sum=(spec.allow_inexact_sum
                           if allow_inexact_sum is None
                           else allow_inexact_sum))
    check_precision(s)
    return s


def converged_halt(old, new, valid):
    """The standard fixpoint predicate: no valid vertex changed state.
    Shared by every to-convergence vertex program (CC, traversal, LPA,
    k-core peeling)."""
    return torch.logical_not(torch.any(torch.logical_and(valid, new != old)))


class Lifted:
    """A scalar message lifted onto a trailing batch axis.

    Calls ``torch.func.vmap`` of ``base``; ``base`` stays reachable so
    that the fused kernel's wrapper can find the compiled edge program
    behind a batched message (it picks programs by identity)."""

    def __init__(self, base: Callable, in_dims):
        self.base = base
        self._fn = torch.func.vmap(base, in_dims=in_dims, out_dims=-1)

    def __call__(self, *args):
        return self._fn(*args)


@functools.lru_cache(maxsize=64)
def batched_spec(spec: PregelSpec) -> PregelSpec:
    """Lift a scalar vertex program onto a trailing batch axis.

    The returned spec runs B independent instances of ``spec`` as *one*
    program over state ``[Vl, B]`` — the fused-batch substrate of the
    service layer (B BFS frontiers with different sources share every
    gather and segment-combine of every superstep).  Each column's
    arithmetic is the unbatched program's, element for element (vmap
    only widens the ops; ``w`` is shared by every column), and the
    monoid combines are exact per column, so column ``b`` of the fused
    result is bit-identical to running instance ``b`` alone.  The fused
    ``halt`` is the AND over columns; converged columns sit at their
    fixpoint (apply is a no-op there) while stragglers finish.

    Memoized (bounded) so repeated fusions of the same program share one
    spec.  Structured (grouped-monoid) messages split columns
    positionally and cannot carry a trailing batch axis — rejected up
    front.
    """
    if isinstance(spec.combine, tuple):
        raise ValueError(
            "batched_spec: structured (grouped-monoid) messages cannot "
            "be lifted onto a batch axis")
    msg_axes = (-1, None, -1) if spec.needs_dst_state else (-1, None)
    vmap = torch.func.vmap
    message = Lifted(spec.message, msg_axes)
    # with a global_value the per-column scalars arrive as a trailing-B
    # vector and each column's apply reads its own entry
    gval_axis = None if spec.global_value is None else -1
    apply_ = vmap(spec.apply, in_dims=(-1, -1, None, gval_axis), out_dims=-1)

    halt = None
    if spec.halt is not None:
        per_col = vmap(spec.halt, in_dims=(-1, -1, None))

        def halt(old, new, valid):
            return torch.all(per_col(old, new, valid))

    gval = None
    if spec.global_value is not None:
        gval = vmap(spec.global_value, in_dims=(-1, None, None), out_dims=-1)

    # activity is per vertex: a vertex is active if ANY column is (the
    # frontier loop reduces trailing axes with `any` after this)
    frontier_init = None
    if spec.frontier_init is not None:
        frontier_init = vmap(spec.frontier_init, in_dims=-1, out_dims=-1)

    return PregelSpec(
        message=message, combine=spec.combine, apply=apply_,
        identity=spec.identity, halt=halt, global_value=gval,
        needs_dst_state=spec.needs_dst_state,
        global_over_agg=spec.global_over_agg,
        elementwise_message=spec.elementwise_message,
        frontier_mode=spec.frontier_mode,
        frontier_init=frontier_init,
        message_dtype=spec.message_dtype,
        allow_inexact_sum=spec.allow_inexact_sum)


_REDUCE = {"min": "amin", "max": "amax"}
_SUM_CHUNK = 1 << 24      # message elements cast to float64 at a time


def _local_combine(msgs, index, v_local, op, identity):
    """Segment-combine messages into the ``v_local`` owned vertices.

    ``index`` is the int64 segment id of each message; padding edges aim
    at the extra segment ``v_local``, which is dropped.  Empty min/max
    segments hold the declared identity: the output starts at the
    identity and ``include_self=False`` reduces a non-empty segment over
    its messages only, exactly as the reference's segment_min/max plus
    identity normalization does.  Grouped ``op`` splits the message's
    last axis into ``(op, width)`` column groups, each combined under its
    own monoid.

    float32 sums accumulate in float64 and round once: a running float32
    sum over one vertex's messages can lose up to ``degree * 2^-24`` of
    its value, and power-law graphs have vertices of in-degree 10^5-10^6
    (with float32 accumulation HITS on the 2^22 user-follow graph of
    ``chip_smoke.py`` drifts past its 1e-4 tolerance).  Integer-valued
    sums are exact either way, so they stay bit-identical to the fused
    and frontier paths.
    """
    if isinstance(op, tuple):
        parts, c0 = [], 0
        for (o, width), ident in zip(op, identity):
            parts.append(_local_combine(msgs[..., c0:c0 + width], index,
                                        v_local, o, ident))
            c0 += width
        return torch.cat(parts, dim=-1)
    shape = (v_local + 1,) + tuple(msgs.shape[1:])
    if op == "sum":
        if msgs.dtype != torch.float32:
            out = torch.zeros(shape, dtype=msgs.dtype, device=msgs.device)
            return out.index_add_(0, index, msgs)[:v_local]
        out = torch.zeros(shape, dtype=torch.float64, device=msgs.device)
        # float64 copies of a slice of rows at a time: a whole copy would
        # add twice the messages' bytes (16.6 GB more for LPA's [E, 64]
        # mass channels at 2^22)
        rows = max(1, _SUM_CHUNK // max(1, math.prod(msgs.shape[1:])))
        for r0 in range(0, msgs.shape[0], rows):
            out.index_add_(0, index[r0:r0 + rows],
                           msgs[r0:r0 + rows].to(torch.float64))
        return out[:v_local].to(torch.float32)
    if op not in _REDUCE:
        raise ValueError(op)
    out = torch.full(shape, identity, dtype=msgs.dtype, device=msgs.device)
    idx = index
    if msgs.dim() > 1:
        idx = index.view((-1,) + (1,) * (msgs.dim() - 1)).expand_as(msgs)
    out.scatter_reduce_(0, idx, msgs, reduce=_REDUCE[op], include_self=False)
    return out[:v_local]


_NO_RANGE = contextlib.nullcontext()


def profiler_range(name: str):
    """The ``torch.profiler`` range ``name`` while a profiler records on
    this thread, else nothing: a range entered with none recording shows
    nowhere and costs tens of microseconds a region on the card's host
    (torch's data pipes gate their ranges the same way)."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _NO_RANGE


class Timeline:
    """Where one profiled execution spends its time, region by region
    on the profiler's timeline: the start state built and put on the
    device (``gas.init``), each superstep loop (``gas.loop``) and each
    host read of a device value inside one (``gas.sync``).  It sums the
    start state's host seconds, counts the reads (``host_syncs``) and,
    on a CUDA device, records an event at each loop's entry and exit.
    The events are read only by :meth:`span_ms`, after the work: no
    sync is added inside a loop.  ``kernel_supersteps`` counts the dense
    supersteps that ran through the kernel's CSR entry."""

    def __init__(self):
        self.init_wall_s = 0.0
        self.host_syncs = 0
        self.kernel_supersteps = 0
        self.inits = 0
        self.loops = 0
        self._events: list = []

    @contextlib.contextmanager
    def init(self):
        t0 = time.perf_counter()
        try:
            with profiler_range(REGION_PREFIX + "init"):
                yield
        finally:
            self.init_wall_s += time.perf_counter() - t0
            self.inits += 1

    @contextlib.contextmanager
    def loop(self, device):
        events = None
        if torch.device(device).type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        with profiler_range(REGION_PREFIX + "loop"):
            if events is not None:
                events[0].record()
            yield
            if events is not None:
                events[1].record()
                self._events.append(events)
        self.loops += 1

    def read(self, flag) -> bool:
        """``bool(flag)``, a device value read on the host: counted."""
        self.host_syncs += 1
        with profiler_range(REGION_PREFIX + "sync"):
            return bool(flag)

    def nonzero(self, mask) -> torch.Tensor:
        """``torch.nonzero(mask)``, whose length the host reads:
        counted."""
        self.host_syncs += 1
        with profiler_range(REGION_PREFIX + "sync"):
            return torch.nonzero(mask)

    def span_ms(self) -> float:
        """The loops' spans on the device's clock, in milliseconds, each
        from its entry event to its exit event: the launch gaps and the
        host syncs between are inside.  Waits for the last event."""
        total = 0.0
        for start, end in self._events:
            end.synchronize()
            total += start.elapsed_time(end)
        return total

    def as_dict(self) -> dict:
        """What was recorded: ``init_wall_s`` where a start state was
        built, ``host_syncs`` and ``kernel_supersteps`` where a loop ran,
        and ``loop_span_ms`` where it ran on a CUDA device, as
        :meth:`span_ms` (a callable: reading it waits for the device).
        Empty where nothing ran."""
        out: dict = {}
        if self.inits:
            out["init_wall_s"] = self.init_wall_s
        if self.loops:
            out["host_syncs"] = self.host_syncs
            out["kernel_supersteps"] = self.kernel_supersteps
        if self._events:
            out["loop_span_ms"] = self.span_ms
        return out


def _loop_region(timeline: Optional[Timeline], device):
    return contextlib.nullcontext() if timeline is None \
        else timeline.loop(device)


def _superstep_loop(one_iter, state, max_iters, halt, timeline=None):
    """Run ``one_iter`` to the halt or ``max_iters``: the reference's
    ``while i < max_iters and not done`` with the halt read on the host
    (one synchronisation per superstep, counted by ``timeline``).
    Returns ``(state, iters)``."""
    with _loop_region(timeline, state.device):
        if halt is None:
            for _ in range(max_iters):
                state = one_iter(state)
            return state, int(max_iters)
        i = 0
        while i < max_iters:
            new = one_iter(state)
            i += 1
            flag = halt(state, new)
            done = bool(flag) if timeline is None else timeline.read(flag)
            state = new
            if done:
                break
        return state, i


def _gval(spec, state, agg, ids, valid):
    if spec.global_value is None:
        return 0.0
    g_src = agg if spec.global_over_agg else state
    return spec.global_value(g_src, ids, valid)


class MeshAxes:
    """This rank's place on a ``DeviceMesh``: its coordinate, each axis'
    size and the process group along it (``model`` may be absent: one
    model shard)."""

    def __init__(self, mesh, axis_data: str = "data",
                 axis_model: str = "model"):
        names = tuple(mesh.mesh_dim_names or ())
        if axis_data not in names:
            raise ValueError(f"the mesh has no {axis_data!r} axis: {names}")
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not on the mesh")
        sizes = dict(zip(names, mesh.mesh.shape))
        at = dict(zip(names, coord))
        self.n_data, self.d = int(sizes[axis_data]), int(at[axis_data])
        self.data_group = mesh.get_group(axis_data)
        if axis_model in names:
            self.n_model, self.m = int(sizes[axis_model]), int(at[axis_model])
            self.model_group = mesh.get_group(axis_model)
        else:
            self.n_model, self.m, self.model_group = 1, 0, None
        self._ranks, self._coord = mesh.mesh, list(coord)
        self._i_data = names.index(axis_data)
        self._i_model = names.index(axis_model) if axis_model in names \
            else None

    def rank_at(self, d: int, m: int = 0) -> int:
        """The global rank at ``(d, m)`` (other axes: this rank's)."""
        c = list(self._coord)
        c[self._i_data] = d
        if self._i_model is not None:
            c[self._i_model] = m
        return int(self._ranks[tuple(c)])

    def broadcast_object(self, obj):
        """``obj`` as the rank at ``(0, 0)`` holds it, on every rank:
        broadcast along ``data`` from ``(0, 0)``, then along ``model``
        from ``(d, 0)``."""
        import torch.distributed as dist
        box = [obj]
        if self.m == 0:
            dist.broadcast_object_list(box, src=self.rank_at(0, 0),
                                       group=self.data_group)
        if self.model_group is not None:
            dist.broadcast_object_list(box, src=self.rank_at(self.d, 0),
                                       group=self.model_group)
        return box[0]


_DIST_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


def _all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """``lax.psum`` / ``pmin`` / ``pmax`` over one mesh axis (in place
    on a contiguous ``x``; returns the reduced tensor)."""
    import torch.distributed as dist
    x = x.contiguous()
    dist.all_reduce(x, op=getattr(dist.ReduceOp, _DIST_OPS[op]), group=group)
    count_collective("all-reduce", x.nbytes, group)
    return x


def _all_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)`` along the leading axis.  The
    list form of ``all_gather`` writes straight into the chunks of one
    output tensor; every supported PyTorch has it, and none warns that
    it is going away."""
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather(list(out.chunk(n)), x, group=group)
    count_collective("all-gather", out.nbytes, group)
    return out


def _shard_combine(agg, op, group):
    """Cross-shard merge of partial aggregates (grouped ops one column
    group at a time)."""
    if isinstance(op, tuple):
        parts, c0 = [], 0
        for o, width in op:
            parts.append(_all_reduce(agg[..., c0:c0 + width], o, group))
            c0 += width
        return torch.cat(parts, dim=-1)
    return _all_reduce(agg, op, group)


def _local_shard(sg: ShardedCOO, ax: MeshAxes, device) -> ShardedCOO:
    """This rank's shard of ``sg`` on ``device`` (cut once and cached on
    ``sg``); ``sg`` itself when it already is that one shard."""
    sharded = sg.vertex_layout == "sharded"
    if sg.n_data != ax.n_data:
        raise ValueError(f"{sg.n_data} data shards on a mesh whose data "
                         f"axis has {ax.n_data} ranks")
    if sharded and sg.n_model != ax.n_model:
        raise ValueError(f"{sg.n_model} model shards on a mesh whose "
                         f"model axis has {ax.n_model} ranks")
    m = ax.m if sharded else 0
    if sg.coord is not None:
        if tuple(sg.coord) != (ax.d, m):
            raise ValueError(f"the shard of {tuple(sg.coord)} on the rank "
                             f"at {(ax.d, m)}")
        return sg
    key = ("shard", ax.d, m, str(device))
    got = sg._index_cache.get(key)
    if got is None:
        got = sg.shard(ax.d, m, device=device)
        sg._index_cache[key] = got
    return got


def run_pregel(
    spec: PregelSpec,
    sg: ShardedCOO,
    init_state: torch.Tensor,
    max_iters: int,
    mesh=None,
    axis_data: str = "data",
    axis_model: str = "model",
    timeline: Optional[Timeline] = None,
    use_kernels: bool = True,
):
    """Run the vertex program to convergence (or ``max_iters``).

    Returns ``(final_state [V or n_model*v_local], iterations_run)``.
    With ``mesh=None`` the edge shards of a 1-D ``ShardedCOO`` are
    concatenated and combined as one on one device.  On a
    ``DeviceMesh`` every rank runs this same call (SPMD): it combines its
    own shard, merges the partial aggregates with one ``all_reduce`` over
    ``data`` (a grouped combine one column group at a time), and in the
    2-D layout gathers the vertex state over ``model`` once a superstep
    and sums ``global_value`` over ``model``.  The halt's unconverged
    shards are summed over the mesh, so every rank runs the same
    supersteps, and every rank returns the whole state.  A model axis
    larger than a 1-D layout's one shard replicates the program.  State
    ``[V, B]`` under a ``batched_spec`` program is gathered and combined
    one column at a time; apply and halt see all of it.
    ``use_kernels=True`` runs a superstep through the kernel's CSR entry
    where ``csr_engages`` allows it; ``False`` keeps the PyTorch ops
    everywhere (parity runs).
    """
    check_precision(spec)
    if mesh is None:
        if sg.vertex_layout == "sharded":
            raise ValueError("run_pregel: a vertex-sharded layout needs a "
                             "mesh")
        return _run_dense(spec, sg, init_state, max_iters, None, timeline,
                          use_kernels)
    ax = MeshAxes(mesh, axis_data, axis_model)
    return _run_dense(spec, _local_shard(sg, ax, init_state.device),
                      init_state, max_iters, ax, timeline, use_kernels)


def csr_engages(spec: PregelSpec, state, ax) -> bool:
    """Whether a dense superstep of ``spec`` over ``state`` (one column of
    a ``batched_spec`` program's) may run through the kernel's CSR entry
    (``superstep_ops.csr_superstep``): 1-D int32 or float32 state on a
    CUDA device, a min or max combine of one of the compiled edge
    programs on the source's state alone, at full precision, with no
    mesh.  The layout must also read as a CSR (``ShardedCOO.csr_index``).
    Every other case keeps the PyTorch ops: sums, grouped monoids,
    two-endpoint programs, reduced-precision channels, meshes, the CPU."""
    message = spec.message.base if isinstance(spec.message, Lifted) \
        else spec.message
    return (ax is None and state.device.type == "cuda" and state.dim() == 1
            and state.dtype in (torch.int32, torch.float32)
            and spec.combine in ("min", "max")
            and not spec.needs_dst_state and spec.message_dtype is None
            and superstep_ops.compiled(message))


def _run_dense(spec, sg, init_state, max_iters, ax, timeline, use_kernels):
    V = sg.n_vertices
    v_local = sg.v_local
    sharded = sg.vertex_layout == "sharded"
    dev = init_state.device
    start = sg.v_start
    n_state = init_state.shape[0]
    if sharded:
        if n_state != sg.n_pad:
            raise ValueError(f"run_pregel: 2-D state must be padded to "
                             f"n_pad = {sg.n_pad}, got {n_state}")
        init_state = init_state[start:start + v_local]
    ids = start + torch.arange(v_local, dtype=torch.int32, device=dev)
    valid = ids < V
    freeze = start + v_local > V
    by_column = isinstance(spec.message, Lifted) and init_state.dim() == 2
    csr = sg.csr_index() if use_kernels and csr_engages(
        spec, init_state[:, 0] if by_column else init_state, ax) else None
    if csr is None:
        src_idx = sg.gather_index("src", n_state)
        dst_idx = sg.gather_index("dst", n_state) \
            if spec.needs_dst_state else None
        seg = sg.combine_index()

    def messages(message, state):
        if csr is not None:
            return superstep_ops.csr_superstep(
                csr, sg.src, sg.w, state, message=message, op=spec.combine,
                identity=spec.identity)
        src_state = state.index_select(0, src_idx)
        if spec.needs_dst_state:
            msgs = message(src_state, sg.w, state.index_select(0, dst_idx))
        else:
            msgs = message(src_state, sg.w)
        if spec.message_dtype is not None:
            msgs = msgs.to(as_dtype(spec.message_dtype))
        return _local_combine(msgs, seg, v_local, spec.combine,
                              spec.identity)

    def one_iter(state):
        if csr is not None and timeline is not None:
            timeline.kernel_supersteps += 1
        full = _all_gather(state, ax.model_group, ax.n_model) if sharded \
            else state
        if by_column:
            # a batched_spec program: each column gathered, messaged and
            # combined as its query alone is (torch gathers [E, B] rows
            # several times slower than B columns of [E]).  The state and
            # the aggregate stay [B, V] in memory: the vmapped hooks keep
            # that layout, so the transpose below copies nothing
            cols = full.t().contiguous()
            agg = torch.stack([messages(spec.message.base, col)
                               for col in cols])
            if ax is not None:
                agg = _shard_combine(agg, spec.combine, ax.data_group)
            agg = agg.t()
        else:
            agg = messages(spec.message, full)
            if ax is not None:
                agg = _shard_combine(agg, spec.combine, ax.data_group)
        gval = _gval(spec, state, agg, ids, valid)
        if sharded and spec.global_value is not None:
            gval = _all_reduce(torch.as_tensor(gval, device=dev), "sum",
                               ax.model_group)
        new = spec.apply(state, agg, ids, gval)
        if freeze:                              # freeze padding slots
            vmask = valid.reshape(valid.shape + (1,) * (new.dim() - 1))
            new = torch.where(vmask, new, state)
        return new

    halt = None
    if spec.halt is not None and ax is None:
        def halt(old, new):
            return spec.halt(old, new, valid)
    elif spec.halt is not None:
        def halt(old, new):
            # shards unconverged anywhere on the mesh (the 1-D layout's
            # model replicas agree, so they are not counted twice)
            conv = torch.as_tensor(spec.halt(old, new, valid), device=dev)
            not_conv = torch.logical_not(conv).to(torch.int32).reshape(1)
            not_conv = _all_reduce(not_conv, "sum", ax.data_group)
            if sharded:
                not_conv = _all_reduce(not_conv, "sum", ax.model_group)
            return not_conv[0] == 0

    if by_column:
        init_state = init_state.t().contiguous().t()
    state, iters = _superstep_loop(one_iter, init_state, max_iters, halt,
                                   timeline)
    if sharded:
        state = _all_gather(state, ax.model_group, ax.n_model)
    return (state.contiguous() if by_column else state), iters


def _check_superstep_spec(spec: PregelSpec, what: str) -> None:
    check_precision(spec)
    if not spec.elementwise_message:
        raise ValueError(f"{what}: spec does not declare "
                         "elementwise_message")
    if spec.needs_dst_state:
        raise ValueError(f"{what}: two-endpoint edge programs are "
                         "dense-path only")
    if isinstance(spec.combine, tuple):
        raise ValueError(f"{what}: structured (grouped-monoid) messages "
                         "are dense-path only")


def run_pregel_fused(
    spec: PregelSpec,
    ell,
    init_state: torch.Tensor,
    max_iters: int,
    use_kernels: bool = True,
    timeline: Optional[Timeline] = None,
):
    """Run the vertex program with the fused-superstep kernel.

    Same contract and return value as ``run_pregel``, but each superstep
    is one pass over the in-neighbor ELL layout
    (``kernels/pregel_superstep``): gather src state → edge program →
    monoid combine into dst rows, with no [E] message tensor and no
    separate segment-combine launch.  Bit-identical to the dense path for
    min/max monoids and integer-valued sums.

    ``use_kernels=True`` goes through the kernel's wrapper: the CUDA
    kernel for state on the card, its plain version for state on the
    CPU.  ``use_kernels=False`` runs the plain version wherever the state
    lives (parity runs).  ``ell`` is the uncapped ``direction='in'``
    layout over the full graph (every edge retained).  State ``[V, B]``
    (a ``batched_spec`` program) is handed to the kernel row-major.
    """
    _check_superstep_spec(spec, "run_pregel_fused")
    V = ell.n_vertices
    if init_state.shape[0] != V:
        raise ValueError("run_pregel_fused: state must be unpadded: "
                         "[V] or [V, B]")
    step = superstep_ops.fused_superstep if use_kernels else superstep_plain
    ids = torch.arange(V, dtype=torch.int32, device=init_state.device)
    valid = ids < V        # all True; uniform halt/global signature

    def one_iter(state):
        state = state.contiguous()
        agg = step(ell.nbr, ell.mask, ell.w, state, message=spec.message,
                   op=spec.combine, identity=spec.identity,
                   message_dtype=spec.message_dtype)
        return spec.apply(state, agg, ids, _gval(spec, state, agg, ids,
                                                 valid))

    halt = None if spec.halt is None else \
        (lambda old, new: spec.halt(old, new, valid))
    return _superstep_loop(one_iter, init_state, max_iters, halt, timeline)


def _reduce_active(ch):
    while ch.dim() > 1:
        ch = torch.any(ch, dim=-1)
    return ch


def run_pregel_frontier(
    spec: PregelSpec,
    ell,
    init_state: torch.Tensor,
    max_iters: int,
    init_active: Optional[torch.Tensor] = None,
    profile: bool = False,
    timeline: Optional[Timeline] = None,
):
    """Run the vertex program with frontier compression.

    ``ell`` is the uncapped ``direction='out'`` layout: row ``u`` lists
    the destinations of u's out-edges, so scanning the frontier's rows
    touches exactly the edges incident to active vertices.  Each
    superstep packs the active vertices (``torch.nonzero``, which
    synchronises) and scatters only their messages.  The reference walks
    the packed list in fixed-size blocks to keep shapes static; eager
    PyTorch scatters the whole frontier at once, which gives the same
    result because min/max and integer sums are order-independent.

    Exactness (the reason results are bit-identical to dense):

    * ``'monotone'`` — the aggregate is rebuilt each round from active
      sources only and folded into state by apply's own min/max.  A
      source unchanged since round t delivered the same message at
      round t and the fold made it permanent; re-delivering it is a
      no-op.
    * ``'delta'`` — the full sum aggregate is carried across rounds;
      round 1 scatters every message, later rounds scatter
      ``msg(new) - msg(old)`` for changed sources.  Exact when messages
      are integer-valued in their dtype.

    The apply/halt/global_value hooks run densely over the full state,
    so iteration counts and gval match the dense path element for
    element.

    ``init_active`` (monotone mode only) overrides the first frontier
    with an explicit ``bool [V]`` mask — the incremental-maintenance
    seam.  Ignored in delta mode.

    ``profile=True`` additionally returns a ``[max_iters] int32`` tensor
    (on the host) of per-round frontier occupancy (untaken rounds stay
    0) as a third output; it records values the loop computes anyway.
    ``timeline`` counts the host syncs: one pack before the loop, then a
    pack and (with a halt) a halt read a superstep.
    """
    _check_superstep_spec(spec, "run_pregel_frontier")
    mode = spec.frontier_mode
    if mode not in ("monotone", "delta"):
        raise ValueError(f"run_pregel_frontier: spec declares no "
                         f"frontier_mode (got {mode!r})")
    if mode == "monotone" and spec.combine not in ("min", "max"):
        raise ValueError("frontier_mode='monotone' requires a min/max "
                         "combine")
    if mode == "delta" and spec.combine != "sum":
        raise ValueError("frontier_mode='delta' requires a 'sum' combine")
    V = ell.n_vertices
    K = ell.nbr.shape[1]
    if init_state.shape[0] != V:
        raise ValueError("run_pregel_frontier: state must be unpadded: "
                         "[V] or [V, B]")
    dev = init_state.device
    trailing = tuple(init_state.shape[1:])
    delta = mode == "delta"
    ids = torch.arange(V, dtype=torch.int32, device=dev)
    valid = ids < V
    probe = spec.message(torch.zeros((1, 1) + trailing,
                                     dtype=init_state.dtype),
                         torch.zeros((1, 1), dtype=ell.w.dtype))
    agg_dtype = (as_dtype(spec.message_dtype)
                 if spec.message_dtype is not None else probe.dtype)
    agg_shape = (V + 1,) + tuple(probe.shape[2:])
    fill = 0 if delta else spec.identity

    def scatter_frontier(acc, state, prev, frontier, first):
        row = frontier.long()
        rn, rm, rw = ell.nbr[row], ell.mask[row], ell.w[row]
        F = row.shape[0]
        src = state[row][:, None].expand((F, K) + trailing)
        msgs = spec.message(src, rw)
        if delta and not first:
            prev_src = prev[row][:, None].expand((F, K) + trailing)
            msgs = msgs - spec.message(prev_src, rw)
        if spec.message_dtype is not None:
            msgs = msgs.to(as_dtype(spec.message_dtype))
        m = rm
        if msgs.dim() > m.dim():
            m = m.reshape(tuple(m.shape) + (1,) * (msgs.dim() - m.dim()))
        msgs = torch.where(m, msgs.to(agg_dtype),
                           torch.tensor(fill, dtype=agg_dtype, device=dev))
        # masked-off slots aim at the sentinel row V
        dst_f = torch.where(rm, rn, V).reshape(-1).long()
        mf = msgs.reshape((F * K,) + tuple(msgs.shape[2:]))
        if spec.combine == "sum":
            return acc.index_add_(0, dst_f, mf)
        if mf.dim() > 1:
            dst_f = dst_f.view((-1,) + (1,) * (mf.dim() - 1)).expand_as(mf)
        return acc.scatter_reduce_(0, dst_f, mf, reduce=_REDUCE[spec.combine],
                                   include_self=True)

    def one_superstep(s, agg):
        return spec.apply(s, agg, ids, _gval(spec, s, agg, ids, valid))

    if delta:
        act0 = torch.ones(V, dtype=torch.bool, device=dev)
    elif init_active is not None:
        act0 = init_active.to(device=dev, dtype=torch.bool)
    elif spec.frontier_init is not None:
        act0 = _reduce_active(spec.frontier_init(init_state))
    else:
        act0 = _reduce_active(
            init_state != torch.tensor(spec.identity,
                                       dtype=init_state.dtype, device=dev))
    pack = torch.nonzero if timeline is None else timeline.nonzero
    occupancy = []
    state, prev = init_state, init_state
    acc = torch.zeros(agg_shape, dtype=agg_dtype, device=dev) if delta \
        else None
    i = 0
    with _loop_region(timeline, dev):
        frontier = pack(act0).flatten()
        while i < max_iters:
            occupancy.append(int(frontier.shape[0]))
            if delta:
                acc = scatter_frontier(acc, state, prev, frontier, i == 0)
            else:
                acc = scatter_frontier(
                    torch.full(agg_shape, fill, dtype=agg_dtype,
                               device=dev),
                    state, None, frontier, False)
            new = one_superstep(state, acc[:V])
            frontier = pack(_reduce_active(new != state)).flatten()
            done = False
            if spec.halt is not None:
                flag = spec.halt(state, new, valid)
                done = bool(flag) if timeline is None \
                    else timeline.read(flag)
            i += 1
            prev, state = state, new
            if done:
                break
    if profile:
        occ = torch.zeros(max_iters, dtype=torch.int32)
        occ[:len(occupancy)] = torch.tensor(occupancy, dtype=torch.int32)
        return state, i, occ
    return state, i
