"""Device-ready graph representations (PyTorch).

The paper's platform moves graphs between a distributed dataflow engine
(Spark/GraphFrames) and an in-memory graph database (Neo4j).  Every
representation here is fixed-shape tensors on one device:

* ``GraphCOO``  — destination-sorted edge list, padded with a sentinel
  vertex id ``V`` so a segment-combine over ``V + 1`` segments drops
  padding for free.  This is the *exact* format (no degree cap) and the
  unit of edge partitioning for the distributed engine.
* ``GraphCSR``  — ``indptr/indices``; the "index-free adjacency"
  analogue: pointer-chase becomes slice.
* ``GraphELL`` — per-vertex neighbor lists padded to a max degree ``K``.
  This is the paper's ``MaxAdjacentNodes`` cap (Table I) turned into a
  fixed-width layout: gather + masked row-reduce, skew becomes padding
  instead of stragglers.  The fused superstep kernel runs over it.
* ``OrientedELL`` — degree-ordered orientation of an undirected graph:
  each edge {u, v} kept once, directed from the lower-(degree, id) rank
  endpoint to the higher, with per-vertex *sorted* out-neighbor rows.

All constructors take host-side ``np.ndarray`` edge lists (the ETL layer
works in numpy, like Scalding worked in Hadoop), build on the host, and
move the finished buffers to ``device`` at the end.  ``device=None`` is
the first CUDA device (see :func:`repro_torch.device.resolve_device`).
Dtypes are the reference package's: int32 ids and sentinel, bool masks,
float32 weights — so buffers and ``content_digest`` agree byte for byte.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:        # e.g. a view of another package's
        arr = arr.copy()               # buffer: torch wants to own it
    return torch.from_numpy(arr).to(device)


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True, eq=False)
class GraphDelta:
    """One snapshot-to-snapshot edge edit, as applied by
    :meth:`GraphCOO.apply_delta`.

    ``added``/``removed`` are ``[n, 2]`` int64 host arrays of logical
    (src, dst) pairs — *before* symmetrization, so an undirected graph's
    delta records each touched undirected edge once.  ``touched`` is the
    sorted unique endpoint set of every changed edge: the seed frontier
    for incremental algorithm maintenance, and the planner's estimate of
    how much of the graph an incremental recompute must visit.
    """

    added: np.ndarray      # [n_added, 2] int64
    removed: np.ndarray    # [n_removed, 2] int64
    touched: np.ndarray    # [n_touched] int32, sorted unique endpoints

    @property
    def n_added(self) -> int:
        return int(self.added.shape[0])

    @property
    def n_removed(self) -> int:
        return int(self.removed.shape[0])

    @property
    def n_touched(self) -> int:
        return int(self.touched.shape[0])

    def nbytes(self) -> int:
        """Bytes a consumer must ingest to apply this delta — the
        planner's incremental-path transfer term."""
        return int(self.added.nbytes + self.removed.nbytes
                   + self.touched.nbytes)


@dataclasses.dataclass
class GraphCOO:
    """Destination-sorted, padded COO edge list.

    Padding edges have ``src == dst == n_vertices`` (the sentinel row) and
    ``w == 0``.
    """

    src: torch.Tensor   # [E_pad] int32
    dst: torch.Tensor   # [E_pad] int32, sorted ascending
    w: torch.Tensor     # [E_pad] float32 (1.0 for unweighted)
    n_vertices: int
    n_edges: int        # true edge count
    symmetric: bool = False   # built via symmetrize=True (metadata; set it
                              # manually if the edge list is already
                              # symmetric by construction)

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def e_pad(self) -> int:
        return int(self.src.shape[0])

    def nbytes(self) -> int:
        return self.e_pad * (4 + 4 + 4)

    def to(self, device) -> "GraphCOO":
        """This graph on ``device`` (``self`` when already there).  The
        digest memo and recorded lineage ride along: moving bytes does
        not change what the graph is."""
        device = torch.device(device)
        if self.device == device:
            return self
        out = GraphCOO(self.src.to(device), self.dst.to(device),
                       self.w.to(device), self.n_vertices, self.n_edges,
                       self.symmetric)
        for attr in ("_content_digest", "parent_digest", "delta"):
            if hasattr(self, attr):
                setattr(out, attr, getattr(self, attr))
        return out

    def content_digest(self) -> str:
        """Content identity of this graph: a digest over the true (un-padded)
        edge buffers plus the structural metadata.  Two byte-identical
        graphs — e.g. the same snapshot reloaded — share one digest, and
        distinct graphs can never collide the way recycled ``id()``
        values can.  Computed once (one device->host transfer) and
        memoized on the instance.  Equal to the reference package's
        digest for the same bytes."""
        d = getattr(self, "_content_digest", None)
        if d is None:
            h = hashlib.blake2b(digest_size=16)
            h.update(f"{self.n_vertices}|{self.n_edges}|"
                     f"{self.symmetric}".encode())
            for buf in (self.src, self.dst, self.w):
                h.update(np.ascontiguousarray(
                    to_numpy(buf[: self.n_edges])).tobytes())
            d = h.hexdigest()
            self._content_digest = d
        return d

    def apply_delta(
        self,
        added=None,
        removed=None,
        added_w: Optional[np.ndarray] = None,
        pad_multiple: int = 1024,
    ) -> "GraphCOO":
        """Edit the edge set without re-landing the snapshot: returns a
        new canonical :class:`GraphCOO` on the same device with recorded
        lineage.

        ``added``/``removed`` are iterables of logical (src, dst) pairs
        (anything ``np.asarray`` reshapes to ``[n, 2]``).  On a
        symmetric graph each logical pair stands for the undirected
        edge — both directions are edited.  Removals apply before
        additions, so remove+add of the same pair is a weight update;
        adding an edge that already exists is a no-op (the existing
        weight wins, matching ``build_coo``'s first-occurrence dedup).

        Because the result routes through ``build_coo``'s
        canonicalization (dedup + destination sort), its
        ``content_digest`` is **bit-identical** to building the edited
        edge list from scratch — lineage-equal graphs are cache-equal.
        The new graph carries ``parent_digest`` (this graph's digest)
        and ``delta`` (a :class:`GraphDelta`) as plain host attributes
        for the catalog's lineage chain and the planner's
        incremental-vs-full pricing.
        """
        def _pairs(edges) -> np.ndarray:
            if edges is None:
                return np.zeros((0, 2), dtype=np.int64)
            e = np.asarray(edges, dtype=np.int64)
            return e.reshape(-1, 2) if e.size else np.zeros((0, 2),
                                                            dtype=np.int64)

        add = _pairs(added)
        rem = _pairs(removed)
        V = self.n_vertices
        for name, e in (("added", add), ("removed", rem)):
            if e.size and (e.min() < 0 or e.max() >= V):
                raise ValueError(
                    f"apply_delta: {name} edge endpoints must lie in "
                    f"[0, {V}); got range [{e.min()}, {e.max()}]")
        touched = np.unique(
            np.concatenate([add.ravel(), rem.ravel()])).astype(np.int32)

        if added_w is None:
            add_w = np.ones(add.shape[0], dtype=np.float32)
        else:
            add_w = np.asarray(added_w, dtype=np.float32).reshape(-1)
            if add_w.shape[0] != add.shape[0]:
                raise ValueError("apply_delta: added_w length mismatch")
        add_s, add_d = add[:, 0], add[:, 1]
        rem_s, rem_d = rem[:, 0], rem[:, 1]
        if self.symmetric:
            add_s, add_d = (np.concatenate([add_s, add_d]),
                            np.concatenate([add_d, add_s]))
            add_w = np.concatenate([add_w, add_w])
            rem_s, rem_d = (np.concatenate([rem_s, rem_d]),
                            np.concatenate([rem_d, rem_s]))

        src = to_numpy(self.src[: self.n_edges]).astype(np.int64)
        dst = to_numpy(self.dst[: self.n_edges]).astype(np.int64)
        w = to_numpy(self.w[: self.n_edges])
        stride = np.int64(V + 1)
        if rem_s.size:
            keep = ~np.isin(src * stride + dst, rem_s * stride + rem_d)
            src, dst, w = src[keep], dst[keep], w[keep]
        new = build_coo(
            np.concatenate([src, add_s]), np.concatenate([dst, add_d]), V,
            w=np.concatenate([w, add_w]), pad_multiple=pad_multiple,
            symmetrize=False, dedup=True, device=self.device)
        # symmetric is digest-header metadata: restore it before any
        # digest is computed so lineage-equal graphs stay cache-equal
        new.symmetric = self.symmetric
        new.parent_digest = self.content_digest()
        new.delta = GraphDelta(added=add, removed=rem, touched=touched)
        return new


@dataclasses.dataclass
class GraphCSR:
    """CSR adjacency: out-neighbors of v are indices[indptr[v]:indptr[v+1]]."""

    indptr: torch.Tensor    # [V+1] int32
    indices: torch.Tensor   # [E_pad] int32 (padded tail with sentinel V)
    w: torch.Tensor         # [E_pad] float32
    n_vertices: int
    n_edges: int

    def nbytes(self) -> int:
        return int(self.indptr.shape[0]) * 4 + int(self.indices.shape[0]) * 8


@dataclasses.dataclass
class GraphELL:
    """ELLPACK: fixed-width neighbor matrix (the MaxAdjacentNodes layout).

    ``nbr[v, k]`` is the k-th in-neighbor of ``v`` (source of an edge into
    v); invalid slots have ``mask == False`` and ``nbr == n_vertices``
    (sentinel, so gathers read the identity pad row).
    """

    nbr: torch.Tensor   # [V, K] int32
    mask: torch.Tensor  # [V, K] bool
    w: torch.Tensor     # [V, K] float32
    n_vertices: int
    n_edges: int        # edges retained after capping
    n_edges_total: int  # edges before capping (for Table I loss accounting)

    @property
    def max_degree(self) -> int:
        return int(self.nbr.shape[1])

    @property
    def lost_fraction(self) -> float:
        """Table I: fraction of edges dropped by the degree cap."""
        if self.n_edges_total == 0:
            return 0.0
        return 1.0 - self.n_edges / self.n_edges_total

    def nbytes(self) -> int:
        v, k = self.nbr.shape
        return int(v) * int(k) * (4 + 1 + 4)


@dataclasses.dataclass
class OrientedELL:
    """Degree-ordered orientation with sorted out-neighbor rows.

    Every undirected edge {u, v} appears exactly once as the oriented
    pair ``(eu[i], ev[i])`` where ``rank(u) < rank(v)`` under the
    lexicographic ``(degree, id)`` order (self-loops drop out — no
    vertex out-ranks itself).  ``nbr[v]`` holds v's oriented
    out-neighbors sorted ascending by id; invalid slots carry the
    sentinel ``n_vertices``, and one extra all-sentinel row at index
    ``n_vertices`` lets padded edge slots gather an empty row.

    The number of triangles is ``sum_i |nbr[eu[i]] ∩ nbr[ev[i]]|`` —
    each triangle counted exactly once, at its lowest-rank edge.
    """

    nbr: torch.Tensor   # [V + 1, K] int32, rows sorted, sentinel-padded
    eu: torch.Tensor    # [E_pad] int32 oriented edge tails (sentinel pad)
    ev: torch.Tensor    # [E_pad] int32 oriented edge heads (sentinel pad)
    n_vertices: int
    n_edges: int        # true oriented (== undirected) edge count

    @property
    def max_out_degree(self) -> int:
        return int(self.nbr.shape[1])

    def nbytes(self) -> int:
        return (int(self.nbr.shape[0]) * int(self.nbr.shape[1])
                + 2 * int(self.eu.shape[0])) * 4


# ---------------------------------------------------------------------------
# Carry-across: the reference package's buffers (as numpy) -> the port's
# ---------------------------------------------------------------------------

def coo_from_numpy(src, dst, w, n_vertices: int, n_edges: int,
                   symmetric: bool = False, device=None) -> GraphCOO:
    """Wrap already-canonical padded COO buffers (e.g. ``np.asarray`` of
    a reference ``GraphCOO``'s ``src``/``dst``/``w``) without rebuilding
    them, so both packages compute on the same bytes."""
    dev = resolve_device(device)
    return GraphCOO(
        src=_tensor(np.asarray(src, dtype=np.int32), dev),
        dst=_tensor(np.asarray(dst, dtype=np.int32), dev),
        w=_tensor(np.asarray(w, dtype=np.float32), dev),
        n_vertices=int(n_vertices), n_edges=int(n_edges),
        symmetric=bool(symmetric))


def ell_from_numpy(nbr, mask, w, n_vertices: int, n_edges: int,
                   n_edges_total: int, device=None) -> GraphELL:
    """ELL counterpart of :func:`coo_from_numpy`."""
    dev = resolve_device(device)
    return GraphELL(
        nbr=_tensor(np.asarray(nbr, dtype=np.int32), dev),
        mask=_tensor(np.asarray(mask, dtype=bool), dev),
        w=_tensor(np.asarray(w, dtype=np.float32), dev),
        n_vertices=int(n_vertices), n_edges=int(n_edges),
        n_edges_total=int(n_edges_total))


# ---------------------------------------------------------------------------
# Host-side constructors (numpy; this is the ETL substrate's device handoff)
# ---------------------------------------------------------------------------

def _pad_to(x: np.ndarray, n: int, fill) -> np.ndarray:
    if x.shape[0] >= n:
        return x[:n]
    pad = np.full((n - x.shape[0],) + x.shape[1:], fill, dtype=x.dtype)
    return np.concatenate([x, pad], axis=0)


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def build_coo(
    src: np.ndarray,
    dst: np.ndarray,
    n_vertices: int,
    w: Optional[np.ndarray] = None,
    pad_multiple: int = 1024,
    symmetrize: bool = False,
    dedup: bool = True,
    device=None,
) -> GraphCOO:
    """Sort edges by destination, optionally symmetrize/dedup, pad."""
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    if w is None:
        w = np.ones_like(src, dtype=np.float32)
    w = np.asarray(w, dtype=np.float32)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
    if dedup and src.size:
        key = src.astype(np.int64) * np.int64(n_vertices + 1) + dst.astype(np.int64)
        _, keep = np.unique(key, return_index=True)
        src, dst, w = src[keep], dst[keep], w[keep]
    order = np.argsort(dst, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    n_edges = int(src.shape[0])
    e_pad = max(pad_multiple, round_up(n_edges, pad_multiple))
    sentinel = np.int32(n_vertices)
    return GraphCOO(
        src=_tensor(_pad_to(src, e_pad, sentinel), dev),
        dst=_tensor(_pad_to(dst, e_pad, sentinel), dev),
        w=_tensor(_pad_to(w, e_pad, 0.0), dev),
        n_vertices=int(n_vertices),
        n_edges=n_edges,
        symmetric=bool(symmetrize),
    )


def build_csr(
    src: np.ndarray,
    dst: np.ndarray,
    n_vertices: int,
    w: Optional[np.ndarray] = None,
    pad_multiple: int = 1024,
    symmetrize: bool = False,
    device=None,
) -> GraphCSR:
    """CSR over *out*-neighbors: row v lists targets of edges from v."""
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    if w is None:
        w = np.ones_like(src, dtype=np.float32)
    w = np.asarray(w, dtype=np.float32)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
    order = np.argsort(src, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    counts = np.bincount(src, minlength=n_vertices).astype(np.int32)
    indptr = np.zeros(n_vertices + 1, dtype=np.int32)
    np.cumsum(counts, out=indptr[1:])
    n_edges = int(src.shape[0])
    e_pad = max(pad_multiple, round_up(n_edges, pad_multiple))
    return GraphCSR(
        indptr=_tensor(indptr, dev),
        indices=_tensor(_pad_to(dst, e_pad, np.int32(n_vertices)), dev),
        w=_tensor(_pad_to(w, e_pad, 0.0), dev),
        n_vertices=int(n_vertices),
        n_edges=n_edges,
    )


def build_ell(
    src: np.ndarray,
    dst: np.ndarray,
    n_vertices: int,
    max_degree: int,
    w: Optional[np.ndarray] = None,
    symmetrize: bool = False,
    direction: str = "in",
    device=None,
) -> GraphELL:
    """Pack edges into the fixed-width ELL layout, capping per-vertex degree.

    ``direction='in'``: row v holds *sources* of edges into v (what SpMV /
    message aggregation wants).  Edges beyond ``max_degree`` for a vertex
    are dropped — this is exactly the paper's ``MaxAdjacentNodes``
    restriction, and ``lost_fraction`` reproduces Table I.
    """
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    if w is None:
        w = np.ones_like(src, dtype=np.float32)
    w = np.asarray(w, dtype=np.float32)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
    if direction == "in":
        row, col = dst, src
    else:
        row, col = src, dst
    n_total = int(row.shape[0])
    order = np.argsort(row, kind="stable")
    row, col, w = row[order], col[order], w[order]
    counts = np.bincount(row, minlength=n_vertices)
    # slot index of each edge within its row
    starts = np.zeros(n_vertices, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    slot = np.arange(n_total, dtype=np.int64) - starts[row]
    keep = slot < max_degree
    row_k, col_k, w_k, slot_k = row[keep], col[keep], w[keep], slot[keep]
    nbr = np.full((n_vertices, max_degree), np.int32(n_vertices), dtype=np.int32)
    mask = np.zeros((n_vertices, max_degree), dtype=bool)
    wm = np.zeros((n_vertices, max_degree), dtype=np.float32)
    nbr[row_k, slot_k] = col_k
    mask[row_k, slot_k] = True
    wm[row_k, slot_k] = w_k
    return GraphELL(
        nbr=_tensor(nbr, dev),
        mask=_tensor(mask, dev),
        w=_tensor(wm, dev),
        n_vertices=int(n_vertices),
        n_edges=int(keep.sum()),
        n_edges_total=n_total,
    )


def build_oriented_ell(
    src: np.ndarray,
    dst: np.ndarray,
    n_vertices: int,
    pad_multiple: int = 1024,
    device=None,
) -> OrientedELL:
    """Degree-order and orient a symmetrized, deduped edge list.

    Input must contain both directions of every undirected edge (the
    ``build_coo(..., symmetrize=True)`` invariant); exactly one survives
    orientation.  Self-loops and sentinel padding rows are dropped.  The
    achieved row width is the orientation's max out-degree — O(sqrt(E))
    even on heavy-tailed graphs, because high-degree hubs rank last and
    therefore *receive* nearly all their edges.
    """
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    real = (src < n_vertices) & (dst < n_vertices) & (src != dst)
    src, dst = src[real], dst[real]
    deg = np.bincount(dst, minlength=n_vertices)
    # keep (u, v) iff (deg[u], u) < (deg[v], v) — the degree-ordered
    # orientation; ties broken by id so every edge survives exactly once
    keep = (deg[src] < deg[dst]) | ((deg[src] == deg[dst]) & (src < dst))
    eu, ev = src[keep], dst[keep]
    order = np.lexsort((ev, eu))          # rows grouped, sorted by head id
    eu, ev = eu[order], ev[order]
    n_edges = int(eu.shape[0])
    counts = np.bincount(eu, minlength=n_vertices)
    k = max(int(counts.max()) if n_edges else 1, 1)
    starts = np.zeros(n_vertices, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    slot = np.arange(n_edges, dtype=np.int64) - starts[eu]
    sentinel = np.int32(n_vertices)
    nbr = np.full((n_vertices + 1, k), sentinel, dtype=np.int32)
    nbr[eu, slot] = ev.astype(np.int32)
    e_pad = max(pad_multiple, round_up(max(n_edges, 1), pad_multiple))
    return OrientedELL(
        nbr=_tensor(nbr, dev),
        eu=_tensor(_pad_to(eu.astype(np.int32), e_pad, sentinel), dev),
        ev=_tensor(_pad_to(ev.astype(np.int32), e_pad, sentinel), dev),
        n_vertices=int(n_vertices),
        n_edges=n_edges,
    )


# ---------------------------------------------------------------------------
# Device-side primitives shared by engines
# ---------------------------------------------------------------------------

def _extreme(dtype: torch.dtype, op: str):
    """What an empty min/max segment holds: the dtype's extreme value,
    as ``jax.ops.segment_min/max`` return for empty segments."""
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def segment_combine(values: torch.Tensor, segment_ids: torch.Tensor,
                    n_vertices: int, op: str) -> torch.Tensor:
    """Aggregate edge messages to destination vertices.

    ``segment_ids`` may contain the sentinel ``n_vertices`` (padding); one
    extra segment swallows it and is dropped.  ``op`` in {sum,min,max};
    empty min/max segments hold the dtype's extreme value.
    """
    n = n_vertices + 1
    idx = segment_ids.long()
    shape = (n,) + tuple(values.shape[1:])
    if op == "sum":
        out = torch.zeros(shape, dtype=values.dtype, device=values.device)
        out.index_add_(0, idx, values)
    elif op in ("min", "max"):
        out = torch.full(shape, _extreme(values.dtype, op),
                         dtype=values.dtype, device=values.device)
        if values.dim() > 1:
            idx = idx.view((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
        out.scatter_reduce_(0, idx, values, reduce="a" + op,
                            include_self=True)
    else:
        raise ValueError(f"unknown op {op!r}")
    return out[:n_vertices]


def pad_vertex_state(x: torch.Tensor, identity) -> torch.Tensor:
    """Append the sentinel row so gathers through padded ids read identity."""
    pad = torch.full((1,) + tuple(x.shape[1:]), identity, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=0)


def require_symmetric(g: GraphCOO, algorithm: str) -> None:
    """Guard for algorithms with undirected semantics — on a directed
    edge list they run fine but return silently wrong answers."""
    if not getattr(g, "symmetric", False):
        raise ValueError(
            f"{algorithm} has undirected semantics and needs a symmetrized "
            f"edge list: build with build_coo(..., symmetrize=True), or set "
            f"coo.symmetric = True if the edges are already symmetric by "
            f"construction")


def out_degrees(g: GraphCOO) -> torch.Tensor:
    ones = (g.src < g.n_vertices).to(torch.float32)
    return segment_combine(ones, g.src, g.n_vertices, "sum")


def in_degrees(g: GraphCOO) -> torch.Tensor:
    ones = (g.dst < g.n_vertices).to(torch.float32)
    return segment_combine(ones, g.dst, g.n_vertices, "sum")
