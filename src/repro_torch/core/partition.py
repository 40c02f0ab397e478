"""Edge partitioning for the engines.

The Spark analogue: GraphFrames hash-partitions edge DataFrames across
executors.  Here edges are pre-partitioned host-side into fixed-size
edge shards laid out shard-major along the leading axis:

* **1-D** (``vertex_layout='replicated'``): edges split evenly over the
  ``data`` axis, vertex state replicated.  On one device the shards are
  simply concatenated and one superstep combines them all at once.
  On a mesh each rank combines its own shard and one ``all_reduce``
  over ``data`` merges them.
* **2-D** (``vertex_layout='sharded'``): the vertex-cut.  The ``model``
  axis owns contiguous destination ranges; each (data, model) shard holds
  edges whose dst falls in its range.  Vertex state is sharded over
  ``model`` and gathered once a superstep over that axis.  Only a mesh
  runs it.

Partitioning is host-side numpy (ETL territory), laid out shard-major:
shard ``(d, m)`` sits at index ``d * n_model + m``.  Every rank of a mesh
builds the same partition and keeps only its own shard
(``ShardedCOO.shard``) on its own device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.graph import GraphCOO, round_up


@dataclasses.dataclass
class ShardedCOO:
    """Edge shards laid out shard-major along the leading axis.

    ``src/dst/w`` have shape ``[n_shards * e_shard]``; slice ``i`` is
    shard ``i``.  For 2-D partitioning ``n_shards == n_data * n_model``
    and shard ``(d, m)`` sits at index ``d * n_model + m``.  A single
    shard (``shard()``) holds ``[e_shard]`` edges and its mesh
    coordinate in ``coord``.
    """

    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    n_vertices: int
    n_edges: int
    n_data: int
    n_model: int          # 1 for 1-D partitioning
    e_shard: int
    v_local: int          # vertices owned per model shard (V for 1-D)
    # (data, model) of the one shard held, None when all of them are
    coord: Optional[tuple] = None
    # int64 / clamped index copies for the dense superstep, built once per
    # ShardedCOO on first use instead of once per superstep
    _index_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def vertex_layout(self) -> str:
        return "replicated" if self.n_model == 1 else "sharded"

    @property
    def n_pad(self) -> int:
        """Length of a full vertex-state array (``n_model * v_local``;
        1-D layouts set ``v_local = n_vertices``, so this is V there)."""
        return self.n_model * self.v_local

    @property
    def v_start(self) -> int:
        """First vertex id this shard's combine owns (0 unless it is one
        2-D shard)."""
        if self.coord is None or self.n_model == 1:
            return 0
        return self.coord[1] * self.v_local

    def shard(self, d: int, m: int = 0, device=None) -> "ShardedCOO":
        """The edges of mesh coordinate ``(d, m)``: shard ``d`` of a 1-D
        layout (every ``m`` of a replicated model axis runs the same
        one), shard ``d * n_model + m`` of a 2-D one; on ``device``
        (default: where these edges are)."""
        if self.coord is not None:
            raise ValueError("shard() of a ShardedCOO that holds one shard")
        if not 0 <= d < self.n_data or (self.n_model > 1
                                        and not 0 <= m < self.n_model):
            raise ValueError(f"mesh coordinate {(d, m)} outside "
                             f"{(self.n_data, self.n_model)} shards")
        m = m if self.n_model > 1 else 0
        i = d * self.n_model + m
        sl = slice(i * self.e_shard, (i + 1) * self.e_shard)
        dev = self.src.device if device is None else torch.device(device)
        return dataclasses.replace(
            self, src=self.src[sl].to(dev), dst=self.dst[sl].to(dev),
            w=self.w[sl].to(dev), coord=(d, m), _index_cache={})

    def gather_index(self, which: str, n_state: int) -> torch.Tensor:
        """``src`` or ``dst`` clamped into ``[0, n_state)`` — the index a
        superstep gathers vertex state through (sentinel ids read the
        last row; their messages are dropped at the combine)."""
        key = ("gather", which, n_state)
        got = self._index_cache.get(key)
        if got is None:
            ids = self.src if which == "src" else self.dst
            got = ids.clamp(0, max(n_state - 1, 0))
            self._index_cache[key] = got
        return got

    def combine_index(self) -> torch.Tensor:
        """``dst - v_start`` as the int64 segment index of the local
        combine: padding edges (``dst >= V``) aim at the extra segment
        ``v_local``, which the combine drops."""
        got = self._index_cache.get("combine")
        if got is None:
            V, vl = self.n_vertices, self.v_local
            got = torch.where(self.dst >= V, vl, self.dst - self.v_start
                              ).clamp(0, vl).long()
            self._index_cache["combine"] = got
        return got


def _pack_shards(groups, e_shard, sentinel):
    """Stack variable-size edge groups into a padded shard-major array."""
    n = len(groups)
    src = np.full((n, e_shard), sentinel, dtype=np.int32)
    dst = np.full((n, e_shard), sentinel, dtype=np.int32)
    w = np.zeros((n, e_shard), dtype=np.float32)
    for i, (s, d, ww) in enumerate(groups):
        k = s.shape[0]
        src[i, :k], dst[i, :k], w[i, :k] = s, d, ww
    return src.reshape(-1), dst.reshape(-1), w.reshape(-1)


def partition_1d(g: GraphCOO, n_data: int, pad_multiple: int = 256,
                 device=None) -> ShardedCOO:
    """Round-robin edge split over the data axis (vertex state replicated).
    ``device=None`` keeps the shards on the graph's own device."""
    dev = g.device if device is None else torch.device(device)
    src = g.src[: g.n_edges].cpu().numpy()
    dst = g.dst[: g.n_edges].cpu().numpy()
    w = g.w[: g.n_edges].cpu().numpy()
    e_shard = max(pad_multiple, round_up(-(-g.n_edges // n_data), pad_multiple))
    groups = []
    for d in range(n_data):
        sel = slice(d, None, n_data)  # strided → balanced across dst ranges
        groups.append((src[sel], dst[sel], w[sel]))
    s, dd, ww = _pack_shards(groups, e_shard, np.int32(g.n_vertices))
    return ShardedCOO(
        src=torch.from_numpy(s).to(dev), dst=torch.from_numpy(dd).to(dev),
        w=torch.from_numpy(ww).to(dev),
        n_vertices=g.n_vertices, n_edges=g.n_edges,
        n_data=n_data, n_model=1, e_shard=e_shard, v_local=g.n_vertices,
    )


def partition_2d(g: GraphCOO, n_data: int, n_model: int,
                 pad_multiple: int = 256, device=None) -> ShardedCOO:
    """Vertex-cut: model axis owns dst ranges, data axis splits within."""
    dev = g.device if device is None else torch.device(device)
    src = g.src[: g.n_edges].cpu().numpy()
    dst = g.dst[: g.n_edges].cpu().numpy()
    w = g.w[: g.n_edges].cpu().numpy()
    v_local = -(-g.n_vertices // n_model)
    owner = np.minimum(dst // v_local, n_model - 1)
    groups = []
    max_block = 0
    for m in range(n_model):
        sel = owner == m
        sm, dm, wm = src[sel], dst[sel], w[sel]
        per_d = []
        for d in range(n_data):
            ss = slice(d, None, n_data)
            per_d.append((sm[ss], dm[ss], wm[ss]))
            max_block = max(max_block, per_d[-1][0].shape[0])
        groups.append(per_d)
    e_shard = max(pad_multiple, round_up(max_block, pad_multiple))
    flat = [groups[m][d] for d in range(n_data) for m in range(n_model)]
    s, dd, ww = _pack_shards(flat, e_shard, np.int32(g.n_vertices))
    return ShardedCOO(
        src=torch.from_numpy(s).to(dev), dst=torch.from_numpy(dd).to(dev),
        w=torch.from_numpy(ww).to(dev),
        n_vertices=g.n_vertices, n_edges=g.n_edges,
        n_data=n_data, n_model=n_model, e_shard=e_shard, v_local=v_local,
    )


def partition(g: GraphCOO, n_data: int, n_model: int = 1,
              device: Optional[torch.device] = None, **kw) -> ShardedCOO:
    if n_model <= 1:
        return partition_1d(g, n_data, device=device, **kw)
    return partition_2d(g, n_data, n_model, device=device, **kw)
