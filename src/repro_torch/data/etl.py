"""The configurable ETL pipeline (paper Section III-C-2).

The paper's pipeline: FlockDB association dumps -> HDFS snapshots ->
(replicate to GCS) -> graph generation -> algorithm execution -> results
to BigQuery/GCS for downstream ML.  Here:

    snapshot files (npz on disk == HDFS/GCS stand-in)
      -> SnapshotStore (daily partitions, multi-snapshot union)
      -> GraphETL: dedup | remap ids | symmetrize | degree-cap | pack
      -> GraphCOO / GraphELL on the device (the first CUDA device unless
         the caller names another, e.g. ``device="cpu"``)
      -> results persisted back via ResultSink (npz + manifest)

Every stage is pure and restartable; the pipeline writes a manifest with
content hashes so a restarted job skips completed stages.  The store's
files and hashes are the reference package's byte for byte, so a store
written by either package is read by the other.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch.core import graph as G


def _hash_arrays(*arrays: np.ndarray) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class Snapshot:
    """One daily snapshot of (src, dst) associations."""
    name: str
    src: np.ndarray
    dst: np.ndarray

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])


@dataclasses.dataclass
class SnapshotDelta:
    """Edge edit from ``base`` to the (virtual) snapshot ``name`` — the
    daily-cadence partition format: today's landing job ships only the
    changed associations, not the full graph."""
    name: str
    base: str
    added_src: np.ndarray
    added_dst: np.ndarray
    removed_src: np.ndarray
    removed_dst: np.ndarray

    @property
    def n_added(self) -> int:
        return int(self.added_src.shape[0])

    @property
    def n_removed(self) -> int:
        return int(self.removed_src.shape[0])


class SnapshotStore:
    """Directory of npz snapshot partitions — the HDFS/GCS stand-in.

    Two partition kinds: full snapshots (``{name}.npz``) and delta
    partitions (``{name}.delta.npz``) that reference a base by name.
    ``manifest``/``resolve`` walk a delta chain back to its full base,
    so a snapshot landed as deltas costs only the changed edges on disk.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def write(self, snap: Snapshot) -> str:
        path = os.path.join(self.root, f"{snap.name}.npz")
        tmp = path + ".tmp.npz"   # savez appends .npz if missing
        np.savez_compressed(tmp, src=snap.src, dst=snap.dst)
        os.replace(tmp, path)     # atomic commit
        return path

    def read(self, name: str) -> Snapshot:
        path = os.path.join(self.root, f"{name}.npz")
        if not os.path.exists(path):
            raise KeyError(
                f"snapshot {name!r} not in store {self.root!r}; "
                f"available: {self.list()} (deltas: {self.list_deltas()})")
        data = np.load(path)
        return Snapshot(name, data["src"], data["dst"])

    def write_delta(self, delta: SnapshotDelta) -> str:
        path = os.path.join(self.root, f"{delta.name}.delta.npz")
        tmp = path + ".tmp.npz"
        np.savez_compressed(
            tmp, base=np.array(delta.base),
            added_src=delta.added_src, added_dst=delta.added_dst,
            removed_src=delta.removed_src, removed_dst=delta.removed_dst)
        os.replace(tmp, path)
        return path

    def read_delta(self, name: str) -> SnapshotDelta:
        path = os.path.join(self.root, f"{name}.delta.npz")
        if not os.path.exists(path):
            raise KeyError(
                f"delta partition {name!r} not in store {self.root!r}; "
                f"available deltas: {self.list_deltas()}")
        data = np.load(path)
        return SnapshotDelta(
            name, str(data["base"]),
            data["added_src"], data["added_dst"],
            data["removed_src"], data["removed_dst"])

    def manifest(self, name: str) -> dict:
        """Lineage of ``name``: its full base partition plus the delta
        names to apply, oldest first."""
        deltas, seen = [], set()
        cur = name
        while not os.path.exists(os.path.join(self.root, f"{cur}.npz")):
            if cur in seen:
                raise KeyError(f"delta chain for {name!r} has a cycle "
                               f"at {cur!r}")
            seen.add(cur)
            deltas.append(self.read_delta(cur))   # KeyError if missing
            cur = deltas[-1].base
        return {"name": name, "base": cur,
                "deltas": [d.name for d in reversed(deltas)]}

    def resolve(self, name: str) -> Snapshot:
        """Materialize ``name`` as a full edge list: read its base and
        apply the delta chain (removals before additions, per delta)."""
        man = self.manifest(name)
        base = self.read(man["base"])
        src = np.asarray(base.src, dtype=np.int64)
        dst = np.asarray(base.dst, dtype=np.int64)
        for dname in man["deltas"]:
            d = self.read_delta(dname)
            if d.n_removed:
                stride = np.int64(
                    max(src.max(initial=0), dst.max(initial=0),
                        np.asarray(d.removed_src).max(initial=0),
                        np.asarray(d.removed_dst).max(initial=0)) + 1)
                rem = (np.asarray(d.removed_src, dtype=np.int64) * stride
                       + np.asarray(d.removed_dst, dtype=np.int64))
                keep = ~np.isin(src * stride + dst, rem)
                src, dst = src[keep], dst[keep]
            src = np.concatenate([src, np.asarray(d.added_src,
                                                  dtype=np.int64)])
            dst = np.concatenate([dst, np.asarray(d.added_dst,
                                                  dtype=np.int64)])
        return Snapshot(name, src, dst)

    def list(self) -> list[str]:
        """Full snapshot partitions only — stray ``.tmp.npz`` files from
        a crashed ``write`` and delta partitions are excluded."""
        return sorted(f[:-4] for f in os.listdir(self.root)
                      if f.endswith(".npz")
                      and not f.endswith(".tmp.npz")
                      and not f.endswith(".delta.npz"))

    def list_deltas(self) -> list[str]:
        return sorted(f[: -len(".delta.npz")] for f in os.listdir(self.root)
                      if f.endswith(".delta.npz")
                      and not f.endswith(".tmp.npz"))


@dataclasses.dataclass
class ETLReport:
    n_vertices: int
    n_edges_in: int
    n_edges_deduped: int
    n_edges_after_cap: int
    lost_fraction: float      # Table I quantity
    wall_seconds: float
    content_hash: str


class GraphETL:
    """Snapshot union -> device graph, with the paper's knobs."""

    def __init__(self, max_adjacent_nodes: Optional[int] = None,
                 symmetrize: bool = False, dedup: bool = True, device=None):
        self.cap = max_adjacent_nodes
        self.symmetrize = symmetrize
        self.dedup = dedup
        self.device = device        # None: the first CUDA device

    def union_snapshots(self, snaps: Iterable[Snapshot]):
        srcs, dsts = [], []
        for s in snaps:
            srcs.append(s.src)
            dsts.append(s.dst)
        return np.concatenate(srcs), np.concatenate(dsts)

    def build(self, snaps: Sequence[Snapshot],
              n_vertices: Optional[int] = None):
        """Returns (GraphCOO, GraphELL|None, ETLReport)."""
        t0 = time.time()
        src, dst = self.union_snapshots(snaps)
        n_in = src.shape[0]
        if n_vertices is None:
            n_vertices = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
        coo = G.build_coo(src, dst, n_vertices, symmetrize=self.symmetrize,
                          dedup=self.dedup, device=self.device)
        ell = None
        lost = 0.0
        if self.cap is not None:
            ell = G.build_ell(G.to_numpy(coo.src)[: coo.n_edges],
                              G.to_numpy(coo.dst)[: coo.n_edges],
                              n_vertices, self.cap, direction="in",
                              device=coo.device)
            lost = ell.lost_fraction
        report = ETLReport(
            n_vertices=n_vertices, n_edges_in=n_in,
            n_edges_deduped=coo.n_edges,
            n_edges_after_cap=ell.n_edges if ell else coo.n_edges,
            lost_fraction=lost, wall_seconds=time.time() - t0,
            content_hash=_hash_arrays(src, dst),
        )
        return coo, ell, report


class ResultSink:
    """Persist algorithm outputs + manifest (the BigQuery/GCS stand-in)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def write(self, name: str, arrays: dict, meta: dict) -> str:
        """Arrays may be numpy arrays or tensors on any device."""
        host = {k: G.to_numpy(v) for k, v in arrays.items()}
        path = os.path.join(self.root, f"{name}.npz")
        np.savez_compressed(path, **host)
        manifest = {
            "name": name, "time": time.time(),
            "meta": {k: str(v) for k, v in meta.items()},
            "arrays": {k: list(v.shape) for k, v in host.items()},
        }
        with open(os.path.join(self.root, f"{name}.manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        return path

    def read(self, name: str):
        data = np.load(os.path.join(self.root, f"{name}.npz"))
        with open(os.path.join(self.root, f"{name}.manifest.json")) as f:
            manifest = json.load(f)
        return dict(data), manifest


def max_adjacent_nodes_sweep(src: np.ndarray, dst: np.ndarray,
                             n_vertices: int,
                             caps: Sequence[int], device=None) -> list[dict]:
    """Reproduce Table I: edge retention vs MaxAdjacentNodes."""
    rows = []
    total = src.shape[0]
    for cap in caps:
        ell = G.build_ell(src, dst, n_vertices, cap, direction="in",
                          device=device)
        rows.append({
            "max_adjacent_nodes": cap,
            "edge_count": ell.n_edges,
            "lost_percentage": 100.0 * ell.lost_fraction,
        })
        if ell.n_edges_total != total:
            raise AssertionError(f"ELL lost track of edges: "
                                 f"{ell.n_edges_total} != {total}")
    return rows
