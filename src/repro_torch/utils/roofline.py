"""Three-term roofline of the port's dry run, on H100 SXM constants (the
reference's ``utils/roofline.py``, which reads XLA's compiled artifacts
against TPU v5e constants).

    compute_s    = FLOPs a rank / PEAK_FLOPS_BF16
    memory_s     = bytes a rank reads and writes / HBM_BW
    collective_s = sum over mesh axes of link bytes a rank / that axis's link

Constants, from NVIDIA's H100 SXM5 data sheet: 989 TFLOP/s dense bf16
(tensor cores, no sparsity), 3.35 TB/s of HBM3, NVLink 4 at 900 GB/s
both ways (450 GB/s a direction) inside a node of 8 cards, and
ConnectX-7 InfiniBand NDR at 400 Gb/s (50 GB/s) a card across nodes.
A mesh axis whose process groups each lie inside one node of 8 ranks
(``rank // 8`` equal) takes NVLink; any other axis takes InfiniBand.

The dry run (``launch/dryrun.py``) counts what XLA's artifacts gave the
reference: FLOPs (``torch.utils.flop_counter``), bytes (each operation's
inputs read once and outputs written once, views free), and collective
bytes, counted where the port issues its collectives
(``count_collective``, called by ``utils/sharding.py``, the mesh
collectives of ``core/pregel.py`` and the ring shift of
``models/layers.py``).  Bytes are the collective's result a rank, as the
reference reads them off the post-SPMD HLO, weighted by its ring factor
(``RING_FACTOR``: all-reduce 2(n-1)/n, all-gather, reduce-scatter and
all-to-all (n-1)/n, a permute 1).  Without an open ``CollectiveCounter``
the hook does nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

PEAK_FLOPS_BF16 = 989e12   # a card, dense bf16
HBM_BW = 3.35e12           # B/s a card (HBM3)
NVLINK_BW = 450e9          # B/s a direction, inside a node of 8
IB_BW = 50e9               # B/s a card (InfiniBand NDR 400 Gb/s)
NODE = 8                   # cards a node


def ring(n: int) -> float:
    """The share of a gathered array one rank sends on a ring of n."""
    return (n - 1) / n if n > 1 else 0.0


RING_FACTOR = {
    "all-reduce": lambda n: 2.0 * ring(n),
    "all-gather": ring,
    "reduce-scatter": ring,
    "all-to-all": ring,
    "collective-permute": lambda n: 1.0,
}


def link_bw(ranks) -> float:
    """The link a process group of these global ranks takes."""
    nodes = {int(r) // NODE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else IB_BW


@dataclasses.dataclass
class CollectiveStats:
    """Per kind: result bytes a rank (``raw``), ring-weighted bytes
    (``link``), calls (``counts``); ``seconds``: link bytes over each
    group's link."""
    raw_bytes: dict = dataclasses.field(default_factory=dict)
    link_bytes: dict = dataclasses.field(default_factory=dict)
    counts: dict = dataclasses.field(default_factory=dict)
    seconds: float = 0.0

    @property
    def total_link_bytes(self) -> float:
        return sum(self.link_bytes.values())

    @property
    def total_raw_bytes(self) -> float:
        return sum(self.raw_bytes.values())


_ACTIVE: list = []


class CollectiveCounter:
    """``with CollectiveCounter() as c:`` counts every collective the port
    issues inside the block into ``c.stats``."""

    def __init__(self):
        self.stats = CollectiveStats()
        self._bw = {}

    def add(self, kind: str, nbytes: float, group) -> None:
        key = id(group)
        if key not in self._bw:
            ranks = _group_ranks(group)
            self._bw[key] = (len(ranks), link_bw(ranks))
        n, bw = self._bw[key]
        st = self.stats
        link = nbytes * RING_FACTOR[kind](n)
        st.raw_bytes[kind] = st.raw_bytes.get(kind, 0.0) + nbytes
        st.link_bytes[kind] = st.link_bytes.get(kind, 0.0) + link
        st.counts[kind] = st.counts.get(kind, 0) + 1
        st.seconds += link / bw

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return False


def _group_ranks(group) -> list:
    import torch.distributed as dist
    return list(dist.get_process_group_ranks(group))


def count_collective(kind: str, nbytes: float, group) -> None:
    """Record one collective of ``kind`` whose result holds ``nbytes`` on
    this rank, over ``group`` (a no-op unless a counter is open)."""
    for c in _ACTIVE:
        c.add(kind, float(nbytes), group)


@dataclasses.dataclass
class RooflineReport:
    name: str
    chips: int
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    coll_link_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_per_chip: float = 0.0       # 6ND/chips (useful compute)
    useful_ratio: float = 0.0               # model_flops / counted flops
    coll_counts: dict = dataclasses.field(default_factory=dict)
    coll_raw: dict = dataclasses.field(default_factory=dict)
    memory_per_device_gb: float = 0.0

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the binding term: the time the
        model's own FLOPs take at peak over the bound."""
        if self.bound_s <= 0:
            return 0.0
        useful_s = self.model_flops_per_chip / PEAK_FLOPS_BF16
        return useful_s / self.bound_s if useful_s > 0 else 0.0

    def row(self) -> dict:
        return {
            "name": self.name, "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "mem_gb": self.memory_per_device_gb,
        }


def analyze(name: str, cost: dict, coll: Optional[CollectiveStats],
            chips: int, model_flops_global: float = 0.0,
            memory_bytes: float = 0.0) -> RooflineReport:
    """``cost``: ``{"flops", "bytes accessed"}`` a rank; ``coll``: the
    rank's ``CollectiveStats`` (None: no collective)."""
    coll = coll or CollectiveStats()
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = nbytes / HBM_BW
    collective_s = coll.seconds
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops_global / max(chips, 1)
    return RooflineReport(
        name=name, chips=chips,
        hlo_flops_per_chip=flops, hlo_bytes_per_chip=nbytes,
        coll_link_bytes_per_chip=coll.total_link_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant,
        model_flops_per_chip=mf,
        useful_ratio=(mf / flops) if flops > 0 else 0.0,
        coll_counts=dict(coll.counts), coll_raw=dict(coll.raw_bytes),
        memory_per_device_gb=memory_bytes / 1e9,
    )


def lm_model_flops(n_params: int, tokens: int, training: bool = True,
                   active_params: Optional[int] = None) -> float:
    """6·N·D for a train step (fwd+bwd); 2·N·D for inference forward.
    For MoE pass active_params (routed-active parameter count)."""
    n = active_params if active_params is not None else n_params
    mult = 6.0 if training else 2.0
    return mult * n * tokens


def fmt_seconds(s: float) -> str:
    if s <= 0:
        return "0"
    exp = int(math.floor(math.log10(s)))
    if exp < -6:
        return f"{s*1e9:.2f}ns"
    if exp < -3:
        return f"{s*1e6:.2f}us"
    if exp < 0:
        return f"{s*1e3:.2f}ms"
    return f"{s:.3f}s"
