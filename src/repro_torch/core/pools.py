"""Device pools — the hybrid-cloud substrate made first-class.

The paper's platform spans two very different places to compute: the
on-premises Hadoop/HDFS estate and the cloud (GCP) side — one graph
snapshot may be *resident* in either, both, or neither, and moving it
costs real wall-clock (their FlockDB→HDFS→GCS copies are the dominant
term for cold queries).  Until now this repo planned over
(engine, variant) on one implicit device pool; this module names the
pools so every other layer can plan and execute over them:

* :class:`DevicePool` — a named subset of the process' torch devices
  ("onprem" / "cloud") with the attributes the planner and the service
  runtime price and enforce: cross-pool ``link_bandwidth`` (the
  byte-rate a non-resident snapshot pays to materialize here),
  ``compute_scale`` (relative compute cost — a cloud pool of faster or
  more numerous chips advertises ``< 1.0``), ``capacity`` (queued
  batch-tier tickets before the service spills work to another
  resident pool), ``max_inflight`` (concurrent executions the runtime
  admits onto the pool) and a mutable ``healthy`` flag.
* :class:`PoolSet` — an ordered, named collection with a **generation
  counter**: flipping a pool's health bumps it, and every plan cache
  keys on it, so a cached Plan that placed work onto a now-unhealthy
  pool is re-costed instead of replayed (the residency analogue lives
  in ``GraphContext``).
* :func:`default_pools` — the two-pool development topology: the
  process' devices partitioned into an "onprem" and a "cloud" half
  (on a one-device host both halves alias the same device — the pools
  stay *logically* distinct, and the result contract makes that
  invisible: per-ticket bytes are identical wherever they run).

Results never depend on the pool: a pool changes *where* state lives
and *what the plan costs*, never what the query returns — the same
contract engines and variants already obey.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Iterable, Optional, Sequence

#: Default cross-pool link byte-rate: a 100 Gb/s private interconnect —
#: the order of magnitude of the paper's on-prem<->GCP link, and far
#: below HBM bandwidth, which is what makes residency matter.
DEFAULT_LINK_BANDWIDTH = 12.5e9


@dataclasses.dataclass(eq=False)
class DevicePool:
    """One named execution substrate.

    ``devices`` are the torch devices the pool owns (empty = the process
    default — a purely logical pool).  ``n_chips`` feeds the
    distributed-engine estimate (``None`` falls back to the graph
    context's configured chip count, which keeps a single-pool service
    bit-compatible with the pre-pool planner).  ``healthy`` is the one
    mutable operational field; flip it through
    :meth:`PoolSet.set_health` so plan caches see the generation bump.
    """

    name: str
    devices: tuple = ()
    n_chips: Optional[int] = None
    link_bandwidth: float = DEFAULT_LINK_BANDWIDTH
    compute_scale: float = 1.0
    capacity: Optional[int] = None
    max_inflight: Optional[int] = None
    healthy: bool = True

    def __post_init__(self):
        self.devices = tuple(self.devices or ())
        if not self.name:
            raise ValueError("pool name must be non-empty")
        if self.link_bandwidth <= 0:
            raise ValueError(
                f"pool {self.name!r}: link_bandwidth must be > 0")
        if self.compute_scale <= 0:
            raise ValueError(
                f"pool {self.name!r}: compute_scale must be > 0")
        if self.capacity is not None and self.capacity < 0:
            raise ValueError(f"pool {self.name!r}: capacity must be >= 0")
        if self.max_inflight is not None and self.max_inflight < 1:
            raise ValueError(
                f"pool {self.name!r}: max_inflight must be >= 1")
        if self.n_chips is None and self.devices:
            self.n_chips = len(self.devices)

    def transfer_seconds(self, n_bytes: int) -> float:
        """Wall-clock to materialize ``n_bytes`` of non-resident graph
        onto this pool — the data-locality term of the cost model."""
        return float(n_bytes) / self.link_bandwidth


class PoolSet:
    """Ordered named pools plus the health generation counter.

    The order is the planner's tie-break (earlier pools win equal-cost
    plans) and the runtime's scan order, so a fixed construction order
    keeps scheduling deterministic.
    """

    def __init__(self, pools: Sequence[DevicePool]):
        pools = list(pools)
        if not pools:
            raise ValueError("PoolSet needs at least one pool")
        names = [p.name for p in pools]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate pool names: {sorted(names)}")
        self._pools = {p.name: p for p in pools}
        self._order = tuple(names)
        self._generation = 0
        self._lock = threading.Lock()

    # -- access -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._order)

    def __iter__(self):
        return iter(self.pools())

    def __contains__(self, name: str) -> bool:
        return name in self._pools

    def names(self) -> tuple:
        return self._order

    def pools(self) -> tuple:
        return tuple(self._pools[n] for n in self._order)

    def get(self, name: str) -> DevicePool:
        try:
            return self._pools[name]
        except KeyError:
            raise KeyError(f"unknown pool {name!r}; pools: "
                           f"{list(self._order)}") from None

    @property
    def default(self) -> DevicePool:
        """The first pool — where a poolset-free caller's work lands."""
        return self._pools[self._order[0]]

    @property
    def trivial(self) -> bool:
        """One pool, unit compute scale — the configuration whose plans
        must match the pre-pool planner exactly."""
        if len(self._order) != 1:
            return False
        p = self.default
        return p.compute_scale == 1.0 and p.healthy

    def healthy_pools(self) -> tuple:
        return tuple(p for p in self.pools() if p.healthy)

    def validate_names(self, names: Iterable[str]) -> tuple:
        out = tuple(names)
        for n in out:
            self.get(n)
        return out

    # -- health -------------------------------------------------------------
    @property
    def generation(self) -> int:
        """Monotone counter of health flips — plan caches key on it."""
        with self._lock:
            return self._generation

    def set_health(self, name: str, healthy: bool) -> DevicePool:
        """Flip one pool's health; a real change bumps the generation so
        cached plans that referenced the pool are re-costed."""
        pool = self.get(name)
        with self._lock:
            if pool.healthy != bool(healthy):
                pool.healthy = bool(healthy)
                self._generation += 1
        return pool


def default_pools(*, link_bandwidth: float = DEFAULT_LINK_BANDWIDTH,
                  cloud_compute_scale: float = 1.0,
                  capacity: Optional[int] = None,
                  devices: Optional[Sequence] = None) -> PoolSet:
    """The development two-pool topology: the process' devices split
    into an "onprem" first half and a "cloud" second half.

    On a one-device host both pools alias that device — still useful:
    placement, residency, spill and the transfer ledger are all
    observable, and the result contract makes the aliasing invisible.
    ``devices`` overrides discovery (e.g. ``[torch.device("cpu")]`` on
    a host without CUDA).  Discovery lists the CUDA devices and raises
    when there are none: nothing falls back to the CPU unasked.
    """
    if devices is None:
        import torch
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "default_pools: CUDA is not available; pass devices= "
                "explicitly (e.g. [torch.device('cpu')]) to run on the CPU")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = tuple(devices)
    half = max(len(devices) // 2, 1)
    onprem = devices[:half] or devices
    cloud = devices[half:] or devices
    return PoolSet([
        DevicePool("onprem", devices=onprem,
                   link_bandwidth=link_bandwidth, capacity=capacity),
        DevicePool("cloud", devices=cloud, link_bandwidth=link_bandwidth,
                   compute_scale=cloud_compute_scale, capacity=capacity),
    ])


def single_pool(name: str = "default", **kw) -> PoolSet:
    """A one-pool PoolSet — what a service without an explicit topology
    runs on; its plans are bit-compatible with the pre-pool planner."""
    return PoolSet([DevicePool(name, **kw)])
