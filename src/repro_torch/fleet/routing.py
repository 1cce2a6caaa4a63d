"""Request routing across heterogeneous fleet replicas.

A router picks which warm replica admits the next request.  On a
homogeneous fleet this is load balancing; on a heterogeneous one
(tp1 vs tpK vs speculative replicas, each with its own
watts/throughput point) the choice moves the fleet's J/token — and,
with a time-varying grid, its gCO2.

- ``RoundRobin`` — the baseline rotation.
- ``LeastLoaded`` — lowest busy-slot occupancy (best TTFT).
- ``EnergyAware`` — lowest *marginal* J/token at the replica's current
  DVFS point, ties broken by load: keep efficient replicas full,
  let gas-guzzlers idle.
- ``CarbonAware`` — blends the two by grid intensity: when gCO2/kWh is
  above ``threshold_gco2_per_kwh``, route for energy; when the grid is
  clean, route for latency.

Routers see ``ReplicaView`` snapshots — enough state to rank without
reaching into the simulator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.fleet.lifecycle import ReplicaSpec
from repro_torch.fleet.traces import CarbonTrace


@dataclasses.dataclass(frozen=True)
class ReplicaView:
    """What a router may see of one warm replica at admission time."""

    index: int
    spec: ReplicaSpec
    busy_slots: int
    freq: float = 1.0

    @property
    def free_slots(self) -> int:
        """Admission capacity left on this replica."""
        return self.spec.n_slots - self.busy_slots

    @property
    def occupancy(self) -> float:
        """Busy-slot fraction in [0, 1]."""
        return self.busy_slots / self.spec.n_slots

    @property
    def marginal_j_per_token(self) -> float:
        """Busy-energy cost of one more decoded token at the current
        clock."""
        return self.spec.j_per_token(self.freq)


class Router:
    """Interface: choose a replica index from candidate views."""

    name = "router"

    def choose(self, views: Sequence[ReplicaView],
               t_s: float) -> Optional[int]:
        """Index of the chosen replica, or ``None`` if no candidate has
        a free slot (request waits in the fleet queue)."""
        raise NotImplementedError


def _with_slots(views: Sequence[ReplicaView]) -> list[ReplicaView]:
    return [v for v in views if v.free_slots > 0]


@dataclasses.dataclass
class RoundRobin(Router):
    """Rotate admissions across replicas with free slots."""

    name = "round-robin"
    _next: int = 0

    def choose(self, views, t_s):
        open_views = _with_slots(views)
        if not open_views:
            return None
        pick = open_views[self._next % len(open_views)]
        self._next += 1
        return pick.index


@dataclasses.dataclass
class LeastLoaded(Router):
    """Lowest occupancy first — spreads load, best for TTFT tails."""

    name = "least-loaded"

    def choose(self, views, t_s):
        open_views = _with_slots(views)
        if not open_views:
            return None
        return min(open_views,
                   key=lambda v: (v.occupancy, v.index)).index


@dataclasses.dataclass
class EnergyAware(Router):
    """Cheapest marginal J/token first; pack efficient replicas full
    before touching expensive ones."""

    name = "energy-aware"

    def choose(self, views, t_s):
        open_views = _with_slots(views)
        if not open_views:
            return None
        return min(open_views,
                   key=lambda v: (v.marginal_j_per_token,
                                  -v.busy_slots, v.index)).index


@dataclasses.dataclass
class CarbonAware(Router):
    """Grid-intensity-gated blend: energy-greedy when the grid is
    dirty, latency-greedy when it is clean.

    ``carbon`` supplies gCO2/kWh at the fleet clock; above
    ``threshold_gco2_per_kwh`` admissions rank by marginal J/token
    (every joule is expensive carbon), below it by occupancy (joules
    are cheap — spend them on tail latency).
    """

    carbon: CarbonTrace = dataclasses.field(default_factory=CarbonTrace)
    threshold_gco2_per_kwh: float = 450.0
    name = "carbon-aware"

    def __post_init__(self):
        self._energy = EnergyAware()
        self._latency = LeastLoaded()

    def choose(self, views, t_s):
        gco2_per_kwh = float(self.carbon.intensity_gco2_per_kwh(t_s))
        if gco2_per_kwh >= self.threshold_gco2_per_kwh:
            return self._energy.choose(views, t_s)
        return self._latency.choose(views, t_s)


ROUTERS = {
    RoundRobin.name: RoundRobin,
    LeastLoaded.name: LeastLoaded,
    EnergyAware.name: EnergyAware,
    CarbonAware.name: CarbonAware,
}
