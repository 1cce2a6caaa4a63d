"""``FleetSUT`` — the harness adapter that makes a simulated fleet a
first-class SUT.

One ``FleetSUT`` + one ``TraceServer`` scenario + one ``PowerRun`` is
the whole measurement: ``serve_queue`` replays the admission schedule
through a fresh ``FleetSim`` (controller and router state never leaks
between runs), and ``domains`` exposes every replica's exact
piecewise-constant wall trace as its own ``r{i}/wall`` power domain
with the fleet boundary a derived ``pdu`` register summing the walls —
the same §IV-C PDU-aggregation shape as ``ReplicatedSUT``, so
compliance R11 (register == Σ measured feeds) pins the fleet ledger.

The system description declares the *autoscaling* envelope: idle watts
are the floor the controller never scales below (``min_replicas`` warm
idles, not the whole fleet), and max watts are every replica at peak —
so compliance's idle/peak sanity band stays meaningful while the fleet
breathes between those extremes.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.compliance import SystemDescription
from repro_torch.fleet.lifecycle import ReplicaSpec
from repro_torch.fleet.simulator import FleetSim
from repro_torch.harness.sut import BaseSUT
from repro_torch.power import PDU, WALL, PowerDomain


class FleetSUT(BaseSUT):
    """An autoscaled fleet of modeled replicas behind one admission
    queue.

    Args:
        specs: every replica the fleet may use (heterogeneous mixes
            welcome); the controller scales within them.
        initial_warm: replicas warm at t=0 (default: all — a static
            fleet when no controller is given).
        make_controller: zero-arg factory returning a fresh
            ``FleetController`` per run (stateful hysteresis must not
            leak between runs); ``None`` pins the fleet static.
        make_router: zero-arg factory returning a fresh ``Router``
            (default ``LeastLoaded``).
        control_interval_s: controller tick cadence in virtual seconds.
        cap_w: per-replica DVFS power cap in watts (``None`` uncapped).
        default_out_tokens: decoded tokens per request when the query
            sample carries no ``out_tokens`` field.
    """

    def __init__(self, specs: Sequence[ReplicaSpec], *,
                 name: str = "fleet",
                 initial_warm: Optional[int] = None,
                 make_controller: Optional[Callable] = None,
                 make_router: Optional[Callable] = None,
                 control_interval_s: float = 1.0,
                 cap_w: Optional[float] = None,
                 default_out_tokens: int = 16,
                 sysdesc: Optional[SystemDescription] = None):
        specs = list(specs)
        if not specs:
            raise ValueError("FleetSUT needs at least one ReplicaSpec")
        self._floor_replicas = (len(specs) if initial_warm is None
                                else max(int(initial_warm), 1))
        if make_controller is not None:
            probe = make_controller()
            self._floor_replicas = max(probe.min_replicas, 1)
        if sysdesc is None:
            min_idle_w = min(s.idle_w for s in specs)
            sysdesc = SystemDescription(
                scale="datacenter",
                n_chips=sum(s.tp for s in specs),
                instrument="node-telemetry",
                telemetry_accuracy=0.01,
                max_system_watts=sum(s.peak_w() for s in specs),
                idle_system_watts=self._floor_replicas * min_idle_w)
        super().__init__(name, sysdesc)
        self.specs = specs
        self.initial_warm = initial_warm
        self.make_controller = make_controller
        self.make_router = make_router
        self.control_interval_s = control_interval_s
        self.cap_w = cap_w
        self.default_out_tokens = default_out_tokens
        self.fault_plan = None       # PowerRun hands its plan here
        self.sim: Optional[FleetSim] = None

    @property
    def n_replicas(self) -> int:
        """Fleet size (every replica the controller may wake)."""
        return len(self.specs)

    def _make_sim(self) -> FleetSim:
        return FleetSim(
            self.specs,
            initial_warm=self.initial_warm,
            controller=(self.make_controller()
                        if self.make_controller else None),
            router=self.make_router() if self.make_router else None,
            control_interval_s=self.control_interval_s,
            cap_w=self.cap_w,
            default_out_tokens=self.default_out_tokens,
            fault_plan=self.fault_plan)

    def serve_queue(self, arrivals: list) -> list:
        self.sim = self._make_sim()
        return self.sim.run(arrivals)

    def supports_serve_queue(self) -> bool:
        return True

    def completed_requests(self) -> Optional[list]:
        return self.sim.records if self.sim is not None else None

    def domains(self, outcome) -> list[PowerDomain]:
        if self.sim is None:
            raise RuntimeError(f"{self.name}: domains() before any "
                               f"serve_queue run — nothing to meter")
        doms: list[PowerDomain] = []
        wall_names: list[str] = []
        for r in self.sim.replicas:
            wall = f"r{r.index}/wall"
            doms.append(PowerDomain(name=wall, source=r.trace.source(),
                                    kind=WALL, group=f"r{r.index}",
                                    boundary=False))
            wall_names.append(wall)
        doms.append(PowerDomain(PDU, derived_from=tuple(wall_names),
                                boundary=True))
        return doms

    def power_source(self, outcome):
        sources = ([r.trace.source() for r in self.sim.replicas]
                   if self.sim is not None else [])

        def fleet(t):
            t = np.asarray(t, float)
            total = np.zeros_like(t)
            for src in sources:
                total = total + np.asarray(src(t), float)
            return total

        return fleet

    def replica_energy_j(self, outcome,
                         times_s: np.ndarray) -> list[float]:
        """Trapezoidal per-replica energy over the measured sample
        times (the ``ReplicatedSUT``-parity attribution surface); sums
        to the fleet trace's integral by linearity."""
        from repro_torch.core.summarizer import _trapz

        times_s = np.asarray(times_s, float)
        out = []
        for r in self.sim.replicas:
            w = np.asarray(r.trace.source()(times_s), float)
            out.append(float(_trapz(w, times_s)))
        return out

    def exact_replica_energy_j(
            self, horizon_s: Optional[float] = None) -> list[float]:
        """Exact per-replica joules from the step traces (no
        quadrature): Σ equals the pdu integral to machine precision."""
        if self.sim is None:
            raise RuntimeError(f"{self.name}: no run to bill")
        return self.sim.replica_energy_j(horizon_s)
