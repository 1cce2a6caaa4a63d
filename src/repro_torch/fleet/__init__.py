"""Energy-aware fleet autoscaling (the ML.ENERGY axis), the port's copy
of the reference's ``fleet`` package: numpy and the port's own
protocol layers (``core``, ``power``, ``harness``, ``faults``) only,
so the copy is the reference's code with its imports pointed at
``repro_torch``.  The fleet is modeled: replicas are ``ReplicaSpec``
operating points served in virtual time, and nothing here runs on a
device.

The paper's measurements fix the system under test; ``repro_torch.fleet``
asks what the same metering discipline says about a *fleet* under
time-varying load, where idle watts, cold starts, and provisioning
slack dominate the bill.  The subsystem is four small layers:

- ``traces``     — seeded diurnal/bursty/ramp arrival generators and a
  time-varying grid-carbon trace; a 24 h day compresses onto a test
  window without changing the arrival count.
- ``lifecycle``  — the replica state machine (cold/starting/warm-idle/
  busy/draining/dead), the DVFS power-cap curve, and the exact
  piecewise-constant ``PowerTrace`` each replica bills into.
- ``controller`` / ``routing`` — pluggable scaling policies behind a
  hysteresis wrapper, and load/energy/carbon-aware request placement.
- ``simulator`` / ``sut`` — the deterministic event loop and the
  ``FleetSUT`` adapter that keeps the one-call ``PowerRun`` shape with
  per-replica power domains under the fleet pdu (R11 exact).

``repro_torch.benchmarks.fleet_sweep`` is the headline consumer: the 24 h
SLO-vs-joules-vs-provisioned-watts Pareto table.
"""
from repro_torch.fleet.controller import (FleetController, Observation,
                                    POLICIES, QueueDepth, ScalingPolicy,
                                    SloSlack, TargetUtilization)
from repro_torch.fleet.lifecycle import (DVFSCurve, PowerTrace, ReplicaSpec,
                                   STATES)
from repro_torch.fleet.routing import (CarbonAware, EnergyAware, LeastLoaded,
                                 ROUTERS, ReplicaView, Router,
                                 RoundRobin)
from repro_torch.fleet.simulator import FleetRecord, FleetSim
from repro_torch.fleet.sut import FleetSUT
from repro_torch.fleet.traces import (ArrivalTrace, CarbonTrace, TRACES,
                                bursty_trace, diurnal_trace, ramp_trace)

__all__ = [
    "ArrivalTrace", "CarbonTrace", "TRACES",
    "bursty_trace", "diurnal_trace", "ramp_trace",
    "DVFSCurve", "PowerTrace", "ReplicaSpec", "STATES",
    "FleetController", "Observation", "POLICIES", "QueueDepth",
    "ScalingPolicy", "SloSlack", "TargetUtilization",
    "CarbonAware", "EnergyAware", "LeastLoaded", "ROUTERS",
    "ReplicaView", "Router", "RoundRobin",
    "FleetRecord", "FleetSim", "FleetSUT",
]
