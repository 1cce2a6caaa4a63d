"""Autoscaling policies + hysteresis wrapper for the fleet controller.

A policy is a pure function from an ``Observation`` (what the fleet
looks like at a control tick) to a desired warm-replica count.  The
``FleetController`` wraps any policy with the operational guardrails
that make autoscaling safe on real traffic: min/max clamps, scale-up
and scale-down cooldowns, and a consecutive-tick deadband on scale
*down* so a square-wave (bursty) trace cannot flap the fleet — tearing
down a replica you will need again in thirty seconds pays the
cold-start energy twice and the TTFT tail once.

Three policies ship:

- ``TargetUtilization`` — classic: size so busy-slot utilization sits
  at a target fraction of capacity.
- ``QueueDepth`` — reactive: size by backlog per replica.
- ``SloSlack`` — predictive: estimate the arrival rate over a lookahead
  window and size so projected TTFT queue wait stays inside a
  fraction of the TTFT SLO.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Observation:
    """Fleet state handed to a scaling policy at one control tick."""

    time_s: float
    queue_depth: int          # requests waiting, fleet-wide
    inflight: int             # requests being served
    n_warm: int               # warm-idle + busy + draining replicas
    n_starting: int           # replicas paying cold start right now
    slots_total: int          # capacity of warm replicas (busy slots)
    arrival_qps: float        # recent observed arrival rate
    service_qps_per_replica: float  # one replica's request/s capacity
    ttft_slo_s: Optional[float] = None

    @property
    def utilization(self) -> float:
        """Busy-slot fraction of warm capacity (0 when none warm)."""
        if self.slots_total <= 0:
            return 1.0 if (self.queue_depth or self.inflight) else 0.0
        return min(self.inflight / self.slots_total, 1.0)


class ScalingPolicy:
    """Interface: map an ``Observation`` to a desired replica count."""

    name = "policy"

    def desired_replicas(self, obs: Observation) -> int:
        """Replicas this policy wants warm (pre-clamp, pre-hysteresis)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class TargetUtilization(ScalingPolicy):
    """Size the fleet so busy-slot utilization sits at ``target``.

    Demand is measured as inflight + queued work converted to slot
    pressure; the desired count is demand / (slots × target), the
    textbook utilization controller.
    """

    target: float = 0.65
    slots_per_replica: int = 4
    name = "target-util"

    def desired_replicas(self, obs: Observation) -> int:
        demand_slots = obs.inflight + obs.queue_depth
        want = demand_slots / (self.slots_per_replica
                               * max(self.target, 1e-6))
        return max(1, math.ceil(want))


@dataclasses.dataclass(frozen=True)
class QueueDepth(ScalingPolicy):
    """Add replicas when the backlog per replica exceeds
    ``max_per_replica``; purely reactive, no rate model."""

    max_per_replica: float = 4.0
    name = "queue-depth"

    def desired_replicas(self, obs: Observation) -> int:
        n_live = max(obs.n_warm + obs.n_starting, 1)
        backlog_per = obs.queue_depth / n_live
        if backlog_per > self.max_per_replica:
            grow = math.ceil(obs.queue_depth / self.max_per_replica)
            return max(n_live, grow)
        if obs.queue_depth == 0 and obs.utilization < 0.3:
            return max(1, n_live - 1)
        return n_live


@dataclasses.dataclass(frozen=True)
class SloSlack(ScalingPolicy):
    """Predictive: keep projected queue wait inside ``slack`` of the
    TTFT SLO.

    With arrival rate λ and per-replica service rate μ, an M/M/n-style
    load bound needs n > λ/μ; the policy adds headroom so the
    projected wait (approximated by backlog drain time at the margin)
    stays under ``slack × ttft_slo_s``.
    """

    slack: float = 0.5
    headroom: float = 1.2
    name = "slo-slack"

    def desired_replicas(self, obs: Observation) -> int:
        mu = max(obs.service_qps_per_replica, 1e-9)
        base = obs.arrival_qps * self.headroom / mu
        want = math.ceil(max(base, 1.0))
        if obs.ttft_slo_s is not None and obs.queue_depth > 0:
            # backlog must drain inside the slack budget
            budget_s = self.slack * obs.ttft_slo_s
            drain = obs.queue_depth / (mu * max(budget_s, 1e-9))
            want = max(want, math.ceil(drain))
        return want


@dataclasses.dataclass
class FleetController:
    """Hysteresis + clamps around a ``ScalingPolicy``.

    - ``min_replicas``/``max_replicas`` hard-clamp the desired count.
    - ``cooldown_up_s``/``cooldown_down_s`` rate-limit direction
      changes (a scale event of either direction resets both clocks).
    - scale *down* additionally requires the policy to ask for fewer
      replicas on ``down_ticks`` consecutive ticks — the deadband that
      stops square-wave flapping: a burst gap shorter than ``down_ticks
      × tick interval`` never tears a replica down.

    ``decide`` returns the target count of live (warm + starting)
    replicas; the simulator turns the delta into start/drain actions.
    """

    policy: ScalingPolicy
    min_replicas: int = 1
    max_replicas: int = 8
    cooldown_up_s: float = 0.0
    cooldown_down_s: float = 30.0
    down_ticks: int = 3

    def __post_init__(self):
        if self.min_replicas < 0 or self.max_replicas < self.min_replicas:
            raise ValueError("need 0 <= min_replicas <= max_replicas")
        self._last_up_s = -math.inf
        self._last_down_s = -math.inf
        self._down_streak = 0
        self.scale_events = 0

    def decide(self, obs: Observation) -> int:
        """Target live-replica count after clamps and hysteresis."""
        n_live = obs.n_warm + obs.n_starting
        want = self.policy.desired_replicas(obs)
        want = max(self.min_replicas, min(self.max_replicas, want))

        if want > n_live:
            self._down_streak = 0
            if obs.time_s - self._last_up_s < self.cooldown_up_s:
                return n_live
            self._last_up_s = obs.time_s
            self.scale_events += 1
            return want

        if want < n_live:
            self._down_streak += 1
            if self._down_streak < self.down_ticks:
                return n_live
            if obs.time_s - self._last_down_s < self.cooldown_down_s:
                return n_live
            self._last_down_s = obs.time_s
            self._down_streak = 0
            self.scale_events += 1
            # step down one replica at a time: cheap to re-grow, and a
            # single tick never halves the fleet on a noisy estimate
            return n_live - 1

        self._down_streak = 0
        return n_live


POLICIES = {
    TargetUtilization.name: TargetUtilization,
    QueueDepth.name: QueueDepth,
    SloSlack.name: SloSlack,
}
