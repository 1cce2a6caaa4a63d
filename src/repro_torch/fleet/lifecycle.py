"""Replica lifecycle + power model for the fleet simulator.

A fleet replica moves through the states

    cold -> starting -> warm-idle <-> busy -> draining -> cold
                                  \\-> dead (ReplicaCrash)

and every state has a modeled wall draw: a ``cold`` replica draws
nothing, ``starting`` pays the cold-start surge for ``cold_start_s``
(weights paged in, caches compiled — energy that static-provisioning
sweeps never see), ``warm-idle`` burns the idle floor, ``busy`` adds
the utilization share of the busy draw scaled by the DVFS operating
point, and ``draining`` is busy-shaped until the last in-flight
request finishes.  ``dead`` replicas draw nothing from the crash
instant (matching ``ReplicatedSUT``'s crash clamp).

``DVFSCurve`` models per-replica power capping: dropping the clock to
frequency fraction ``f`` scales throughput ~linearly and dynamic
power superlinearly (``f**power_exp``), so a watt cap maps to the
highest frequency whose full-load draw fits under it —
``ReplicaSpec.freq_for_cap_w``.

``PowerTrace`` is the accounting surface: the simulator appends a
breakpoint whenever a replica's draw changes and the finished trace
becomes the replica's ``PowerDomain`` source (a step function) plus
an exact piecewise-constant energy integral — so the pdu fleet total
equals the sum of replica walls by construction (compliance R11).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Optional

import numpy as np

COLD = "cold"
STARTING = "starting"
WARM_IDLE = "warm-idle"
BUSY = "busy"
DRAINING = "draining"
DEAD = "dead"

STATES = (COLD, STARTING, WARM_IDLE, BUSY, DRAINING, DEAD)


@dataclasses.dataclass(frozen=True)
class DVFSCurve:
    """Frequency/power/throughput scaling for per-replica power caps.

    ``f`` is the clock fraction in ``[min_freq, 1]``.  Throughput
    scales as ``f ** throughput_exp`` (~linear: decode is
    bandwidth-bound) and the *dynamic* share of busy power as ``f **
    power_exp`` (CV^2f: superlinear, since voltage drops with
    frequency) — which is why capping trades watts for tokens/s at a
    favourable rate.
    """

    min_freq: float = 0.5
    power_exp: float = 2.4
    throughput_exp: float = 1.0

    def throughput_scale(self, f: float) -> float:
        """Token-rate multiplier at clock fraction ``f``."""
        return float(np.clip(f, self.min_freq, 1.0)
                     ** self.throughput_exp)

    def power_scale(self, f: float) -> float:
        """Dynamic-power multiplier at clock fraction ``f``."""
        return float(np.clip(f, self.min_freq, 1.0) ** self.power_exp)


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """Static facts of one replica type (the heterogeneous-fleet unit).

    ``tokens_per_s`` is the replica's full-occupancy decode rate at
    f=1.0 (all ``n_slots`` busy); the per-slot cadence is derived from
    it.  ``prefill_s`` is the fixed time-to-first-token cost of one
    request at f=1.0.  ``idle_w``/``busy_w`` bound the wall draw
    (busy at full occupancy, f=1.0); ``cold_start_s`` at
    ``cold_start_w`` is the modeled spin-up (checkpoint load + warmup
    compile), billed through the replica's own power domain.
    """

    label: str = "replica"
    tokens_per_s: float = 100.0
    prefill_s: float = 0.05
    n_slots: int = 4
    idle_w: float = 90.0
    busy_w: float = 260.0
    cold_start_s: float = 1.0
    cold_start_w: float = 180.0
    tp: int = 1
    dvfs: DVFSCurve = DVFSCurve()

    def __post_init__(self):
        if self.tokens_per_s <= 0 or self.n_slots < 1:
            raise ValueError(f"{self.label}: need tokens_per_s > 0 "
                             f"and n_slots >= 1")
        if self.busy_w < self.idle_w:
            raise ValueError(f"{self.label}: busy_w < idle_w")

    def tpot_s(self, freq: float = 1.0) -> float:
        """Per-slot decode cadence (seconds/token) at clock ``freq``."""
        per_slot = self.tokens_per_s / self.n_slots
        return 1.0 / (per_slot * self.dvfs.throughput_scale(freq))

    def ttft_service_s(self, freq: float = 1.0) -> float:
        """Prefill time of one request at clock ``freq`` (queue wait
        excluded)."""
        return self.prefill_s / self.dvfs.throughput_scale(freq)

    def watts(self, n_busy_slots: int, freq: float = 1.0) -> float:
        """Wall draw with ``n_busy_slots`` slots decoding at ``freq``:
        idle floor plus the occupancy share of the DVFS-scaled dynamic
        draw."""
        occupancy = min(n_busy_slots, self.n_slots) / self.n_slots
        dynamic_w = (self.busy_w - self.idle_w) \
            * self.dvfs.power_scale(freq)
        return self.idle_w + occupancy * dynamic_w

    def peak_w(self, freq: float = 1.0) -> float:
        """Full-occupancy draw at ``freq`` (the provisioning number)."""
        return max(self.watts(self.n_slots, freq), self.cold_start_w)

    def freq_for_cap_w(self, cap_w: Optional[float]) -> float:
        """Highest clock fraction whose *full-load* draw fits under
        ``cap_w``.  ``None`` (or a cap above busy_w) means f=1.0; a
        cap below the floor (idle + min-frequency dynamic draw)
        raises — the cap would be unenforceable."""
        if cap_w is None or cap_w >= self.busy_w:
            return 1.0
        dynamic_w = self.busy_w - self.idle_w
        floor_w = self.idle_w \
            + dynamic_w * self.dvfs.power_scale(self.dvfs.min_freq)
        if cap_w < floor_w:
            raise ValueError(
                f"{self.label}: cap {cap_w:.0f} W below the DVFS floor "
                f"{floor_w:.0f} W (idle + min-frequency dynamic draw)")
        # invert power_scale: f = ((cap - idle) / dynamic) ** (1/exp)
        f = ((cap_w - self.idle_w) / dynamic_w) \
            ** (1.0 / self.dvfs.power_exp)
        return float(np.clip(f, self.dvfs.min_freq, 1.0))

    def j_per_token(self, freq: float = 1.0) -> float:
        """Marginal busy energy per decoded token at ``freq`` — the
        energy-aware router's ranking key."""
        dynamic_w = (self.busy_w - self.idle_w) \
            * self.dvfs.power_scale(freq)
        rate = self.tokens_per_s * self.dvfs.throughput_scale(freq)
        return dynamic_w / rate


class PowerTrace:
    """Piecewise-constant wall draw of one replica, built event by
    event.

    The simulator calls ``set_watts(t, w)`` whenever the replica's
    draw changes (state transition, slot occupancy change, frequency
    change); ``source()`` exposes the finished trace as a step
    function for the replica's ``PowerDomain``, and ``energy_j`` /
    ``energy_between_j`` integrate it exactly (no quadrature error —
    the R11 sum check is exact because every replica wall is one of
    these).
    """

    def __init__(self, t0_s: float = 0.0, watts: float = 0.0):
        self.times_s: list[float] = [float(t0_s)]
        self.watts: list[float] = [float(watts)]

    def set_watts(self, t_s: float, w: float) -> None:
        """Draw becomes ``w`` watts from ``t_s`` on (monotone in t)."""
        t_s, w = float(t_s), float(w)
        if t_s < self.times_s[-1] - 1e-12:
            raise ValueError(
                f"PowerTrace breakpoints must be monotone: "
                f"{t_s} < {self.times_s[-1]}")
        if abs(t_s - self.times_s[-1]) <= 1e-12:
            self.watts[-1] = w           # same instant: overwrite
            return
        if w == self.watts[-1]:
            return                       # no change: skip breakpoint
        self.times_s.append(t_s)
        self.watts.append(w)

    def current_w(self) -> float:
        """The draw after the last breakpoint."""
        return self.watts[-1]

    def source(self):
        """``source(t_s) -> watts`` step function over the trace."""
        times = np.asarray(self.times_s, float)
        levels = np.asarray(self.watts, float)

        def step(t):
            t = np.asarray(t, float)
            idx = np.searchsorted(times, t, side="right") - 1
            idx = np.clip(idx, 0, len(levels) - 1)
            out = levels[idx]
            return np.where(t < times[0], 0.0, out)

        return step

    def energy_between_j(self, t0_s: float, t1_s: float) -> float:
        """Exact integral of the step trace over ``[t0_s, t1_s]``."""
        if t1_s <= t0_s:
            return 0.0
        total_j = 0.0
        i = max(0, bisect.bisect_right(self.times_s, t0_s) - 1)
        while i < len(self.times_s):
            seg_start = max(self.times_s[i], t0_s)
            seg_end = self.times_s[i + 1] \
                if i + 1 < len(self.times_s) else t1_s
            seg_end = min(seg_end, t1_s)
            if seg_end > seg_start:
                total_j += self.watts[i] * (seg_end - seg_start)
            if seg_end >= t1_s:
                break
            i += 1
        return float(total_j)

    def energy_j(self, horizon_s: float) -> float:
        """Exact integral of the step trace over ``[0, horizon_s]``."""
        return self.energy_between_j(0.0, horizon_s)
