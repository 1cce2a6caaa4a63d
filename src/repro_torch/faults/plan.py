"""Typed fault specs and the deterministic ``FaultPlan``.

The measurement hazards the paper's methodology exists to survive —
analyzer range overloads caught by PTDaemon's ranging passes, dropped
telemetry samples, NTP clock skew — plus the fleet-serving hazards
(replica crash/hang, admission-queue overload) are modelled here as
small frozen spec dataclasses.  A ``FaultPlan`` bundles a set of them
with one seed; every stochastic choice a fault makes (which samples a
partial dropout eats, the arrival times of an overload burst) is drawn
from a generator keyed on ``(seed, fault kind, channel, attempt)``, so
the same plan replayed against the same run produces byte-identical
results — the property the determinism acceptance test pins.

``transient`` faults fire only on the *first* attempt (run attempt 0,
channel retry 0): a re-measured interval or a re-executed run sees
clean data, which is what makes bounded retry a cure.  Persistent
faults (``transient=False``) keep firing until a structural fix —
re-ranging for an overload, rerouting for a crashed replica — removes
their effect.

Copied unchanged from the reference ``src/repro/faults/plan.py`` (numpy
only), so one seed gives the reference's draws bit for bit.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff shared by every degradation path
    (meter interval re-measurement, fleet re-dispatch, run re-execution).

    ``delay_s(k)`` is the modeled wait before retry ``k`` (0-based);
    delays grow by ``backoff_mult`` per attempt and the total number of
    retries is hard-capped at ``max_attempts``.
    """

    max_attempts: int = 3
    backoff_s: float = 0.05
    backoff_mult: float = 2.0

    def delay_s(self, attempt: int) -> float:
        return self.backoff_s * self.backoff_mult ** max(0, attempt)

    def total_backoff_s(self) -> float:
        return float(sum(self.delay_s(k) for k in range(self.max_attempts)))


# --- metering faults ----------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MeterDropout:
    """Telemetry samples of ``channel`` lost in ``[start_s, start_s +
    duration_s)`` (run-relative seconds).  ``drop_fraction < 1`` drops a
    seeded random subset of the window's samples instead of all of
    them.  Transient by default: a re-measured interval recovers."""

    channel: str
    start_s: float
    duration_s: float
    drop_fraction: float = 1.0
    transient: bool = True


@dataclasses.dataclass(frozen=True)
class RangeOverload:
    """The true draw of ``channel`` surges by ``factor`` inside the
    window — past the range the two-pass probe pinned, so a range-mode
    analyzer clips at its fixed range.  Persistent by default: the
    surge is real power, and only re-ranging (the stack bumps the
    channel to the next covering range before re-measuring) stops the
    clipping."""

    channel: str
    start_s: float
    duration_s: float
    factor: float = 4.0
    transient: bool = False


@dataclasses.dataclass(frozen=True)
class ClockSkew:
    """An NTP-skew spike: the channel's sample timestamps jump by
    ``skew_ms`` from ``at_s`` onward.  The stack knows its own nominal
    grid (shared timeline), so it realigns and counts the correction in
    the channel's health rather than logging shifted samples."""

    channel: str
    at_s: float
    skew_ms: float = 250.0
    transient: bool = True


# --- serving faults -----------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ReplicaCrash:
    """Replica ``replica`` dies at ``at_s`` (serve-clock seconds): no
    request of its completes past that instant and its power domains
    read zero afterwards (the fleet bills it through its crash time)."""

    replica: int
    at_s: float


@dataclasses.dataclass(frozen=True)
class ReplicaHang:
    """Replica ``replica`` stalls for ``duration_s`` starting at
    ``at_s``: every completion it would have produced after ``at_s`` is
    delayed by the stall (deadlines turn the stragglers into explicit
    timeouts)."""

    replica: int
    at_s: float
    duration_s: float


@dataclasses.dataclass(frozen=True)
class QueueOverload:
    """An arrival burst at ``qps`` layered on top of the scenario's
    Poisson schedule for ``duration_s`` from ``at_s`` — the load-
    shedding trigger."""

    at_s: float
    duration_s: float
    qps: float


METER_FAULTS = (MeterDropout, RangeOverload, ClockSkew)


def _crc(name: str) -> int:
    """Stable small int from a channel name (rng key material)."""
    return zlib.crc32(name.encode("utf-8"))


class FaultPlan:
    """A seeded, deterministic set of faults for one measured run.

    ``attempt`` is the run-level retry counter (set by ``PowerRun``'s
    ``retry_policy`` loop); transient faults fire only at attempt 0, so
    a re-executed run recovers.  The plan is safely reusable: consumers
    key their generators on the seed rather than sharing stateful rng
    objects, and ``PowerRun`` resets ``attempt`` when its loop ends.
    """

    def __init__(self, faults=(), *, seed: int = 0):
        self.faults = tuple(faults)
        self.seed = int(seed)
        self.attempt = 0

    def __repr__(self):
        return (f"FaultPlan(seed={self.seed}, "
                f"faults={[type(f).__name__ for f in self.faults]})")

    def rng(self, *key) -> np.random.Generator:
        """Fresh generator keyed on the plan seed + a structured key
        (strings hashed stably) — the source of every stochastic fault
        decision."""
        parts = [self.seed]
        for k in key:
            parts.append(_crc(k) if isinstance(k, str) else int(k))
        return np.random.default_rng(parts)

    def active(self, fault, retry: int = 0) -> bool:
        """Does ``fault`` fire on this (run attempt, channel retry)?"""
        if not getattr(fault, "transient", False):
            return True
        return self.attempt == 0 and retry == 0

    # --- per-layer queries ---------------------------------------------
    def meter_faults(self, channel: str) -> list:
        return [f for f in self.faults
                if isinstance(f, METER_FAULTS) and f.channel == channel]

    def crash_of(self, replica: int) -> Optional[ReplicaCrash]:
        for f in self.faults:
            if isinstance(f, ReplicaCrash) and f.replica == replica:
                return f
        return None

    def hang_of(self, replica: int) -> Optional[ReplicaHang]:
        for f in self.faults:
            if isinstance(f, ReplicaHang) and f.replica == replica:
                return f
        return None

    def overloads(self) -> list[QueueOverload]:
        return [f for f in self.faults if isinstance(f, QueueOverload)]

    def burst_arrivals(self) -> np.ndarray:
        """Extra arrival times (seconds from run start) injected by the
        plan's ``QueueOverload`` bursts, seeded per burst."""
        out: list[float] = []
        for k, f in enumerate(self.overloads()):
            rng = self.rng("overload", k)
            t = f.at_s
            while True:
                t += rng.exponential(1.0 / f.qps)
                if t >= f.at_s + f.duration_s:
                    break
                out.append(t)
        return np.asarray(sorted(out), float)
