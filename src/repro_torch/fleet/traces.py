"""Seeded arrival and carbon-intensity traces for fleet simulation.

Real fleets see time-varying load: the diurnal swing of user traffic,
bursts from batch jobs or retry storms, ramps as a launch picks up.
The paper measures fixed operating points; these generators produce
the 24 h schedules the fleet controller is exercised against, and
``compress`` maps a day onto a few hundred virtual seconds so the
whole horizon fits a test run (the ``VirtualAnalyzer`` samples
analytically, so compressed time costs nothing in fidelity).

Every generator is a seeded nonhomogeneous Poisson process (thinning
over the rate envelope), so a trace is fully determined by its
parameters + seed: the property tests pin seeded determinism,
non-negative inter-arrival gaps, and arrival-count conservation under
compression.

``CarbonTrace`` models the grid's time-varying carbon intensity
(gCO2/kWh, diurnal: low mid-day under solar, high overnight) for
carbon-aware routing and reporting.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ArrivalTrace:
    """An explicit arrival schedule: sorted seconds from trace start.

    ``horizon_s`` is the window the schedule was generated over (every
    arrival lies in ``[0, horizon_s)``); ``label`` names the shape for
    reports.
    """

    arrivals_s: np.ndarray
    horizon_s: float
    label: str = "trace"

    def __post_init__(self):
        arr = np.asarray(self.arrivals_s, float)
        if arr.size and np.any(np.diff(arr) < 0):
            raise ValueError(f"{self.label}: arrivals must be sorted")
        object.__setattr__(self, "arrivals_s", arr)

    @property
    def n_arrivals(self) -> int:
        """Number of arrivals in the schedule."""
        return int(self.arrivals_s.size)

    @property
    def mean_qps(self) -> float:
        """Average offered rate over the horizon."""
        return self.n_arrivals / max(self.horizon_s, 1e-9)

    def compress(self, factor: float) -> "ArrivalTrace":
        """The same arrivals on a horizon ``factor`` times shorter.

        Pure time scaling: the arrival *count* is conserved exactly and
        relative spacing is preserved, so a 24 h diurnal day replays in
        ``86400 / factor`` virtual seconds with identical collision
        geometry (rates scale up by ``factor``).
        """
        if factor <= 0:
            raise ValueError(f"compress factor must be > 0: {factor}")
        return ArrivalTrace(self.arrivals_s / factor,
                            self.horizon_s / factor,
                            label=f"{self.label}/x{factor:g}")

    def rate_qps(self, t_s: float, window_s: float) -> float:
        """Observed arrival rate in ``[t_s - window_s, t_s)`` — what a
        controller's rate estimator sees at time ``t_s``."""
        lo = np.searchsorted(self.arrivals_s, t_s - window_s)
        hi = np.searchsorted(self.arrivals_s, t_s)
        return float(hi - lo) / max(window_s, 1e-9)


def _thinned(rate_of, peak_qps: float, horizon_s: float,
             seed: int, label: str) -> ArrivalTrace:
    """Nonhomogeneous Poisson arrivals by thinning a ``peak_qps``
    homogeneous process with acceptance ``rate_of(t) / peak_qps``."""
    if peak_qps <= 0 or horizon_s <= 0:
        raise ValueError(
            f"{label}: peak_qps and horizon_s must be > 0 "
            f"(got {peak_qps}, {horizon_s})")
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    while True:
        t += rng.exponential(1.0 / peak_qps)
        if t >= horizon_s:
            break
        if rng.random() * peak_qps <= rate_of(t):
            out.append(t)
    return ArrivalTrace(np.asarray(out, float), horizon_s, label=label)


def diurnal_trace(*, peak_qps: float, trough_qps: float,
                  horizon_s: float = 86_400.0,
                  period_s: float = 86_400.0,
                  seed: int = 0) -> ArrivalTrace:
    """One (or more) day of diurnal traffic: a raised-cosine rate
    envelope between ``trough_qps`` (t=0, night) and ``peak_qps``
    (mid-period, midday)."""
    if trough_qps < 0 or peak_qps < trough_qps:
        raise ValueError(
            f"need 0 <= trough_qps <= peak_qps "
            f"(got {trough_qps}, {peak_qps})")

    def rate_of(t: float) -> float:
        phase = 0.5 * (1.0 - np.cos(2.0 * np.pi * t / period_s))
        return trough_qps + (peak_qps - trough_qps) * phase

    return _thinned(rate_of, peak_qps, horizon_s, seed, "diurnal")


def bursty_trace(*, base_qps: float, burst_qps: float,
                 burst_period_s: float, burst_duration_s: float,
                 horizon_s: float, seed: int = 0) -> ArrivalTrace:
    """A square-wave rate: ``base_qps`` background with ``burst_qps``
    plateaus of ``burst_duration_s`` every ``burst_period_s`` — the
    controller-hysteresis stress shape (a naive scaler flaps on every
    edge)."""
    if burst_duration_s > burst_period_s:
        raise ValueError("burst_duration_s must fit in burst_period_s")

    def rate_of(t: float) -> float:
        in_burst = (t % burst_period_s) < burst_duration_s
        return burst_qps if in_burst else base_qps

    peak = max(base_qps, burst_qps)
    return _thinned(rate_of, peak, horizon_s, seed, "bursty")


def ramp_trace(*, start_qps: float, end_qps: float, horizon_s: float,
               seed: int = 0) -> ArrivalTrace:
    """A linear rate ramp from ``start_qps`` to ``end_qps`` — launch-day
    growth (up) or drain-down (down)."""

    def rate_of(t: float) -> float:
        return start_qps + (end_qps - start_qps) * (t / horizon_s)

    peak = max(start_qps, end_qps)
    return _thinned(rate_of, peak, horizon_s, seed, "ramp")


TRACES = {
    "diurnal": diurnal_trace,
    "bursty": bursty_trace,
    "ramp": ramp_trace,
}


@dataclasses.dataclass(frozen=True)
class CarbonTrace:
    """Time-varying grid carbon intensity (gCO2 per kWh).

    A raised-cosine diurnal model: intensity dips to ``base_gco2_per_kwh
    - swing_gco2_per_kwh`` mid-period (solar noon) and peaks at ``base +
    swing`` at the period edges (overnight fossil baseload).  The trace
    shares the arrival trace's clock, so a compressed day uses a
    compressed ``period_s``.
    """

    base_gco2_per_kwh: float = 450.0
    swing_gco2_per_kwh: float = 250.0
    period_s: float = 86_400.0

    def intensity_gco2_per_kwh(self, t_s) -> np.ndarray:
        """Grid intensity at trace time ``t_s`` (array-friendly)."""
        t_s = np.asarray(t_s, float)
        phase = np.cos(2.0 * np.pi * t_s / self.period_s)
        return self.base_gco2_per_kwh \
            + self.swing_gco2_per_kwh * phase

    def emitted_gco2(self, energy_j, t_s) -> float:
        """Grams of CO2 for ``energy_j`` joules drawn at ``t_s``."""
        kwh = np.asarray(energy_j, float) / 3.6e6
        return float(np.sum(kwh * self.intensity_gco2_per_kwh(t_s)))
