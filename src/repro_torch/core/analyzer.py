"""Virtual SPEC-class power analyzer + node telemetry + tiny I/O manager.

These mirror the paper's three measurement instruments:

- ``VirtualAnalyzer``: an external AC power analyzer (Yokogawa WT310
  class) for edge/datacenter inference.  Samples a power source at a
  configurable rate with a realistic error model (gain + offset +
  quantization by range), supports *range mode* — an initial run
  observes peaks, subsequent runs pin the current/voltage ranges for
  better accuracy — and flags the <75 W crest-factor caveat (§III-A).
- ``NodeTelemetry``: IPMI/Redfish-style out-of-band node power readings
  for training/HPC, with optional PDU-level aggregation and an
  interconnect ``SwitchEstimator`` (documented estimation, §IV-C).
- ``IOManager``: tiny-scale UART-isolated capture; detects inference
  windows from the pin channel of the waveform (§IV-B).

Copied from the reference ``src/repro/core/analyzer.py``; only its imports
differ (the I/O manager integrates through the summarizer's ``_trapz``,
which also runs on numpy < 2).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core.mlperf_log import MLPerfLogger
from repro_torch.core.summarizer import _trapz


@dataclasses.dataclass
class AnalyzerSpec:
    name: str = "virtual-wt310"
    sample_hz: float = 10.0
    gain_error: float = 0.001        # 0.1 % of reading
    offset_error_w: float = 0.05
    ranges_w: tuple = (15.0, 75.0, 300.0, 1500.0, 6000.0)
    counts: int = 60_000             # quantization counts per range
    spec_approved: bool = True


class VirtualAnalyzer:
    """Samples ``source(t) -> watts``; the physics behind ``source`` is
    the analytical power model (or a replayed waveform)."""

    def __init__(self, spec: Optional[AnalyzerSpec] = None, seed: int = 0):
        # a default constructed per instance: a shared default-argument
        # AnalyzerSpec instance would leak range/spec mutations across
        # every analyzer constructed without an explicit spec
        self.spec = spec if spec is not None else AnalyzerSpec()
        self.rng = np.random.default_rng(seed)
        self.fixed_range: Optional[float] = None
        self.warnings: list[str] = []

    # --- range mode ---------------------------------------------------
    def range_probe(self, source: Callable[[np.ndarray], np.ndarray],
                    duration_s: float) -> float:
        """Initial run: observe the peak and pin the smallest range
        covering it (the paper's two-pass range mode)."""
        t = np.arange(0.0, duration_s, 1.0 / self.spec.sample_hz)
        peak = float(np.max(source(t)))
        for r in self.spec.ranges_w:
            if peak <= r:
                self.fixed_range = r
                return r
        self.fixed_range = self.spec.ranges_w[-1]
        return self.fixed_range

    def _range_for(self, w: float) -> float:
        if self.fixed_range is not None:
            return self.fixed_range
        for r in self.spec.ranges_w:          # autorange: coarser error
            if w <= r:
                return r
        return self.spec.ranges_w[-1]

    # --- measurement ----------------------------------------------------
    def measure(self, source: Callable[[np.ndarray], np.ndarray],
                duration_s: float, *, t0_ms: float = 0.0,
                logger: Optional[MLPerfLogger] = None,
                node: str = "sut") -> tuple[np.ndarray, np.ndarray]:
        """Sample the source; returns (t_ms, watts_measured)."""
        n = max(2, int(duration_s * self.spec.sample_hz))
        t = np.arange(n) / self.spec.sample_hz
        true_w = np.asarray(source(t), dtype=np.float64)
        # vectorized error model (a MeterStack samples many channels
        # per run; a per-sample Python loop would dominate metering
        # overhead): per-sample range selection, gain+offset noise,
        # quantization by the selected range
        if self.fixed_range is not None:
            rng_w = np.full(n, self.fixed_range)
            autorange_penalty = 1.0
        else:
            ranges = np.asarray(self.spec.ranges_w, dtype=np.float64)
            idx = np.minimum(np.searchsorted(ranges, true_w),
                             len(ranges) - 1)
            rng_w = ranges[idx]
            autorange_penalty = 2.0            # autorange: coarser error
        gain = self.spec.gain_error * autorange_penalty
        quant = rng_w / self.spec.counts
        noise = (true_w * gain * self.rng.standard_normal(n)
                 + self.spec.offset_error_w * self.rng.standard_normal(n))
        meas = np.round((true_w + noise) / quant) * quant
        if float(np.mean(true_w)) < 75.0:
            self.warnings.append(
                "mean power < 75 W: high crest-factor error possible "
                "(use DC supply or fixed low range)")
        t_ms = t0_ms + t * 1e3
        if logger is not None:
            for ti, wi in zip(t_ms, meas):
                logger.power_sample(float(ti), float(wi), node=node,
                                    source=self.spec.name)
        return t_ms, meas


@dataclasses.dataclass
class TelemetrySpec:
    name: str = "ipmi"
    sample_hz: float = 1.0           # BMC-class cadence
    accuracy: float = 0.02           # +/- 2 % of reading
    out_of_band: bool = True


class NodeTelemetry:
    """Per-node software telemetry (IPMI / Redfish semantics)."""

    def __init__(self, spec: Optional[TelemetrySpec] = None, seed: int = 0):
        # per-instance default (same shared-mutable-default bug class
        # as VirtualAnalyzer's spec)
        self.spec = spec if spec is not None else TelemetrySpec()
        self.rng = np.random.default_rng(seed)

    def measure_nodes(self, node_sources: dict[str, Callable],
                      duration_s: float, *, t0_ms: float = 0.0,
                      logger: Optional[MLPerfLogger] = None,
                      pdu_level: bool = False) -> dict[str, np.ndarray]:
        """Sample every node; optionally aggregate at PDU level (the
        paper's fallback when per-node measurement is not feasible)."""
        n = max(2, int(duration_s * self.spec.sample_hz))
        t = np.arange(n) / self.spec.sample_hz
        t_ms = t0_ms + t * 1e3
        out: dict[str, np.ndarray] = {"t_ms": t_ms}
        readings = {}
        for name, src in node_sources.items():
            w = np.asarray(src(t), dtype=np.float64)
            w = w * (1 + self.spec.accuracy * 0.5
                     * self.rng.standard_normal(len(t)))
            readings[name] = w
        if pdu_level:
            total = np.sum(list(readings.values()), axis=0)
            out["pdu"] = total
            if logger is not None:
                for ti, wi in zip(t_ms, total):
                    logger.power_sample(float(ti), float(wi), node="pdu",
                                        source=self.spec.name)
        else:
            out.update(readings)
            if logger is not None:
                for name, w in readings.items():
                    for ti, wi in zip(t_ms, w):
                        logger.power_sample(float(ti), float(wi), node=name,
                                            source=self.spec.name)
        return out


@dataclasses.dataclass
class SwitchEstimator:
    """Interconnect-switch power estimation with mandatory disclosure."""

    watts_per_switch: float = 500.0
    chips_per_switch: int = 64

    def estimate(self, n_chips: int, duration_s: float) -> dict:
        n_sw = max(0, -(-n_chips // self.chips_per_switch)
                   if n_chips > 8 else 0)
        e = n_sw * self.watts_per_switch * duration_s
        return {
            "n_switches": n_sw,
            "watts": n_sw * self.watts_per_switch,
            "energy_j": e,
            "methodology": ("constant nameplate-derated per-switch power; "
                            "documented estimate per MLPerf Power rules "
                            "(direct switch telemetry unavailable)"),
        }


class IOManager:
    """Tiny-scale capture: isolate SUT, find pin-demarcated windows."""

    def __init__(self, supply_volts: float = 3.0,
                 level_shifter_leak_w: float = 1e-6):
        self.volts = supply_volts
        self.leak = level_shifter_leak_w   # parasitic bound, must be ~0

    def windows(self, t: np.ndarray, pin: np.ndarray) -> list[tuple[int, int]]:
        """Rising/falling pin edges -> [start, stop) sample index pairs."""
        edges = np.diff(pin.astype(np.int8))
        starts = list(np.where(edges == 1)[0] + 1)
        stops = list(np.where(edges == -1)[0] + 1)
        if pin[0]:
            starts = [0] + starts
        if pin[-1]:
            stops = stops + [len(pin)]
        return list(zip(starts, stops))

    def energy_per_inference(self, t: np.ndarray, amps: np.ndarray,
                             pin: np.ndarray) -> tuple[float, int]:
        """Trapezoidal energy over each pin window, averaged."""
        ws = self.windows(t, pin)
        if not ws:
            raise ValueError("no inference windows found")
        energies = []
        for a, b in ws:
            if b - a < 2:
                continue
            e = _trapz(amps[a:b] * self.volts, t[a:b])
            energies.append(e - self.leak * (t[b - 1] - t[a]))
        return float(np.mean(energies)), len(energies)
