"""Director / SUT orchestration (edge & datacenter inference, §IV-B).

The Director (server) NTP-syncs with the SUT (client), starts the PTD
(power-thermal daemon) session against the *meter stack* — every
channel of a ``repro_torch.power.MeterStack``, driven as one unit on the
shared NTP-corrected timeline with per-channel two-pass ranging —
commands the SUT to run loadgen, collects both logs, and hands them to
the summarizer.  Everything runs in-process here, but the protocol
steps, clock-offset correction, and the range mode are the real ones.

This is protocol plumbing: benchmarks and examples should not wire
``Director.run_measurement`` closures by hand — the public entry point
is ``repro_torch.harness.PowerRun``, which composes the Director protocol
with a loadgen scenario, the summarizer, and the compliance review.
A scalar ``power_source`` is still accepted and wrapped into a
single-channel wall-only stack (the pre-domain API).

Copied from the reference ``src/repro/core/director.py``; only its imports
differ.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core.analyzer import VirtualAnalyzer
from repro_torch.core.mlperf_log import MLPerfLogger


@dataclasses.dataclass
class NTPSync:
    """Simulated clock offset between Director and SUT."""

    true_offset_ms: float = 37.0
    residual_ms: float = 0.5          # post-sync residual error

    def sync(self, rng: Optional[np.random.Generator] = None) -> float:
        rng = rng or np.random.default_rng(0)
        measured = self.true_offset_ms + rng.normal(0, self.residual_ms)
        return measured


@dataclasses.dataclass
class PTDSession:
    """Power-Thermal Daemon API facade.

    Historically wrapped one analyzer; it now fronts a whole
    ``MeterStack`` (SPEC PTDaemon's multi-channel mode).  ``analyzer``
    is kept as the legacy single-channel form — it is treated as a
    wall-only stack.
    """

    analyzer: Optional[VirtualAnalyzer] = None
    stack: Optional[object] = None            # repro_torch.power.MeterStack
    connected: bool = False

    def connect(self) -> dict:
        self.connected = True
        if self.stack is not None:
            return {"channels": self.stack.describe()}
        return {"device": self.analyzer.spec.name,
                "spec_approved": self.analyzer.spec.spec_approved}

    def set_range(self, watts: float, channel: Optional[str] = None):
        if self.stack is not None:
            self.stack.set_range(watts, channel)
        elif self.analyzer is not None:
            self.analyzer.fixed_range = watts

    def start_logging(self):
        assert self.connected, "PTD not connected"

    def stop_logging(self):
        pass


class Director:
    def __init__(self, analyzer: Optional[VirtualAnalyzer] = None,
                 seed: int = 0):
        self.analyzer = analyzer or VirtualAnalyzer(seed=seed)
        self.ptd = PTDSession(self.analyzer)
        self.perf_log = MLPerfLogger("perf")
        self.power_log = MLPerfLogger("power")
        self.clock_offset_ms = 0.0
        self.rng = np.random.default_rng(seed)

    def run_measurement(
        self, *,
        sut_run: Callable[[MLPerfLogger], float],
        power_source: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        meter_stack=None,
        range_mode: bool = True,
        probe_duration_s: float = 5.0,
        fault_injector=None,
        meter_retry=None,
    ) -> tuple[MLPerfLogger, MLPerfLogger]:
        """Full protocol: NTP sync -> PTD connect -> (per-channel range
        probe) -> loadgen run with concurrent power logging.

        ``fault_injector`` (``repro_torch.faults.FaultInjector``) subjects the
        stack's channels to the plan's metering hazards; ``meter_retry``
        (``repro_torch.faults.RetryPolicy``) bounds the stack's re-range /
        re-measure degradation loop.  Both default to off.

        ``sut_run(perf_log) -> duration_s`` executes the workload and
        writes run_start/run_stop + results into the perf log (in SUT
        clock).  The measured system is either a ``meter_stack``
        (multi-channel power domains) or — legacy form — a scalar
        ``power_source(t) -> watts``, which is wrapped into a
        single-channel wall-only stack around the session's analyzer.

        Each call starts fresh perf/power logs, so one Director session
        can be reused across measurements without the runs' windows and
        samples bleeding into each other.
        """
        if (power_source is None) == (meter_stack is None):
            raise ValueError(
                "run_measurement takes exactly one of power_source= "
                "(legacy scalar) or meter_stack=")
        if meter_stack is None:
            from repro_torch.power.stack import single_source_stack

            meter_stack = single_source_stack(power_source, self.analyzer)
        self.perf_log = MLPerfLogger("perf")
        self.power_log = MLPerfLogger("power")
        offset_ms = NTPSync().sync(self.rng)
        self.clock_offset_ms = offset_ms
        self.ptd = PTDSession(self.analyzer, meter_stack)
        self.ptd.connect()
        if range_mode:
            # two-pass mode: every channel pins the smallest range
            # covering its own observed peak (not the stack peak)
            meter_stack.range_probe(probe_duration_s)
        self.ptd.start_logging()
        duration_s = sut_run(self.perf_log)
        # all channels sample in Director clock on one shared timeline;
        # correct by the sync offset
        meter_stack.measure(duration_s, t0_ms=-offset_ms,
                            logger=self.power_log,
                            injector=fault_injector, retry=meter_retry)
        self.ptd.stop_logging()
        # shift power samples into SUT clock for the summarizer
        meter_stack.shift_clock(self.power_log, offset_ms)
        return self.perf_log, self.power_log
