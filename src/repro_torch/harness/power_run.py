"""One-call measured run: ``PowerRun(sut, scenario).run()``.

Composes the full paper methodology around one scenario execution:

1. run the scenario against the SUT (``repro_torch.core.loadgen``),
2. build the SUT's multi-channel ``MeterStack`` (power domains +
   scale-appropriate instruments, ``repro_torch.power``),
3. Director protocol — NTP sync, PTD connect, per-channel two-pass
   range probe, concurrent power logging on one shared timeline
   (``repro_torch.core.director``),
4. summarizer window extraction + per-domain trapezoidal energy
   integration (boundary channels total; rails are the breakdown),
5. compliance review against the submission rules, including the
   cross-domain invariants (wall >= sum of rails; wall == rails/eta
   within the channels' error model),
6. an ``efficiency.Submission`` record (with per-domain watts) for
   trend analyses,
7. per-request energy attribution — total and per domain — when the
   SUT kept request records.

Instruments are picked per scale when the SUT declares domains: tiny
pin channels get a µW-class I/O-manager-grade channel (kHz sampling,
sub-µW offset error); edge gets the SPEC-approved WT310-class
analyzer; datacenter channels use node telemetry with the documented
accuracy.  A SUT that only provides the legacy scalar
``power_source`` is wrapped into a single-channel wall-only stack
(with a ``DeprecationWarning``).

Copied from the reference ``src/repro/harness/power_run.py``; besides
its imports, per-request energy goes through the port's
``repro_torch.serving.attribute_request_energy`` and the default
``software_id`` is ``repro-torch``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np

from repro_torch.core import efficiency
from repro_torch.core.analyzer import AnalyzerSpec, VirtualAnalyzer
from repro_torch.core.compliance import Check, ReviewReport, review
from repro_torch.core.director import Director
from repro_torch.core.loadgen import Clock, QuerySampleLibrary
from repro_torch.core.mlperf_log import MLPerfLogger
from repro_torch.core.summarizer import EnergySummary, summarize
from repro_torch.harness.scenarios import Scenario, ScenarioOutcome
from repro_torch.power import MeterStack, single_source_stack

# µW-regime instrument: the WT310-class defaults (50 mW offset error,
# 15 W bottom range) would drown a duty-cycled MCU trace.  (Kept as a
# public name; the stack builder's PIN_CHANNEL is the same spec.)
TINY_ANALYZER = AnalyzerSpec(
    name="virtual-io-manager", sample_hz=2000.0, gain_error=0.001,
    offset_error_w=1e-7, ranges_w=(1e-3, 1e-2, 1e-1, 1.0), counts=60_000)


def analyzer_for_scale(scale: str, seed: int = 0) -> VirtualAnalyzer:
    """Instrument matched to the scale class: the µW-range I/O-manager
    spec for ``tiny`` SUTs, the default WT310-class analyzer else."""
    if scale == "tiny":
        return VirtualAnalyzer(TINY_ANALYZER, seed=seed)
    return VirtualAnalyzer(seed=seed)


@dataclasses.dataclass
class SubmissionResult:
    """Everything a measured run produced, in one object."""

    outcome: ScenarioOutcome
    summary: EnergySummary
    report: ReviewReport
    submission: efficiency.Submission
    perf_log: MLPerfLogger
    power_log: MLPerfLogger
    per_request_energy_j: Optional[dict] = None
    # per-domain views (populated by every MeterStack run)
    meter_stack: Optional[MeterStack] = None
    per_request_domain_energy_j: Optional[dict] = None
    # robustness views: one dict per executed attempt (the retry loop's
    # audit trail — rejection reasons of every invalid attempt), and
    # the stack's per-channel degradation health
    attempts: Optional[list] = None
    channel_health: Optional[dict] = None

    @property
    def passed(self) -> bool:
        """True when the compliance review ACCEPTED the run."""
        return self.report.passed

    @property
    def samples_per_joule(self) -> float:
        """The headline efficiency number (measured if available,
        else the submission record's)."""
        if self.summary.samples_per_joule is not None:
            return self.summary.samples_per_joule
        return self.submission.samples_per_joule

    @property
    def per_domain_energy_j(self) -> dict:
        """Joules per channel (boundary domains + breakdown rails)."""
        return self.summary.per_domain_j

    @property
    def per_domain_watts(self) -> dict:
        """Average watts per channel over the measurement window."""
        return self.summary.domain_watts()

    def domain_samples_per_joule(self) -> dict:
        """Per-domain efficiency (what the throughput costs each rail)."""
        return self.submission.domain_samples_per_joule()

    def power_samples(self) -> tuple[np.ndarray, np.ndarray]:
        """(times_s, watts) of the *boundary* channels (the submission
        total), SUT clock."""
        return _power_samples(self.power_log)

    def domain_samples(self, domain: str
                       ) -> tuple[np.ndarray, np.ndarray]:
        """(times_s, watts) of one named channel, SUT clock."""
        return _power_samples(self.power_log, node=domain,
                              boundary_only=False)

    def render(self) -> str:
        """Human-readable digest: metrics, Joules, per-domain split,
        and the compliance report."""
        o, s = self.outcome, self.summary
        lines = [
            f"{o.scenario}[{self.submission.workload}]: "
            f"{o.result.n_queries} queries in {o.result.duration_s:.2f} s, "
            f"{o.result.qps:.2f} samples/s, p99 {o.result.p99 * 1e3:.2f} ms"
            + (f", SLO met: {o.slo_met}" if o.slo_met is not None else ""),
            f"energy: {s.energy_j:.3f} J over {s.window_s:.2f} s "
            f"({s.avg_watts:.3f} W avg) -> "
            f"{self.samples_per_joule:.4f} samples/J",
        ]
        if len(s.per_node_j) > 1:
            split = ", ".join(
                f"{k}={v:.3f} J" for k, v in sorted(s.per_node_j.items()))
            lines.append(f"domains: {split} "
                         f"(boundary: {'+'.join(s.boundary_nodes)})")
        lines.append(self.report.render())
        return "\n".join(lines)


class PowerRun:
    """One measured scenario run: ``PowerRun(sut, scenario).run()``.

    ``qsl`` defaults to a 64-sample index library (most SUT adapters
    build their own inputs from the sample index).  Pass a ``director``
    to reuse a session across runs; ``sample_hz`` overrides every
    stack channel's sampling rate together (benchmarks resolving
    sub-second windows pass 1000.0).

    Robustness knobs:

    - ``fault_plan`` (``repro_torch.faults.FaultPlan``): the run's injected
      hazards.  Metering faults are applied inside the stack; the plan
      is also handed to the scenario and SUT when they accept one
      (queue-overload bursts, replica crash/hang).
    - ``meter_retry`` (``repro_torch.faults.RetryPolicy``): bounds the
      stack's re-range / re-measure degradation loop.
    - ``retry_policy`` (``repro_torch.faults.RetryPolicy``): an invalid
      (REJECTED) run is re-executed up to ``max_attempts`` times;
      every attempt's rejection reasons land in ``result.attempts``.
    - ``watchdog_s``: wall-clock budget per attempt; an overrun
      appends a failed ``W1 watchdog`` check (a hung run must fail
      loudly, not hang the harness report).
    """

    def __init__(self, sut, scenario: Scenario, *,
                 qsl: Optional[QuerySampleLibrary] = None,
                 director: Optional[Director] = None,
                 seed: int = 0, range_mode: bool = True,
                 probe_duration_s: float = 5.0,
                 sample_hz: Optional[float] = None,
                 clock: Optional[Clock] = None,
                 switch_estimate: Optional[dict] = None,
                 workload: Optional[str] = None,
                 version: str = "v1.0",
                 system_id: Optional[str] = None,
                 software_id: str = "repro-torch",
                 fault_plan=None,
                 meter_retry=None,
                 retry_policy=None,
                 watchdog_s: Optional[float] = None,
                 coverage_threshold: float = 0.95):
        self.sut = sut
        self.scenario = scenario
        self.qsl = qsl or QuerySampleLibrary(64, lambda i: {"idx": i})
        self.director = director
        self.seed = seed
        self.range_mode = range_mode
        self.probe_duration_s = probe_duration_s
        self.sample_hz = sample_hz
        self.clock = clock
        self.switch_estimate = switch_estimate
        self.workload = workload
        self.version = version
        self.system_id = system_id
        self.software_id = software_id
        self.fault_plan = fault_plan
        self.meter_retry = meter_retry
        self.retry_policy = retry_policy
        self.watchdog_s = watchdog_s
        self.coverage_threshold = coverage_threshold
        if fault_plan is not None:
            # one plan drives every layer: hand it to the scenario
            # (queue bursts) and the SUT (replica crash/hang) when
            # they take one and don't already have their own
            if getattr(scenario, "fault_plan", False) is None:
                scenario.fault_plan = fault_plan
            if getattr(sut, "fault_plan", False) is None:
                sut.fault_plan = fault_plan

    def _meter_stack(self, outcome, scale: str) -> MeterStack:
        make = getattr(self.sut, "meter_stack", None)
        if make is not None:
            return make(outcome, seed=self.seed,
                        sample_hz=self.sample_hz)
        # a bare-protocol SUT with only the scalar surface
        warnings.warn(
            f"{getattr(self.sut, 'name', 'sut')}: scalar power_source "
            f"SUTs are deprecated — provide meter_stack()/domains()",
            DeprecationWarning, stacklevel=2)
        analyzer = analyzer_for_scale(scale, self.seed)
        if self.sample_hz is not None:
            analyzer.spec = dataclasses.replace(
                analyzer.spec, sample_hz=self.sample_hz)
        return single_source_stack(self.sut.power_source(outcome),
                                   analyzer)

    def run(self) -> SubmissionResult:
        """Execute the run; with ``retry_policy``, re-execute invalid
        attempts (bounded) and return the first valid one — or the last
        attempt with the full per-attempt rejection trail."""
        import time as _time

        plan = self.fault_plan
        policy = self.retry_policy
        n_attempts = policy.max_attempts if policy is not None else 1
        attempts: list[dict] = []
        result = None
        for attempt in range(n_attempts):
            if plan is not None:
                # transient faults fire only on attempt 0 (plan.active)
                plan.attempt = attempt
            t0 = _time.perf_counter()
            result = self._run_once()
            wall_s = _time.perf_counter() - t0
            if (self.watchdog_s is not None
                    and wall_s > self.watchdog_s):
                result.report.checks.append(Check(
                    "W1 watchdog", False,
                    f"attempt took {wall_s:.2f} s wall > "
                    f"{self.watchdog_s:.2f} s budget — runaway run "
                    f"killed by the harness watchdog"))
            attempts.append({
                "attempt": attempt,
                "valid": result.report.passed,
                "wall_s": wall_s,
                "rejected": [f"{c.rule}: {c.detail}"
                             for c in result.report.failures()],
            })
            if result.report.passed:
                break
        if plan is not None:
            plan.attempt = 0     # same plan re-runs byte-identically
        result.attempts = attempts
        return result

    def _run_once(self) -> SubmissionResult:
        outcome = self.scenario.run(self.sut, self.qsl, self.clock)
        sysdesc = self.sut.system_description()
        stack = self._meter_stack(outcome, sysdesc.scale)
        director = self.director or Director(
            analyzer=analyzer_for_scale(sysdesc.scale, self.seed),
            seed=self.seed)
        dur_s = outcome.result.duration_s

        def sut_run(log: MLPerfLogger) -> float:
            log.run_start(0.0)
            log.result("samples_processed", outcome.samples_processed,
                       dur_s * 1e3)
            log.run_stop(dur_s * 1e3)
            return dur_s

        injector = None
        if self.fault_plan is not None:
            from repro_torch.faults import FaultInjector

            injector = FaultInjector(self.fault_plan)
        perf_log, power_log = director.run_measurement(
            sut_run=sut_run, meter_stack=stack,
            range_mode=self.range_mode,
            probe_duration_s=self.probe_duration_s,
            fault_injector=injector, meter_retry=self.meter_retry)
        summary = summarize(perf_log.events, power_log.events,
                            switch_estimate=self.switch_estimate)
        report = review(perf_log.events, power_log.events, sysdesc,
                        min_duration_s=self.scenario.min_duration_s,
                        range_mode_used=self.range_mode,
                        meter_stack=stack,
                        coverage_threshold=self.coverage_threshold)
        submission = efficiency.Submission(
            version=self.version,
            workload=self.workload or self.sut.name,
            scale=sysdesc.scale,
            system_id=self.system_id or sysdesc.instrument,
            software_id=self.software_id,
            samples_per_second=(summary.samples_per_second
                                or outcome.result.qps),
            avg_watts=summary.avg_watts,
            per_domain_watts=summary.domain_watts())

        per_request = None
        per_request_domain = None
        completed = getattr(self.sut, "completed_requests", lambda: None)()
        if completed:
            from repro_torch.serving import attribute_request_energy
            # speculative SUTs weight the split by per-request compute
            # (target tokens + draft forwards); others split equally
            weight = getattr(self.sut, "request_energy_weight", None)
            # per-channel first: what each request burned on each rail
            # (sums to the channel's busy energy)
            per_request_domain = {}
            for node in sorted(summary.per_node_j):
                t_d, w_d = _power_samples(power_log, node=node,
                                          boundary_only=False)
                per_request_domain[node] = attribute_request_energy(
                    completed, t_d, w_d, weight=weight)
            # boundary split last: attribute_request_energy fills
            # Request.energy_j as a side effect, and the records must
            # keep the submission-total view, not the last rail's
            times_s, watts = _power_samples(power_log)
            per_request = attribute_request_energy(completed, times_s,
                                                   watts, weight=weight)
        return SubmissionResult(outcome, summary, report, submission,
                                perf_log, power_log, per_request,
                                meter_stack=stack,
                                per_request_domain_energy_j=per_request_domain,
                                channel_health=dict(stack.health)
                                if getattr(stack, "health", None) else None)


def _power_samples(power_log: MLPerfLogger, *,
                   node: Optional[str] = None,
                   boundary_only: bool = True
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(times_s, watts) from the power log, SUT clock.

    By default only *boundary* channels contribute (wall/pdu/pin —
    the submission total; summing breakdown rails on top would
    double-count).  ``node`` selects one named channel instead.
    """
    pairs = []
    for ev in power_log.events:
        if ev.key != "power_w":
            continue
        md = ev.metadata or {}
        if node is not None:
            if md.get("node", "sut") != node:
                continue
        elif boundary_only and not bool(md.get("boundary", True)):
            continue
        pairs.append((ev.time_ms / 1e3, float(ev.value)))
    pairs.sort()
    return (np.asarray([t for t, _ in pairs]),
            np.asarray([w for _, w in pairs]))
