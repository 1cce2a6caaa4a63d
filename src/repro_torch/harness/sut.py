"""The SUT (system under test) protocol and adapters (PyTorch port).

A copy of the reference ``src/repro/harness/sut.py`` restricted to the
protocol and the adapters that need no serving engine.  A ``SUT`` is
the one surface the harness measures: how to run queries (``issue`` /
``issue_batch`` / ``serve_queue``), what the system draws while doing
it (``meter_stack`` — the multi-channel power-domain surface), and
what it claims to be (``system_description``).

- ``CallableSUT`` — plain functions + a power figure; the universal
  adapter for analytic workloads and hand-timed calls.
- ``TinySUT`` — a pin-demarcated duty-cycled MCU workload (the µW end
  of the paper's range) measured on the ``pin`` channel.

The engine adapters (``ServeEngineSUT``, ``ContinuousBatchingSUT``,
``ShardedSUT``, ``ReplicatedSUT``, ``DisaggregatedSUT``) wait for
ROADMAP §A.4, §A.8 and §A.9: each is held against a port engine.

Power surface: every adapter implements ``domains(outcome) ->
list[PowerDomain]`` — its per-component measurement boundaries
(``accelerator`` / ``dram`` / ``host`` DC rails, a ``wall`` boundary
derived through the PSU loss model, ``pin`` for tiny) — and
``BaseSUT.meter_stack`` turns them into a scale-appropriate
``repro_torch.power.MeterStack`` that ``PowerRun`` drives through the
Director.  The legacy scalar ``power_source(outcome)`` surface still
works: a SUT that only provides it is wrapped into a single-channel
wall-only stack with a ``DeprecationWarning``.
"""
from __future__ import annotations

import time
import warnings
from typing import Any, Callable, Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.compliance import SystemDescription
from repro_torch.core.power_model import StepWork, SystemPowerModel, TinyPowerModel
from repro_torch.power import (ACCELERATOR, PIN, WALL, MeterStack,
                         PowerDomain, build_stack, wall_domain)

PowerSource = Callable[[np.ndarray], np.ndarray]


@runtime_checkable
class SUT(Protocol):
    """What a measurable system exposes to the harness.

    Scenarios call whichever issue surface they need; adapters may
    leave the others unimplemented (``NotImplementedError``) and the
    scenario will say so at run time.
    """

    name: str

    def issue(self, sample: dict) -> float:
        """Run one query; return its latency in seconds."""
        ...

    def issue_batch(self, samples: list[dict]) -> float:
        """Run one batch/burst; return seconds until all complete."""
        ...

    def serve_queue(self, arrivals: list[tuple[dict, float]]) -> list:
        """Serve ``(sample, arrival_s)`` via an admission queue; return
        completed records (the ``repro_torch.serving.Request`` contract)."""
        ...

    def meter_stack(self, outcome, *, seed: int = 0,
                    sample_hz: Optional[float] = None) -> MeterStack:
        """The multi-channel meter stack measuring this run
        (``outcome`` is the ScenarioOutcome, so the domain traces can
        be shaped by it)."""
        ...

    def system_description(self) -> SystemDescription:
        """Static facts compliance needs: scale class, power bounds."""
        ...


class BaseSUT:
    """Concrete base: batch falls back to sequential issue, queue is
    unsupported; the power surface is ``domains(outcome)`` (native
    multi-channel) with a deprecated scalar ``power_source`` fallback.
    """

    name = "sut"

    def __init__(self, name: Optional[str] = None,
                 sysdesc: Optional[SystemDescription] = None):
        if name is not None:
            self.name = name
        self._sysdesc = sysdesc or SystemDescription(
            scale="edge", max_system_watts=60, idle_system_watts=8)

    def issue(self, sample: dict) -> float:
        """Run one query; return its latency in seconds."""
        raise NotImplementedError(f"{self.name}: no single-query path")

    def issue_batch(self, samples: list[dict]) -> float:
        """Run one burst; sequential fallback (sum of single issues)."""
        return float(sum(self.issue(s) for s in samples))

    def serve_queue(self, arrivals: list[tuple[dict, float]]) -> list:
        """Serve ``(sample, arrival_s)`` via an admission queue; return
        completed records.  Unsupported on the base."""
        raise NotImplementedError(f"{self.name}: no admission queue")

    def supports_serve_queue(self) -> bool:
        """Scenario auto-mode probe: does this SUT have a real admission
        queue?  Overridden by adapters that implement ``serve_queue``."""
        return False

    def completed_requests(self) -> Optional[list]:
        """Requests finished by the last run, for per-request energy
        attribution; ``None`` when the SUT has no request records."""
        return None

    # --- power surface -------------------------------------------------
    def domains(self, outcome) -> Optional[list[PowerDomain]]:
        """Native multi-channel surface: the run's power domains.
        ``None`` means the adapter only has the legacy scalar source
        and ``meter_stack`` falls back to the compatibility shim."""
        return None

    def power_source(self, outcome) -> PowerSource:
        """Legacy scalar surface: ``source(t_s) -> watts``.  Kept for
        compatibility; prefer ``domains`` / ``meter_stack``."""
        raise NotImplementedError(f"{self.name}: no power source")

    def _psu(self):
        """PSU loss model documented with the stack (compliance R10);
        ``None`` when the SUT has no rail decomposition."""
        return None

    def meter_stack(self, outcome, *, seed: int = 0,
                    sample_hz: Optional[float] = None) -> MeterStack:
        """Build the run's multi-channel ``MeterStack`` from
        ``domains(outcome)``, falling back to a single-domain wall-only
        stack around the deprecated scalar ``power_source``."""
        doms = self.domains(outcome)
        psu = self._psu()
        if doms is None:
            warnings.warn(
                f"{self.name}: the scalar power_source surface is "
                f"deprecated — implement domains()/meter_stack(); "
                f"wrapping it into a single-domain wall-only "
                f"MeterStack", DeprecationWarning, stacklevel=2)
            doms = [wall_domain(self.power_source(outcome))]
            psu = None
        return build_stack(doms, self.system_description(), seed=seed,
                           sample_hz=sample_hz,
                           name=f"{self.name}-stack", psu=psu)

    def system_description(self) -> SystemDescription:
        """Static facts compliance needs: scale class, power bounds."""
        return self._sysdesc


def constant_power(watts: float) -> PowerSource:
    """A flat ``source(t_s) -> watts`` trace (the simplest domain)."""
    return lambda t: np.full_like(np.asarray(t, float), float(watts))


def throughput_work(cfg, qps: float) -> StepWork:
    """Per-second work while serving ``qps`` samples/s of a decoder
    model: 2 FLOPs/param/sample, weights re-read from HBM at 1/8 byte
    per FLOP (the roofline-fed recipe all adapters share)."""
    return StepWork(flops=2.0 * cfg.param_count() * qps,
                    hbm_bytes=2.0 * cfg.param_count() * qps / 8)


def throughput_watts(meter: SystemPowerModel, cfg, qps: float) -> float:
    """Analytic full-system (wall) draw at ``qps`` samples/s."""
    return meter.system_watts(throughput_work(cfg, qps))


def _shaped(idle_w: float, busy_w: float,
            util: Optional[Callable]) -> PowerSource:
    """Rail trace: idle floor + utilization share of the busy draw."""
    if util is None:
        return constant_power(busy_w)

    def source(t):
        t = np.asarray(t, float)
        return idle_w + (busy_w - idle_w) * util(t)

    return source


def rail_domains(meter: SystemPowerModel, work: StepWork, *,
                 util: Optional[Callable] = None,
                 n_accel_channels: int = 1,
                 psu=None) -> list[PowerDomain]:
    """The standard adapter stack: accelerator/dram/host DC rails
    (utilization-shaped when ``util(t)`` is given) under one measured
    ``wall`` boundary derived through the system's PSU loss model.

    ``n_accel_channels > 1`` splits the accelerator rail into one
    channel per shard (``accelerator/0`` ... — tensor-parallel systems
    meter each chip's rail separately and sum under one wall).
    ``psu`` overrides the system's flat-efficiency PSU (e.g. a
    load-dependent ``repro_torch.power.GOLD_CURVE`` loss model).
    """
    busy = meter.rail_watts(work)
    idle = meter.rail_watts(None)
    rails: list[PowerDomain] = []
    k = max(1, n_accel_channels)
    if k == 1:
        rails.append(PowerDomain(ACCELERATOR, _shaped(
            idle[ACCELERATOR], busy[ACCELERATOR], util)))
    else:
        # Megatron-split shards draw symmetrically: one channel each
        for i in range(k):
            rails.append(PowerDomain(
                f"{ACCELERATOR}/{i}",
                _shaped(idle[ACCELERATOR] / k, busy[ACCELERATOR] / k,
                        util),
                kind=ACCELERATOR))
    rails.append(PowerDomain("dram", _shaped(idle["dram"], busy["dram"],
                                             util)))
    rails.append(PowerDomain("host", _shaped(idle["host"], busy["host"],
                                             util)))
    psu = psu or meter.psu()
    wall = PowerDomain(WALL, psu.wall_source([r.source for r in rails]),
                       boundary=True)
    return rails + [wall]


class CallableSUT(BaseSUT):
    """Wrap plain functions + a power figure into a SUT.

    ``power`` is a constant in watts or a ``source(t) -> watts`` trace
    (measured as a single wall boundary); use
    ``power_factory(outcome) -> source`` when the trace depends on the
    run's outcome, or ``domains_factory(outcome) ->
    list[PowerDomain]`` for a native multi-channel stack (pass ``psu``
    to document the loss model for the compliance invariants).

    ``power_source=`` is the deprecated pre-domain keyword: accepted,
    wrapped into a single-domain wall-only stack, and warned about.
    """

    def __init__(self, *, name: str = "callable-sut",
                 issue: Optional[Callable[[dict], float]] = None,
                 issue_batch: Optional[Callable[[list], float]] = None,
                 serve_queue: Optional[Callable[[list], list]] = None,
                 power: Any = None,
                 power_factory: Optional[Callable[[Any], PowerSource]] = None,
                 domains_factory: Optional[Callable[[Any], list]] = None,
                 psu: Any = None,
                 power_source: Any = None,
                 sysdesc: Optional[SystemDescription] = None):
        super().__init__(name, sysdesc)
        self._issue = issue
        self._issue_batch = issue_batch
        self._serve_queue = serve_queue
        if power_source is not None:
            warnings.warn(
                f"{self.name}: CallableSUT(power_source=...) is "
                f"deprecated — pass power= / power_factory= / "
                f"domains_factory=; wrapping the scalar source into a "
                f"single-domain wall-only MeterStack",
                DeprecationWarning, stacklevel=2)
            power = power if power is not None else power_source
        self._power = power
        self._power_factory = power_factory
        self._domains_factory = domains_factory
        self._psu_model = psu

    def issue(self, sample: dict) -> float:
        if self._issue is None:
            return super().issue(sample)
        return self._issue(sample)

    def issue_batch(self, samples: list[dict]) -> float:
        if self._issue_batch is None:
            return super().issue_batch(samples)
        return self._issue_batch(samples)

    def serve_queue(self, arrivals: list[tuple[dict, float]]) -> list:
        if self._serve_queue is None:
            return super().serve_queue(arrivals)
        return self._serve_queue(arrivals)

    def supports_serve_queue(self) -> bool:
        return self._serve_queue is not None

    def domains(self, outcome) -> Optional[list[PowerDomain]]:
        if self._domains_factory is not None:
            return list(self._domains_factory(outcome))
        if self._power_factory is not None or self._power is not None:
            return [wall_domain(self.power_source(outcome))]
        return None

    def _psu(self):
        return self._psu_model

    def power_source(self, outcome) -> PowerSource:
        if self._power_factory is not None:
            return self._power_factory(outcome)
        p = self._power
        if p is None:
            return super().power_source(outcome)
        return p if callable(p) else constant_power(float(p))


class TinySUT(BaseSUT):
    """Duty-cycled MCU workload: an always-on detector running one
    inference per ``period_s`` frame (pin-demarcated capture, §IV-B).

    ``issue`` runs the real jitted forward but reports the *frame
    period* as the query latency — the SingleStream run then models
    wall time of the 4 Hz detector, and the ``pin`` power domain
    replays the MCU waveform (active burst of ``inference_time`` per
    frame, sleep floor in between) so the summarizer integrates true
    duty-cycled energy from the µW-class channel.
    """

    def __init__(self, fwd: Callable[[], None], *, macs: float,
                 sram_bytes: float, period_s: float = 0.25,
                 name: str = "tiny-mcu",
                 model: Optional[TinyPowerModel] = None,
                 sysdesc: Optional[SystemDescription] = None):
        sysdesc = sysdesc or SystemDescription(
            scale="tiny", instrument="io-manager",
            max_system_watts=0.01, idle_system_watts=5e-5)
        super().__init__(name, sysdesc)
        self.fwd = fwd
        self.macs = macs
        self.sram_bytes = sram_bytes
        self.period_s = period_s
        self.model = model or TinyPowerModel()
        self.real_latencies_s: list[float] = []

    def issue(self, sample: dict) -> float:
        t0 = time.perf_counter()
        self.fwd()
        self.real_latencies_s.append(time.perf_counter() - t0)
        return self.period_s

    def domains(self, outcome) -> list[PowerDomain]:
        return [PowerDomain(PIN, self.power_source(outcome),
                            boundary=True)]

    def power_source(self, outcome) -> PowerSource:
        d = self.model.device
        t_inf = self.model.inference_time(self.macs)
        p_active = (self.model.inference_energy(self.macs, self.sram_bytes)
                    / max(t_inf, 1e-9))

        def source(t):
            t = np.asarray(t, float)
            active = (t % self.period_s) < t_inf
            return np.where(active, p_active, d.sleep_watts)

        return source
