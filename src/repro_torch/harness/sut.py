"""The SUT (system under test) protocol and adapters (PyTorch port).

A copy of the reference ``src/repro/harness/sut.py`` restricted to the
protocol and the adapters the port has.  A ``SUT`` is the one surface
the harness measures: how to run queries (``issue`` / ``issue_batch``
/ ``serve_queue``), what the system draws while doing it
(``meter_stack`` — the multi-channel power-domain surface), and what
it claims to be (``system_description``).

- ``CallableSUT`` — plain functions + a power figure; the universal
  adapter for analytic workloads and hand-timed calls.
- ``ServeEngineSUT`` — the fixed-batch ``ServeEngine`` (blocking
  batches; SingleStream / MultiStream / Offline / sync Server).
- ``ContinuousBatchingSUT`` — the slot-based
  ``ContinuousBatchingEngine`` behind ``serve_queue`` (queue-driven
  Server with per-request TTFT/TPOT and energy attribution).
- ``TinySUT`` — a pin-demarcated duty-cycled MCU workload (the µW end
  of the paper's range) measured on the ``pin`` channel.
- ``ReplicatedSUT`` — N independent engine replicas behind one
  admission queue: arrivals dispatched round-robin, each replica
  contributes its own meter stack (rails + wall) and the fleet
  boundary is a PDU domain aggregating the replica walls.  Replicas
  with a measured ``energy_meter`` are refused (one card's counter
  cannot be split between replicas).
- ``DisaggregatedSUT`` — a ``DisaggregatedEngine``'s prefill and
  decode fleets behind one queue, each with its own rail stack
  (``prefill/...``, ``decode/...``) under a derived ``pdu``.  A
  measured ``energy_meter`` is refused, for the same reason.
- ``ShardedSUT`` — a tensor-parallel ``ShardedContinuousBatchingEngine``
  (rank 0's) behind the same queue surface: ``tp`` chips on the meter,
  one accelerator channel per shard.  A measured ``energy_meter`` is
  taken at tp 1 only: one NVML counter is one card.

Power surface: every adapter implements ``domains(outcome) ->
list[PowerDomain]`` — its per-component measurement boundaries
(``accelerator`` / ``dram`` / ``host`` DC rails, a ``wall`` boundary
derived through the PSU loss model, ``pin`` for tiny) — and
``BaseSUT.meter_stack`` turns them into a scale-appropriate
``repro_torch.power.MeterStack`` that ``PowerRun`` drives through the
Director.  The legacy scalar ``power_source(outcome)`` surface still
works: a SUT that only provides it is wrapped into a single-channel
wall-only stack with a ``DeprecationWarning``.

Measured energy (the port's addition): the two engine SUTs take an
``energy_meter``, a factory of ``repro_torch.power.nvml.EnergySampler``
over the card's energy counter.  Without one (the default) their
domains are the reference's modeled rails, value for value.  With one,
each ``serve_queue`` / ``issue_batch`` runs inside a sampler and the
domains are the *measured* ``accelerator`` rail (board power, HBM
included, so no ``dram`` rail), the modeled ``host`` rail and the
PSU-derived ``wall`` (``measured_domains``), declared as a datacenter
system read through node telemetry (``measured_sysdesc``).
"""
from __future__ import annotations

import time
import warnings
from typing import Any, Callable, Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.compliance import SystemDescription
from repro_torch.core.power_model import StepWork, SystemPowerModel, TinyPowerModel
from repro_torch.hw import DATACENTER_H100, EDGE_SYSTEM, SystemSpec
from repro_torch.power import (ACCELERATOR, HOST, PDU, PIN, WALL,
                               MeterStack, PowerDomain, build_stack,
                               wall_domain)

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


# NVML documents its power reading as accurate to within +/-5 % of the
# draw (nvmlDeviceGetPowerUsage); the energy counter integrates the same
# sensor.  The figure a datacenter submission documents for R4.
NVML_ACCURACY = 0.05

# Stack sampling rate of a measured run: the counter-derived trace is
# piecewise constant between the counter's updates, and 100 Hz resolves
# a serve's first and last tenth of a second, which 10 Hz telemetry
# would integrate away on a sub-minute run.
MEASURED_SAMPLE_HZ = 100.0


def measured_domains(meter: SystemPowerModel, work: StepWork,
                     accelerator: PowerSource, *,
                     util: Optional[Callable] = None) -> list[PowerDomain]:
    """The measured stack: the card's ``accelerator`` rail as measured
    (board power, which includes its HBM, so no modeled ``dram`` rail is
    added), the system's modeled ``host`` rail (utilization-shaped when
    ``util(t)`` is given, as in ``rail_domains``) and the ``wall``
    boundary derived from both through the system's PSU."""
    host = _shaped(meter.rail_watts(None)[HOST], meter.rail_watts(work)[HOST],
                   util)
    rails = [PowerDomain(ACCELERATOR, accelerator), PowerDomain(HOST, host)]
    wall = PowerDomain(WALL, meter.psu().wall_source([accelerator, host]),
                       boundary=True)
    return rails + [wall]


def measured_sysdesc(meter: SystemPowerModel) -> SystemDescription:
    """What a measured run declares: a datacenter system (telemetry
    channels, no range-mode rule) read through NVML, not a
    SPEC-approved analyzer, with NVML's documented accuracy, the
    modeled host rail disclosed as an estimate, and the system's peak
    and idle envelope."""
    return SystemDescription(
        scale="datacenter", n_chips=meter.n_chips,
        instrument="nvml-energy-counter", instrument_spec_approved=False,
        telemetry_accuracy=NVML_ACCURACY,
        estimated_components={HOST: "modeled: the SystemSpec's host "
                              "idle/active watts"},
        max_system_watts=_system_peak_watts(meter),
        idle_system_watts=meter.system_watts(None))


def spliced_source(segments: list[tuple[float, PowerSource]]) -> PowerSource:
    """One trace from ``(start_s, source)`` segments sorted by start:
    ``t`` reads the last segment starting at or before it (the first
    before them all) at ``t - start_s``."""
    starts = np.asarray([start for start, _ in segments], float)

    def source(t):
        t = np.asarray(t, float)
        idx = np.clip(np.searchsorted(starts, t, side="right") - 1, 0,
                      len(segments) - 1)
        out = np.empty_like(t)
        for k, (start, src) in enumerate(segments):
            sel = idx == k
            if sel.any():
                out[sel] = src(t[sel] - start)
        return out

    return source


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


class MeasuredTrace:
    """The card's measured draw over one run, as segments on the run's
    clock.

    ``energy_meter()`` makes a fresh ``EnergySampler``.  ``run(start_s,
    fn)`` calls ``fn(now)`` inside one: ``now`` reads the sampler's
    clock, its first reading is the segment's t = 0, and the segment
    sits at ``start_s`` on the run's clock.  ``source()`` splices the
    segments into the run's accelerator trace; the first ``run`` after
    it starts the next run's segments."""

    def __init__(self, energy_meter: Callable):
        self.energy_meter = energy_meter
        # (start_s on the run's clock, sampler, sampler clock at t = 0)
        self.segments: list = []
        self._read = False

    @property
    def fresh(self) -> bool:
        """Whether the next ``run`` starts a new run's segments."""
        return self._read or not self.segments

    def reset(self) -> None:
        self.segments, self._read = [], False

    def run(self, start_s: float, fn: Callable[[Callable], Any]):
        if self._read:
            self.reset()
        sampler = self.energy_meter()
        first: list[float] = []

        def now():
            t = sampler.clock()
            if not first:
                first.append(t)
            return t

        with sampler:
            out = fn(now)
        if not first:
            raise RuntimeError("MeasuredTrace.run: fn never read now(), "
                               "so its t = 0 is unknown")
        self.segments.append((start_s, sampler, first[0]))
        return out

    def gaps_s(self, window_s: float) -> tuple[float, float]:
        """For a run of one segment whose window is ``window_s`` seconds
        from its t = 0: how long before t = 0 the sampler's first read
        began and how long after the window's end its last read ended
        (``EnergySampler.bracket``), the most the counter's delta can
        hold outside the window.  Both lie within one sampling period
        when the delta is the window's energy, so the trace's t = 0 is
        the run's to within a reading; a slow first or last read, or an
        engine whose t = 0 comes after its first ``now()``, shows as a
        longer gap."""
        if len(self.segments) != 1:
            raise ValueError(f"MeasuredTrace.gaps_s: {len(self.segments)} "
                             f"segments, not one run's")
        _, sampler, t0 = self.segments[0]
        first, last = sampler.bracket()
        return t0 - first, last - (t0 + window_s)

    def energy_j(self) -> float:
        """The counter's delta summed over this run's segments."""
        return sum(s.energy_j() for _, s, _ in self.segments)

    def source(self) -> PowerSource:
        if not self.segments:
            raise RuntimeError("MeasuredTrace.source: nothing was "
                               "measured (no run inside a sampler)")
        self._read = True
        return spliced_source([(start, s.source(t0))
                               for start, s, t0 in self.segments])


class _MeteredSUT(BaseSUT):
    """The engine SUTs' shared measured surface: with an
    ``energy_meter`` (a factory of ``EnergySampler``) the SUT keeps a
    ``MeasuredTrace`` of its serves, declares ``measured_sysdesc`` and
    samples its stack at ``MEASURED_SAMPLE_HZ`` unless told otherwise."""

    def __init__(self, name, sysdesc, meter: SystemPowerModel,
                 energy_meter: Optional[Callable] = None):
        if energy_meter is not None and sysdesc is None:
            sysdesc = measured_sysdesc(meter)
        super().__init__(name, sysdesc)
        self.meter = meter
        self.trace = (MeasuredTrace(energy_meter)
                      if energy_meter is not None else None)

    def meter_stack(self, outcome, *, seed: int = 0,
                    sample_hz: Optional[float] = None) -> MeterStack:
        if self.trace is not None and sample_hz is None:
            sample_hz = MEASURED_SAMPLE_HZ
        return super().meter_stack(outcome, seed=seed, sample_hz=sample_hz)


class ServeEngineSUT(_MeteredSUT):
    """Fixed-batch ``ServeEngine`` behind the SUT surface.

    ``make_requests(samples) -> list[Request]`` builds the engine's
    batch from loadgen samples; latency is real wall time of
    ``run_batch``.  The meter stack is the analytic system draw at the
    measured throughput, decomposed into accelerator/dram/host rails
    under one PSU-derived wall (same roofline-fed recipe as before,
    now per domain).

    With ``energy_meter`` each batch is a measured segment, laid end to
    end from t = 0 as the loadgen's clock advances by each batch's
    latency (Offline, SingleStream, MultiStream).  The synchronous
    Server is refused: its clock also counts modeled queueing waits
    the card never ran, so no batch's measured draw has a place on it.
    ``system`` defaults to the edge SoC, and with a meter to the H100
    datacenter system.
    """

    def __init__(self, engine, cfg, *, name: str = "serve-engine",
                 make_requests: Callable[[list[dict]], list],
                 system: Optional[SystemSpec] = None, n_chips: int = 1,
                 sysdesc: Optional[SystemDescription] = None,
                 energy_meter: Optional[Callable] = None):
        system = system or (DATACENTER_H100 if energy_meter else EDGE_SYSTEM)
        super().__init__(name, sysdesc, SystemPowerModel(system, n_chips),
                         energy_meter)
        self.engine = engine
        self.cfg = cfg
        self.make_requests = make_requests
        self._busy_s = 0.0

    def issue(self, sample: dict) -> float:
        return self.issue_batch([sample])

    def issue_batch(self, samples: list[dict]) -> float:
        reqs = self.make_requests(samples)
        if self.trace is None:
            t0 = time.perf_counter()
            self.engine.run_batch(reqs)
            return time.perf_counter() - t0
        if self.trace.fresh:
            self._busy_s = 0.0          # a new run's first batch

        def run(now):
            t0 = now()
            self.engine.run_batch(reqs)
            return now() - t0

        dt = self.trace.run(self._busy_s, run)
        self._busy_s += dt
        return dt

    def domains(self, outcome) -> list[PowerDomain]:
        work = throughput_work(self.cfg, outcome.result.qps)
        if self.trace is None:
            return rail_domains(self.meter, work)
        if outcome.scenario == "Server":
            raise ValueError(
                f"{self.name}: a measured energy_meter cannot run the "
                f"synchronous Server, whose clock counts modeled queueing "
                f"waits the card never ran; serve through "
                f"ContinuousBatchingSUT, or drop the meter")
        return measured_domains(self.meter, work, self.trace.source())

    def _psu(self):
        return self.meter.psu()

    def power_source(self, outcome) -> PowerSource:
        return constant_power(
            throughput_watts(self.meter, self.cfg, outcome.result.qps))


class ContinuousBatchingSUT(_MeteredSUT):
    """Slot-based ``ContinuousBatchingEngine`` behind ``serve_queue``.

    ``make_request(i, sample, arrival_s) -> Request`` builds each
    admission-queue entry.  Every domain trace is shaped by engine
    occupancy (idle floor + per-slot share of the busy draw over the
    completed requests' spans), so per-request energy attribution sees
    a realistic trace on every rail.

    ``draft``: the draft model's config when the engine decodes
    speculatively.  It switches per-request energy attribution to
    compute-weighted splitting: a request's share of each interval is
    proportional to the work it triggered — target token-forwards
    (``verify_tokens``: a low-acceptance request burns more verify
    forwards per emitted token) plus its draft-model forwards scaled
    by the draft/target parameter ratio — so both models' work is
    billed to the request that caused it and the per-request energies
    still sum to the fleet total.

    Prefix caching (an engine with ``prefix_caching`` on): a
    prefix-cache hit skipped the shared pages' prefill, so its energy
    weight counts only the *unique-suffix* prefill it actually
    computed (``prefill_tokens``) plus its decoded tokens — cached
    prompt tokens are free, and the J they would have cost stays
    billed to the requests that did the work.  (In speculative mode
    ``verify_tokens`` already counts only computed prompt tokens, so
    the draft weighting above composes with prefix hits unchanged.)

    With ``energy_meter`` the serve runs inside one sampler whose t = 0
    is the engine's own (the first reading of the ``now`` it stamps
    requests with, which ``run_server_queue`` times the run on): the
    accelerator rail is the card's measured draw, the host rail keeps
    the occupancy shape.  ``system`` defaults to the edge SoC, and with
    a meter to the H100 datacenter system.
    """

    def __init__(self, engine, cfg, *, name: str = "continuous-engine",
                 make_request: Callable[[int, dict, float], Any],
                 system: Optional[SystemSpec] = None, n_chips: int = 1,
                 draft: Any = None,
                 sysdesc: Optional[SystemDescription] = None,
                 energy_meter: Optional[Callable] = None):
        system = system or (DATACENTER_H100 if energy_meter else EDGE_SYSTEM)
        super().__init__(name, sysdesc, SystemPowerModel(system, n_chips),
                         energy_meter)
        self.engine = engine
        self.cfg = cfg
        self.make_request = make_request
        self.completed: list = []
        self.draft_cfg = draft
        if draft is not None:
            ratio = draft.param_count() / max(1, cfg.param_count())

            def request_energy_weight(r, _ratio=ratio):
                target = (getattr(r, "verify_tokens", 0)
                          or len(r.output or []))
                return target + _ratio * getattr(r, "draft_tokens", 0)

            # picked up by PowerRun via getattr; absent -> equal split
            self.request_energy_weight = request_energy_weight
        elif getattr(engine, "prefix_caching", False):
            def request_energy_weight(r):
                return (getattr(r, "prefill_tokens", 0)
                        + len(r.output or []))

            self.request_energy_weight = request_energy_weight

    def serve_queue(self, arrivals: list[tuple[dict, float]]) -> list:
        reqs = [self.make_request(i, s, a)
                for i, (s, a) in enumerate(arrivals)]
        if self.trace is None:
            self.completed = self.engine.serve(reqs)
        else:
            self.trace.reset()
            self.completed = self.trace.run(
                0.0, lambda now: self.engine.serve(reqs, now=now))
        return self.completed

    def supports_serve_queue(self) -> bool:
        return True

    def completed_requests(self) -> Optional[list]:
        return self.completed or None

    def _utilization(self) -> Callable:
        """Slot occupancy over the completed requests' spans."""
        spans = [(r.arrival_s, r.done_s) for r in self.completed
                 if r.done_s is not None]
        n_slots = self.engine.n_slots

        def util(t):
            t = np.asarray(t, float)
            inflight = np.zeros_like(t)
            for a, d in spans:
                inflight += (t >= a) & (t < d)
            return np.minimum(inflight / max(1, n_slots), 1.0)

        return util

    def _n_accel_channels(self) -> int:
        return 1

    def domains(self, outcome) -> list[PowerDomain]:
        work = throughput_work(self.cfg, outcome.result.qps)
        if self.trace is not None:
            return measured_domains(self.meter, work, self.trace.source(),
                                    util=self._utilization())
        return rail_domains(
            self.meter, work, util=self._utilization(),
            n_accel_channels=self._n_accel_channels())

    def _psu(self):
        return self.meter.psu()

    def power_source(self, outcome) -> PowerSource:
        busy = throughput_watts(self.meter, self.cfg, outcome.result.qps)
        idle = self.meter.system_watts(None)
        return _shaped(idle, busy, self._utilization())


def _system_peak_watts(meter: SystemPowerModel) -> float:
    """Declared full-system envelope: every chip at peak + active hosts
    + switches, through the PSU (the ``max_system_watts`` a submission
    at this scale would state)."""
    s = meter.system
    w = (meter.n_chips * s.chip.peak_watts
         + s.n_hosts(meter.n_chips) * s.host_active_watts
         + s.n_switches(meter.n_chips) * s.switch_watts)
    return w / s.psu_efficiency


def modeled_sysdesc(meter: SystemPowerModel,
                    scale: Optional[str] = None) -> SystemDescription:
    """What a system on modeled rails declares (the reference
    ``ShardedSUT``'s recipe): ``datacenter`` scale for more than one
    chip unless ``scale`` says otherwise, read through node telemetry
    of documented accuracy (R4) there and a virtual analyzer at the
    edge, with the meter's peak and idle envelope."""
    scale = scale or ("datacenter" if meter.n_chips > 1 else "edge")
    # datacenter submissions document node telemetry accuracy (R4)
    # instead of a SPEC-approved analyzer
    telemetry = 0.01 if scale == "datacenter" else None
    return SystemDescription(
        scale=scale, n_chips=meter.n_chips,
        instrument=("node-telemetry" if scale == "datacenter"
                    else "virtual-wt310"),
        telemetry_accuracy=telemetry,
        max_system_watts=_system_peak_watts(meter),
        idle_system_watts=meter.system_watts(None))


class ShardedSUT(ContinuousBatchingSUT):
    """Tensor-parallel ``ShardedContinuousBatchingEngine`` behind the
    SUT surface.

    Identical queue semantics to ``ContinuousBatchingSUT``; the power
    meter spans the shards (``n_chips = engine.tp``) with one
    accelerator channel *per shard* summed under one wall, and the
    default system description declares the matching scale and
    envelope, so the stack gets the scale-appropriate instruments and
    the compliance review checks the fleet-level power budget.  The
    engine is rank 0's: its ``serve`` drives the other ranks, which
    ``follow``.

    The port's one difference: a measured ``energy_meter`` is taken at
    tp 1 only, and then the SUT is measured as ``ContinuousBatchingSUT``
    is (on the H100 system unless told otherwise).  At tp > 1 it raises
    ``ValueError``, naming the SUT: one NVML counter is one card, and
    the other shards' cards would go unbilled.
    """

    def __init__(self, engine, cfg, *, name: str = "sharded-engine",
                 make_request: Callable[[int, dict, float], Any],
                 system: Optional[SystemSpec] = None,
                 scale: Optional[str] = None,
                 draft: Any = None,
                 sysdesc: Optional[SystemDescription] = None,
                 energy_meter: Optional[Callable] = None):
        tp = engine.tp
        if energy_meter is not None and tp > 1:
            raise ValueError(
                f"ShardedSUT {name!r}: a measured energy_meter is taken at "
                f"tp 1 only; at tp={tp} one card's NVML counter would stand "
                f"for {tp} cards: the shards run on modeled rails")
        if energy_meter is None:
            system = system or EDGE_SYSTEM
            if sysdesc is None:
                sysdesc = modeled_sysdesc(SystemPowerModel(system, tp),
                                          scale)
        super().__init__(engine, cfg, name=name, make_request=make_request,
                         system=system, n_chips=tp, draft=draft,
                         sysdesc=sysdesc, energy_meter=energy_meter)

    def _n_accel_channels(self) -> int:
        return self.engine.tp


class ReplicatedSUT(BaseSUT):
    """N independent engine replicas behind one admission queue.

    ``replicas`` are queue-capable SUTs (``ContinuousBatchingSUT``,
    ``CallableSUT(serve_queue=...)``); one admission queue dispatches
    arrivals round-robin, each replica serves its share on the shared
    t=0 clock, and the completed records merge into one fleet result.
    Each replica contributes its whole meter stack under a ``r{i}/``
    prefix (rails + wall, all non-boundary), and the fleet boundary is
    a derived ``pdu`` domain summing the replica wall feeds — exactly
    the paper's PDU-aggregation fallback.  ``replica_energy_j`` splits
    the fleet energy back per replica, and the attribution test checks
    the parts sum to the whole.

    Fault handling (``fault_plan`` — a ``repro_torch.faults.FaultPlan``):

    - ``ReplicaCrash(i, at_s)``: replica *i* dies at ``at_s`` on the
      shared serve clock.  Queries it completed before the crash
      stand; everything else from its share is re-dispatched
      round-robin onto the survivors after ``retry``'s backoff (one
      re-dispatch wave; no duplicate or lost qids either way — the
      queue runner's conservation check holds).  The dead replica's
      power channels clamp to zero from ``at_s``, so fleet energy
      bills it exactly through the crash.
    - ``ReplicaHang(i, at_s, duration_s)``: replica *i* stalls; its
      in-flight completions shift by the stall (late enough ones may
      blow the per-request deadline — counted, not hidden).

    Without ``retry``, a crash that loses queries raises instead of
    silently shrinking the result set.

    The port's one difference: replicas that carry a measured
    ``energy_meter`` are refused (``ValueError``, naming the replica).
    On one card every replica's NVML trace is the whole card's draw, so
    the fleet's PDU would bill it once per replica; replicas sharing a
    card run with modeled rails.
    """

    def __init__(self, replicas: list, *, name: str = "replicated",
                 sysdesc: Optional[SystemDescription] = None,
                 fault_plan=None, retry=None):
        if not replicas:
            raise ValueError("ReplicatedSUT needs at least one replica")
        for i, rep in enumerate(replicas):
            if getattr(rep, "trace", None) is not None:
                raise ValueError(
                    f"ReplicatedSUT: replica {i} ({rep.name}) carries a "
                    f"measured energy_meter; every replica on one card "
                    f"would read the whole card's counter, so the fleet "
                    f"would bill it once per replica: give the replicas "
                    f"modeled rails")
        base = replicas[0].system_description()
        r = len(replicas)
        if sysdesc is None:
            sysdesc = SystemDescription(
                scale=base.scale, n_chips=base.n_chips * r,
                instrument=base.instrument,
                telemetry_accuracy=base.telemetry_accuracy,
                max_system_watts=(base.max_system_watts or 0.0) * r or None,
                idle_system_watts=base.idle_system_watts * r)
        super().__init__(name, sysdesc)
        self.replicas = replicas
        self.fault_plan = fault_plan
        self.retry = retry
        self.completed: list = []
        # speculative fleets: delegate draft-aware energy weighting to
        # the replicas' (identical) weight functions so per-request
        # attribution keeps billing draft forwards in fleet mode
        weight = getattr(replicas[0], "request_energy_weight", None)
        if weight is not None:
            self.request_energy_weight = weight

    @property
    def n_replicas(self) -> int:
        """Fleet size (replicas behind the one admission queue)."""
        return len(self.replicas)

    def _crash_time(self, i: int) -> Optional[float]:
        if self.fault_plan is None:
            return None
        c = self.fault_plan.crash_of(i)
        return float(c.at_s) if c is not None else None

    def serve_queue(self, arrivals: list[tuple[dict, float]]) -> list:
        from concurrent.futures import ThreadPoolExecutor

        from repro_torch.core.loadgen import qid_of

        plan = self.fault_plan
        shares = [list(arrivals[i::self.n_replicas])
                  for i in range(self.n_replicas)]
        # replicas are independent engines on independent t=0 clocks;
        # serve them concurrently so fleet wall time is one schedule,
        # not R of them (each replica sleeps through its own arrivals).
        # Every replica serves even an empty share so its completed
        # list reflects *this* run (no stale spans in the fleet power
        # trace when the SUT is reused or under-fed).
        with ThreadPoolExecutor(self.n_replicas) as pool:
            futures = [pool.submit(rep.serve_queue, share)
                       for rep, share in zip(self.replicas, shares)]
            waves = [list(f.result()) for f in futures]

        # absorb the plan's replica faults: shift hung completions,
        # drop a crashed replica's post-crash completions and collect
        # the lost share for re-dispatch
        lost: list[tuple[dict, float]] = []
        crash_at = 0.0
        for i, recs in enumerate(waves):
            hang = plan.hang_of(i) if plan is not None else None
            if hang is not None:
                for r in recs:
                    if r.done_s is not None and r.done_s >= hang.at_s:
                        r.done_s += hang.duration_s
                        if (r.first_token_s is not None
                                and r.first_token_s >= hang.at_s):
                            r.first_token_s += hang.duration_s
            tc = self._crash_time(i)
            if tc is not None:
                kept = [r for r in recs
                        if r.done_s is not None and r.done_s < tc]
                done = {r.rid for r in kept}
                for j, (s, a) in enumerate(shares[i]):
                    if qid_of(s, j) not in done:
                        lost.append((s, float(a)))
                crash_at = max(crash_at, tc)
                waves[i] = kept

        if lost:
            survivors = [i for i in range(self.n_replicas)
                         if self._crash_time(i) is None]
            if not survivors:
                raise RuntimeError(
                    f"{self.name}: every replica crashed — "
                    f"{len(lost)} queries unservable")
            if self.retry is None:
                raise RuntimeError(
                    f"{self.name}: replica crash lost {len(lost)} "
                    f"queries; pass retry=RetryPolicy() to re-dispatch "
                    f"them onto the surviving replicas")
            # one re-dispatch wave: the lost share re-arrives on the
            # survivors after the crash is detected + backoff
            delay = self.retry.delay_s(0)
            redo = sorted(lost, key=lambda sa: (sa[1],
                                                qid_of(sa[0], 0)))
            redo = [(s, max(a, crash_at) + delay) for s, a in redo]
            shares2 = {i: redo[k::len(survivors)]
                       for k, i in enumerate(survivors)}
            with ThreadPoolExecutor(len(survivors)) as pool:
                futures = {i: pool.submit(self.replicas[i].serve_queue,
                                          share)
                           for i, share in shares2.items()}
                for i, f in futures.items():
                    waves[i] = waves[i] + list(f.result())

        # per-replica completed reflects every wave this replica served
        # (utilization spans + energy billing see retried queries too)
        for rep, recs in zip(self.replicas, waves):
            rep.completed = recs
        self.completed = [r for recs in waves for r in recs]
        rids = [r.rid for r in self.completed]
        if len(set(rids)) != len(rids):
            raise ValueError(
                f"{self.name}: duplicate request ids across replicas — "
                "request builders must derive rids from the loadgen "
                "query id (repro.core.loadgen.qid_of), not the "
                "per-replica enumerate index")
        return self.completed

    def supports_serve_queue(self) -> bool:
        return True

    def completed_requests(self) -> Optional[list]:
        return self.completed or None

    def _replica_outcome(self, rep, outcome):
        """The fleet outcome as one replica sees it: the real outcome
        with qps scaled to its share of completed queries, every other
        field intact (replica power surfaces may read any of them)."""
        import dataclasses

        frac = (len(rep.completed) / max(1, len(self.completed))
                if getattr(rep, "completed", None) else 0.0)
        result = dataclasses.replace(outcome.result,
                                     qps=outcome.result.qps * frac)
        return dataclasses.replace(outcome, result=result)

    def _crash_clamped(self, i: int, src):
        """A replica's trace, zeroed from its crash time: the dead
        replica draws nothing after ``at_s``, so fleet energy bills it
        exactly through the crash (and the PDU register — sum of
        *measured* feeds — agrees by construction)."""
        tc = self._crash_time(i)
        if tc is None or src is None:
            return src

        def clamped(t, _src=src, _tc=tc):
            t = np.asarray(t, float)
            return np.where(t < _tc, np.asarray(_src(t), float), 0.0)

        return clamped

    def domains(self, outcome) -> list[PowerDomain]:
        doms: list[PowerDomain] = []
        wall_names: list[str] = []
        for i, rep in enumerate(self.replicas):
            rout = self._replica_outcome(rep, outcome)
            rdoms = rep.domains(rout) if hasattr(rep, "domains") else None
            if rdoms is None:
                rdoms = [wall_domain(rep.power_source(rout))]
            g = f"r{i}"
            for d in rdoms:
                doms.append(PowerDomain(
                    name=f"{g}/{d.name}",
                    source=self._crash_clamped(i, d.source), kind=d.kind,
                    group=g, boundary=False,
                    derived_from=tuple(f"{g}/{n}"
                                       for n in d.derived_from),
                    combine=d.combine))
                if d.kind == WALL:
                    wall_names.append(f"{g}/{d.name}")
        # the fleet boundary: a PDU register aggregating the replica
        # wall feeds (sum of *measured* samples — §IV-C fallback)
        doms.append(PowerDomain(PDU, derived_from=tuple(wall_names),
                                boundary=True))
        return doms

    def _psu(self):
        # R10 applies the documented PSU to every replica group, so it
        # is only honest when the replicas share one loss model; a
        # heterogeneous fleet documents none (R10 skipped, R9/R11
        # still checked)
        psus = [getattr(rep, "_psu", lambda: None)()
                for rep in self.replicas]
        if psus[0] is not None and all(p == psus[0] for p in psus):
            return psus[0]
        return None

    def _replica_source(self, rep, rout) -> PowerSource:
        """One replica's boundary trace: the sum of its wall feeds when
        it is domain-native (the exact series its share of the PDU
        register meters), else its legacy scalar source."""
        doms = rep.domains(rout) if hasattr(rep, "domains") else None
        if doms is not None:
            walls = [d.source for d in doms
                     if d.kind == WALL and d.source is not None]
            if walls:
                def src(t, _walls=tuple(walls)):
                    t = np.asarray(t, float)
                    total = np.zeros_like(t)
                    for w in _walls:
                        total = total + np.asarray(w(t), float)
                    return total

                return src
        return rep.power_source(rout)

    def replica_sources(self, outcome) -> list[PowerSource]:
        """Per-replica wall traces, crash-clamped to zero draw after a
        fault plan kills the member (energy billed through crash time)."""
        return [self._crash_clamped(
                    i, self._replica_source(
                        rep, self._replica_outcome(rep, outcome)))
                for i, rep in enumerate(self.replicas)]

    def power_source(self, outcome) -> PowerSource:
        sources = self.replica_sources(outcome)

        def fleet(t):
            t = np.asarray(t, float)
            total = np.zeros_like(t)
            for src in sources:
                total = total + np.asarray(src(t), float)
            return total

        return fleet

    def replica_energy_j(self, outcome, times_s: np.ndarray
                         ) -> list[float]:
        """Trapezoidal per-replica energy over the measured sample
        times; sums to the fleet trace's integral by linearity."""
        times_s = np.asarray(times_s, float)
        from repro_torch.core.summarizer import _trapz

        out = []
        for src in self.replica_sources(outcome):
            w = np.asarray(src(times_s), float)
            out.append(float(_trapz(w, times_s)))
        return out


class DisaggregatedSUT(BaseSUT):
    """Prefill and decode fleets behind one queue, metered separately.

    Wraps a ``repro_torch.serving.DisaggregatedEngine``: the prefill
    workers and the decode engine each get their own full rail stack
    (``prefill/accelerator`` ... ``prefill/wall``, ``decode/...``) with
    the fleet boundary a derived ``pdu`` channel summing the two wall
    feeds, so the prefill-vs-decode energy split is read per boundary
    channel (``per_domain_energy_j["prefill/wall"]`` vs
    ``["decode/wall"]``).

    Args:
        engine: the ``DisaggregatedEngine`` (prefill workers + paged
            decode engine).
        cfg: the target model config (FLOP/token shaping for both
            fleets' analytic draw).
        make_request: ``(i, sample, arrival_s) -> Request`` queue-entry
            builder, as in ``ContinuousBatchingSUT``.
        system: the per-fleet ``SystemSpec`` (chips split as
            ``len(workers)`` prefill + one decode).
        energy_meter: must be ``None``.  The port's one difference: a
            measured meter is refused (``ValueError``), because on one
            card the prefill and decode fleets read the same NVML
            counter while they overlap, so a measured split would bill
            the card twice.  Both fleets' rails are modeled.

    Each fleet's rails are shaped by its *own* phase utilization:
    prefill by the (``prefill_start_s``, ``first_token_s``) spans over
    the worker count, decode by the (``first_token_s``, ``done_s``)
    spans over the slot count, and driven by its own token rate
    (prompt tokens/s vs output tokens/s), since prefill does 2
    FLOPs/param *per prompt token* while decode does the same per
    generated token at decode-shaped batch sizes.
    """

    def __init__(self, engine, cfg, *, name: str = "disaggregated",
                 make_request: Callable[[int, dict, float], Any],
                 system: SystemSpec = EDGE_SYSTEM,
                 sysdesc: Optional[SystemDescription] = None,
                 energy_meter: Optional[Callable] = None):
        if energy_meter is not None:
            raise ValueError(
                f"DisaggregatedSUT {name!r}: a measured energy_meter is "
                f"refused; the prefill and decode fleets share one card, "
                f"whose counter both would read while they overlap, so "
                f"the split would bill the card twice: the fleets run on "
                f"modeled rails")
        self.n_prefill = len(engine.workers)
        self.n_decode = getattr(engine.engine, "tp", 1)
        pre_meter = SystemPowerModel(system, self.n_prefill)
        dec_meter = SystemPowerModel(system, self.n_decode)
        if sysdesc is None:
            sysdesc = SystemDescription(
                scale="datacenter",
                n_chips=self.n_prefill + self.n_decode,
                instrument="node-telemetry", telemetry_accuracy=0.01,
                max_system_watts=(_system_peak_watts(pre_meter)
                                  + _system_peak_watts(dec_meter)),
                idle_system_watts=(pre_meter.system_watts(None)
                                   + dec_meter.system_watts(None)))
        super().__init__(name, sysdesc)
        self.engine = engine
        self.cfg = cfg
        self.make_request = make_request
        self.prefill_meter = pre_meter
        self.decode_meter = dec_meter
        self.completed: list = []

        def request_energy_weight(r):
            # prompt tokens the prefill fleet computed + tokens the
            # decode fleet generated: both phases billed to the
            # request that caused the work
            return (getattr(r, "prefill_tokens", 0)
                    + len(r.output or []))

        self.request_energy_weight = request_energy_weight

    def serve_queue(self, arrivals: list[tuple[dict, float]]) -> list:
        reqs = [self.make_request(i, s, a)
                for i, (s, a) in enumerate(arrivals)]
        self.completed = self.engine.serve(reqs)
        return self.completed

    def supports_serve_queue(self) -> bool:
        return True

    def completed_requests(self) -> Optional[list]:
        return self.completed or None

    def _phase_util(self, spans: list, width: int) -> Callable:
        def util(t):
            t = np.asarray(t, float)
            inflight = np.zeros_like(t)
            for a, d in spans:
                inflight += (t >= a) & (t < d)
            return np.minimum(inflight / max(1, width), 1.0)

        return util

    def _fleet_shapes(self):
        """Per-fleet (token_rate, util) from the completed records."""
        recs = [r for r in self.completed if r.done_s is not None]
        dur = max([r.done_s for r in recs], default=0.0) or 1.0
        pre_spans = [(r.prefill_start_s, r.first_token_s) for r in recs
                     if r.prefill_start_s is not None
                     and r.first_token_s is not None]
        dec_spans = [(r.first_token_s, r.done_s) for r in recs
                     if r.first_token_s is not None]
        pre_rate = sum(getattr(r, "prefill_tokens", 0)
                       for r in recs) / dur
        dec_rate = sum(len(r.output or []) for r in recs) / dur
        return ((pre_rate, self._phase_util(pre_spans, self.n_prefill)),
                (dec_rate, self._phase_util(dec_spans,
                                            self.engine.engine.n_slots)))

    def domains(self, outcome) -> list[PowerDomain]:
        (pre_rate, pre_util), (dec_rate, dec_util) = self._fleet_shapes()
        fleets = (("prefill", self.prefill_meter, pre_rate, pre_util,
                   self.n_prefill),
                  ("decode", self.decode_meter, dec_rate, dec_util,
                   self.n_decode))
        doms: list[PowerDomain] = []
        walls: list[str] = []
        for g, meter, rate, util, k in fleets:
            # 2 FLOPs/param per token this fleet processes: prompt
            # tokens for prefill, generated tokens for decode
            rdoms = rail_domains(meter, throughput_work(self.cfg, rate),
                                 util=util, n_accel_channels=k)
            for d in rdoms:
                doms.append(PowerDomain(
                    name=f"{g}/{d.name}", source=d.source, kind=d.kind,
                    group=g, boundary=False,
                    derived_from=tuple(f"{g}/{n}"
                                       for n in d.derived_from),
                    combine=d.combine))
                if d.kind == WALL:
                    walls.append(f"{g}/{d.name}")
        doms.append(PowerDomain(PDU, derived_from=tuple(walls),
                                boundary=True))
        return doms

    def _psu(self):
        return self.prefill_meter.psu()

    def power_source(self, outcome) -> PowerSource:
        (pre_rate, pre_util), (dec_rate, dec_util) = self._fleet_shapes()
        pre = _shaped(self.prefill_meter.system_watts(None),
                      self.prefill_meter.system_watts(
                          throughput_work(self.cfg, pre_rate)), pre_util)
        dec = _shaped(self.decode_meter.system_watts(None),
                      self.decode_meter.system_watts(
                          throughput_work(self.cfg, dec_rate)), dec_util)

        def fleet(t):
            t = np.asarray(t, float)
            return np.asarray(pre(t), float) + np.asarray(dec(t), float)

        return fleet


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
