"""Meters and the MeterStack: multi-channel measurement as one unit.

A ``Meter`` binds one ``PowerDomain`` to an instrument model — a
``VirtualAnalyzer`` channel configured for the domain's regime
(SPEC-class WT310 for edge wall/rails, node-telemetry accuracy for
datacenter channels, the µW I/O-manager-grade channel for the tiny
pin) — or marks the channel *derived* (a PDU summing register over
already-measured feeds).

The ``MeterStack`` is what the Director/PTD session drives as one
unit: one NTP-corrected timeline shared by every channel, per-channel
two-pass ranging (each channel pins the smallest range covering *its
own* peak, not the stack peak), and one power log whose samples carry
the domain/boundary metadata the summarizer and compliance review key
on.

Copied from the reference ``src/repro/power/stack.py``; only its imports
differ.  Injected metering faults (``repro_torch.faults``) act on the
stack's sampling of a channel: on the card that includes the
accelerator channel's samples of the NVML-measured trace, never the
NVML counter itself, so a re-measured interval re-samples the same
measured trace.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.analyzer import AnalyzerSpec, VirtualAnalyzer
from repro_torch.core.mlperf_log import MLPerfLogger
from repro_torch.power.domains import PIN, PowerDomain
from repro_torch.power.psu import PSUModel

# µW-regime channel: WT310 defaults (50 mW offset error, 15 W bottom
# range) would drown a duty-cycled MCU trace.
PIN_CHANNEL = AnalyzerSpec(
    name="virtual-io-manager", sample_hz=2000.0, gain_error=0.001,
    offset_error_w=1e-7, ranges_w=(1e-3, 1e-2, 1e-1, 1.0), counts=60_000)


def telemetry_channel(accuracy: float = 0.02,
                      sample_hz: float = 10.0) -> AnalyzerSpec:
    """IPMI/Redfish-style out-of-band channel: percent-of-reading
    accuracy, no SPEC approval (the paper's §IV-C instrument, absorbed
    into the channel model)."""
    return AnalyzerSpec(
        name="node-telemetry", sample_hz=sample_hz,
        gain_error=accuracy / 2, offset_error_w=0.0,
        ranges_w=(1e3, 1e4, 1e5, 1e6), counts=10_000_000,
        spec_approved=False)


@dataclasses.dataclass
class Meter:
    """One channel: a domain plus the instrument sampling it.

    ``analyzer`` is ``None`` exactly when the domain is derived — the
    channel's samples are computed from other channels' *measured*
    samples instead of drawn by an instrument.
    """

    domain: PowerDomain
    analyzer: Optional[VirtualAnalyzer] = None

    def __post_init__(self):
        if (self.analyzer is None) != self.domain.derived:
            raise ValueError(
                f"meter {self.domain.name!r}: derived domains take no "
                f"analyzer; measured domains need one")

    @property
    def name(self) -> str:
        return self.domain.name

    @property
    def instrument(self) -> str:
        if self.analyzer is None:
            return "derived:" + "+".join(self.domain.derived_from)
        return self.analyzer.spec.name


class MeterStack:
    """A set of meters measured as one unit on one shared timeline.

    ``psu`` documents the loss model linking the DC rails to the wall
    boundary; the compliance review uses it for the cross-domain
    consistency checks (wall >= sum of rails; wall == rails/eta within
    the channels' error model).
    """

    def __init__(self, meters: list[Meter], *, psu: Optional[PSUModel]
                 = None, name: str = "meter-stack"):
        if not meters:
            raise ValueError("MeterStack needs at least one meter")
        names = [m.name for m in meters]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate channel names: {names}")
        known = set(names)
        for m in meters:
            missing = set(m.domain.derived_from) - known
            if missing:
                raise ValueError(
                    f"channel {m.name!r} derives from unknown "
                    f"channels {sorted(missing)}")
        if not any(m.domain.boundary for m in meters):
            raise ValueError(
                f"stack {name!r} has no boundary channel "
                f"({names}): one domain (wall/pdu/pin) must be the "
                f"submission total or the summarizer integrates zero "
                f"energy")
        self.meters = list(meters)
        self.psu = psu
        self.name = name
        # per-channel degradation record of the last measure() with an
        # injector: {channel: repro_torch.faults.ChannelHealth}
        self.health: dict = {}

    # --- introspection -------------------------------------------------
    def __iter__(self):
        return iter(self.meters)

    def __len__(self):
        return len(self.meters)

    def channel(self, name: str) -> Meter:
        for m in self.meters:
            if m.name == name:
                return m
        raise KeyError(name)

    def channel_names(self) -> list[str]:
        return [m.name for m in self.meters]

    def boundary_names(self) -> list[str]:
        return [m.name for m in self.meters if m.domain.boundary]

    def describe(self) -> dict:
        """Per-channel device info (the PTD connect handshake)."""
        return {m.name: {
            "instrument": m.instrument,
            "kind": m.domain.kind,
            "boundary": m.domain.boundary,
            "spec_approved": (m.analyzer.spec.spec_approved
                              if m.analyzer else False),
        } for m in self.meters}

    # --- two-pass ranging ----------------------------------------------
    def range_probe(self, duration_s: float) -> dict:
        """Initial run: every measured channel observes *its own*
        domain's peak and pins the smallest covering range (a shared
        stack-peak range would cost the low-power rails a decade of
        resolution)."""
        out = {}
        for m in self.meters:
            if m.analyzer is not None:
                out[m.name] = m.analyzer.range_probe(m.domain.source,
                                                     duration_s)
        return out

    def set_range(self, watts: float, channel: Optional[str] = None):
        """PTD range command; one channel or all measured channels."""
        for m in self.meters:
            if m.analyzer is not None and (channel is None
                                           or m.name == channel):
                m.analyzer.fixed_range = watts

    # --- measurement ----------------------------------------------------
    def measure(self, duration_s: float, *, t0_ms: float = 0.0,
                logger: Optional[MLPerfLogger] = None,
                injector=None, retry=None) -> dict:
        """Sample every channel over the same window; returns
        ``{channel: (t_ms, watts)}``.

        Measured channels are sampled by their instruments; derived
        channels combine the *measured* samples of the channels they
        aggregate (sum by default — PDU semantics), so a derived
        boundary is exactly the sum of what its feeds reported.  All
        channels share one timeline (uniform sample rate enforced),
        the precondition for cross-domain energy comparison.

        ``injector`` (a ``repro_torch.faults.FaultInjector``) applies the
        fault plan's metering hazards to each measured channel, and the
        stack degrades gracefully instead of logging lies: clipped
        intervals are re-ranged and re-measured, sample gaps re-measured
        (bounded exponential backoff per ``retry``, a
        ``repro_torch.faults.RetryPolicy``), skewed timestamps realigned to
        the stack's own nominal grid.  What happened lands in
        ``self.health`` (per-channel ``ChannelHealth``); residual gaps
        and clipped samples reach the log marked for the compliance
        invariants (R12 coverage / R13 no-clipping) to catch.
        """
        out: dict = {}
        grid = None
        hz = None
        for m in self.meters:
            if m.analyzer is None:
                continue
            t_ms, w = m.analyzer.measure(m.domain.source, duration_s,
                                         t0_ms=t0_ms)
            if grid is None:
                grid = t_ms
                hz = m.analyzer.spec.sample_hz
            elif len(t_ms) != len(grid):
                raise ValueError(
                    f"channel {m.name!r} samples at "
                    f"{m.analyzer.spec.sample_hz} Hz — all channels of "
                    f"a stack share one timeline (uniform sample rate)")
            out[m.name] = (t_ms, w)
        # fault injection + graceful degradation runs BEFORE derived
        # resolution: a derived register sums what its feeds *measured*
        # (surge/clip effects and retried intervals included), so the
        # PDU invariant stays exact under faults the stack absorbed
        self.health = {}
        flags: dict = {}
        if injector is not None:
            for m in self.meters:
                if m.analyzer is None:
                    continue
                t_ms, w = out[m.name]
                w, dropped, clipped, health = self._degrade(
                    m, t_ms, w, t0_ms=t0_ms, hz=hz, injector=injector,
                    retry=retry)
                out[m.name] = (t_ms, w)
                flags[m.name] = (dropped, clipped)
                self.health[m.name] = health
        # resolve derived channels (PDU-style aggregation; an order
        # that only references already-resolved channels is required)
        pending = [m for m in self.meters if m.analyzer is None]
        while pending:
            progressed = False
            for m in list(pending):
                if not all(n in out for n in m.domain.derived_from):
                    continue
                parts = [out[n][1] for n in m.domain.derived_from]
                t_ms = out[m.domain.derived_from[0]][0]
                combine = m.domain.combine or (
                    lambda ws: np.sum(ws, axis=0))
                out[m.name] = (t_ms, np.asarray(combine(parts), float))
                pending.remove(m)
                progressed = True
            if not progressed:
                raise ValueError(
                    f"derived channels form a cycle: "
                    f"{[m.name for m in pending]}")
        if logger is not None:
            for m in self.meters:
                t_ms, w = out[m.name]
                # sample_hz rides along so coverage (R12) can compare
                # delivered samples against the channel's own cadence
                meta = dict(m.domain.metadata())
                meta["sample_hz"] = (m.analyzer.spec.sample_hz
                                     if m.analyzer is not None else hz)
                dropped, clipped = flags.get(m.name, (None, None))
                for i, (ti, wi) in enumerate(zip(t_ms, w)):
                    if dropped is not None and dropped[i]:
                        continue   # lost in telemetry: never logged
                    extra = meta
                    if clipped is not None and clipped[i]:
                        extra = dict(meta, clipped=True)
                    logger.power_sample(float(ti), float(wi),
                                        node=m.name,
                                        source=m.instrument,
                                        extra=extra)
        # the telemetry view: residual dropped samples are gaps
        view: dict = {}
        for name, (t_ms, w) in out.items():
            dropped = flags.get(name, (None,))[0]
            if dropped is not None and dropped.any():
                keep = ~dropped
                view[name] = (t_ms[keep], w[keep])
            else:
                view[name] = (t_ms, w)
        return view

    def coverage(self) -> dict:
        """Per-channel delivered/expected sample fraction of the last
        injected measure(); clean channels report 1.0."""
        return {name: h.coverage for name, h in self.health.items()}

    def _bump_range(self, m: Meter) -> bool:
        """Re-range after clipping: step the channel to the next range
        (PTDaemon's cure for an overload — one step per retry, since a
        clipped reading hides the true peak)."""
        a = m.analyzer
        if a is None or a.fixed_range is None:
            return False                # autorange never clips here
        above = [r for r in a.spec.ranges_w if r > a.fixed_range]
        if not above:
            return False                # already at the top range
        a.fixed_range = above[0]
        return True

    def _degrade(self, m: Meter, t_ms: np.ndarray, w: np.ndarray, *,
                 t0_ms: float, hz: float, injector, retry):
        """Inject one channel's faults, then re-range/re-measure the
        affected intervals with bounded exponential backoff."""
        from repro_torch.faults.inject import ChannelHealth

        rel_s = (np.asarray(t_ms, float) - t0_ms) / 1e3
        w, dropped, clipped, shift_ms = injector.apply(m, rel_s, w,
                                                       retry=0)
        health = ChannelHealth()
        if np.any(shift_ms != 0.0):
            # the stack owns the nominal grid (one shared timeline), so
            # a skew spike is detected as deviation from it and cured
            # by realigning to the grid; the correction is surfaced in
            # health rather than silently swallowed
            health.skew_corrected_ms = float(np.max(np.abs(shift_ms)))
        k = 0
        max_attempts = retry.max_attempts if retry is not None else 0
        while (dropped.any() or clipped.any()) and k < max_attempts:
            if clipped.any():
                if self._bump_range(m):
                    health.reranges += 1
                elif not dropped.any():
                    break               # top range: no structural fix
            health.retries += 1
            health.backoff_s += retry.delay_s(k)
            bad = dropped | clipped
            for i0, i1 in _spans(bad):
                nn = i1 - i0 + 1
                start_s = float(rel_s[i0])
                # the analyzer samples from t=0, so the interval source
                # is the channel waveform shifted to the span start
                seg_src = (lambda t, _src=m.domain.source, _a=start_s:
                           _src(np.asarray(t, float) + _a))
                _, seg_w = m.analyzer.measure(
                    seg_src, (nn + 0.5) / hz,
                    t0_ms=t0_ms + start_s * 1e3)
                seg_w, seg_drop, seg_clip, _ = injector.apply(
                    m, rel_s[i0:i1 + 1], seg_w[:nn], retry=k + 1)
                w[i0:i1 + 1] = seg_w
                dropped[i0:i1 + 1] = seg_drop
                clipped[i0:i1 + 1] = seg_clip
            k += 1
        health.n_dropped = int(dropped.sum())
        health.n_clipped = int(clipped.sum())
        health.coverage = 1.0 - health.n_dropped / max(1, len(w))
        return w, dropped, clipped, health

    def shift_clock(self, logger: MLPerfLogger, offset_ms: float):
        """Move logged samples into the SUT clock (post-NTP-sync)."""
        for ev in logger.events:
            ev.time_ms += offset_ms


def _spans(mask: np.ndarray) -> list[tuple[int, int]]:
    """Contiguous True runs of a boolean mask as inclusive (i0, i1)
    index pairs (the intervals the degradation loop re-measures)."""
    idx = np.flatnonzero(mask)
    if not len(idx):
        return []
    breaks = np.flatnonzero(np.diff(idx) > 1)
    starts = np.concatenate([[0], breaks + 1])
    stops = np.concatenate([breaks, [len(idx) - 1]])
    return [(int(idx[a]), int(idx[b])) for a, b in zip(starts, stops)]


def single_source_stack(source, analyzer: Optional[VirtualAnalyzer]
                        = None, *, name: str = "wall-only") -> MeterStack:
    """The compatibility stack: one scalar ``source(t) -> watts``
    measured at the wall boundary (the pre-domain API)."""
    from repro_torch.power.domains import wall_domain

    return MeterStack(
        [Meter(wall_domain(source), analyzer or VirtualAnalyzer())],
        name=name)


def build_stack(domains: list[PowerDomain], sysdesc, *, seed: int = 0,
                sample_hz: Optional[float] = None,
                name: str = "meter-stack",
                psu: Optional[PSUModel] = None) -> MeterStack:
    """Scale-appropriate instruments for a set of domains.

    Channel choice mirrors the paper's instrument table: the tiny pin
    channel gets the µW I/O-manager-grade spec (kHz sampling, sub-µW
    offset error), datacenter systems get node-telemetry channels with
    the documented accuracy, edge systems get the SPEC-approved
    WT310-class analyzer.  ``sample_hz`` overrides every channel's
    rate together (the stack shares one timeline).
    """
    scale = getattr(sysdesc, "scale", "edge")
    accuracy = getattr(sysdesc, "telemetry_accuracy", None) or 0.02
    meters = []
    for i, dom in enumerate(domains):
        if dom.derived:
            meters.append(Meter(dom))
            continue
        if dom.kind == PIN:
            spec = dataclasses.replace(PIN_CHANNEL)
        elif scale == "datacenter":
            spec = telemetry_channel(accuracy)
        else:
            spec = AnalyzerSpec()
        if sample_hz is not None:
            spec = dataclasses.replace(spec, sample_hz=sample_hz)
        # channel 0 keeps the bare seed so a single-channel stack is
        # draw-for-draw identical to the legacy single-analyzer path
        meters.append(Meter(dom, VirtualAnalyzer(
            spec, seed=seed + 101 * i)))
    return MeterStack(meters, psu=psu, name=name)
