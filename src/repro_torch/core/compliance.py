"""Compliance checker: the paper's validation & review rules (§IV-D).

Checks a submission (perf log + power log + system description) against
the measurement rules and produces a review report:

  R1  measurement window covers >= min_duration (60 s)
  R2  sampling rate >= required minimum for the scale
  R3  power samples span the whole execution window (no gaps > 2/rate)
  R4  instrument is SPEC-approved (edge) / documented accuracy (DC)
  R5  full-system scope declared (chips + host + interconnect)
  R6  estimation methodologies disclosed for any estimated component
  R7  energy consistency: avg power within declared system envelope
  R8  range-mode (two-pass) used for analyzer measurements < 75 W

Multi-domain submissions (``repro_torch.power.MeterStack`` logs carry
per-channel domain metadata) additionally get the cross-domain
invariants:

  R9  wall >= sum of DC rails (the PSU only ever *adds* loss)
  R10 wall == sum of rails / eta(load) within the channels' error
      model (needs the stack's PSU model; skipped without one)
  R11 PDU aggregation equals the sum of its member wall feeds

Robustness invariants (what a fault the stack could not absorb looks
like in the log — see ``repro_torch.faults``):

  R12 per-boundary-channel sample coverage >= threshold (default 95%
      of the channel's own cadence over the window; telemetry dropout
      the degradation loop failed to re-measure lands here)
  R13 no clipped samples on boundary channels (a range overload the
      re-ranging retry failed to cure; clipped samples carry a
      ``clipped`` flag in the log metadata)

Copied from the reference ``src/repro/core/compliance.py``; only its imports
differ.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.mlperf_log import LogEvent, find_window
from repro_torch.core.summarizer import _trapz

RAIL_KINDS = ("accelerator", "dram", "host")

MIN_DURATION_S = 60.0
MIN_SAMPLE_HZ = {"tiny": 1000.0, "edge": 1.0, "datacenter": 0.5}


@dataclasses.dataclass
class Check:
    rule: str
    passed: bool
    detail: str


@dataclasses.dataclass
class SystemDescription:
    scale: str                           # tiny | edge | datacenter
    n_chips: int = 1
    instrument: str = "virtual-wt310"
    instrument_spec_approved: bool = True
    telemetry_accuracy: Optional[float] = None
    scope: tuple = ("chips", "host")
    estimated_components: dict = dataclasses.field(default_factory=dict)
    max_system_watts: Optional[float] = None
    idle_system_watts: float = 0.0


@dataclasses.dataclass
class ReviewReport:
    checks: list[Check]

    @property
    def passed(self) -> bool:
        return all(c.passed for c in self.checks)

    def failures(self) -> list[Check]:
        return [c for c in self.checks if not c.passed]

    def render(self) -> str:
        lines = ["MLPerf Power compliance review:"]
        for c in self.checks:
            lines.append(f"  [{'PASS' if c.passed else 'FAIL'}] "
                         f"{c.rule}: {c.detail}")
        lines.append(f"  => {'ACCEPTED' if self.passed else 'REJECTED'}")
        return "\n".join(lines)


def _channel_series(power_events: list[LogEvent], start_ms: float,
                    stop_ms: float) -> dict:
    """Per-channel in-window series + domain metadata.

    Returns ``{node: dict(t_s, w, energy_j, kind, group, boundary,
    derived)}``; channels whose samples carry no domain ``kind`` are
    legacy single-source logs and get ``kind=None``.
    """
    raw: dict[str, dict] = {}
    for ev in power_events:
        if ev.key != "power_w":
            continue
        md = ev.metadata or {}
        node = md.get("node", "sut")
        ch = raw.setdefault(node, {
            "samples": [], "kind": md.get("kind"),
            "group": md.get("group", ""),
            "boundary": bool(md.get("boundary", True)),
            "source": str(md.get("source", "")),
            "derived": str(md.get("source", "")).startswith("derived:"),
            "sample_hz": md.get("sample_hz"),
        })
        ch["samples"].append((ev.time_ms, float(ev.value),
                              bool(md.get("clipped", False))))
    out = {}
    for node, ch in raw.items():
        ch["samples"].sort()
        t = np.asarray([s[0] for s in ch["samples"]]) / 1e3
        w = np.asarray([s[1] for s in ch["samples"]])
        clip = np.asarray([s[2] for s in ch["samples"]], bool)
        sel = (t >= start_ms / 1e3) & (t <= stop_ms / 1e3)
        t, w, clip = t[sel], w[sel], clip[sel]
        e = _trapz(w, t) if len(t) > 1 else 0.0
        out[node] = dict(t_s=t, w=w, energy_j=e, kind=ch["kind"],
                         group=ch["group"], boundary=ch["boundary"],
                         source=ch["source"], derived=ch["derived"],
                         sample_hz=ch["sample_hz"],
                         n_clipped=int(clip.sum()))
    return out


def _pdu_members(name: str, ch: dict, channels: dict,
                 meter_stack=None) -> dict:
    """The wall feeds a PDU actually aggregates: its ``derived_from``
    list (from the stack, or the ``derived:a+b`` source tag its
    samples carry) — NOT every wall channel in the log, which would
    falsely reject a stack carrying an extra standalone wall monitor
    or a second PDU over a disjoint replica subset."""
    members: tuple = ()
    if meter_stack is not None:
        try:
            members = meter_stack.channel(name).domain.derived_from
        except KeyError:
            pass
    if not members and ch["derived"]:
        members = tuple(ch["source"][len("derived:"):].split("+"))
    if members:
        return {m: channels[m] for m in members if m in channels}
    return {m: c for m, c in channels.items() if c["kind"] == "wall"}


def _domain_checks(channels: dict, meter_stack=None) -> list[Check]:
    """The cross-domain invariants (R9-R11) for MeterStack logs."""
    checks: list[Check] = []
    if not any(ch["kind"] for ch in channels.values()):
        return checks                   # legacy logs: no domain metadata

    # per-channel analyzer gain errors -> measurement slack
    def _gain(node):
        if meter_stack is None:
            return 0.002
        try:
            m = meter_stack.channel(node)
        except KeyError:
            return 0.002
        return m.analyzer.spec.gain_error if m.analyzer else 0.0

    groups = sorted({ch["group"] for ch in channels.values()
                     if ch["kind"] in RAIL_KINDS})
    for g in groups:
        rails = {n: ch for n, ch in channels.items()
                 if ch["group"] == g and ch["kind"] in RAIL_KINDS}
        walls = {n: ch for n, ch in channels.items()
                 if ch["group"] == g and ch["kind"] == "wall"}
        if not rails or not walls:
            continue
        label = f"group {g!r}" if g else "wall"
        e_rails = sum(ch["energy_j"] for ch in rails.values())
        e_wall = sum(ch["energy_j"] for ch in walls.values())
        slack = 3 * (max(_gain(n) for n in walls)
                     + max(_gain(n) for n in rails)) + 0.01
        checks.append(Check(
            "R9 wall-geq-rails",
            e_wall >= e_rails * (1.0 - slack),
            f"{label}: wall {e_wall:.3f} J vs sum-of-rails "
            f"{e_rails:.3f} J (PSU loss can only add)"))
        psu = getattr(meter_stack, "psu", None)
        if psu is None:
            checks.append(Check(
                "R10 psu-consistency", True,
                f"{label}: no PSU model documented (skipped)"))
            continue
        lens = {len(ch["t_s"]) for ch in rails.values()} | \
            {len(ch["t_s"]) for ch in walls.values()}
        if len(lens) != 1:
            checks.append(Check(
                "R10 psu-consistency", False,
                f"{label}: channels not on one timeline "
                f"(sample counts {sorted(lens)})"))
            continue
        dc = np.sum([ch["w"] for ch in rails.values()], axis=0)
        t_s = next(iter(walls.values()))["t_s"]
        e_expect = (_trapz(psu.wall_watts(dc), t_s)
                    if len(t_s) > 1 else 0.0)
        tol = max(0.025, slack)
        rel = abs(e_wall - e_expect) / max(e_expect, 1e-12)
        checks.append(Check(
            "R10 psu-consistency", rel <= tol,
            f"{label}: wall {e_wall:.3f} J vs rails/eta "
            f"{e_expect:.3f} J ({rel * 100:.2f}% vs tol "
            f"{tol * 100:.1f}%)"))

    pdus = {n: ch for n, ch in channels.items() if ch["kind"] == "pdu"}
    for n, ch in sorted(pdus.items()):
        feeds = _pdu_members(n, ch, channels, meter_stack)
        if not feeds:
            checks.append(Check("R11 pdu-aggregation", False,
                                f"{n}: no member wall feeds logged"))
            continue
        e_feeds = sum(c["energy_j"] for c in feeds.values())
        # a derived PDU register is the exact sum of its feeds; an
        # independently metered PDU gets the error-model slack
        tol = 1e-9 if ch["derived"] else \
            3 * max(_gain(m) for m in feeds) + 0.01
        rel = abs(ch["energy_j"] - e_feeds) / max(e_feeds, 1e-12)
        checks.append(Check(
            "R11 pdu-aggregation", rel <= tol,
            f"{n}: {ch['energy_j']:.3f} J vs sum of "
            f"{len(feeds)} wall feeds {e_feeds:.3f} J"))
    return checks


def _robustness_checks(channels: dict, window_s: float,
                       coverage_threshold: float) -> list[Check]:
    """R12/R13: what an unabsorbed metering fault looks like in the log.

    Both apply to *boundary* channels only — they guard the submission
    total; a degraded breakdown rail is informational, not a validity
    hazard.  Coverage compares delivered in-window samples against the
    channel's own cadence (the ``sample_hz`` its samples carry; legacy
    logs fall back to the median inter-sample step), so a run with
    telemetry gaps the degradation loop could not re-measure is
    REJECTED with the shortfall named instead of quietly integrating
    through the hole.
    """
    checks: list[Check] = []
    for n, ch in sorted(channels.items()):
        if not ch["boundary"]:
            continue
        t = ch["t_s"]
        if len(t) < 2:
            checks.append(Check("R12 sample-coverage", False,
                                f"{n}: {len(t)} in-window samples"))
            continue
        hz = ch.get("sample_hz")
        if not hz:
            d = np.diff(t)
            d = d[d > 0]
            hz = 1.0 / float(np.median(d)) if len(d) else None
        if hz:
            expected = window_s * float(hz)
            coverage = len(t) / max(expected, 1.0)
            checks.append(Check(
                "R12 sample-coverage",
                coverage >= coverage_threshold,
                f"{n}: {len(t)} samples vs ~{expected:.0f} expected at "
                f"{float(hz):g} Hz ({min(coverage, 1.0) * 100:.1f}% >= "
                f"{coverage_threshold * 100:.0f}%)"))
        nc = ch.get("n_clipped", 0)
        checks.append(Check(
            "R13 no-clipping", nc == 0,
            f"{n}: {nc} clipped samples (range overload not cured by "
            f"re-ranging)" if nc else f"{n}: no clipped samples"))
    return checks


def review(perf_events: list[LogEvent], power_events: list[LogEvent],
           sysdesc: SystemDescription, *,
           min_duration_s: float = MIN_DURATION_S,
           range_mode_used: bool = True,
           coverage_threshold: float = 0.95,
           meter_stack=None) -> ReviewReport:
    checks: list[Check] = []
    start_ms, stop_ms = find_window(perf_events)
    window_s = (stop_ms - start_ms) / 1e3

    checks.append(Check(
        "R1 min-duration", window_s >= min_duration_s - 1e-6,
        f"window {window_s:.1f}s vs required {min_duration_s:.0f}s"))

    ts = np.sort(np.asarray([ev.time_ms for ev in power_events
                             if ev.key == "power_w"]))
    in_win = ts[(ts >= start_ms) & (ts <= stop_ms)]
    nodes = {(ev.metadata or {}).get("node", "sut")
             for ev in power_events if ev.key == "power_w"}
    n_nodes = max(1, len(nodes))
    if len(in_win) >= 2:
        rate = (len(in_win) / n_nodes) / max(window_s, 1e-9)
        need = MIN_SAMPLE_HZ[sysdesc.scale]
        checks.append(Check("R2 sampling-rate", rate >= need * 0.99,
                            f"{rate:.2f} Hz/node vs required {need} Hz"))
        # gap check on a single node's samples
        node0 = sorted(nodes)[0]
        ts0 = np.sort(np.asarray([ev.time_ms for ev in power_events
                                  if ev.key == "power_w" and
                                  (ev.metadata or {}).get("node", "sut")
                                  == node0]))
        ts0 = ts0[(ts0 >= start_ms) & (ts0 <= stop_ms)]
        max_gap = float(np.max(np.diff(ts0))) / 1e3 if len(ts0) > 1 else 1e9
        allowed = 2.0 / MIN_SAMPLE_HZ[sysdesc.scale]
        cover = ((ts0[0] - start_ms) / 1e3 <= allowed and
                 (stop_ms - ts0[-1]) / 1e3 <= allowed)
        checks.append(Check("R3 coverage",
                            max_gap <= allowed * 1.5 and cover,
                            f"max gap {max_gap * 1e3:.1f} ms, "
                            f"edges covered={cover}"))
    else:
        checks.append(Check("R2 sampling-rate", False, "no samples"))
        checks.append(Check("R3 coverage", False, "no samples"))

    if sysdesc.scale in ("edge", "tiny"):
        checks.append(Check("R4 instrument",
                            sysdesc.instrument_spec_approved,
                            f"{sysdesc.instrument} SPEC-approved="
                            f"{sysdesc.instrument_spec_approved}"))
    else:
        ok = sysdesc.telemetry_accuracy is not None \
            and sysdesc.telemetry_accuracy <= 0.05
        checks.append(Check("R4 instrument", ok,
                            f"telemetry accuracy documented: "
                            f"{sysdesc.telemetry_accuracy}"))

    full = {"chips", "host"} <= set(sysdesc.scope)
    checks.append(Check("R5 full-system scope", full,
                        f"scope={sysdesc.scope}"))

    est_ok = all(bool(v) for v in sysdesc.estimated_components.values())
    checks.append(Check(
        "R6 estimation disclosure",
        est_ok, f"estimated={list(sysdesc.estimated_components)}"
                " (all documented)" if sysdesc.estimated_components
        else "no estimated components"))

    # R7 compares against the declared full-system envelope, so only
    # the *boundary* channels (wall / pdu / pin) count — summing the
    # breakdown rails on top would double-count the wall.  Samples
    # without domain metadata keep the legacy all-nodes semantics.
    w = []
    boundary_nodes = set()
    for ev in power_events:
        if ev.key != "power_w" or not (start_ms <= ev.time_ms <= stop_ms):
            continue
        md = ev.metadata or {}
        if not bool(md.get("boundary", True)):
            continue
        w.append(float(ev.value))
        boundary_nodes.add(md.get("node", "sut"))
    if w and sysdesc.max_system_watts:
        avg = float(np.mean(w)) * (len(boundary_nodes)
                                   if len(boundary_nodes) > 1 else 1)
        envelope_ok = (sysdesc.idle_system_watts * 0.5 <= avg
                       <= sysdesc.max_system_watts * 1.1)
        checks.append(Check("R7 consistency", envelope_ok,
                            f"avg {avg:.1f} W within "
                            f"[{sysdesc.idle_system_watts * 0.5:.0f}, "
                            f"{sysdesc.max_system_watts * 1.1:.0f}] W"))
    else:
        checks.append(Check("R7 consistency", True,
                            "no envelope declared (skipped)"))

    if w and float(np.mean(w)) < 75.0 and sysdesc.scale == "edge":
        checks.append(Check("R8 range-mode", range_mode_used,
                            "sub-75W device: fixed ranges required"))
    else:
        checks.append(Check("R8 range-mode", True, "not applicable"))

    channels = _channel_series(power_events, start_ms, stop_ms)
    checks.extend(_domain_checks(channels, meter_stack))
    checks.extend(_robustness_checks(channels, window_s,
                                     coverage_threshold))
    return ReviewReport(checks)
