"""Energy-efficiency metrics + version-over-version trend analysis.

The §V analyses: normalized Samples/Joule trends (Fig. 4), software- vs
hardware-isolated improvement attribution (Figs. 9-10), accuracy-target
efficiency cost (Fig. 7).

Copied from the reference ``src/repro/core/efficiency.py``; only its imports
differ.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Submission:
    version: str
    workload: str
    scale: str                        # tiny | edge | datacenter
    system_id: str                    # hardware identity for isolation
    software_id: str
    samples_per_second: float
    avg_watts: float
    accuracy_target: Optional[float] = None
    # multi-domain submissions: average watts per measured power
    # domain (accelerator / dram / host / wall / pdu / pin); the
    # boundary domains are what avg_watts totals
    per_domain_watts: Optional[dict] = None

    @property
    def samples_per_joule(self) -> float:
        return self.samples_per_second / self.avg_watts

    @property
    def joules_per_sample(self) -> float:
        return self.avg_watts / self.samples_per_second

    def domain_samples_per_joule(self) -> dict:
        """Per-domain efficiency: what the throughput costs on each
        rail (the paper's per-component attribution view)."""
        if not self.per_domain_watts:
            return {}
        return {k: self.samples_per_second / w
                for k, w in self.per_domain_watts.items() if w > 0}


def max_sustainable_qps(points: list[tuple], *,
                        min_attainment: float = 0.99) -> float:
    """Max offered QPS whose tail-SLO attainment stays at or above
    ``min_attainment`` — the Server-scenario capacity figure.

    Args:
        points: ``(qps, attainment)`` pairs from a QPS sweep — offered
            queries/s vs the fraction meeting the TTFT/TPOT tail SLOs
            (``ServerMetrics.tail_attainment``), any order.
        min_attainment: the attainment bar (fraction in [0, 1]; the
            paper-style default demands 99 %).

    Returns the highest sustaining QPS, or ``0.0`` when no swept point
    sustains the bar.  The sweep's grid sets the resolution; this does
    not interpolate between points (a knee between grid points reports
    the last *measured* sustaining rate).
    """
    ok = [float(q) for q, a in points
          if not np.isnan(a) and a >= min_attainment]
    return max(ok, default=0.0)


def qps_at_slo_per_joule(qps_at_slo: float, avg_watts: float) -> float:
    """Max sustainable QPS at the tail SLO per joule: queries/s of
    SLO-compliant capacity per watt of measured draw — equivalently,
    SLO-compliant queries per joule (1/s / W == 1/J).  The Server
    energy-efficiency headline the SLO sweep reports.

    Args:
        qps_at_slo: ``max_sustainable_qps`` output (queries/s).
        avg_watts: mean measured system draw over the sustaining run
            (boundary-channel watts — wall, or pdu for fleets).
    """
    if avg_watts <= 0:
        return 0.0
    return qps_at_slo / avg_watts


def normalized_trend(subs: list[Submission]) -> dict[str, list]:
    """Per-workload Samples/J normalized to the first version (Fig. 4)."""
    by_wl: dict[str, list[Submission]] = {}
    for s in subs:
        by_wl.setdefault(s.workload, []).append(s)
    out = {}
    for wl, ss in by_wl.items():
        ss = sorted(ss, key=lambda s: s.version)
        base = ss[0].samples_per_joule
        out[wl] = [(s.version, s.samples_per_joule / base) for s in ss]
    return out


def software_isolated_deltas(subs: list[Submission]) -> list[dict]:
    """Identical hardware, consecutive versions -> efficiency change
    distribution (Fig. 9)."""
    out = []
    by_key: dict[tuple, list[Submission]] = {}
    for s in subs:
        by_key.setdefault((s.workload, s.system_id), []).append(s)
    for (wl, sysid), ss in by_key.items():
        ss = sorted(ss, key=lambda s: s.version)
        for a, b in zip(ss, ss[1:]):
            out.append({
                "workload": wl, "system": sysid,
                "from": a.version, "to": b.version,
                "delta_pct": 100.0 * (b.samples_per_joule
                                      / a.samples_per_joule - 1.0),
                "perf_ratio": b.samples_per_second / a.samples_per_second,
                "power_ratio": b.avg_watts / a.avg_watts,
            })
    return out


def hardware_isolated_deltas(subs: list[Submission]) -> list[dict]:
    """Constant software stack, successive hardware (Fig. 10b)."""
    out = []
    by_key: dict[tuple, list[Submission]] = {}
    for s in subs:
        by_key.setdefault((s.workload, s.software_id), []).append(s)
    for (wl, swid), ss in by_key.items():
        ss = sorted(ss, key=lambda s: s.version)
        for a, b in zip(ss, ss[1:]):
            if a.system_id == b.system_id:
                continue
            out.append({
                "workload": wl, "software": swid,
                "hw_from": a.system_id, "hw_to": b.system_id,
                "eff_ratio": b.samples_per_joule / a.samples_per_joule,
                "perf_ratio": b.samples_per_second / a.samples_per_second,
                "power_ratio": b.avg_watts / a.avg_watts,
            })
    return out


def accuracy_cost(low: Submission, high: Submission) -> float:
    """% change in Samples/J when moving to the higher accuracy target
    (Fig. 7; negative = efficiency lost)."""
    return 100.0 * (high.samples_per_joule / low.samples_per_joule - 1.0)


def summary_stats(deltas: list[dict], key: str = "delta_pct") -> dict:
    xs = np.asarray([d[key] for d in deltas], dtype=np.float64)
    if len(xs) == 0:
        return {"n": 0}
    return {
        "n": len(xs),
        "mean": float(np.mean(xs)),
        "median": float(np.median(xs)),
        "frac_positive": float(np.mean(xs > 0)),
        "frac_gt_50pct": float(np.mean(xs > 50)),
    }
