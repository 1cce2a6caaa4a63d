"""Result summarizer: align logs, integrate energy, compute metrics.

Implements the paper's §IV-C pipeline: find the run_start/run_stop
window in the performance log, select the power samples inside it
(per channel), trapezoidally integrate each channel's power over the
window, and derive the unified efficiency metrics of §IV-A.  Channels
are either *boundary* domains (wall / pdu / pin — what the submission
totals) or per-component breakdown rails (accelerator / dram / host)
reported per node but never double-counted into the total; samples
without domain metadata keep the legacy sum-over-nodes semantics
(+ documented switch estimates) for energy-to-train:

  throughput benchmarks: Samples/s, Watts, Samples/Joule
  latency benchmarks (tiny): energy per inference, 1/Joules

Copied from the reference ``src/repro/core/summarizer.py``; only its imports
differ.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Optional

import numpy as np

from repro_torch.core.mlperf_log import LogEvent, find_window


def _trapz(y: np.ndarray, x: np.ndarray) -> float:
    if hasattr(np, "trapezoid"):
        return float(np.trapezoid(y, x))
    return float(np.trapz(y, x))


@dataclasses.dataclass
class EnergySummary:
    window_s: float
    energy_j: float
    avg_watts: float
    per_node_j: dict
    n_samples: int
    samples_processed: Optional[float] = None
    samples_per_joule: Optional[float] = None
    samples_per_second: Optional[float] = None
    inv_joules: Optional[float] = None          # tiny metric (1/J)
    switch_energy_j: float = 0.0
    notes: tuple = ()
    # multi-domain runs: which channels *are* the submission total
    # (wall/pdu/pin); per_node_j keeps every channel's breakdown
    boundary_nodes: tuple = ()
    # delivered/expected in-window samples per channel (channels whose
    # samples carry a sample_hz; telemetry dropout shows up here and is
    # thresholded by compliance invariant R12)
    channel_coverage: dict = dataclasses.field(default_factory=dict)

    @property
    def per_domain_j(self) -> dict:
        """Alias: per-channel energies (breakdown + boundary)."""
        return self.per_node_j

    def domain_watts(self) -> dict:
        """Average watts per channel over the window."""
        w = max(self.window_s, 1e-12)
        return {k: v / w for k, v in self.per_node_j.items()}


def summarize(perf_events: list[LogEvent], power_events: list[LogEvent],
              *, switch_estimate: Optional[dict] = None) -> EnergySummary:
    start_ms, stop_ms = find_window(perf_events)
    window_s = (stop_ms - start_ms) / 1e3

    by_node: dict[str, list[tuple[float, float]]] = defaultdict(list)
    node_boundary: dict[str, bool] = {}
    node_hz: dict[str, Optional[float]] = {}
    for ev in power_events:
        if ev.key != "power_w":
            continue
        md = ev.metadata or {}
        node = md.get("node", "sut")
        by_node[node].append((ev.time_ms, float(ev.value)))
        node_hz.setdefault(node, md.get("sample_hz"))
        # a channel marked boundary=False is a per-component breakdown
        # inside another channel's boundary: report it per-node, but
        # never sum it into the total (that would double-count the
        # wall).  Samples without the flag (single-source logs, multi-
        # node training logs) keep the legacy sum-over-nodes semantics.
        node_boundary.setdefault(node, bool(md.get("boundary", True)))

    per_node_j = {}
    n_samples = 0
    coverage = {}
    for node, samples in by_node.items():
        samples.sort()
        t = np.asarray([s[0] for s in samples])
        w = np.asarray([s[1] for s in samples])
        sel = (t >= start_ms) & (t <= stop_ms)
        n_samples += int(sel.sum())
        hz = node_hz.get(node)
        if hz:
            coverage[node] = float(
                min(1.0, sel.sum() / max(window_s * float(hz), 1.0)))
        if sel.sum() < 2:
            per_node_j[node] = 0.0
            continue
        per_node_j[node] = _trapz(w[sel], t[sel] / 1e3)
    boundary_nodes = tuple(sorted(n for n, b in node_boundary.items()
                                  if b))
    energy = float(sum(per_node_j[n] for n in boundary_nodes))

    notes = []
    degraded = {n: c for n, c in coverage.items() if c < 0.99}
    if degraded:
        worst = min(degraded, key=degraded.get)
        notes.append(f"degraded sample coverage: "
                     f"{len(degraded)} channel(s), worst {worst} at "
                     f"{degraded[worst]:.1%}")
    switch_j = 0.0
    if switch_estimate is not None:
        switch_j = float(switch_estimate["watts"]) * window_s
        energy += switch_j
        notes.append(f"switch power estimated: "
                     f"{switch_estimate['methodology']}")

    # results reported by the SUT in the perf log
    processed = None
    for ev in perf_events:
        if ev.key in ("samples_processed", "result_samples"):
            processed = float(ev.value)

    summary = EnergySummary(
        window_s=window_s, energy_j=energy,
        avg_watts=energy / max(window_s, 1e-12),
        per_node_j=dict(per_node_j), n_samples=n_samples,
        samples_processed=processed, switch_energy_j=switch_j,
        notes=tuple(notes), boundary_nodes=boundary_nodes,
        channel_coverage=coverage)
    if processed:
        summary.samples_per_second = processed / window_s
        summary.samples_per_joule = processed / energy
        summary.inv_joules = processed / energy   # = 1/(J per inference)
    return summary


def energy_to_train(perf_events: list[LogEvent],
                    node_logs: dict[str, list[LogEvent]],
                    *, switch_estimate: Optional[dict] = None
                    ) -> EnergySummary:
    """Training/HPC variant: one power log per node, summed (§IV-C)."""
    merged: list[LogEvent] = []
    for node, events in node_logs.items():
        for ev in events:
            if ev.key == "power_w":
                md = dict(ev.metadata or {})
                md["node"] = node
                merged.append(LogEvent(ev.key, ev.value, ev.time_ms,
                                       ev.namespace, md))
    return summarize(perf_events, merged, switch_estimate=switch_estimate)
