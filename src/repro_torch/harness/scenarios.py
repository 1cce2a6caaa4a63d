"""First-class MLPerf Inference scenarios.

Each scenario is a small config dataclass with a ``run(sut, qsl,
clock)`` method that drives the matching ``repro_torch.core.loadgen`` runner
against the SUT's issue surface and returns a uniform
``ScenarioOutcome``.  Adding a scenario means adding one dataclass
here — the Director protocol, summarizer, and compliance review in
``PowerRun`` are scenario-agnostic.

- ``SingleStream`` — one query at a time (latency metric).
- ``MultiStream`` — n-sample bursts with per-burst latency (MLPerf
  Inference edge rules; p99 query latency metric).
- ``Offline``   — maximal batches (throughput metric).
- ``Server``    — Poisson arrivals at a target QPS with a latency SLO;
  ``mode`` picks the synchronous form or the queue-driven form
  (continuous-batching admission queue, TTFT/TPOT metrics), or
  ``"auto"`` to use the queue whenever the SUT has one.

Copied from the reference ``src/repro/harness/scenarios.py``; only its imports
differ.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.loadgen import (Clock, LoadgenResult, QuerySampleLibrary,
                                ServerMetrics, MIN_DURATION_S,
                                run_multi_stream, run_offline, run_server,
                                run_server_queue, run_server_trace,
                                run_single_stream)


@dataclasses.dataclass
class ScenarioOutcome:
    """Uniform result of one scenario run, scenario-specific extras
    included (``server`` is populated by the queue-driven Server)."""

    scenario: str
    result: LoadgenResult
    samples_processed: float
    slo_met: Optional[bool] = None
    server: Optional[ServerMetrics] = None

    @property
    def metric(self) -> float:
        """The scenario's reported metric: p90/p99 latency for the
        latency-bound scenarios, samples/s for the throughput-bound."""
        if self.scenario == "SingleStream":
            return self.result.p90
        if self.scenario == "MultiStream":
            return self.result.p99
        return self.result.qps


@dataclasses.dataclass
class Scenario:
    """Base config shared by every scenario."""

    min_duration_s: float = MIN_DURATION_S
    name = "Scenario"

    def run(self, sut, qsl: QuerySampleLibrary,
            clock: Optional[Clock] = None) -> ScenarioOutcome:
        """Drive ``sut`` with this scenario's load pattern and return
        the measured ``ScenarioOutcome`` (each subclass maps onto one
        ``repro_torch.core.loadgen`` runner)."""
        raise NotImplementedError


@dataclasses.dataclass
class SingleStream(Scenario):
    min_queries: int = 64
    name = "SingleStream"

    def run(self, sut, qsl, clock=None):
        res = run_single_stream(sut.issue, qsl,
                                min_duration_s=self.min_duration_s,
                                min_queries=self.min_queries,
                                clock=clock or Clock())
        return ScenarioOutcome("SingleStream", res, res.n_queries)


@dataclasses.dataclass
class MultiStream(Scenario):
    """Bursts of ``n_streams`` samples per query; latency of a query is
    the completion time of its whole burst (edge rules).  The MLPerf
    minimum query count for the scenario is 270."""

    n_streams: int = 8
    min_queries: int = 270
    name = "MultiStream"

    def run(self, sut, qsl, clock=None):
        res = run_multi_stream(sut.issue_batch, qsl,
                               n_streams=self.n_streams,
                               min_duration_s=self.min_duration_s,
                               min_queries=self.min_queries,
                               clock=clock or Clock())
        return ScenarioOutcome("MultiStream", res,
                               res.n_queries * self.n_streams)


@dataclasses.dataclass
class Offline(Scenario):
    batch: int = 4
    name = "Offline"

    def run(self, sut, qsl, clock=None):
        res = run_offline(sut.issue_batch, qsl, batch=self.batch,
                          min_duration_s=self.min_duration_s,
                          clock=clock or Clock())
        return ScenarioOutcome("Offline", res, res.n_queries)


@dataclasses.dataclass
class Server(Scenario):
    """Poisson arrivals at ``target_qps`` under ``latency_slo_s``.

    ``mode="sync"`` issues blocking queries with analytic queueing
    (``run_server``); ``mode="queue"`` hands the whole arrival schedule
    to the SUT's admission queue (``run_server_queue``) and reports
    TTFT/TPOT; ``mode="auto"`` prefers the queue when the SUT's
    ``supports_serve_queue()`` hook says one exists.

    The robustness knobs (queue mode only) pass straight through to
    ``run_server_queue``: ``deadline_s`` per-request deadlines,
    ``shed`` (a ``repro_torch.core.loadgen.ShedPolicy``) admission-control
    load shedding, and ``fault_plan`` (``repro_torch.faults.FaultPlan``)
    queue-overload burst splicing.  ``ttft_slo_s``/``tpot_slo_s``
    (seconds, queue mode only) add per-token tail SLOs: ``slo_met``
    then also requires p99 TTFT/TPOT within bounds, and
    ``ServerMetrics.tail_attainment`` reports the per-query fraction
    meeting both — the constraint the SLO sweep maximises QPS under.
    """

    target_qps: float = 4.0
    latency_slo_s: float = 10.0
    mode: str = "auto"               # auto | sync | queue
    min_queries: int = 32
    seed: int = 0
    deadline_s: Optional[float] = None
    shed: Optional[object] = None    # loadgen.ShedPolicy
    fault_plan: Optional[object] = None   # faults.FaultPlan
    ttft_slo_s: Optional[float] = None
    tpot_slo_s: Optional[float] = None
    name = "Server"

    def _use_queue(self, sut) -> bool:
        if self.mode in ("sync", "queue"):
            return self.mode == "queue"
        # auto mode trusts only the explicit capability hook: a bare
        # ``serve_queue`` attribute may be a NotImplementedError stub
        # (the SUT protocol allows partial surfaces), so its presence
        # alone proves nothing.  SUTs without the hook run sync; pass
        # mode="queue" to force the queue path.
        probe = getattr(sut, "supports_serve_queue", None)
        return bool(probe()) if probe is not None else False

    def run(self, sut, qsl, clock=None):
        if self._use_queue(sut):
            m = run_server_queue(sut.serve_queue, qsl,
                                 target_qps=self.target_qps,
                                 latency_slo_s=self.latency_slo_s,
                                 min_duration_s=self.min_duration_s,
                                 seed=self.seed,
                                 min_queries=self.min_queries,
                                 deadline_s=self.deadline_s,
                                 shed=self.shed,
                                 fault_plan=self.fault_plan,
                                 ttft_slo_s=self.ttft_slo_s,
                                 tpot_slo_s=self.tpot_slo_s)
            return ScenarioOutcome("Server", m.result,
                                   m.result.n_queries,
                                   slo_met=m.slo_met, server=m)
        res, slo = run_server(sut.issue, qsl, target_qps=self.target_qps,
                              latency_slo_s=self.latency_slo_s,
                              min_duration_s=self.min_duration_s,
                              seed=self.seed,
                              min_queries=self.min_queries,
                              clock=clock or Clock())
        return ScenarioOutcome("Server", res, res.n_queries, slo_met=slo)


@dataclasses.dataclass
class TraceServer(Scenario):
    """Server scenario driven by an explicit arrival trace.

    ``trace`` is either a ``repro_torch.fleet.traces.ArrivalTrace`` or a raw
    array of arrival seconds; the whole schedule is handed to the
    SUT's admission queue via ``run_server_trace`` (queue form only —
    a trace has no synchronous analogue).  All the queue-form
    robustness knobs (``deadline_s`` / ``shed`` / ``fault_plan`` /
    ``ttft_slo_s`` / ``tpot_slo_s``) pass straight through, so a
    compressed 24 h diurnal day runs under exactly the Server
    scenario's admission, conservation, and tail-SLO semantics.
    ``min_duration_s`` defaults to 0: the trace's horizon, not the
    paper's 60 s floor, decides the window (pass the floor explicitly
    when compliance should enforce it).
    """

    trace: Optional[object] = None   # ArrivalTrace | array of seconds
    latency_slo_s: float = 10.0
    min_duration_s: float = 0.0
    deadline_s: Optional[float] = None
    shed: Optional[object] = None    # loadgen.ShedPolicy
    fault_plan: Optional[object] = None   # faults.FaultPlan
    ttft_slo_s: Optional[float] = None
    tpot_slo_s: Optional[float] = None
    name = "TraceServer"

    def arrivals_s(self):
        """The schedule as raw arrival seconds (trace-type agnostic)."""
        if self.trace is None:
            raise ValueError("TraceServer needs a trace (ArrivalTrace "
                             "or an array of arrival seconds)")
        return getattr(self.trace, "arrivals_s", self.trace)

    def run(self, sut, qsl, clock=None):
        probe = getattr(sut, "supports_serve_queue", None)
        if probe is not None and not probe():
            raise NotImplementedError(
                f"TraceServer needs an admission queue; "
                f"{getattr(sut, 'name', 'sut')} has none")
        m = run_server_trace(sut.serve_queue, qsl,
                             arrivals_s=self.arrivals_s(),
                             latency_slo_s=self.latency_slo_s,
                             min_duration_s=self.min_duration_s,
                             deadline_s=self.deadline_s,
                             shed=self.shed,
                             fault_plan=self.fault_plan,
                             ttft_slo_s=self.ttft_slo_s,
                             tpot_slo_s=self.tpot_slo_s)
        return ScenarioOutcome("Server", m.result, m.result.n_queries,
                               slo_met=m.slo_met, server=m)


SCENARIOS = {
    "single-stream": SingleStream,
    "multi-stream": MultiStream,
    "offline": Offline,
    "server": Server,
    "trace-server": TraceServer,
}
