"""Load generator: MLPerf Inference scenarios (the internal engine room).

This module holds the raw scenario runners; the public measurement API
is ``repro_torch.harness`` (``PowerRun(sut, scenario).run()``), which wraps
these runners together with the Director protocol, summarizer, and
compliance review.  Prefer the harness in examples/benchmarks; call the
runners directly only when composing a new scenario.

- ``SingleStream``: one query at a time, latency-bound (tiny/edge).
- ``MultiStream``: bursts of ``n_streams`` samples per query; the
  per-query latency is the completion time of the whole burst (MLPerf
  Inference edge rules; the metric is the p99 query latency).
- ``Offline``: all samples issued at once, throughput-bound.
- ``Server``: Poisson arrivals at a target QPS with latency SLO.
  Two forms: ``run_server`` (synchronous — each query blocks the SUT,
  queueing modelled analytically) and ``run_server_queue`` (the
  arrival schedule is handed to a continuous-batching engine's
  admission queue up front; the engine overlaps requests and reports
  per-request TTFT/TPOT, from which throughput and SLO compliance are
  derived).  ``run_server_trace`` is the trace-driven sibling: the
  caller supplies the whole arrival schedule explicitly (e.g. a
  compressed 24 h diurnal day from ``repro_torch.fleet.traces``) and shares
  the queue form's admission/shedding/metric semantics.

Implements the paper's minimum-duration rule: workloads shorter than
``min_duration_s`` (60 s by default) are looped until the threshold is
reached (§IV-A, principle four).

Copied from the reference ``src/repro/core/loadgen.py``; only its imports
differ.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from collections import Counter
from typing import Callable, Optional

import numpy as np

MIN_DURATION_S = 60.0


def nan_percentile(values: np.ndarray, p: float) -> float:
    """Percentile with the empty-run guard shared by every latency path.

    NaN entries (requests that never produced the timing being ranked,
    e.g. a shed query's TTFT) are ignored; empty and all-NaN runs
    return ``nan`` — with zero usable samples there is no defensible
    tie-break between "fastest" and "slowest", so we refuse to invent
    one rather than raise (or warn) mid-report.  A single finite sample
    is its own percentile for every ``p``.
    """
    values = np.asarray(values, float)
    if values.size:
        values = values[~np.isnan(values)]
    if values.size == 0:
        return float("nan")
    return float(np.percentile(values, p))


@dataclasses.dataclass
class QuerySampleLibrary:
    """Deterministic sample library (the QSL)."""

    n_samples: int
    make_sample: Callable[[int], dict]

    def sample(self, idx: int) -> dict:
        return self.make_sample(idx % self.n_samples)


@dataclasses.dataclass
class LoadgenResult:
    scenario: str
    n_queries: int
    duration_s: float
    latencies_s: np.ndarray
    qps: float
    min_duration_met: bool

    @functools.cached_property
    def _sorted_latencies(self) -> np.ndarray:
        """Latencies sorted once; every percentile access reuses it."""
        return np.sort(np.asarray(self.latencies_s, float))

    def percentile(self, p: float) -> float:
        """Percentile over the cached sorted array (sorted once; the
        p50/p90/p99 properties all reuse it); nan on empty runs
        (``nan_percentile``)."""
        return nan_percentile(self._sorted_latencies, p)

    @property
    def p50(self):
        return self.percentile(50)

    @property
    def p90(self):
        return self.percentile(90)

    @property
    def p99(self):
        return self.percentile(99)


class Clock:
    """Virtual clock so 60 s runs don't take 60 s of CPU in tests."""

    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def advance(self, dt_s: Optional[float] = None, *,
                dt: Optional[float] = None):
        if dt is not None:               # deprecated unsuffixed alias
            warnings.warn(
                "Clock.advance(dt=...) is deprecated; the argument is "
                "seconds — pass dt_s=", DeprecationWarning,
                stacklevel=2)
            dt_s = dt
        if dt_s is None:
            raise TypeError("Clock.advance() missing dt_s")
        if dt_s < 0:
            raise ValueError(
                f"Clock.advance({dt_s!r}): negative dt_s would run the "
                f"virtual clock backwards (now={self.t!r}); measurement "
                f"windows must be monotonic")
        self.t += dt_s


def run_single_stream(issue: Callable[[dict], float], qsl: QuerySampleLibrary,
                      *, min_duration_s: float = MIN_DURATION_S,
                      min_queries: int = 64,
                      clock: Optional[Clock] = None) -> LoadgenResult:
    """``issue(sample) -> latency_s`` (the SUT runs one query)."""
    clock = clock or Clock()
    lat = []
    i = 0
    t0 = clock.now()
    while (clock.now() - t0 < min_duration_s) or (i < min_queries):
        dt_s = issue(qsl.sample(i))
        lat.append(dt_s)
        clock.advance(dt_s)
        i += 1
    dur = clock.now() - t0
    return LoadgenResult("SingleStream", i, dur, np.asarray(lat),
                         qps=i / dur, min_duration_met=dur >= min_duration_s)


def run_multi_stream(issue_burst: Callable[[list[dict]], float],
                     qsl: QuerySampleLibrary, *, n_streams: int = 8,
                     min_duration_s: float = MIN_DURATION_S,
                     min_queries: int = 270,
                     clock: Optional[Clock] = None) -> LoadgenResult:
    """MultiStream: each query is a burst of ``n_streams`` samples.

    ``issue_burst(samples) -> latency_s`` services one whole burst; the
    recorded per-query latency is the time for *all* of its samples to
    complete (MLPerf Inference edge rules — the reported metric is the
    p99 of these query latencies).  ``min_queries`` defaults to the
    MLPerf minimum query count for the scenario (270).

    ``n_queries`` counts queries (bursts); ``qps`` reports samples/s
    (``n_queries * n_streams / duration``) so throughput metrics stay
    comparable with Offline.
    """
    clock = clock or Clock()
    lat = []
    i = 0
    t0 = clock.now()
    while (clock.now() - t0 < min_duration_s) or (i < min_queries):
        burst = [qsl.sample(i * n_streams + j) for j in range(n_streams)]
        dt_s = issue_burst(burst)
        lat.append(dt_s)
        clock.advance(dt_s)
        i += 1
    dur = clock.now() - t0
    return LoadgenResult("MultiStream", i, dur, np.asarray(lat),
                         qps=i * n_streams / dur,
                         min_duration_met=dur >= min_duration_s)


def run_offline(issue_batch: Callable[[list[dict]], float],
                qsl: QuerySampleLibrary, *, batch: int,
                min_duration_s: float = MIN_DURATION_S,
                clock: Optional[Clock] = None) -> LoadgenResult:
    """``issue_batch(samples) -> seconds``; loops batches to 60 s."""
    clock = clock or Clock()
    t0 = clock.now()
    n = 0
    times = []
    while clock.now() - t0 < min_duration_s or n == 0:
        dt_s = issue_batch([qsl.sample(n + j) for j in range(batch)])
        clock.advance(dt_s)
        times.append(dt_s)
        n += batch
    dur = clock.now() - t0
    per_sample = np.repeat(np.asarray(times) / batch, batch)
    return LoadgenResult("Offline", n, dur, per_sample, qps=n / dur,
                         min_duration_met=dur >= min_duration_s)


def run_server(issue: Callable[[dict], float], qsl: QuerySampleLibrary, *,
               target_qps: float, latency_slo_s: float,
               min_duration_s: float = MIN_DURATION_S,
               seed: int = 0, min_queries: int = 32,
               clock: Optional[Clock] = None) -> tuple[LoadgenResult, bool]:
    """Poisson arrivals; returns (result, slo_met at p99).

    ``min_queries`` extends the run past ``min_duration_s`` until at
    least that many queries were issued (mirrors ``poisson_arrivals``).
    """
    rng = np.random.default_rng(seed)
    clock = clock or Clock()
    t0 = clock.now()
    lat = []
    i = 0
    next_free = t0
    t_arrive = t0
    while t_arrive - t0 < min_duration_s or i < min_queries:
        t_arrive += rng.exponential(1.0 / target_qps)
        service = issue(qsl.sample(i))
        start = max(t_arrive, next_free)          # queueing
        next_free = start + service
        lat.append(next_free - t_arrive)
        i += 1
    clock.advance(next_free - t0)
    dur = next_free - t0
    res = LoadgenResult("Server", i, dur, np.asarray(lat), qps=i / dur,
                        min_duration_met=dur >= min_duration_s)
    return res, res.p99 <= latency_slo_s


def poisson_arrivals(target_qps: float, *,
                     min_duration_s: float = MIN_DURATION_S,
                     seed: int = 0, min_queries: int = 32) -> np.ndarray:
    """Poisson arrival schedule (seconds from run start), extended past
    ``min_duration_s`` until at least ``min_queries`` queries exist."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    while t < min_duration_s or len(out) < min_queries:
        t += rng.exponential(1.0 / target_qps)
        out.append(t)
    return np.asarray(out)


@dataclasses.dataclass(frozen=True)
class ShedPolicy:
    """Admission-control load shedding (leaky bucket over arrivals).

    The queue runner models the admission side of overload: the bucket
    drains at ``drain_qps`` (the rate the fleet can sustain) and holds
    at most ``max_queue`` outstanding arrivals.  An arrival that finds
    the bucket full is *shed* — never handed to the engine, counted in
    ``ServerMetrics.n_shed`` — instead of silently inflating the tail
    latency of everything behind it.
    """

    max_queue: int = 64
    drain_qps: Optional[float] = None   # default: 1.5x the target rate

    def shed_mask(self, arrivals_s: np.ndarray,
                  target_qps: float) -> np.ndarray:
        drain = self.drain_qps if self.drain_qps else 1.5 * target_qps
        level, last = 0.0, 0.0
        mask = np.zeros(len(arrivals_s), dtype=bool)
        for i, t in enumerate(arrivals_s):
            level = max(0.0, level - (float(t) - last) * drain)
            last = float(t)
            if level >= self.max_queue:
                mask[i] = True        # bucket full: shed this arrival
            else:
                level += 1.0
        return mask


@dataclasses.dataclass
class ServerMetrics:
    """Queue-driven Server-scenario outcome (continuous batching).

    ``result``/latency stats cover *goodput* — queries completed within
    their deadline.  The robustness counters make degradation explicit:
    ``n_admitted`` queries reached the engine, ``n_shed`` were refused
    at admission (``ShedPolicy``), ``n_timeout`` completed past the
    per-request deadline and are excluded from the latency stats.
    """

    result: LoadgenResult            # end-to-end latency per query
    slo_met: bool                    # p99 end-to-end <= SLO
    ttft_s: np.ndarray               # time to first token per query
    tpot_s: np.ndarray               # per-token decode cadence
    total_tokens: int
    tokens_per_s: float
    n_admitted: int = 0
    n_shed: int = 0
    n_timeout: int = 0
    # per-token tail SLOs (None = not constrained this run): a query
    # meets the tail when its TTFT and its own decode cadence both do
    ttft_slo_s: Optional[float] = None
    tpot_slo_s: Optional[float] = None
    n_tail_miss: int = 0             # completed but blew a tail SLO

    def ttft_p(self, p: float) -> float:
        return nan_percentile(self.ttft_s, p)

    def tpot_p(self, p: float) -> float:
        return nan_percentile(self.tpot_s, p)

    @property
    def tpot_mean(self) -> float:
        """Mean decode cadence; nan on runs with no multi-token request
        (same empty-run guard as the percentile paths)."""
        if self.tpot_s.size == 0:
            return float("nan")
        return float(np.mean(self.tpot_s))

    @property
    def slo_attainment(self) -> float:
        """Fraction of offered queries that completed within deadline
        (goodput over offered load, counting shed + timed-out against)."""
        offered = self.result.n_queries + self.n_shed + self.n_timeout
        if offered == 0:
            return float("nan")
        return self.result.n_queries / offered

    @property
    def tail_attainment(self) -> float:
        """Fraction of offered queries that met *both* per-token tail
        SLOs (TTFT and TPOT), shed and timed-out queries counting
        against — the Server metric the SLO sweep maximises QPS over.
        ``nan`` when the run set no tail SLO."""
        if self.ttft_slo_s is None and self.tpot_slo_s is None:
            return float("nan")
        offered = self.result.n_queries + self.n_shed + self.n_timeout
        if offered == 0:
            return float("nan")
        return (self.result.n_queries - self.n_tail_miss) / offered


def qid_of(sample, fallback: int) -> int:
    """The loadgen-assigned unique query id of a sample, else the
    caller's enumerate index.  Request builders must use this (not the
    bare index) for request ids: samples wrap modulo the QSL size and
    replicas each enumerate only their share of the queue."""
    if isinstance(sample, dict) and "qid" in sample:
        return sample["qid"]
    return fallback


def run_server_queue(serve: Callable[[list[tuple[dict, float]]], list],
                     qsl: QuerySampleLibrary, *, target_qps: float,
                     latency_slo_s: float,
                     min_duration_s: float = MIN_DURATION_S,
                     seed: int = 0,
                     min_queries: int = 32,
                     deadline_s: Optional[float] = None,
                     shed: Optional[ShedPolicy] = None,
                     fault_plan=None,
                     ttft_slo_s: Optional[float] = None,
                     tpot_slo_s: Optional[float] = None) -> ServerMetrics:
    """Server scenario against an asynchronous admission queue.

    The whole Poisson arrival schedule is generated up front and handed
    to ``serve(arrivals)`` — ``arrivals`` is a list of ``(sample,
    arrival_s)`` — which feeds an engine's admission queue and returns
    completed records carrying ``arrival_s`` / ``first_token_s`` /
    ``done_s`` / ``output`` on one clock with t=0 at serve start (the
    ``repro_torch.serving.Request`` contract).  Unlike ``run_server``, the
    SUT is free to overlap requests (continuous batching), so the
    latency distribution reflects real queueing + mid-flight admission.

    Each sample dict carries a ``qid`` — the loadgen-assigned unique
    query id.  QSL samples wrap modulo the library size (the
    performance sample set), so ``qid``, not the sample index, is what
    request builders must use for request ids: it stays unique when the
    schedule outruns the QSL and when replicas split one queue.

    Robustness knobs (all default off):

    - ``fault_plan`` (``repro_torch.faults.FaultPlan``): any ``QueueOverload``
      faults splice seeded burst arrivals into the Poisson schedule.
    - ``shed`` (``ShedPolicy``): overload-triggered load shedding at
      admission; shed queries never reach ``serve`` and are counted in
      ``ServerMetrics.n_shed``.
    - ``deadline_s``: per-request deadline.  Queries completing past it
      count as ``n_timeout`` and are excluded from the latency/token
      stats (goodput semantics).

    Tail SLOs (``ttft_slo_s`` / ``tpot_slo_s``, seconds, default
    unconstrained): per-query time-to-first-token and per-token decode
    cadence bounds.  Completed queries that blow either count in
    ``n_tail_miss`` (they stay in the latency stats — they *did*
    complete) and ``ServerMetrics.tail_attainment`` reports the
    fraction of offered queries meeting both; when set, ``slo_met``
    additionally requires p99 TTFT/TPOT within the bounds.

    Query-id conservation is enforced whenever the completed records
    carry rids (the ``repro_torch.serving.Request`` contract): every
    admitted qid must come back exactly once.  Duplicate, fabricated,
    or lost qids raise ``ValueError`` naming the colliding/missing ids
    — a crashing replica must re-dispatch, not drop or double-serve.
    """
    arrivals = poisson_arrivals(target_qps, min_duration_s=min_duration_s,
                                seed=seed, min_queries=min_queries)
    times = [float(a) for a in arrivals]
    if fault_plan is not None:
        times = sorted(times + [float(b)
                                for b in fault_plan.burst_arrivals()])
    return _serve_schedule(serve, qsl, times, target_qps=target_qps,
                           latency_slo_s=latency_slo_s,
                           min_duration_s=min_duration_s,
                           deadline_s=deadline_s, shed=shed,
                           ttft_slo_s=ttft_slo_s, tpot_slo_s=tpot_slo_s)


def run_server_trace(serve: Callable[[list[tuple[dict, float]]], list],
                     qsl: QuerySampleLibrary, *, arrivals_s,
                     latency_slo_s: float,
                     min_duration_s: float = 0.0,
                     deadline_s: Optional[float] = None,
                     shed: Optional[ShedPolicy] = None,
                     fault_plan=None,
                     ttft_slo_s: Optional[float] = None,
                     tpot_slo_s: Optional[float] = None,
                     target_qps: Optional[float] = None) -> ServerMetrics:
    """Server scenario driven by an *explicit* arrival schedule.

    The trace-driven sibling of ``run_server_queue``: instead of
    generating Poisson arrivals at a constant ``target_qps``, the
    caller hands the whole schedule (``arrivals_s`` — seconds from run
    start, e.g. a compressed 24 h ``repro_torch.fleet.traces`` diurnal day)
    and the admission, shedding, conservation, and metric semantics
    are shared verbatim with the Poisson form.  ``target_qps``
    defaults to the trace's mean rate (it only feeds ``ShedPolicy``'s
    default drain rate); ``fault_plan`` burst arrivals splice into the
    schedule exactly as in the Poisson form.
    """
    times = sorted(float(a) for a in np.asarray(arrivals_s, float))
    if any(t < 0 for t in times):
        raise ValueError("run_server_trace: negative arrival time in "
                         "the schedule")
    if fault_plan is not None:
        times = sorted(times + [float(b)
                                for b in fault_plan.burst_arrivals()])
    if target_qps is None:
        span = times[-1] if times else 0.0
        target_qps = len(times) / span if span > 0 else 1.0
    return _serve_schedule(serve, qsl, times, target_qps=target_qps,
                           latency_slo_s=latency_slo_s,
                           min_duration_s=min_duration_s,
                           deadline_s=deadline_s, shed=shed,
                           ttft_slo_s=ttft_slo_s, tpot_slo_s=tpot_slo_s)


def _serve_schedule(serve, qsl, times: list, *, target_qps: float,
                    latency_slo_s: float, min_duration_s: float,
                    deadline_s: Optional[float],
                    shed: Optional[ShedPolicy],
                    ttft_slo_s: Optional[float],
                    tpot_slo_s: Optional[float]) -> ServerMetrics:
    """Shared admission + serve + metrics body of the two Server
    forms: qid stamping, shedding, conservation checks, goodput
    accounting, and tail-SLO attainment over one explicit arrival-time
    list."""
    queries = [(dict(qsl.sample(i), qid=i), t)
               for i, t in enumerate(times)]

    n_shed = 0
    if shed is not None:
        mask = shed.shed_mask(np.asarray(times), target_qps)
        n_shed = int(mask.sum())
        queries = [q for q, drop in zip(queries, mask) if not drop]

    admitted = [int(s["qid"]) for s, _ in queries]
    dup_admitted = sorted({q for q, c in Counter(admitted).items() if c > 1})
    if dup_admitted:
        raise ValueError(
            f"duplicate qids in admission queue: {dup_admitted} — the "
            f"query-id space must be unique per run")

    recs = serve(queries)

    rids = [getattr(r, "rid", None) for r in recs]
    if all(r is not None for r in rids):
        returned = [int(r) for r in rids]
        dup = sorted({q for q, c in Counter(returned).items() if c > 1})
        if dup:
            raise ValueError(
                f"qids completed more than once: {dup} — a retried "
                f"query must be deduplicated, not double-served")
        extra = sorted(set(returned) - set(admitted))
        if extra:
            raise ValueError(
                f"completed qids never admitted: {extra} — the SUT "
                f"fabricated or renumbered requests")
        lost = sorted(set(admitted) - set(returned))
        if lost:
            raise ValueError(
                f"admitted qids never completed: {lost} — a crashed "
                f"replica's queries must be re-dispatched to survivors")

    n_timeout = 0
    done = recs
    if deadline_s is not None:
        done = [r for r in recs if r.done_s - r.arrival_s <= deadline_s]
        n_timeout = len(recs) - len(done)

    lat = np.asarray([r.done_s - r.arrival_s for r in done])
    ttft = np.asarray([r.first_token_s - r.arrival_s for r in done])
    tpot = np.asarray([(r.done_s - r.first_token_s)
                       / max(1, len(r.output) - 1)
                       for r in done if len(r.output or []) > 1])
    n_tail_miss = 0
    if ttft_slo_s is not None or tpot_slo_s is not None:
        for r in done:
            miss = (ttft_slo_s is not None
                    and r.first_token_s - r.arrival_s > ttft_slo_s)
            if not miss and tpot_slo_s is not None \
                    and len(r.output or []) > 1:
                cadence = ((r.done_s - r.first_token_s)
                           / (len(r.output) - 1))
                miss = cadence > tpot_slo_s
            n_tail_miss += bool(miss)
    dur = max((r.done_s for r in recs), default=0.0)
    res = LoadgenResult("Server", len(done), dur, lat,
                        qps=len(done) / dur if dur else 0.0,
                        min_duration_met=dur >= min_duration_s)
    total_tokens = sum(len(r.output or []) for r in done)
    slo = res.p99 <= latency_slo_s
    if ttft_slo_s is not None:
        slo = slo and nan_percentile(ttft, 99) <= ttft_slo_s
    if tpot_slo_s is not None and tpot.size:
        slo = slo and nan_percentile(tpot, 99) <= tpot_slo_s
    return ServerMetrics(res, bool(slo), ttft, tpot,
                         total_tokens,
                         total_tokens / dur if dur else 0.0,
                         n_admitted=len(admitted), n_shed=n_shed,
                         n_timeout=n_timeout,
                         ttft_slo_s=ttft_slo_s, tpot_slo_s=tpot_slo_s,
                         n_tail_miss=n_tail_miss)


def loops_for_min_duration(workload_s: float,
                           min_duration_s: float = MIN_DURATION_S) -> int:
    """How many times to loop a short workload (paper §IV-A)."""
    return max(1, math.ceil(min_duration_s / max(workload_s, 1e-9)))
