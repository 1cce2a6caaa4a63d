"""Deterministic event-driven fleet simulator.

``FleetSim`` plays an explicit admission schedule (the ``serve_queue``
query list) against a fleet of modeled replicas in virtual time: a
heapq of (time, seq) events covers arrivals, request completions,
cold-start readiness, controller ticks, and fault-plan replica
crashes.  Every replica bills its wall draw into its own
``PowerTrace`` breakpoint by breakpoint — cold-start surges, warm-idle
floors, DVFS-capped busy draw — so the fleet's pdu total is exactly
the sum of replica walls (R11) and the energy ledger
(``idle_j`` / ``cold_start_j`` / ``busy_j``) is an exact partition of
it.

Service model: a request dispatched to replica ``r`` at clock fraction
``f`` sees ``first_token = start + prefill/throughput_scale(f)`` and
then one token per ``tpot_s(f)`` until its output length is done; a
slot is held for the full span.  Crashes requeue the victim's
in-flight requests (original arrival kept, so loadgen's qid
conservation holds) and the controller re-scales on its next tick.

Determinism: no wall clock, no RNG — identical inputs replay the
identical event sequence (heap ties broken by a monotone sequence
number).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import deque
from typing import Optional, Sequence

from repro_torch.fleet.controller import FleetController, Observation
from repro_torch.fleet.lifecycle import (BUSY, COLD, DEAD, DRAINING, STARTING,
                                   WARM_IDLE, PowerTrace, ReplicaSpec)
from repro_torch.fleet.routing import LeastLoaded, ReplicaView, Router


@dataclasses.dataclass
class FleetRecord:
    """One completed request, in the loadgen Server record shape."""

    rid: int
    arrival_s: float
    first_token_s: float
    done_s: float
    output: list
    replica: int = 0


@dataclasses.dataclass
class _Request:
    rid: int
    arrival_s: float
    n_out: int


class _Replica:
    """Mutable runtime state of one fleet replica."""

    def __init__(self, index: int, spec: ReplicaSpec, *,
                 warm: bool, freq: float):
        self.index = index
        self.spec = spec
        self.freq = freq
        self.state = WARM_IDLE if warm else COLD
        self.busy_slots = 0
        self.active: dict[int, _Request] = {}
        w0 = spec.idle_w if warm else 0.0
        self.trace = PowerTrace(0.0, w0)
        # capacity actually provisioned (peak draw while live, 0 cold)
        self.provision = PowerTrace(0.0, spec.peak_w(freq) if warm
                                    else 0.0)
        self.state_t0_s = 0.0
        self.time_in_state_s = {s: 0.0 for s in
                                (COLD, STARTING, WARM_IDLE, BUSY,
                                 DRAINING, DEAD)}

    def _enter(self, t_s: float, state: str) -> None:
        self.time_in_state_s[self.state] += t_s - self.state_t0_s
        self.state, self.state_t0_s = state, t_s

    def close(self, t_s: float) -> None:
        """Flush the open state interval at end of simulation."""
        self.time_in_state_s[self.state] += t_s - self.state_t0_s
        self.state_t0_s = t_s

    @property
    def live(self) -> bool:
        """Counted against the controller's target (not cold/dead)."""
        return self.state in (STARTING, WARM_IDLE, BUSY, DRAINING)

    @property
    def admitting(self) -> bool:
        return self.state in (WARM_IDLE, BUSY)

    def watts_now(self) -> float:
        if self.state in (COLD, DEAD):
            return 0.0
        if self.state == STARTING:
            return self.spec.cold_start_w
        return self.spec.watts(self.busy_slots, self.freq)

    def repaint(self, t_s: float) -> None:
        """Re-bill the wall trace after any state/occupancy change."""
        self.trace.set_watts(t_s, self.watts_now())
        self.provision.set_watts(
            t_s, self.spec.peak_w(self.freq) if self.live else 0.0)


class FleetSim:
    """Simulate one admission schedule against an autoscaled fleet.

    ``specs`` lists every replica the fleet may ever use (the
    controller scales within them, heterogeneous mixes welcome);
    ``initial_warm`` of them start warm, the rest cold.  ``controller``
    ``None`` pins the fleet static at ``initial_warm``.  ``cap_w``
    applies a per-replica DVFS power cap (watts) fleet-wide.
    ``fault_plan`` is a ``repro_torch.faults.FaultPlan`` whose
    ``ReplicaCrash`` entries kill replicas mid-run.
    """

    def __init__(self, specs: Sequence[ReplicaSpec], *,
                 initial_warm: Optional[int] = None,
                 controller: Optional[FleetController] = None,
                 router: Optional[Router] = None,
                 control_interval_s: float = 1.0,
                 cap_w: Optional[float] = None,
                 default_out_tokens: int = 16,
                 rate_window_s: Optional[float] = None,
                 fault_plan=None):
        if not specs:
            raise ValueError("FleetSim needs at least one ReplicaSpec")
        self.specs = list(specs)
        self.controller = controller
        self.router = router if router is not None else LeastLoaded()
        self.control_interval_s = float(control_interval_s)
        self.cap_w = cap_w
        self.default_out_tokens = int(default_out_tokens)
        self.rate_window_s = (rate_window_s if rate_window_s is not None
                              else 10.0 * self.control_interval_s)
        self.fault_plan = fault_plan
        n_warm = len(specs) if initial_warm is None else int(initial_warm)
        if not 0 <= n_warm <= len(specs):
            raise ValueError(f"initial_warm {n_warm} outside fleet "
                             f"size {len(specs)}")
        if controller is not None:
            n_warm = max(n_warm, controller.min_replicas)
        self.replicas = [
            _Replica(i, s, warm=i < n_warm,
                     freq=s.freq_for_cap_w(cap_w))
            for i, s in enumerate(self.specs)]
        self.pending: deque[_Request] = deque()
        self.records: list[FleetRecord] = []
        self.cold_starts = 0
        self.n_crashed = 0
        self.n_requeued = 0
        self.end_s = 0.0
        self._recent_arrivals: deque[float] = deque()
        self._dispatch_ids = itertools.count()
        self._heap: list = []
        self._seq = itertools.count()

    # -- event plumbing -------------------------------------------------
    def _push(self, t_s: float, kind: str, payload=None) -> None:
        heapq.heappush(self._heap, (t_s, next(self._seq), kind, payload))

    # -- fleet views ----------------------------------------------------
    def _views(self) -> list[ReplicaView]:
        return [ReplicaView(r.index, r.spec, r.busy_slots, r.freq)
                for r in self.replicas if r.admitting]

    def _observe(self, t_s: float) -> Observation:
        while self._recent_arrivals and \
                self._recent_arrivals[0] < t_s - self.rate_window_s:
            self._recent_arrivals.popleft()
        window = min(self.rate_window_s, max(t_s, 1e-9))
        warm = [r for r in self.replicas if r.admitting or
                r.state == DRAINING]
        svc = [s.tokens_per_s / max(self.default_out_tokens, 1)
               for s in self.specs]
        return Observation(
            time_s=t_s,
            queue_depth=len(self.pending),
            inflight=sum(r.busy_slots for r in self.replicas),
            n_warm=len(warm),
            n_starting=sum(r.state == STARTING for r in self.replicas),
            slots_total=sum(r.spec.n_slots for r in self.replicas
                            if r.admitting),
            arrival_qps=len(self._recent_arrivals) / window,
            service_qps_per_replica=sum(svc) / len(svc),
            ttft_slo_s=getattr(self.controller, "ttft_slo_s", None))

    # -- scaling actions ------------------------------------------------
    def _scale_to(self, t_s: float, target: int) -> None:
        live = [r for r in self.replicas if r.live]
        if len(live) < target:
            cold = [r for r in self.replicas if r.state == COLD]
            for r in cold[:target - len(live)]:
                r._enter(t_s, STARTING)
                r.repaint(t_s)
                self.cold_starts += 1
                self._push(t_s + r.spec.cold_start_s, "ready", r.index)
        elif len(live) > target:
            # drain the emptiest admitting replicas first
            victims = sorted(
                (r for r in live if r.admitting),
                key=lambda r: (r.busy_slots, -r.index))
            for r in victims[:len(live) - target]:
                if r.busy_slots == 0:
                    r._enter(t_s, COLD)
                else:
                    r._enter(t_s, DRAINING)
                r.repaint(t_s)

    def _on_ready(self, t_s: float, idx: int) -> None:
        r = self.replicas[idx]
        if r.state != STARTING:      # crashed (or drained) mid-start
            return
        r._enter(t_s, WARM_IDLE)
        r.repaint(t_s)
        self._dispatch(t_s)

    def _on_crash(self, t_s: float, idx: int) -> None:
        r = self.replicas[idx]
        if r.state == DEAD:
            return
        orphans = list(r.active.values())
        r.active.clear()
        r.busy_slots = 0
        r._enter(t_s, DEAD)
        r.repaint(t_s)
        self.n_crashed += 1
        self.n_requeued += len(orphans)
        # re-dispatch to survivors, original arrival kept: loadgen's
        # qid-conservation check sees every admitted rid complete once
        self.pending.extendleft(reversed(orphans))
        self._dispatch(t_s)

    # -- serving --------------------------------------------------------
    def _dispatch(self, t_s: float) -> None:
        while self.pending:
            views = self._views()
            pick = self.router.choose(views, t_s) if views else None
            if pick is None:
                return
            req = self.pending.popleft()
            r = self.replicas[pick]
            r.busy_slots += 1
            if r.state == WARM_IDLE:
                r._enter(t_s, BUSY)
            r.repaint(t_s)
            did = next(self._dispatch_ids)
            r.active[did] = req
            first = t_s + r.spec.ttft_service_s(r.freq)
            done = first + max(req.n_out - 1, 0) * r.spec.tpot_s(r.freq)
            self._push(done, "finish", (pick, did, first))

    def _on_finish(self, t_s: float, idx: int, did: int,
                   first_s: float) -> None:
        r = self.replicas[idx]
        req = r.active.pop(did, None)
        if req is None:              # requeued after a crash: stale
            return
        r.busy_slots -= 1
        self.records.append(FleetRecord(
            rid=req.rid, arrival_s=req.arrival_s,
            first_token_s=first_s, done_s=t_s,
            output=list(range(req.n_out)), replica=idx))
        if r.busy_slots == 0:
            if r.state == DRAINING:
                r._enter(t_s, COLD)
            elif r.state == BUSY:
                r._enter(t_s, WARM_IDLE)
        r.repaint(t_s)
        self._dispatch(t_s)

    def _on_control(self, t_s: float) -> None:
        if self.controller is None:
            return
        target = self.controller.decide(self._observe(t_s))
        self._scale_to(t_s, target)

    # -- entry point ----------------------------------------------------
    def run(self, queries) -> list[FleetRecord]:
        """Serve a loadgen admission list (``(sample, arrival_s)``
        pairs) and return completion records; the ``serve_queue``
        surface of the fleet."""
        for sample, t in queries:
            n_out = int(sample.get("out_tokens",
                                   self.default_out_tokens))
            self._push(float(t), "arrival",
                       _Request(int(sample["qid"]), float(t),
                                max(n_out, 1)))
        if self.fault_plan is not None:
            for f in getattr(self.fault_plan, "faults", ()):
                if type(f).__name__ == "ReplicaCrash" \
                        and f.replica < len(self.replicas):
                    self._push(float(f.at_s), "crash", int(f.replica))
        if self.controller is not None:
            self._push(0.0, "control", None)

        while self._heap:
            t_s, _, kind, payload = heapq.heappop(self._heap)
            self.end_s = max(self.end_s, t_s)
            if kind == "arrival":
                self._recent_arrivals.append(t_s)
                self.pending.append(payload)
                self._dispatch(t_s)
            elif kind == "finish":
                self._on_finish(t_s, *payload)
            elif kind == "ready":
                self._on_ready(t_s, payload)
            elif kind == "crash":
                self._on_crash(t_s, payload)
            elif kind == "control":
                self._on_control(t_s)
                work_left = (self.pending
                             or any(r.active for r in self.replicas)
                             or any(k == "arrival"
                                    for _, _, k, _ in self._heap))
                if work_left:
                    self._push(t_s + self.control_interval_s,
                               "control", None)
        if self.pending:
            raise RuntimeError(
                f"{len(self.pending)} requests stranded with no "
                f"admitting replica — fleet scaled to zero or all dead")
        for r in self.replicas:
            r.close(self.end_s)
        return self.records

    # -- energy ledger --------------------------------------------------
    def replica_energy_j(self, horizon_s: Optional[float] = None):
        """Exact per-replica wall joules over the run window."""
        h = self.end_s if horizon_s is None else float(horizon_s)
        return [r.trace.energy_j(h) for r in self.replicas]

    def energy_ledger_j(self, horizon_s: Optional[float] = None) -> dict:
        """Exact partition of fleet joules by lifecycle state."""
        h = self.end_s if horizon_s is None else float(horizon_s)
        cold_start_j = sum(
            r.spec.cold_start_w * r.time_in_state_s[STARTING]
            for r in self.replicas)
        idle_j = sum(r.spec.idle_w * r.time_in_state_s[WARM_IDLE]
                     for r in self.replicas)
        total_j = sum(self.replica_energy_j(h))
        return {"total_j": total_j,
                "cold_start_j": cold_start_j,
                "idle_j": idle_j,
                "busy_j": total_j - cold_start_j - idle_j}

    def provisioned_w_avg(self,
                          horizon_s: Optional[float] = None) -> float:
        """Time-averaged provisioned capacity (Σ live-replica peak
        watts) — the provisioning-slack axis of the Pareto table."""
        h = self.end_s if horizon_s is None else float(horizon_s)
        if h <= 0:
            return 0.0
        return sum(r.provision.energy_j(h) for r in self.replicas) / h

    def total_tokens(self) -> int:
        """Decoded tokens across all completed requests."""
        return sum(len(rec.output) for rec in self.records)
