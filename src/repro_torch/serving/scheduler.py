"""SLO-aware admission policy: deadline-slack ordering + preemption
(the port's copy of the reference ``serving/scheduler.py``).

The continuous-batching engine's default admission is FIFO by arrival
— correct, but blind to deadlines: a batch request that arrived one
microsecond before an interactive one gets the last free slot and the
interactive request blows its TTFT SLO waiting.  ``Scheduler`` is the
pluggable policy the engine consults instead:

- **admission order** (``order``): ready requests are sorted by
  priority (higher first), then by *deadline slack* — ``deadline_s -
  now_s``, seconds of headroom left — so the request closest to
  missing its deadline goes first within a priority class.  Requests
  without a deadline sort after any with one (infinite slack), then by
  arrival.
- **preemption** (``pick_victim``, enabled with ``preemption=True``):
  when admission fails under page-pool pressure, the engine asks for a
  running victim of *strictly lower* priority than the candidate.  The
  victim with the most slack (it can best afford the delay) is evicted
  — its full KV pages are parked in the prefix cache via the refcount
  machinery and the request re-queued, to be resumed later through the
  prefix-cache extend path with bit-identical output (see
  ``ContinuousBatchingEngine._park``).  The strict-priority rule makes
  park/resume ping-pong impossible: a resumed request can never
  preempt its own preemptor.

The policy is stateless; counters (preemptions, resumes, chunk
interleaving) accumulate in ``ContinuousBatchingEngine.sched_stats``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Scheduler:
    """Deadline-slack priority policy for the serving engine.

    Args:
        preemption: allow the engine to evict lower-priority running
            slots when admission hits page-pool pressure.  Requires an
            engine with ``prefix_caching=True`` (parked KV pages live
            in the prefix cache until resume).

    Reads per-request ``priority`` (int, higher = more urgent, default
    0) and ``deadline_s`` (absolute seconds on the serve clock, or
    ``None`` = no deadline) from the ``Request`` contract.
    """

    preemption: bool = False

    @staticmethod
    def slack_s(r, now_s: float) -> float:
        """Seconds of deadline headroom left for ``r`` at ``now_s``
        (``inf`` when the request carries no deadline)."""
        d = getattr(r, "deadline_s", None)
        return math.inf if d is None else float(d) - float(now_s)

    def order(self, ready, now_s: float) -> list:
        """Admission order over the ready set at time ``now_s``:
        priority descending, then slack ascending (most-at-risk
        first), then FIFO (arrival, rid) as the deterministic tie
        break.  Returns a new sorted list; ``ready`` is not mutated."""
        return sorted(ready, key=lambda r: (
            -getattr(r, "priority", 0), self.slack_s(r, now_s),
            r.arrival_s, r.rid))

    def pick_victim(self, running: list, candidate) -> Optional[int]:
        """The slot to preempt so ``candidate`` can admit, or ``None``.

        ``running``: list of ``(slot_index, request)`` for the
        currently-decoding slots.  Only strictly-lower-priority slots
        are eligible (equal priority never preempts — that way a
        resumed request cannot evict its preemptor and oscillate);
        among those, the lowest priority loses first, slackest first
        within a class (it can best absorb the added latency).
        """
        if not self.preemption:
            return None
        cand_pri = getattr(candidate, "priority", 0)
        eligible = [(b, r) for b, r in running
                    if getattr(r, "priority", 0) < cand_pri]
        if not eligible:
            return None
        b, _ = min(eligible, key=lambda br: (
            getattr(br[1], "priority", 0),
            # most slack first => sort by -slack (inf-safe: negate
            # compares fine since inf stays extreme)
            -self.slack_s(br[1], 0.0),
            br[0]))
        return b
