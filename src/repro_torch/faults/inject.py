"""``FaultInjector``: apply a plan's metering faults to channel samples.

The injector sits between the instrument model and the power log: the
``MeterStack`` measures a channel cleanly, then asks the injector what
the telemetry path actually delivered — which samples were lost
(``MeterDropout``), which the analyzer clipped at its pinned range
(``RangeOverload`` surges the *true* draw past the probe's range), and
which timestamps an NTP-skew spike shifted.  The stack's degradation
loop then re-ranges/retries the affected intervals and records what
happened per channel in a ``ChannelHealth``.

Copied from the reference ``src/repro/faults/inject.py``; only its
imports differ.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.faults.plan import (ClockSkew, FaultPlan, MeterDropout,
                                     RangeOverload)


@dataclasses.dataclass
class ChannelHealth:
    """What graceful degradation did (and failed to do) to one channel.

    ``coverage`` is delivered/expected samples after all retries (the
    quantity compliance invariant R12 thresholds); ``n_clipped`` counts
    samples still pinned at the analyzer range after re-ranging (R13).
    ``backoff_s`` is the modeled retry wait, bounded by the policy.
    """

    coverage: float = 1.0
    n_dropped: int = 0
    n_clipped: int = 0
    retries: int = 0
    reranges: int = 0
    backoff_s: float = 0.0
    skew_corrected_ms: float = 0.0

    @property
    def degraded(self) -> bool:
        return (self.coverage < 1.0 or self.n_clipped > 0
                or self.retries > 0 or self.skew_corrected_ms > 0.0)

    def describe(self) -> str:
        bits = [f"coverage {self.coverage:.1%}"]
        if self.n_clipped:
            bits.append(f"{self.n_clipped} clipped")
        if self.retries:
            bits.append(f"{self.retries} retries "
                        f"(+{self.backoff_s * 1e3:.0f} ms backoff)")
        if self.reranges:
            bits.append(f"{self.reranges} re-ranges")
        if self.skew_corrected_ms:
            bits.append(f"skew corrected {self.skew_corrected_ms:.0f} ms")
        return ", ".join(bits)


class FaultInjector:
    """Applies a ``FaultPlan``'s metering faults to measured samples."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def faults_for(self, channel: str) -> list:
        return self.plan.meter_faults(channel)

    def apply(self, meter, rel_s: np.ndarray, w: np.ndarray, *,
              retry: int = 0
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Inject this channel's faults into one measured span.

        ``rel_s`` are sample times relative to measurement start (the
        coordinate fault windows use), ``retry`` the channel-level
        retry counter (transient faults fire only at attempt 0/retry
        0).  Returns ``(w, dropped, clipped, shift_ms)``: the possibly
        surged-and-clipped watts, boolean masks for lost and clipped
        samples, and per-sample timestamp shifts from clock skew.
        """
        rel_s = np.asarray(rel_s, float)
        w = np.array(w, float)
        n = len(w)
        dropped = np.zeros(n, bool)
        clipped = np.zeros(n, bool)
        shift_ms = np.zeros(n, float)
        for k, f in enumerate(self.faults_for(meter.name)):
            if not self.plan.active(f, retry):
                continue
            if isinstance(f, MeterDropout):
                win = ((rel_s >= f.start_s)
                       & (rel_s < f.start_s + f.duration_s))
                idx = np.flatnonzero(win)
                if f.drop_fraction < 1.0 and len(idx):
                    rng = self.plan.rng("dropout", meter.name, k,
                                        self.plan.attempt, retry)
                    idx = idx[rng.random(len(idx)) < f.drop_fraction]
                dropped[idx] = True
            elif isinstance(f, RangeOverload):
                win = ((rel_s >= f.start_s)
                       & (rel_s < f.start_s + f.duration_s))
                w[win] = w[win] * f.factor
                cap = (meter.analyzer.fixed_range
                       if meter.analyzer is not None else None)
                if cap is not None:
                    over = win & (w > cap)
                    w[over] = cap
                    clipped |= over
            elif isinstance(f, ClockSkew):
                shift_ms[rel_s >= f.at_s] += f.skew_ms
        return w, dropped, clipped, shift_ms
