"""Fault-tolerant training supervisor: checkpoint/restart on failure,
straggler detection, deterministic data continuation (PyTorch port of
the reference ``checkpoint/supervisor.py``, the same behaviour).

The supervisor wraps the step loop: on a (real or injected) failure it
restores the newest checkpoint and resumes; the synthetic data pipeline
is a pure function of the step, so no sample is lost or replayed.
Steps slower than ``factor`` x the running median are logged as
straggler events.  A step's time is taken after its loss is ready (a
device sync where the reference blocks on the loss).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Optional

import torch


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests / examples)."""


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 2.0
    window: int = 32
    events: list = dataclasses.field(default_factory=list)
    _times: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        self._times.append(seconds)
        if len(self._times) > self.window:
            self._times.pop(0)
        med = statistics.median(self._times)
        if len(self._times) >= 8 and seconds > self.factor * med:
            self.events.append({"step": step, "seconds": seconds,
                                "median": med})
            return True
        return False


@dataclasses.dataclass
class RecoveryReport:
    final_step: int
    failures: int
    straggler_events: list
    losses: list


def run_with_recovery(
    *,
    state,
    step_fn: Callable,
    data_fn: Callable[[int], dict],
    ckpt,
    total_steps: int,
    ckpt_every: int = 10,
    failure_injector: Optional[Callable[[int], None]] = None,
    on_step: Optional[Callable[[int, dict], None]] = None,
    max_restarts: int = 10,
) -> tuple:
    """Run ``total_steps`` of training with checkpoint/restart recovery.

    ``step_fn(state, batch) -> (state, metrics)``; ``data_fn(step)``
    must be deterministic in step.  Returns (state, RecoveryReport).
    """
    monitor = StragglerMonitor()
    failures = 0
    losses = []
    step = int(state.step)
    while step < total_steps:
        try:
            while step < total_steps:
                if failure_injector is not None:
                    failure_injector(step)
                batch = data_fn(step)
                t0 = time.monotonic()
                state, metrics = step_fn(state, batch)
                loss = metrics.get("loss", None)
                if isinstance(loss, torch.Tensor) and loss.is_cuda:
                    torch.cuda.synchronize(loss.device)
                dt = time.monotonic() - t0
                step += 1
                monitor.observe(step, dt)
                losses.append(float(metrics["loss"]))
                if on_step is not None:
                    on_step(step, metrics)
                if step % ckpt_every == 0 or step == total_steps:
                    ckpt.save(step, state)
        except SimulatedFailure:
            failures += 1
            if failures > max_restarts:
                raise
            last = ckpt.latest_step()
            if last is None:
                # restart from scratch: re-init is the caller's concern;
                # only the step counter rewinds (the params kept: a warm
                # spare takes over with the current weights)
                step = 0
                continue
            state, _ = ckpt.restore(state)
            step = int(last)
    return state, RecoveryReport(step, failures, monitor.events, losses)
