"""Quickstart: train a small LM for a few steps *under power measurement*
(PyTorch port of ``examples/quickstart.py``).

The public API end to end: config -> model -> train loop -> MLPerf-style
power log -> Samples/J.  The step times are ``--device``'s own; the
power figure is the modeled edge system's watts for the model's per-step
work (``hw.EDGE_SYSTEM``), sampled at 2 Hz, as in the reference, and
at the window's end -- not the card's draw.  The model is qwen3-1.7b at
full width, or the reference's reduced config with ``--reduce``.  On the
card the reduced model's 10 steps can take less than the review's 1 s
window (R1 then refuses it).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cuda]
      [--reduce] [--min-duration S]
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import (MLPerfLogger, StepWork, SystemDescription,
                              SystemPowerModel, review, summarize)
from repro_torch.data import SyntheticTokens
from repro_torch.hw import EDGE_SYSTEM
from repro_torch.models import build_model
from repro_torch.train import (TrainHParams, init_train_state,
                               make_train_step)

SEQ_LEN, BATCH, STEPS = 64, 8, 10


def modeled_watts(cfg) -> float:
    """The edge system's watts for one step's work: 6 N FLOPs a token
    over the step's tokens, 6 N x 4 bytes."""
    n_params = cfg.param_count()
    work = StepWork(flops=6.0 * n_params * BATCH * SEQ_LEN,
                    hbm_bytes=6.0 * n_params * 4)
    return SystemPowerModel(EDGE_SYSTEM, 1).system_watts(work)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduce", action="store_true",
                    help="the reference's reduced config")
    ap.add_argument("--min-duration", type=float, default=1.0,
                    help="the review's minimum window (relaxed, as in the "
                    "reference)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("qwen3-1.7b")
    if args.reduce:
        cfg = reduce_config(cfg)
    model = build_model(cfg, dev)
    hp = TrainHParams(total_steps=STEPS, warmup=2)
    state = init_train_state(model, 0, hp)
    step = make_train_step(model, hp)
    data = SyntheticTokens(cfg.vocab_size, seq_len=SEQ_LEN,
                           global_batch=BATCH, device=str(dev))

    # power instrumentation: the model's per-step work drives the meter
    watts = modeled_watts(cfg)

    perf, power = MLPerfLogger("perf"), MLPerfLogger("power")
    losses = []
    t0 = time.monotonic()
    perf.run_start(0.0)
    for i in range(STEPS):
        state, metrics = step(state, data.batch(i))
        losses.append(float(metrics["loss"]))
        print(f"step {i}: loss={losses[-1]:.4f} "
              f"modeled_power={watts:.1f} W")
    dur_ms = (time.monotonic() - t0) * 1e3
    perf.result("samples_processed", STEPS * BATCH, dur_ms)
    perf.run_stop(dur_ms)
    # the analyzer samples on its own clock (2 Hz), decoupled from steps,
    # and once more at the window's end: a run shorter than one period
    # (the card's 10 steps) still spans an interval to integrate
    for t_ms in np.append(np.arange(0.0, dur_ms, 500.0), dur_ms):
        power.power_sample(float(t_ms), watts)

    s = summarize(perf.events, power.events)
    print(f"\nenergy: {s.energy_j:.1f} J over {s.window_s:.1f} s "
          f"-> {s.samples_per_joule:.4f} samples/J")
    rep = review(perf.events, power.events,
                 SystemDescription(scale="edge", max_system_watts=60,
                                   idle_system_watts=8),
                 min_duration_s=args.min_duration)
    print(rep.render())
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite loss: {losses}")
    return {"losses": losses, "watts": watts, "summary": s, "review": rep,
            "seconds": dur_ms / 1e3}


if __name__ == "__main__":
    main()
