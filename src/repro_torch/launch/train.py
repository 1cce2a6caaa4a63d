"""Training launcher of the port: ``--arch <id>`` selects any
architecture (PyTorch port of the reference ``launch/train.py``).

Trains the (optionally reduced) model on one device with seeded
weights, the synthetic data pipeline, AdamW, checkpointing with
failure recovery and MLPerf power logging; it ends with the modeled
energy-to-train.  The power figures are the reference's modeled
telemetry on ``DATACENTER_H100`` (where the reference models a v5e):
nothing here is read from the card's counter.

  python -m repro_torch.launch.train --arch qwen3-1.7b --reduce \\
      --steps 20 --batch 8 --seq 128 --device cpu

``--device`` defaults to ``cuda`` and raises without a GPU.
``--model-axis`` above 1 (sharded training) raises: it waits for a
4-chip cell.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager, run_with_recovery
from repro_torch.configs import get_config, list_archs, reduce_config
from repro_torch.core import (MLPerfLogger, StepWork, SwitchEstimator,
                              SystemPowerModel)
from repro_torch.core.summarizer import energy_to_train
from repro_torch.data import SyntheticTokens
from repro_torch.hw import DATACENTER_H100
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.train import (TrainHParams, init_train_state,
                               make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduce", action="store_true",
                    help="smoke-scale config (CPU-friendly)")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--quant-opt", action="store_true",
                    help="int8-m / bf16-sqrt-v optimizer states")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.model_axis > 1:
        raise NotImplementedError(
            f"--model-axis {args.model_axis}: sharded training waits for a "
            f"4-chip cell, see ROADMAP §A.8")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduce_config(cfg)
    if cfg.family in ("tiny", "encdec") or cfg.vlm is not None:
        raise NotImplementedError(
            f"{args.arch}: the launcher's SyntheticTokens batches hold "
            f"tokens only (no mfcc, frames or patch embeddings), as the "
            f"reference's")
    model = build_model(cfg, dev)
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"(reduced={args.reduce}) device={dev}")

    hp = TrainHParams(total_steps=args.steps, warmup=max(2, args.steps // 10),
                      adamw=AdamWConfig(quant_moments=args.quant_opt))
    state = init_train_state(model, 0, hp)
    step = make_train_step(model, hp)
    data = SyntheticTokens(cfg.vocab_size, args.seq, args.batch, device=dev)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)

    n_chips = 1
    meter = SystemPowerModel(DATACENTER_H100, n_chips)
    work = StepWork(
        flops=6.0 * cfg.param_count() * args.batch * args.seq / n_chips,
        hbm_bytes=16.0 * cfg.param_count() / n_chips)
    watts = meter.system_watts(work)

    perf, node = MLPerfLogger("perf"), MLPerfLogger("power")
    t0 = time.monotonic()
    perf.run_start(0.0)

    def on_step(s, metrics):
        node.power_sample((time.monotonic() - t0) * 1e3, watts,
                          node="node0")
        if s % 5 == 0:
            print(f"step {s}: loss={float(metrics['loss']):.4f}")

    state, rep = run_with_recovery(
        state=state, step_fn=step, data_fn=data.batch, ckpt=ckpt,
        total_steps=args.steps, ckpt_every=max(5, args.steps // 4),
        on_step=on_step)
    dur_ms = (time.monotonic() - t0) * 1e3
    perf.result("samples_processed", args.steps * args.batch, dur_ms)
    perf.run_stop(dur_ms)

    s = energy_to_train(perf.events, {"node0": node.events},
                        switch_estimate=SwitchEstimator().estimate(
                            n_chips, dur_ms / 1e3))
    print(f"energy-to-train (modeled): {s.energy_j:.1f} J, "
          f"avg {s.avg_watts:.0f} W, {s.window_s:.1f} s")
    return state, rep, s


if __name__ == "__main__":
    main()
