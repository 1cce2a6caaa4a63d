"""End-to-end training run of the port (PyTorch port of the
reference ``examples/train_e2e.py``): a ~106M-parameter LM trained with
the whole stack -- the deterministic data pipeline, AdamW,
checkpoint/restart through an injected node failure, straggler
monitoring, per-node power telemetry, energy-to-train and a compliance
review.

  python -m repro_torch.launch.train_e2e --steps 300
  python -m repro_torch.launch.train_e2e --steps 12 --smoke --device cpu

The telemetry is the reference's model of one 8-chip node, on
``DATACENTER_H100`` where the reference models v5e chips: modeled
watts, not the card's counter.  ``--device`` defaults to ``cuda`` and
raises without a GPU.  Checkpoints go to a fresh temporary directory
(removed at the end) unless ``--ckpt-dir`` names one.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.checkpoint import (CheckpointManager, SimulatedFailure,
                                    run_with_recovery)
from repro_torch.configs import get_config
from repro_torch.core import (MLPerfLogger, StepWork, SwitchEstimator,
                              SystemDescription, SystemPowerModel, review)
from repro_torch.core.summarizer import energy_to_train
from repro_torch.data import SyntheticTokens
from repro_torch.hw import DATACENTER_H100
from repro_torch.models import build_model
from repro_torch.train import (TrainHParams, init_train_state,
                               make_train_step)

N_CHIPS = 8     # the modeled node


def model_100m():
    """~106M parameters: 10L x d640, GQA 10/5, SwiGLU 2560, vocab 32000."""
    return get_config(
        "qwen3-1.7b", n_layers=10, d_model=640, n_heads=10, n_kv_heads=5,
        d_head=64, d_ff=2560, vocab_size=32000, qk_norm=True,
        dtype="float32", remat=False)


def run(*, steps: int, batch: int, seq: int, device="cuda",
        ckpt_dir=None, smoke: bool = False, log=print) -> dict:
    """Train ``model_100m`` for ``steps`` steps with a failure injected
    at step ``steps // 3`` (from 9 steps on).  Returns the report,
    losses, straggler events, the energy summary, the review, the final
    state and the checkpoint manager (whose directory is gone unless
    ``ckpt_dir`` was given)."""
    dev = resolve_device(device)
    cfg = model_100m()
    model = build_model(cfg, dev)
    log(f"params: {cfg.param_count() / 1e6:.1f}M")
    hp = TrainHParams(total_steps=steps, warmup=20, peak_lr=6e-4)
    state = init_train_state(model, 0, hp)
    step = make_train_step(model, hp)
    data = SyntheticTokens(cfg.vocab_size, seq, batch, device=dev)
    own_dir = ckpt_dir is None
    ckpt = CheckpointManager(ckpt_dir or tempfile.mkdtemp(
        prefix="repro_torch_e2e_"), keep=2)

    # telemetry: one virtual node (this host models an 8-chip node)
    meter = SystemPowerModel(DATACENTER_H100, N_CHIPS)
    tokens = batch * seq
    work = StepWork(flops=6.0 * cfg.param_count() * tokens / N_CHIPS,
                    hbm_bytes=16.0 * cfg.param_count() / N_CHIPS,
                    ici_bytes=2.0 * cfg.param_count() / N_CHIPS)
    watts = meter.system_watts(work)

    perf = MLPerfLogger("perf")
    node_log = MLPerfLogger("power")
    t0 = time.monotonic()
    perf.run_start(0.0)

    fail_at = {steps // 3: True} if steps >= 9 else {}

    def injector(s):
        if fail_at.pop(s, None):
            log(f"!! injected node failure at step {s}")
            raise SimulatedFailure(s)

    losses = []
    last_sample = [0.0]

    def on_step(s, metrics):
        # out-of-band telemetry: fill a 1 Hz sample grid up to now (a
        # real BMC samples on its own clock; tying samples to step
        # completion under-samples slow steps and fails review R2/R3)
        t_ms = (time.monotonic() - t0) * 1e3
        while last_sample[0] <= t_ms:
            node_log.power_sample(last_sample[0], watts, node="node0")
            last_sample[0] += 1000.0
        losses.append(float(metrics["loss"]))
        if s % 10 == 0 or s <= 3:
            log(f"step {s:4d} loss={losses[-1]:.4f} "
                f"lr={float(metrics['lr']):.2e} "
                f"gnorm={float(metrics['grad_norm']):.2f}")

    try:
        state, rep = run_with_recovery(
            state=state, step_fn=step, data_fn=data.batch, ckpt=ckpt,
            total_steps=steps, ckpt_every=max(5, steps // 10),
            failure_injector=injector, on_step=on_step)
    finally:
        if own_dir:
            shutil.rmtree(ckpt.dir, ignore_errors=True)

    dur_ms = (time.monotonic() - t0) * 1e3
    perf.result("samples_processed", steps * batch, dur_ms)
    perf.run_stop(dur_ms)

    log(f"\nrecovered from {rep.failures} failure(s); "
        f"straggler events: {len(rep.straggler_events)}")
    first = float(np.mean(losses[:10]))
    last = float(np.mean(losses[-10:]))
    log(f"loss {first:.4f} -> {last:.4f} "
        f"({'DECREASED' if last < first else 'did not decrease'})")

    est = SwitchEstimator().estimate(N_CHIPS, dur_ms / 1e3)
    summary = energy_to_train(perf.events, {"node0": node_log.events},
                              switch_estimate=est)
    log(f"energy-to-train (modeled {N_CHIPS}-chip node): "
        f"{summary.energy_j / 1e3:.2f} kJ over {summary.window_s:.0f} s "
        f"({summary.avg_watts:.0f} W avg)")
    rev = review(perf.events, node_log.events, SystemDescription(
        scale="datacenter", n_chips=N_CHIPS, telemetry_accuracy=0.02,
        scope=("chips", "host", "interconnect"),
        estimated_components={"switch": est["methodology"]},
        max_system_watts=5000, idle_system_watts=500),
        min_duration_s=1.0 if smoke else 60.0)
    log(rev.render())
    return {"report": rep, "losses": losses, "first": first, "last": last,
            "summary": summary, "review": rev, "state": state,
            "ckpt": ckpt, "seconds": dur_ms / 1e3}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        args.steps, args.batch, args.seq = min(args.steps, 12), 4, 64
    out = run(steps=args.steps, batch=args.batch, seq=args.seq,
              device=args.device, ckpt_dir=args.ckpt_dir, smoke=args.smoke)
    if args.steps >= 50:            # smoke runs sit inside lr warmup
        assert out["last"] < out["first"], "training must reduce loss"
    return out


if __name__ == "__main__":
    main()
