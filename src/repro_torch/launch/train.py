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

Sharded training (the reference's ``make_host_mesh(model=...)`` and
``make_rules(cfg, mesh, "train")``): the world is the visible cards on
``cuda`` (NCCL, one process a card) and ``--devices N`` ranks on the
CPU (gloo; the counterpart of ``--xla_force_host_platform_device_count``);
``--model-axis`` splits it into (world / model, model).  A world of one
trains unsharded, as the reference does on one device.  Rank 0 prints
and its report is returned (the state stays with the ranks):

  python -m repro_torch.launch.train --arch qwen3-1.7b --reduce \
      --steps 6 --model-axis 2 --devices 4 --device cpu

The model axis takes every family the launcher trains (dense, moe,
mla_moe, hybrid and rwkv; its batches hold tokens only, so vlm, encdec
and tiny stay refused, as the reference's launcher refuses them).  It
raises when ``--model-axis`` does not divide the world, and for an MoE
config whose experts do not divide the model axis
(``models.lm.check_model_axis``).
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
from repro_torch.models.lm import check_model_axis
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
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks of a sharded run (CPU: gloo processes; "
                         "cuda: at most the visible cards)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = _config(args)
    # before any rank is spawned
    check_model_axis(cfg, args.model_axis)
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(args.model_axis, device=dev, devices=(
        args.devices if dev.type == "cuda" else args.devices or 1))
    if mesh.size == 1:
        return _train(args, dev)
    from repro_torch.parallel.launch import run_grid
    d, m = mesh.axis_sizes
    rep, summary = run_grid(_train_rank, d, m, args=(args,),
                            backend="nccl" if dev.type == "cuda" else "gloo",
                            timeout_s=3600.0)
    return None, rep, summary


def _config(args):
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduce_config(cfg)
    if cfg.family in ("tiny", "encdec") or cfg.vlm is not None:
        raise NotImplementedError(
            f"{args.arch}: the launcher's SyntheticTokens batches hold "
            f"tokens only (no mfcc, frames or patch embeddings), as the "
            f"reference's")
    return cfg


def _train_rank(grid, args):
    """One rank of a sharded run: rank 0's (report, summary)."""
    _, rep, summary = _train(args, grid.device, grid)
    return (rep, summary) if grid.rank == 0 else None


def _train(args, dev, grid=None):
    """The training run on ``dev``, sharded on ``grid`` where given:
    (state, report, energy summary)."""
    cfg = _config(args)
    say = print if grid is None or grid.rank == 0 else (lambda *a: None)
    model = build_model(cfg, dev, grid=grid)
    say(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
        f"(reduced={args.reduce}) device={dev}")
    if grid is not None:
        say(f"mesh data={grid.data} model={grid.model} "
            f"({'nccl' if dev.type == 'cuda' else 'gloo'})")

    hp = TrainHParams(total_steps=args.steps, warmup=max(2, args.steps // 10),
                      adamw=AdamWConfig(quant_moments=args.quant_opt))
    state = init_train_state(model, 0, hp)
    step = make_train_step(model, hp)
    data = SyntheticTokens(cfg.vocab_size, args.seq, args.batch, device=dev)
    ckpt_kw = {}
    if grid is not None:
        from repro_torch.train.train_step import train_state_pspecs
        ckpt_kw = dict(grid=grid,
                       pspecs=train_state_pspecs(model, model.rules, hp))
    ckpt = CheckpointManager(args.ckpt_dir, keep=2, **ckpt_kw)

    n_chips = 1 if grid is None else grid.data * grid.model
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
            say(f"step {s}: loss={float(metrics['loss']):.4f}")

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
    say(f"energy-to-train (modeled): {s.energy_j:.1f} J, "
        f"avg {s.avg_watts:.0f} W, {s.window_s:.1f} s")
    return state, rep, s


if __name__ == "__main__":
    main()
