"""MLPerf-Tiny-scale benchmark of the port: keyword spotting under the
MLPerf Power harness.

  python -m repro_torch.launch.tiny_benchmark --device cuda \\
      [--scenario single|multi] [--min-duration S] [--period S] \\
      [--int8-accuracy]

The counterpart of ``examples/tiny_benchmark.py`` (``--scenario
single``, the default) and ``benchmarks/tiny_edge_measured.py:
edge_multi_stream`` (``--scenario multi``).  Both go through the whole
measurement protocol in one call, ``PowerRun(sut, scenario).run()``:
loadgen, Director with the virtual analyzer, summarizer and compliance
review.

What is measured and what is modeled:

- **Measured**: the tiny model's forward latency, on ``--device`` (the
  card's own time on CUDA: host clock around the forward and a
  synchronize), and the int8-vs-float32 agreement of
  ``--int8-accuracy``.
- **Modeled**: every energy figure.  ``single`` runs an always-on
  detector at one frame per ``--period`` behind ``TinySUT``, whose
  ``pin`` channel replays the reference's MCU waveform
  (``TinyPowerModel``): the µJ/inference is that modeled MCU's, not
  the H100's draw.  The I/O manager cross-checks it on the
  pin-demarcated waveform.  ``multi`` times 8-sample bursts under
  ``CallableSUT`` with a flat modeled 1 W edge power figure.  The
  card's measured energy (``repro_torch.power.nvml``) is the serving
  SUTs'; an H100's board draw is not the µW MCU this scale models.

``--device`` defaults to ``cuda`` and raises without a GPU.

  python -m repro_torch.launch.tiny_benchmark --device cpu --min-duration 1
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import IOManager, TinyPowerModel
from repro_torch.core.compliance import SystemDescription
from repro_torch.harness import (CallableSUT, MultiStream, PowerRun,
                                 SingleStream, TinySUT)
from repro_torch.models import tiny as tiny_mod

BURST = 8                   # samples per MultiStream burst (edge rules)
BURST_QUERIES = 64          # tiny_edge_measured.edge_multi_stream's count


def _forward(dev, batch: int):
    """A call of the tiny model (weights from seed 0) on a (batch, 49,
    10) input of ones, warmed up once; on CUDA it returns after the card
    is done, so a host clock around it times the card's work."""
    cfg = get_config("tiny-kws")
    model = tiny_mod.TinyModel(cfg, dev)
    params = model.init(0)
    x = torch.ones((batch, tiny_mod.IN_T, tiny_mod.IN_F), device=dev)

    def fwd():
        model(params, x)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fwd()
    return cfg, fwd


def single_stream(device="cuda", *, min_duration_s: float = 60.0,
                  period_s: float = 0.25, min_queries=None) -> dict:
    """SingleStream through ``TinySUT``: real forward latencies, the
    modeled duty-cycled MCU energy on the ``pin`` channel and the I/O
    manager's cross-check.  ``min_queries`` defaults to one duration's
    worth of frames."""
    dev = resolve_device(device)
    cfg, fwd = _forward(dev, 1)
    macs, sram = tiny_mod.macs(cfg), tiny_mod.sram_bytes(cfg)
    sut = TinySUT(fwd, macs=macs, sram_bytes=sram, period_s=period_s,
                  name="tiny-kws")
    if min_queries is None:
        min_queries = int(min_duration_s / period_s)
    scenario = SingleStream(min_duration_s=min_duration_s,
                            min_queries=min_queries)
    r = PowerRun(sut, scenario, seed=0).run()
    lat = np.asarray(sut.real_latencies_s)
    n = r.outcome.result.n_queries
    e_inf = r.summary.energy_j / n
    t, amps, pin = TinyPowerModel().waveform(
        macs, sram, n_inferences=min(n, 64), period_s=period_s,
        sample_hz=50_000)
    e_pin, n_pin = IOManager().energy_per_inference(t, amps, pin)
    return {
        "scenario": "single", "device": str(dev), "macs": macs,
        "sram_bytes": sram, "n_queries": n, "n_forwards": len(lat),
        "mean_us": float(np.mean(lat) * 1e6),
        "p50_us": float(np.percentile(lat, 50) * 1e6),
        "p90_us": float(np.percentile(lat, 90) * 1e6),
        "modeled_energy_j": r.summary.energy_j,
        "modeled_window_s": r.summary.window_s,
        "modeled_uj_per_inf": e_inf * 1e6,
        "modeled_avg_uw": r.summary.avg_watts * 1e6,
        "duty_cycle": sut.model.duty_cycle(macs, period_s),
        "pin_windows": n_pin, "pin_uj_per_inf": e_pin * 1e6,
        "review_passed": r.passed, "result": r,
    }


def multi_stream(device="cuda", *, min_duration_s: float = 0.5) -> dict:
    """MultiStream: 8-sample bursts of the real forward under
    ``CallableSUT``; per-burst latency percentiles through the harness,
    a flat modeled 1 W edge power figure."""
    dev = resolve_device(device)
    _, fwd = _forward(dev, BURST)
    burst_s: list[float] = []

    def issue_burst(samples):
        t0 = time.perf_counter()
        fwd()
        burst_s.append(time.perf_counter() - t0)
        return burst_s[-1]

    sut = CallableSUT(name="tiny-kws-burst", issue_batch=issue_burst,
                      power=1.0,
                      sysdesc=SystemDescription(
                          scale="edge", max_system_watts=60,
                          idle_system_watts=0.5))
    r = PowerRun(sut, MultiStream(n_streams=BURST,
                                  min_duration_s=min_duration_s,
                                  min_queries=BURST_QUERIES),
                 seed=0).run()
    res = r.outcome.result
    lat = np.asarray(burst_s)
    return {
        "scenario": "multi", "device": str(dev), "bursts": len(lat),
        "p50_us": float(np.percentile(lat, 50) * 1e6),
        "p90_us": float(np.percentile(lat, 90) * 1e6),
        "p99_burst_ms": res.p99 * 1e3, "samples_per_s": res.qps,
        "modeled_samples_per_joule": r.samples_per_joule,
        "review_passed": r.passed, "result": r,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scenario", default="single",
                    choices=("single", "multi"))
    ap.add_argument("--min-duration", type=float, default=None,
                    help="seconds (default 60 single, 0.5 multi)")
    ap.add_argument("--period", type=float, default=0.25,
                    help="detector frame period, single (default 4 Hz)")
    ap.add_argument("--int8-accuracy", action="store_true",
                    help="also run the W8A8 accuracy measurement")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    if args.scenario == "single":
        out = single_stream(dev, min_duration_s=args.min_duration or 60.0,
                            period_s=args.period)
        print(f"workload: {out['macs'] / 1e3:.0f}k MACs, "
              f"{out['sram_bytes'] / 1024:.0f} KiB SRAM")
        print(f"single-stream: {out['n_forwards']} forwards on {name} "
              f"(measured): p50 {out['p50_us']:.1f} us, p90 "
              f"{out['p90_us']:.1f} us")
        print(f"modeled MCU at {1 / args.period:g} Hz frames (pin "
              f"channel, not the {name}'s draw): "
              f"{out['modeled_energy_j'] * 1e3:.3f} mJ over "
              f"{out['modeled_window_s']:.1f} s -> "
              f"{out['modeled_uj_per_inf']:.3f} uJ/inference, duty cycle "
              f"{out['duty_cycle'] * 100:.2f}%, average "
              f"{out['modeled_avg_uw']:.1f} uW")
        print(f"io-manager cross-check (modeled waveform): "
              f"{out['pin_windows']} pin windows, "
              f"{out['pin_uj_per_inf']:.3f} uJ/inference")
    else:
        out = multi_stream(dev, min_duration_s=args.min_duration or 0.5)
        print(f"multi-stream: {out['bursts']} bursts of {BURST} on {name} "
              f"(measured): p50 {out['p50_us']:.1f} us, p90 "
              f"{out['p90_us']:.1f} us, p99 {out['p99_burst_ms']:.3f} ms, "
              f"{out['samples_per_s']:.0f} samples/s")
        print(f"modeled flat 1 W edge power: "
              f"{out['modeled_samples_per_joule']:.1f} samples/J")
    print(out["result"].report.render())
    if args.int8_accuracy:
        from repro_torch.benchmarks.quantization_efficiency import (
            tiny_accuracy_measurement)
        print(tiny_accuracy_measurement(dev))
    return out


if __name__ == "__main__":
    main()
