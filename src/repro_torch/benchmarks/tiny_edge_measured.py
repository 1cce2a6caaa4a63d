"""Measured tiny single-stream and edge runs (PyTorch port of
``benchmarks/tiny_edge_measured.py``).

Each run goes end to end through the public harness:
``PowerRun(sut, scenario).run()`` = loadgen -> Director + virtual
analyzer -> summarizer -> compliance review, in one call.

What is measured and what is modeled, as in ``launch/tiny_benchmark.py``:
the forward latencies are ``device``'s own (on CUDA the card's: a host
clock around the call and a synchronize); every energy figure is
modeled, as in the reference (the tiny run's duty-cycled MCU on the
``pin`` channel, the edge runs' analytic edge-system watts or a flat
figure), never an H100's draw.  ``edge_offline`` runs edge-vit at full
width (12 layers x 384, 196 patches) unless ``reduce`` asks for the
reference's reduced config, as the CPU tests do.

  PYTHONPATH=src python -m repro_torch.benchmarks.tiny_edge_measured \\
      [--device cuda] [--reduce]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.benchmarks.common import csv_row
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import SystemPowerModel
from repro_torch.core.compliance import SystemDescription
from repro_torch.harness import (CallableSUT, Offline, PowerRun,
                                 SingleStream, constant_power,
                                 throughput_watts)
from repro_torch.hw import EDGE_SYSTEM
from repro_torch.launch import tiny_benchmark
from repro_torch.models import build_model

EDGE_BATCH = 8


def tiny_single_stream(device="cuda") -> dict:
    """Real tiny-KWS forward latency + duty-cycled µW energy, measured
    through the harness at a reduced duration (10 Hz detector frames --
    a faster cadence than the example's 4 Hz so 200 queries fit a short
    benchmark window; per-inference energy includes the per-period
    sleep floor, so it is not directly comparable across periods).  The
    forward is ``launch.tiny_benchmark``'s."""
    out = tiny_benchmark.single_stream(device, min_duration_s=2.0,
                                       period_s=0.1, min_queries=200)
    e_inf = out["modeled_uj_per_inf"] * 1e-6
    return {
        "name": "tiny_kws_single_stream",
        "us_per_call": out["mean_us"],
        "p90_us": out["p90_us"],
        "measured_uj_per_inf": out["modeled_uj_per_inf"],
        "inv_joules": 1.0 / e_inf,
        "review_passed": out["review_passed"],
    }


def edge_loss_forward(device="cuda", *, reduce: bool = False):
    """(config, a call of edge-vit's training-loss forward on
    ``EDGE_BATCH`` samples of 8 zero tokens behind the config's patch
    embeddings of ones, weights from seed 0, warmed up once).  On CUDA
    the call returns after the card is done."""
    dev = resolve_device(device)
    cfg = get_config("edge-vit")
    if reduce:
        cfg = reduce_config(cfg)
    model = build_model(cfg, dev)
    params = model.init(seed=0)
    tok = torch.zeros((EDGE_BATCH, 8), dtype=torch.int64, device=dev)
    pe = torch.ones((EDGE_BATCH, cfg.vlm.n_patches, cfg.d_model),
                    dtype=torch.float32, device=dev)
    inputs = {"tokens": tok, "labels": tok, "patch_embeds": pe}

    def loss_fn():
        with torch.no_grad():
            loss = model.train_loss(params, inputs)[0]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return loss

    loss_fn()
    return cfg, loss_fn


def edge_offline(device="cuda", *, reduce: bool = False,
                 min_duration_s: float = 1.0) -> dict:
    """Edge ViT training-loss step under the Offline scenario; analytic
    edge-system watts shaped by the measured throughput."""
    cfg, loss_fn = edge_loss_forward(device, reduce=reduce)
    meter = SystemPowerModel(EDGE_SYSTEM, 1)
    b = EDGE_BATCH

    def issue_batch(samples):
        t0 = time.perf_counter()
        loss_fn()
        return time.perf_counter() - t0

    def power_factory(outcome):
        return constant_power(
            throughput_watts(meter, cfg, outcome.result.qps))

    sut = CallableSUT(name="edge-vit", issue_batch=issue_batch,
                      power_factory=power_factory)
    r = PowerRun(sut, Offline(batch=b, min_duration_s=min_duration_s),
                 seed=0).run()
    res = r.outcome.result
    return {
        "name": "edge_vit_offline",
        "us_per_call": float(res.duration_s / max(1, res.n_queries // b)
                             * 1e6),
        "samples_per_s": res.qps,
        "samples_per_joule": r.samples_per_joule,
        "review_passed": r.passed,
    }


def edge_multi_stream(device="cuda", *,
                      min_duration_s: float = 0.5) -> dict:
    """MultiStream bursts (edge rules): 8-sample bursts on the tiny
    model, p99 per-burst latency through the harness
    (``launch.tiny_benchmark.multi_stream``)."""
    out = tiny_benchmark.multi_stream(device, min_duration_s=min_duration_s)
    return {
        "name": "edge_multi_stream",
        "us_per_call": out["p99_burst_ms"] * 1e3,
        "p99_burst_ms": out["p99_burst_ms"],
        "samples_per_s": out["samples_per_s"],
        "review_passed": out["review_passed"],
    }


def full_pipeline_compliance() -> dict:
    """End-to-end: synthetic edge run through the one-call harness."""
    sut = CallableSUT(name="edge-synthetic", issue=lambda s: 0.01,
                      power=42.0,
                      sysdesc=SystemDescription(
                          scale="edge", max_system_watts=60,
                          idle_system_watts=8))
    r = PowerRun(sut, SingleStream(min_duration_s=66.0), seed=0).run()
    return {"name": "edge_pipeline_compliance",
            "samples_per_joule": r.samples_per_joule,
            "review_passed": r.passed}


def run(device="cuda", *, reduce: bool = False,
        window_s: float | None = None) -> list[dict]:
    """The four rows.  ``window_s`` sets the Offline and MultiStream
    runs' minimum windows (the reference's 1.0 and 0.5 s by default): a
    window under ~2 s can miss R12's 95 % sample coverage at the edge
    analyzer's 10 Hz by one sample."""
    win = {} if window_s is None else dict(min_duration_s=window_s)
    return [tiny_single_stream(device),
            edge_offline(device, reduce=reduce, **win),
            edge_multi_stream(device, **win), full_pipeline_compliance()]


def csv(device="cuda") -> list[str]:
    out = []
    for r in run(device):
        us = r.get("us_per_call", 0.0)
        rest = ";".join(f"{k}={v}" for k, v in r.items()
                        if k not in ("name", "us_per_call"))
        out.append(csv_row(r["name"], us, rest))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduce", action="store_true",
                    help="edge-vit at the reference's reduced config")
    args = ap.parse_args(argv)
    for r in run(args.device, reduce=args.reduce):
        print(r)


if __name__ == "__main__":
    main()
