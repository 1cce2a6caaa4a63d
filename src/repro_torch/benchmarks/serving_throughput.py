"""Serving throughput: fixed-batch vs continuous batching under a
Poisson Server load with mixed ``max_new_tokens`` (the port of
``benchmarks/serving_throughput.py``).

Both engines run behind the ``repro_torch.harness`` API: each is a SUT
with a ``serve_queue``, driven by the queue-form ``Server`` scenario
through ``PowerRun``, so tokens/Joule comes from the Director's
integrated energy.  The continuous engine wins on two axes: finished
slots are refilled mid-flight instead of blocking the batch on its
longest request, and the decode loop runs whole chunks on device (one
host sync per ``chunk_steps`` tokens instead of per token).

- On the CPU (``device="cpu"``): the reduced qwen3-1.7b, and both SUTs
  declare the reference's constant busy watts, so the tok/J ratio
  isolates scheduling and host-sync overhead, as in the reference.
- On the card (the default): the full-width qwen3-1.7b (the reduced
  config's heads of 32 are refused by every CUDA attention wrapper),
  and each SUT's domains are the measured ones of its own serve: the
  card's accelerator rail from its NVML energy counter, the H100
  system's modeled host rail and the PSU-derived wall.

  PYTHONPATH=src python -m repro_torch.benchmarks.serving_throughput \\
      [--device cpu] [--smoke]
"""
from __future__ import annotations

import argparse
import time
from functools import partial

import numpy as np

SLOTS = 4
PROMPT_LEN = 16
MAX_LEN = 64
MIX = (4, 24, 8, 16)          # mixed budgets: stragglers + short ones


def _make_request(cfg, i, arrival_s):
    from repro_torch.serving import Request

    rng = np.random.default_rng((7, i))
    return Request(rid=i,
                   prompt=rng.integers(0, cfg.vocab_size, PROMPT_LEN),
                   max_new_tokens=MIX[i % len(MIX)],
                   arrival_s=float(arrival_s))


def _fixed_serve_queue(engine, cfg, trace=None):
    """Fixed-batch baseline behind the ``serve_queue`` contract:
    batches formed in arrival order; each batch starts once its last
    member has arrived and the previous batch finished (the whole
    batch then blocks on its longest request).  Stamps run on the
    modeled timeline so latency = done_s - arrival_s is honest.  With
    a ``MeasuredTrace`` each batch is a measured segment placed where
    it starts on that timeline."""

    def serve(arrivals):
        reqs = [_make_request(cfg, i, a)
                for i, (_, a) in enumerate(arrivals)]
        if trace is not None:
            trace.reset()
        t = 0.0
        done = []
        for i in range(0, len(reqs), engine.batch):
            group = reqs[i:i + engine.batch]
            base = max(t, max(r.arrival_s for r in group))

            def batch(now, group=group, base=base):
                wall0 = now()
                engine.run_batch(group,
                                 now=lambda: base + (now() - wall0))
                return now() - wall0

            dt = (batch(time.perf_counter) if trace is None
                  else trace.run(base, batch))
            t = base + dt
            done.extend(group)
        return done

    return serve


def _continuous_serve_queue(engine, cfg, trace=None):
    def serve(arrivals):
        reqs = [_make_request(cfg, i, a)
                for i, (_, a) in enumerate(arrivals)]
        if trace is None:
            return engine.serve(reqs)
        trace.reset()
        return trace.run(0.0, lambda now: engine.serve(reqs, now=now))

    return serve


def metrics(device="cuda", smoke: bool = False) -> dict:
    """Measured numbers keyed as the reference's (tokens/s and tokens/J
    per engine plus the continuous-over-fixed speedup ratio), with each
    run's review verdict and the device; on the card also each engine's
    measured accelerator J and tokens/J at the accelerator."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.power_model import SystemPowerModel
    from repro_torch.harness import (CallableSUT, MeasuredTrace, PowerRun,
                                     Server, measured_domains,
                                     measured_sysdesc, throughput_watts,
                                     throughput_work)
    from repro_torch.hw import DATACENTER_H100, EDGE_SYSTEM
    from repro_torch.models import build_model
    from repro_torch.power.nvml import NVML
    from repro_torch.serving import ContinuousBatchingEngine, ServeEngine

    dev = resolve_device(device)
    measured = dev.type == "cuda"
    cfg = get_config("qwen3-1.7b")
    if not measured:
        cfg = reduce_config(cfg)
    model = build_model(cfg, dev)
    params = model.init(0)
    fixed = ServeEngine(model, params, max_len=MAX_LEN, batch_size=SLOTS,
                        device=dev)
    cont = ContinuousBatchingEngine(model, params, max_len=MAX_LEN,
                                    n_slots=SLOTS, chunk_steps=4,
                                    device=dev)
    n = 12 if smoke else 24
    # saturating offered load: both engines run backlogged, the
    # comparison isolates scheduling + host-sync overhead
    qps = 200.0

    edge = SystemPowerModel(EDGE_SYSTEM, 1)
    busy_w = throughput_watts(edge, cfg, 100.0)

    # warm both engines outside the timed region
    warm = [(None, 0.0)] * SLOTS
    _fixed_serve_queue(fixed, cfg)(warm)
    _continuous_serve_queue(cont, cfg)(warm)

    scenario = Server(target_qps=qps, latency_slo_s=10.0,
                      min_duration_s=0.0, min_queries=n, mode="queue")
    serves = {"fixed": partial(_fixed_serve_queue, fixed, cfg),
              "continuous": partial(_continuous_serve_queue, cont, cfg)}
    nvml = NVML(dev) if measured else None
    try:
        if measured:
            h100 = SystemPowerModel(DATACENTER_H100, 1)
            energy_meter = nvml.energy_meter()

            def measured_sut(name, make_serve):
                trace = MeasuredTrace(energy_meter)
                return CallableSUT(
                    name=f"serving-{name}", serve_queue=make_serve(trace),
                    domains_factory=lambda outcome: measured_domains(
                        h100, throughput_work(cfg, outcome.result.qps),
                        trace.source()),
                    psu=h100.psu(), sysdesc=measured_sysdesc(h100))

            suts = {name: measured_sut(name, make)
                    for name, make in serves.items()}
        else:
            suts = {name: CallableSUT(name=f"serving-{name}",
                                      serve_queue=make(), power=busy_w)
                    for name, make in serves.items()}

        def run_once(sut):
            # 1 kHz sampling resolves each engine's sub-second duration
            # (applied to every channel of the SUT's meter stack)
            return PowerRun(sut, scenario, seed=0, sample_hz=1000.0).run()

        # interleaved best-of-4: keeps the speedup ratio honest under
        # temporally-correlated machine noise
        from repro_torch.benchmarks.common import interleaved_best_of

        best = interleaved_best_of(
            {name: partial(run_once, sut) for name, sut in suts.items()})
    finally:
        if nvml is not None:
            nvml.close()

    out: dict = {"qps": qps,
                 "device": (torch.cuda.get_device_name(dev) if measured
                            else "cpu")}
    for name, r in best.items():
        m = r.outcome.server
        dur = r.outcome.result.duration_s
        out[name] = {
            "tokens_per_s": m.tokens_per_s,
            "tok_per_j": m.total_tokens / max(r.summary.energy_j, 1e-12),
            "us_per_tok": dur / m.total_tokens * 1e6,
            "review_passed": r.passed,
        }
        if measured:
            acc_j = r.per_domain_energy_j["accelerator"]
            out[name]["accelerator_j"] = acc_j
            out[name]["tok_per_j_accelerator"] = (m.total_tokens
                                                  / max(acc_j, 1e-12))
    out["speedup"] = (out["continuous"]["tokens_per_s"]
                      / max(out["fixed"]["tokens_per_s"], 1e-12))
    out["chunk_syncs"] = cont.host_syncs
    # gate the multi-channel sampling path itself on a representative
    # 4-channel rail stack (accelerator/dram/host + PSU-derived wall)
    from repro_torch.core.compliance import SystemDescription
    from repro_torch.harness import rail_domains
    from repro_torch.power import build_stack

    doms = rail_domains(edge, throughput_work(cfg, 100.0))
    stack = build_stack(
        doms, SystemDescription(scale="edge"), seed=0,
        sample_hz=1000.0, psu=edge.psu())
    out["meter_samples_per_s"] = meter_overhead(stack)
    return out


def meter_overhead(stack, duration_s: float = 2.0,
                   n_reps: int = 4) -> float:
    """Metering throughput of the multi-channel sampling path:
    channel-samples produced per second of metering wall time
    (best-of-``n_reps``; pure numpy, so a single max is stable)."""
    best = 0.0
    for _ in range(n_reps):
        t0 = time.perf_counter()
        out = stack.measure(duration_s)
        dt = time.perf_counter() - t0
        n = sum(len(t) for t, _ in out.values())
        best = max(best, n / max(dt, 1e-9))
    return best


def csv(device="cuda", smoke: bool = False) -> list[str]:
    m = metrics(device, smoke=smoke)
    qps = m["qps"]
    rows = []
    for name in ("fixed", "continuous"):
        p = m[name]
        rows.append(f"serving_{name}_qps{qps:.0f},"
                    f"{p['us_per_tok']:.1f},"
                    f"{p['tokens_per_s']:.1f}toks/s;"
                    f"{p['tok_per_j']:.3f}tok/J")
    rows.append(f"serving_continuous_speedup,0.0,"
                f"{m['speedup']:.2f}x;"
                f"chunk_syncs={m['chunk_syncs']}")
    rows.append(f"serving_meter_overhead,0.0,"
                f"{m['meter_samples_per_s']:.0f}samples/s")
    return rows


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    rows = csv(args.device, smoke=args.smoke)
    for row in rows:
        print(row)
    return rows


if __name__ == "__main__":
    main()
