"""Serving under measurement, both engines, via ``repro_torch.harness``
(PyTorch port of ``examples/serve_power.py``):

1. Offline scenario -- the fixed-batch ``ServeEngine`` behind
   ``ServeEngineSUT`` issues blocking batches (throughput-bound).
2. Server scenario -- Poisson arrivals feed the admission queue of the
   slot-based ``ContinuousBatchingEngine`` (``ContinuousBatchingSUT``).
   Finished slots are refilled mid-flight and decoding runs in
   on-device chunks, so the reported TTFT/TPOT reflect real queueing +
   continuous batching.  ``PowerRun`` attributes the Director's power
   samples per request automatically (``per_request_energy_j``).

Each run is one call: ``PowerRun(sut, scenario).run()`` -- loadgen,
Director protocol, summarizer, and compliance review included.  The
model is granite-3-2b: at full width by default (40 layers, d_model
2,048, 32 query and 8 KV heads of 64, d_ff 8,192, vocabulary 49,155
padded), as the card serves it, or the reference's reduced config with
``--reduce``; weights from seed 0.  Latencies and throughput are
``--device``'s own; the power rails are modeled (the edge system, as in
the reference), not the card's measured draw.

  PYTHONPATH=src python -m repro_torch.examples.serve_power \\
      [--device cuda] [--reduce] [--min-duration S] [--server-duration S]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduce_config
from repro_torch.harness import (ContinuousBatchingSUT, Offline, PowerRun,
                                 ServeEngineSUT, Server)
from repro_torch.models import build_model
from repro_torch.serving import ContinuousBatchingEngine, Request, ServeEngine

ARCH = "granite-3-2b"
PROMPT, MAX_LEN, BATCH = 16, 96, 4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduce", action="store_true",
                    help="the reference's reduced config")
    ap.add_argument("--min-duration", type=float, default=60.0,
                    help="the Offline run's minimum window (the "
                    "reference's 60 s)")
    ap.add_argument("--server-duration", type=float, default=0.5,
                    help="the Server run's minimum window (the "
                    "reference's 0.5 s; a window under ~2 s can miss "
                    "R12's 95 %% sample coverage at 10 Hz)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(ARCH)
    if args.reduce:
        cfg = reduce_config(cfg)
    model = build_model(cfg, dev)
    params = model.init(seed=0)

    def make_req(i, arrival_s=0.0, new_tokens=8):
        rng = np.random.default_rng([1, i])
        return Request(rid=i,
                       prompt=rng.integers(0, cfg.vocab_size, PROMPT),
                       max_new_tokens=new_tokens, arrival_s=arrival_s)

    # ------------------------------------------------------------------
    # Offline: fixed batches, the device's timing of one batch per issue
    # ------------------------------------------------------------------
    engine = ServeEngine(model, params, max_len=MAX_LEN, batch_size=BATCH,
                         device=dev)
    engine.run_batch([make_req(100 + j) for j in range(BATCH)])  # warm

    offline_sut = ServeEngineSUT(
        engine, cfg, name=f"{ARCH}-offline",
        make_requests=lambda samples: [make_req(BATCH * s["idx"] + j)
                                       for s in samples[:1]
                                       for j in range(BATCH)])
    offline = PowerRun(offline_sut,
                       Offline(batch=BATCH,
                               min_duration_s=args.min_duration),
                       seed=0).run()
    res = offline.outcome.result
    print(f"Offline: {res.n_queries} queries, {res.qps:.2f} samples/s, "
          f"p90 {res.p90 * 1e3:.1f} ms, "
          f"{offline.samples_per_joule:.4f} samples/J "
          f"(review {'ACCEPTED' if offline.passed else 'REJECTED'})")

    # ------------------------------------------------------------------
    # Server: Poisson arrivals -> continuous-batching admission queue.
    # Mixed token budgets make the fixed-batch straggler problem real;
    # the slot engine retires short requests early and refills.
    # ------------------------------------------------------------------
    cont = ContinuousBatchingEngine(model, params, max_len=MAX_LEN,
                                    n_slots=BATCH, chunk_steps=4,
                                    device=dev)
    cont.serve([make_req(200, new_tokens=4)],
               honor_arrivals=False)                  # warmup
    server_sut = ContinuousBatchingSUT(
        cont, cfg, name=f"{ARCH}-server",
        make_request=lambda i, s, a: make_req(
            i, arrival_s=a, new_tokens=(4, 12, 8)[i % 3]))
    run = PowerRun(server_sut,
                   Server(target_qps=res.qps * 2, latency_slo_s=10.0,
                          mode="queue",
                          min_duration_s=args.server_duration),
                   seed=0)
    r = run.run()
    m = r.outcome.server
    print(f"Server:  {r.outcome.result.qps:.2f} qps, "
          f"{m.tokens_per_s:.1f} tok/s, "
          f"p99 {r.outcome.result.p99 * 1e3:.1f} ms, "
          f"SLO met: {r.outcome.slo_met}")
    print(f"  TTFT p99 {m.ttft_p(99) * 1e3:.1f} ms, "
          f"TPOT mean {m.tpot_mean * 1e3:.2f} ms, "
          f"host syncs {cont.host_syncs}")
    e = np.asarray(list((r.per_request_energy_j or {}).values()))
    print(f"energy: {r.summary.energy_j:.1f} J -> "
          f"{r.samples_per_joule:.4f} samples/J, "
          f"{m.total_tokens / max(r.summary.energy_j, 1e-9):.3f} tok/J, "
          f"per-request mean {e.mean():.2f} J")
    # the meter stack's per-domain split: DC rails vs the wall boundary
    print("per-domain: " + ", ".join(
        f"{k}={v:.1f} J" for k, v in sorted(r.per_domain_energy_j.items())))
    print(r.report.render())
    return {"cfg": cfg, "offline": offline, "server": r,
            "host_syncs": cont.host_syncs}


if __name__ == "__main__":
    main()
