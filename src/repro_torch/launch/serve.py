"""Serving launcher of the port: one engine, seeded Poisson arrivals.

  python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --engine continuous --qps 8 --min-duration 5

``--engine continuous`` (the default here) feeds a seeded Poisson
arrival list to ``ContinuousBatchingEngine.serve``; ``--engine fixed``
serves the same requests in ``--batch``-sized groups through
``ServeEngine``.  The run prints TTFT p50/p99, TPOT mean, tokens/s,
the engine's host syncs and the kernels' launch counts.  Weights are
random, made from ``--seed``; prompts are random tokens.  ``--device``
defaults to ``cuda``.

Director-measured energy (``PowerRun``, tok/J) needs the harness,
core and power modules, which are not ported yet (ROADMAP §A.4), and
the options of the reference launcher for speculative decoding, paged
KV, prefix caching, chunked prefill, preemption, tensor parallelism
and replicas are refused until their ROADMAP items land.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs, reduce_config
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import build_model
from repro_torch.serving import ContinuousBatchingEngine, Request, ServeEngine

# reference-launcher options that wait for a later slice
UNPORTED = {
    "speculative": "ROADMAP §A.7 (speculative decoding)",
    "kv_page_size": "ROADMAP §A.5 (paged KV)",
    "prefix_cache": "ROADMAP §A.5 (prefix caching)",
    "prefill_chunk": "ROADMAP §A.6 (chunked prefill)",
    "preemption": "ROADMAP §A.6 (preemption)",
    "tp": "ROADMAP §A.8 (tensor parallel)",
    "replicas": "ROADMAP §A.4 (replicas behind one queue)",
}


def poisson_arrivals(qps: float, min_duration_s: float, seed: int,
                     min_queries: int = 1) -> np.ndarray:
    """Arrival times (s) of a seeded Poisson process, extended past
    ``min_duration_s`` until at least ``min_queries`` queries exist."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    while t < min_duration_s or len(out) < min_queries:
        t += rng.exponential(1.0 / qps)
        out.append(t)
    return np.asarray(out)


def make_requests(arrivals, vocab: int, prompt_len: int, new_tokens: int,
                  seed: int) -> list[Request]:
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, prompt_len),
                    max_new_tokens=new_tokens, arrival_s=float(a))
            for i, a in enumerate(arrivals)]


def summarize(done: list[Request], wall_s: float) -> dict:
    """Latency and throughput of a served request list."""
    ttft = np.asarray([r.ttft_s() for r in done if r.ttft_s() is not None])
    tpot = np.asarray([r.tpot_s() for r in done
                       if r.tpot_s() is not None and len(r.output) > 1])
    tokens = sum(len(r.output or []) for r in done)
    return {"requests": len(done), "tokens": tokens,
            "tokens_per_s": tokens / max(wall_s, 1e-9),
            "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft.size
            else float("nan"),
            "ttft_p99_s": float(np.percentile(ttft, 99)) if ttft.size
            else float("nan"),
            "tpot_mean_s": float(tpot.mean()) if tpot.size
            else float("nan")}


def _serve_fixed(engine, requests, honor_arrivals):
    """Serve ``requests`` in arrival-order batches; a batch starts once
    its last request has arrived (times on the serve clock)."""
    t0 = time.perf_counter()

    def now():
        return time.perf_counter() - t0

    done = []
    for i in range(0, len(requests), engine.batch):
        group = requests[i:i + engine.batch]
        wait_s = max(r.arrival_s for r in group) - now()
        if honor_arrivals and wait_s > 0:
            time.sleep(wait_s)
        done += engine.run_batch(group, now=now)
    return done


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--engine", default="continuous",
                    choices=["fixed", "continuous"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--chunk-steps", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--qps", type=float, default=4.0)
    ap.add_argument("--min-duration", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=0)
    # refused until ported
    ap.add_argument("--speculative", action="store_true")
    ap.add_argument("--kv-page-size", type=int, default=0)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--preemption", action="store_true")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--replicas", type=int, default=1)
    args = ap.parse_args(argv)
    for name, item in UNPORTED.items():
        value = getattr(args, name)
        if value and not (name in ("tp", "replicas") and value == 1):
            ap.error(f"--{name.replace('_', '-')} is not ported yet: {item}")
    if args.prompt_len + args.new_tokens > args.max_len:
        ap.error("--prompt-len + --new-tokens must fit --max-len")

    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduce_config(cfg)
    model = build_model(cfg, args.device)
    params = model.init(args.seed)
    if args.engine == "continuous":
        engine = ContinuousBatchingEngine(
            model, params, max_len=args.max_len, n_slots=args.slots,
            chunk_steps=args.chunk_steps, device=args.device)
    else:
        engine = ServeEngine(model, params, max_len=args.max_len,
                             batch_size=args.batch, device=args.device)
    arrivals = poisson_arrivals(args.qps, args.min_duration, args.seed)

    def run(reqs, honor_arrivals):
        if args.engine == "continuous":
            return engine.serve(reqs, honor_arrivals=honor_arrivals)
        return _serve_fixed(engine, reqs, honor_arrivals)

    # warm-up outside the measurement: one request end to end
    run(make_requests([0.0], cfg.vocab_size, args.prompt_len,
                      args.new_tokens, args.seed + 1), False)
    requests = make_requests(arrivals, cfg.vocab_size, args.prompt_len,
                             args.new_tokens, args.seed + 2)
    decode_attention.launches = flash_attention.launches = 0
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    t0 = time.perf_counter()
    done = run(requests, True)
    wall_s = time.perf_counter() - t0
    m = summarize(done, wall_s)
    device = (torch.cuda.get_device_name(model.device)
              if model.device.type == "cuda" else "cpu")
    print(f"{args.arch}{' (reduced)' if args.reduce else ''} "
          f"{args.engine} on {device}: {m['requests']} requests, "
          f"{m['tokens']} tokens in {wall_s:.3f} s")
    print(f"  TTFT p50/p99: {m['ttft_p50_s'] * 1e3:.1f}/"
          f"{m['ttft_p99_s'] * 1e3:.1f} ms, TPOT mean: "
          f"{m['tpot_mean_s'] * 1e3:.2f} ms, "
          f"{m['tokens_per_s']:.1f} tokens/s, host syncs: "
          f"{getattr(engine, 'host_syncs', 'n/a')}")
    print(f"  kernel launches: decode_attention "
          f"{decode_attention.launches}, flash_attention "
          f"{flash_attention.launches}")
    return m


if __name__ == "__main__":
    main()
