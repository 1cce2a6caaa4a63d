"""Serving launcher of the port: one engine, seeded Poisson arrivals.

  python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --engine continuous --qps 8 --min-duration 5

``--engine continuous`` (the default here) feeds a seeded Poisson
arrival list to ``ContinuousBatchingEngine.serve``; ``--engine fixed``
serves the same requests in ``--batch``-sized groups through
``ServeEngine``.  ``--kv-page-size N`` gives the continuous engine a
paged KV cache of N-row pages, and ``--prefix-cache`` adds the radix
prefix cache over it.  ``--speculative`` turns on speculative decoding:
a draft model proposes ``--k`` tokens per slot and round and the target
verifies them in one forward; ``--draft truncate`` (the default) drafts
with the target's first ``--draft-layers`` blocks, an arch name drafts
with that model (fresh weights, same vocabulary).  The run prints TTFT
p50/p99, TPOT mean, tokens/s, the engine's host syncs, the kernels'
launch counts and, with the prefix cache, its hits, with
``--speculative`` the acceptance rate.  Weights are random, made from
``--seed``; prompts are random tokens.  ``--device`` defaults to
``cuda``.

  python -m repro_torch.launch.serve --arch qwen3-1.7b --reduce \
      --device cpu --speculative --k 4 --qps 20 --min-duration 0.5

``--arch rwkv6-3b`` serves the RWKV-6 stack through the same engines;
its prefill runs the linear-scan kernel and its cache is a fixed-size
recurrent state, so ``--kv-page-size``, ``--prefix-cache`` and
``--speculative`` are refused for it (as the reference refuses them).

  python -m repro_torch.launch.serve --arch rwkv6-3b --reduce \
      --device cpu --qps 20 --min-duration 0.5

Director-measured energy (``PowerRun``, tok/J) needs the engine SUTs
and a measured H100 power source, which are not ported yet (ROADMAP
§A.4; ``repro_torch.harness`` has the protocol itself), and the
options of the reference launcher for chunked prefill, preemption,
tensor parallelism and replicas are refused until their ROADMAP items
land.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs, reduce_config
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.kernels.paged_decode_attention.ops import (
    paged_decode_attention)
from repro_torch.kernels.paged_verify_attention.ops import (
    paged_verify_attention)
from repro_torch.kernels.verify_attention.ops import verify_attention
from repro_torch.models import build_model
from repro_torch.serving import (ContinuousBatchingEngine, Request,
                                 ServeEngine, truncate_draft)

# reference-launcher options that wait for a later slice
UNPORTED = {
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


def build_draft(args, cfg, model, params):
    """(draft_model, draft_params) for ``--speculative``: the target's
    first ``--draft-layers`` blocks (``--draft truncate``), or the arch
    ``--draft`` names (reduced alongside ``--reduce``) with fresh
    weights from ``--seed`` + 2; the vocabularies must match."""
    if args.draft == "truncate":
        return truncate_draft(model, params, n_layers=args.draft_layers)
    dcfg = get_config(args.draft)
    if args.reduce:
        dcfg = reduce_config(dcfg)
    if dcfg.vocab_size != cfg.vocab_size:
        raise SystemExit(
            f"--draft {args.draft}: vocab {dcfg.vocab_size} != target "
            f"vocab {cfg.vocab_size} (draft and target must share the "
            f"tokenizer)")
    dmodel = build_model(dcfg, args.device)
    return dmodel, dmodel.init(args.seed + 2)


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
    ap.add_argument("--kv-page-size", type=int, default=0)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--speculative", action="store_true",
                    help="speculative decoding: draft k tokens with a "
                         "small model, verify in one target forward")
    ap.add_argument("--draft", default="truncate",
                    help="draft model: 'truncate' (the target's first "
                         "--draft-layers blocks, shared embed/head) or "
                         "an arch name with a matching vocab")
    ap.add_argument("--draft-layers", type=int, default=2,
                    help="layers kept by --draft truncate")
    ap.add_argument("--k", type=int, default=4,
                    help="draft tokens per verify round")
    # refused until ported
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--preemption", action="store_true")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--replicas", type=int, default=1)
    args = ap.parse_args(argv)
    for name, item in UNPORTED.items():
        value = getattr(args, name)
        if value and not (name in ("tp", "replicas") and value == 1):
            ap.error(f"--{name.replace('_', '-')} is not ported yet: {item}")
    spec_k = args.k if args.speculative else 0
    if args.prompt_len + args.new_tokens + spec_k > args.max_len:
        ap.error("--prompt-len + --new-tokens (+ --k with --speculative) "
                 "must fit --max-len")
    if args.speculative and args.engine != "continuous":
        ap.error("--speculative is a continuous-engine decode mode; add "
                 "--engine continuous")
    if args.prefix_cache and not args.kv_page_size:
        ap.error("--prefix-cache needs --kv-page-size")
    if args.kv_page_size and args.engine != "continuous":
        ap.error("--kv-page-size needs --engine continuous")

    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduce_config(cfg)
    model = build_model(cfg, args.device)
    params = model.init(args.seed)
    if args.engine == "continuous":
        spec_kw, draft_name = {}, None
        if args.speculative:
            dmodel, dparams = build_draft(args, cfg, model, params)
            spec_kw = dict(draft_model=dmodel, draft_params=dparams,
                           spec_k=args.k)
            draft_name = dmodel.cfg.name
        engine = ContinuousBatchingEngine(
            model, params, max_len=args.max_len, n_slots=args.slots,
            chunk_steps=args.chunk_steps, device=args.device,
            kv_page_size=args.kv_page_size,
            prefix_caching=args.prefix_cache, **spec_kw)
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
    kernels = (decode_attention, flash_attention, paged_decode_attention,
               paged_verify_attention, verify_attention, linear_scan)
    for k in kernels:
        k.launches = 0
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
    print("  kernel launches: " + ", ".join(
        f"{k.__name__} {k.launches}" for k in kernels))
    if args.speculative:
        st = engine.spec_stats
        print(f"  speculative k={args.k} (draft {draft_name}): acceptance "
              f"{engine.acceptance_rate():.2f}, {st['rounds']} verified "
              f"slot-rounds")
    if getattr(engine, "prefix_caching", False):
        st = engine.prefix_stats
        print(f"  prefix cache: {st['hits']}/{st['lookups']} hits, "
              f"{st['cached_tokens']} prompt tokens served from cache, "
              f"{st['evicted_pages']} pages evicted, peak "
              f"{engine.page_pool.peak_used} pages (page size "
              f"{args.kv_page_size})")
    return m


if __name__ == "__main__":
    main()
