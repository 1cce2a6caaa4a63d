"""Energy per cached token: the paged KV cache's prefix-sharing sweep
(the port of ``benchmarks/prefix_cache.py``).

The serving stack's radix prefix cache lets requests that share a
prompt prefix reuse the prefilled KV pages of earlier requests — a hit
computes only its unique suffix.  This sweep measures what that is
worth in Joules on the queue-form Server scenario, at prefix-hit rates
0, 0.5 and 0.9 over a prompt mix where a long shared system prompt
(``SHARED_LEN`` tokens) dominates a short unique tail:

- **tok/J and tok/s** per hit rate (PowerRun-integrated Director
  trace; the reference's acceptance bar is tok/J at hit-rate 0.9 >=
  1.3x hit-rate 0, on its CPU);
- **J saved per cached token**: (E(0) - E(h)) / cached_tokens(h) —
  the headline energy value of one prompt token served from cache;
- **admission capacity**: how many concurrent request contexts the
  page pool can hold at each mix (shared pages counted once), vs the
  contiguous layout's ``pool / pages-per-slot`` — the second win of
  paging: shared prefixes stop occupying one copy per slot;
- **page-allocator ops/s**: a host-side microbenchmark of the
  refcounting free-list allocator (alloc/ref/unref).

Every point serves identical budgets (same decode tokens), so tok/J
ratios between hit rates isolate the prefill compute the cache
skipped.  The geometry, request stream, repetitions, keys and CSV rows
are the reference's.

- On the CPU (``device="cpu"``): the reduced qwen3-1.7b, every rail
  the reference's model.
- On the card (the default): the full-width qwen3-1.7b, and each SUT's
  accelerator rail is the card's NVML energy counter (the H100
  system's host rail modeled, the wall derived through its PSU); each
  point also reports its measured accelerator Joules and tokens/J
  there, and every point ``review_passed``.

  PYTHONPATH=src python -m repro_torch.benchmarks.prefix_cache \\
      [--device cpu] [--smoke]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

SLOTS = 4
PAGE_SIZE = 8
MAX_LEN = 128
SHARED_LEN = 112                # shared system-prompt tokens (14 pages)
SUFFIX_LEN = 8                  # unique per-request tail
PROMPT_LEN = SHARED_LEN + SUFFIX_LEN
NEW_TOKENS = 4                  # short decode: prefill-dominated mix
HIT_RATES = (0.0, 0.5, 0.9)
N_REPS = 4
QPS = 2000.0                    # backlogged: measure the engine, not
                                # the arrival schedule


def _prompt(cfg, rid: int, shared: bool) -> np.ndarray:
    """Deterministic prompts: a fixed shared prefix + per-rid tail, or
    a fully per-rid prompt of the same length."""
    rng = np.random.default_rng(10_000 + rid)
    tail = rng.integers(0, cfg.vocab_size, SUFFIX_LEN)
    if not shared:
        head = rng.integers(0, cfg.vocab_size, SHARED_LEN)
        return np.concatenate([head, tail]).astype(np.int64)
    head = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                             SHARED_LEN)
    return np.concatenate([head, tail]).astype(np.int64)


def _make_request(cfg, rid: int, arrival_s: float, hit_rate: float):
    from repro_torch.serving import Request

    # spread the shared-prefix requests through the stream so hits and
    # misses interleave at every rate (the first shared one still
    # misses and pays the intern)
    shared = (rid % 10) < round(hit_rate * 10)
    return Request(rid=rid, prompt=_prompt(cfg, rid, shared),
                   max_new_tokens=NEW_TOKENS, arrival_s=float(arrival_s))


def _prepare_point(name, engine, cfg, hit_rate, n_queries, energy_meter):
    from repro_torch.core.loadgen import qid_of
    from repro_torch.harness import ContinuousBatchingSUT, PowerRun, Server

    def make_request(i, s, a):
        return _make_request(cfg, qid_of(s, i), a, hit_rate)

    # warmup outside the measurement: a miss, a hit (the extend path),
    # and a full decode chunk
    engine.serve([_make_request(cfg, 10 ** 6 + j, 0.0, 1.0)
                  for j in range(2)], honor_arrivals=False)
    sut = ContinuousBatchingSUT(engine, cfg, name=f"prefix-{name}",
                                make_request=make_request,
                                energy_meter=energy_meter)
    scenario = Server(target_qps=QPS, latency_slo_s=30.0,
                      min_duration_s=0.0, min_queries=n_queries,
                      mode="queue")

    def run_once():
        r = PowerRun(sut, scenario, seed=0, sample_hz=1000.0).run()
        # snapshot this repetition's cache accounting alongside it
        r.prefix_stats = dict(engine.prefix_stats)
        r.peak_pages = engine.page_pool.peak_used
        return r

    return run_once


def _capacity(usable_pages: int, hit_rate: float) -> int:
    """Concurrent request contexts the pool can hold at this mix:
    shared pages are resident once, each context then needs only its
    unique pages.  (Contiguous layout equivalent: SLOTS contexts.)"""
    pages_per_ctx = -(-(PROMPT_LEN + NEW_TOKENS) // PAGE_SIZE)
    shared_pages = SHARED_LEN // PAGE_SIZE
    unique_pages = pages_per_ctx - shared_pages
    if hit_rate <= 0:
        return usable_pages // pages_per_ctx
    # one resident copy of the shared prefix; hits add unique pages,
    # the (1 - h) misses still carry full contexts
    per_ctx = hit_rate * unique_pages + (1 - hit_rate) * pages_per_ctx
    return int((usable_pages - shared_pages) // per_ctx)


def _alloc_ops_per_s() -> float:
    """Host microbenchmark: allocator ops/s over alloc/ref/unref
    cycles shaped like admission traffic (16-page contexts, one
    shared-14 ref bump, interleaved frees)."""
    from repro_torch.serving import PagePool

    pool = PagePool(4097, PAGE_SIZE)
    shared = pool.alloc(14)
    t0 = time.perf_counter()
    live: list[list[int]] = []
    while pool.alloc_ops < 200_000:
        for p in shared:
            pool.ref(p)
        live.append(pool.alloc(2))
        if len(live) > 64:
            for p in live.pop(0):
                pool.unref(p)
            for p in shared:
                pool.unref(p)
    dt = time.perf_counter() - t0
    return pool.alloc_ops / max(dt, 1e-9)


def _model(dev):
    """The served model: full-width qwen3-1.7b on the card, reduced on
    the CPU; seeded weights."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import build_model

    cfg = get_config("qwen3-1.7b")
    if dev.type != "cuda":
        cfg = reduce_config(cfg)
    model = build_model(cfg, dev)
    return cfg, model, model.init(0)


def _points(dev, smoke: bool) -> dict:
    from repro_torch.benchmarks.common import interleaved_best_of
    from repro_torch.power.nvml import NVML
    from repro_torch.serving import ContinuousBatchingEngine

    measured = dev.type == "cuda"
    cfg, model, params = _model(dev)
    n = 10 if smoke else 20

    nvml = NVML(dev) if measured else None
    try:
        setups: dict = {}
        for h in HIT_RATES:
            name = f"hit{int(h * 100)}"
            eng = ContinuousBatchingEngine(
                model, params, max_len=MAX_LEN, n_slots=SLOTS,
                chunk_steps=4, kv_page_size=PAGE_SIZE, prefix_caching=True,
                device=dev)
            meter = nvml.energy_meter() if measured else None
            setups[name] = (_prepare_point(name, eng, cfg, h, n, meter),
                            eng, h)

        best = interleaved_best_of(
            {name: run_once for name, (run_once, _, _) in setups.items()},
            n_reps=N_REPS)
    finally:
        if nvml is not None:
            nvml.close()

    points: dict = {}
    for name, (_, eng, h) in setups.items():
        r = best[name]
        m = r.outcome.server
        usable = eng.page_pool.n_pages - 1
        points[name] = {
            "tokens_per_s": m.tokens_per_s,
            "tok_per_j": m.total_tokens / max(r.summary.energy_j, 1e-12),
            "us_per_tok": (r.outcome.result.duration_s
                           / max(1, m.total_tokens) * 1e6),
            "energy_j": r.summary.energy_j,
            "cached_tokens": r.prefix_stats["cached_tokens"],
            "hits": r.prefix_stats["hits"],
            "lookups": r.prefix_stats["lookups"],
            "peak_pages": r.peak_pages,
            "capacity_ctx": _capacity(usable, h),
            "review_passed": r.passed,
        }
        if measured:
            acc_j = r.per_domain_energy_j["accelerator"]
            points[name]["accelerator_j"] = acc_j
            points[name]["tok_per_j_accelerator"] = (m.total_tokens
                                                     / max(acc_j, 1e-12))
    # the headline: Joules one cached prompt token is worth, from the
    # widest spread (hit-rate 0 vs 0.9 at identical decode budgets)
    e0 = points["hit0"]["energy_j"]
    for name, p in points.items():
        if p["cached_tokens"]:
            p["j_saved_per_cached_token"] = ((e0 - p["energy_j"])
                                             / p["cached_tokens"])
    points["allocator"] = {"page_alloc_ops_per_s": _alloc_ops_per_s()}
    return points


def metrics(device="cuda", smoke: bool = False) -> dict:
    """Hit-rate sweep keyed as the reference's, plus ``review_passed``
    per point (and the measured accelerator figures on the card)."""
    from repro_torch import resolve_device

    return _points(resolve_device(device), smoke)


def csv(device="cuda", smoke: bool = False) -> list[str]:
    points = metrics(device, smoke=smoke)
    rows = []
    for name, p in points.items():
        if name == "allocator":
            rows.append(f"prefix_{name},0.0,"
                        f"{p['page_alloc_ops_per_s']:.0f}ops/s")
            continue
        derived = (f"{p['tokens_per_s']:.1f}toks/s;"
                   f"{p['tok_per_j']:.3f}tok/J;"
                   f"hits={p['hits']}/{p['lookups']};"
                   f"capacity={p['capacity_ctx']}ctx;"
                   f"peak={p['peak_pages']}pages")
        if "j_saved_per_cached_token" in p:
            derived += (f";{p['j_saved_per_cached_token'] * 1e3:.2f}"
                        f"mJ/cached_tok")
        rows.append(f"prefix_{name},{p['us_per_tok']:.1f},{derived}")
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
