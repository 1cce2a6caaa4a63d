"""Paged-serving smoke: paged KV must be invisible to tokens (PyTorch
port of ``scripts/paged_smoke.py``).

The paged engine (block-granular KV pool + page-table-indirect
attention + radix prefix cache) must produce *token-identical* greedy
output to the contiguous engine -- any drift means masking or page
indirection is wrong, not a tuning difference.  On reduced qwen3-1.7b
(weights from seed 0) this checks:

- TP 1 paged-vs-contiguous parity, both in-order and shuffled page
  hand-out order (catches anything that secretly relies on physical
  contiguity);
- prefix-cache hits (shared prompt prefix): identical output to a cold
  prefill, with cached/prefill token accounting;
- speculative + paged parity (verify rollback across page boundaries);
- chunked prefill (SLO-aware interleaved admission) parity at TP 1;
- preempt/park/resume parity at TP 1: a high-priority arrival under
  page-pool pressure parks a best-effort request, which resumes via the
  prefix-cache extend path with zero token drift;
- TP ``--tp`` (default 4) sharded paged parity, one gloo process a rank
  on the CPU (``parallel.run_tp``), including hits through the sharded
  extend path, plus the chunked and preempt/resume checks again.  A
  machine with one card has no second rank, so the sharded parities
  always run on the CPU, whatever ``--device`` says; each rank holds
  them against an unsharded engine of its own on the CPU.

The TP 1 parities run on ``--device`` (default ``cuda``, which raises
without a GPU; there they go through the hand-written kernels, at heads
of 64: ``dev_smoke.device_config``).  Exit 0
= all parities hold.

  PYTHONPATH=src python -m repro_torch.scripts.paged_smoke [--device cuda]
      [--tp 4]     # --tp 0 or 1: no sharded run
"""
from __future__ import annotations

import argparse
import copy
import sys

import numpy as np

ARCH = "qwen3-1.7b"
BUDGETS = [5, 9, 3, 12, 1, 7]
TP_TIMEOUT_S = 600.0


def _mixed_requests(budgets, prompt_len=8):
    from repro_torch.serving import Request

    return [Request(rid=i, prompt=np.arange(prompt_len) + 3 * i,
                    max_new_tokens=b) for i, b in enumerate(budgets)]


def _shared_prefix_requests():
    from repro_torch.serving import Request

    shared = list(np.arange(16) + 100)
    return [Request(rid=i,
                    prompt=np.asarray(shared + [200 + i, 201 + i]),
                    max_new_tokens=6) for i in range(4)]


def _preempt_requests():
    from repro_torch.serving import Request

    # two best-effort 12-token prompts fill the 8 usable pages of the
    # contended pool exactly (12 prompt + 4 new = 4 pages each); the
    # high-priority short that lands mid-decode must park one to admit
    return [Request(rid=0, prompt=np.arange(12) + 7, max_new_tokens=4,
                    arrival_s=0.0, priority=0),
            Request(rid=1, prompt=np.arange(12) + 40, max_new_tokens=4,
                    arrival_s=0.0, priority=0),
            Request(rid=2, prompt=np.arange(4) + 90, max_new_tokens=4,
                    arrival_s=0.01, priority=1, deadline_s=0.05)]


def _outputs(engine, requests):
    done = engine.serve(copy.deepcopy(requests), honor_arrivals=False)
    return {r.rid: list(map(int, r.output)) for r in done}, done


def _say(msg: str, log: list) -> None:
    log.append(msg)
    print(f"[paged-smoke] {msg}", flush=True)


def _preempt_parity(tag, engine, ref_out, say) -> dict:
    from repro_torch.serving import Request

    engine.serve([Request(rid=80, prompt=np.arange(12) + 300,
                          max_new_tokens=2),
                  Request(rid=81, prompt=np.arange(4) + 400,
                          max_new_tokens=2)],
                 honor_arrivals=False)     # warm, off the clock
    t = [0.0]

    def now():
        t[0] += 0.002        # every clock read ticks: the priority
        return t[0]          # arrival lands while both slots decode

    def sleep(dt):
        t[0] += max(0.0, dt)

    done = engine.serve(copy.deepcopy(_preempt_requests()),
                        now=now, sleep=sleep)
    stats = dict(engine.sched_stats)
    assert stats["preemptions"] >= 1, (tag, stats)
    assert stats["resumes"] >= 1, (tag, stats)
    out = {r.rid: list(map(int, r.output)) for r in done}
    assert out == ref_out, f"{tag} preempt/resume output diverged"
    say(f"{tag} preempt/resume parity OK "
        f"(preemptions={stats['preemptions']})")
    return stats


def _model(device):
    import torch

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import build_model
    from repro_torch.scripts.dev_smoke import device_config

    cfg = device_config(reduce_config(get_config(ARCH)),
                        torch.device(device))
    model = build_model(cfg, device)
    return model, model.init(seed=0)


def tp1_parities(device, log: list) -> dict:
    """Every TP 1 parity on ``device``; returns the engines' stats."""
    from repro_torch.serving import (ContinuousBatchingEngine, PagePool,
                                     Scheduler)

    model, params = _model(device)

    def cbe(**kw):
        kw.setdefault("max_len", 64)
        kw.setdefault("n_slots", 3)
        kw.setdefault("chunk_steps", 4)
        return ContinuousBatchingEngine(model, params, device=device, **kw)

    stats = {}
    ref = cbe()
    ref_mixed, _ = _outputs(ref, _mixed_requests(BUDGETS))
    ref_shared, _ = _outputs(ref, _shared_prefix_requests())

    # TP 1: page indirection must not change a single token
    eng = cbe(kv_page_size=8)
    out, _ = _outputs(eng, _mixed_requests(BUDGETS))
    assert out == ref_mixed, "TP=1 paged output diverged"
    _say("TP=1 paged parity OK (in-order pool)", log)

    order = list(np.random.default_rng(7).permutation(
        np.arange(1, eng.n_pages)))
    eng.page_pool = PagePool(eng.n_pages, eng.page_size, order=order)
    eng.reset()
    out, _ = _outputs(eng, _mixed_requests(BUDGETS))
    assert out == ref_mixed, "shuffled-pool paged output diverged"
    _say("TP=1 paged parity OK (shuffled pool order)", log)

    # chunked prefill: 20-token prompts walk 8-token chunks (2 full + a
    # 4-token tail) interleaved with decode -- tokens must not move
    long_reqs = _mixed_requests([4, 6, 5], prompt_len=20)
    ref_long, _ = _outputs(ref, long_reqs)
    ck = cbe(kv_page_size=8, prefill_chunk_tokens=8)
    out, _ = _outputs(ck, long_reqs)
    assert out == ref_long, "TP=1 chunked-prefill output diverged"
    assert ck.sched_stats["prefill_chunks"] >= 9, ck.sched_stats
    stats["chunked"] = dict(ck.sched_stats)
    _say("TP=1 chunked-prefill parity OK "
         f"(chunks={ck.sched_stats['prefill_chunks']})", log)

    # prefix hits: shared 16-token prefix, unique 2-token suffixes
    pc = cbe(n_slots=2, kv_page_size=8, prefix_caching=True)
    out, done = _outputs(pc, _shared_prefix_requests())
    assert out == ref_shared, "prefix-hit output diverged"
    hits = [r for r in done if r.cached_tokens]
    assert hits, "expected prefix hits on a shared prefix"
    assert all(r.cached_tokens == 16 and r.prefill_tokens == 2
               for r in hits), "hit token accounting wrong"
    stats["prefix"] = dict(pc.prefix_stats)
    _say(f"prefix-hit parity OK ({pc.prefix_stats})", log)

    # speculative + paged: verify rollback across page boundaries
    sp_kw = dict(n_slots=2, chunk_steps=3, draft_model=model,
                 draft_params=params, spec_k=2)
    ref_spec, _ = _outputs(cbe(**sp_kw), _mixed_requests([6, 4, 9]))
    sp = cbe(kv_page_size=8, prefix_caching=True, **sp_kw)
    out, _ = _outputs(sp, _mixed_requests([6, 4, 9]))
    assert out == ref_spec, "speculative paged output diverged"
    _say("speculative paged parity OK", log)

    # preempt/park/resume on a contended pool vs an uncontended run
    pre_kw = dict(max_len=16, n_slots=3, chunk_steps=2, kv_page_size=4)
    ref_pre, _ = _outputs(cbe(kv_pages=33, **pre_kw), _preempt_requests())
    stats["preempt"] = _preempt_parity("TP=1", cbe(
        kv_pages=9, prefix_caching=True,
        scheduler=Scheduler(preemption=True), **pre_kw), ref_pre,
        lambda m: _say(m, log))
    return stats


def _tp_parities(rank, tp):
    """One rank's sharded parities (SPMD: every rank serves the same
    requests), each against an unsharded engine on the CPU; returns
    rank 0's log."""
    from repro_torch.serving import (ContinuousBatchingEngine, Scheduler,
                                     ShardedContinuousBatchingEngine)

    model, params = _model("cpu")
    log = []
    say = (lambda m: _say(m, log)) if rank == 0 else (lambda m: None)

    def ref(**kw):
        return ContinuousBatchingEngine(model, params, device="cpu", **kw)

    def sharded(**kw):
        return ShardedContinuousBatchingEngine(model, params, tp=tp,
                                               rank=rank, device="cpu", **kw)

    base = dict(max_len=64, n_slots=3, chunk_steps=4)
    ref_mixed, _ = _outputs(ref(**base), _mixed_requests(BUDGETS))
    ref_shared, _ = _outputs(ref(**base), _shared_prefix_requests())
    long_reqs = _mixed_requests([4, 6, 5], prompt_len=20)
    ref_long, _ = _outputs(ref(**base), long_reqs)

    # TP on gloo ranks, including hits through the sharded extend path
    sh = sharded(kv_page_size=8, prefix_caching=True, **base)
    out, _ = _outputs(sh, _mixed_requests(BUDGETS))
    assert out == ref_mixed, f"TP={tp} paged output diverged"
    out, _ = _outputs(sh, _shared_prefix_requests())
    assert out == ref_shared, f"TP={tp} prefix-hit output diverged"
    assert sh.prefix_stats["hits"] >= 3, sh.prefix_stats
    say(f"TP={tp} paged parity OK ({sh.prefix_stats})")

    # chunked prefill through the sharded model
    sh_ck = sharded(kv_page_size=8, prefill_chunk_tokens=8, **base)
    out, _ = _outputs(sh_ck, long_reqs)
    assert out == ref_long, f"TP={tp} chunked-prefill output diverged"
    say(f"TP={tp} chunked-prefill parity OK")

    # preempt/park/resume through the sharded extend path
    pre_kw = dict(max_len=16, n_slots=3, chunk_steps=2, kv_page_size=4)
    ref_pre, _ = _outputs(ref(kv_pages=33, **pre_kw), _preempt_requests())
    _preempt_parity(f"TP={tp}", sharded(
        kv_pages=9, prefix_caching=True,
        scheduler=Scheduler(preemption=True), **pre_kw), ref_pre, say)
    return log if rank == 0 else None


def main(argv=None) -> int:
    from repro_torch import resolve_device
    from repro_torch.parallel import run_tp

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tp", type=int, default=4,
                    help="ranks of the sharded parities, gloo on the CPU "
                    "(0 or 1: none)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    log: list = []
    tp1_parities(dev, log)
    if args.tp > 1:
        print(f"[paged-smoke] TP={args.tp}: {args.tp} gloo ranks on the "
              f"CPU (one card has no second rank)", flush=True)
        log += run_tp(_tp_parities, args.tp, backend="gloo",
                      timeout_s=TP_TIMEOUT_S)
    _say("all parities hold", log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
