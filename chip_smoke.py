#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each fatal on failure:

1. Device: the card's name and ``nvidia-smi`` name and power limit.
2. Build: compile every CUDA kernel from ``src/repro_torch/kernels/csrc``.
3. Kernels vs their plain PyTorch versions on the card, bf16, at the
   main paths' shapes; each kernel's median time beside its plain
   version's, one PyTorch library call's (SDPA, a yardstick the port
   never calls) and the least time the card could take (its bound).
   Paged decode must also equal contiguous decode bit for bit on the
   same values, through a shuffled page table.
   Then every build the wrappers can launch (float32 and bfloat16,
   D 64 and 128, G 1/2/4/8) once at a small shape against its plain
   version.
4. Full-width engine: qwen3-1.7b (28 layers, d_model 2048, 16/8 heads,
   padded vocab 153,600, bf16, seeded random weights) behind
   ``ContinuousBatchingEngine(n_slots=8, max_len=2048, chunk_steps=8)``
   serves 16 Poisson-arriving requests; the kernels' launch counters
   must show that every layer's attention went through them.
5. Path consistency: the same weights and inputs through the kernel
   path and the plain path (prefill into 4 slots, then teacher-forced
   ragged decode steps); logits are compared in float32.
6. Full-width paged engine with prefix caching (page size 16): 24
   Poisson-arriving requests, 18 of them behind one shared 1,024-token
   system prompt; hits extend through paged verify, misses prefill
   through flash, every decode step goes through paged decode.
7. Token identity: phase 4's requests through the contiguous engine and
   through a paged engine with shuffled pages give the same tokens; a
   prefix hit's first-token logits match a cold prefill's.

The line before the last holds the kernels' JSON record; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside
a checkout of the repository, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense bf16 flop/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# Tolerances of the repo's kernel tests (tests/test_kernels.py:16).  In
# bf16, kernel and plain version both accumulate in float32 and round
# once to bf16, so they may differ by one bf16 ulp of the output (2^-7
# relative); 2e-2 absolute + 2e-2 relative covers that with margin.  In
# float32 (TF32 is off in the port) only the summation order differs.
TOLS = {"bfloat16": dict(rtol=2e-2, atol=2e-2),
        "float32": dict(rtol=1e-4, atol=1e-4)}

# A check tied to the output's size: ||kernel - plain|| / ||plain||.  On
# randn inputs a deep row's softmax is nearly flat and its output is a
# mean of ~n value rows, ~1/sqrt(n) per element, so 2e-2 per element is
# about half a typical value there.  Dropping one position at depth n
# moves the output by ~1/sqrt(n) of its norm (2.6% at n = 1500); one
# rounding of the same float32 value to bf16 moves it by under 2^-9.
REL_NORM_TOL = {"bfloat16": 5e-3, "float32": 1e-5}

# Phase 5: the kernel and plain paths round attention to bf16 at slightly
# different points; through 28 bf16 layers those one-ulp differences
# grow.  Logits are compared relative to their largest magnitude.
LOGIT_REL_TOL = 5e-2
ARGMAX_AGREE_MIN = 0.9


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms, CUDA events per call."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(label: str, got, want) -> tuple[float, float]:
    """Hold a kernel's output against its plain version's, per element
    and by norm; returns (max abs error, relative norm error)."""
    import torch
    dtype = str(want.dtype).removeprefix("torch.")
    diff = got.float() - want.float()
    err = float(diff.abs().max())
    rel = float(diff.norm() / want.float().norm().clamp_min(1e-30))
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    check(torch.allclose(got.float(), want.float(), **TOLS[dtype]),
          f"{label} disagrees with its plain version: max abs err {err}")
    check(rel <= REL_NORM_TOL[dtype],
          f"{label}: ||kernel - plain|| / ||plain|| = {rel} > "
          f"{REL_NORM_TOL[dtype]}")
    return err, rel


def phase_kernels(torch, dev):
    """Phase 3: each kernel against its plain version, then timed."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.paged_decode_attention.ops import (
        paged_decode_attention, paged_decode_attention_plain)
    from repro_torch.kernels.paged_verify_attention.ops import (
        paged_verify_attention, paged_verify_attention_plain)

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    out = {}

    # --- decode: 8 slots, KVH 8, G 2, D 128, S 2048 ---------------------
    b, kvh, g, d, s = 8, 8, 2, 128, 2048
    h = kvh * g
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(bf16)
    kc = torch.randn((b, s, kvh, d), generator=gen, device=dev).to(bf16)
    vc = torch.randn((b, s, kvh, d), generator=gen, device=dev).to(bf16)
    ragged = torch.tensor([0, 2047, 1024, 17, 511, 1500, 300, 2000],
                          dtype=torch.int32, device=dev)
    errs, rels = [], []
    for name, pos in (("ragged", ragged),
                      ("scalar", torch.tensor(1023, dtype=torch.int32,
                                              device=dev))):
        got = decode_attention(q, kc, vc, pos)
        want = decode_attention_plain(q, kc, vc, pos)
        err, rel = compare(f"decode_attention ({name} pos)", got, want)
        errs.append(err)
        rels.append(rel)
        print(f"  decode_attention pos={name}: max |kernel - plain| "
              f"{err:.3e}, ||kernel - plain|| / ||plain|| {rel:.3e}")
    mask = (torch.arange(s, device=dev)[None, :]
            <= ragged[:, None])[:, None, None, :]       # (B, 1, 1, S)
    ms = time_ms(lambda: decode_attention(q, kc, vc, ragged))
    plain_ms = time_ms(lambda: decode_attention_plain(q, kc, vc, ragged))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
        attn_mask=mask, enable_gqa=True))
    rows = int((ragged.long() + 1).sum())           # positions read
    nbytes = rows * kvh * d * 2 * 2 + 2 * q.numel() * 2
    flops = rows * h * d * 4
    bound_ms, bound_by = bound(nbytes, flops)
    out["decode_attention"] = dict(
        max_abs_err=max(errs), rel_norm_err=max(rels), ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms)
    print(f"  decode_attention B={b} KVH={kvh} G={g} D={d} S={s} ragged "
          f"pos: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
          f"{library_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us "
          f"({bound_by}, {nbytes} B)")

    # --- flash: Sq = Skv in {17, 511, 1024}, H 16, KVH 8, D 128 ----------
    h, kvh = 16, 8
    errs, rels = [], []
    for sq in (17, 511, 1024):
        q = torch.randn((1, sq, h, d), generator=gen, device=dev).to(bf16)
        k = torch.randn((1, sq, kvh, d), generator=gen, device=dev).to(bf16)
        v = torch.randn((1, sq, kvh, d), generator=gen, device=dev).to(bf16)
        got = flash_attention(q, k, v, causal=True)
        want = flash_attention_plain(q, k, v, causal=True)
        err, rel = compare(f"flash_attention (S={sq})", got, want)
        errs.append(err)
        rels.append(rel)
        print(f"  flash_attention S={sq}: max |kernel - plain| {err:.3e}, "
              f"||kernel - plain|| / ||plain|| {rel:.3e}")
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, causal=True))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True))
    sq = q.shape[1]
    flops = 4 * h * d * sq * (sq + 1) // 2          # causal pairs only
    nbytes = (2 * sq * h * d + 2 * sq * kvh * d) * 2
    bound_ms, bound_by = bound(nbytes, flops)
    out["flash_attention"] = dict(
        max_abs_err=max(errs), rel_norm_err=max(rels), ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms)
    print(f"  flash_attention S={sq} H={h} KVH={kvh} D={d}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} "
          f"ms, bound {bound_ms * 1e3:.2f} us ({bound_by}, {flops} flop)")

    # --- paged: decode's K/V scattered into a pool of 16-row pages ------
    # handed out in a shuffled order; page 0 holds large finite garbage
    ps, h = 16, kvh * g
    nb = s // ps
    pages = (torch.randperm(b * nb, generator=gen, device=dev) + 1).reshape(
        b, nb).to(torch.int32)
    kp = torch.full((b * nb + 1, ps, kvh, d), 1e4, dtype=bf16, device=dev)
    vp = torch.full_like(kp, -1e4)
    kp[pages.long()] = kc.reshape(b, nb, ps, kvh, d)
    vp[pages.long()] = vc.reshape(b, nb, ps, kvh, d)
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(bf16)
    got = paged_decode_attention(q, kp, vp, pages, ragged)
    err, rel = compare("paged_decode_attention", got,
                       paged_decode_attention_plain(q, kp, vp, pages,
                                                    ragged))
    check(torch.equal(got, decode_attention(q, kc, vc, ragged)),
          "paged_decode_attention is not bit-identical to decode_attention "
          "on the same values through a shuffled page table")
    ms = time_ms(lambda: paged_decode_attention(q, kp, vp, pages, ragged))
    plain_ms = time_ms(lambda: paged_decode_attention_plain(
        q, kp, vp, pages, ragged))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
        attn_mask=mask, enable_gqa=True))
    blocks = int(((ragged.long() + ps) // ps).sum())   # table entries read
    nbytes = (rows * kvh * d * 2 * 2 + 2 * q.numel() * 2 + blocks * 4
              + b * 4)
    flops = rows * h * d * 4
    bound_ms, bound_by = bound(nbytes, flops)
    out["paged_decode_attention"] = dict(
        max_abs_err=err, rel_norm_err=rel, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    print(f"  paged_decode_attention max |kernel - plain| {err:.3e}, "
          f"||kernel - plain|| / ||plain|| {rel:.3e}, torch.equal to "
          f"decode_attention: True")
    print(f"  paged_decode_attention B={b} KVH={kvh} G={g} D={d} page {ps} "
          f"x {nb} ragged pos: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, SDPA (contiguous, no gather) {library_ms:.4f} ms, bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}, {nbytes} B)")

    # --- paged verify: windows at ragged starts, across page boundaries
    errs, rels = [], []
    for t, starts in ((1, [15, 1031, 1030, 0, 511, 1500, 300, 2047]),
                      (4, [14, 1023, 1030, 0, 509, 1500, 300, 2044]),
                      (200, [15, 1031, 1030, 0, 511, 1500, 300, 1848])):
        pos = torch.tensor(starts, dtype=torch.int32, device=dev)
        q = torch.randn((b, t, h, d), generator=gen, device=dev).to(bf16)
        err, rel = compare(f"paged_verify_attention (T={t})",
                           paged_verify_attention(q, kp, vp, pages, pos),
                           paged_verify_attention_plain(q, kp, vp, pages,
                                                        pos))
        errs.append(err)
        rels.append(rel)
        print(f"  paged_verify_attention T={t}: max |kernel - plain| "
              f"{err:.3e}, ||kernel - plain|| / ||plain|| {rel:.3e}")
    # timed at a prefix hit's shape: one slot, a 200-token suffix behind
    # 1,024 cached tokens
    t, start = 200, 1024
    q = torch.randn((1, t, h, d), generator=gen, device=dev).to(bf16)
    pos = torch.tensor([start], dtype=torch.int32, device=dev)
    pg1 = pages[:1]
    ms = time_ms(lambda: paged_verify_attention(q, kp, vp, pg1, pos))
    plain_ms = time_ms(lambda: paged_verify_attention_plain(
        q, kp, vp, pg1, pos))
    skv = start + t
    kc1 = kp[pg1.long()].reshape(1, nb * ps, kvh, d)[:, :skv]
    vc1 = vp[pg1.long()].reshape(1, nb * ps, kvh, d)[:, :skv]
    vmask = (torch.arange(skv, device=dev)[None, :]
             <= start + torch.arange(t, device=dev)[:, None])[None, None]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), kc1.transpose(1, 2), vc1.transpose(1, 2),
        attn_mask=vmask, enable_gqa=True))
    pairs = t * start + t * (t + 1) // 2            # visible (query, key)
    flops = 4 * h * d * pairs
    nbytes = (skv * kvh * d * 2 * 2 + 2 * q.numel() * 2
              + -(-skv // ps) * 4 + 4)
    bound_ms, bound_by = bound(nbytes, flops)
    out["paged_verify_attention"] = dict(
        max_abs_err=max(errs), rel_norm_err=max(rels), ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=library_ms)
    print(f"  paged_verify_attention B=1 T={t} at pos {start} H={h} "
          f"KVH={kvh} D={d}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"SDPA (contiguous, no gather) {library_ms:.4f} ms, bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}, {flops} flop, {nbytes} B)")
    return out


def phase_builds(torch, dev):
    """Phase 3, second part: every build the wrappers can launch (the
    kernels are templates on dtype, D and, for decode, G), once each at
    a small ragged shape against the plain version: paged verify with a
    5-token window across a page boundary."""
    import itertools
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.paged_decode_attention.ops import (
        paged_decode_attention, paged_decode_attention_plain)
    from repro_torch.kernels.paged_verify_attention.ops import (
        paged_verify_attention, paged_verify_attention_plain)

    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    b, kvh, s, sq = 3, 2, 300, 77       # sq: not a multiple of a tile
    ps, nb = 16, 19                     # 304 rows of pages hold s
    pos = torch.tensor([0, s - 1, 137], dtype=torch.int32, device=dev)
    starts = torch.tensor([0, 290, 133], dtype=torch.int32, device=dev)
    pages = (torch.randperm(b * nb, generator=gen, device=dev) + 1).reshape(
        b, nb).to(torch.int32)
    for dtype, d, g in itertools.product((torch.float32, torch.bfloat16),
                                         (64, 128), (1, 2, 4, 8)):
        h = kvh * g
        name = f"{str(dtype).removeprefix('torch.')} D={d} G={g}"

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        q = randn(b, 1, h, d)
        kc, vc = randn(b, s, kvh, d), randn(b, s, kvh, d)
        dec = compare(f"decode_attention {name}",
                      decode_attention(q, kc, vc, pos),
                      decode_attention_plain(q, kc, vc, pos))
        # the same rows, padded to whole pages, in a shuffled pool
        kc = torch.cat([kc, randn(b, nb * ps - s, kvh, d)], 1)
        vc = torch.cat([vc, randn(b, nb * ps - s, kvh, d)], 1)
        kp, vp = randn(b * nb + 1, ps, kvh, d), randn(b * nb + 1, ps, kvh, d)
        kp[0], vp[0] = 1e4, -1e4
        kp[pages.long()] = kc.reshape(b, nb, ps, kvh, d)
        vp[pages.long()] = vc.reshape(b, nb, ps, kvh, d)
        got = paged_decode_attention(q, kp, vp, pages, pos)
        pdec = compare(f"paged_decode_attention {name}", got,
                       paged_decode_attention_plain(q, kp, vp, pages, pos))
        check(torch.equal(got, decode_attention(q, kc, vc, pos)),
              f"paged_decode_attention {name} is not bit-identical to "
              f"decode_attention")
        q = randn(b, 5, h, d)
        pver = compare(f"paged_verify_attention {name}",
                       paged_verify_attention(q, kp, vp, pages, starts),
                       paged_verify_attention_plain(q, kp, vp, pages,
                                                    starts))
        q = randn(2, sq, h, d)
        k, v = randn(2, sq, kvh, d), randn(2, sq, kvh, d)
        fl = compare(f"flash_attention {name}",
                     flash_attention(q, k, v, causal=True),
                     flash_attention_plain(q, k, v, causal=True))
        print(f"  {name}: decode max err {dec[0]:.2e} rel {dec[1]:.2e}; "
              f"flash {fl[0]:.2e}/{fl[1]:.2e}; paged decode "
              f"{pdec[0]:.2e}/{pdec[1]:.2e} (= decode); paged verify "
              f"{pver[0]:.2e}/{pver[1]:.2e}")


def launch_counters() -> dict:
    """The kernel wrappers, by name; each carries its ``launches``."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_decode_attention.ops import (
        paged_decode_attention)
    from repro_torch.kernels.paged_verify_attention.ops import (
        paged_verify_attention)
    return {k.__name__: k for k in (decode_attention, flash_attention,
                                    paged_decode_attention,
                                    paged_verify_attention)}


def print_served(m: dict, wall_s: float, engine) -> None:
    print(f"  served {m['requests']} requests, {m['tokens']} tokens in "
          f"{wall_s:.3f} s: {m['tokens_per_s']:.1f} tokens/s, TTFT "
          f"p50/p99 {m['ttft_p50_s'] * 1e3:.1f}/{m['ttft_p99_s'] * 1e3:.1f}"
          f" ms, TPOT mean {m['tpot_mean_s'] * 1e3:.2f} ms, host syncs "
          f"{engine.host_syncs}, decode steps {engine.decode_steps}")


def phase_engine(torch, dev, model, params):
    """Phase 4: serve 16 requests through the full-width engine."""
    import numpy as np
    from repro_torch.launch.serve import poisson_arrivals, summarize
    from repro_torch.serving import ContinuousBatchingEngine, Request

    cfg = model.cfg
    engine = ContinuousBatchingEngine(model, params, max_len=2048,
                                      n_slots=8, chunk_steps=8, device=dev)
    rng = np.random.default_rng(0)
    n = 16
    arrivals = poisson_arrivals(8.0, 0.0, seed=0, min_queries=n)[:n]
    requests = [Request(rid=i,
                        prompt=rng.integers(0, cfg.vocab_size,
                                            int(rng.integers(128, 1025))),
                        max_new_tokens=int(rng.integers(32, 129)),
                        arrival_s=float(a))
                for i, a in enumerate(arrivals)]
    # warm-up (cuBLAS handles, kernel libraries) outside the counted run
    engine.serve([Request(rid=-1, prompt=np.arange(64), max_new_tokens=9)],
                 honor_arrivals=False)
    torch.cuda.synchronize()
    kernels = launch_counters()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    done = engine.serve(requests)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    m = summarize(done, wall_s)
    print_served(m, wall_s, engine)
    print("  launches: " + ", ".join(f"{k} {n}"
                                     for k, n in launches.items()))
    check(len(done) == n, f"{len(done)} of {n} requests completed")
    for r in done:
        check(len(r.output) == r.max_new_tokens,
              f"request {r.rid}: {len(r.output)} of {r.max_new_tokens} "
              f"tokens")
        check(all(0 <= t < model.vp for t in r.output),
              f"request {r.rid}: token outside the padded vocabulary")
    check(launches["decode_attention"]
          == cfg.n_layers * engine.decode_steps,
          f"decode launches {launches['decode_attention']} != "
          f"{cfg.n_layers} layers x {engine.decode_steps} decode steps")
    check(launches["flash_attention"] == cfg.n_layers * n,
          f"flash launches {launches['flash_attention']} != "
          f"{cfg.n_layers} layers x {n} admissions")
    check(engine.host_syncs * engine.chunk_steps == engine.decode_steps,
          "more than one host copy per decode chunk")
    check(launches["paged_decode_attention"]
          == launches["paged_verify_attention"] == 0,
          "the contiguous engine launched a paged kernel")
    return engine, requests, launches


def phase_consistency(torch, dev, cfg, params):
    """Phase 5: kernel path vs plain path on the same weights."""
    import numpy as np
    from repro_torch.models import build_model

    rng = np.random.default_rng(1)
    lens = (300, 17, 1024, 129)
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab_size, n),
                               device=dev)[None] for n in lens]
    forced = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 6)),
                             device=dev)
    runs = []
    for kernels in (True, False):
        model = build_model(cfg, dev, kernels=kernels)
        cache = model.init_cache(len(lens), 1280, per_slot_pos=True)
        logits = []
        with torch.no_grad():
            for b, prompt in enumerate(prompts):
                row = {"blocks": {k: t[:, b:b + 1] for k, t in
                                  cache["layers"]["blocks"].items()}}
                lg, one = model.prefill(params, {"tokens": prompt},
                                        max_len=1280, cache=row)
                cache["pos"][b] = one["pos"]
                logits.append(lg[0, -1])
            for step in range(forced.shape[1]):
                lg, cache = model.decode_step(params, cache,
                                              forced[:, step:step + 1])
                logits.extend(lg[:, -1])
        runs.append(torch.stack(logits).float())
    got, want = runs
    rel = float((got - want).abs().max() / want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"  {got.shape[0]} logit rows (4 prefills + 6 ragged decode "
          f"steps x 4 slots): max |kernel - plain| / max |plain| = "
          f"{rel:.3e}, argmax agreement {agree:.3f}")
    check(bool(torch.isfinite(got).all()), "non-finite logits")
    check(rel <= LOGIT_REL_TOL, f"kernel-path logits differ by {rel}")
    check(agree >= ARGMAX_AGREE_MIN, f"argmax agreement {agree}")


def phase_paged_engine(torch, dev, model, params):
    """Phase 6: the paged, prefix-caching engine at full width: 24
    Poisson requests, 18 behind one shared 1,024-token system prompt
    with unique 64-512-token tails, 6 unique 128-1,024-token prompts,
    interleaved."""
    import numpy as np
    from repro_torch.launch.serve import poisson_arrivals, summarize
    from repro_torch.serving import ContinuousBatchingEngine, Request

    cfg = model.cfg
    engine = ContinuousBatchingEngine(
        model, params, max_len=2048, n_slots=8, chunk_steps=8,
        kv_page_size=16, prefix_caching=True, device=dev)
    rng = np.random.default_rng(0)
    n = 24
    arrivals = poisson_arrivals(8.0, 0.0, seed=0, min_queries=n)[:n]
    system = rng.integers(0, cfg.vocab_size, 1024)
    shared = rng.permutation(np.arange(n) < 18)
    requests = []
    for i, a in enumerate(arrivals):
        if shared[i]:
            prompt = np.concatenate([system, rng.integers(
                0, cfg.vocab_size, int(rng.integers(64, 513)))])
        else:
            prompt = rng.integers(0, cfg.vocab_size,
                                  int(rng.integers(128, 1025)))
        requests.append(Request(rid=i, prompt=prompt,
                                max_new_tokens=int(rng.integers(32, 129)),
                                arrival_s=float(a)))
    # warm-up: a miss and a hit, outside the counted run
    warm = rng.integers(0, cfg.vocab_size, 80)
    engine.serve([Request(rid=-1, prompt=warm, max_new_tokens=9),
                  Request(rid=-2, prompt=np.concatenate([warm, [1, 2]]),
                          max_new_tokens=9)], honor_arrivals=False)
    torch.cuda.synchronize()
    kernels = launch_counters()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    done = engine.serve(requests)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    m = summarize(done, wall_s)
    st = engine.prefix_stats
    misses = st["lookups"] - st["hits"]
    print_served(m, wall_s, engine)
    print(f"  prefix cache: {st['hits']}/{st['lookups']} hits, "
          f"{st['cached_tokens']} prompt tokens served from cache, "
          f"{st['evicted_pages']} pages evicted, peak "
          f"{engine.page_pool.peak_used} pages of {engine.n_pages - 1} "
          f"(page size {engine.page_size})")
    print("  launches: " + ", ".join(f"{k} {n}"
                                     for k, n in launches.items()))
    check(len(done) == n, f"{len(done)} of {n} requests completed")
    for r in done:
        check(len(r.output) == r.max_new_tokens,
              f"request {r.rid}: {len(r.output)} of {r.max_new_tokens} "
              f"tokens")
        check(all(0 <= t < model.vp for t in r.output),
              f"request {r.rid}: token outside the padded vocabulary")
    check(st["lookups"] == n, f"{st['lookups']} prefix lookups != {n}")
    check(st["hits"] >= 17, f"only {st['hits']} prefix hits")
    layers = cfg.n_layers
    check(launches["paged_decode_attention"]
          == layers * engine.decode_steps,
          f"paged decode launches {launches['paged_decode_attention']} != "
          f"{layers} layers x {engine.decode_steps} decode steps")
    check(launches["paged_verify_attention"] == layers * st["hits"],
          f"paged verify launches {launches['paged_verify_attention']} != "
          f"{layers} layers x {st['hits']} hits")
    check(launches["flash_attention"] == layers * misses,
          f"flash launches {launches['flash_attention']} != {layers} "
          f"layers x {misses} misses")
    check(launches["decode_attention"] == 0,
          "the paged engine launched contiguous decode attention")
    check(engine.host_syncs * engine.chunk_steps == engine.decode_steps,
          "more than one host copy per decode chunk")
    return launches


def phase_token_identity(torch, dev, model, params, engine, requests):
    """Phase 7: phase 4's requests through its contiguous engine and a
    paged engine with shuffled pages (no prefix cache) must give the
    same tokens: prefill is the same flash kernel and paged decode is
    bit-identical to decode.  A prefix hit computes its suffix through
    paged verify, so there phase 5's rule holds instead: its first-token
    logits against a cold prefill's."""
    import copy

    import numpy as np
    from repro_torch.serving import (ContinuousBatchingEngine, PagePool,
                                     Request)

    def serve(eng):
        done = eng.serve(copy.deepcopy(requests), honor_arrivals=False)
        return {r.rid: r.output for r in done}

    want = serve(engine)
    paged = ContinuousBatchingEngine(model, params, max_len=2048,
                                     n_slots=8, chunk_steps=8,
                                     kv_page_size=16, device=dev)
    order = np.random.default_rng(7).permutation(paged.n_pages - 1) + 1
    paged.page_pool = PagePool(paged.n_pages, paged.page_size,
                               order=order.tolist())
    got = serve(paged)
    same = sum(got[rid] == want[rid] for rid in want)
    print(f"  {same}/{len(want)} requests token-identical (paged, shuffled "
          f"pages vs contiguous), {sum(len(o) for o in got.values())} "
          f"tokens")
    check(same == len(want), "paged engine tokens differ from the "
          "contiguous engine's")

    # prefix hits vs cold prefills, at the engine's own page arithmetic
    cfg = model.cfg
    hit_eng = ContinuousBatchingEngine(model, params, max_len=2048,
                                       n_slots=8, chunk_steps=8,
                                       kv_page_size=16, prefix_caching=True,
                                       device=dev)
    rng = np.random.default_rng(3)
    system = rng.integers(0, cfg.vocab_size, 1024)
    hit_eng.serve([Request(rid=0, prompt=np.concatenate(
        [system, rng.integers(0, cfg.vocab_size, 40)]), max_new_tokens=1)],
        honor_arrivals=False)
    rows = []
    with torch.no_grad():
        for tail in (1, 17, 64, 300):
            toks = tuple(int(x) for x in np.concatenate(
                [system, rng.integers(0, cfg.vocab_size, tail)]))
            row, start = hit_eng._acquire_pages(toks, len(toks), 1)
            check(start == 1024, f"prefix hit covered {start} tokens")
            prompt = torch.as_tensor(toks, device=dev)[None]
            mini = {"layers": hit_eng.state["cache"]["layers"],
                    "pos": torch.tensor([start], dtype=torch.int32,
                                        device=dev),
                    "pages": hit_eng._table_row(row)[None]}
            lg_hit, _ = model.verify_step(params, mini, prompt[:, start:])
            lg_cold, _ = model.prefill(params, {"tokens": prompt})
            rows.append((lg_hit[0, -1].float(), lg_cold[0, -1].float()))
            for p in row:
                hit_eng.page_pool.unref(p)
    hit = torch.stack([a for a, _ in rows])
    cold = torch.stack([b for _, b in rows])
    rel = float((hit - cold).abs().max() / cold.abs().max())
    agree = float((hit.argmax(-1) == cold.argmax(-1)).float().mean())
    print(f"  prefix hits (1,024 cached tokens, tails 1/17/64/300) vs cold "
          f"prefill: max |hit - cold| / max |cold| = {rel:.3e}, argmax "
          f"agreement {agree:.2f}")
    check(bool(torch.isfinite(hit).all()), "non-finite logits on a hit")
    check(rel <= LOGIT_REL_TOL, f"prefix-hit logits differ by {rel}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found: run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_leaves

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def phase(title: str) -> None:
        print(f"{title}  [t = {time.perf_counter() - t_start:.1f} s]")

    phase("phase 1: device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{kind}")
    print(smi.strip())

    phase("phase 2: build")
    t0 = time.perf_counter()
    build.build_all()
    print(f"  built in {time.perf_counter() - t0:.2f} s")
    for name, (secs, log) in build.build_log.items():
        report = [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln]
        print(f"  {name}.cu: nvcc {secs:.2f} s; " + " | ".join(report[:4]))

    phase("phase 3: kernels vs plain versions (bf16, main-path shapes)")
    kernels = phase_kernels(torch, dev)
    phase("phase 3b: every kernel build vs its plain version (small shapes)")
    phase_builds(torch, dev)

    phase("phase 4: full-width qwen3-1.7b engine")
    cfg = get_config("qwen3-1.7b")
    model = build_model(cfg, dev)
    params = model.init(seed=0)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"  {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, d_head {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, padded vocab {model.vp}, {n_params / 1e9:.3f} B "
          f"params ({cfg.dtype})")
    engine, requests, launches = phase_engine(torch, dev, model, params)

    phase("phase 5: kernel path vs plain path")
    phase_consistency(torch, dev, cfg, params)

    phase("phase 6: full-width paged engine with prefix caching")
    paged_launches = phase_paged_engine(torch, dev, model, params)

    phase("phase 7: paged vs contiguous tokens; prefix hit vs cold logits")
    phase_token_identity(torch, dev, model, params, engine, requests)

    # launches: each kernel's count on its own path's run (phase 4 for
    # the contiguous kernels, phase 6 for the paged ones)
    dec = "src/repro/kernels/decode_attention/decode_attention.py"
    sources = {
        "decode_attention": (f"{dec}:351", launches),
        "flash_attention": (
            "src/repro/kernels/flash_attention/flash_attention.py:77",
            launches),
        "paged_decode_attention": (f"{dec}:266", paged_launches),
        "paged_verify_attention": (f"{dec}:308", paged_launches)}
    record = {"kernels": [
        dict(name=name, route="cuda",
             source=f"src/repro_torch/kernels/csrc/{name}.cu",
             replaces=replaces, launches=counts[name], **kernels[name])
        for name, (replaces, counts) in sources.items()]}
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi.strip())
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
