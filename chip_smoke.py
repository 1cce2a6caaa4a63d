#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each fatal on failure:

1. Device: the card's name and ``nvidia-smi`` name and power limit.
2. Build: compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (seven sources, one ``nvcc`` each, in parallel).
3. Kernels vs their plain PyTorch versions on the card, bf16, at the
   main paths' shapes; each kernel's median time beside its plain
   version's, one PyTorch library call's (SDPA, a yardstick the port
   never calls) and the least time the card could take (its bound).
   Paged decode must also equal contiguous decode bit for bit on the
   same values, through a shuffled page table, and likewise paged
   verify and contiguous verify.
   The linear scan (rwkv6-3b's prefill: B 1, T 1,024 and a ragged
   1,000, H 48, dh 64) against its plain chunked version, y and state.
   The W8A8 int8 GEMM at the tiny model's shape (M 12,544, K = N = 64,
   float32 out) and a qwen3-1.7b FFN up-projection (M 1,024, K 2,048,
   N 6,144, bf16 out), equal to its plain version bit for bit, beside
   ``torch._int_mm`` + the same epilogue and its bound at the int8 rate.
   Then every build the wrappers can launch (float32 and bfloat16,
   D 64 and 128, G 1/2/4/8; the scan at dh 32/64/128; the int8 GEMM at
   the reference test's shapes and ragged edges, both outputs) once at
   a small shape against its plain version.
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
8. Full-width speculative engine: the weights above with layers past 2
   damped to 0.001 (a high-acceptance pair) and a 2-layer truncated
   draft, ``spec_k=4``, serve phase 4's requests; verify, draft decode
   and flash launches are exact and the host copies once per chunk.
   The plain engine serves them on the same weights in the same call.
9. Speculative tokens: ``verify_step`` against sequential
   ``decode_step``s; plain against speculative engine offline (a
   divergence must start at a near-tie); paged speculative (shuffled
   pages) token-identical to contiguous speculative.
10. Full-width rwkv6-3b engine (the qwen3 engines freed first): 32
   RWKV-6 layers, d_model 2,560, 48 padded heads of 64, vocab 65,536,
   bf16, seeded random weights; phase 4's 16 requests (tokens redrawn
   in its vocabulary) through ``ContinuousBatchingEngine(n_slots=8,
   max_len=2048, chunk_steps=8)``; every layer's prefill scan went
   through the linear-scan kernel (launches = 32 x admissions).
11. rwkv6 consistency: prefill(prompt + 8 tokens) against
   prefill(prompt) and 8 decode steps (the state, and the token-shift
   rows ``x_prev_t``/``x_prev_c``, handed from prefill to decode) for 4
   slots at 300/17/1,000/129 tokens, and the kernel path against the
   plain path on the same prompts: held in float32 (the same seeded
   weights, full width), reported in bf16.

12. tiny-kws (4 layers, width 64, 12 classes, float32, seeded weights):
   the forward on the card against the same weights on the CPU (1e-5
   by norm); the W8A8 accuracy measurement (its four pointwise GEMMs,
   M 12,544, K = N = 64, through ``int8_matmul``: exactly 4 launches)
   against the same measurement through the plain GEMM (identical
   agreement and error), relative logit error < 0.02.
13. tiny-kws through the port's ``PowerRun``: SingleStream behind
   ``TinySUT`` (10 Hz frames, 200 queries, 2 s) and MultiStream
   8-sample bursts (64 queries, 0.5 s); both reviews must pass.
   Forward latencies are the card's; the µJ/inference is the modeled
   MCU's on the ``pin`` channel.

The line before the last holds the kernels' JSON record; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside
a checkout of the repository, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 flop/s and
# dense int8 op/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12

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

# The linear scan in float32: the plain version's chunked form takes
# exp of differences of within-chunk cumulative log decays (up to ~300
# in magnitude, float32 ulp ~3e-5) where the kernel multiplies the
# decays step by step, so they part by ~1e-5 relative: the reference's
# own scan tolerance (tests/test_kernels.py:167), and 1e-4 by norm.  In
# bf16 the repo's tolerances above hold.  The final state is float32 in
# both and is held within 5e-4, as in the reference's test.
SCAN_TOLS = {"bfloat16": (TOLS["bfloat16"], REL_NORM_TOL["bfloat16"]),
             "float32": (dict(rtol=5e-4, atol=5e-4), 1e-4)}
STATE_TOL = dict(rtol=5e-4, atol=5e-4)

# Phase 5: the kernel and plain paths round attention to bf16 at slightly
# different points; through 28 bf16 layers those one-ulp differences
# grow.  Logits are compared relative to their largest magnitude.
LOGIT_REL_TOL = 5e-2
ARGMAX_AGREE_MIN = 0.9

# Phase 11: random-weight rwkv6 amplifies rounding far more than the
# dense stack.  The reference's own bf16 prefill(prompt + 8) against
# prefill(prompt) + 8 decode steps parts by ~0.16 of max |logit| at 32
# layers (tests/test_torch_rwkv.py::test_handoff_error_is_rounding_
# as_in_the_reference), so phase 5's 5e-2 cannot tell a fault from
# rounding in bf16.  The same weights in float32 part by ~1e-4 there;
# a wrong token-shift row or state moves the logits by O(1).  So the
# handoff and the kernel-vs-plain path are held in float32, within
# 5e-3, and the bf16 numbers are reported.
F32_LOGIT_REL_TOL = 5e-3

# Phase 12: the tiny forward on the card against the same weights on the
# CPU, relative by norm; both float32 (TF32 off), only the matmuls'
# summation order differs (the CPU tests hold the port within 1e-5 of
# the reference the same way).  The W8A8 path's relative error must stay
# under the reference test's own gate (tests/test_kernels.py:130-141).
TINY_REL_TOL = 1e-5
INT8_REL_ERR_MAX = 0.02


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


def bound(nbytes: float, flops: float,
          peak: float = BF16_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(label: str, got, want, tols=None) -> tuple[float, float]:
    """Hold a kernel's output against its plain version's, per element
    and by norm (``tols``: (allclose kwargs, norm limit) by dtype, the
    repo's kernel tolerances unless given); returns (max abs error,
    relative norm error)."""
    import torch
    dtype = str(want.dtype).removeprefix("torch.")
    tol, rel_tol = (tols or {}).get(dtype,
                                    (TOLS[dtype], REL_NORM_TOL[dtype]))
    diff = got.float() - want.float()
    err = float(diff.abs().max())
    rel = float(diff.norm() / want.float().norm().clamp_min(1e-30))
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    check(torch.allclose(got.float(), want.float(), **tol),
          f"{label} disagrees with its plain version: max abs err {err}")
    check(rel <= rel_tol,
          f"{label}: ||kernel - plain|| / ||plain|| = {rel} > {rel_tol}")
    return err, rel


def compare_scan(torch, label: str, r, k, v, logw, u):
    """The linear scan against its plain version on the same inputs:
    y by ``compare`` at the scan's tolerances, the final state within
    ``STATE_TOL``.  Returns (max abs err of y, its norm error, max abs
    err of the state)."""
    from repro_torch.kernels.linear_scan.ops import (linear_scan,
                                                     linear_scan_plain)
    y, s = linear_scan(r, k, v, logw, u)
    yp, sp = linear_scan_plain(r, k, v, logw, u, return_state=True)
    err, rel = compare(label, y, yp, SCAN_TOLS)
    serr = float((s - sp).abs().max())
    check(bool(torch.isfinite(s).all()), f"{label}: non-finite state")
    check(torch.allclose(s, sp, **STATE_TOL),
          f"{label}: final state differs by {serr}")
    return err, rel, serr


def scan_inputs(torch, gen, dev, b, t, h, dh, dtype):
    """The reference's scan test inputs (tests/test_kernels.py:151-156)
    from ``gen``: r, k, v ~ N(0, 0.25) in ``dtype``, logw = -exp(N(0,
    0.25)) and u ~ N(0, 0.09) in float32."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    r, k, v = ((randn(b, t, h, dh) * 0.5).to(dtype) for _ in range(3))
    logw = -torch.exp(randn(b, t, h, dh) * 0.5)
    return r, k, v, logw, randn(h, dh) * 0.3


def phase_kernels(torch, dev):
    """Phase 3: each kernel against its plain version, then timed."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.linear_scan.ops import (linear_scan,
                                                     linear_scan_plain)
    from repro_torch.kernels.paged_decode_attention.ops import (
        paged_decode_attention, paged_decode_attention_plain)
    from repro_torch.kernels.paged_verify_attention.ops import (
        paged_verify_attention, paged_verify_attention_plain)
    from repro_torch.kernels.verify_attention.ops import (
        verify_attention, verify_attention_plain)

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

    # --- verify: the speculative window (T = k + 1 = 5) on the decode
    # cache, at the decode shape's ragged depths clipped to S - T
    t = 5
    pos = ragged.clamp(max=s - t)
    q = torch.randn((b, t, h, d), generator=gen, device=dev).to(bf16)
    got = verify_attention(q, kc, vc, pos)
    err, rel = compare("verify_attention", got,
                       verify_attention_plain(q, kc, vc, pos))
    check(torch.equal(got, paged_verify_attention(q, kp, vp, pages, pos)),
          "verify_attention is not bit-identical to paged_verify_attention "
          "on the same values through a shuffled page table")
    ms = time_ms(lambda: verify_attention(q, kc, vc, pos))
    plain_ms = time_ms(lambda: verify_attention_plain(q, kc, vc, pos))
    q_pos = pos[:, None] + torch.arange(t, device=dev)[None, :]   # (B, T)
    vmask = (torch.arange(s, device=dev)[None, None, :]
             <= q_pos[:, :, None])[:, None].expand(b, h, t, s)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
        attn_mask=vmask, enable_gqa=True))
    rows = int((pos.long() + t).sum())              # positions read
    nbytes = rows * kvh * d * 2 * 2 + 2 * q.numel() * 2 + b * 4
    flops = int((q_pos.long() + 1).sum()) * h * d * 4   # visible pairs
    bound_ms, bound_by = bound(nbytes, flops)
    out["verify_attention"] = dict(
        max_abs_err=err, rel_norm_err=rel, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    print(f"  verify_attention max |kernel - plain| {err:.3e}, "
          f"||kernel - plain|| / ||plain|| {rel:.3e}, torch.equal to "
          f"paged_verify_attention: True")
    print(f"  verify_attention B={b} T={t} KVH={kvh} G={g} D={d} S={s} "
          f"ragged pos: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
          f"(boolean (B, H, T, S) mask) {library_ms:.4f} ms, bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}, {nbytes} B, {flops} flop)")

    # --- linear scan: rwkv6-3b's prefill of 1,024 tokens (48 padded
    # heads of 64), then a ragged 1,000
    b, h, dh = 1, 48, 64
    errs, rels, serrs = [], [], []
    for t in (1024, 1000):
        r, k, v, logw, u = scan_inputs(torch, gen, dev, b, t, h, dh, bf16)
        err, rel, serr = compare_scan(torch, f"linear_scan (T={t})", r, k,
                                      v, logw, u)
        errs.append(err)
        rels.append(rel)
        serrs.append(serr)
        print(f"  linear_scan T={t}: max |kernel - plain| {err:.3e}, "
              f"||kernel - plain|| / ||plain|| {rel:.3e}, state max err "
              f"{serr:.3e}")
    r, k, v, logw, u = scan_inputs(torch, gen, dev, b, 1024, h, dh, bf16)
    ms = time_ms(lambda: linear_scan(r, k, v, logw, u))
    plain_ms = time_ms(lambda: linear_scan_plain(r, k, v, logw, u,
                                                 return_state=True))
    t = r.shape[1]
    # r, k, v, y in bf16, logw in f32, read or written once; u and the
    # f32 state; the recurrence's 5 dh^2 flop per step and head
    nbytes = (4 * r.numel() * 2 + logw.numel() * 4 + u.numel() * 4
              + b * h * dh * dh * 4)
    flops = 5 * b * t * h * dh * dh
    bound_ms, bound_by = bound(nbytes, flops)
    out["linear_scan"] = dict(
        max_abs_err=max(errs), rel_norm_err=max(rels),
        state_max_abs_err=max(serrs), ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    print(f"  linear_scan B={b} T={t} H={h} dh={dh}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, no library call, bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}, {nbytes} B, {flops} flop; "
          f"{flops / 67e12 * 1e6:.2f} us at float32's 67 TFLOP/s)")
    return out


def phase_builds(torch, dev):
    """Phase 3, second part: every build the wrappers can launch (the
    kernels are templates on dtype, D and, for decode, G), once each at
    a small ragged shape against the plain version: both verify kernels
    with a 5-token window (across a page boundary for paged verify),
    which must agree bit for bit."""
    import itertools
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.paged_decode_attention.ops import (
        paged_decode_attention, paged_decode_attention_plain)
    from repro_torch.kernels.paged_verify_attention.ops import (
        paged_verify_attention, paged_verify_attention_plain)
    from repro_torch.kernels.verify_attention.ops import (
        verify_attention, verify_attention_plain)

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
        got = paged_verify_attention(q, kp, vp, pages, starts)
        pver = compare(f"paged_verify_attention {name}", got,
                       paged_verify_attention_plain(q, kp, vp, pages,
                                                    starts))
        ver = verify_attention(q, kc, vc, starts)
        cver = compare(f"verify_attention {name}", ver,
                       verify_attention_plain(q, kc, vc, starts))
        check(torch.equal(ver, got), f"verify_attention {name} is not "
              f"bit-identical to paged_verify_attention")
        q = randn(2, sq, h, d)
        k, v = randn(2, sq, kvh, d), randn(2, sq, kvh, d)
        fl = compare(f"flash_attention {name}",
                     flash_attention(q, k, v, causal=True),
                     flash_attention_plain(q, k, v, causal=True))
        print(f"  {name}: decode max err {dec[0]:.2e} rel {dec[1]:.2e}; "
              f"flash {fl[0]:.2e}/{fl[1]:.2e}; paged decode "
              f"{pdec[0]:.2e}/{pdec[1]:.2e} (= decode); verify "
              f"{cver[0]:.2e}/{cver[1]:.2e}; paged verify "
              f"{pver[0]:.2e}/{pver[1]:.2e} (= verify)")
    # the scan: B 2, T 77 (no multiple of a staged block), H 3
    for dtype, dh in itertools.product((torch.float32, torch.bfloat16),
                                       (32, 64, 128)):
        name = f"{str(dtype).removeprefix('torch.')} dh={dh}"
        r, k, v, logw, u = scan_inputs(torch, gen, dev, 2, 77, 3, dh, dtype)
        err, rel, serr = compare_scan(torch, f"linear_scan {name}", r, k,
                                      v, logw, u)
        print(f"  linear_scan {name}: y max err {err:.2e} rel {rel:.2e}, "
              f"state {serr:.2e}")


def int8_inputs(torch, gen, dev, m, k, n):
    """x (M, K) and w (K, N) drawn from N(0, 1) and quantized as the
    tiny measurement quantizes them: per row of x, per column of w."""
    from repro_torch.kernels.int8_matmul import quantize_int8
    x = torch.randn((m, k), generator=gen, device=dev)
    w = torch.randn((k, n), generator=gen, device=dev)
    xq, sx = quantize_int8(x, axis=1)
    wq, sw = quantize_int8(w, axis=0)
    return xq, wq, sx, sw


def compare_int8(torch, label, xq, wq, sx, sw, out_dtype):
    """The int8 GEMM against its plain version: the integer sum is exact
    and the epilogue's two multiplies run in the same order, so the two
    must be equal bit for bit.  Returns the max abs difference (0)."""
    from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_plain
    got = int8_matmul(xq, wq, sx, sw, out_dtype=out_dtype)
    want = int8_matmul_plain(xq, wq, sx, sw, out_dtype)
    check(got.dtype == out_dtype and got.shape == want.shape,
          f"{label}: {got.dtype} {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    check(torch.equal(got, want),
          f"{label} is not bit-equal to its plain version: max abs err "
          f"{err}")
    return err


def phase_int8(torch, dev):
    """Phase 3, int8 GEMM: the tiny keyword spotter's pointwise GEMM (M
    12,544, K = N = 64, float32 out; the main path's shape) and a
    qwen3-1.7b FFN up-projection (M 1,024, K 2,048, N 6,144, bf16 out),
    each equal to its plain version and timed beside it, beside
    ``torch._int_mm`` + the same epilogue (a yardstick the port never
    calls) and beside its bound at the int8 rate."""
    from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    rec = {}
    for tag, (m, k, n), out_dtype in (
            ("tiny", (12544, 64, 64), torch.float32),
            ("lm", (1024, 2048, 6144), torch.bfloat16)):
        xq, wq, sx, sw = int8_inputs(torch, gen, dev, m, k, n)
        name = f"int8_matmul {tag} M={m} K={k} N={n} " \
               f"{str(out_dtype).removeprefix('torch.')}"
        err = compare_int8(torch, name, xq, wq, sx, sw, out_dtype)
        ms = time_ms(lambda: int8_matmul(xq, wq, sx, sw,
                                         out_dtype=out_dtype))
        plain_ms = time_ms(lambda: int8_matmul_plain(xq, wq, sx, sw,
                                                     out_dtype))
        library_ms = time_ms(lambda: ((torch._int_mm(xq, wq).float() * sx)
                                      * sw).to(out_dtype))
        # x, w read once, the scales once, the output written once
        out_bytes = 4 if out_dtype == torch.float32 else 2
        nbytes = m * k + k * n + 4 * (m + n) + m * n * out_bytes
        ops = 2 * m * n * k
        bound_ms, bound_by = bound(nbytes, ops, INT8_OP_PER_S)
        print(f"  {name}: equal to plain (max err {err}); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch._int_mm + "
              f"epilogue {library_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}, {nbytes} B, {ops} int8 op)")
        rec[tag] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=library_ms)
    # the record's numbers are the main path's (tiny) shape; the LM
    # shape's ride along under lm_*
    out = dict(rec["tiny"])
    out.update({f"lm_{key}": v for key, v in rec["lm"].items()
                if key != "max_abs_err"})
    return out


def phase_int8_builds(torch, dev):
    """Phase 3b, int8 GEMM: the reference test's shapes (256^3, 300 x
    500 x 260, 128 x 1,024 x 512) and ragged edges (every dimension off
    the 128 / 64 / 64 tiles, K off 16 and 4, N off 4), each with float32
    and bf16 output, equal to the plain version."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    shapes = ((256, 256, 256), (300, 500, 260), (128, 1024, 512),
              (1, 1, 1), (17, 500, 9), (130, 77, 65), (129, 64, 63))
    for (m, k, n) in shapes:
        xq, wq, sx, sw = int8_inputs(torch, gen, dev, m, k, n)
        for out_dtype in (torch.float32, torch.bfloat16):
            compare_int8(torch, f"int8_matmul M={m} K={k} N={n} "
                         f"{out_dtype}", xq, wq, sx, sw, out_dtype)
        print(f"  int8_matmul M={m} K={k} N={n}: float32 and bf16 equal "
              f"to plain")


def phase_tiny(torch, dev):
    """Phase 12: the tiny keyword spotter (4 layers, width 64, 12
    classes) on seeded float32 weights: its forward on the card against
    the same weights on the CPU, then the W8A8 accuracy measurement
    through the kernel (the main path: 4 launches) and through the plain
    version, which must agree exactly.  Returns the kernel's launch
    count."""
    from repro_torch.benchmarks.quantization_efficiency import (
        BATCH, tiny_accuracy_measurement)
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_map
    from repro_torch.models.tiny import IN_F, IN_T

    cfg = get_config("tiny-kws")
    model = build_model(cfg, dev)
    params = model.init(seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.randn((BATCH, IN_T, IN_F), generator=gen, device=dev)
    got = model(params, x)
    want = build_model(cfg, "cpu")(tree_map(lambda t: t.cpu(), params),
                                   x.cpu())
    rel = float((got.cpu() - want).norm() / want.norm())
    check(bool(torch.isfinite(got).all())
          and got.shape == (BATCH, cfg.vocab_size),
          f"tiny forward: {tuple(got.shape)}")
    check(rel <= TINY_REL_TOL,
          f"tiny forward: card vs CPU {rel} > {TINY_REL_TOL} by norm")
    print(f"  tiny forward B={BATCH}: card vs CPU ||d|| / ||cpu|| "
          f"{rel:.3e} (<= {TINY_REL_TOL})")

    kernels = launch_counters()
    for k in kernels.values():
        k.launches = 0
    q = tiny_accuracy_measurement(dev, params=params, x=x)
    counts = {name: k.launches for name, k in kernels.items()}
    launches = counts.pop("int8_matmul")
    plain = tiny_accuracy_measurement(dev, params=params, x=x,
                                      kernels=False)
    check(launches == cfg.n_layers,
          f"int8_matmul launched {launches} times, want {cfg.n_layers}")
    check(not any(counts.values()), f"tiny path launched {counts}")
    agree, err = q["int8_argmax_agreement"], q["int8_rel_err"]
    check(err < INT8_REL_ERR_MAX,
          f"int8 relative logit error {err} >= {INT8_REL_ERR_MAX}")
    check((agree, err) == (plain["int8_argmax_agreement"],
                           plain["int8_rel_err"]),
          f"kernel path {(agree, err)} != plain path "
          f"{(plain['int8_argmax_agreement'], plain['int8_rel_err'])}")
    print(f"  W8A8 vs float32 (M {BATCH * IN_T}, K = N = {cfg.d_model}, "
          f"{launches} launches): argmax agreement {agree:.4f} (reported, "
          f"not gated), relative logit error {err:.6f} (< "
          f"{INT8_REL_ERR_MAX}); plain path identical")
    return launches


def phase_tiny_power(torch, dev):
    """Phase 13: the tiny model through the port's ``PowerRun``:
    SingleStream behind ``TinySUT`` at 10 Hz frames (200 queries, 2 s)
    and MultiStream 8-sample bursts (64 queries, 0.5 s); both reviews
    must pass.  Latencies are the card's; energy is the modeled MCU's."""
    from repro_torch.launch import tiny_benchmark

    single = tiny_benchmark.single_stream(dev, min_duration_s=2.0,
                                          period_s=0.1, min_queries=200)
    check(single["review_passed"],
          "tiny SingleStream review rejected:\n"
          + single["result"].report.render())
    print(f"  SingleStream: {single['n_queries']} queries, forward on the "
          f"card p50 {single['p50_us']:.1f} us, p90 {single['p90_us']:.1f}"
          f" us (measured); {single['modeled_uj_per_inf']:.3f} "
          f"uJ/inference, {single['modeled_avg_uw']:.1f} uW average "
          f"(modeled MCU, pin channel; I/O manager "
          f"{single['pin_uj_per_inf']:.3f} uJ); review ACCEPTED")
    multi = tiny_benchmark.multi_stream(dev, min_duration_s=0.5)
    check(multi["review_passed"],
          "tiny MultiStream review rejected:\n"
          + multi["result"].report.render())
    print(f"  MultiStream: {multi['bursts']} bursts of "
          f"{tiny_benchmark.BURST}, burst on the card p50 "
          f"{multi['p50_us']:.1f} us, p90 {multi['p90_us']:.1f} us, p99 "
          f"{multi['p99_burst_ms'] * 1e3:.1f} us (measured); "
          f"{multi['samples_per_s']:.0f} samples/s; review ACCEPTED")


def launch_counters() -> dict:
    """The kernel wrappers, by name; each carries its ``launches``."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_decode_attention.ops import (
        paged_decode_attention)
    from repro_torch.kernels.paged_verify_attention.ops import (
        paged_verify_attention)
    from repro_torch.kernels.int8_matmul.ops import int8_matmul
    from repro_torch.kernels.linear_scan.ops import linear_scan
    from repro_torch.kernels.verify_attention.ops import verify_attention
    return {k.__name__: k for k in (decode_attention, flash_attention,
                                    paged_decode_attention,
                                    paged_verify_attention,
                                    verify_attention, linear_scan,
                                    int8_matmul)}


def print_served(m: dict, wall_s: float, engine) -> None:
    print(f"  served {m['requests']} requests, {m['tokens']} tokens in "
          f"{wall_s:.3f} s: {m['tokens_per_s']:.1f} tokens/s, TTFT "
          f"p50/p99 {m['ttft_p50_s'] * 1e3:.1f}/{m['ttft_p99_s'] * 1e3:.1f}"
          f" ms, TPOT mean {m['tpot_mean_s'] * 1e3:.2f} ms, host syncs "
          f"{engine.host_syncs}, decode steps {engine.decode_steps}")


def served_run(torch, engine, requests, honor_arrivals=True):
    """Serve a copy of ``requests`` after a warm-up request (cuBLAS
    handles, kernel libraries) outside the counted run, with every
    launch counter set to 0 just before; returns (done, wall seconds,
    launches)."""
    import copy

    import numpy as np
    from repro_torch.serving import Request

    engine.serve([Request(rid=-1, prompt=np.arange(64), max_new_tokens=9)],
                 honor_arrivals=False)
    torch.cuda.synchronize()
    kernels = launch_counters()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    done = engine.serve(copy.deepcopy(requests),
                        honor_arrivals=honor_arrivals)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    return done, wall_s, {name: k.launches for name, k in kernels.items()}


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
    done, wall_s, launches = served_run(torch, engine, requests)
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
          == launches["paged_verify_attention"]
          == launches["verify_attention"] == 0,
          "the plain contiguous engine launched a paged or verify kernel")
    return engine, requests, launches


def prefill_slots(torch, model, params, prompts, max_len):
    """A per-slot cache of ``max_len`` rows with slot b prefilled with
    prompts[b] (each (1, S_b)); returns it and each prefill's last-token
    logits."""
    cache = model.init_cache(len(prompts), max_len, per_slot_pos=True)
    logits = []
    with torch.no_grad():
        for b, prompt in enumerate(prompts):
            row = {"blocks": {k: t[:, b:b + 1] for k, t in
                              cache["layers"]["blocks"].items()}}
            lg, one = model.prefill(params, {"tokens": prompt},
                                    max_len=max_len, cache=row)
            cache["pos"][b] = one["pos"]
            logits.append(lg[0, -1])
    return cache, logits


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
        cache, logits = prefill_slots(torch, model, params, prompts, 1280)
        with torch.no_grad():
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
    check(launches["decode_attention"] == launches["verify_attention"] == 0,
          "the paged engine launched a contiguous decode or verify kernel")
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


def spec_engines(dev, model, params):
    """The speculative pair of ``benchmarks/speculative_efficiency.py``
    at full width: the target's layers past 2 damped to 0.001 of their
    residual output, and its first 2 layers as the draft.  Returns a
    factory of engines on the damped weights (``spec_k`` 4 with the
    draft, 0 without)."""
    from repro_torch.serving import (ContinuousBatchingEngine,
                                     damp_upper_layers, truncate_draft)

    damped = damp_upper_layers(params, n_keep=2, damp=0.001)
    dmodel, dparams = truncate_draft(model, damped, 2)

    def make(spec_k=4, **more):
        draft = (dict(draft_model=dmodel, draft_params=dparams,
                      spec_k=spec_k) if spec_k else {})
        return ContinuousBatchingEngine(
            model, damped, max_len=2048, n_slots=8, chunk_steps=8,
            device=dev, **draft, **more)
    return make


def phase_spec_engine(torch, dev, model, make, requests):
    """Phase 8: phase 4's 16 requests at 8 QPS through the speculative
    engine (k = 4, 2-layer truncated draft) on the damped weights, then
    through the plain engine on the same weights, in this one call."""
    from repro_torch.launch.serve import summarize

    cfg = model.cfg
    spec = make()
    done, wall_s, launches = served_run(torch, spec, requests)
    m = summarize(done, wall_s)
    st = spec.spec_stats
    rounds = spec.spec_rounds
    print_served(m, wall_s, spec)
    print(f"  speculative k={spec.spec_k}: acceptance "
          f"{spec.acceptance_rate():.4f} ({st['accepted']}/{st['proposed']}"
          f" drafts), {st['rounds']} slot-rounds, {rounds} rounds, "
          f"{spec.host_syncs} host copies")
    print("  launches: " + ", ".join(f"{k} {n}"
                                     for k, n in launches.items()))
    check(len(done) == len(requests),
          f"{len(done)} of {len(requests)} requests completed")
    for r in done:
        check(len(r.output) == r.max_new_tokens,
              f"request {r.rid}: {len(r.output)} of {r.max_new_tokens} "
              f"tokens")
        check(all(0 <= t < model.vp for t in r.output),
              f"request {r.rid}: token outside the padded vocabulary")
    dl = spec.draft_model.cfg.n_layers
    n = len(requests)
    check(launches["verify_attention"] == cfg.n_layers * rounds,
          f"verify launches {launches['verify_attention']} != "
          f"{cfg.n_layers} layers x {rounds} rounds")
    check(launches["decode_attention"]
          == dl * (spec.spec_k + 1) * rounds,
          f"decode launches {launches['decode_attention']} != {dl} draft "
          f"layers x {spec.spec_k + 1} steps x {rounds} rounds")
    check(launches["flash_attention"] == (cfg.n_layers + dl) * n,
          f"flash launches {launches['flash_attention']} != "
          f"({cfg.n_layers} + {dl}) layers x {n} admissions")
    check(launches["paged_decode_attention"]
          == launches["paged_verify_attention"] == 0,
          "the contiguous speculative engine launched a paged kernel")
    check(spec.host_syncs * spec.chunk_steps == rounds,
          "host copies != chunks: more than one copy per chunk")
    check(spec.decode_steps == 0, "the speculative engine ran plain "
          "decode steps")

    plain = make(spec_k=0)
    done, wall_s, _ = served_run(torch, plain, requests)
    mp = summarize(done, wall_s)
    print("  plain engine, same damped weights, same requests:")
    print_served(mp, wall_s, plain)
    print(f"  tokens/s speculative / plain: "
          f"{m['tokens_per_s'] / mp['tokens_per_s']:.3f}")
    return launches


def phase_spec_tokens(torch, dev, model, params, make, requests):
    """Phase 9: speculative token checks.  (1) Model level: a 5-token
    ``verify_step`` against 5 sequential ``decode_step``s.  (2) Phase
    4's requests offline through the plain and the speculative
    contiguous engines: every divergence must start at a near-tie.
    (3) The same requests through the speculative paged engine
    (shuffled 16-row pages) must give the speculative contiguous
    engine's tokens exactly."""
    import numpy as np
    from repro_torch.serving import PagePool

    cfg = model.cfg
    # (1) model level, on the undamped weights: all 28 layers count
    rng = np.random.default_rng(2)
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab_size, n),
                               device=dev)[None] for n in (300, 17, 1024, 129)]
    cache, _ = prefill_slots(torch, model, params, prompts, 1280)
    with torch.no_grad():
        window = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 5)),
                                 device=dev)
        seq = {"layers": {"blocks": {k: t.clone() for k, t in
                                     cache["layers"]["blocks"].items()}},
               "pos": cache["pos"].clone()}
        steps = []
        for j in range(window.shape[1]):
            lg, seq = model.decode_step(params, seq, window[:, j:j + 1])
            steps.append(lg[:, 0])
        want = torch.stack(steps, 1).float()
        got, vc = model.verify_step(params, cache, window)
        got = got.float()
    rel = float((got - want).abs().max() / want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"  verify_step (4 slots at depths 300/17/1024/129, 5-token "
          f"window) vs 5 decode_steps: max |verify - decode| / max "
          f"|decode| = {rel:.3e}, argmax agreement {agree:.2f}")
    check(bool(torch.isfinite(got).all()), "non-finite verify logits")
    check(rel <= LOGIT_REL_TOL, f"verify_step logits differ by {rel}")
    check(torch.equal(vc["pos"], cache["pos"]), "verify_step moved pos")

    # (2) plain vs speculative, offline, on the damped weights
    def serve(eng):
        done, _, launches = served_run(torch, eng, requests, False)
        return {r.rid: r.output for r in done}, launches

    plain, _ = serve(make(spec_k=0))
    spec_eng = make()
    spec, _ = serve(spec_eng)
    same = sum(spec[rid] == plain[rid] for rid in plain)
    print(f"  {same}/{len(plain)} requests token-identical (speculative vs "
          f"plain, offline), acceptance {spec_eng.acceptance_rate():.4f}")
    damped = spec_eng.params
    by_rid = {r.rid: r for r in requests}
    for rid in sorted(plain):
        a, b = plain[rid], spec[rid]
        if a == b:
            continue
        check(len(a) == len(b), f"request {rid}: {len(b)} speculative "
              f"tokens vs {len(a)} plain")
        j = next(i for i in range(len(a)) if a[i] != b[i])
        prompt = np.concatenate([np.asarray(by_rid[rid].prompt), a[:j]])
        with torch.no_grad():
            toks = torch.as_tensor(prompt, device=dev)[None]
            lg, c = model.prefill(damped, {"tokens": toks[:, :-1]},
                                  max_len=toks.shape[1])
            lg, _ = model.decode_step(damped, c, toks[:, -1:])
        row = lg[0, -1].float()
        gap = float(row[a[j]] - row[b[j]])
        tol = LOGIT_REL_TOL * float(row.abs().max())
        print(f"  request {rid} diverges at token {j}: logit(plain "
              f"{a[j]}) - logit(speculative {b[j]}) = {gap:.4f}, "
              f"near-tie limit {tol:.4f}")
        check(gap <= tol, f"request {rid}: divergence at token {j} is not "
              f"a near-tie ({gap} > {tol})")

    # (3) paged speculative vs contiguous speculative: the same bits
    paged = make(kv_page_size=16)
    order = np.random.default_rng(11).permutation(paged.n_pages - 1) + 1
    paged.page_pool = PagePool(paged.n_pages, paged.page_size,
                               order=order.tolist())
    got, launches = serve(paged)
    same = sum(got[rid] == spec[rid] for rid in spec)
    rounds = paged.spec_rounds
    print(f"  {same}/{len(spec)} requests token-identical (paged "
          f"speculative, shuffled pages, vs contiguous speculative); "
          f"paged_verify_attention {launches['paged_verify_attention']} "
          f"launches = {cfg.n_layers} x {rounds} rounds")
    check(same == len(spec), "paged speculative tokens differ from the "
          "contiguous speculative engine's")
    check(launches["paged_verify_attention"] == cfg.n_layers * rounds,
          f"paged verify launches {launches['paged_verify_attention']} != "
          f"{cfg.n_layers} layers x {rounds} rounds")
    check(launches["verify_attention"] == 0,
          "the paged speculative engine launched contiguous verify")


def phase_rwkv_engine(torch, dev, requests):
    """Phase 10: phase 4's requests (arrivals, prompt lengths, budgets),
    their tokens redrawn in rwkv6-3b's vocabulary, through the
    full-width rwkv6-3b engine.  Returns (model, params, launches)."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import summarize
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_leaves
    from repro_torch.models.rwkv6 import padded_heads
    from repro_torch.serving import ContinuousBatchingEngine

    cfg = get_config("rwkv6-3b")
    model = build_model(cfg, dev)
    params = model.init(seed=0)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"  {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads padded to {padded_heads(cfg)} of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {model.vp}, {n_params / 1e9:.3f} B params "
          f"({cfg.dtype})")
    rng = np.random.default_rng(0)
    requests = [dataclasses.replace(r, prompt=rng.integers(
        0, cfg.vocab_size, len(r.prompt))) for r in requests]
    engine = ContinuousBatchingEngine(model, params, max_len=2048,
                                      n_slots=8, chunk_steps=8, device=dev)
    done, wall_s, launches = served_run(torch, engine, requests)
    m = summarize(done, wall_s)
    print_served(m, wall_s, engine)
    print("  launches: " + ", ".join(f"{k} {n}"
                                     for k, n in launches.items()))
    n = len(requests)
    check(len(done) == n, f"{len(done)} of {n} requests completed")
    for r in done:
        check(len(r.output) == r.max_new_tokens,
              f"request {r.rid}: {len(r.output)} of {r.max_new_tokens} "
              f"tokens")
        check(all(0 <= t < model.vp for t in r.output),
              f"request {r.rid}: token outside the padded vocabulary")
    check(launches["linear_scan"] == cfg.n_layers * n,
          f"linear_scan launches {launches['linear_scan']} != "
          f"{cfg.n_layers} layers x {n} admissions")
    check(engine.host_syncs * engine.chunk_steps == engine.decode_steps,
          "more than one host copy per decode chunk")
    check(all(c == 0 for k, c in launches.items() if k != "linear_scan"),
          "the rwkv engine launched an attention kernel")
    return model, params, launches


def rwkv_paths(torch, dev, cfg, params) -> dict:
    """For 4 slots at prompt lengths 300/17/1,000/129: the last-token
    logits of prefill(prompt + 8 tokens) against those of
    prefill(prompt) followed by 8 ``decode_step``s on the same tokens,
    on the kernel path and on the plain path, and the two paths against
    each other.  Returns max |a - b| / max |b| of each comparison."""
    import numpy as np
    from repro_torch.models import build_model

    rng = np.random.default_rng(5)
    lens = (300, 17, 1000, 129)
    extra = 8
    toks = [torch.as_tensor(rng.integers(0, cfg.vocab_size, n + extra),
                            device=dev)[None] for n in lens]
    forced = torch.cat([t[:, n:] for t, n in zip(toks, lens)])   # (4, 8)
    runs, out = {}, {}
    for kernels in (True, False):
        model = build_model(cfg, dev, kernels=kernels)
        with torch.no_grad():
            whole = torch.stack([model.prefill(params, {"tokens": t})[0][0, -1]
                                 for t in toks]).float()
        cache, _ = prefill_slots(torch, model, params,
                                 [t[:, :n] for t, n in zip(toks, lens)],
                                 2048)
        with torch.no_grad():
            for j in range(extra):
                lg, cache = model.decode_step(params, cache,
                                              forced[:, j:j + 1])
        stepped = lg[:, -1].float()
        check(bool(torch.isfinite(stepped).all())
              and bool(torch.isfinite(whole).all()),
              f"{cfg.dtype}: non-finite logits")
        path = "kernel" if kernels else "plain"
        out[f"{path} path: prefill(prompt) + {extra} decode steps vs "
            f"prefill(prompt + {extra})"] = (stepped, whole)
        runs[kernels] = (whole, stepped)
    for i, what in enumerate(("prefill", "prefill + decode")):
        out[f"kernel vs plain path, {what}"] = (runs[True][i],
                                                runs[False][i])
    return {k: float((a - b).abs().max() / b.abs().max())
            for k, (a, b) in out.items()}


def phase_rwkv_consistency(torch, dev, cfg, params):
    """Phase 11: ``rwkv_paths`` on phase 10's seeded weights in float32,
    each comparison within ``F32_LOGIT_REL_TOL``; then in bf16 on phase
    10's own weights, reported (see ``F32_LOGIT_REL_TOL``)."""
    import dataclasses

    from repro_torch.models import build_model

    f32 = dataclasses.replace(cfg, dtype="float32")
    f32_params = build_model(f32, dev).init(seed=0)
    for what, rel in rwkv_paths(torch, dev, f32, f32_params).items():
        print(f"  float32, {what}: max |a - b| / max |b| = {rel:.3e}")
        check(rel <= F32_LOGIT_REL_TOL, f"float32 {what}: {rel} > "
              f"{F32_LOGIT_REL_TOL}")
    del f32_params
    gc.collect()
    torch.cuda.empty_cache()
    for what, rel in rwkv_paths(torch, dev, cfg, params).items():
        print(f"  bfloat16 (reported), {what}: max |a - b| / max |b| = "
              f"{rel:.3e}")


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
    kernels["int8_matmul"] = phase_int8(torch, dev)
    phase("phase 3b: every kernel build vs its plain version (small shapes)")
    phase_builds(torch, dev)
    phase_int8_builds(torch, dev)

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

    phase("phase 8: full-width speculative engine (k = 4) vs plain engine")
    make = spec_engines(dev, model, params)
    spec_launches = phase_spec_engine(torch, dev, model, make, requests)

    phase("phase 9: speculative tokens: verify_step, near-ties, paged")
    phase_spec_tokens(torch, dev, model, params, make, requests)

    # the qwen3 weights, engines and damped copy go before rwkv6-3b
    del engine, make, model, params
    gc.collect()
    torch.cuda.empty_cache()

    phase("phase 10: full-width rwkv6-3b engine")
    rwkv, rwkv_params, rwkv_launches = phase_rwkv_engine(torch, dev,
                                                         requests)

    phase("phase 11: rwkv6 state handoff; kernel path vs plain path")
    phase_rwkv_consistency(torch, dev, rwkv.cfg, rwkv_params)
    del rwkv, rwkv_params
    gc.collect()
    torch.cuda.empty_cache()

    phase("phase 12: tiny-kws forward and W8A8 measurement")
    int8_launches = phase_tiny(torch, dev)

    phase("phase 13: tiny-kws through PowerRun (SingleStream, MultiStream)")
    phase_tiny_power(torch, dev)

    # launches: each kernel's count on its own path's run (phase 4 for
    # the contiguous kernels, phase 6 for the paged ones, phase 8 for
    # the verify kernel, phase 10 for the scan, phase 12 for the int8
    # GEMM)
    dec = "src/repro/kernels/decode_attention/decode_attention.py"
    sources = {
        "decode_attention": (f"{dec}:351", launches),
        "flash_attention": (
            "src/repro/kernels/flash_attention/flash_attention.py:77",
            launches),
        "paged_decode_attention": (f"{dec}:266", paged_launches),
        "paged_verify_attention": (f"{dec}:308", paged_launches),
        "verify_attention": (f"{dec}:127", spec_launches),
        "linear_scan": ("src/repro/kernels/linear_scan/linear_scan.py:81",
                        rwkv_launches),
        "int8_matmul": ("src/repro/kernels/int8_matmul/int8_matmul.py:42",
                        {"int8_matmul": int8_launches})}
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
