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
   never calls; by events and kernel-only at every attention shape) and
   the least time the card could take (its bound).
   Decode and paged decode (bf16: the split-KV kernel + merge, split
   layout printed) are also held against the split algorithm's plain
   version and timed by events, kernel-only (``torch.profiler``, both
   grids; with the L2 warm from the last call, and cold: flushed before
   each call, as the engine's layers find it) and host work per call,
   beside SDPA by events and kernel-only, warm and cold;
   beside them the T = 1 yardstick (verify's split route at the same
   shape) and decode at whisper-small's decoder shape (B 8, KVH 12, G 1,
   D 64, 448 rows, depths up to 68).
   Paged decode must also equal contiguous decode bit for bit on the
   same values, through a shuffled page table, and likewise paged
   verify and contiguous verify, at T 5 (the speculative window), 8 and
   9 (both sides of the split route's 16-row line at G 2) and 200 (a
   prefix hit's suffix).  Each verify call prints its route (bf16: the
   split-KV kernel + merge for at most 16 rows T * G per KV head, else
   the tensor-core tile kernel) and, timed, its kernel-only time.
   The linear scan (rwkv6-3b's prefill: B 1, T 1,024 and a ragged
   1,000, H 48, dh 64) against its plain chunked version, y and state:
   bf16 takes the chunked tensor-core route (an intra-chunk grid, then
   a carry grid: chunk, state columns a carry CTA and both grids' CTAs
   printed), timed by events, kernel-only (each grid) with the L2 warm
   and flushed, and host work per call, beside the carry grid's other
   value split (equal bits) and the registers and spills ptxas reported.
   The W8A8 int8 GEMM at the tiny model's shape (M 12,544, K = N = 64,
   float32 out) and a qwen3-1.7b FFN up-projection (M 1,024, K 2,048,
   N 6,144, bf16 out): both take the wgmma route (route, tile, CTAs and
   waves printed), equal to the plain version bit for bit on it and on
   the mma.sync route (called through its own entry point); each route
   timed by events, kernel-only warm and L2-cold, and host work per
   call (the wgmma route's TMA descriptor encoding also alone), beside
   ``torch._int_mm`` alone (kernel-only) and with the same
   epilogue, and the bound at the int8 rate; the registers, spills and
   SASS opcodes of both routes' kernels (the wgmma kernel must hold
   warpgroup MMAs, TMA loads and mbarrier operations, the sync kernel
   IMMAs).
   Flash's bidirectional form at whisper-small's shapes (B 8, H = KVH
   12, D 64, 1,500 keys; Sq 1,500, 1 and 4) beside SDPA.  Each flash
   shape prints the route it took (bf16: the tensor-core tile kernel
   for more than 16 query rows per KV head, else split-KV + merge) and,
   beside the per-call event time, the kernel-only device time per
   call from ``torch.profiler`` (both grids of the split route).
   Then every build the wrappers can launch (float32 and bfloat16,
   D 64 and 128, G 1/2/4/8, flash in both forms and, in bf16, through
   both routes: causal Sq 3 over 3 and 300 keys (whole splits masked),
   a ragged last split, 77 x 300 tiles; decode and paged decode bit for
   bit, in bf16 also against the split plain version; both verify
   kernels at windows of 5, 8, 9 and 200, bit for bit; the paged kernels
   bit for bit between pools of 16-row and 8-row pages; the scan at dh
   32/64/128 on both routes (float32 loop, bf16 chunked) at T 1, 40, 77
   and 77 under strong decay (logw down to -30 a step); the int8 GEMM
   at the reference test's shapes and ragged edges on both routes,
   K 8,192 among them, both outputs, each shape's route printed) once
   at a small shape against its plain version.
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
14. Full-width whisper-small (12 encoder layers over 1,500 frames, 12
   decoder layers, d_model 768, 12 heads of 64, padded vocab 53,248,
   bf16, seeded weights) behind ``ServeEngine(batch_size=8,
   max_len=448)``: 8 requests with 4-token prompts and 64 new tokens,
   frames from numpy seed 0 passed as ``extra_inputs``.  Flash runs
   bidirectional in the encoder and the cross-attention, causal in the
   decoder's prefill; decode runs each step's self-attention.  Launch
   counts exact (flash 36 + 12 x 63, decode 12 x 63); the kernel path
   against the plain path on the same weights (first-token logits
   within phase 5's limit, tokens equal except from a near-tie on).
15. The main path under ``PowerRun`` with the card's own energy (run
   after phase 9, while phase 4's qwen3-1.7b weights and engine are
   loaded): the NVML energy counter's update period, 2 s of idle draw
   beside the H100 spec's estimate; ``ContinuousBatchingSUT(phase 4's
   engine, energy_meter=NVML)`` under ``Server(mode="queue",
   target_qps=8, min_queries=16, latency_slo_s=10)`` over phase 4's
   prompts and budgets: the review must ACCEPT, the stack's measured
   accelerator energy must lie within 3 % of the counter's delta over
   the serve, its average watts between half the idle draw and 1.05 x
   the enforced limit, launches exact (flash 28 per admission, decode
   28 per decode step); tok/s, TTFT, TPOT, Joules by channel (measured
   or modeled), tok/J at the accelerator and at the wall.  Then
   ``serving_throughput.metrics(smoke=True)`` on the card (both SUTs
   ACCEPT) and the launcher's fixed engine under Offline through
   ``ServeEngineSUT`` (ACCEPT).
16. SLO-aware serving (run after phase 15, on phase 4's weights), in
   ``repro_torch.benchmarks.slo_sweep``'s geometry (64-row pages, 832
   rows a slot, 27 pages, chunks of 64): (a) paged verify at the chunk
   shapes (T 64 at window starts 0, 64 and 704: the tile route; T 8 at
   64, a 72-token prompt's tail, and T 5 at 768, a parked long's resume
   suffix: the split route) against its plain version under phase 3b's
   tolerances, each with its route, kernel time by events and
   kernel-only, the plain version's, SDPA's and the bound; (b) the
   sweep's bimodal mix (longs of 768, shorts of 16, mids of 72, 8 new
   tokens) offline through its monolithic and chunked engines: tokens
   equal except from a near-tie on, launches exact (chunked: paged
   verify 28 per chunk, no flash; monolithic: flash 28 per admission;
   paged decode 28 per step), and every non-final chunk runs with each
   tensor-to-host conversion raising; (c) the reference's preemption
   test at 64-row pages under its virtual clock: at least one
   preemption and one resume, only priority 0 parked, tokens as an
   uncontended run's except from a near-tie on; (d)
   ``slo_sweep.metrics(smoke=True)`` with the NVML meter on the three
   colocated configurations and modeled rails (the H100 system) on the
   disaggregated one: every review ACCEPTs; ``t_long``, the SLO, each
   point's short-class attainment, ``qps_at_slo``, tok/s, tok/J at the
   accelerator and the wall, preemptions, resumes, the interleave
   ratio, ``speedup``, the disaggregated row's modeled ``prefill_j``,
   ``decode_j`` and ``prefill_energy_frac`` and beside them the NVML
   counter's delta over the same serve (reported, not gated) are
   printed.
17. Faults on the main path (after phase 16, phase 4's weights and
   engine): (a) ``PowerRun(ContinuousBatchingSUT(engine, energy_meter=
   NVML), Server(mode="queue"), fault_plan=FaultPlan([MeterDropout(
   "wall", 0.5, 1.0)]))``: hardened (``meter_retry=RetryPolicy()``) the
   review ACCEPTs with the wall's coverage 1.0 after re-measurement and
   the stack within 3 % of the counter's delta; naive, R12 (coverage)
   refuses it.  (b) A ``QueueOverload`` burst of 120 QPS for 0.5 s over
   an 8-QPS Server with ``ShedPolicy(max_queue=8)`` and 5 s deadlines:
   every offered qid completed, shed or timed out exactly once, some
   shed, launches exact for what was served.  (c) ``ReplicatedSUT`` of
   two ``ContinuousBatchingSUT``s (one set of weights, two engines,
   modeled rails, each serve on a virtual clock of 0.1 s a read, so
   that every run splits the same way) with replica 1 crashing halfway
   through its share:
   with ``retry`` no qid lost or duplicated, launches exact for every
   serve of both replicas (each from its own thread), and every
   request's tokens those of phase 4's engine serving them offline,
   except from a near-tie on; without ``retry`` the run raises;
   replicas with the NVML meter are refused (one card's counter billed
   per replica).  In every part each serve's counts are first held to
   what its request stream fixes (prefix hits exactly, decode steps
   and speculative rounds between bounds from the budgets).
18. The two benchmarks on the card at full width with the NVML meter:
   (a) every kernel they launch at their own shapes against its plain
   and split plain versions under phase 3b's tolerances, with route and
   split layout: in prefix_cache's pool (4 slots of 16 8-row pages, a
   shared 14-page prefix) paged decode at positions 120-127 and paged
   verify of a hit's suffix (T 8 and T 5 at 112), both bit for bit
   against the contiguous kernels on the gathered rows; verify at T 3,
   5 and 9 and decode in speculative_efficiency's 4 x 128-row cache;
   flash over both benchmarks' prompts (120 and 8 tokens).  (b) Each
   benchmark on its own engines and seed-0 weights (phase 4's seed):
   ``prefix_cache.metrics(smoke=True)`` (flash 28 per miss, paged
   verify 28 per hit, paged decode 28 per step; hits, lookups and
   cached tokens those of the CPU run) and
   ``speculative_efficiency.metrics(smoke=True, n_reps=2)`` (k 0/2/4/8
   and the random draft over the full 28-layer target; verify 28 a
   round, the draft's decode k + 1 per round, flash 29 per admission):
   launches exact, every review ACCEPTs; acceptance, speedup, draft
   energy share, tok/s and tok/J at the accelerator and the wall, and
   every repetition's tok/J beside its window in counter periods, are
   printed (not gated).
19. Prefill/decode disaggregation (after phase 18, phase 4's weights):
   (a) ``DisaggregatedEngine`` with two ``PrefillWorker``s, each
   prefilling in a thread of its own, and a paged decode engine in
   slo_sweep's geometry (64-row pages, 8 slots, chunks of 2; 1,088 rows
   a slot for phase 4's longest request) serves phase 4's 16 requests
   offline and with their arrivals: every budget completed, tokens
   those of the colocated paged engine except from a near-tie on,
   launches exact (flash 28 per request from the worker threads, paged
   decode 28 per decode step, nothing else), one host read per decode
   chunk; (b) a worker whose third prefill raises ends ``serve`` with
   that error within 30 s; (c) ``DisaggregatedSUT`` with the NVML meter
   is refused.
20. The modeled fleet calibrated on the card:
   ``fleet_sweep.metrics(smoke=True)`` measures the warm decode token
   time on the full-width qwen3-1.7b (seeded bf16 weights; launches
   exact: flash 28 per admission, decode 28 per step) and runs its six
   configurations in simulated time (no sleep): every acceptance check
   passes and every review ACCEPTs; ``t_tok``, tokens/s and each
   configuration's tail attainment, tok/J, provisioned W, cold starts,
   scale events and hetero_carbon's grams are printed.  Then
   ``repro_torch.launch.fleet`` with a 60 s horizon: ACCEPTED.

The line before the last holds the kernels' JSON record; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside
a checkout of the repository, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import contextlib
import dataclasses
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

# Phase 3b's extra flash shapes (causal, Sq, Skv), each at D 64/128 and
# G 1/2/4/8, so that bf16 reaches both routes: a causal 3-row case over
# 3 keys and over 300 (whose splits past the first are wholly masked),
# 4 rows over 777 keys (a ragged last split: 12 x 64 + 9), and 77 x 300
# tiles in the causal form.
FLASH_ROUTE_CASES = ((True, 3, 3), (True, 3, 300), (False, 4, 777),
                     (True, 77, 300))

# Phase 3b's verify windows (T, starts of 3 slots) over phase 3b's 304
# cache positions (19 pages of 16), each at D 64/128 and G 1/2/4/8, so
# that bf16 reaches both routes: T 5 (split up to G 2, tiles from G 4),
# T 8 and 9 (16 and 18 rows at G 2: both sides of the split route's
# line), T 200 (tiles).  Each set has a slot at 0 and one whose window
# ends on the last position (pos + T = 304); windows at 14 cross a page
# boundary.
VERIFY_WINDOWS = ((5, (0, 290, 133)), (5, (14, 299, 0)), (8, (14, 296, 0)),
                  (9, (14, 295, 0)), (200, (14, 104, 0)))

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

# Phase 15: the stack's accelerator channel samples the counter-derived
# trace at 100 Hz with the telemetry channel's noise (2.5 % a sample,
# independent) and integrates it over the run's window; the counter's
# own delta spans the serve.  The two must agree within 3 %.  That gate
# sees a trace read off the engine's t = 0 only where the draw changes
# across the shift, so time alignment is gated directly as well: the
# serve's window (the engine's t = 0 to the loadgen's duration) must lie
# inside the sampler's readings, within one sampling period of each end
# (MeasuredTrace.gaps_s; tests/test_torch_serving_sut.py plants a late
# t = 0 and a shifted trace and sees these gates fail).
ENERGY_ALIGN_TOL = 0.03


def ptxas_report(log: str) -> list[str]:
    """One entry per kernel of ``nvcc -Xptxas -v`` output: its name
    (demangled by ``c++filt`` where the machine has it), registers and
    spill bytes."""
    rows, name, spill = [], "?", ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "spill stores" in ln:
            spill = ln.strip().split(",", 1)[1].strip()
        elif "Used" in ln and "registers" in ln:
            regs = ln.split("Used", 1)[1].split("registers")[0].strip()
            rows.append((name, regs, spill))
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(n for n, _, _ in rows),
            capture_output=True, text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        names = []
    if len(names) != len(rows):
        names = [n for n, _, _ in rows]
    names = [n.replace("(anonymous namespace)::", "").split("(")[0]
             .removeprefix("void ") for n in names]
    return [f"{n}: {regs} registers, {spill}"
            for n, (_, regs, spill) in zip(names, rows)]


def sass_ops(lib: str) -> dict:
    """Opcode counts per kernel in the SASS of the shared library
    ``lib`` (``cuobjdump -sass`` beside ``nvcc``), by mangled kernel
    name: {name: {opcode: n}}, the opcode without its modifiers (HMMA,
    IMMA, HGMMA, IGMMA, UTMALDG, SYNCS, ...)."""
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :", 1)[1].strip()
            counts[name] = {}
        elif name and "*/" in ln:
            words = ln.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words and words[0][:1].isalpha():
                op = words[0].split(".")[0]
                counts[name][op] = counts[name].get(op, 0) + 1
    return counts


def sass_mma_counts(lib: str) -> dict:
    """HMMA (tensor-core mma) instructions per kernel in the SASS of the
    shared library ``lib``, by mangled kernel name."""
    return {name: ops.get("HMMA", 0) for name, ops in sass_ops(lib).items()}


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


# Bytes written before each call of a cold timing: five times the H100's
# 50 MB L2, so that a kernel finds its inputs in device memory, as the
# engine's decode step does (each layer reads another layer's cache).
L2_FLUSH_BYTES = 256 << 20


# Profiler windows a kernel-only time may take: a window that lacks a
# kernel record of some call (every kernel's count must be a whole
# multiple of the calls) is profiled again, and each such window is
# printed with what it recorded.
PROFILE_WINDOWS = 3
# Untimed one-byte fills launched at the head of every profiler window:
# on the H100, torch.profiler drops the first records of a window, more
# of them the longer since the process's first window (none at first,
# about 10 three minutes on; launch/profiler_check.py), so these take
# the loss in place of the timed calls' kernels.
PROFILE_LEAD_IN = 128


def device_ms(torch, fn, reps: int = 10, cold: bool = False):
    """Kernel-only device time per call of ``fn()`` in ms: the durations
    of the CUDA kernels ``torch.profiler`` records over ``reps`` calls
    (both grids of a split route), summed, over ``reps``; and a text of
    each kernel's name with its own ms per call.  ``PROFILE_LEAD_IN``
    one-byte fills open every window; with ``cold`` a fill of
    ``L2_FLUSH_BYTES`` runs before every call; the fills' kernels are
    left out of the sums.  Only a complete window counts: one where each
    kernel's record count is a positive multiple of ``reps``.  Up to
    ``PROFILE_WINDOWS`` windows are profiled; each incomplete one is
    printed (its records per kernel, the launch calls the profiler saw
    on the host and the fills' records), and so is a later window the
    time comes from.
    (None, "") where no window is complete."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = (torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
             if cold else None)
    lead = torch.empty(1, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    for window in range(1, PROFILE_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_LEAD_IN):
                lead.fill_(0)
            for _ in range(reps):
                if cold:
                    flush.fill_(1)
                fn()
            torch.cuda.synchronize()
        per, count, launches, fills = {}, {}, 0, 0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                launches += e.name.startswith(("cudaLaunch", "cuLaunch"))
            elif "FillFunctor<unsigned char>" in e.name:
                fills += 1
            else:
                name = (e.name.replace("(anonymous namespace)::", "")
                         .split("(")[0].removeprefix("void "))
                per[name] = per.get(name, 0.0) + e.time_range.elapsed_us()
                count[name] = count.get(name, 0) + 1
        if per and all(n % reps == 0 for n in count.values()):
            if window > 1:
                print(f"  torch.profiler window {window} of "
                      f"{PROFILE_WINDOWS} complete: the kernel-only time "
                      f"below comes from it")
            return (sum(per.values()) / 1e3 / reps,
                    ", ".join(f"{n} {us / 1e3 / reps:.4f} ms"
                              for n, us in sorted(per.items())))
        n_fills = PROFILE_LEAD_IN + (reps if cold else 0)
        print(f"  torch.profiler window {window} of {PROFILE_WINDOWS} "
              f"incomplete over {reps} calls: kernel records "
              f"{dict(sorted(count.items())) or 'none'} ({launches - n_fills}"
              f" launch calls on the host), {fills} of its {n_fills} fills' "
              f"records")
    return None, ""


def host_us(torch, fn, reps: int = 200) -> float:
    """Host time per call of ``fn()`` in us: the wrapper's Python,
    allocations and launches, timed while the device keeps up (the
    launch queue never fills at these counts)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


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


def scan_inputs(torch, gen, dev, b, t, h, dh, dtype, strong=False):
    """The reference's scan test inputs (tests/test_kernels.py:151-156)
    from ``gen``: r, k, v ~ N(0, 0.25) in ``dtype``, logw = -exp(N(0,
    0.25)) and u ~ N(0, 0.09) in float32.  ``strong``: logw uniform in
    (-30, 0) instead, a decay that sums to hundreds within a chunk."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    r, k, v = ((randn(b, t, h, dh) * 0.5).to(dtype) for _ in range(3))
    if strong:
        logw = -30 * torch.rand((b, t, h, dh), generator=gen, device=dev)
    else:
        logw = -torch.exp(randn(b, t, h, dh) * 0.5)
    return r, k, v, logw, randn(h, dh) * 0.3


def decode_times(torch, label, F, kernel, plain, q, kc, vc, mask, pos,
                 extra_bytes: int = 0) -> dict:
    """Time a decode call at a phase-3 shape: the kernel by events, its
    kernel-only device time (both grids of the split route) with the L2
    warm from the last call and cold, and its host work per call; the
    plain version by events; SDPA on the contiguous cache with the
    boolean (B, 1, 1, S) mask of ``pos`` (a yardstick the port never
    calls) by events and kernel-only, warm and cold; and the bound: the K/V
    rows up to each slot's ``pos`` read once, q read and o written once,
    plus ``extra_bytes`` (a page table's entries)."""
    b, _, h, d = q.shape
    kvh = kc.shape[2]
    ms = time_ms(kernel)
    dev_ms, kerns = device_ms(torch, kernel)
    cold_ms, cold_kerns = device_ms(torch, kernel, cold=True)
    h_us = host_us(torch, kernel)
    plain_ms = time_ms(plain)

    def sdpa():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    library_ms = time_ms(sdpa)
    lib_dev_ms, lib_kerns = device_ms(torch, sdpa)
    lib_cold_ms, _ = device_ms(torch, sdpa, cold=True)
    rows = int((pos.long() + 1).sum())              # positions read
    nbytes = rows * kvh * d * 2 * 2 + 2 * q.numel() * 2 + extra_bytes
    bound_ms, bound_by = bound(nbytes, rows * h * d * 4)
    print(f"  {label} B={b} KVH={kvh} G={h // kvh} D={d} S={kc.shape[1]}: "
          f"kernel {ms:.4f} ms (kernel-only {fmt_ms(dev_ms)}: {kerns}; "
          f"L2 cold {fmt_ms(cold_ms)}: {cold_kerns}; host {h_us:.1f} us a "
          f"call), plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms "
          f"(kernel-only {fmt_ms(lib_dev_ms)}, L2 cold {fmt_ms(lib_cold_ms)}"
          f": {lib_kerns}), bound {bound_ms * 1e3:.2f} us ({bound_by}, "
          f"{nbytes} B)")
    return dict(ms=ms, device_ms=dev_ms, device_cold_ms=cold_ms,
                host_us=h_us, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
                library_device_ms=lib_dev_ms,
                library_device_cold_ms=lib_cold_ms)


def phase_kernels(torch, dev):
    """Phase 3: each kernel against its plain version, then timed."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.decode_attention.ops import plan as decode_plan
    from repro_torch.kernels.flash_attention.ops import (
        _route, _sm_count, flash_attention, flash_attention_plain,
        flash_attention_split_plain, plan)
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
    n_sm = _sm_count(dev.index)
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(bf16)
    kc = torch.randn((b, s, kvh, d), generator=gen, device=dev).to(bf16)
    vc = torch.randn((b, s, kvh, d), generator=gen, device=dev).to(bf16)
    ragged = torch.tensor([0, 2047, 1024, 17, 511, 1500, 300, 2000],
                          dtype=torch.int32, device=dev)
    dplan = decode_plan("decode_attention", h, kvh, d, bf16, s, b * kvh,
                        n_sm)
    route, n_split, per = dplan
    errs, rels = [], []
    for name, pos in (("ragged", ragged),
                      ("scalar", torch.tensor(1023, dtype=torch.int32,
                                              device=dev))):
        got = decode_attention(q, kc, vc, pos)
        want = decode_attention_plain(q, kc, vc, pos)
        err, rel = compare(f"decode_attention ({name} pos)", got, want)
        serr, srel = compare(
            f"decode_attention ({name} pos) vs the split plain version", got,
            flash_attention_split_plain(q, kc, vc, causal=True,
                                        keys_per_split=per,
                                        offsets=pos.expand(b)))
        errs.append(err)
        rels.append(rel)
        print(f"  decode_attention pos={name} route {route} ({n_split} "
              f"splits of {per}): max |kernel - plain| {err:.3e}, "
              f"||kernel - plain|| / ||plain|| {rel:.3e}; vs the split "
              f"plain version {serr:.3e} / {srel:.3e}")
    mask = (torch.arange(s, device=dev)[None, :]
            <= ragged[:, None])[:, None, None, :]       # (B, 1, 1, S)
    dec = out["decode_attention"] = dict(
        max_abs_err=max(errs), rel_norm_err=max(rels), kernel_route=route,
        n_split=n_split, keys_per_split=per,
        **decode_times(torch, "decode_attention", F,
                       lambda: decode_attention(q, kc, vc, ragged),
                       lambda: decode_attention_plain(q, kc, vc, ragged),
                       q, kc, vc, mask, ragged))
    # the same call through the float32 loop (one grid, no scratch): what
    # the split route's merge launch and scratch add to the host's work
    qf, kf, vf = q.float(), kc.float(), vc.float()
    dec["loop_f32_host_us"] = host_us(
        torch, lambda: decode_attention(qf, kf, vf, ragged))
    del qf, kf, vf
    print(f"  decode_attention host work per call: split (bf16) "
          f"{dec['host_us']:.1f} us, loop (f32: one grid, no scratch) "
          f"{dec['loop_f32_host_us']:.1f} us")
    # the yardstick: verify's split route (flash_split.cuh) at T = 1 with
    # pos as the window start computes the same function
    vroute, vn, vper = plan("verify_attention", 1, h, kvh, d, bf16, s,
                            b * kvh, n_sm)
    verr, vrel = compare(f"verify_attention (T=1, {vroute})",
                         verify_attention(q, kc, vc, ragged),
                         decode_attention_plain(q, kc, vc, ragged))
    v_ms = time_ms(lambda: verify_attention(q, kc, vc, ragged))
    v_dev, v_kerns = device_ms(torch,
                               lambda: verify_attention(q, kc, vc, ragged))
    v_cold, _ = device_ms(torch, lambda: verify_attention(q, kc, vc, ragged),
                          cold=True)
    dec["t1_verify"] = dict(kernel_route=vroute, n_split=vn,
                            keys_per_split=vper, ms=v_ms, device_ms=v_dev,
                            device_cold_ms=v_cold, max_abs_err=verr,
                            rel_norm_err=vrel)
    faster = (v_dev is not None and dec["device_ms"] is not None
              and dec["device_ms"] < v_dev)
    print(f"  yardstick verify_attention T=1 route {vroute} ({vn} splits of "
          f"{vper}): max |kernel - plain| {verr:.3e}; kernel {v_ms:.4f} ms "
          f"(kernel-only {fmt_ms(v_dev)}, L2 cold {fmt_ms(v_cold)}: "
          f"{v_kerns}); decode's kernel-only {fmt_ms(dec['device_ms'])}, "
          f"L2 cold {fmt_ms(dec['device_cold_ms'])}: "
          + ("the split-KV decode body is faster" if faster else
             "the T = 1 route is at least as fast"))

    # --- decode at whisper-small's decoder shape: 8 windows, KVH 12, G 1,
    # D 64, a 448-row cache at ragged depths up to 68
    wb, wkvh, wd, ws = 8, 12, 64, 448
    wq = torch.randn((wb, 1, wkvh, wd), generator=gen, device=dev).to(bf16)
    wk = torch.randn((wb, ws, wkvh, wd), generator=gen, device=dev).to(bf16)
    wv = torch.randn((wb, ws, wkvh, wd), generator=gen, device=dev).to(bf16)
    wpos = torch.tensor([68, 3, 40, 0, 67, 17, 55, 30], dtype=torch.int32,
                        device=dev)
    wroute, wn, wper = decode_plan("decode_attention", wkvh, wkvh, wd, bf16,
                                   ws, wb * wkvh, n_sm)
    got = decode_attention(wq, wk, wv, wpos)
    werr, wrel = compare("decode_attention (whisper shape)", got,
                         decode_attention_plain(wq, wk, wv, wpos))
    compare("decode_attention (whisper shape) vs the split plain version",
            got, flash_attention_split_plain(wq, wk, wv, causal=True,
                                             keys_per_split=wper,
                                             offsets=wpos))
    print(f"  decode_attention whisper shape route {wroute} ({wn} splits of "
          f"{wper}): max |kernel - plain| {werr:.3e}, ||kernel - plain|| / "
          f"||plain|| {wrel:.3e}")
    wmask = (torch.arange(ws, device=dev)[None, :]
             <= wpos[:, None])[:, None, None, :]
    dec["whisper"] = dict(
        max_abs_err=werr, rel_norm_err=wrel, kernel_route=wroute,
        n_split=wn, keys_per_split=wper,
        **decode_times(torch, "decode_attention (whisper shape)", F,
                       lambda: decode_attention(wq, wk, wv, wpos),
                       lambda: decode_attention_plain(wq, wk, wv, wpos),
                       wq, wk, wv, wmask, wpos))

    # --- flash: Sq = Skv in {17, 511, 1024}, H 16, KVH 8, D 128 ----------
    h, kvh = 16, 8
    errs, rels = [], []
    for sq in (17, 511, 1024):
        q = torch.randn((1, sq, h, d), generator=gen, device=dev).to(bf16)
        k = torch.randn((1, sq, kvh, d), generator=gen, device=dev).to(bf16)
        v = torch.randn((1, sq, kvh, d), generator=gen, device=dev).to(bf16)
        route = _route(sq, sq, h, kvh, d, bf16)
        got = flash_attention(q, k, v, causal=True)
        want = flash_attention_plain(q, k, v, causal=True)
        err, rel = compare(f"flash_attention (S={sq}, {route})", got, want)
        errs.append(err)
        rels.append(rel)
        print(f"  flash_attention S={sq} route {route}: max |kernel - "
              f"plain| {err:.3e}, ||kernel - plain|| / ||plain|| {rel:.3e}")
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True))
    dev_ms, kerns = device_ms(torch,
                              lambda: flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, causal=True))

    def sdpa():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    library_ms = time_ms(sdpa)
    lib_dev_ms, lib_kerns = device_ms(torch, sdpa)
    sq = q.shape[1]
    flops = 4 * h * d * sq * (sq + 1) // 2          # causal pairs only
    nbytes = (2 * sq * h * d + 2 * sq * kvh * d) * 2
    bound_ms, bound_by = bound(nbytes, flops)
    out["flash_attention"] = dict(
        max_abs_err=max(errs), rel_norm_err=max(rels), ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        library_device_ms=lib_dev_ms,
        kernel_route=_route(sq, sq, h, kvh, d, bf16), device_ms=dev_ms)
    print(f"  flash_attention S={sq} H={h} KVH={kvh} D={d} route "
          f"{out['flash_attention']['kernel_route']}: kernel {ms:.4f} ms "
          f"(kernel-only {fmt_ms(dev_ms)}: {kerns}), plain "
          f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms (kernel-only "
          f"{fmt_ms(lib_dev_ms)}: {lib_kerns}), bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}, {flops} flop)")

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
    pplan = decode_plan("paged_decode_attention", h, kvh, d, bf16, nb * ps,
                        b * kvh, n_sm)
    check(pplan == dplan,
          "decode and paged decode take different routes or split layouts")
    got = paged_decode_attention(q, kp, vp, pages, ragged)
    err, rel = compare("paged_decode_attention", got,
                       paged_decode_attention_plain(q, kp, vp, pages,
                                                    ragged))
    compare("paged_decode_attention vs the split plain version", got,
            flash_attention_split_plain(q, kc, vc, causal=True,
                                        keys_per_split=pplan[2],
                                        offsets=ragged))
    check(torch.equal(got, decode_attention(q, kc, vc, ragged)),
          "paged_decode_attention is not bit-identical to decode_attention "
          "on the same values through a shuffled page table")
    print(f"  paged_decode_attention route {pplan[0]}: max |kernel - plain| "
          f"{err:.3e}, ||kernel - plain|| / ||plain|| {rel:.3e}, "
          f"torch.equal to decode_attention: True")
    blocks = int(((ragged.long() + ps) // ps).sum())   # table entries read
    out["paged_decode_attention"] = dict(
        max_abs_err=err, rel_norm_err=rel, kernel_route=pplan[0],
        **decode_times(torch, "paged_decode_attention (SDPA: contiguous, "
                       "no gather)", F,
                       lambda: paged_decode_attention(q, kp, vp, pages,
                                                      ragged),
                       lambda: paged_decode_attention_plain(q, kp, vp, pages,
                                                            ragged),
                       q, kc, vc, mask, ragged,
                       extra_bytes=blocks * 4 + b * 4))

    # --- paged verify: windows at ragged starts, across page boundaries
    errs, rels = [], []
    for t, starts in ((1, [15, 1031, 1030, 0, 511, 1500, 300, 2047]),
                      (4, [14, 1023, 1030, 0, 509, 1500, 300, 2044]),
                      (200, [15, 1031, 1030, 0, 511, 1500, 300, 1848])):
        pos = torch.tensor(starts, dtype=torch.int32, device=dev)
        q = torch.randn((b, t, h, d), generator=gen, device=dev).to(bf16)
        route = _route(t, nb * ps, h, kvh, d, bf16)
        err, rel = compare(f"paged_verify_attention (T={t}, {route})",
                           paged_verify_attention(q, kp, vp, pages, pos),
                           paged_verify_attention_plain(q, kp, vp, pages,
                                                        pos))
        errs.append(err)
        rels.append(rel)
        print(f"  paged_verify_attention T={t} route {route}: max |kernel - "
              f"plain| {err:.3e}, ||kernel - plain|| / ||plain|| {rel:.3e}")
    # verify and paged verify on the same values (the decode cache and its
    # shuffled pages), bit for bit, on both sides of the 16-row line (T 8
    # and 9 at G 2) and at a prefix hit's T 200
    for t, starts in ((8, [15, 1031, 1030, 0, 511, 1500, 300, 2040]),
                      (9, [15, 1031, 1030, 0, 511, 1500, 300, 2039]),
                      (200, [15, 1031, 1030, 0, 511, 1500, 300, 1848])):
        pos = torch.tensor(starts, dtype=torch.int32, device=dev)
        q = torch.randn((b, t, h, d), generator=gen, device=dev).to(bf16)
        vplan = plan("verify_attention", t, h, kvh, d, bf16, s, b * kvh,
                     n_sm)
        check(vplan == plan("paged_verify_attention", t, h, kvh, d, bf16,
                            nb * ps, b * kvh, n_sm),
              f"verify and paged verify take different routes or split "
              f"layouts at T={t}")
        route = vplan[0]
        got = verify_attention(q, kc, vc, pos)
        err, rel = compare(f"verify_attention (T={t}, {route})", got,
                           verify_attention_plain(q, kc, vc, pos))
        check(torch.equal(got, paged_verify_attention(q, kp, vp, pages,
                                                      pos)),
              f"verify_attention T={t} ({route}) is not bit-identical to "
              f"paged_verify_attention on the same values through a "
              f"shuffled page table")
        print(f"  verify_attention T={t} route {route}: max |kernel - plain|"
              f" {err:.3e}, ||kernel - plain|| / ||plain|| {rel:.3e}, "
              f"torch.equal to paged_verify_attention: True")
    # timed at a prefix hit's shape: one slot, a 200-token suffix behind
    # 1,024 cached tokens
    t, start = 200, 1024
    q = torch.randn((1, t, h, d), generator=gen, device=dev).to(bf16)
    pos = torch.tensor([start], dtype=torch.int32, device=dev)
    pg1 = pages[:1]
    route = _route(t, nb * ps, h, kvh, d, bf16)
    ms = time_ms(lambda: paged_verify_attention(q, kp, vp, pg1, pos))
    dev_ms, kerns = device_ms(
        torch, lambda: paged_verify_attention(q, kp, vp, pg1, pos))
    plain_ms = time_ms(lambda: paged_verify_attention_plain(
        q, kp, vp, pg1, pos))
    skv = start + t
    kc1 = kp[pg1.long()].reshape(1, nb * ps, kvh, d)[:, :skv]
    vc1 = vp[pg1.long()].reshape(1, nb * ps, kvh, d)[:, :skv]
    vmask = (torch.arange(skv, device=dev)[None, :]
             <= start + torch.arange(t, device=dev)[:, None])[None, None]

    def sdpa():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kc1.transpose(1, 2), vc1.transpose(1, 2),
            attn_mask=vmask, enable_gqa=True)

    library_ms = time_ms(sdpa)
    lib_dev_ms, lib_kerns = device_ms(torch, sdpa)
    pairs = t * start + t * (t + 1) // 2            # visible (query, key)
    flops = 4 * h * d * pairs
    nbytes = (skv * kvh * d * 2 * 2 + 2 * q.numel() * 2
              + -(-skv // ps) * 4 + 4)
    bound_ms, bound_by = bound(nbytes, flops)
    out["paged_verify_attention"] = dict(
        max_abs_err=max(errs), rel_norm_err=max(rels), ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=library_ms, library_device_ms=lib_dev_ms,
        kernel_route=route, device_ms=dev_ms)
    print(f"  paged_verify_attention B=1 T={t} at pos {start} H={h} "
          f"KVH={kvh} D={d} route {route}: kernel {ms:.4f} ms (kernel-only "
          f"{fmt_ms(dev_ms)}: {kerns}), plain {plain_ms:.4f} ms, "
          f"SDPA (contiguous, no gather) {library_ms:.4f} ms (kernel-only "
          f"{fmt_ms(lib_dev_ms)}: {lib_kerns}), bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}, {flops} flop, {nbytes} B)")

    # --- verify: the speculative window (T = k + 1 = 5) on the decode
    # cache, at the decode shape's ragged depths clipped to S - T
    t = 5
    pos = ragged.clamp(max=s - t)
    q = torch.randn((b, t, h, d), generator=gen, device=dev).to(bf16)
    route = _route(t, s, h, kvh, d, bf16)
    got = verify_attention(q, kc, vc, pos)
    err, rel = compare(f"verify_attention ({route})", got,
                       verify_attention_plain(q, kc, vc, pos))
    check(torch.equal(got, paged_verify_attention(q, kp, vp, pages, pos)),
          "verify_attention is not bit-identical to paged_verify_attention "
          "on the same values through a shuffled page table")
    ms = time_ms(lambda: verify_attention(q, kc, vc, pos))
    dev_ms, kerns = device_ms(torch,
                              lambda: verify_attention(q, kc, vc, pos))
    plain_ms = time_ms(lambda: verify_attention_plain(q, kc, vc, pos))
    q_pos = pos[:, None] + torch.arange(t, device=dev)[None, :]   # (B, T)
    vmask = (torch.arange(s, device=dev)[None, None, :]
             <= q_pos[:, :, None])[:, None].expand(b, h, t, s)

    def sdpa():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=vmask, enable_gqa=True)

    library_ms = time_ms(sdpa)
    lib_dev_ms, lib_kerns = device_ms(torch, sdpa)
    rows = int((pos.long() + t).sum())              # positions read
    nbytes = rows * kvh * d * 2 * 2 + 2 * q.numel() * 2 + b * 4
    flops = int((q_pos.long() + 1).sum()) * h * d * 4   # visible pairs
    bound_ms, bound_by = bound(nbytes, flops)
    # the paged speculative window (phase 9) at the same shape and values
    p_ms = time_ms(lambda: paged_verify_attention(q, kp, vp, pages, pos))
    p_dev_ms, _ = device_ms(
        torch, lambda: paged_verify_attention(q, kp, vp, pages, pos))
    out["verify_attention"] = dict(
        max_abs_err=err, rel_norm_err=rel, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        library_device_ms=lib_dev_ms, kernel_route=route, device_ms=dev_ms)
    # SDPA on the contiguous cache is the paged window's yardstick too
    out["paged_verify_attention"]["window"] = dict(
        t=t, kernel_route=route, ms=p_ms, device_ms=p_dev_ms,
        library_ms=library_ms, library_device_ms=lib_dev_ms)
    print(f"  verify_attention max |kernel - plain| {err:.3e}, "
          f"||kernel - plain|| / ||plain|| {rel:.3e}, torch.equal to "
          f"paged_verify_attention: True")
    print(f"  verify_attention B={b} T={t} KVH={kvh} G={g} D={d} S={s} "
          f"ragged pos route {route}: kernel {ms:.4f} ms (kernel-only "
          f"{fmt_ms(dev_ms)}: {kerns}), plain {plain_ms:.4f} ms, "
          f"SDPA (boolean (B, H, T, S) mask) {library_ms:.4f} ms "
          f"(kernel-only {fmt_ms(lib_dev_ms)}: {lib_kerns}), bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}, {nbytes} B, {flops} flop)")
    print(f"  paged_verify_attention at the same window (T={t}, route "
          f"{route}): kernel {p_ms:.4f} ms (kernel-only {fmt_ms(p_dev_ms)}),"
          f" SDPA on the contiguous cache kernel-only {fmt_ms(lib_dev_ms)}")

    return out


def phase_scan(torch, dev):
    """Phase 3, the linear scan at rwkv6-3b's prefill (bf16, B 1, H 48
    padded heads, dh 64; T 1,024 and a ragged 1,000): the chunked route
    against the plain version (y and state), then timed by events, kernel
    only (``torch.profiler``: both grids, each printed) with the L2 warm
    and flushed, and host work per call, beside the plain version, the
    bound and the registers and spills ptxas reported."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import _sm_count
    from repro_torch.kernels.linear_scan.ops import (chunk_steps,
                                                     linear_scan,
                                                     linear_scan_plain,
                                                     plan)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(2468)
    b, h, dh = 1, 48, 64
    # the chunk as built, and a carry CTA's state columns (kVB in
    # scan_chunked.cuh)
    route, chunk, vb = plan(bf16, dh), chunk_steps(dh), 32
    errs, rels, serrs = [], [], []
    for t in (1024, 1000):
        r, k, v, logw, u = scan_inputs(torch, gen, dev, b, t, h, dh, bf16)
        err, rel, serr = compare_scan(torch, f"linear_scan (T={t}, {route})",
                                      r, k, v, logw, u)
        errs.append(err)
        rels.append(rel)
        serrs.append(serr)
        print(f"  linear_scan T={t} route {route}: max |kernel - plain| "
              f"{err:.3e}, ||kernel - plain|| / ||plain|| {rel:.3e}, state "
              f"max err {serr:.3e}")
    r, k, v, logw, u = scan_inputs(torch, gen, dev, b, 1024, h, dh, bf16)
    t = r.shape[1]

    def kernel():
        return linear_scan(r, k, v, logw, u)

    ms = time_ms(kernel)
    dev_ms, kerns = device_ms(torch, kernel)
    cold_ms, cold_kerns = device_ms(torch, kernel, cold=True)
    h_us = host_us(torch, kernel)
    plain_ms = time_ms(lambda: linear_scan_plain(r, k, v, logw, u,
                                                 return_state=True))
    # r, k, v, y in bf16, logw in f32, read or written once; u and the
    # f32 state; the recurrence's 5 dh^2 flop per step and head
    nbytes = (4 * r.numel() * 2 + logw.numel() * 4 + u.numel() * 4
              + b * h * dh * dh * 4)
    flops = 5 * b * t * h * dh * dh
    bound_ms, bound_by = bound(nbytes, flops)
    regs = [ln for ln in ptxas_report(build.build_log.get(
        "linear_scan", (0, ""))[1]) if "scan" in ln]
    # the chunked route's two grids run on the tensor cores
    counts = sass_mma_counts(build.library_path("linear_scan"))
    mma = {}
    for grid in ("intra", "carry"):
        hits = [n for name, n in counts.items()
                if f"scan_{grid}_kernelILi{dh}ELi{chunk}EE" in name]
        mma[grid] = hits[0] if len(hits) == 1 else 0
    check(all(mma.values()),
          f"linear_scan: no HMMA in the chunked route's SASS: {mma}")
    ctas = b * h * -(-t // chunk), b * h * (dh // vb)
    print(f"  linear_scan B={b} T={t} H={h} dh={dh} route {route} (chunk "
          f"{chunk}: intra-chunk grid {ctas[0]} CTAs, carry grid {ctas[1]} "
          f"CTAs of {vb} state columns, on {_sm_count(dev.index)} SMs): "
          f"kernel {ms:.4f} ms (kernel-only "
          f"{fmt_ms(dev_ms)}: {kerns}; L2 cold {fmt_ms(cold_ms)}: "
          f"{cold_kerns}; host {h_us:.1f} us a call), plain "
          f"{plain_ms:.4f} ms, no library call, bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}, {nbytes} B, {flops} flop; "
          f"{flops / 67e12 * 1e6:.2f} us at float32's 67 TFLOP/s)")
    print("  ptxas: " + (" | ".join(regs) or "no report (library cached)"))
    print("  SASS HMMA instructions: " + ", ".join(
        f"scan_{k}_kernel {n}" for k, n in mma.items()))
    return dict(
        max_abs_err=max(errs), rel_norm_err=max(rels),
        state_max_abs_err=max(serrs), ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        kernel_route=route, chunk=chunk, value_block=vb,
        ctas=dict(intra=ctas[0], carry=ctas[1]), sass_hmma=mma,
        device_ms=dev_ms, device_cold_ms=cold_ms, host_us=h_us,
        ptxas=regs)


def phase_scan_builds(torch, dev):
    """Phase 3b, every build of the scan (B 2, H 3, dh 32/64/128) against
    the plain version: the float32 loop and the bfloat16 chunked route,
    at T 1, 40 (under a chunk), 77 (a ragged tail) and 77 under strong
    decay (logw down to -30 a step)."""
    import itertools

    from repro_torch.kernels.linear_scan.ops import plan
    gen = torch.Generator(device=dev)
    gen.manual_seed(1357)
    for dtype, dh in itertools.product((torch.float32, torch.bfloat16),
                                       (32, 64, 128)):
        route = plan(dtype, dh)
        name = f"{str(dtype).removeprefix('torch.')} dh={dh} ({route})"
        res = []
        for t, strong in ((1, False), (40, False), (77, False), (77, True)):
            r, k, v, logw, u = scan_inputs(torch, gen, dev, 2, t, 3, dh,
                                           dtype, strong=strong)
            err, rel, serr = compare_scan(
                torch, f"linear_scan {name} T={t}"
                f"{' strong decay' if strong else ''}", r, k, v, logw, u)
            res.append(f"T{t}{'s' if strong else ''} {err:.2e}/{rel:.2e}/"
                       f"{serr:.2e}")
        print(f"  linear_scan {name}: y max err / norm err / state max err: "
              + "; ".join(res))


def phase_flash_bidir(torch, dev):
    """Phase 3, flash's bidirectional form at whisper-small's shapes
    (bf16, B 8, H = KVH 12, D 64, 1,500 encoder frames): the encoder's
    self-attention (Sq = Skv = 1,500) and the decoder's cross-attention
    at decode (Sq 1) and at prefill (Sq 4, the start-of-transcript
    prefix), each against its plain version, timed beside it, beside
    SDPA (``is_causal=False``, a yardstick the port never calls) and
    beside its bound, with the route it took and its kernel-only device
    time.  Returns one record per shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        _route, flash_attention, flash_attention_plain)

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    b, h, kvh, d, skv = 8, 12, 12, 64, 1500
    k = torch.randn((b, skv, kvh, d), generator=gen, device=dev).to(bf16)
    v = torch.randn((b, skv, kvh, d), generator=gen, device=dev).to(bf16)
    out = {}
    for tag, sq in (("encoder", 1500), ("cross_decode", 1),
                    ("cross_prefill", 4)):
        q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(bf16)
        route = _route(sq, skv, h, kvh, d, bf16)
        err, rel = compare(f"flash_attention bidirectional {tag} ({route})",
                           flash_attention(q, k, v, causal=False),
                           flash_attention_plain(q, k, v, causal=False))
        ms = time_ms(lambda: flash_attention(q, k, v, causal=False))
        dev_ms, kerns = device_ms(
            torch, lambda: flash_attention(q, k, v, causal=False))
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v,
                                                         causal=False))

        def sdpa():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=False)

        library_ms = time_ms(sdpa)
        lib_dev_ms, lib_kerns = device_ms(torch, sdpa)
        # q, k, v read once and o written once, bf16; every (query, key)
        # pair scores: 2 D flop for q.k and 2 D for p.v
        nbytes = (2 * b * sq * h * d + 2 * b * skv * kvh * d) * 2
        flops = 4 * b * h * d * sq * skv
        bound_ms, bound_by = bound(nbytes, flops)
        out[tag] = dict(sq=sq, skv=skv, max_abs_err=err, rel_norm_err=rel,
                        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=library_ms,
                        library_device_ms=lib_dev_ms, kernel_route=route,
                        device_ms=dev_ms)
        print(f"  flash_attention bidirectional {tag} B={b} Sq={sq} "
              f"Skv={skv} H={h} KVH={kvh} D={d} route {route}: max |kernel "
              f"- plain| {err:.3e}, rel {rel:.3e}; kernel {ms:.4f} ms "
              f"(kernel-only {fmt_ms(dev_ms)}: {kerns}), plain "
              f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms (kernel-only "
              f"{fmt_ms(lib_dev_ms)}: {lib_kerns}), bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}, {nbytes} B, {flops} "
              f"flop)")
    return out


def phase_builds(torch, dev):
    """Phase 3, second part: every build the wrappers can launch (the
    kernels are templates on dtype, D and, for decode, G), once each at
    a small ragged shape against the plain version: both verify kernels
    at every window of ``VERIFY_WINDOWS`` (both bf16 routes, across a
    page boundary, up to the last position), which must agree bit for
    bit, and the paged kernels bit for bit between 16- and 8-row pages.  Flash also at the shapes that reach both bf16 routes
    (``FLASH_ROUTE_CASES``).  A split-route case of flash, of either
    verify kernel and of either decode kernel is held against the split
    algorithm's plain version too."""
    import itertools
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.decode_attention.ops import plan as decode_plan
    from repro_torch.kernels.flash_attention.ops import (
        _route, _sm_count, _splits, flash_attention, flash_attention_plain,
        flash_attention_split_plain, plan)
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
    ps8, nb8 = 8, 38                    # the same rows in 8-row pages
    n_sm = _sm_count(dev.index)
    pos = torch.tensor([0, s - 1, 137], dtype=torch.int32, device=dev)
    pages = (torch.randperm(b * nb, generator=gen, device=dev) + 1).reshape(
        b, nb).to(torch.int32)
    pages8 = (torch.randperm(b * nb8, generator=gen, device=dev)
              + 1).reshape(b, nb8).to(torch.int32)
    for dtype, d, g in itertools.product((torch.float32, torch.bfloat16),
                                         (64, 128), (1, 2, 4, 8)):
        h = kvh * g
        name = f"{str(dtype).removeprefix('torch.')} D={d} G={g}"

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        q = randn(b, 1, h, d)
        kc, vc = randn(b, s, kvh, d), randn(b, s, kvh, d)
        got = decode_attention(q, kc, vc, pos)
        dec = compare(f"decode_attention {name}", got,
                      decode_attention_plain(q, kc, vc, pos))
        droute, _, per = decode_plan("decode_attention", h, kvh, d, dtype, s,
                                     b * kvh, n_sm)
        if droute == "split":
            compare(f"decode_attention {name} vs the split plain version",
                    got, flash_attention_split_plain(
                        q, kc, vc, causal=True, keys_per_split=per,
                        offsets=pos))
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
        if droute == "split":
            per = decode_plan("paged_decode_attention", h, kvh, d, dtype,
                              nb * ps, b * kvh, n_sm)[2]
            compare(f"paged_decode_attention {name} vs the split plain "
                    f"version", got, flash_attention_split_plain(
                        q, kc, vc, causal=True, keys_per_split=per,
                        offsets=pos))
        check(torch.equal(got, decode_attention(q, kc, vc, pos)),
              f"paged_decode_attention {name} is not bit-identical to "
              f"decode_attention")
        # and through a shuffled pool of 8-row pages (prefix_cache's):
        # the same capacity, so the same splits, and the same bits
        kp8 = randn(b * nb8 + 1, ps8, kvh, d)
        vp8 = randn(b * nb8 + 1, ps8, kvh, d)
        kp8[0], vp8[0] = 1e4, -1e4
        kp8[pages8.long()] = kc.reshape(b, nb8, ps8, kvh, d)
        vp8[pages8.long()] = vc.reshape(b, nb8, ps8, kvh, d)
        check(torch.equal(got, paged_decode_attention(q, kp8, vp8, pages8,
                                                      pos)),
              f"paged_decode_attention {name} with 8-row pages is not "
              f"bit-identical to 16-row pages")
        # both verify kernels on the same values at every window of
        # VERIFY_WINDOWS, bit for bit; a split-route window against the
        # split algorithm's plain version too
        vers = []
        for t, starts in VERIFY_WINDOWS:
            vpos = torch.tensor(starts, dtype=torch.int32, device=dev)
            q = randn(b, t, h, d)
            route, _, per = plan("verify_attention", t, h, kvh, d, dtype,
                                 nb * ps, b * kvh, n_sm)
            label = f"{name} T={t} ({route})"
            got = paged_verify_attention(q, kp, vp, pages, vpos)
            pver = compare(f"paged_verify_attention {label}", got,
                           paged_verify_attention_plain(q, kp, vp, pages,
                                                        vpos))
            ver = verify_attention(q, kc, vc, vpos)
            cver = compare(f"verify_attention {label}", ver,
                           verify_attention_plain(q, kc, vc, vpos))
            check(torch.equal(ver, got), f"verify_attention {label} is not "
                  f"bit-identical to paged_verify_attention")
            check(torch.equal(got, paged_verify_attention(q, kp8, vp8, pages8,
                                                          vpos)),
                  f"paged_verify_attention {label} with 8-row pages is not "
                  f"bit-identical to 16-row pages")
            if route == "split":
                compare(f"verify_attention {label} vs the split plain "
                        f"version", ver, flash_attention_split_plain(
                            q, kc, vc, causal=True, keys_per_split=per,
                            offsets=vpos))
            vers.append(f"T{t}@{starts[1]} {route} {cver[0]:.2e}/"
                        f"{cver[1]:.2e}, paged {pver[0]:.2e}/{pver[1]:.2e}")
        q = randn(2, sq, h, d)
        k, v = randn(2, sq, kvh, d), randn(2, sq, kvh, d)
        fl = compare(f"flash_attention {name}",
                     flash_attention(q, k, v, causal=True),
                     flash_attention_plain(q, k, v, causal=True))
        # the bidirectional form at Sq != Skv: ragged tiles on both
        # sides, and one query row over whisper's 1,500 frames
        bi = []
        for bsq, bskv in ((sq, s), (1, 1500)):
            q = randn(2, bsq, h, d)
            k, v = randn(2, bskv, kvh, d), randn(2, bskv, kvh, d)
            bi.append(compare(
                f"flash_attention bidirectional {name} Sq={bsq} "
                f"Skv={bskv}", flash_attention(q, k, v, causal=False),
                flash_attention_plain(q, k, v, causal=False)))
        routes = []
        for causal, rsq, rskv in FLASH_ROUTE_CASES:
            q = randn(2, rsq, h, d)
            k, v = randn(2, rskv, kvh, d), randn(2, rskv, kvh, d)
            route = _route(rsq, rskv, h, kvh, d, dtype)
            form = "causal" if causal else "bidirectional"
            label = f"flash_attention {name} {form} Sq={rsq} Skv={rskv}"
            got = flash_attention(q, k, v, causal=causal)
            err, rel = compare(f"{label} ({route})", got,
                               flash_attention_plain(q, k, v, causal=causal))
            if route == "split":
                per = _splits(2 * kvh, rskv, n_sm)[1]
                compare(f"{label} vs the split plain version", got,
                        flash_attention_split_plain(q, k, v, causal=causal,
                                                    keys_per_split=per))
            routes.append(f"{form[0]}{rsq}x{rskv} {route} "
                          f"{err:.2e}/{rel:.2e}")
        print(f"  {name}: decode max err {dec[0]:.2e} rel {dec[1]:.2e}; "
              f"flash {fl[0]:.2e}/{fl[1]:.2e}; {'; '.join(routes)}; "
              f"bidirectional "
              f"{sq}x{s} {bi[0][0]:.2e}/{bi[0][1]:.2e}, 1x1500 "
              f"{bi[1][0]:.2e}/{bi[1][1]:.2e}; paged decode "
              f"{pdec[0]:.2e}/{pdec[1]:.2e} (= decode); verify and paged "
              f"verify (bit-equal): {'; '.join(vers)}")


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


# The int8 GEMM's kernels in cuobjdump's SASS, by a piece of their
# mangled names: the wgmma route's and the mma.sync route's
INT8_KERNELS = {"wgmma": "int8_wgmma_kernel", "sync": "int8_matmul_kernel"}


def int8_sass() -> dict:
    """Opcode counts of the int8 library's kernels that tell its routes
    apart: warpgroup MMAs (*GMMA), mma.sync's IMMA, TMA loads (UTMALDG)
    and mbarrier operations (SYNCS), summed over each kernel's output
    types.  Fails unless the wgmma kernel has warpgroup MMAs, TMA loads
    and mbarrier waits, and the sync kernel IMMAs."""
    from repro_torch.kernels import build
    per = {}
    for name, ops in sass_ops(build.library_path("int8_matmul")).items():
        for tag, key in INT8_KERNELS.items():
            if key in name:
                acc = per.setdefault(tag, {"IMMA": 0, "UTMALDG": 0,
                                           "SYNCS": 0})
                for op, n in ops.items():
                    if op in acc or op.endswith("GMMA"):
                        acc[op] = acc.get(op, 0) + n
    for tag in INT8_KERNELS:
        c = per.get(tag, {})
        if tag == "wgmma":
            gmma = sum(n for op, n in c.items() if op.endswith("GMMA"))
            check(gmma > 0 and c.get("UTMALDG", 0) > 0
                  and c.get("SYNCS", 0) > 0,
                  f"int8_matmul {tag}: SASS lacks warpgroup MMAs, TMA "
                  f"loads or mbarrier operations: {c}")
        else:
            check(c.get("IMMA", 0) > 0,
                  f"int8_matmul {tag}: no IMMA in its SASS: {c}")
    return per


def phase_int8(torch, dev):
    """Phase 3, int8 GEMM: the tiny keyword spotter's pointwise GEMM (M
    12,544, K = N = 64, float32 out; the main path's shape) and a
    qwen3-1.7b FFN up-projection (M 1,024, K 2,048, N 6,144, bf16 out).
    Both take the wgmma route (route, tile, CTAs and waves printed); each
    is held bit for bit against its plain version, on that route and on
    the mma.sync route called through its own entry point at the same
    shape, then timed: the wrapper by events, kernel-only
    (``torch.profiler``) with the L2 warm and flushed, and its host work
    per call; the sync route the same way (the before-number); beside
    ``torch._int_mm`` alone kernel-only and ``_int_mm`` + the same
    epilogue (yardsticks the port never calls), the plain version and
    the bound at the int8 rate.  Then the registers, spills and SASS
    opcodes of both routes' kernels."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import _sm_count
    from repro_torch.kernels.int8_matmul.ops import (
        WGMMA_STAGES, WGMMA_TILE, int8_matmul, int8_matmul_plain, launch,
        plan, wgmma_encode_us)

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    n_sm = _sm_count(dev.index)
    rec = {}
    for tag, (m, k, n), out_dtype in (
            ("tiny", (12544, 64, 64), torch.float32),
            ("lm", (1024, 2048, 6144), torch.bfloat16)):
        xq, wq, sx, sw = int8_inputs(torch, gen, dev, m, k, n)
        route = plan(m, k, n, out_dtype)
        check(route == "wgmma", f"int8_matmul {tag}: route {route}")
        bm, bn = WGMMA_TILE
        ctas = -(-m // bm) * -(-n // bn)
        waves = ctas / n_sm                 # one CTA an SM
        name = f"int8_matmul {tag} M={m} K={k} N={n} " \
               f"{str(out_dtype).removeprefix('torch.')}"
        err = compare_int8(torch, f"{name} ({route})", xq, wq, sx, sw,
                           out_dtype)
        want = int8_matmul_plain(xq, wq, sx, sw, out_dtype)
        check(torch.equal(launch(xq, wq, sx, sw, out_dtype, "sync"), want),
              f"{name}: the sync route is not bit-equal to plain")

        def kernel():
            return int8_matmul(xq, wq, sx, sw, out_dtype=out_dtype)

        def sync():
            return launch(xq, wq, sx, sw, out_dtype, "sync")

        def int_mm():
            return torch._int_mm(xq, wq)

        def int_mm_epilogue():
            return ((torch._int_mm(xq, wq).float() * sx) * sw).to(out_dtype)

        ms = time_ms(kernel)
        dev_ms, kerns = device_ms(torch, kernel)
        cold_ms, _ = device_ms(torch, kernel, cold=True)
        h_us = host_us(torch, kernel)
        enc_us = wgmma_encode_us(xq, wq, kernel())
        s_ms = time_ms(sync)
        s_dev_ms, s_kerns = device_ms(torch, sync)
        s_cold_ms, _ = device_ms(torch, sync, cold=True)
        s_h_us = host_us(torch, sync)
        plain_ms = time_ms(lambda: int8_matmul_plain(xq, wq, sx, sw,
                                                     out_dtype))
        library_ms = time_ms(int_mm_epilogue)
        lib_dev_ms, _ = device_ms(torch, int_mm_epilogue)
        mm_ms = time_ms(int_mm)
        mm_dev_ms, mm_kerns = device_ms(torch, int_mm)
        mm_cold_ms, _ = device_ms(torch, int_mm, cold=True)
        # x, w read once, the scales once, the output written once
        out_bytes = 4 if out_dtype == torch.float32 else 2
        nbytes = m * k + k * n + 4 * (m + n) + m * n * out_bytes
        ops = 2 * m * n * k
        bound_ms, bound_by = bound(nbytes, ops, INT8_OP_PER_S)
        print(f"  {name}: route {route}, tile {bm}x{bn} ({WGMMA_STAGES} "
              f"stages, one CTA an SM): {ctas} CTAs on {n_sm} SMs, "
              f"{waves:.2f} waves; bit-equal to plain on both routes")
        print(f"    wgmma: {ms:.4f} ms by events, kernel-only "
              f"{fmt_ms(dev_ms)} ({kerns}), L2 cold {fmt_ms(cold_ms)}, host "
              f"{h_us:.1f} us a call ({enc_us:.2f} us of it encoding the "
              f"TMA descriptors)")
        print(f"    sync (mma.sync, 128x64): {s_ms:.4f} ms by events, "
              f"kernel-only {fmt_ms(s_dev_ms)} ({s_kerns}), L2 cold "
              f"{fmt_ms(s_cold_ms)}, host {s_h_us:.1f} us a call")
        print(f"    torch._int_mm alone {mm_ms:.4f} ms by events, "
              f"kernel-only {fmt_ms(mm_dev_ms)} ({mm_kerns}), L2 cold "
              f"{fmt_ms(mm_cold_ms)}; _int_mm + epilogue {library_ms:.4f} "
              f"ms (kernel-only {fmt_ms(lib_dev_ms)}); plain "
              f"{plain_ms:.4f} ms; bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}, {nbytes} B, {ops} int8 op)")
        rec[tag] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms, kernel_route=route,
            tile=[bm, bn], stages=WGMMA_STAGES, ctas=ctas, waves=waves,
            device_ms=dev_ms, device_cold_ms=cold_ms, host_us=h_us,
            encode_us=enc_us, sync_ms=s_ms, sync_device_ms=s_dev_ms,
            sync_device_cold_ms=s_cold_ms, sync_host_us=s_h_us,
            library_device_ms=lib_dev_ms, int_mm_ms=mm_ms,
            int_mm_device_ms=mm_dev_ms, int_mm_device_cold_ms=mm_cold_ms)
    regs = [ln for ln in ptxas_report(build.build_log.get(
        "int8_matmul", (0, ""))[1]) if "int8" in ln]
    sass = int8_sass()
    print("  ptxas: " + (" | ".join(regs) or "no report (library cached)"))
    print("  SASS: " + "; ".join(f"{tag} {c}" for tag, c in sass.items()))
    # the record's numbers are the main path's (tiny) shape; the LM
    # shape's ride along under lm_*
    out = dict(rec["tiny"])
    out.update({f"lm_{key}": v for key, v in rec["lm"].items()
                if key != "max_abs_err"})
    out.update(ptxas=regs, sass=sass)
    return out


# Phase 3b's int8 shapes: the reference test's (256^3, 300 x 500 x 260,
# 128 x 1,024 x 512), ragged edges on the sync route (every dimension
# off the 128 / 64 / 64 tiles, K off 16 and 4, N off 4), and on the
# wgmma route: ragged M, N and K tiles (300 x 272 x 528), a lone row
# and the smallest K and N (1 x 16 x 16), one whole stage (65 x 128 x
# 80) and 64 stages, 16 turns of the ring (200 x 8,192 x 400).
INT8_SHAPES = ((256, 256, 256), (300, 500, 260), (128, 1024, 512),
               (1, 1, 1), (17, 500, 9), (130, 77, 65), (129, 64, 63),
               (300, 272, 528), (1, 16, 16), (65, 128, 80),
               (200, 8192, 400))


def phase_int8_builds(torch, dev):
    """Phase 3b, int8 GEMM: every shape of ``INT8_SHAPES``, float32 and
    bf16 out, bit-equal to the plain version through the wrapper (its
    route printed); a wgmma-route shape also through the sync route."""
    from repro_torch.kernels.int8_matmul.ops import (
        int8_matmul_plain, launch, plan)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    for (m, k, n) in INT8_SHAPES:
        xq, wq, sx, sw = int8_inputs(torch, gen, dev, m, k, n)
        route = plan(m, k, n, torch.float32)
        for out_dtype in (torch.float32, torch.bfloat16):
            label = f"int8_matmul M={m} K={k} N={n} {out_dtype}"
            compare_int8(torch, f"{label} ({route})", xq, wq, sx, sw,
                         out_dtype)
            if route == "wgmma":
                check(torch.equal(
                    launch(xq, wq, sx, sw, out_dtype, "sync"),
                    int8_matmul_plain(xq, wq, sx, sw, out_dtype)),
                    f"{label}: the sync route is not bit-equal to plain")
        tile = " (sync route too)" if route == "wgmma" else ""
        print(f"  int8_matmul M={m} K={k} N={n} route {route}{tile}: "
              f"float32 and bf16 equal to plain")


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


def whisper_near_tie(torch, model, params, frames, prompt, a, b, j):
    """The kernel path's logits at the first token j where greedy token
    lists ``a`` (kernel path) and ``b`` (plain path) of one request part:
    prefill of prompt + a[:j] less its last token, one decode step on
    it.  Returns (logit(a[j]) - logit(b[j]), phase 9's near-tie limit)."""
    import numpy as np
    toks = torch.as_tensor(np.concatenate([np.asarray(prompt), a[:j]]),
                           dtype=torch.long, device=frames.device)[None]
    with torch.no_grad():
        lg, c = model.prefill(params, {"frames": frames,
                                       "tokens": toks[:, :-1]},
                              max_len=toks.shape[1])
        lg, _ = model.decode_step(params, c, toks[:, -1:])
    row = lg[0, -1].float()
    return (float(row[a[j]] - row[b[j]]),
            LOGIT_REL_TOL * float(row.abs().max()))


def phase_whisper(torch, dev):
    """Phase 14: full-width whisper-small (12 + 12 layers, d_model 768,
    12 heads of 64, 1,500 frames, padded vocab 53,248, bf16, seeded
    weights) behind ``ServeEngine(batch_size=8, max_len=448)``: 8
    requests with 4-token prompts and 64 new tokens each, frames (8,
    1,500, 768) from numpy seed 0 as ``extra_inputs``.  Every attention
    goes through a kernel: flash for the encoder (bidirectional), the
    prefill's cross-attention (bidirectional, Sq 4) and causal decoder
    prefill, and each decode step's cross-attention (Sq 1); decode for
    each step's self-attention.  Launch counts are exact; the kernel
    path is held against ``kernels=False`` on the same weights (first
    token logits within phase 5's limit, greedy tokens equal except
    from a near-tie on).  Returns the launch counts."""
    import copy

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_leaves
    from repro_torch.serving import Request, ServeEngine

    cfg = get_config("whisper-small")
    model = build_model(cfg, dev)
    params = model.init(seed=0)
    n_params = sum(t.numel() for t in tree_leaves(params))
    e = cfg.encdec
    print(f"  encoder {e.enc_layers} layers over {e.enc_len} frames, "
          f"decoder {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, padded vocab {model.vp}, {n_params} params "
          f"({cfg.dtype})")
    b, prompt_len, new_tokens, max_len = 8, 4, 64, 448
    rng = np.random.default_rng(0)
    frames = torch.as_tensor(
        rng.standard_normal((b, e.enc_len, cfg.d_model), dtype=np.float32),
        device=dev)
    requests = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                   prompt_len),
                        max_new_tokens=new_tokens) for i in range(b)]
    extra = {"frames": frames}
    engine = ServeEngine(model, params, max_len=max_len, batch_size=b,
                         device=dev)
    with torch.no_grad():
        enc_ms = time_ms(lambda: model.encode(params, frames), reps=5,
                         warmup=1)
    engine.run_batch([dataclasses.replace(r, max_new_tokens=2)
                      for r in requests], extra_inputs=extra)  # warm-up
    torch.cuda.synchronize()
    kernels = launch_counters()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    done = engine.run_batch(copy.deepcopy(requests), now=time.perf_counter,
                            extra_inputs=extra)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {name: k.launches for name, k in kernels.items()}
    tokens = engine.tokens_per_request(done)
    prefill_ms = (done[0].first_token_s - t0) * 1e3
    step_ms = (done[0].done_s - done[0].first_token_s) * 1e3 / (
        new_tokens - 1)
    print(f"  encoder (B {b}) {enc_ms:.3f} ms; run_batch: prefill "
          f"(encoder, cross K/V, decoder) {prefill_ms:.3f} ms wall, decode "
          f"{step_ms:.3f} ms per step x {new_tokens - 1}, {tokens} tokens "
          f"in {(t_end - t0) * 1e3:.1f} ms: {tokens / (t_end - t0):.1f} "
          f"tokens/s")
    print("  launches: " + ", ".join(f"{k} {n}" for k, n in launches.items()))
    check(tokens == b * new_tokens, f"{tokens} tokens, want {b * new_tokens}")
    for r in done:
        check(len(r.output) == new_tokens and
              all(0 <= t < model.vp for t in r.output),
              f"request {r.rid}: {len(r.output)} tokens, or one outside "
              f"the padded vocabulary")
    want_flash = 3 * cfg.n_layers + cfg.n_layers * (new_tokens - 1)
    want_dec = cfg.n_layers * (new_tokens - 1)
    check(launches["flash_attention"] == want_flash,
          f"flash launches {launches['flash_attention']} != {want_flash} "
          f"({3 * cfg.n_layers} + {cfg.n_layers} x {new_tokens - 1})")
    check(launches["decode_attention"] == want_dec,
          f"decode launches {launches['decode_attention']} != {want_dec}")
    check(all(n == 0 for k, n in launches.items()
              if k not in ("flash_attention", "decode_attention")),
          "the whisper path launched another kernel")

    # the plain path on the same weights
    plain = build_model(cfg, dev, kernels=False)
    inputs = {"frames": frames,
              "tokens": torch.as_tensor(np.stack([r.prompt for r in
                                                  requests]), device=dev)}
    with torch.no_grad():
        got = model.prefill(params, inputs, max_len=max_len)[0].float()
        want = plain.prefill(params, inputs, max_len=max_len)[0].float()
    rel = float((got - want).abs().max() / want.abs().max())
    print(f"  first-token logits, kernel vs plain path: max |d| / max "
          f"|plain| = {rel:.3e} (<= {LOGIT_REL_TOL})")
    check(bool(torch.isfinite(got).all()), "non-finite whisper logits")
    check(rel <= LOGIT_REL_TOL, f"whisper kernel-path logits differ by "
          f"{rel}")
    plain_done = ServeEngine(plain, params, max_len=max_len, batch_size=b,
                             device=dev).run_batch(copy.deepcopy(requests),
                                                   extra_inputs=extra)
    same = 0
    for r, p in zip(done, plain_done):
        if r.output == p.output:
            same += 1
            continue
        j = next(i for i in range(new_tokens) if r.output[i] != p.output[i])
        gap, tol = whisper_near_tie(torch, model, params,
                                    frames[r.rid:r.rid + 1], r.prompt,
                                    r.output, p.output, j)
        print(f"  request {r.rid} parts at token {j}: logit(kernel "
              f"{r.output[j]}) - logit(plain {p.output[j]}) = {gap:.4f}, "
              f"near-tie limit {tol:.4f}")
        check(abs(gap) <= tol, f"request {r.rid}: kernel and plain paths "
              f"part at token {j} without a near-tie ({gap} > {tol})")
    print(f"  {same}/{b} requests token-identical (kernel vs plain path)")
    return launches


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
    by_rid = {r.rid: r for r in requests}
    for rid in sorted(plain):
        near_tie(torch, model, spec_eng.params, by_rid[rid].prompt,
                 plain[rid], spec[rid], f"request {rid} (plain vs "
                 f"speculative)")

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


def phase_power(torch, dev, model, engine, requests) -> dict:
    """Phase 15: the main path under ``PowerRun`` with the card's own
    energy.  (a) 2 s of idle draw from the NVML energy counter beside
    the H100 spec's estimate, and the counter's update period.  (b)
    ``PowerRun(ContinuousBatchingSUT(phase 4's engine, energy_meter=
    NVML), Server(mode="queue", target_qps=8, min_queries=16,
    latency_slo_s=10))`` over phase 4's prompts and budgets: the review
    must ACCEPT, the stack's accelerator energy lie within
    ``ENERGY_ALIGN_TOL`` of the counter's delta over the serve, the
    accelerator's average watts between half the idle draw and 1.05 x
    the enforced limit, and the launches be exact.  (c)
    ``serving_throughput.metrics(smoke=True)`` on the card: both SUTs
    ACCEPT.  (d) the launcher's fixed engine under Offline through
    ``ServeEngineSUT``: ACCEPT.  Returns (b)'s launches."""
    import numpy as np
    from repro_torch.benchmarks import serving_throughput
    from repro_torch.harness import ContinuousBatchingSUT, PowerRun, Server
    from repro_torch.hw import H100_SXM
    from repro_torch.launch import serve as tserve
    from repro_torch.power.nvml import NVML
    from repro_torch.serving import Request

    cfg = model.cfg
    with NVML(dev) as nvml:
        limit_w = nvml.power_limit_w()
        meter = nvml.energy_meter()
        period = nvml.counter_period_s
        print(f"  NVML: {nvml.name()} at {nvml.bus_id}, enforced limit "
              f"{limit_w:.2f} W; energy counter moves every "
              f"{period * 1e3:.3f} ms (median), so read every "
              f"{meter.keywords['period_s'] * 1e3:.3f} ms")
        # (a) idle draw
        torch.cuda.synchronize()
        with meter() as idle:
            time.sleep(2.0)
        idle_w = idle.energy_j() / idle.window_s()
        print(f"  (a) idle: {idle_w:.2f} W measured over "
              f"{idle.window_s():.3f} s ({idle.n_samples} readings); "
              f"H100_SXM.idle_watts {H100_SXM.idle_watts:.1f} W "
              f"(estimate); power reading now {nvml.power_w():.2f} W")

        # (b) the main path
        def make_request(i, s, a):
            qid = s["qid"]
            r = requests[qid % len(requests)]
            return Request(rid=qid, prompt=r.prompt,
                           max_new_tokens=r.max_new_tokens, arrival_s=a)

        engine.serve([Request(rid=-1, prompt=np.arange(64),
                              max_new_tokens=9)], honor_arrivals=False)
        sut = ContinuousBatchingSUT(engine, cfg, name="qwen3-1.7b-continuous",
                                    make_request=make_request,
                                    energy_meter=meter)
        torch.cuda.synchronize()
        kernels = launch_counters()
        for k in kernels.values():
            k.launches = 0
        r = PowerRun(sut, Server(mode="queue", target_qps=8.0,
                                 min_queries=16, latency_slo_s=10.0,
                                 min_duration_s=1.0), seed=0).run()
        launches = {name: k.launches for name, k in kernels.items()}
    print("  " + r.render().replace("\n", "\n  "))
    m = r.outcome.server
    n = r.outcome.result.n_queries
    check(r.passed, "phase 15 main path: the review REJECTED the run")
    check(launches["decode_attention"] == cfg.n_layers * engine.decode_steps,
          f"phase 15 decode launches {launches['decode_attention']} != "
          f"{cfg.n_layers} layers x {engine.decode_steps} decode steps")
    check(launches["flash_attention"] == cfg.n_layers * n,
          f"phase 15 flash launches {launches['flash_attention']} != "
          f"{cfg.n_layers} layers x {n} admissions")
    dom = r.per_domain_energy_j
    sampler = sut.trace.segments[0][1]
    counter_j = sut.trace.energy_j()
    acc_j = dom["accelerator"]
    err = abs(acc_j - counter_j) / counter_j
    window = r.summary.window_s
    lead, tail = sut.trace.gaps_s(r.outcome.result.duration_s)
    acc_w = acc_j / window
    tokens = m.total_tokens
    print(f"  (b) {n} requests, {tokens} tokens in {window:.3f} s: "
          f"{m.tokens_per_s:.1f} tok/s, TTFT p50/p99 "
          f"{m.ttft_p(50) * 1e3:.1f}/{m.ttft_p(99) * 1e3:.1f} ms, TPOT "
          f"mean {m.tpot_mean * 1e3:.2f} ms; launches: decode "
          f"{launches['decode_attention']} (28 x {engine.decode_steps} "
          f"steps), flash {launches['flash_attention']} (28 x {n})")
    print("  (b) energy: " + "; ".join(
        f"{k} {v:.3f} J ({'measured, NVML counter' if k == 'accelerator' else 'derived: PSU of the rails' if k == 'wall' else 'modeled'})"
        for k, v in sorted(dom.items()))
          + f"; accelerator {acc_w:.2f} W average")
    print(f"  (b) {tokens / acc_j:.4f} tok/J at the accelerator "
          f"(measured), {tokens / r.summary.energy_j:.4f} tok/J at the "
          f"wall; the counter's delta over the serve {counter_j:.3f} J in "
          f"{sampler.window_s():.3f} s, {sampler.n_samples} readings every "
          f"{sampler.period_s * 1e3:.3f} ms; stack vs counter "
          f"{err * 100:.3f} %; the sampler read {lead * 1e3:.3f} ms "
          f"before the serve's t = 0 and {tail * 1e3:.3f} ms after its "
          f"window")
    check(0 <= lead <= sampler.period_s and 0 <= tail <= sampler.period_s,
          f"phase 15: the serve's window is not inside the sampler's "
          f"readings to within one period ({sampler.period_s * 1e3:.3f} "
          f"ms): {lead * 1e3:.3f} ms before, {tail * 1e3:.3f} ms after")
    check(err <= ENERGY_ALIGN_TOL,
          f"phase 15: the stack's accelerator energy {acc_j:.3f} J is "
          f"{err * 100:.2f} % off the counter's delta {counter_j:.3f} J")
    check(0.5 * idle_w <= acc_w <= 1.05 * limit_w,
          f"phase 15: accelerator {acc_w:.2f} W outside [{0.5 * idle_w:.2f},"
          f" {1.05 * limit_w:.2f}] W")

    # (c) the serving-throughput benchmark on the card
    st = serving_throughput.metrics(device=dev, smoke=True)
    for name in ("fixed", "continuous"):
        p = st[name]
        check(p["review_passed"],
              f"phase 15 serving_throughput: the {name} run was REJECTED")
        print(f"  (c) serving_throughput {name}: {p['tokens_per_s']:.1f} "
              f"tok/s, {p['tok_per_j']:.4f} tok/J at the wall, "
              f"{p['tok_per_j_accelerator']:.4f} tok/J at the accelerator "
              f"({p['accelerator_j']:.3f} J measured); review ACCEPTED")
    print(f"  (c) speedup {st['speedup']:.3f}x, chunk_syncs "
          f"{st['chunk_syncs']}")
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the launcher's fixed engine under Offline
    fixed = tserve.main(["--arch", "qwen3-1.7b", "--engine", "fixed",
                         "--scenario", "offline", "--min-duration", "2"])
    check(fixed["review_passed"],
          "phase 15 launcher: the fixed engine's Offline run was REJECTED")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, idle_w=idle_w, limit_w=limit_w,
                counter_period_s=period, tokens_per_s=m.tokens_per_s,
                accelerator_j=acc_j, counter_j=counter_j,
                tok_per_j_accelerator=tokens / acc_j,
                tok_per_j_wall=tokens / r.summary.energy_j)


# Phase 16 (a): paged verify at the chunk shapes of the sweep's geometry
# (benchmarks/slo_sweep.py: 64-row pages, 13-page rows, chunks of 64):
# (T, window start) for a long's first, second and last chunk, a 72-token
# prompt's 8-token tail, and a parked long's resume suffix (768 cached
# tokens + a 5-token tail).  T 64 at G 2 is 128 rows per KV head (the tile
# route); T 8 and T 5 are 16 and 10 (the split route).
SLO_CHUNK_SHAPES = ((64, 0), (64, 64), (64, 704), (8, 64), (5, 768))

# Phase 16 (a): paged decode in the sweep's pool: 8 slots at ragged
# positions up to the last row of their 13-page rows (832 rows), taking
# 13 + 1 + 2 + 1 + 1 + 5 + 1 + 2 = 26 pages, all of the 27-page pool but
# the garbage page, which the rest of each table row points at.
SLO_DECODE_POS = (831, 23, 79, 15, 0, 300, 63, 127)


def near_tie(torch, model, params, prompt, a, b, label) -> None:
    """Two token lists of one request must be equal or part at a
    near-tie: at the first index j where they differ, the logits after
    ``prompt + a[:j]`` (a prefill and one decode step) may rank a[j]
    above b[j] by at most ``LOGIT_REL_TOL`` of the largest |logit|."""
    import numpy as np
    if a == b:
        return
    check(len(a) == len(b), f"{label}: {len(b)} tokens vs {len(a)}")
    j = next(i for i in range(len(a)) if a[i] != b[i])
    toks = torch.as_tensor(np.concatenate([np.asarray(prompt), a[:j]]),
                           device=model.device)[None]
    with torch.no_grad():
        lg, c = model.prefill(params, {"tokens": toks[:, :-1]},
                              max_len=toks.shape[1])
        lg, _ = model.decode_step(params, c, toks[:, -1:])
    row = lg[0, -1].float()
    gap = float(row[a[j]] - row[b[j]])
    tol = LOGIT_REL_TOL * float(row.abs().max())
    print(f"  {label} diverges at token {j}: logit({a[j]}) - "
          f"logit({b[j]}) = {gap:.4f}, near-tie limit {tol:.4f}")
    check(gap <= tol, f"{label}: divergence at token {j} is not a "
          f"near-tie ({gap} > {tol})")


def phase_slo_kernel(torch, dev) -> dict:
    """Phase 16 (a): ``paged_verify_attention`` at ``SLO_CHUNK_SHAPES``
    (qwen3-1.7b's heads: H 16, KVH 8, D 128, bf16; one slot of 13
    shuffled 64-row pages in a 27-page pool, page 0 large finite
    garbage) against its plain version under phase 3b's tolerances;
    each shape's route, kernel time by events and kernel-only, the plain
    version's, SDPA's on the contiguous prefix (no gather) and the
    bound.  Then ``paged_decode_attention`` in the sweep's pool (8 slots
    at ``SLO_DECODE_POS``, 13-page rows of 64 rows, 27 pages) against
    its plain version and the split algorithm's plain version under the
    same tolerances, and bit for bit against ``decode_attention`` on the
    gathered rows; its route, split layout, times and bound as phase 3's
    decode rows.  Returns (the chunk shapes' figures, the decode
    figures)."""
    import torch.nn.functional as F
    from repro_torch.benchmarks import slo_sweep as sw
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ops import plan as decode_plan
    from repro_torch.kernels.flash_attention.ops import (
        _route, _sm_count, flash_attention_split_plain)
    from repro_torch.kernels.paged_decode_attention.ops import (
        paged_decode_attention, paged_decode_attention_plain, paged_view)
    from repro_torch.kernels.paged_verify_attention.ops import (
        paged_verify_attention, paged_verify_attention_plain)

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    h, kvh, d = 16, 8, 128
    ps, nb = sw.PAGE_SIZE, sw.MAX_LEN // sw.PAGE_SIZE
    kp = torch.full((sw.KV_PAGES, ps, kvh, d), 1e4, dtype=bf16, device=dev)
    vp = torch.full_like(kp, -1e4)
    pages = (torch.randperm(sw.KV_PAGES - 1, generator=gen, device=dev)[:nb]
             + 1).to(torch.int32)[None]
    kp[pages[0].long()] = torch.randn((nb, ps, kvh, d), generator=gen,
                                      device=dev).to(bf16)
    vp[pages[0].long()] = torch.randn((nb, ps, kvh, d), generator=gen,
                                      device=dev).to(bf16)
    rows = {}
    for t, start in SLO_CHUNK_SHAPES:
        q = torch.randn((1, t, h, d), generator=gen, device=dev).to(bf16)
        pos = torch.tensor([start], dtype=torch.int32, device=dev)
        route = _route(t, nb * ps, h, kvh, d, bf16)

        def kernel():
            return paged_verify_attention(q, kp, vp, pages, pos)

        def plain():
            return paged_verify_attention_plain(q, kp, vp, pages, pos)

        label = f"paged_verify_attention T={t} at {start} ({route})"
        err, rel = compare(label, kernel(), plain())
        skv = start + t
        kc = kp[pages[0].long()].reshape(1, nb * ps, kvh, d)[:, :skv]
        vc = vp[pages[0].long()].reshape(1, nb * ps, kvh, d)[:, :skv]
        mask = (torch.arange(skv, device=dev)[None, :]
                <= start + torch.arange(t, device=dev)[:, None])[None, None]

        def sdpa():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)

        ms = time_ms(kernel)
        dev_ms, kerns = device_ms(torch, kernel)
        plain_ms = time_ms(plain)
        library_ms = time_ms(sdpa)
        lib_dev_ms, _ = device_ms(torch, sdpa)
        pairs = t * start + t * (t + 1) // 2        # visible (query, key)
        flops = 4 * h * d * pairs
        nbytes = (skv * kvh * d * 2 * 2 + 2 * q.numel() * 2
                  + -(-skv // ps) * 4 + 4)
        bound_ms, bound_by = bound(nbytes, flops)
        rows[f"T{t}@{start}"] = dict(
            max_abs_err=err, rel_norm_err=rel, kernel_route=route, ms=ms,
            device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
            library_device_ms=lib_dev_ms, bound_ms=bound_ms,
            bound_by=bound_by)
        print(f"  {label}: max |kernel - plain| {err:.3e}, ||kernel - "
              f"plain|| / ||plain|| {rel:.3e}; kernel {ms:.4f} ms "
              f"(kernel-only {fmt_ms(dev_ms)}: {kerns}), plain "
              f"{plain_ms:.4f} ms, SDPA (contiguous, no gather) "
              f"{library_ms:.4f} ms (kernel-only {fmt_ms(lib_dev_ms)}), "
              f"bound {bound_ms * 1e3:.3f} us ({bound_by}, {nbytes} B, "
              f"{flops} flop)")

    # paged decode: every slot's table row filled to its position from a
    # shuffled pool, the rest of the row the garbage page
    b = sw.SLOTS
    pos = torch.tensor(SLO_DECODE_POS, dtype=torch.int32, device=dev)
    need = [p // ps + 1 for p in SLO_DECODE_POS]
    free = (torch.randperm(sw.KV_PAGES - 1, generator=gen, device=dev)
            + 1).tolist()
    check(sum(need) <= len(free), "phase 16 (a): SLO_DECODE_POS needs more "
          "pages than the sweep's pool holds")
    table = torch.zeros((b, nb), dtype=torch.int32)
    for i, n in enumerate(need):
        table[i, :n] = torch.tensor(free[:n])
        free = free[n:]
    table = table.to(dev)
    kp[1:] = torch.randn((sw.KV_PAGES - 1, ps, kvh, d), generator=gen,
                         device=dev).to(bf16)
    vp[1:] = torch.randn((sw.KV_PAGES - 1, ps, kvh, d), generator=gen,
                         device=dev).to(bf16)
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(bf16)
    kc, vc = paged_view(kp, table), paged_view(vp, table)
    route, n_split, per = decode_plan("paged_decode_attention", h, kvh, d,
                                      bf16, nb * ps, b * kvh,
                                      _sm_count(dev.index))
    got = paged_decode_attention(q, kp, vp, table, pos)
    label = f"paged_decode_attention in the sweep's pool ({route})"
    err, rel = compare(label, got, paged_decode_attention_plain(
        q, kp, vp, table, pos))
    split = compare(f"{label} vs the split plain version", got,
                    flash_attention_split_plain(q, kc, vc, causal=True,
                                                keys_per_split=per,
                                                offsets=pos))
    check(torch.equal(got, decode_attention(q, kc, vc, pos)),
          f"{label} is not bit-identical to decode_attention on the "
          f"gathered rows")
    print(f"  {label}: {n_split} splits of {per} keys over {nb * ps} rows, "
          f"positions {list(SLO_DECODE_POS)}; max |kernel - plain| "
          f"{err:.3e}, ||kernel - plain|| / ||plain|| {rel:.3e}; vs the "
          f"split plain version {split[0]:.3e} / {split[1]:.3e}; "
          f"torch.equal to decode_attention: True")
    mask = (torch.arange(nb * ps, device=dev)[None, :]
            <= pos[:, None])[:, None, None]
    decode = dict(
        max_abs_err=err, rel_norm_err=rel, kernel_route=route,
        n_split=n_split, keys_per_split=per,
        **decode_times(torch, "paged_decode_attention (sweep's pool; SDPA: "
                       "contiguous, no gather)", F,
                       lambda: paged_decode_attention(q, kp, vp, table, pos),
                       lambda: paged_decode_attention_plain(q, kp, vp, table,
                                                            pos),
                       q, kc, vc, mask, pos,
                       extra_bytes=sum(need) * 4 + b * 4))
    return rows, decode


class _HostRead(AssertionError):
    pass


def guard_host_reads(torch, engine, method: str) -> list:
    """Wrap ``engine.<method>`` so that every tensor-to-host conversion
    raises while it runs; returns the list its calls are appended to."""
    names = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
             "__float__", "__index__")
    inner = getattr(engine, method)
    calls = []

    def raiser(name):
        def f(*args, **kw):
            raise _HostRead(f"Tensor.{name} inside {method}")
        return f

    def guarded(*args):
        # the methods live on torch's C base class: shadow them on
        # torch.Tensor for the call, then drop the shadows
        for n in names:
            setattr(torch.Tensor, n, raiser(n))
        try:
            out = inner(*args)
        finally:
            for n in names:
                delattr(torch.Tensor, n)
        calls.append(args[-1])
        return out

    setattr(engine, method, guarded)
    return calls


def phase_slo(torch, dev, model, params, kernels: dict) -> dict:
    """Phase 16: SLO-aware serving at full width (qwen3-1.7b, phase 4's
    weights).  (a) ``phase_slo_kernel``.  (b) slo_sweep's bimodal mix
    (longs of 768, shorts of 16, mids of 72, 8 new tokens each) offline
    through its monolithic and chunked engines: tokens equal except
    from a near-tie on, launches exact (chunked: paged verify 28 per
    chunk and no flash; monolithic: flash 28 per admission; both paged
    decode 28 per step), no host read inside a non-final chunk.  (c)
    the reference's preemption test at 64-row pages (two 240 + 16-token
    best-effort requests fill the 8 usable pages; a priority-1 112 +
    16-token one arrives at 10 ms of a virtual clock that ticks 2 ms a
    read): a preemption and a resume, only priority 0 parked, tokens as
    an uncontended run's except from a near-tie on.  (d)
    ``slo_sweep.metrics(smoke=True)`` on the card with the NVML meter:
    every review ACCEPTED.  Returns (b)'s launches."""
    import numpy as np
    from repro_torch.benchmarks import slo_sweep as sw
    from repro_torch.serving import (ContinuousBatchingEngine, Request,
                                     Scheduler)

    t_phase = time.perf_counter()
    cfg = model.cfg
    layers = cfg.n_layers
    print("  (a) paged verify at the chunk shapes, paged decode in the "
          "sweep's pool:")
    verify, decode = phase_slo_kernel(torch, dev)
    pver, pdec = (kernels["paged_verify_attention"],
                  kernels["paged_decode_attention"])
    pver["chunk_shapes"], pdec["sweep_pool"] = verify, decode
    pver["max_abs_err"] = max([pver["max_abs_err"]]
                              + [r["max_abs_err"] for r in verify.values()])
    pdec["max_abs_err"] = max(pdec["max_abs_err"], decode["max_abs_err"])

    # (b) chunked vs monolithic on the bimodal mix
    lens = (768, 16, 72, 16, 16, 768, 72, 16)
    rng = np.random.default_rng(16)
    requests = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n),
                        max_new_tokens=sw.NEW_TOKENS)
                for i, n in enumerate(lens)]

    def engine(**kw):
        return ContinuousBatchingEngine(
            model, params, max_len=sw.MAX_LEN, n_slots=sw.SLOTS,
            chunk_steps=sw.CHUNK_STEPS, kv_page_size=sw.PAGE_SIZE,
            kv_pages=sw.KV_PAGES, device=dev, **kw)

    runs, launches = {}, {}
    for name, kw in (("monolithic", {}),
                     ("chunked", dict(prefill_chunk_tokens=sw.PREFILL_CHUNK))):
        eng = engine(**kw)
        non_final = (guard_host_reads(torch, eng, "_prefill_chunk")
                     if kw else [])
        done, wall_s, counts = served_run(torch, eng, requests,
                                          honor_arrivals=False)
        st = eng.sched_stats
        runs[name] = {r.rid: r.output for r in done}
        launches[name] = counts
        print(f"  (b) {name}: {len(done)} requests, "
              f"{sum(len(r.output) for r in done)} tokens in {wall_s:.3f} "
              f"s; {st['prefill_chunks']} prefill chunks, "
              f"{st['decode_chunks']} decode chunks "
              f"({st['interleaved_chunks']} interleaved), "
              f"{eng.decode_steps} decode steps; launches: "
              + ", ".join(f"{k} {n}" for k, n in counts.items() if n))
        check(len(done) == len(requests) and all(
            len(r.output) == r.max_new_tokens for r in done),
            f"phase 16 {name}: not every request completed its budget")
        check(counts["paged_decode_attention"] == layers * eng.decode_steps,
              f"phase 16 {name}: paged decode launches "
              f"{counts['paged_decode_attention']} != {layers} x "
              f"{eng.decode_steps} steps")
        if kw:
            chunks = -(-np.asarray(lens) // sw.PREFILL_CHUNK)
            check(st["prefill_chunks"] == int(chunks.sum()),
                  f"phase 16 chunked: {st['prefill_chunks']} chunks != "
                  f"{int(chunks.sum())}")
            check(counts["paged_verify_attention"]
                  == layers * st["prefill_chunks"],
                  f"phase 16 chunked: paged verify launches "
                  f"{counts['paged_verify_attention']} != {layers} x "
                  f"{st['prefill_chunks']} chunks")
            check(counts["flash_attention"] == 0,
                  "phase 16 chunked: a prefill went through flash")
            # the warm-up's 64-token prompt is one (final) chunk
            check(len(non_final) == st["prefill_chunks"] - len(lens),
                  f"phase 16 chunked: {len(non_final)} guarded non-final "
                  f"chunks != {st['prefill_chunks'] - len(lens)}")
            print(f"  (b) {len(non_final)} non-final chunks ran with every "
                  f"tensor-to-host conversion raising: no host read")
        else:
            check(counts["flash_attention"] == layers * len(lens)
                  and counts["paged_verify_attention"] == 0,
                  f"phase 16 monolithic: flash {counts['flash_attention']} "
                  f"!= {layers} x {len(lens)} admissions, or a paged "
                  f"verify ran")
        del eng
    same = sum(runs["chunked"][i] == runs["monolithic"][i]
               for i in range(len(lens)))
    print(f"  (b) {same}/{len(lens)} requests token-identical (chunked vs "
          f"monolithic prefill)")
    for r in requests:
        near_tie(torch, model, params, r.prompt, runs["monolithic"][r.rid],
                 runs["chunked"][r.rid],
                 f"(b) request {r.rid} ({len(r.prompt)} tokens)")

    # (c) preemption, the reference test's geometry at 64-row pages
    def contended():
        g = np.random.default_rng(17)
        return [Request(rid=0, prompt=g.integers(0, cfg.vocab_size, 240),
                        max_new_tokens=16, priority=0),
                Request(rid=1, prompt=g.integers(0, cfg.vocab_size, 240),
                        max_new_tokens=16, priority=0),
                Request(rid=2, prompt=g.integers(0, cfg.vocab_size, 112),
                        max_new_tokens=16, arrival_s=0.01, priority=1,
                        deadline_s=0.05)]

    kw = dict(max_len=256, n_slots=3, chunk_steps=2, kv_page_size=64,
              device=dev)
    pre = ContinuousBatchingEngine(model, params, kv_pages=9,
                                   prefix_caching=True,
                                   scheduler=Scheduler(preemption=True), **kw)
    pre.serve(contended(), honor_arrivals=False)           # warm-up
    tick = [0.0]

    def now():
        tick[0] += 0.002
        return tick[0]

    def sleep(dt):
        tick[0] += max(0.0, dt)

    done = pre.serve(contended(), now=now, sleep=sleep)
    st = pre.sched_stats
    parked = sorted(r.rid for r in done if r.preemptions)
    print(f"  (c) {st['preemptions']} preemptions, {st['resumes']} resumes, "
          f"parked rids {parked}; prefix cache {pre.prefix_stats}")
    check(st["preemptions"] >= 1 and st["resumes"] >= 1,
          "phase 16 (c): no preemption or no resume")
    check(sorted(r.rid for r in done) == [0, 1, 2]
          and all(len(r.output) == 16 for r in done),
          "phase 16 (c): a request was lost or cut short")
    check(all(r.priority == 0 for r in done if r.preemptions),
          "phase 16 (c): a priority-1 request was parked")
    free = ContinuousBatchingEngine(model, params, kv_pages=33, **kw)
    want = {r.rid: r.output for r in free.serve(contended(),
                                                honor_arrivals=False)}
    same = sum(r.output == want[r.rid] for r in done)
    print(f"  (c) {same}/3 requests token-identical to the uncontended run")
    for r in done:
        near_tie(torch, model, params, r.prompt, want[r.rid], r.output,
                 f"(c) request {r.rid} (parked {r.preemptions}x)")
    del pre, free
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the SLO sweep on the card
    m = sw.metrics(device=dev, smoke=True)
    cal = m["calibration"]
    print(f"  (d) {cal['device']}: t_long {cal['t_long_ms']:.3f} ms, TTFT "
          f"SLO {cal['ttft_slo_ms']:.3f} ms, grid {cal['grid_qps']} QPS, "
          f"{24} queries a point")
    for name in ("monolithic", "chunked", "chunked_preempt",
                 "disaggregated"):
        p = m[name]
        check(p["review_passed"],
              f"phase 16 (d) slo_sweep {name}: a review REJECTED its run")
        extra = "".join(
            f", {k} {p[k]}" for k in ("preemptions", "resumes") if k in p)
        if "interleave_ratio" in p:
            extra += f", interleave ratio {p['interleave_ratio']:.4f}"
        if "accelerator_j" in p:
            energy = (f"{p['tok_per_j_accelerator']:.4f} tok/J at the "
                      f"accelerator ({p['accelerator_j']:.3f} J measured), "
                      f"{p['tok_per_j']:.4f} tok/J at the wall")
        else:
            energy = f"{p['tok_per_j']:.4f} tok/J at the wall (modeled)"
        print(f"  (d) {name}: attainment " + ", ".join(
            f"{k[7:]} {v:.3f}" for k, v in sorted(p.items())
            if k.startswith("attain_"))
              + f"; qps_at_slo {p['qps_at_slo']:.3f}, {p['tokens_per_s']:.1f}"
              f" tok/s, {energy}{extra}; reviews ACCEPTED")
    d = m["disaggregated"]
    check("counter_j" in d and "accelerator_j" not in d,
          "phase 16 (d) disaggregated: the row is not modeled beside the "
          "counter")
    print(f"  (d) disaggregated split at the mid point (modeled, "
          f"DATACENTER_H100): prefill {d['prefill_j']:.3f} J, decode "
          f"{d['decode_j']:.3f} J at the walls, prefill share "
          f"{d['prefill_energy_frac']:.4f}; the NVML counter's delta over "
          f"the same serve (reported, not gated): {d['counter_j']:.3f} J")
    if m["chunked_preempt"]["qps_at_slo"] or m["monolithic"]["qps_at_slo"]:
        print(f"  (d) speedup (chunked_preempt / monolithic sustainable "
              f"QPS, reported) {m['chunked_preempt']['speedup']:.3f}x")
    else:
        print(f"  (d) speedup undefined: both below the grid (no point "
              f"sustains the SLO; the metrics' speedup, "
              f"{m['chunked_preempt']['speedup']:.3f}, is the ratio of "
              f"the two floors of half the lowest rate)")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return {k: launches["monolithic"][k] + launches["chunked"][k]
            for k in launches["chunked"]}


# Phase 17 (a): the wall channel's samples lost from 0.5 s to 1.5 s of
# the serve (transient: a re-measured interval reads them).  At the
# measured stack's 100 Hz that is 100 samples of a window of a few
# seconds, far below R12's 95 % coverage without re-measurement.
FAULT_DROPOUT = (0.5, 1.0)

# Phase 17 (b): an arrival burst of 120 QPS for 0.5 s from 0.5 s of an
# 8-QPS Server, past what the engine serves at these prompts; the
# leaky-bucket shedder holds 8 queued requests, each request a 5 s
# deadline.
FAULT_BURST = dict(at_s=0.5, duration_s=0.5, qps=120.0)
FAULT_SHED_QUEUE = 8
FAULT_DEADLINE_S = 5.0

# Phase 17 (c): the replicas' virtual clock advances this much a read.
FAULT_CLOCK_TICK_S = 0.1

# Phase 18: speculative_efficiency's repetitions (its N_REPS is 4).
SPEC_BENCH_REPS = 2

# Phase 18 (a): positions in the benchmarks' own pools.  prefix_cache's
# 4 slots decode from 120 (a 112 + 8-token prompt) and the last slot
# reads its row's last position; speculative_efficiency's 4 slots sit
# at the end of an 8-token prompt, inside and near the end of an
# 81-token budget and on the cache's last row (its verify windows start
# at the first three and end on that row).
PREFIX_DECODE_POS = (120, 122, 123, 127)
SPEC_DECODE_POS = (8, 47, 88, 127)


@dataclasses.dataclass
class ServeTally:
    """One ``ContinuousBatchingEngine.serve`` inside ``serve_tally``:
    what its request stream and the engine's configuration fix (each
    request's budget, the stream's prefix hits) beside the engine's own
    counts (lookups, hits, decode steps, speculative rounds)."""
    speculative: bool
    draft_layers: int
    spec_k: int
    n_slots: int
    chunk_steps: int
    prefix_caching: bool
    budgets: tuple
    stream_hits: int
    lookups: int
    hits: int
    decode_steps: int
    spec_rounds: int

    @property
    def admissions(self) -> int:
        return len(self.budgets)


@contextlib.contextmanager
def every_repetition():
    """Records every repetition's result, by point, of the benchmarks'
    ``interleaved_best_of`` inside the block (they report the best)."""
    from repro_torch.benchmarks import common

    best_of = common.interleaved_best_of
    reps: dict = {}

    def recorded(run_fns, n_reps=4):
        def keep(name, run_once):
            def run():
                r = run_once()
                reps.setdefault(name, []).append(r)
                return r
            return run
        return best_of({name: keep(name, run_once)
                        for name, run_once in run_fns.items()}, n_reps)

    common.interleaved_best_of = recorded
    try:
        yield reps
    finally:
        common.interleaved_best_of = best_of


def stream_hits(engine, requests) -> int:
    """The prefix hits a serve's request stream fixes: in admission
    order (arrival, then rid), each prompt longer than a page whose
    first page an earlier prompt of the same serve began with (the
    engine empties its cache at every serve; phase 18's pool never has
    to evict a prefix a later request shares)."""
    if engine.prefix_cache is None:
        return 0
    ps, seen, hits = engine.page_size, set(), 0
    for r in sorted(requests, key=lambda r: (r.arrival_s, r.rid)):
        head = tuple(int(t) for t in r.prompt[:ps])
        hits += len(r.prompt) > ps and head in seen
        seen.add(head)
    return hits


@contextlib.contextmanager
def serve_tally():
    """Records a ``ServeTally`` for every engine serve inside the block
    (the benchmarks and ``ReplicatedSUT`` build or drive their engines
    themselves), from any thread."""
    from repro_torch.serving import ContinuousBatchingEngine

    serve = ContinuousBatchingEngine.serve
    log: list = []

    def tallied(engine, requests, *args, **kwargs):
        requests = list(requests)
        out = serve(engine, requests, *args, **kwargs)
        log.append(ServeTally(
            speculative=engine.speculative,
            draft_layers=(engine.draft_model.cfg.n_layers
                          if engine.speculative else 0),
            spec_k=engine.spec_k, n_slots=engine.n_slots,
            chunk_steps=engine.chunk_steps,
            prefix_caching=engine.prefix_cache is not None,
            budgets=tuple(r.max_new_tokens for r in requests),
            stream_hits=stream_hits(engine, requests),
            lookups=engine.prefix_stats["lookups"],
            hits=engine.prefix_stats["hits"],
            decode_steps=engine.decode_steps,
            spec_rounds=engine.spec_rounds))
        return out

    ContinuousBatchingEngine.serve = tallied
    try:
        yield log
    finally:
        ContinuousBatchingEngine.serve = serve


def check_stream(label: str, s: ServeTally) -> None:
    """Hold one serve's engine counts to what its request stream fixes:
    a prefix-caching engine looks up every admission and hits the
    stream's hits; the decode chunks (``chunk_steps`` plain steps or
    speculative rounds each) lie between the fewest the slots could
    share and one for every chunk of every request.  A request is
    active for ceil((budget - 1) / chunk_steps) plain chunks, and for
    ceil((budget - 1) / ((k + 1) chunk_steps)) to ceil((budget - 1) /
    chunk_steps) speculative ones (a round emits 1 to k + 1 tokens a
    slot); every chunk has one to ``n_slots`` active requests."""
    want = ((s.admissions, s.stream_hits) if s.prefix_caching else (0, 0))
    check((s.lookups, s.hits) == want,
          f"{label}: {s.lookups} lookups, {s.hits} hits; the request "
          f"stream fixes {want[0]} and {want[1]}")
    left = [max(n - 1, 0) for n in s.budgets]
    most = sum(-(-n // s.chunk_steps) for n in left)
    per_chunk = s.chunk_steps * (s.spec_k + 1 if s.speculative else 1)
    least = -(-sum(-(-n // per_chunk) for n in left) // s.n_slots)
    steps = s.spec_rounds if s.speculative else s.decode_steps
    chunks = steps // s.chunk_steps
    check(steps % s.chunk_steps == 0 and least <= chunks <= most,
          f"{label}: {steps} {'rounds' if s.speculative else 'steps'} "
          f"({chunks} chunks of {s.chunk_steps}) outside the {least} to "
          f"{most} chunks its {s.admissions} requests' budgets allow "
          f"on {s.n_slots} slots")


def check_launches(label: str, got: dict, layers: int, log: list,
                   paged: bool) -> None:
    """Each kernel's launches for the serves in ``log``, each serve's
    counts first held to its request stream (``check_stream``): a paged
    engine prefills the stream's misses through flash and its hits'
    suffixes through paged verify, and decodes through paged decode; a
    contiguous plain engine prefills through flash and decodes through
    decode; a speculative one prefills target and draft through flash,
    drafts k + 1 decode steps of the draft's layers a round and
    verifies through verify."""
    want = dict.fromkeys(launch_counters(), 0)
    for i, s in enumerate(log):
        check_stream(f"{label}, serve {i}", s)
        if paged:
            want["flash_attention"] += layers * (s.admissions
                                                 - s.stream_hits)
            want["paged_verify_attention"] += layers * s.stream_hits
            want["paged_decode_attention"] += layers * s.decode_steps
        elif s.speculative:
            want["flash_attention"] += (layers + s.draft_layers) * s.admissions
            want["decode_attention"] += (s.draft_layers * (s.spec_k + 1)
                                         * s.spec_rounds)
            want["verify_attention"] += layers * s.spec_rounds
        else:
            want["flash_attention"] += layers * s.admissions
            want["decode_attention"] += layers * s.decode_steps
    print(f"  {label} launches ({len(log)} serves): " + ", ".join(
        f"{k} {n}" for k, n in got.items() if n or want[k]))
    for k, n in got.items():
        check(n == want[k], f"{label}: {k} launches {n} != {want[k]} "
              f"expected from the serves' request streams and counts")


def phase_faults(torch, dev, model, params, engine, requests) -> dict:
    """Phase 17: fault injection on the main path at full width (phase
    4's weights and engine).  (a) ``PowerRun(ContinuousBatchingSUT(
    engine, energy_meter=NVML), Server(mode="queue"), fault_plan=
    FaultPlan([MeterDropout("wall", ...)]))``: hardened (``meter_retry=
    RetryPolicy()``) the review ACCEPTs with the wall's coverage 1.0
    after re-measurement and the stack's accelerator energy within
    ``ENERGY_ALIGN_TOL`` of the counter's delta; naive, R12 refuses.
    (b) a ``QueueOverload`` burst with ``ShedPolicy`` and per-request
    deadlines: every offered qid completed, shed or timed out exactly
    once, some shed, launches exact for what was served.  (c)
    ``ReplicatedSUT`` of two ``ContinuousBatchingSUT``s (one set of
    weights, two engines, modeled rails, each serve on a virtual clock)
    with replica 1 crashing halfway through its share: with ``retry``
    no qid lost or duplicated, launches exact for every serve of both
    replicas, and every request's tokens those of phase 4's engine
    serving the same requests offline, except from a near-tie on;
    without it the run raises; a set of measured replicas is refused.  Returns the launches of (a), (b) and
    (c)'s crashed run."""
    import numpy as np
    from repro_torch.core.loadgen import ShedPolicy, poisson_arrivals
    from repro_torch.faults import (FaultPlan, MeterDropout, QueueOverload,
                                    ReplicaCrash, RetryPolicy)
    from repro_torch.harness import (ContinuousBatchingSUT, PowerRun,
                                     ReplicatedSUT, Server)
    from repro_torch.power.nvml import NVML
    from repro_torch.serving import ContinuousBatchingEngine, Request

    t_phase = time.perf_counter()
    cfg = model.cfg
    layers = cfg.n_layers
    kernels = launch_counters()

    def counted(run):
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        out = run()
        torch.cuda.synchronize()
        return out, {name: k.launches for name, k in kernels.items()}

    def make_request(budget=None):
        def make(i, s, a):
            qid = s["qid"]
            r = requests[qid % len(requests)]
            return Request(rid=qid, prompt=r.prompt,
                           max_new_tokens=budget(qid) if budget else
                           r.max_new_tokens, arrival_s=a)
        return make

    def server(**kw):
        return Server(mode="queue", target_qps=8.0, min_queries=16,
                      latency_slo_s=10.0, min_duration_s=2.0, **kw)

    launches = dict.fromkeys(kernels, 0)

    # (a) meter dropout on the wall channel, hardened and naive
    with NVML(dev) as nvml:
        meter = nvml.energy_meter()
        for label, kw in (("hardened", dict(meter_retry=RetryPolicy())),
                          ("naive", {})):
            sut = ContinuousBatchingSUT(
                engine, cfg, name=f"qwen3-1.7b-{label}",
                make_request=make_request(), energy_meter=meter)
            plan = FaultPlan([MeterDropout("wall", *FAULT_DROPOUT)],
                             seed=17)
            with serve_tally() as log:
                r, got = counted(lambda: PowerRun(
                    sut, server(), seed=0, fault_plan=plan, **kw).run())
            n = r.outcome.result.n_queries
            check_launches(f"phase 17 (a) {label}", got, layers, log,
                           paged=False)
            for k in launches:
                launches[k] += got[k]
            h = r.channel_health["wall"]
            counter_j = sut.trace.energy_j()
            acc_j = r.per_domain_energy_j["accelerator"]
            err = abs(acc_j - counter_j) / counter_j
            failed = [c.rule for c in r.report.failures()]
            print(f"  (a) {label}: {n} requests in "
                  f"{r.outcome.result.duration_s:.3f} s; wall channel "
                  f"{h.describe()} ({h.n_dropped} samples lost after "
                  f"retries); review {'ACCEPTED' if r.passed else 'REJECTED'}"
                  f"{': ' + ', '.join(failed) if failed else ''}; "
                  f"accelerator {acc_j:.3f} J vs the counter's "
                  f"{counter_j:.3f} J ({err * 100:.3f} %)")
            if label == "hardened":
                check(r.passed, "phase 17 (a): the hardened run was "
                      "REJECTED: " + ", ".join(failed))
                check(h.coverage == 1.0 and h.retries >= 1,
                      f"phase 17 (a): the wall channel was not "
                      f"re-measured to full coverage ({h.describe()})")
                check(err <= ENERGY_ALIGN_TOL,
                      f"phase 17 (a): the stack's accelerator energy is "
                      f"{err * 100:.2f} % off the counter's delta")
            else:
                check(not r.passed and any(f.startswith("R12")
                                           for f in failed),
                      f"phase 17 (a): the naive run was not refused by "
                      f"the R12 coverage check (failures: {failed})")
                check(h.coverage < 0.95, f"phase 17 (a): the naive "
                      f"wall coverage {h.coverage:.3f} is not degraded")

    # (b) a queue-overload burst, shed and deadlined
    plan = FaultPlan([QueueOverload(**FAULT_BURST)], seed=17)
    scenario = server(deadline_s=FAULT_DEADLINE_S,
                      shed=ShedPolicy(max_queue=FAULT_SHED_QUEUE))
    sut = ContinuousBatchingSUT(
        engine, cfg, name="qwen3-1.7b-overload",
        make_request=make_request(lambda qid: 16 + 8 * (qid % 3)))
    with serve_tally() as log:
        r, got = counted(lambda: PowerRun(sut, scenario, seed=0,
                                          fault_plan=plan).run())
    m = r.outcome.server
    offered = (len(poisson_arrivals(scenario.target_qps,
                                    min_duration_s=scenario.min_duration_s,
                                    seed=scenario.seed,
                                    min_queries=scenario.min_queries))
               + len(plan.burst_arrivals()))
    rids = [q.rid for q in sut.completed]
    print(f"  (b) offered {offered} ({len(plan.burst_arrivals())} in the "
          f"burst): {m.n_admitted} admitted, {m.n_shed} shed, "
          f"{m.result.n_queries} completed within {FAULT_DEADLINE_S} s, "
          f"{m.n_timeout} timed out; SLO attainment "
          f"{m.slo_attainment:.3f}; review "
          f"{'ACCEPTED' if r.passed else 'REJECTED'}")
    check(m.n_admitted + m.n_shed == offered,
          f"phase 17 (b): {m.n_admitted} admitted + {m.n_shed} shed != "
          f"{offered} offered")
    check(len(rids) == len(set(rids)) == m.n_admitted,
          f"phase 17 (b): {len(rids)} completions ({len(set(rids))} "
          f"distinct) for {m.n_admitted} admitted")
    check(m.result.n_queries + m.n_timeout == m.n_admitted,
          "phase 17 (b): completed + timed out != admitted")
    check(m.n_shed > 0, "phase 17 (b): the burst shed nothing")
    check(sum(t.admissions for t in log) == m.n_admitted,
          f"phase 17 (b): the engine served "
          f"{sum(t.admissions for t in log)} of {m.n_admitted} admitted")
    check_launches("phase 17 (b)", got, layers, log, paged=False)
    for k in launches:
        launches[k] += got[k]

    # (c) two replicas, one crashing mid-serve.  Each replica's serves
    # run on a virtual clock, fresh at every serve (as
    # tests/test_torch_faults.py does on the CPU): the crash time taken
    # from the fault-free run then splits replica 1's share the same way
    # in the runs with and without retry, whatever the host's speed in
    # each (on the wall clock a faster later run could finish the whole
    # share before the crash, and lose nothing).  A read advances it by
    # FAULT_CLOCK_TICK_S, about what the card's host takes between two
    # reads (a decode chunk of 8 steps is two), so that arrivals overlap
    # in the slots as they do on the wall clock
    second = ContinuousBatchingEngine(model, params, max_len=2048,
                                      n_slots=8, chunk_steps=8, device=dev)
    second.serve([Request(rid=-1, prompt=np.arange(64), max_new_tokens=9)],
                 honor_arrivals=False)
    engines = (engine, second)

    def virtual_clock(eng):
        def serve(requests, **kw):
            t = [0.0]

            def now():
                t[0] += FAULT_CLOCK_TICK_S
                return t[0]

            def sleep(dt):
                t[0] += max(0.0, dt)

            kw.setdefault("now", now)
            kw.setdefault("sleep", sleep)
            # the class's serve at call time: serve_tally's, inside it
            return ContinuousBatchingEngine.serve(eng, requests, **kw)

        return serve

    for e in engines:
        e.serve = virtual_clock(e)
    fleet_request = make_request(lambda qid: 16 + 8 * (qid % 4))

    def fleet(retry=None, **kw):
        return ReplicatedSUT(
            [ContinuousBatchingSUT(e, cfg, name=f"replica{i}",
                                   make_request=fleet_request, **kw)
             for i, e in enumerate(engines)], name="qwen3-1.7b-fleet",
            retry=retry)

    free = fleet()
    PowerRun(free, server(), seed=0).run()
    done = sorted(q.done_s for q in free.replicas[1].completed)
    at = (done[len(done) // 2 - 1] + done[len(done) // 2]) / 2
    crash = FaultPlan([ReplicaCrash(1, at_s=at)], seed=17)
    hard = fleet(retry=RetryPolicy())
    with serve_tally() as log:
        r, got = counted(lambda: PowerRun(hard, server(), seed=0,
                                          fault_plan=crash).run())
    kept = hard.replicas[1].completed
    moved = [q for q in hard.replicas[0].completed if q.rid % 2]
    rids = sorted(q.rid for q in hard.completed)
    e = r.per_domain_energy_j
    print(f"  (c) replica 1 crashes at {at:.3f} s (halfway through its "
          f"share in a fault-free run): it kept {len(kept)}, "
          f"{len(moved)} re-dispatched onto replica 0 after "
          f"{RetryPolicy().delay_s(0) * 1e3:.0f} ms; {len(rids)} "
          f"completed of {r.outcome.server.n_admitted}; review "
          f"{'ACCEPTED' if r.passed else 'REJECTED'}; modeled energy "
          f"r0/wall {e['r0/wall']:.3f} J, r1/wall {e['r1/wall']:.3f} J "
          f"(billed through the crash), pdu {e['pdu']:.3f} J")
    # both replicas' serves, the crashed one's whole share and the
    # re-dispatch wave, each from its own thread
    check_launches("phase 17 (c)", got, layers, log, paged=False)
    for k in launches:
        launches[k] += got[k]
    check(r.passed, "phase 17 (c): the crashed fleet's run was REJECTED")
    check(rids == sorted(set(rids)) and len(rids)
          == r.outcome.server.n_admitted,
          "phase 17 (c): a qid was lost or served twice")
    check(kept and all(q.done_s < at for q in kept) and moved,
          "phase 17 (c): the crash did not split replica 1's share")
    alone = {q.rid: list(map(int, q.output)) for q in engine.serve(
        [Request(rid=q.rid, prompt=q.prompt, max_new_tokens=q.max_new_tokens)
         for q in hard.completed], honor_arrivals=False)}
    for q in hard.completed:
        near_tie(torch, model, params, q.prompt, alone[q.rid],
                 list(map(int, q.output)), f"phase 17 (c) request {q.rid}")
    naive = fleet()
    try:
        PowerRun(naive, server(), seed=0, fault_plan=crash).run()
        raised = ""
    except RuntimeError as exc:
        raised = str(exc)
    print(f"  (c) without retry: {raised or 'no error'}")
    check("re-dispatch" in raised,
          "phase 17 (c): a crash that lost queries did not raise without "
          "retry")
    with NVML(dev) as nvml:
        try:
            fleet(energy_meter=nvml.energy_meter())
            refused = ""
        except ValueError as exc:
            refused = str(exc)
    print(f"  (c) measured replicas: {refused or 'accepted'}")
    check("replica 0" in refused, "phase 17 (c): replicas with a measured "
          "meter on one card were not refused")
    del engine.serve, second
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_bench_kernels(torch, dev) -> dict:
    """Phase 18 (a): each kernel the benchmarks launch, at their own
    shapes (qwen3-1.7b's H 16, KVH 8, D 128, bf16), against its plain
    version and, on the split route, the split algorithm's plain
    version, under phase 3b's tolerances, printing route and split
    layout.  prefix_cache: paged decode in its pool (4 slots of 16
    8-row pages, 128 rows, 65 pages, page 0 large finite garbage; three
    slots share the system prompt's 14 pages) at ``PREFIX_DECODE_POS``;
    paged verify of a hit's 8-token suffix behind its 112 cached tokens
    and of a 5-token one (batch 1, the row's pages past the window the
    garbage page); both bit for bit against their contiguous kernels on
    the gathered rows; flash over a miss's 120-token prompt.
    speculative_efficiency: verify at T = k + 1 for k 2/4/8 in its 4
    slots' 128-row cache, starting at ``SPEC_DECODE_POS``'s first three
    and ending on the last row; decode (the draft's, and k0's target)
    at ``SPEC_DECODE_POS``; flash over its 8-token prompt.  Returns
    each kernel's figures by shape."""
    from repro_torch.benchmarks import prefix_cache as pc
    from repro_torch.benchmarks import speculative_efficiency as se
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.decode_attention.ops import plan as decode_plan
    from repro_torch.kernels.flash_attention.ops import (
        _sm_count, flash_attention, flash_attention_plain,
        flash_attention_split_plain, plan)
    from repro_torch.kernels.paged_decode_attention.ops import (
        paged_decode_attention, paged_decode_attention_plain, paged_view)
    from repro_torch.kernels.paged_verify_attention.ops import (
        paged_verify_attention, paged_verify_attention_plain)
    from repro_torch.kernels.verify_attention.ops import (
        verify_attention, verify_attention_plain)

    cfg = get_config("qwen3-1.7b")
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bf16, i32 = torch.bfloat16, torch.int32
    n_sm = _sm_count(dev.index)
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    rows: dict = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    def hold(name, label, layout, got, plain, q, kc, vc, offsets,
             same=None):
        route, n_split, per = layout
        err, rel = compare(f"{name} {label} ({route})", got, plain)
        line = (f"  {name} {label}: {route}; max |kernel - plain| "
                f"{err:.3e}, ||kernel - plain|| / ||plain|| {rel:.3e}")
        if route == "split":
            serr, srel = compare(
                f"{name} {label} vs the split plain version", got,
                flash_attention_split_plain(q, kc, vc, causal=True,
                                            keys_per_split=per,
                                            offsets=offsets))
            line += (f"; {n_split} splits of {per} keys, vs the split "
                     f"plain version {serr:.3e} / {srel:.3e}")
        if same is not None:
            check(torch.equal(got, same[1]), f"{name} {label} is not "
                  f"bit-identical to {same[0]}")
            line += f"; torch.equal to {same[0]}"
        print(line)
        rows.setdefault(name, {})[label] = dict(
            max_abs_err=err, rel_norm_err=rel, kernel_route=route,
            n_split=n_split, keys_per_split=per)

    # prefix_cache's pool: three slots on the shared prompt's pages,
    # the last on its own, each row filled to its position
    ps, nb = pc.PAGE_SIZE, pc.MAX_LEN // pc.PAGE_SIZE
    n_pages = pc.SLOTS * nb + 1                 # the engine's default
    kp, vp = randn(n_pages, ps, kvh, d), randn(n_pages, ps, kvh, d)
    kp[0], vp[0] = 1e4, -1e4
    free = (torch.randperm(n_pages - 1, generator=gen, device=dev)
            + 1).tolist()
    n_shared = pc.SHARED_LEN // ps
    shared, free = free[:n_shared], free[n_shared:]
    table = torch.zeros((pc.SLOTS, nb), dtype=i32)
    for b, p in enumerate(PREFIX_DECODE_POS):
        own = shared if b < pc.SLOTS - 1 else []
        n = p // ps + 1
        table[b, :n] = torch.tensor(own + free[:n - len(own)])
        free = free[n - len(own):]
    table = table.to(dev)
    pos = torch.tensor(PREFIX_DECODE_POS, dtype=i32, device=dev)
    q = randn(pc.SLOTS, 1, h, d)
    kc, vc = paged_view(kp, table), paged_view(vp, table)
    hold("paged_decode_attention",
         f"prefix_cache pool at {list(PREFIX_DECODE_POS)}",
         decode_plan("paged_decode_attention", h, kvh, d, bf16, nb * ps,
                     pc.SLOTS * kvh, n_sm),
         paged_decode_attention(q, kp, vp, table, pos),
         paged_decode_attention_plain(q, kp, vp, table, pos), q, kc, vc,
         pos, same=("decode_attention on the gathered rows",
                    decode_attention(q, kc, vc, pos)))
    for t in (pc.SUFFIX_LEN, 5):
        start = pc.SHARED_LEN
        hit = table[:1].clone()
        hit[:, (start + t - 1) // ps + 1:] = 0
        vpos = torch.tensor([start], dtype=i32, device=dev)
        q = randn(1, t, h, d)
        kc, vc = paged_view(kp, hit), paged_view(vp, hit)
        hold("paged_verify_attention", f"prefix_cache hit T={t} at {start}",
             plan("paged_verify_attention", t, h, kvh, d, bf16, nb * ps,
                  kvh, n_sm),
             paged_verify_attention(q, kp, vp, hit, vpos),
             paged_verify_attention_plain(q, kp, vp, hit, vpos), q, kc, vc,
             vpos, same=("verify_attention on the gathered rows",
                         verify_attention(q, kc, vc, vpos)))

    # speculative_efficiency's contiguous 4 x 128-row cache
    kc = randn(se.SLOTS, se.MAX_LEN, kvh, d)
    vc = randn(se.SLOTS, se.MAX_LEN, kvh, d)
    for t in sorted({k + 1 for k in se.K_SWEEP if k}):
        vpos = torch.tensor(SPEC_DECODE_POS[:-1] + (se.MAX_LEN - t,),
                            dtype=i32, device=dev)
        q = randn(se.SLOTS, t, h, d)
        hold("verify_attention", f"speculative_efficiency T={t} at "
             f"{vpos.tolist()}",
             plan("verify_attention", t, h, kvh, d, bf16, se.MAX_LEN,
                  se.SLOTS * kvh, n_sm),
             verify_attention(q, kc, vc, vpos),
             verify_attention_plain(q, kc, vc, vpos), q, kc, vc, vpos)
    pos = torch.tensor(SPEC_DECODE_POS, dtype=i32, device=dev)
    q = randn(se.SLOTS, 1, h, d)
    hold("decode_attention",
         f"speculative_efficiency at {list(SPEC_DECODE_POS)}",
         decode_plan("decode_attention", h, kvh, d, bf16, se.MAX_LEN,
                     se.SLOTS * kvh, n_sm),
         decode_attention(q, kc, vc, pos),
         decode_attention_plain(q, kc, vc, pos), q, kc, vc, pos)

    # flash over each benchmark's prompt (batch-1 prefills)
    for label, n in (("prefix_cache miss", pc.PROMPT_LEN),
                     ("speculative_efficiency prompt", se.PROMPT_LEN)):
        q, k, v = randn(1, n, h, d), randn(1, n, kvh, d), randn(1, n, kvh, d)
        hold("flash_attention", f"{label} S={n}",
             plan("flash_attention", n, h, kvh, d, bf16, n, kvh, n_sm),
             flash_attention(q, k, v, causal=True),
             flash_attention_plain(q, k, v, causal=True), q, k, v, None)
    return rows


def phase_benchmarks(torch, dev, kernels: dict, period_s: float) -> dict:
    """Phase 18: (a) ``phase_bench_kernels``, whose errors join the
    JSON line's (``bench_shapes``).  (b) ``prefix_cache`` and
    ``speculative_efficiency`` on the card at full width with the NVML
    meter, each through its own engines on its own seeded weights (seed
    0, as phase 4's).  Every review ACCEPTs and every kernel's launches
    are those each serve's request stream and counts fix
    (``check_launches``).  prefix_cache's hits,
    lookups and cached tokens must be those of the same request stream
    on the CPU (0/4/8 hits of 10 lookups at hit rates 0/0.5/0.9, 112
    cached tokens a hit; tests/test_torch_prefix_cache_bench.py holds
    the CPU run to the reference's).  Returns each benchmark's launches
    and figures."""
    from repro_torch.benchmarks import prefix_cache as pc
    from repro_torch.benchmarks import speculative_efficiency as se
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    print("  (a) the benchmarks' kernel shapes:")
    for name, shapes in phase_bench_kernels(torch, dev).items():
        kernels[name]["bench_shapes"] = shapes
        kernels[name]["max_abs_err"] = max(
            [kernels[name]["max_abs_err"]]
            + [r["max_abs_err"] for r in shapes.values()])
    layers = get_config("qwen3-1.7b").n_layers
    counters = launch_counters()
    out = {}
    # the speculative sweep at 2 interleaved repetitions, not its 4:
    # at 4 it takes ~170 s of the script (its random-draft point emits
    # one token a round)
    for name, paged, reps, run in (
            ("prefix_cache", True, pc.N_REPS,
             lambda: pc.metrics(device=dev, smoke=True)),
            ("speculative_efficiency", False, SPEC_BENCH_REPS,
             lambda: se.metrics(device=dev, smoke=True,
                                n_reps=SPEC_BENCH_REPS))):
        t0 = time.perf_counter()
        with serve_tally() as log, every_repetition() as runs:
            torch.cuda.synchronize()
            for k in counters.values():
                k.launches = 0
            m = run()
            torch.cuda.synchronize()
            got = {n: k.launches for n, k in counters.items()}
        print(f"  (b) {name}: best of {reps} repetitions, {len(log)} serves "
              f"in {time.perf_counter() - t0:.1f} s")
        check_launches(f"phase 18 {name}", got, layers, log, paged)
        # every repetition's window against the counter's period: the
        # measured Joules of a window of n periods are good to ~1 / n
        acc = {point: [r.outcome.server.total_tokens
                       / r.per_domain_energy_j["accelerator"] for r in rs]
               for point, rs in runs.items()}
        for point, rs in runs.items():
            print(f"  {point} repetitions: " + "; ".join(
                f"{r.outcome.server.tokens_per_s:.1f} tok/s, {a:.4f} tok/J "
                f"at the accelerator, window {r.outcome.result.duration_s:.3f}"
                f" s = {r.outcome.result.duration_s / period_s:.1f} periods"
                for r, a in zip(rs, acc[point])))
        for point, p in m.items():
            if point == "allocator":
                print(f"  {point}: {p['page_alloc_ops_per_s']:.0f} ops/s")
                continue
            extra = "".join(
                f", {k} {p[k]:.4f}" if isinstance(p[k], float)
                else f", {k} {p[k]}" for k in (
                    "acceptance", "speedup", "draft_energy_share",
                    "hits", "lookups", "cached_tokens", "peak_pages",
                    "capacity_ctx", "j_saved_per_cached_token") if k in p)
            print(f"  {point}: {p['tokens_per_s']:.1f} tok/s, "
                  f"{p['tok_per_j_accelerator']:.4f} tok/J at the "
                  f"accelerator ({p['accelerator_j']:.3f} J measured), "
                  f"{p['tok_per_j']:.4f} tok/J at the wall{extra}; review "
                  f"{'ACCEPTED' if p['review_passed'] else 'REJECTED'}")
            check(p["review_passed"],
                  f"phase 18 {name} {point}: the review was REJECTED")
        out[name] = dict(launches=got, metrics=m, tok_per_j_reps=acc)
    pm = out["prefix_cache"]["metrics"]
    for point, hits in (("hit0", 0), ("hit50", 4), ("hit90", 8)):
        p = pm[point]
        check((p["hits"], p["lookups"], p["cached_tokens"])
              == (hits, 10, hits * pc.SHARED_LEN),
              f"phase 18 prefix_cache {point}: hits/lookups/cached "
              f"{p['hits']}/{p['lookups']}/{p['cached_tokens']} != the "
              f"CPU's {hits}/10/{hits * pc.SHARED_LEN}")
    reps = out["prefix_cache"]["tok_per_j_reps"]
    print(f"  prefix_cache tok/J hit90 / hit0 (reported, not gated): wall "
          f"{pm['hit90']['tok_per_j'] / pm['hit0']['tok_per_j']:.3f}, "
          f"accelerator {pm['hit90']['tok_per_j_accelerator'] / pm['hit0']['tok_per_j_accelerator']:.3f}"
          f"; at the accelerator by repetition " + ", ".join(
              f"{a / b:.3f}" for a, b in zip(reps["hit90"], reps["hit0"])))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return out


# Phase 19: the disaggregated decode engine.  slo_sweep's page size,
# slots and chunk steps; phase 4's requests reach 1,028 tokens (prompt +
# budget), past the sweep's 832 rows, so a slot holds 17 pages of 64
# and the pool every slot full.
DISAGG_MAX_LEN = 1088
# Phase 19 (b): the prefill that raises, and how long serve may take to
# end with its error.
DISAGG_FAIL_AT = 3
DISAGG_FAIL_S = 30.0


def phase_disagg(torch, dev, model, params, requests) -> dict:
    """Phase 19: prefill/decode disaggregation at full width on phase
    4's weights.  (a) ``DisaggregatedEngine`` with two ``PrefillWorker``s
    (each prefilling in a thread of its own) and a paged decode engine
    serves phase 4's 16 requests offline and then with their arrivals:
    every request completes its budget; its tokens are the colocated
    paged engine's on the same weights and requests, except from a
    near-tie on; launches exact (flash 28 per request, counted from the
    worker threads; paged decode 28 per decode step; nothing else); one
    host read per decode chunk.  (b) A worker whose third prefill raises
    ends ``serve`` with that error within ``DISAGG_FAIL_S``.  (c)
    ``DisaggregatedSUT`` with the NVML meter is refused.  Returns (a)'s
    launches, both serves summed."""
    import copy
    import threading

    import numpy as np
    from repro_torch.benchmarks import slo_sweep as sw
    from repro_torch.harness import DisaggregatedSUT
    from repro_torch.launch.serve import summarize
    from repro_torch.power.nvml import NVML
    from repro_torch.serving import (ContinuousBatchingEngine,
                                     DisaggregatedEngine, PrefillWorker,
                                     Request)

    t_phase = time.perf_counter()
    layers = model.cfg.n_layers
    geometry = dict(max_len=DISAGG_MAX_LEN, n_slots=sw.SLOTS,
                    chunk_steps=sw.CHUNK_STEPS, kv_page_size=sw.PAGE_SIZE,
                    device=dev)

    def workers(cls=PrefillWorker):
        return [PrefillWorker(model, params, page_size=sw.PAGE_SIZE,
                              device=dev),
                cls(model, params, page_size=sw.PAGE_SIZE, device=dev)]

    colocated = ContinuousBatchingEngine(model, params, **geometry)
    done, wall_s, _ = served_run(torch, colocated, requests,
                                 honor_arrivals=False)
    want = {r.rid: r.output for r in done}
    print(f"  (a) colocated paged engine, offline: {len(done)} requests in "
          f"{wall_s:.3f} s")
    del colocated

    dec = ContinuousBatchingEngine(model, params, **geometry)
    deng = DisaggregatedEngine(workers(), dec)
    counters = launch_counters()
    total = dict.fromkeys(counters, 0)
    for label, arrivals in (("offline", False), ("arrivals", True)):
        deng.serve([Request(rid=-1 - k, prompt=np.arange(64 + 8 * k),
                            max_new_tokens=9) for k in range(2)],
                   honor_arrivals=False)              # warm-up
        torch.cuda.synchronize()
        for k in counters.values():
            k.launches = 0
        t0 = time.perf_counter()
        done = deng.serve(copy.deepcopy(requests), honor_arrivals=arrivals)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        got = {n: k.launches for n, k in counters.items()}
        for n in total:
            total[n] += got[n]
        m = summarize(done, wall_s)
        st = dec.sched_stats
        print(f"  (a) disaggregated, {label}: {m['requests']} requests, "
              f"{m['tokens']} tokens in {wall_s:.3f} s: "
              f"{m['tokens_per_s']:.1f} tokens/s, TTFT p50/p99 "
              f"{m['ttft_p50_s'] * 1e3:.1f}/{m['ttft_p99_s'] * 1e3:.1f} ms, "
              f"TPOT mean {m['tpot_mean_s'] * 1e3:.2f} ms; prefill tokens "
              f"by worker {[w.prefill_tokens for w in deng.workers]}; "
              f"{st['decode_chunks']} decode chunks, {dec.host_syncs} host "
              f"reads, {dec.decode_steps} decode steps; launches: "
              + ", ".join(f"{k} {n}" for k, n in got.items() if n))
        check(len(done) == len(requests) and all(
            len(r.output) == r.max_new_tokens for r in done),
            f"phase 19 {label}: not every request completed its budget")
        check(all(r.prefill_start_s <= r.first_token_s <= r.done_s
                  for r in done),
              f"phase 19 {label}: a request's stamps are out of order")
        check(got["flash_attention"] == layers * len(requests),
              f"phase 19 {label}: flash launches {got['flash_attention']} "
              f"!= {layers} x {len(requests)} prefills")
        check(got["paged_decode_attention"] == layers * dec.decode_steps,
              f"phase 19 {label}: paged decode launches "
              f"{got['paged_decode_attention']} != {layers} x "
              f"{dec.decode_steps} steps")
        check(got["decode_attention"] == got["verify_attention"]
              == got["paged_verify_attention"] == 0,
              f"phase 19 {label}: a kernel off the disaggregated path ran")
        check(dec.host_syncs == st["decode_chunks"] and dec.decode_steps
              == dec.chunk_steps * dec.host_syncs,
              f"phase 19 {label}: {dec.host_syncs} host reads for "
              f"{st['decode_chunks']} decode chunks")
        same = sum(r.output == want[r.rid] for r in done)
        print(f"  (a) {label}: {same}/{len(done)} requests token-identical "
              f"to the colocated paged engine")
        for r in done:
            near_tie(torch, model, params, r.prompt, want[r.rid], r.output,
                     f"(a) {label} request {r.rid}")

    class Failing(PrefillWorker):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.calls = 0

        def prefill(self, r, t0_s, now=time.monotonic):
            self.calls += 1
            if self.calls == DISAGG_FAIL_AT:
                raise RuntimeError(f"injected failure of prefill "
                                   f"{self.calls}")
            return super().prefill(r, t0_s, now)

    failing = DisaggregatedEngine(workers(Failing), dec)
    out: dict = {}

    def serve_failing():
        try:
            failing.serve(copy.deepcopy(requests), honor_arrivals=False)
        except RuntimeError as e:
            out["error"] = e

    t0 = time.perf_counter()
    runner = threading.Thread(target=serve_failing, daemon=True)
    runner.start()
    runner.join(timeout=DISAGG_FAIL_S)
    ended_s = time.perf_counter() - t0
    check(not runner.is_alive(), f"phase 19 (b): serve still running "
          f"{DISAGG_FAIL_S:.0f} s after a worker raised")
    check("injected failure" in str(out.get("error", "")),
          f"phase 19 (b): serve ended with {out.get('error')!r}, not the "
          f"worker's error")
    print(f"  (b) a worker's prefill {DISAGG_FAIL_AT} raised; serve ended "
          f"with its error after {ended_s:.3f} s: {out['error']}")

    nvml = NVML(dev)
    try:
        DisaggregatedSUT(deng, model.cfg, make_request=lambda i, s, a: None,
                         energy_meter=nvml.energy_meter())
        refused = ""
    except ValueError as e:
        refused = str(e)
    finally:
        nvml.close()
    check("measured energy_meter is refused" in refused,
          "phase 19 (c): DisaggregatedSUT took the NVML meter")
    print(f"  (c) DisaggregatedSUT with the NVML meter refused: {refused}")
    torch.cuda.synchronize()
    del deng, failing, dec
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return total


@contextlib.contextmanager
def recorded_sleeps():
    """Records every ``time.sleep`` inside the block (seconds asked)."""
    sleep = time.sleep
    asked: list = []

    def recorded(dt):
        asked.append(dt)
        sleep(dt)

    time.sleep = recorded
    try:
        yield asked
    finally:
        time.sleep = sleep


def phase_fleet(torch, dev) -> dict:
    """Phase 20: the modeled fleet calibrated on the card.
    ``fleet_sweep.metrics(smoke=True)`` measures the warm decode token
    time ``t_tok`` on the full-width qwen3-1.7b (seeded bf16 weights,
    its own engine: 4 slots, 48 rows, chunks of 4): launches exact for
    its serves (flash 28 per admission, decode 28 per decode step,
    ``check_launches``); every acceptance check of the sweep passes (it
    raises otherwise: the cap, R11's pdu = sum of replica walls, the
    exact ledger within 2 %, autoscaled beating static max-N on J/token
    at equal or better tail attainment) and every configuration's review
    ACCEPTs; the fleet runs in simulated time and sleeps through none of
    it.  Then the launcher ``repro_torch.launch.fleet`` with a short
    horizon: its review ACCEPTs.  Returns the calibration's launches."""
    from repro_torch.benchmarks import fleet_sweep as fs
    from repro_torch.configs import get_config
    from repro_torch.launch import fleet as launch_fleet

    t_phase = time.perf_counter()
    layers = get_config("qwen3-1.7b").n_layers
    counters = launch_counters()
    measure = fs._measure_t_tok
    cal_s: list = []

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return measure(*a, **kw)
        finally:
            cal_s.append(time.perf_counter() - t0)

    fs._measure_t_tok = timed
    try:
        with serve_tally() as log, recorded_sleeps() as asked:
            torch.cuda.synchronize()
            for k in counters.values():
                k.launches = 0
            t0 = time.perf_counter()
            m = fs.metrics(device=dev, smoke=True)
            sweep_s = time.perf_counter() - t0
            got = {n: k.launches for n, k in counters.items()}
    finally:
        fs._measure_t_tok = measure
    check_launches("phase 20 calibration", got, layers, log, paged=False)
    check(not asked, f"phase 20: the sweep slept {sum(asked):.3f} s in "
          f"{len(asked)} calls")
    cal = m["calibration"]
    print(f"  {cal['device']}: t_tok {cal['t_tok_ms']:.4f} ms, "
          f"{cal['tokens_per_s']:.1f} tokens/s; a request-time unit "
          f"{cal['unit_ms']:.3f} ms; {cal['n_arrivals']} arrivals over "
          f"{cal['horizon_s']:.3f} s of simulated time; calibration "
          f"{cal_s[0]:.1f} s, sweep {sweep_s - cal_s[0]:.1f} s of wall, no "
          f"sleep")
    for name, p in m.items():
        if name == "calibration":
            continue
        check(p["compliance_passed"] == 1.0,
              f"phase 20 fleet_sweep {name}: the review REJECTED its run")
        extra = "".join(f", {k} {p[k]:.3f}" for k in (
            "speedup", "peak_replica_w", "emitted_gco2") if k in p)
        print(f"  {name}: tail attainment {p['tail_attainment']:.4f}, "
              f"{p['tok_per_j']:.4f} tok/J, {p['tokens_per_s']:.1f} tok/s, "
              f"provisioned {p['provisioned_w_avg']:.1f} W, "
              f"{p['cold_starts']} cold starts, {p['scale_events']} scale "
              f"events, {p['n_crashed']} crashed{extra}; review ACCEPTED")
    print("  acceptance: cap, R11, exact ledger and autoscaled vs static "
          "max-N all passed (the sweep raises otherwise)")
    t0 = time.perf_counter()
    with recorded_sleeps() as asked:
        r = launch_fleet.main(["--horizon", "60"])
    check(r.passed, "phase 20: the fleet launcher's review REJECTED its run")
    check(not asked, "phase 20: the fleet launcher slept")
    print(f"  launcher (--horizon 60): ACCEPTED in "
          f"{time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 20 took {time.perf_counter() - t_phase:.1f} s")
    return got


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
        print(f"  {name}.cu: nvcc {secs:.2f} s; " + " | ".join(
            ptxas_report(log)))

    phase("phase 3: kernels vs plain versions (bf16, main-path shapes)")
    kernels = phase_kernels(torch, dev)
    bidir = phase_flash_bidir(torch, dev)
    flash = kernels["flash_attention"]
    flash["max_abs_err"] = max([flash["max_abs_err"]]
                               + [r["max_abs_err"] for r in bidir.values()])
    flash["bidirectional"] = bidir
    kernels["linear_scan"] = phase_scan(torch, dev)
    kernels["int8_matmul"] = phase_int8(torch, dev)
    phase("phase 3b: every kernel build vs its plain version (small shapes)")
    phase_builds(torch, dev)
    phase_scan_builds(torch, dev)
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

    phase("phase 15: the main path under PowerRun with the card's energy")
    power = phase_power(torch, dev, model, engine, requests)

    phase("phase 16: SLO-aware serving (chunked prefill, preemption, the "
          "SLO sweep)")
    print(smi.strip())
    slo_launches = phase_slo(torch, dev, model, params, kernels)

    phase("phase 17: faults on the main path (meter dropout, queue "
          "overload, a replica crash)")
    fault_launches = phase_faults(torch, dev, model, params, engine,
                                  requests)

    phase("phase 18: the prefix-cache and speculative benchmarks on the "
          "card")
    print(smi.strip())
    bench = phase_benchmarks(torch, dev, kernels,
                             power["counter_period_s"])
    prefix_launches = bench["prefix_cache"]["launches"]
    spec_bench_launches = bench["speculative_efficiency"]["launches"]

    phase("phase 19: prefill/decode disaggregation (two prefill workers, "
          "paged KV handoff)")
    disagg_launches = phase_disagg(torch, dev, model, params, requests)

    phase("phase 20: the modeled fleet calibrated on the card "
          "(fleet_sweep, launch.fleet)")
    fleet_launches = phase_fleet(torch, dev)

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

    phase("phase 14: full-width whisper-small through ServeEngine")
    whisper_launches = phase_whisper(torch, dev)

    # launches: each kernel's count on its own paths' runs (phases 4, 14,
    # 15, 17 and 20 for decode and flash, 16, 18 and 19 for flash, 18 for
    # decode; phases 6, 16 and 18 for the paged kernels and 19 for paged
    # decode, 8 and 18 for the verify kernel, phase 10 for the scan,
    # phase 12 for the int8 GEMM)
    dec = "src/repro/kernels/decode_attention/decode_attention.py"
    by_phase = {"4": launches, "14": whisper_launches,
                "15": power["launches"], "16": slo_launches,
                "17": fault_launches, "18": {
                    k: prefix_launches[k] + spec_bench_launches[k]
                    for k in prefix_launches},
                "19": disagg_launches, "20": fleet_launches}
    uses = {"decode_attention": ("4", "14", "15", "17", "18", "20"),
            "flash_attention": ("4", "14", "15", "16", "17", "18", "19",
                                "20"),
            "paged_decode_attention": ("6", "16", "18", "19"),
            "paged_verify_attention": ("6", "16", "18"),
            "verify_attention": ("8", "18")}
    by_phase["6"], by_phase["8"] = paged_launches, spec_launches
    totals = {}
    for name, phases in uses.items():
        kernels[name]["launches_by_phase"] = {
            p: by_phase[p][name] for p in phases}
        totals[name] = sum(kernels[name]["launches_by_phase"].values())
    sources = {
        "decode_attention": (f"{dec}:351", totals),
        "flash_attention": (
            "src/repro/kernels/flash_attention/flash_attention.py:77",
            totals),
        "paged_decode_attention": (f"{dec}:266", totals),
        "paged_verify_attention": (f"{dec}:308", totals),
        "verify_attention": (f"{dec}:127", totals),
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
