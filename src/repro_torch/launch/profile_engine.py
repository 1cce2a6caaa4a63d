"""Where the engine's time goes on the card: decode and prefill profiled.

  python -m repro_torch.launch.profile_engine [--arch rwkv6-3b]
  python -m repro_torch.launch.profile_engine --arch jamba-v0.1-52b
  python -m repro_torch.launch.profile_engine --arch phi-3-vision-4.2b
  python -m repro_torch.launch.profile_engine --arch whisper-small

Fills every slot of the full-width ``--arch`` (default qwen3-1.7b)
``ContinuousBatchingEngine`` (the engine shape ``chip_smoke.py`` serves
at) with a prompt of ``PROMPT_LEN`` tokens (seeded random weights and
tokens), then, after one warm-up chunk, measures the following.  An
arch whose weights pass ``CARD_SHARE`` of the card's memory runs at
full width on fewer layers (``fit_depth``: whole superblocks of a
hybrid; jamba-v0.1-52b on 16 of its 32), and the output names the cut
(or that the whole depth runs: phi-3-vision-4.2b's 32 layers).  A VLM
serves text-only here, as through the slot engine.

- decode: host wall time per step over 4 chunks of 8 steps (ending in a
  synchronize), then one chunk under ``torch.profiler`` for its kernels'
  device time; busy share = kernel time / the wall time measured with
  the profiler off; and the kernels that take the most device time;
- prefill: the same for an admission of ``PROMPT_LEN`` tokens, and its
  kernels' device time split (``prefill_split``) into GEMMs (cuBLAS:
  projections, FFNs, the MoE's expert products), attention (the port's
  kernels), the Mamba scan of a hybrid and the rest;
- speculative round: the same for one chunk of ``CHUNK_STEPS`` rounds
  of the speculative engine (``SPEC_K`` drafts from a 2-layer truncated
  draft, the target's layers past 2 damped to 0.001: ``chip_smoke.py``
  phase 8's pair), its slots filled the same way, per round; only for
  a dense target (a truncated draft needs one);
- prefix hit: the same for one admission of a ``PROMPT_LEN +
  SUFFIX_LEN``-token prompt into the paged engine (pages of
  ``PAGE_SIZE``, the radix prefix cache on, ``chip_smoke.py`` phase 6's
  engine) whose first ``PROMPT_LEN`` tokens are cached: the
  ``SUFFIX_LEN``-token suffix runs through paged verify attention behind
  them; for the dense and moe families (the paged engine takes no
  other, as in the reference).

A train step (``train_step_split``, called by ``chip_smoke.py`` phase
26) is split by CUDA events into the forward (``train_loss``), the
backward (``torch.autograd.grad``, remat's recomputed forwards inside
it) and the AdamW update, and profiled once for its kernels by kind.

whisper-small (an encoder-decoder, which the slot engine refuses) is
profiled as ``chip_smoke.py`` phase 14 serves it through ``ServeEngine``:
``SLOTS`` windows of frames with ``ENC_PROMPT``-token prompts and a
``ENC_MAX_LEN``-row cache; its encoder, its prefill (encoder, cross
K/V, decoder) and one decode step with the engine's per-step host read
of the next tokens, each timed on the host and profiled the same way.

Prints one JSON object as its last line.  Needs a CUDA device; the
numbers are the card's and are printed beside its name and power limit.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, list_archs
from repro_torch.models import build_model
from repro_torch.models import mamba as M
from repro_torch.models.param import DTYPES, tree_leaves
from repro_torch.serving import (ContinuousBatchingEngine, Request,
                                 damp_upper_layers, truncate_draft)

ARCH = "qwen3-1.7b"     # the engine shape chip_smoke.py serves at
MAX_LEN = 2048
SLOTS = 8
CHUNK_STEPS = 8
PROMPT_LEN = 1024
SPEC_K = 4
PAGE_SIZE = 16
SUFFIX_LEN = 200        # a prefix hit's uncached tail
SEED = 0
ENC_PROMPT = 4          # whisper's start-of-transcript prefix
ENC_MAX_LEN = 448       # whisper's text context
CARD_SHARE = 0.75       # of the card's memory the weights may take
# kernel names by part of a prefill (lower case substrings)
GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma", "gemv", "splitk")
ATTENTION_NAMES = ("flash", "decode", "merge_splits", "window_tile")


def weight_bytes(cfg) -> int:
    """Bytes of ``cfg``'s weights, from its parameter definitions."""
    defs = build_model(cfg, "cpu").param_defs()
    return sum(math.prod(d.shape) * DTYPES[d.dtype].itemsize
               for d in tree_leaves(defs))


def fit_depth(cfg, card_bytes: int):
    """``cfg`` at the most layers whose weights take at most
    ``CARD_SHARE`` of ``card_bytes`` (whole superblocks of a hybrid; at
    least every leading dense layer and one MoE layer of an mla_moe
    stack), full width.  Returns (config, its weights' bytes)."""
    step = cfg.hybrid.attn_period if cfg.hybrid is not None else 1
    least = cfg.moe.first_k_dense + 1 if cfg.family == "mla_moe" else step
    for n in range(cfg.n_layers - cfg.n_layers % step, least - 1, -step):
        cut = dataclasses.replace(cfg, n_layers=n)
        nbytes = weight_bytes(cut)
        if nbytes <= CARD_SHARE * card_bytes:
            return cut, nbytes
    raise ValueError(f"{cfg.name}: even {least} layers pass "
                     f"{CARD_SHARE:.0%} of {card_bytes / 1e9:.1f} GB")


def _wall_ms(fn, reps: int) -> float:
    """Host wall time of ``fn()`` in ms, averaged, ending in a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _kernels(fn) -> dict:
    """{kernel name: [launches, device ms]} of one call of ``fn`` under
    the profiler."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per[e.name][0] += 1
            per[e.name][1] += e.time_range.elapsed_us() / 1e3
    return per


def _profiled(fn, wall_ms: float, top: int = 16) -> dict:
    """Run ``fn`` once under the profiler: its kernels' device time, the
    busy share against ``wall_ms`` (measured with the profiler off, which
    itself slows the host) and the top kernels by device time."""
    per = _kernels(fn)
    kernel_ms = sum(ms for _, ms in per.values())
    ranked = sorted(per.items(), key=lambda kv: -kv[1][1])[:top]
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms,
            "busy_share": kernel_ms / wall_ms,
            "n_kernels": sum(n for n, _ in per.values()),
            "top": [{"kernel": k[:90], "count": n, "ms": ms}
                    for k, (n, ms) in ranked]}


@contextlib.contextmanager
def _timed_calls(module, name: str):
    """Bracket every call of ``module.name`` with CUDA events while the
    context is open; yields the list of (start, end) event pairs."""
    orig = getattr(module, name)
    pairs = []

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*args, **kw)
        end.record()
        pairs.append((start, end))
        return out

    setattr(module, name, timed)
    try:
        yield pairs
    finally:
        setattr(module, name, orig)


def prefill_split(fn) -> dict:
    """The device ms of one call of ``fn`` (an admission) split by part:
    its kernels under the profiler, GEMMs (cuBLAS, ``GEMM_NAMES``: the
    projections, FFNs and the MoE's expert products) and attention (the
    port's kernels, ``ATTENTION_NAMES``) by kernel name; then a second
    call with CUDA events around each ``mamba.selective_scan`` (a_bar,
    b_bar, the chunked scan and y: elementwise kernels, so none of them
    is a GEMM or attention): the Mamba scan's ms.  ``other_ms``: the
    rest (norms, the conv, routing and dispatch, softplus, ...)."""
    per = _kernels(fn)
    total = sum(ms for _, ms in per.values())

    def part(names):
        return sum(ms for k, (_, ms) in per.items()
                   if any(n in k.lower() for n in names))

    gemm, attention = part(GEMM_NAMES), part(ATTENTION_NAMES)
    with _timed_calls(M, "selective_scan") as pairs:
        fn()
        torch.cuda.synchronize()
    scan = sum(s.elapsed_time(e) for s, e in pairs)
    return {"kernel_ms": total, "gemm_ms": gemm,
            "attention_ms": attention, "scan_ms": scan,
            "scan_calls": len(pairs),
            "other_ms": total - gemm - attention - scan,
            "n_kernels": sum(n for n, _ in per.values())}


# kernel names by kind in a train step (lower case substrings); a GEMM
# is a GEMM whatever its dtype: the projections' bf16 products and the
# plain attention's float32 einsums alike
SOFTMAX_NAMES = ("softmax",)
REDUCE_NAMES = ("reduce", "norm", "logsumexp")


def train_step_split(model, state, batch, hp) -> dict:
    """One single-batch train step from ``state`` split in device ms by
    stage (CUDA events: forward, backward, AdamW; the wall time around
    them ends in a synchronize), then the same step under
    ``torch.profiler``: its kernels by kind (GEMMs, softmax, reductions
    and norms, the rest) and the kernels that take the most device time.
    The stages are ``make_train_step``'s own pieces; the step's new state
    is dropped."""
    from repro_torch.train.train_step import (apply_update, backward_grads,
                                              forward_loss)
    if hp.microbatches != 1:
        raise ValueError(f"train_step_split times a single-batch step; "
                         f"got microbatches={hp.microbatches}")

    def run(events=None):
        def mark(i):
            if events:
                events[i].record()

        mark(0)
        live, loss, _ = forward_loss(model, state.params, batch)
        mark(1)
        grads = backward_grads(state.params, live, loss)
        mark(2)
        out = apply_update(state, grads, hp)
        mark(3)
        return out

    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(events)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    del out
    stages = {name: events[i].elapsed_time(events[i + 1])
              for i, name in enumerate(("forward_ms", "backward_ms",
                                        "adamw_ms"))}
    per = _kernels(run)
    total = sum(ms for _, ms in per.values())

    def part(names):
        return sum(ms for k, (_, ms) in per.items()
                   if any(n in k.lower() for n in names))

    gemm, softmax = part(GEMM_NAMES), part(SOFTMAX_NAMES)
    reduce = part(REDUCE_NAMES)
    ranked = sorted(per.items(), key=lambda kv: -kv[1][1])[:8]
    return {"wall_ms": wall, **stages, "kernel_ms": total,
            "busy_share": total / wall, "gemm_ms": gemm,
            "softmax_ms": softmax, "reduce_ms": reduce,
            "other_ms": total - gemm - softmax - reduce,
            "n_kernels": sum(n for n, _ in per.values()),
            "top": [{"kernel": k[:90], "count": n, "ms": ms}
                    for k, (n, ms) in ranked]}


def _profile_spec(model, params, rng) -> dict:
    """One chunk of speculative rounds, its slots filled with
    ``PROMPT_LEN``-token prompts: the profile of one round."""
    cfg = model.cfg
    budget = MAX_LEN - PROMPT_LEN
    damped = damp_upper_layers(params, n_keep=2, damp=0.001)
    dmodel, dparams = truncate_draft(model, damped, 2)
    spec = ContinuousBatchingEngine(
        model, damped, max_len=MAX_LEN, n_slots=SLOTS,
        chunk_steps=CHUNK_STEPS, draft_model=dmodel, draft_params=dparams,
        spec_k=SPEC_K)
    for b in range(SLOTS):
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                              PROMPT_LEN),
                                 device=spec.device)[None]
        spec._prefill_slot(damped, spec.state, prompt, b,
                           budget - SPEC_K)
        spec._prefill_draft(dparams, spec.state, prompt, b)

    def spec_chunk():
        spec._spec_chunk(damped, dparams, spec.state)

    spec_chunk()                                      # warm-up
    rounds = _profiled(spec_chunk, _wall_ms(spec_chunk, 2))
    rounds.update(wall_ms_per_round=rounds["wall_ms"] / CHUNK_STEPS,
                  kernel_ms_per_round=rounds["kernel_ms"] / CHUNK_STEPS,
                  depth=int(spec.state["cache"]["pos"].max()))
    return rounds


def _profile_prefix_hit(model, params, rng) -> dict:
    """One prefix-hit admission: a miss first interns a
    ``PROMPT_LEN``-token prefix's pages, then a prompt of that prefix
    and a ``SUFFIX_LEN``-token tail is admitted into slot 0 through
    ``_extend_slot`` (its suffix through paged verify), profiled."""
    cfg = model.cfg
    eng = ContinuousBatchingEngine(
        model, params, max_len=MAX_LEN, n_slots=SLOTS,
        chunk_steps=CHUNK_STEPS, kv_page_size=PAGE_SIZE,
        prefix_caching=True, device=model.device)
    prefix = rng.integers(0, cfg.vocab_size, PROMPT_LEN)
    eng.serve([Request(rid=0, prompt=np.concatenate(
        [prefix, rng.integers(0, cfg.vocab_size, 8)]), max_new_tokens=1)],
        honor_arrivals=False)
    toks = tuple(int(x) for x in np.concatenate(
        [prefix, rng.integers(0, cfg.vocab_size, SUFFIX_LEN)]))
    budget = MAX_LEN - len(toks)
    row, start = eng._acquire_pages(toks, len(toks), budget)
    if start != PROMPT_LEN:
        raise RuntimeError(f"prefix hit covered {start} of {PROMPT_LEN} "
                           f"tokens")
    suffix = torch.as_tensor(toks[start:], device=eng.device)[None]

    def admit():
        eng._extend_slot(params, eng.state, suffix, 0, row, start, budget)

    admit()                                           # warm-up
    hit = _profiled(admit, _wall_ms(admit, 3))
    hit.update(cached_tokens=start, suffix_tokens=int(suffix.shape[1]))
    return hit


@torch.no_grad()
def _profile_encdec(model, params) -> dict:
    """Encoder, prefill and one decode step of ``SLOTS`` whisper windows
    (frames and prompt tokens from numpy seed ``SEED``)."""
    cfg = model.cfg
    rng = np.random.default_rng(SEED)
    frames = torch.as_tensor(rng.standard_normal(
        (SLOTS, cfg.encdec.enc_len, cfg.d_model), dtype=np.float32),
        device="cuda")
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (SLOTS, ENC_PROMPT)), device="cuda")
    inputs = {"frames": frames, "tokens": tokens}

    def encode():
        model.encode(params, frames)

    def prefill():
        return model.prefill(params, inputs, max_len=ENC_MAX_LEN)

    logits, cache = prefill()
    tok = torch.argmax(logits[:, -1], -1)[:, None]

    def step():                 # ServeEngine.run_batch's loop body
        lg, _ = model.decode_step(params, cache, tok)
        torch.argmax(lg[:, -1], -1).tolist()

    encode()
    step()                                            # warm-up
    return {"encoder": _profiled(encode, _wall_ms(encode, 3)),
            "prefill": _profiled(prefill, _wall_ms(prefill, 3)),
            "decode": _profiled(step, _wall_ms(step, 10))}


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main_encdec(cfg) -> dict:
    model = build_model(cfg, "cuda")
    parts = _profile_encdec(model, model.init(SEED))
    smi = _smi()
    print(f"{smi}: {cfg.name}, {SLOTS} windows of {cfg.encdec.enc_len} "
          f"frames, {ENC_PROMPT}-token prompts")
    for name, part in parts.items():
        print(f"  {name}: {part['wall_ms']:.3f} ms host wall, "
              f"{part['kernel_ms']:.3f} ms of kernels, busy "
              f"{part['busy_share']:.1%}, {part['n_kernels']} kernels")
    for name, part in parts.items():
        for t in part["top"]:
            print(f"  {name} {t['ms']:9.3f} ms x{t['count']:<5} "
                  f"{t['kernel']}")
    out = {"device": smi, "arch": cfg.name, "windows": SLOTS,
           "prompt_len": ENC_PROMPT, **parts}
    print(json.dumps(out))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=ARCH, choices=list_archs())
    args = ap.parse_args(argv)
    full = get_config(args.arch)
    if full.encdec is not None:
        return main_encdec(full)
    card = torch.cuda.get_device_properties(0).total_memory
    cfg, nbytes = fit_depth(full, card)
    depth = {"layers": cfg.n_layers, "of": full.n_layers,
             "weights_gb": nbytes / 1e9, "card_gb": card / 1e9}
    model = build_model(cfg, "cuda")
    params = model.init(SEED)
    eng = ContinuousBatchingEngine(model, params, max_len=MAX_LEN,
                                   n_slots=SLOTS, chunk_steps=CHUNK_STEPS)
    rng = np.random.default_rng(SEED)
    budget = MAX_LEN - PROMPT_LEN

    def admit(slot):
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                              PROMPT_LEN),
                                 device=eng.device)[None]
        eng._prefill_slot(params, eng.state, prompt, slot, budget)

    for b in range(SLOTS):
        admit(b)

    def chunk():
        eng._decode_chunk(params, eng.state)

    chunk()                                           # warm-up
    decode = _profiled(chunk, _wall_ms(chunk, 4))
    steps = CHUNK_STEPS
    decode.update(wall_ms_per_step=decode["wall_ms"] / steps,
                  kernel_ms_per_step=decode["kernel_ms"] / steps)
    prefill = _profiled(lambda: admit(0), _wall_ms(lambda: admit(0), 2))
    split = prefill_split(lambda: admit(0))

    # a truncated draft needs a dense target; the prefix hit a GQA stack
    dense = cfg.family == "dense"
    rounds = _profile_spec(model, params, rng) if dense else None
    hit = (_profile_prefix_hit(model, params, rng)
           if cfg.family in ("dense", "moe") else None)

    smi = _smi()
    depth_rows = int(eng.state["cache"]["pos"].max())
    print(f"{smi}: {cfg.name}, {SLOTS} slots at depth ~{depth_rows}")
    if cfg.n_layers < full.n_layers:
        print(f"  depth cut: {cfg.n_layers} of {full.n_layers} layers at "
              f"full width ({nbytes / 1e9:.2f} GB of weights; all "
              f"{full.n_layers} pass {CARD_SHARE:.0%} of the card's "
              f"{card / 1e9:.2f} GB)")
    else:
        print(f"  depth: all {cfg.n_layers} layers at full width "
              f"({nbytes / 1e9:.2f} GB of weights, within {CARD_SHARE:.0%} "
              f"of the card's {card / 1e9:.2f} GB)")
    print(f"  decode: {decode['wall_ms_per_step']:.3f} ms/step host wall, "
          f"{decode['kernel_ms_per_step']:.3f} ms/step of kernels, busy "
          f"{decode['busy_share']:.1%}, {decode['n_kernels'] // steps} "
          f"kernels/step")
    print(f"  prefill ({PROMPT_LEN} tokens): "
          f"{prefill['wall_ms']:.3f} ms wall, {prefill['kernel_ms']:.3f} ms "
          f"of kernels, busy {prefill['busy_share']:.1%}")
    print(f"  prefill split, ms of kernels: GEMMs {split['gemm_ms']:.3f}, "
          f"attention {split['attention_ms']:.3f}, Mamba scan "
          f"{split['scan_ms']:.3f} ({split['scan_calls']} calls, by "
          f"events), the rest {split['other_ms']:.3f}, of "
          f"{split['kernel_ms']:.3f}")
    if rounds is not None:
        print(f"  speculative (k={SPEC_K}, depth ~{rounds['depth']}): "
              f"{rounds['wall_ms_per_round']:.3f} ms/round host wall, "
              f"{rounds['kernel_ms_per_round']:.3f} ms/round of kernels, "
              f"busy {rounds['busy_share']:.1%}, "
              f"{rounds['n_kernels'] // steps} kernels/round")
    if hit is not None:
        print(f"  prefix hit ({hit['suffix_tokens']} tokens behind "
              f"{hit['cached_tokens']} cached): {hit['wall_ms']:.3f} ms "
              f"wall, {hit['kernel_ms']:.3f} ms of kernels, busy "
              f"{hit['busy_share']:.1%}, {hit['n_kernels']} kernels")
    for name, part in (("decode", decode), ("prefill", prefill),
                       ("speculative", rounds), ("prefix hit", hit)):
        for t in (part or {}).get("top", []):
            print(f"  {name} {t['ms']:9.3f} ms x{t['count']:<5} "
                  f"{t['kernel']}")
    out = {"device": smi, "arch": cfg.name, "depth": depth,
           "slots": SLOTS, "prompt_len": PROMPT_LEN, "decode": decode,
           "prefill": prefill, "prefill_split": split,
           "speculative": rounds, "prefix_hit": hit}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
