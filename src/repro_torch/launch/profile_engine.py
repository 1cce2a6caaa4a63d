"""Where the engine's time goes on the card: decode and prefill profiled.

  python -m repro_torch.launch.profile_engine

Fills every slot of full-width qwen3-1.7b's ``ContinuousBatchingEngine``
(the engine shape ``chip_smoke.py`` serves at) with a prompt of
``PROMPT_LEN`` tokens (seeded random weights and tokens), then, after
one warm-up chunk, measures:

- decode: host wall time per step over 4 chunks of 8 steps (ending in a
  synchronize), then one chunk under ``torch.profiler`` for its kernels'
  device time; busy share = kernel time / the wall time measured with
  the profiler off; and the kernels that take the most device time;
- prefill: the same for an admission of ``PROMPT_LEN`` tokens.

Prints one JSON object as its last line.  Needs a CUDA device; the
numbers are the card's and are printed beside its name and power limit.
"""
from __future__ import annotations

import collections
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving import ContinuousBatchingEngine

ARCH = "qwen3-1.7b"     # the engine shape chip_smoke.py serves at
MAX_LEN = 2048
SLOTS = 8
CHUNK_STEPS = 8
PROMPT_LEN = 1024
SEED = 0


def _wall_ms(fn, reps: int) -> float:
    """Host wall time of ``fn()`` in ms, averaged, ending in a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _profiled(fn, wall_ms: float, top: int = 8) -> dict:
    """Run ``fn`` once under the profiler: its kernels' device time, the
    busy share against ``wall_ms`` (measured with the profiler off, which
    itself slows the host) and the top kernels by device time."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per[e.name][0] += 1
            per[e.name][1] += e.time_range.elapsed_us() / 1e3
    kernel_ms = sum(ms for _, ms in per.values())
    ranked = sorted(per.items(), key=lambda kv: -kv[1][1])[:top]
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms,
            "busy_share": kernel_ms / wall_ms,
            "n_kernels": sum(n for n, _ in per.values()),
            "top": [{"kernel": k[:90], "count": n, "ms": ms}
                    for k, (n, ms) in ranked]}


def main():
    cfg = get_config(ARCH)
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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    depth = int(eng.state["cache"]["pos"].max())
    print(f"{smi}: {cfg.name}, {SLOTS} slots at depth ~{depth}")
    print(f"  decode: {decode['wall_ms_per_step']:.3f} ms/step host wall, "
          f"{decode['kernel_ms_per_step']:.3f} ms/step of kernels, busy "
          f"{decode['busy_share']:.1%}, {decode['n_kernels'] // steps} "
          f"kernels/step")
    print(f"  prefill ({PROMPT_LEN} tokens): "
          f"{prefill['wall_ms']:.3f} ms wall, {prefill['kernel_ms']:.3f} ms "
          f"of kernels, busy {prefill['busy_share']:.1%}")
    for name, part in (("decode", decode), ("prefill", prefill)):
        for t in part["top"]:
            print(f"  {name} {t['ms']:9.3f} ms x{t['count']:<5} "
                  f"{t['kernel']}")
    out = {"device": smi, "arch": cfg.name, "slots": SLOTS,
           "prompt_len": PROMPT_LEN, "decode": decode,
           "prefill": prefill}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
