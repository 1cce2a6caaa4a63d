"""Does ``torch.profiler`` record every kernel of a short window on the
card, and, where it loses some, which ones?

  python -m repro_torch.launch.profiler_check [--idle-first 90]
      [--span 300] [--every 60] [--pad 20]

A window launches ``CALLS`` small kernels, the first half adds and the
second half multiplies (so the records kept say which end a loss came
from), then synchronizes.  For each window it prints the records of
each half and, where all were recorded, the skew of the device's clock
against the host's as the profiler reports them: the first kernel's
start minus its launch's start, and the last kernel's end minus the
host's return from the synchronize (a kernel cannot start before its
launch nor end after the synchronize that waits for it).

Six kinds of window (``KINDS``): bare; padded, with ``--pad`` ms of
host sleep inside the window before the first launch and after the
synchronize; prefixed, with ``PREFIX`` untimed fills launched first;
blocked, behind a ``BLOCK_CYCLES`` spin kernel, so that every timed
kernel starts milliseconds after its launch; scheduled, a profiler
schedule whose warm-up step runs the same calls untraced before the
traced step; and cuda_only, the device's activity alone (no host
events, so no skew).  The first round of three windows of each kind
comes ``--idle-first`` seconds after start-up (no profiler session
before it), then one every ``--every`` seconds for ``--span`` seconds.
Prints one JSON object as its last line.  Needs a CUDA device; the
figures are printed beside its name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

CALLS = 10
PREFIX = 40
BLOCK_CYCLES = 20_000_000         # about 10 ms at the H100's 1.98 GHz
KINDS = ("bare", "padded", "prefixed", "blocked", "scheduled", "cuda_only")


def window(torch, x, kind: str, pad_s: float) -> dict:
    """One profiled window of ``CALLS`` kernels of the given ``KINDS``
    kind; see the module doc."""
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    def calls():
        for i in range(CALLS):
            x.add_(1.0) if i < CALLS // 2 else x.mul_(1.0)
        with record_function("synchronized"):
            torch.cuda.synchronize()

    y = torch.empty_like(x)
    acts = [ProfilerActivity.CUDA]
    if kind != "cuda_only":
        acts.append(ProfilerActivity.CPU)
    prefix = PREFIX if kind == "prefixed" else 0
    if kind == "scheduled":
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            calls()                         # warm-up step, discarded
            prof.step()
            calls()
            prof.step()
    else:
        with profile(activities=acts) as prof:
            if kind == "padded":
                time.sleep(pad_s)
            for _ in range(prefix):
                y.fill_(0.0)
            if kind == "blocked":
                torch.cuda._sleep(BLOCK_CYCLES)
            calls()
            if kind == "padded":
                time.sleep(pad_s)
    kernels, launches, sync_end = [], [], None
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if "Fill" not in e.name and "spin" not in e.name:
                kernels.append(e)
        elif e.name.startswith(("cudaLaunch", "cuLaunch")):
            launches.append(e)
        elif e.name == "synchronized":
            sync_end = e.time_range.end
    kernels.sort(key=lambda e: e.time_range.start)
    launches = sorted(launches, key=lambda e: e.time_range.start)[
        prefix + (kind == "blocked"):]
    out = {"add": sum("_add" in e.name for e in kernels),
           "mul": sum("Mul" in e.name for e in kernels),
           "launches": len(launches)}
    if kernels and len(kernels) == len(launches) and sync_end is not None:
        out["first_start_minus_launch_us"] = (kernels[0].time_range.start
                                              - launches[0].time_range.start)
        out["last_end_minus_sync_us"] = kernels[-1].time_range.end - sync_end
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--idle-first", type=float, default=0.0,
                    help="seconds before the first profiled window")
    ap.add_argument("--span", type=float, default=180.0,
                    help="seconds over which windows are taken")
    ap.add_argument("--every", type=float, default=30.0,
                    help="seconds between two rounds of windows")
    ap.add_argument("--pad", type=float, default=20.0,
                    help="ms of host sleep at each end of a padded window")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profiler_check needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    print(smi.strip())
    x = torch.zeros(1 << 20, device="cuda")
    x.add_(1.0)
    x.mul_(1.0)
    torch.cuda.synchronize()
    time.sleep(args.idle_first)
    t0 = time.perf_counter()
    rounds = []
    while True:
        t = time.perf_counter() - t0
        row = {"t_s": args.idle_first + t}
        for kind in KINDS:
            row[kind] = [window(torch, x, kind, args.pad / 1e3)
                         for _ in range(3)]
        rounds.append(row)
        for kind in KINDS:
            print(f"t = {row['t_s']:7.1f} s, {kind}: " + "; ".join(
                f"add {w['add']}/{CALLS // 2}, mul {w['mul']}/"
                f"{CALLS // 2} of {w['launches']} launches"
                + (f", first start - launch "
                   f"{w['first_start_minus_launch_us']:.1f} us, last end "
                   f"- sync {w['last_end_minus_sync_us']:.1f} us"
                   if "last_end_minus_sync_us" in w else "")
                for w in row[kind]))
        if t + args.every > args.span:
            break
        time.sleep(max(0.0, t0 + t + args.every - time.perf_counter()))
    print(smi.strip())
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "pad_ms": args.pad, "prefix": PREFIX,
                      "rounds": rounds}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
