"""Max sustainable QPS at a fixed TTFT/TPOT tail SLO, per joule (the
port of ``benchmarks/slo_sweep.py``).

On a bimodal prompt mix (short interactive queries + long
context-stuffing queries), how many queries per second can each engine
configuration sustain while the *interactive* class keeps meeting its
time-to-first-token SLO, and what does that capacity cost in joules?
Four configurations share one geometry and one tight page pool:

- **monolithic** -- paged KV, whole-prompt prefill at admission: a
  short arriving behind a long prompt waits out the whole prefill;
- **chunked** -- ``prefill_chunk_tokens`` splits every prefill into
  chunks interleaved with decode chunks, so shorts slip in between a
  long's chunks and decoding slots never stall;
- **chunked_preempt** -- chunked + ``Scheduler(preemption=True)``:
  deadline-slack admission order, and under page-pool pressure a
  low-priority long is parked (pages evicted, state host-side) so the
  short admits at once; the long resumes through the prefix-cache
  extend path;
- **disaggregated** -- prefill and decode as separate fleets
  (``PrefillWorker`` x ``N_PREFILL_WORKERS`` -> paged KV handoff ->
  the monolithic engine's geometry decoding), each behind its own rail
  stack under ``DisaggregatedSUT``, so the prefill-vs-decode energy
  split is read per fleet (``prefill_j``, ``decode_j``,
  ``prefill_energy_frac`` at the ``MID`` point).  Its rails are
  modeled on every device (one card's counter cannot be split between
  fleets that overlap): on the CPU as the reference's edge system, on
  the card as the H100 datacenter system.

Every timing knob is calibrated to the measured warm monolithic
long-prompt serve ``t_long`` of this engine on this device (the SLO is
``SLO_FRAC x t_long``, the offered-QPS grid ``GRID_x / t_long``), so the
collision geometry -- which shorts land behind which longs -- does not
depend on the machine's speed.  Arrivals are Poisson at a fixed seed.

Reported per configuration, as in the reference: ``tokens_per_s`` /
``tok_per_j`` at the mid grid point, ``qps_at_slo``
(``max_sustainable_qps`` over the grid at ``ATTAIN_BAR`` short-class
attainment), ``qps_at_slo_per_j``, the per-point attainments, the
preemptions and resumes (preemptive config), the interleave ratio
(chunked configs), ``prefill_j`` / ``decode_j`` /
``prefill_energy_frac`` (disaggregated) and ``speedup`` =
chunked_preempt's sustainable QPS over monolithic's.  The port adds
``review_passed`` (every point's review ACCEPTED).

- On the CPU (``device="cpu"``): the reduced qwen3-1.7b, every rail
  the reference's model.
- On the card (the default): the full-width qwen3-1.7b, and each
  colocated SUT's accelerator rail is the card's NVML energy counter
  (the H100 system's host rail modeled, the wall derived through its
  PSU); each of those configurations also reports the mid point's
  measured accelerator Joules and tokens/J there.  The disaggregated
  row reports instead ``counter_j``, the counter's delta over its mid
  point's serve, beside its modeled split.

  PYTHONPATH=src python -m repro_torch.benchmarks.slo_sweep \\
      [--device cpu] [--smoke]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

LONG_LEN = 768                  # context-stuffing prompt (12 pages)
SHORT_LEN = 16                  # interactive prompt (1 page w/ budget)
MAX_LEN = 832                   # 13 pages per slot
PAGE_SIZE = 64
SLOTS = 8                       # slots are not the binding constraint
KV_PAGES = 27                   # two resident longs fill the pool: the
                                # third concurrent context must wait
                                # (monolithic/chunked) or preempt
CHUNK_STEPS = 2                 # decode tokens per fused chunk
PREFILL_CHUNK = 64              # chunked-prefill tokens per iteration
NEW_TOKENS = 8                  # decode budget (both classes)
LONG_PERIOD = 8                 # arrival pattern period ...
LONG_SLOTS = (0, 5)             # ... longs at these offsets (25 %)
SLO_FRAC = 0.35                 # ttft_slo = SLO_FRAC * t_long
TPOT_FRAC = 0.5                 # tpot_slo = TPOT_FRAC * t_long (loose:
                                # the sweep discriminates on TTFT)
ATTAIN_BAR = 0.9                # short-class TTFT attainment bar
GRID_X = (0.4, 1.0, 2.0)        # offered qps = x / t_long (smoke)
GRID_X_FULL = (0.4, 0.8, 1.2, 1.6, 2.0, 2.4)
MID = 1                         # grid index for the fixed-load
                                # tokens_per_s / tok_per_j comparison
N_PREFILL_WORKERS = 2
SEED = 0                        # Poisson arrival schedule seed


def _is_long(i: int) -> bool:
    return i % LONG_PERIOD in LONG_SLOTS


def _prompt(cfg, i: int) -> np.ndarray:
    """Deterministic per-arrival-index prompts, unique content per
    request so the prefix cache in the preemptive config never
    cross-hits between requests (only park/resume reuses pages)."""
    n = LONG_LEN if _is_long(i) else SHORT_LEN
    rng = np.random.default_rng(20_000 + i)
    return rng.integers(0, cfg.vocab_size, n).astype(np.int64)


def _make_request(cfg, rid: int, i: int, arrival_s: float,
                  ttft_slo_s: float):
    """Shorts are the interactive class: priority 1 with a deadline at
    arrival + SLO (drives the scheduler's slack ordering); longs are
    best-effort priority 0 -- the preemption victims."""
    from repro_torch.serving import Request

    short = not _is_long(i)
    return Request(
        rid=rid, prompt=_prompt(cfg, i), max_new_tokens=NEW_TOKENS,
        arrival_s=float(arrival_s),
        priority=1 if short else 0,
        deadline_s=float(arrival_s) + ttft_slo_s if short else None)


def _warm(engine, cfg, *, prefix: bool) -> None:
    """Run every path of the measurement once outside it: long + short
    prefill (whole or chunked), a decode chunk, and for the
    prefix-caching config the full-prefix-hit extend and the park/resume
    tails (a parked long resumes with ``prompt' = prompt + output``:
    768 cached tokens and an extend tail of 1/3/5/7 tokens)."""
    from repro_torch.serving import Request

    def req(j, n):
        rng = np.random.default_rng(5_000 + j)
        return Request(rid=10 ** 6 + j,
                       prompt=rng.integers(0, cfg.vocab_size, n),
                       max_new_tokens=NEW_TOKENS)

    engine.serve([req(0, LONG_LEN), req(1, SHORT_LEN)],
                 honor_arrivals=False)
    engine.serve([req(2, SHORT_LEN), req(3, LONG_LEN)],
                 honor_arrivals=False)
    if prefix:
        long_p = np.asarray(req(0, LONG_LEN).prompt)
        extra = np.random.default_rng(5_999).integers(
            0, cfg.vocab_size, NEW_TOKENS)
        engine.serve([req(0, LONG_LEN)], honor_arrivals=False)
        engine.serve(
            [Request(rid=10 ** 6 + 10 + k,
                     prompt=np.concatenate([long_p, extra[:k]]),
                     max_new_tokens=NEW_TOKENS)
             for k in range(1, NEW_TOKENS, 2)],
            honor_arrivals=False)


def _measure_t_long(engine, cfg) -> float:
    """Warm monolithic long-prompt serve (seconds, best of 3; the serve
    ends on the host read of the first token): the calibration unit
    every SLO and grid rate is expressed in."""
    from repro_torch.serving import Request

    ts = []
    for j in range(3):
        rng = np.random.default_rng(6_000 + j)
        r = Request(rid=10 ** 6 + 100 + j,
                    prompt=rng.integers(0, cfg.vocab_size, LONG_LEN),
                    max_new_tokens=1)
        t0 = time.perf_counter()
        engine.serve([r], honor_arrivals=False)
        ts.append(time.perf_counter() - t0)
    return float(min(ts))


def _short_attainment(completed, ttft_slo_s: float) -> float:
    """Fraction of *short-class* requests whose TTFT met the SLO."""
    ttfts = [r.first_token_s - r.arrival_s for r in completed
             if len(r.prompt) < LONG_LEN]
    if not ttfts:
        return float("nan")
    return float(np.mean([t <= ttft_slo_s for t in ttfts]))


def _run_grid(sut, grid_qps, ttft_slo_s, tpot_slo_s, n_queries):
    """One PowerRun per offered rate, ascending; returns
    ``[(qps, short_attainment, SubmissionResult, sched_stats)]``."""
    from repro_torch.harness import PowerRun, Server

    points = []
    for qps in grid_qps:
        scenario = Server(target_qps=qps, latency_slo_s=30.0,
                          min_duration_s=0.0, min_queries=n_queries,
                          mode="queue", seed=SEED,
                          ttft_slo_s=ttft_slo_s, tpot_slo_s=tpot_slo_s)
        res = PowerRun(sut, scenario, seed=0, sample_hz=1000.0).run()
        attain = _short_attainment(sut.completed, ttft_slo_s)
        # a disaggregated SUT's engine keeps its decode engine's stats
        eng = getattr(sut.engine, "engine", sut.engine)
        points.append((qps, attain, res, dict(eng.sched_stats)))
    return points


def _point_metrics(points, grid_x, floor_qps, measured: bool):
    """Grid -> the configuration's figures: fixed-load throughput and
    efficiency at the MID point, sustainable QPS, capacity per watt at
    the highest sustaining point, and whether every review passed."""
    from repro_torch.core.efficiency import (max_sustainable_qps,
                                             qps_at_slo_per_joule)

    msq = max_sustainable_qps([(q, a) for q, a, _, _ in points],
                              min_attainment=ATTAIN_BAR)
    # nothing sustained: floor at half the lowest grid rate so the
    # speedup ratio stays finite (reads as "below the grid")
    msq_eff = msq if msq > 0 else floor_qps
    at = next((p for p in reversed(points) if p[0] <= msq_eff), points[0])
    mid = points[min(MID, len(points) - 1)]
    m = mid[2].outcome.server
    out = {
        "tokens_per_s": m.tokens_per_s,
        "tok_per_j": m.total_tokens / max(mid[2].summary.energy_j,
                                          1e-12),
        "qps_at_slo": msq,
        "qps_at_slo_per_j": qps_at_slo_per_joule(
            msq_eff, at[2].summary.avg_watts),
        "review_passed": all(p[2].passed for p in points),
    }
    if measured:
        acc_j = mid[2].per_domain_energy_j["accelerator"]
        out["accelerator_j"] = acc_j
        out["tok_per_j_accelerator"] = m.total_tokens / max(acc_j, 1e-12)
    for (_, a, _, _), x in zip(points, grid_x):
        out[f"attain_x{int(round(x * 10))}"] = a
    return out, msq_eff


def _disaggregated(engine, cfg, dev, measured: bool, nvml, grid,
                   ttft_slo, tpot_slo, n):
    """The ``disaggregated`` row: ``N_PREFILL_WORKERS`` workers on the
    decode engine's model and weights, warmed, then the grid under
    ``DisaggregatedSUT`` on modeled rails (the H100 system on the card,
    the reference's default on the CPU).  Returns the grid's points
    and, on the card, the counter's delta over each point's serve."""
    from repro_torch.core.loadgen import qid_of
    from repro_torch.harness import DisaggregatedSUT
    from repro_torch.hw import DATACENTER_H100, EDGE_SYSTEM
    from repro_torch.serving import DisaggregatedEngine, PrefillWorker

    workers = [PrefillWorker(engine.model, engine.params,
                             page_size=PAGE_SIZE, device=dev)
               for _ in range(N_PREFILL_WORKERS)]
    deng = DisaggregatedEngine(workers, engine)
    _warm(deng, cfg, prefix=False)

    def make_request(i, s, a, _slo=ttft_slo):
        return _make_request(cfg, qid_of(s, i), i, a, _slo)

    sut = DisaggregatedSUT(
        deng, cfg, name="slo-disaggregated", make_request=make_request,
        system=DATACENTER_H100 if measured else EDGE_SYSTEM)
    counter_j: list = []
    if measured:
        serve_queue = sut.serve_queue

        def metered(arrivals):
            e0 = nvml.energy_mj()
            try:
                return serve_queue(arrivals)
            finally:
                counter_j.append((nvml.energy_mj() - e0) / 1e3)

        sut.serve_queue = metered
    return _run_grid(sut, grid, ttft_slo, tpot_slo, n), counter_j


def metrics(device="cuda", smoke: bool = False) -> dict:
    """The QPS-at-SLO sweep keyed as the reference's; ``calibration``
    also names the device."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.loadgen import qid_of
    from repro_torch.harness import ContinuousBatchingSUT
    from repro_torch.models import build_model
    from repro_torch.power.nvml import NVML
    from repro_torch.serving import ContinuousBatchingEngine, Scheduler

    dev = resolve_device(device)
    measured = dev.type == "cuda"
    cfg = get_config("qwen3-1.7b")
    if not measured:
        cfg = reduce_config(cfg)
    model = build_model(cfg, dev)
    params = model.init(0)
    n = 24 if smoke else 48
    grid_x = GRID_X if smoke else GRID_X_FULL

    def engine(**kw):
        return ContinuousBatchingEngine(
            model, params, max_len=MAX_LEN, n_slots=SLOTS,
            chunk_steps=CHUNK_STEPS, kv_page_size=PAGE_SIZE,
            kv_pages=KV_PAGES, device=dev, **kw)

    # calibration: a dedicated monolithic engine measures t_long warm
    cal = engine()
    _warm(cal, cfg, prefix=False)
    t_long = _measure_t_long(cal, cfg)
    del cal
    ttft_slo = SLO_FRAC * t_long
    tpot_slo = TPOT_FRAC * t_long
    grid_qps = [x / t_long for x in grid_x]
    floor_qps = grid_qps[0] / 2.0

    configs = {
        "monolithic": (dict(), False, False),
        "chunked": (dict(prefill_chunk_tokens=PREFILL_CHUNK), True, False),
        "chunked_preempt": (dict(prefill_chunk_tokens=PREFILL_CHUNK,
                                 prefix_caching=True,
                                 scheduler=Scheduler(preemption=True)),
                            True, True),
    }
    out: dict = {"calibration": {
        "t_long_ms": t_long * 1e3, "ttft_slo_ms": ttft_slo * 1e3,
        "grid_qps": [round(q, 3) for q in grid_qps],
        "device": (torch.cuda.get_device_name(dev) if measured
                   else "cpu")}}
    msq_by_name: dict = {}
    nvml = NVML(dev) if measured else None
    try:
        for name, (kw, chunked, prefix) in configs.items():
            eng = engine(**kw)
            _warm(eng, cfg, prefix=prefix)

            def make_request(i, s, a, _slo=ttft_slo):
                return _make_request(cfg, qid_of(s, i), i, a, _slo)

            sut = ContinuousBatchingSUT(
                eng, cfg, name=f"slo-{name}", make_request=make_request,
                energy_meter=nvml.energy_meter() if measured else None)
            pts = _run_grid(sut, grid_qps, ttft_slo, tpot_slo, n)
            row, msq_by_name[name] = _point_metrics(pts, grid_x, floor_qps,
                                                    measured)
            if prefix:
                row["preemptions"] = sum(s["preemptions"]
                                         for _, _, _, s in pts)
                row["resumes"] = sum(s["resumes"] for _, _, _, s in pts)
            if chunked:
                dc = sum(s["decode_chunks"] for _, _, _, s in pts)
                il = sum(s["interleaved_chunks"] for _, _, _, s in pts)
                row["interleave_ratio"] = il / max(1, dc)
            out[name] = row
            del sut, eng
        # disaggregated: prefill fleet -> paged handoff -> decode fleet,
        # one rail stack per fleet (modeled split)
        pts, counter_j = _disaggregated(engine(), cfg, dev, measured, nvml,
                                        grid_qps, ttft_slo, tpot_slo, n)
        row, msq_by_name["disaggregated"] = _point_metrics(
            pts, grid_x, floor_qps, measured=False)
        dom = pts[min(MID, len(pts) - 1)][2].per_domain_energy_j
        row["prefill_j"] = dom.get("prefill/wall", 0.0)
        row["decode_j"] = dom.get("decode/wall", 0.0)
        total = row["prefill_j"] + row["decode_j"]
        row["prefill_energy_frac"] = row["prefill_j"] / max(total, 1e-12)
        if measured:
            row["counter_j"] = counter_j[min(MID, len(counter_j) - 1)]
        out["disaggregated"] = row
    finally:
        if nvml is not None:
            nvml.close()
    # preemptive chunked serving against monolithic admission
    out["chunked_preempt"]["speedup"] = (
        msq_by_name["chunked_preempt"] / msq_by_name["monolithic"])
    return out


def csv(device="cuda", smoke: bool = False) -> list[str]:
    points = metrics(device, smoke=smoke)
    rows = []
    cal = points.pop("calibration")
    rows.append(f"slo_calibration,{cal['t_long_ms']:.1f},"
                f"slo={cal['ttft_slo_ms']:.1f}ms;"
                f"grid={'/'.join(str(q) for q in cal['grid_qps'])}qps")
    for name, p in points.items():
        derived = (f"{p['tokens_per_s']:.1f}toks/s;"
                   f"{p['tok_per_j']:.3f}tok/J;"
                   f"msq={p['qps_at_slo']:.2f}qps;"
                   f"{p['qps_at_slo_per_j']:.4f}qps_at_slo/J")
        if "speedup" in p:
            derived += f";speedup={p['speedup']:.2f}x"
        if "preemptions" in p:
            derived += (f";preempt={p['preemptions']}"
                        f";resume={p['resumes']}")
        if "prefill_j" in p:
            derived += (f";prefill={p['prefill_j']:.2f}J"
                        f";decode={p['decode_j']:.2f}J"
                        f";prefill_frac={p['prefill_energy_frac']:.2f}")
        attains = ";".join(
            f"{k[7:]}={v:.2f}" for k, v in sorted(p.items())
            if k.startswith("attain_"))
        rows.append(f"slo_{name},{p['qps_at_slo']:.2f},"
                    f"{derived};{attains}")
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
