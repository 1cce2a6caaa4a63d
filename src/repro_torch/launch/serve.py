"""Serving launcher of the port: ``--arch <id>``, a loadgen scenario,
Director-measured Samples/Joule through the ``repro_torch.harness``
API.

  python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --scenario server --engine continuous --qps 8 --min-duration 5

Two engines, four scenarios, one call path (the reference launcher's):
the engine is wrapped in a SUT adapter, the scenario is a config
dataclass, and ``PowerRun(sut, scenario).run()`` does loadgen +
Director protocol + summarizer + compliance review in one shot.

- ``--engine continuous`` (the default): the slot-based
  ``ContinuousBatchingEngine`` behind ``ContinuousBatchingSUT`` under
  ``--scenario server`` (the default): the seeded Poisson arrival
  schedule feeds the engine's admission queue, and every request is
  attributed its share of the Joules.
- ``--engine fixed``: the fixed-batch ``ServeEngine`` behind
  ``ServeEngineSUT`` under any ``--scenario``: ``offline``
  (``--batch``-sized batches), ``single-stream``, ``multi-stream``
  (``--streams`` samples a burst) or the synchronous ``server``
  (on ``cpu`` only: its queueing waits are modeled, so the card's
  measured draw has no place on its clock).

On ``cuda`` (the default ``--device``) the SUT reads the card's NVML
energy counter: the accelerator rail is measured, the host rail is the
H100 system's model, the wall is derived through its PSU, and the run
is reviewed as a datacenter submission.  On ``cpu`` every rail is the
reference's model.  The run prints the review, which channels were
measured and which modeled, the Joules of each, tokens/J at the
accelerator and at the wall, TTFT p50/p99, TPOT mean, tokens/s, the
engine's host syncs and the kernels' launch counts.

``--kv-page-size N`` gives the continuous engine a paged KV cache of
N-row pages, and ``--prefix-cache`` adds the radix prefix cache over
it.  ``--prefill-chunk C`` (needs ``--kv-page-size``) absorbs each
prompt C tokens at a time, interleaved with decode chunks, and
``--preemption`` (needs ``--prefix-cache``) admits through the
deadline-slack ``Scheduler``, which may park a lower-priority running
request under page-pool pressure; the run then prints the scheduler's
preemptions, resumes and prefill chunks.  ``--speculative`` turns on
speculative decoding: a draft model proposes ``--k`` tokens per slot
and round and the target verifies them in one forward; ``--draft
truncate`` (the default) drafts with the target's first
``--draft-layers`` blocks, an arch name drafts with that model (fresh
weights, same vocabulary).  With the prefix cache the run
prints its hits, with ``--speculative`` the acceptance rate.  Weights
are random, made from ``--seed``; prompts are random tokens.

  python -m repro_torch.launch.serve --arch qwen3-1.7b --reduce \\
      --device cpu --speculative --k 4 --qps 20 --min-duration 0.5
  python -m repro_torch.launch.serve --arch qwen3-1.7b --reduce \\
      --device cpu --engine fixed --scenario offline --min-duration 1
  python -m repro_torch.launch.serve --arch qwen3-1.7b --reduce \\
      --device cpu --kv-page-size 8 --prefill-chunk 8 --qps 20 \\
      --min-duration 0.5

``--arch rwkv6-3b`` serves the RWKV-6 stack through the same engines;
its prefill runs the linear-scan kernel and its cache is a fixed-size
recurrent state, so ``--kv-page-size``, ``--prefix-cache`` and
``--speculative`` are refused for it (as the reference refuses them).

  python -m repro_torch.launch.serve --arch rwkv6-3b --reduce \\
      --device cpu --qps 20 --min-duration 0.5

Scale axis (the paper's µW -> MW sweep): ``--tp K`` shards the
continuous engine K ways, one process per shard
(``repro_torch.parallel.run_tp``: gloo with ``--device cpu``, NCCL on
the card, where K must not exceed the visible cards): every rank holds
a ``ShardedContinuousBatchingEngine``, rank 0 runs the ``PowerRun``
through ``ShardedSUT`` (one accelerator channel per shard summed under
one wall) and prints, the other ranks follow its serves.
``--replicas N`` runs N independent engines behind one admission
queue (``ReplicatedSUT``; the fleet boundary is a PDU domain summing
the replicas' walls).  Either way the energy is modeled (the H100
system's rails on the card): one card's NVML counter cannot stand for
K cards, nor be split between replicas.  Both at once are refused:
replicas of a sharded engine would issue their collectives from
threads, in an order the ranks do not share (ROADMAP §A.8).

  python -m repro_torch.launch.serve --arch qwen3-1.7b --reduce \\
      --device cpu --tp 4 --qps 16 --min-duration 2
  python -m repro_torch.launch.serve --arch qwen3-1.7b --reduce \\
      --device cpu --replicas 2 --qps 16 --min-duration 2
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs, reduce_config
from repro_torch.core.loadgen import qid_of
from repro_torch.core.power_model import SystemPowerModel
from repro_torch.harness import (ContinuousBatchingSUT, MultiStream, Offline,
                                 PowerRun, ReplicatedSUT, ServeEngineSUT,
                                 Server, ShardedSUT, SingleStream,
                                 modeled_sysdesc)
from repro_torch.hw import DATACENTER_H100
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.kernels.paged_decode_attention.ops import (
    paged_decode_attention)
from repro_torch.kernels.paged_verify_attention.ops import (
    paged_verify_attention)
from repro_torch.kernels.verify_attention.ops import verify_attention
from repro_torch.models import build_model
from repro_torch.parallel import run_tp
from repro_torch.power import ACCELERATOR
from repro_torch.power.nvml import NVML
from repro_torch.serving import (ContinuousBatchingEngine, Request,
                                 Scheduler, ServeEngine,
                                 ShardedContinuousBatchingEngine,
                                 truncate_draft)

KERNELS = (decode_attention, flash_attention, paged_decode_attention,
           paged_verify_attention, verify_attention, linear_scan)


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


def _request(args, vocab: int, rid: int, arrival_s: float = 0.0) -> Request:
    """Request ``rid``: ``--prompt-len`` random tokens drawn from
    (``--seed``, ``rid``), ``--new-tokens`` to generate."""
    rng = np.random.default_rng((args.seed, rid))
    return Request(rid=rid, prompt=rng.integers(0, vocab, args.prompt_len),
                   max_new_tokens=args.new_tokens, arrival_s=float(arrival_s))


def _scenario_for(args):
    if args.scenario == "offline":
        return Offline(batch=args.batch, min_duration_s=args.min_duration)
    if args.scenario == "server":
        return Server(target_qps=args.qps, latency_slo_s=10.0,
                      mode="queue" if args.engine == "continuous"
                      else "sync", min_duration_s=args.min_duration,
                      seed=args.seed)
    if args.scenario == "multi-stream":
        return MultiStream(n_streams=args.streams,
                           min_duration_s=args.min_duration)
    return SingleStream(min_duration_s=args.min_duration)


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


def _continuous_engines(args, cfg, model, params, rank: int = 0):
    """``--replicas`` warmed-up continuous engines (one rank's shard of
    one with ``--tp``) and the draft's config (``None`` without
    ``--speculative``)."""
    spec_kw, draft_cfg = {}, None
    if args.speculative:
        dmodel, dparams = build_draft(args, cfg, model, params)
        spec_kw = dict(draft_model=dmodel, draft_params=dparams,
                       spec_k=args.k)
        draft_cfg = dmodel.cfg
    kw = dict(max_len=args.max_len, n_slots=args.slots,
              chunk_steps=args.chunk_steps, device=model.device,
              kv_page_size=args.kv_page_size,
              prefix_caching=args.prefix_cache,
              prefill_chunk_tokens=args.prefill_chunk,
              scheduler=(Scheduler(preemption=True) if args.preemption
                         else None), **spec_kw)
    engines = []
    for _ in range(args.replicas):
        engine = (ShardedContinuousBatchingEngine(
            model, params, tp=args.tp, rank=rank, **kw) if args.tp > 1
            else ContinuousBatchingEngine(model, params, **kw))
        # warm-up outside the measurement: one request end to end (on
        # every rank of a sharded engine)
        engine.serve([_request(args, cfg.vocab_size, 10 ** 6)],
                     honor_arrivals=False)
        engines.append(engine)
    return engines, draft_cfg


def _continuous_sut(args, cfg, engines, draft_cfg, energy_meter):
    """The SUT over ``engines``: ``ContinuousBatchingSUT``,
    ``ShardedSUT`` with ``--tp`` or ``ReplicatedSUT`` over one SUT a
    replica with ``--replicas``; modeled rails on the H100 system on
    the card unless ``energy_meter`` measures the one card."""
    def make_request(i, s, a):
        # rid from the loadgen query id (unique even when samples wrap,
        # and across replicas, each of which sees a share of the queue)
        return _request(args, cfg.vocab_size, qid_of(s, i), a)

    name = f"{args.arch}-continuous" + (
        f"-k{args.k}" if args.speculative else "")
    system = sysdesc = None
    if energy_meter is None and engines[0].device.type == "cuda":
        # a modeled H100 server declares itself as one
        system = DATACENTER_H100
        sysdesc = modeled_sysdesc(SystemPowerModel(system, 1), "datacenter")
    if args.tp > 1:
        return ShardedSUT(engines[0], cfg, name=f"{name}-tp{args.tp}",
                          make_request=make_request, system=system,
                          draft=draft_cfg)
    suts = [ContinuousBatchingSUT(
        engine, cfg, name=name + (f"-r{i}" if args.replicas > 1 else ""),
        make_request=make_request, system=system, draft=draft_cfg,
        sysdesc=sysdesc, energy_meter=energy_meter)
        for i, engine in enumerate(engines)]
    if args.replicas > 1:
        return ReplicatedSUT(suts, name=f"{args.arch}-x{args.replicas}")
    return suts[0]


def _fixed_sut(args, cfg, model, params, energy_meter):
    batch_cap = max(args.batch, args.streams
                    if args.scenario == "multi-stream" else 1)
    engine = ServeEngine(model, params, max_len=args.max_len,
                         batch_size=batch_cap, device=args.device)

    def make_requests(samples):
        return [_request(args, cfg.vocab_size, s["idx"]) for s in samples]

    # warm-up outside the measurement: the batch shape the scenario issues
    warm_n = {"offline": args.batch,
              "multi-stream": args.streams}.get(args.scenario, 1)
    engine.run_batch(make_requests([{"idx": j} for j in range(warm_n)]))
    return ServeEngineSUT(engine, cfg, name=f"{args.arch}-fixed",
                          make_requests=make_requests,
                          energy_meter=energy_meter), engine


def _report(args, r, engines, measured: bool) -> dict:
    """Print the run and return its figures (``engines``: the replicas,
    or rank 0's shard)."""
    server = r.outcome.server
    if server is not None:
        tokens, n = server.total_tokens, r.outcome.result.n_queries
        m = {"ttft_p50_s": server.ttft_p(50), "ttft_p99_s": server.ttft_p(99),
             "tpot_mean_s": server.tpot_mean}
    else:
        n = r.outcome.samples_processed
        tokens = n * args.new_tokens
        m = {"ttft_p50_s": float("nan"), "ttft_p99_s": float("nan"),
             "tpot_mean_s": float("nan")}
    dur = r.outcome.result.duration_s
    dom = r.per_domain_energy_j
    # one channel, or one a shard (accelerator/i) or a replica
    # (r{i}/accelerator)
    acc_j = sum(v for k, v in dom.items() if ACCELERATOR in k.split("/"))
    m.update(requests=n, tokens=tokens, duration_s=dur,
             tokens_per_s=tokens / max(dur, 1e-9),
             review_passed=r.passed, energy_j=r.summary.energy_j,
             accelerator_j=acc_j, domain_energy_j=dict(dom),
             tok_per_j=tokens / max(r.summary.energy_j, 1e-12),
             tok_per_j_accelerator=tokens / max(acc_j, 1e-12),
             measured=[ACCELERATOR] if measured else [])
    print(r.render())
    engine = engines[0]
    device = (torch.cuda.get_device_name(engine.device)
              if engine.device.type == "cuda" else "cpu")
    scale = (f" across tp={args.tp} ranks" if args.tp > 1 else
             f" x {args.replicas} replicas" if args.replicas > 1 else "")
    print(f"{args.arch}{' (reduced)' if args.reduce else ''} {args.engine} "
          f"{args.scenario} on {device}{scale}: {n} requests, {tokens} "
          f"tokens in {dur:.3f} s, {m['tokens_per_s']:.1f} tokens/s")
    syncs = ([e.host_syncs for e in engines]
             if hasattr(engine, "host_syncs") else "n/a")
    print(f"  TTFT p50/p99: {m['ttft_p50_s'] * 1e3:.1f}/"
          f"{m['ttft_p99_s'] * 1e3:.1f} ms, TPOT mean: "
          f"{m['tpot_mean_s'] * 1e3:.2f} ms, host syncs: "
          f"{syncs[0] if len(syncs) == 1 else syncs}")
    if not measured and engine.device.type == "cuda":
        print(f"  energy modeled: the H100 system's rails "
              f"(repro_torch.hw.DATACENTER_H100) for "
              f"{max(args.tp, args.replicas)} cards (one card's NVML "
              f"counter cannot stand for several cards or be split "
              f"between replicas)")
    print("  energy by channel: " + "; ".join(
        f"{k} {v:.3f} J ("
        + ("measured, NVML" if k == ACCELERATOR and measured else
           "derived: PSU of the rails" if k.split("/")[-1] == "wall" else
           "derived: the replicas' walls" if k == "pdu" else "modeled")
        + ")" for k, v in sorted(dom.items())))
    print(f"  {m['tok_per_j_accelerator']:.3f} tok/J at the accelerator "
          f"({'measured' if measured else 'modeled'}), "
          f"{m['tok_per_j']:.3f} tok/J at the wall; review "
          f"{'ACCEPTED' if r.passed else 'REJECTED'}")
    print(f"  kernel launches{' (rank 0)' if args.tp > 1 else ''}: "
          + ", ".join(f"{k.__name__} {k.launches}" for k in KERNELS))
    if args.replicas > 1:
        per_rep = [dom.get(f"r{i}/wall", 0.0) for i in range(args.replicas)]
        print(f"  per-replica wall energy: "
              f"{'/'.join(f'{x:.3f}' for x in per_rep)} J (sum "
              f"{sum(per_rep):.3f} J vs fleet PDU {r.summary.energy_j:.3f} J)")
    return m


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--scenario", default="server",
                    choices=["offline", "server", "single-stream",
                             "multi-stream"])
    ap.add_argument("--engine", default="continuous",
                    choices=["fixed", "continuous"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--streams", type=int, default=4,
                    help="samples per MultiStream burst")
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
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="SLO-aware chunked prefill: tokens per "
                         "prefill chunk, interleaved with decode "
                         "(needs --kv-page-size; 0 = whole-prompt "
                         "prefill at admission)")
    ap.add_argument("--preemption", action="store_true",
                    help="priority scheduler with preemption: a "
                         "high-priority arrival under page-pool "
                         "pressure parks a best-effort request "
                         "(needs --prefix-cache)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: one process a shard "
                         "(gloo on the CPU, NCCL on as many cards)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="independent engine replicas behind one "
                         "admission queue (fleet power summed)")
    args = ap.parse_args(argv)
    spec_k = args.k if args.speculative else 0
    if args.prompt_len + args.new_tokens + spec_k > args.max_len:
        ap.error("--prompt-len + --new-tokens (+ --k with --speculative) "
                 "must fit --max-len")
    if args.engine == "continuous" and args.scenario != "server":
        ap.error("--engine continuous drives the server scenario (its "
                 "admission queue is the point); use --scenario server")
    if args.tp < 1 or args.replicas < 1:
        ap.error("--tp and --replicas count from 1")
    if (args.tp > 1 or args.replicas > 1) and args.engine != "continuous":
        ap.error("--tp/--replicas shard the continuous engine; add "
                 "--engine continuous")
    if args.tp > 1 and args.replicas > 1:
        ap.error("--tp with --replicas is not ported: each replica of a "
                 "sharded engine would issue its collectives from a "
                 "thread of its own, in an order the ranks do not share "
                 "(ROADMAP §A.8)")
    if (args.tp > 1 and torch.device(args.device).type == "cuda"
            and args.tp > torch.cuda.device_count()):
        ap.error(f"--tp {args.tp} runs a rank on each of {args.tp} cards; "
                 f"{torch.cuda.device_count()} visible")
    if args.speculative and args.engine != "continuous":
        ap.error("--speculative is a continuous-engine decode mode; add "
                 "--engine continuous")
    if (args.engine == "fixed" and args.scenario == "server"
            and torch.device(args.device).type == "cuda"):
        ap.error("--engine fixed --scenario server is the synchronous "
                 "Server, whose queueing waits are modeled and have no "
                 "measured draw; on cuda serve with --engine continuous")
    if args.prefix_cache and not args.kv_page_size:
        ap.error("--prefix-cache needs --kv-page-size")
    if args.kv_page_size and args.engine != "continuous":
        ap.error("--kv-page-size needs --engine continuous")
    if args.prefill_chunk and not args.kv_page_size:
        ap.error("--prefill-chunk needs --kv-page-size (chunks write "
                 "through the paged verify path)")
    if args.preemption and not args.prefix_cache:
        ap.error("--preemption needs --prefix-cache (a parked "
                 "request's KV pages survive as cache entries until "
                 "resume)")
    if args.tp > 1:
        backend = ("nccl" if torch.device(args.device).type == "cuda"
                   else "gloo")
        # the run's own length, its warm-up and the ranks' start
        return run_tp(_tp_rank, args.tp, backend=backend,
                      timeout_s=600.0 + 10.0 * args.min_duration,
                      args=(args,))
    return _run(args, args.device)


def _tp_rank(rank: int, tp: int, args):
    """One rank of ``--tp``: rank r on ``cuda:r`` (or the CPU)."""
    dev = (f"cuda:{rank}" if torch.device(args.device).type == "cuda"
           else "cpu")
    return _run(args, dev, rank)


def _run(args, device, rank: int = 0):
    """Build, serve under ``PowerRun`` and report (rank 0 of ``--tp``,
    or the only process); the other ranks of ``--tp`` follow rank 0's
    serves and return ``None``."""
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduce_config(cfg)
    model = build_model(cfg, device)
    params = model.init(args.seed)
    draft_cfg = None
    if args.engine == "continuous":
        engines, draft_cfg = _continuous_engines(args, cfg, model, params,
                                                 rank)
        if rank != 0:
            engines[0].follow()
            return None
    measured = (model.device.type == "cuda" and args.tp == 1
                and args.replicas == 1)
    nvml = NVML(model.device) if measured else None
    try:
        energy_meter = nvml.energy_meter() if measured else None
        if args.engine == "continuous":
            sut = _continuous_sut(args, cfg, engines, draft_cfg,
                                  energy_meter)
        else:
            sut, engine = _fixed_sut(args, cfg, model, params, energy_meter)
            engines = [engine]
        for k in KERNELS:
            k.launches = 0
        try:
            r = PowerRun(sut, _scenario_for(args), seed=0).run()
        finally:
            if args.tp > 1:
                engines[0].close()
    finally:
        if nvml is not None:
            nvml.close()
    m = _report(args, r, engines, measured)
    _print_stats(args, engines, draft_cfg)
    return m


def _print_stats(args, engines, draft_cfg) -> None:
    """The speculative, prefix-cache and scheduler counters, summed over
    the replicas."""
    def total(stats: str, key: str) -> int:
        return sum(getattr(e, stats)[key] for e in engines)

    if args.speculative:
        acc = total("spec_stats", "accepted") / max(
            1, total("spec_stats", "proposed"))
        print(f"  speculative k={args.k} (draft {draft_cfg.name}): "
              f"acceptance {acc:.2f}, {total('spec_stats', 'rounds')} "
              f"verified slot-rounds")
    if getattr(engines[0], "prefix_caching", False):
        peak = max(e.page_pool.peak_used for e in engines)
        print(f"  prefix cache: {total('prefix_stats', 'hits')}/"
              f"{total('prefix_stats', 'lookups')} hits, "
              f"{total('prefix_stats', 'cached_tokens')} prompt tokens "
              f"served from cache, {total('prefix_stats', 'evicted_pages')}"
              f" pages evicted, peak {peak} pages (page size "
              f"{args.kv_page_size})")
    if any(v for e in engines for v in getattr(e, "sched_stats",
                                               {}).values()):
        chunks = total("sched_stats", "prefill_chunks")
        inter = total("sched_stats", "interleaved_chunks")
        print(f"  scheduler: {total('sched_stats', 'preemptions')} "
              f"preemptions, {total('sched_stats', 'resumes')} resumes, "
              f"{chunks} prefill chunks ({inter / max(1, chunks):.0%} "
              f"interleaved with decode)")


if __name__ == "__main__":
    main()
