"""Scale sweep: perf-vs-watts across {1 device, TP=k, R replicas} (the
port of ``benchmarks/scale_sweep.py``).

The paper's core claim is that energy efficiency must be measured
*across scales*; this sweep walks the serving stack up the datacenter
end of the µW->MW axis and reports tokens/s and tokens/J at each scale
point, all through the same ``PowerRun`` methodology:

- ``tp1``   — one ``ContinuousBatchingEngine`` on one device;
- ``tpK``   — one ``ShardedContinuousBatchingEngine`` over K ranks,
  one process each (``repro_torch.parallel.run_tp``; ``ShardedSUT``:
  the meter spans K chips);
- ``r2``    — two independent engines behind one admission queue
  (``ReplicatedSUT``: fleet power is the sum of the replica traces).

On the CPU (``device="cpu"``) K is 4, four gloo ranks standing in for
the reference's four virtual devices, on the reduced qwen3-1.7b.  On
the card K is the number of visible cards and the model is the
full-width qwen3-1.7b (the reduced config's heads of 32 are refused by
every CUDA attention wrapper); with one card the ``tpK`` point gives
way to the reference's ``scale_tp_skipped`` row.  Every point's rails
are modeled (the H100 system's on the card): one card's NVML counter
can stand neither for K cards nor for a share of one.  With K > 1 the
whole sweep runs on rank 0 of the group, so that its repetitions
interleave across all three points as the reference's do; the other
ranks serve their shards of ``tpK``.

  PYTHONPATH=src python -m repro_torch.benchmarks.scale_sweep \\
      [--device cpu] [--smoke]
"""
from __future__ import annotations

import numpy as np

SLOTS = 4
PROMPT_LEN = 12
MAX_LEN = 48
MIX = (4, 12, 6, 8)  # mixed decode budgets: stragglers + short ones
QPS = 200.0  # saturating offered load: every point runs backlogged
REPLICAS = 2
CPU_TP = 4   # gloo ranks of the tpK point on the CPU
TP_TIMEOUT_S = 900.0


def _make_request(cfg, rid, arrival_s):
    from repro_torch.serving import Request

    rng = np.random.default_rng((11, rid))
    return Request(
        rid=rid,
        prompt=rng.integers(0, cfg.vocab_size, PROMPT_LEN),
        max_new_tokens=MIX[rid % len(MIX)],
        arrival_s=float(arrival_s),
    )


def _warm(engine, cfg):
    engine.serve(
        [_make_request(cfg, 10**6, 0.0)], honor_arrivals=False
    )


def _run_once(sut, n_queries):
    from repro_torch.harness import PowerRun, Server

    scenario = Server(
        target_qps=QPS,
        latency_slo_s=30.0,
        min_duration_s=0.0,
        min_queries=n_queries,
        mode="queue",
    )
    # sample every meter-stack channel at 1 kHz so the energy window
    # resolves each point's sub-second duration
    return PowerRun(sut, scenario, seed=0, sample_hz=1000.0).run()


def _measure_points(suts, n_queries):
    """Interleaved best-of per scale point (sub-second numbers; see
    ``benchmarks.common``)."""
    from functools import partial

    from repro_torch.benchmarks.common import interleaved_best_of

    return interleaved_best_of(
        {name: partial(_run_once, sut, n_queries) for name, sut in suts.items()}
    )


def _finish_point(name, r, chips):
    m = r.outcome.server
    tok_j = m.total_tokens / max(r.summary.energy_j, 1e-12)
    us_per_tok = r.outcome.result.duration_s / max(1, m.total_tokens) * 1e6
    point = {
        "tokens_per_s": m.tokens_per_s,
        "tok_per_j": tok_j,
        "us_per_tok": us_per_tok,
        "avg_watts": r.summary.avg_watts,
        "chips": chips,
    }
    return (
        f"scale_{name},{us_per_tok:.1f},"
        f"{m.tokens_per_s:.1f}toks/s;{tok_j:.4f}tok/J;"
        f"{r.summary.avg_watts:.1f}W;{chips}chips"
    ), point


def _setup(device: str):
    """(cfg, model, params) of the sweep on ``device``: seed-0 weights,
    the same on every rank."""
    import torch

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import build_model

    cfg = get_config("qwen3-1.7b")
    if torch.device(device).type == "cpu":
        cfg = reduce_config(cfg)
    model = build_model(cfg, device)
    return cfg, model, model.init(0)


def _engine_kw(model) -> dict:
    return dict(max_len=MAX_LEN, n_slots=SLOTS, chunk_steps=4,
                device=model.device)


def _modeled(model) -> dict:
    """The tp1 and replica SUTs' rails: the reference's defaults on the
    CPU, the H100 system declared as a datacenter server on the card."""
    from repro_torch.core.power_model import SystemPowerModel
    from repro_torch.harness import modeled_sysdesc
    from repro_torch.hw import DATACENTER_H100

    if model.device.type != "cuda":
        return {}
    return dict(system=DATACENTER_H100, sysdesc=modeled_sysdesc(
        SystemPowerModel(DATACENTER_H100, 1), "datacenter"))


def _sweep_rank(rank: int, tp: int, device_type: str, smoke: bool):
    """One rank of the sweep's group: rank 0 runs the whole sweep (its
    ``tp1`` and ``r2`` engines beside its shard of ``tpK``), the other
    ranks serve their shards of ``tpK`` until rank 0 closes them."""
    from repro_torch.harness import ShardedSUT
    from repro_torch.serving import ShardedContinuousBatchingEngine

    device = f"cuda:{rank}" if device_type == "cuda" else "cpu"
    cfg, model, params = _setup(device)
    eng = ShardedContinuousBatchingEngine(model, params, tp=tp, rank=rank,
                                          **_engine_kw(model))
    _warm(eng, cfg)
    if rank != 0:
        eng.follow()
        return None
    sut = ShardedSUT(eng, cfg, name=f"scale-tp{tp}",
                     make_request=_make_request_for(cfg),
                     system=_modeled(model).get("system"))
    try:
        return _sweep(smoke, cfg, model, params, (f"tp{tp}", sut, tp))
    finally:
        eng.close()


def _make_request_for(cfg):
    from repro_torch.core.loadgen import qid_of

    def make_request(i, s, a):
        # rid from the loadgen query id: replicas each see a share of
        # the queue and attribution needs fleet-unique ids
        return _make_request(cfg, qid_of(s, i), a)

    return make_request


def _sweep(smoke: bool, cfg, model, params, tp_point=None):
    """Run every scale point; returns ``(rows, points)``.  ``tp_point``:
    ``(name, ShardedSUT, chips)`` of the ``tpK`` point, or ``None`` on
    a single device (the ``scale_tp_skipped`` row instead)."""
    from repro_torch.harness import ContinuousBatchingSUT, ReplicatedSUT
    from repro_torch.serving import ContinuousBatchingEngine

    # enough queries that every point (incl. the threaded replica
    # fleet, which splits the queue) decodes long enough to dominate
    # admission overhead
    n = 16 if smoke else 24
    make_request = _make_request_for(cfg)
    modeled = _modeled(model)

    rows = []
    points: dict = {}
    suts: dict = {}
    chips: dict = {}

    # -- 1 device ------------------------------------------------------
    eng1 = ContinuousBatchingEngine(model, params, **_engine_kw(model))
    _warm(eng1, cfg)
    suts["tp1"] = ContinuousBatchingSUT(
        eng1, cfg, name="scale-tp1", make_request=make_request, **modeled)
    chips["tp1"] = 1

    # -- tensor parallel over every rank of the group -------------------
    tp_skipped = None
    if tp_point is not None:
        name, sut, k = tp_point
        suts[name] = sut
        chips[name] = k
    else:
        tp_skipped = "scale_tp_skipped,0.0,single-device;one visible card"

    # -- replica fleet -------------------------------------------------
    reps = []
    for _ in range(REPLICAS):
        eng = ContinuousBatchingEngine(model, params, **_engine_kw(model))
        _warm(eng, cfg)
        reps.append(ContinuousBatchingSUT(
            eng, cfg, name="scale-replica", make_request=make_request,
            **modeled))
    suts[f"r{REPLICAS}"] = ReplicatedSUT(reps, name=f"scale-r{REPLICAS}")
    chips[f"r{REPLICAS}"] = REPLICAS

    best = _measure_points(suts, n)
    for name in suts:
        row, points[name] = _finish_point(name, best[name], chips[name])
        rows.append(row)
        if name == "tp1" and tp_skipped is not None:
            rows.append(tp_skipped)

    base_tps = points["tp1"]["tokens_per_s"]
    fleet_tps = points[f"r{REPLICAS}"]["tokens_per_s"]
    points[f"r{REPLICAS}"]["speedup"] = fleet_tps / max(base_tps, 1e-9)
    rows.append(
        f"scale_r{REPLICAS}_speedup,0.0,{fleet_tps / max(base_tps, 1e-9):.2f}x"
    )
    return rows, points


def sweep(device="cuda", smoke: bool = False):
    """``(rows, points)`` of the sweep on ``device``: K gloo ranks on
    the CPU, one NCCL rank a visible card on ``cuda``, in-process when
    there is one card."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.parallel import run_tp

    dev = resolve_device(device)
    if dev.type == "cpu":
        k, backend = CPU_TP, "gloo"
    else:
        k, backend = torch.cuda.device_count(), "nccl"
    if k > 1:
        return run_tp(_sweep_rank, k, backend=backend,
                      timeout_s=TP_TIMEOUT_S, args=(dev.type, smoke))
    return _sweep(smoke, *_setup(dev))


def metrics(device="cuda", smoke: bool = False) -> dict:
    """Scale-point numbers keyed as the reference's."""
    return sweep(device, smoke)[1]


def csv(device="cuda", smoke: bool = False) -> list[str]:
    return sweep(device, smoke)[0]


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    for r in csv(device=args.device, smoke=args.smoke):
        print(r)
