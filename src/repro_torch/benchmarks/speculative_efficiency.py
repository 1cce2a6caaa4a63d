"""Speculative-decoding k-sweep: tokens/s, tokens/J, and the
draft-vs-target energy split across k ∈ {0, 2, 4, 8} (the port of
``benchmarks/speculative_efficiency.py``).

The ML.ENERGY benchmark (arXiv:2505.06371) ranks speculative decoding
among the highest-leverage LLM inference energy optimizations — *when
the draft agrees with the target*.  This sweep quantifies both sides
of that trade on the serving stack:

- the **high-acceptance pair**: the draft is the target's first
  ``DRAFT_LAYERS`` blocks (LayerSkip-style self-draft, shared
  embeddings/head).  Random weights can't provide the distilled draft
  a real deployment would train, so the target's upper layers are
  damped (``damp_upper_layers``) to *construct* the high-agreement
  regime — the target keeps its full depth and per-token cost, and the
  measured acceptance rate is reported alongside every row;
- the **low-acceptance row** (``spec_random_draft``): an independently
  initialized draft that almost never agrees — drafting then *costs*
  energy (every proposed token burns draft FLOPs the verify throws
  away).

Every point runs the same backlogged queue-form Server scenario
through ``PowerRun`` under the draft-weighted
``ContinuousBatchingSUT(draft=...)``; tok/J integrates the Director
trace.  The energy split is analytic: draft/target forward counts from
the engine's ``spec_stats`` weighted by each model's parameter count.

The reference's geometry, k grid, budgets, keys and CSV rows; two
differences: prompts are drawn with numpy (``default_rng((13, rid))``)
where the reference draws them with ``jax.random``, and the target's
depth depends on the device:

- On the CPU (``device="cpu"``): the reduced qwen3-1.7b deepened to
  ``TARGET_LAYERS`` = 8, as in the reference.  The reduced config's 4
  layers would make a 1-layer draft nearly half as expensive as
  verifying; at 8 the ratio (~0.2x with the shared embed/head) stands
  in for a real deployment's much smaller draft.  Every rail is the
  reference's model.
- On the card (the default): the full 28-layer qwen3-1.7b, whose own
  depth gives the 1-layer draft a realistic cost ratio, so
  ``TARGET_LAYERS`` does not apply; each SUT's accelerator rail is the
  card's NVML energy counter, and each point also reports its
  measured accelerator Joules and tokens/J there.

``n_reps`` defaults to the reference's ``N_REPS``, which ``__main__``
runs.

  PYTHONPATH=src python -m repro_torch.benchmarks.speculative_efficiency \\
      [--device cpu] [--smoke]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

SLOTS = 4
PROMPT_LEN = 8
MAX_LEN = 128
# the CPU target is deepened to 8 layers so the draft/target cost
# ratio resembles a real deployment's (see the module docstring)
TARGET_LAYERS = 8
# uniform 80-decode-token budgets: long enough that decode (not
# prefill/admission) dominates each run, and 80 divides both the plain
# engine's 4-step chunks and the k=4 verify rounds (5 tokens), so
# neither engine pays budget/chunk misalignment waste
MIX = (81, 81, 81, 81)
# saturating offered load: the whole queue arrives within a few ms so
# every point runs backlogged
QPS = 2000.0
K_SWEEP = (0, 2, 4, 8)
DRAFT_LAYERS = 1
DAMP = 0.001                  # upper-layer damping of the target
N_REPS = 4


def _make_request(cfg, rid, arrival_s):
    from repro_torch.serving import Request

    rng = np.random.default_rng((13, rid))
    return Request(rid=rid,
                   prompt=rng.integers(0, cfg.vocab_size, PROMPT_LEN),
                   max_new_tokens=MIX[rid % len(MIX)],
                   arrival_s=float(arrival_s))


def _prepare_point(name, engine, cfg, draft_cfg, n_queries, energy_meter):
    """Warm an engine and return its measurement closure."""
    from repro_torch.core.loadgen import qid_of
    from repro_torch.harness import ContinuousBatchingSUT, PowerRun, Server

    def make_request(i, s, a):
        return _make_request(cfg, qid_of(s, i), a)

    # warmup outside the measurement: a full slot-count batch exercises
    # prefill, chunks and refills before the measured runs
    engine.serve([_make_request(cfg, 10 ** 6 + j, 0.0)
                  for j in range(SLOTS + 1)], honor_arrivals=False)
    sut = ContinuousBatchingSUT(engine, cfg, name=f"spec-{name}",
                                make_request=make_request,
                                draft=draft_cfg, energy_meter=energy_meter)
    scenario = Server(target_qps=QPS, latency_slo_s=30.0,
                      min_duration_s=0.0, min_queries=n_queries,
                      mode="queue")

    def run_once():
        # 1 kHz on every meter-stack channel resolves the sub-second
        # measured window
        r = PowerRun(sut, scenario, seed=0, sample_hz=1000.0).run()
        # snapshot this repetition's engine accounting so the stats
        # reported for a point come from the same rep as its metrics
        r.spec_stats = dict(engine.spec_stats)
        return r

    return run_once


def _finish_point(r, engine, cfg, draft_cfg, measured):
    m = r.outcome.server
    point = {
        "tokens_per_s": m.tokens_per_s,
        "tok_per_j": m.total_tokens / max(r.summary.energy_j, 1e-12),
        "us_per_tok": (r.outcome.result.duration_s
                       / max(1, m.total_tokens) * 1e6),
        "review_passed": r.passed,
    }
    if measured:
        acc_j = r.per_domain_energy_j["accelerator"]
        point["accelerator_j"] = acc_j
        point["tok_per_j_accelerator"] = m.total_tokens / max(acc_j, 1e-12)
    # the snapshot taken by run_once: the best rep's own accounting
    s = r.spec_stats
    if engine.speculative:
        d_fwd = s["draft_fwd"] + s["draft_prefill_tokens"]
        t_fwd = (s["rounds"] * (engine.spec_k + 1)
                 + s["target_prefill_tokens"])
        d_cost = d_fwd * draft_cfg.param_count()
        t_cost = t_fwd * cfg.param_count()
        point["acceptance"] = s["accepted"] / max(1, s["proposed"])
        point["draft_energy_share"] = d_cost / max(d_cost + t_cost, 1e-12)
    return point


def _build(dev):
    """The target (seeded, its layers past ``DRAFT_LAYERS`` damped) and
    its truncated self-draft: full width on the card, the reduced
    config at ``TARGET_LAYERS`` on the CPU."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import build_model
    from repro_torch.serving import damp_upper_layers, truncate_draft

    cfg = get_config("qwen3-1.7b")
    if dev.type != "cuda":
        cfg = dataclasses.replace(reduce_config(cfg),
                                  n_layers=TARGET_LAYERS)
    model = build_model(cfg, dev)
    params = model.init(0)
    # construct the high-acceptance regime (see module docstring): the
    # target keeps its full depth/cost, but its upper layers contribute
    # little, so the truncated self-draft agrees almost always
    params = damp_upper_layers(params, DRAFT_LAYERS, DAMP)
    dmodel, dparams = truncate_draft(model, params, DRAFT_LAYERS)
    return cfg, model, params, dmodel, dparams


def _random_draft(cfg, dev):
    """An independent draft of the self-draft's shape, seeded apart."""
    from repro_torch.models import build_model

    rcfg = dataclasses.replace(cfg, n_layers=DRAFT_LAYERS,
                               name=f"{cfg.name}-random-draft")
    rmodel = build_model(rcfg, dev)
    return rmodel, rmodel.init(99)


def _points(dev, smoke: bool, n_reps: int) -> dict:
    from repro_torch.benchmarks.common import interleaved_best_of
    from repro_torch.power.nvml import NVML
    from repro_torch.serving import ContinuousBatchingEngine

    measured = dev.type == "cuda"
    cfg, model, params, dmodel, dparams = _build(dev)
    n = 12 if smoke else 24
    nvml = NVML(dev) if measured else None
    try:
        def setup(name, **spec_kw):
            # plain decode: 4 tokens/chunk; speculative: 4 rounds/chunk
            eng = ContinuousBatchingEngine(
                model, params, max_len=MAX_LEN, n_slots=SLOTS,
                chunk_steps=4, device=dev, **spec_kw)
            draft_cfg = (spec_kw["draft_model"].cfg if spec_kw else None)
            meter = nvml.energy_meter() if measured else None
            return (_prepare_point(name, eng, cfg, draft_cfg, n, meter),
                    eng, draft_cfg)

        setups: dict = {}
        for k in K_SWEEP:
            spec_kw = ({} if k == 0 else
                       dict(draft_model=dmodel, draft_params=dparams,
                            spec_k=k))
            setups[f"k{k}"] = setup(f"k{k}", **spec_kw)
        # the cautionary point: an independent random draft (same shape
        # as the self-draft) that the target almost never agrees with
        rmodel, rparams = _random_draft(cfg, dev)
        setups["random_draft_k4"] = setup(
            "random-k4", draft_model=rmodel, draft_params=rparams, spec_k=4)

        # interleaved best-of-n_reps per k point (see common.py)
        best = interleaved_best_of(
            {name: run_once for name, (run_once, _, _) in setups.items()},
            n_reps=n_reps)
    finally:
        if nvml is not None:
            nvml.close()

    points = {name: _finish_point(best[name], eng, cfg, draft_cfg, measured)
              for name, (_, eng, draft_cfg) in setups.items()}
    base = points["k0"]["tokens_per_s"]
    for name in points:
        if name != "k0":
            points[name]["speedup"] = (points[name]["tokens_per_s"]
                                       / max(base, 1e-12))
    return points


def metrics(device="cuda", smoke: bool = False,
            n_reps: int = N_REPS) -> dict:
    """k-sweep numbers keyed as the reference's, plus ``review_passed``
    per point (and the measured accelerator figures on the card)."""
    from repro_torch import resolve_device

    return _points(resolve_device(device), smoke, n_reps)


def csv(device="cuda", smoke: bool = False) -> list[str]:
    points = metrics(device, smoke=smoke)
    rows = []
    for name, p in points.items():
        derived = (f"{p['tokens_per_s']:.1f}toks/s;"
                   f"{p['tok_per_j']:.3f}tok/J")
        if "acceptance" in p:
            derived += (f";acc={p['acceptance']:.2f};"
                        f"draft_share={p['draft_energy_share']:.2f}")
        if "speedup" in p:
            derived += f";{p['speedup']:.2f}x"
        rows.append(f"spec_{name},{p['us_per_tok']:.1f},{derived}")
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
