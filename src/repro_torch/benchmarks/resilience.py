"""Resilience benchmark: efficiency + validity under injected faults.

Sweeps the three fault families of ``repro_torch.faults`` — meter sample
dropout, replica crash, queue-overload burst — at increasing fault
rates, and for each level runs the same modeled serving fleet twice:

- **hardened**: every graceful-degradation path enabled (meter
  re-measure retries, crash re-dispatch onto survivors, admission-
  control load shedding, per-request deadlines, run-level retry), and
- **naive**: the same faults with every mitigation disabled.

Reported per level: ``goodput_per_j`` (deadline-met queries per Joule
of fleet boundary energy), ``slo_attainment`` (deadline-met fraction
of offered load), and run validity (did the compliance review accept
the run — a naive run may also die outright, e.g. a crash with no
re-dispatch path, which counts as invalid).  The whole benchmark is
modeled (pure numpy service/queueing model + the virtual meter stack,
fixed seeds), so the numbers are deterministic across machines and the
CI perf gate compares ``goodput_per_j`` raw against the committed
baseline.

The port of ``benchmarks/resilience.py``: the same constants, fleets,
fault levels, seeds and CSV rows over the port's harness.  Being
entirely modeled (numpy service times, ``CallableSUT`` replicas, the
virtual meter stack), it takes no device and gives the reference's
numbers on any machine.

    PYTHONPATH=src python -m repro_torch.benchmarks.resilience [--smoke]
"""
from __future__ import annotations

import argparse
from types import SimpleNamespace

import numpy as np

SEED = 13
TARGET_QPS = 4.0
SLO_S = 5.0
SERVICE_QPS = 8.0            # per-replica modeled service rate
WINDOW_S = 61.0
N_REPLICAS = 2

# fault levels, mildest first (l1 is the smoke + gate level)
DROPOUT_S = (8.0, 20.0, 40.0)          # seconds of lost wall samples
CRASH_AT_S = (50.0, 35.0, 20.0)        # earlier crash = more lost work
BURST_QPS = (12.0, 30.0, 60.0)         # 10 s overload burst rate


def _const(w):
    return lambda t, _w=float(w): np.full_like(np.asarray(t, float), _w)


def _sysdesc():
    from repro_torch.core.compliance import SystemDescription

    return SystemDescription(scale="edge", max_system_watts=60,
                             idle_system_watts=8)


def _queue_serve(service_qps: float):
    """Modeled single-server replica: FIFO queue, deterministic
    service time — queueing delay (and thus deadline misses) emerges
    under overload instead of being scripted."""
    from repro_torch.core.loadgen import qid_of

    def serve(arrivals):
        service = 1.0 / service_qps
        free = 0.0
        out = []
        for j, (s, a) in enumerate(arrivals):
            start = max(float(a), free)
            done = start + service
            free = done
            out.append(SimpleNamespace(
                rid=qid_of(s, j), arrival_s=float(a),
                first_token_s=start + 0.3 * service, done_s=done,
                output=[0] * 8, energy_j=None))
        return out

    return serve


def _replica(i: int):
    from repro_torch.harness import CallableSUT
    from repro_torch.power import PSUModel, PowerDomain

    psu = PSUModel(rated_watts=60.0, efficiency=0.9)
    rails = [PowerDomain("accelerator", _const(9.0 + i)),
             PowerDomain("host", _const(5.0))]
    wall = PowerDomain("wall",
                       psu.wall_source([r.source for r in rails]),
                       boundary=True)
    return CallableSUT(name=f"rep{i}", serve_queue=_queue_serve(
                           SERVICE_QPS),
                       psu=psu, domains_factory=lambda o: rails + [wall],
                       sysdesc=_sysdesc())


def _solo_sut():
    """Single-system SUT whose wall IS the boundary channel — the
    meter-dropout mode needs the R12 coverage invariant to bite."""
    from repro_torch.harness import CallableSUT
    from repro_torch.power import PSUModel, PowerDomain

    psu = PSUModel(rated_watts=60.0, efficiency=0.9)
    rails = [PowerDomain("accelerator", _const(9.0)),
             PowerDomain("host", _const(5.0))]
    wall = PowerDomain("wall",
                       psu.wall_source([r.source for r in rails]),
                       boundary=True)
    return CallableSUT(name="solo", serve_queue=_queue_serve(
                           2 * SERVICE_QPS),
                       psu=psu, domains_factory=lambda o: rails + [wall],
                       sysdesc=_sysdesc())


def _run(faults, *, fleet: bool, hardened: bool) -> dict:
    from repro_torch.core.loadgen import ShedPolicy
    from repro_torch.faults import FaultPlan, RetryPolicy
    from repro_torch.harness import PowerRun, ReplicatedSUT, Server

    plan = FaultPlan(faults, seed=SEED)
    if fleet:
        sut = ReplicatedSUT([_replica(i) for i in range(N_REPLICAS)],
                            name="fleet",
                            retry=RetryPolicy() if hardened else None)
    else:
        sut = _solo_sut()
    scenario = Server(
        target_qps=TARGET_QPS, latency_slo_s=SLO_S, mode="queue",
        min_duration_s=WINDOW_S, seed=SEED, deadline_s=SLO_S,
        shed=ShedPolicy(max_queue=32) if hardened else None)
    kwargs = {}
    if hardened:
        kwargs = dict(meter_retry=RetryPolicy(),
                      retry_policy=RetryPolicy(max_attempts=2))
    try:
        r = PowerRun(sut, scenario, seed=0, fault_plan=plan,
                     **kwargs).run()
    except (RuntimeError, ValueError) as e:
        # a naive run may die outright (crash with no re-dispatch
        # path); that is an invalid run, not a benchmark error
        return {"valid": 0.0, "goodput_per_j": 0.0,
                "slo_attainment": 0.0, "died": type(e).__name__}
    m = r.outcome.server
    goodput = m.result.n_queries / max(r.summary.energy_j, 1e-12)
    return {"valid": 1.0 if r.passed else 0.0,
            "goodput_per_j": goodput,
            "slo_attainment": m.slo_attainment,
            "n_shed": m.n_shed, "n_timeout": m.n_timeout,
            "energy_j": r.summary.energy_j}


def _mode_faults(mode: str, level: float):
    from repro_torch.faults import MeterDropout, QueueOverload, ReplicaCrash

    if mode == "meter_dropout":
        return [MeterDropout("wall", 5.0, level)], False
    if mode == "replica_crash":
        return [ReplicaCrash(1, at_s=level)], True
    if mode == "overload":
        return [QueueOverload(at_s=20.0, duration_s=10.0, qps=level)], True
    raise ValueError(mode)


def metrics(smoke: bool = False) -> dict:
    """Nested metrics for the CI perf gate + nightly trend artifact.
    ``l1`` (the mildest level) is measured in both smoke and full
    mode, so the committed smoke baseline gates every run."""
    levels = {"meter_dropout": DROPOUT_S, "replica_crash": CRASH_AT_S,
              "overload": BURST_QPS}
    n_levels = 1 if smoke else len(DROPOUT_S)
    out: dict = {"baseline": _run([], fleet=True, hardened=True)}
    for mode, lv in levels.items():
        per_mode: dict = {}
        valid, naive_valid = [], []
        for k, level in enumerate(lv[:n_levels], start=1):
            faults, fleet = _mode_faults(mode, level)
            hard = _run(faults, fleet=fleet, hardened=True)
            naive = _run(faults, fleet=fleet, hardened=False)
            valid.append(hard["valid"])
            naive_valid.append(naive["valid"])
            per_mode[f"l{k}"] = dict(
                hard, fault_level=float(level),
                naive_valid=naive["valid"],
                naive_slo_attainment=naive["slo_attainment"])
        per_mode["valid_rate"] = float(np.mean(valid))
        per_mode["naive_valid_rate"] = float(np.mean(naive_valid))
        out[mode] = per_mode
    return out


def csv(smoke: bool = False) -> list[str]:
    m = metrics(smoke=smoke)
    rows = [f"resilience_baseline,0.0,"
            f"{m['baseline']['goodput_per_j']:.4f}q/J;"
            f"slo={m['baseline']['slo_attainment']:.3f}"]
    for mode in ("meter_dropout", "replica_crash", "overload"):
        for key, lev in sorted(m[mode].items()):
            if not key.startswith("l"):
                continue
            rows.append(
                f"resilience_{mode}_{key},0.0,"
                f"{lev['goodput_per_j']:.4f}q/J;"
                f"slo={lev['slo_attainment']:.3f};"
                f"valid={lev['valid']:.0f};"
                f"naive_valid={lev['naive_valid']:.0f}")
        rows.append(f"resilience_{mode}_validity,0.0,"
                    f"hardened={m[mode]['valid_rate']:.2f};"
                    f"naive={m[mode]['naive_valid_rate']:.2f}")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="mildest fault level only (CI chaos stage)")
    args = ap.parse_args(argv)
    for row in csv(smoke=args.smoke):
        print(row)


if __name__ == "__main__":
    main()
