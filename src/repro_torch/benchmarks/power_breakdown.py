"""Per-domain power/energy breakdown across the µW->MW scale axis
(port of ``benchmarks/power_breakdown.py``).

The paper's central table, with one *column per measurement boundary*:
each scale point runs through the one-call harness with its
scale-appropriate ``MeterStack`` and reports the measured watts/Joules
split across power domains —

- ``tiny``  — duty-cycled MCU on the pin-demarcated DC channel (µW);
- ``edge``  — single edge SoC: accelerator/dram/host rails under a
  SPEC-class wall analyzer (W);
- ``tp1``   — one datacenter chip behind node telemetry (kW class);
- ``tp4``   — 4-way tensor parallel: one accelerator channel *per
  shard* summed under one wall;
- ``r2``    — a 2-replica fleet: per-replica stacks (rails + wall)
  aggregated by a derived PDU boundary (§IV-C fallback).

The datacenter points model the H100 system (``common.SYSTEM``).  All
points use modeled workloads on the simulated loadgen clock, so the
sweep is fast and device-independent — the point is the metering API,
not engine throughput (``benchmarks/scale_sweep.py`` measures that).
Every row's run must pass the compliance review, including the
cross-domain invariants (wall >= sum of rails, wall == rails/eta within
channel error, PDU == sum of wall feeds); a rejected review emits an
ERROR row.

  PYTHONPATH=src python -m repro_torch.benchmarks.power_breakdown --smoke
"""
from __future__ import annotations

import types

from repro_torch.benchmarks import common
from repro_torch.benchmarks.common import csv_row

QPS = {"edge": 20.0, "tp1": 40.0, "tp4": 160.0, "r2": 40.0}


def _tiny_point():
    from repro_torch.core.loadgen import Clock
    from repro_torch.harness import PowerRun, SingleStream, TinySUT

    sut = TinySUT(lambda: None, macs=500_000, sram_bytes=60_000,
                  period_s=0.25, name="tiny-kws-model")
    return PowerRun(sut, SingleStream(min_duration_s=61.0, min_queries=64),
                    clock=Clock(), seed=0).run()


def _dc_sysdesc(meter, scale="datacenter"):
    from repro_torch.core.compliance import SystemDescription
    from repro_torch.harness.sut import _system_peak_watts

    telemetry = 0.01 if scale == "datacenter" else None
    return SystemDescription(
        scale=scale, n_chips=meter.n_chips,
        instrument=("node-telemetry" if scale == "datacenter"
                    else "virtual-wt310"),
        telemetry_accuracy=telemetry,
        max_system_watts=_system_peak_watts(meter),
        idle_system_watts=meter.system_watts(None))


def _issue_point(name, meter, qps, *, n_accel_channels=1, psu=None,
                 scale="datacenter"):
    """One synthetic serving point: constant-latency issue function,
    analytic rail domains at the measured throughput."""
    from repro_torch.configs import get_config
    from repro_torch.core.loadgen import Clock
    from repro_torch.harness import (CallableSUT, PowerRun, SingleStream,
                                     rail_domains, throughput_work)

    cfg = get_config("qwen3-1.7b")
    psu = psu or meter.psu()
    sut = CallableSUT(
        name=name, issue=lambda s: 1.0 / qps, psu=psu,
        domains_factory=lambda o: rail_domains(
            meter, throughput_work(cfg, o.result.qps),
            n_accel_channels=n_accel_channels, psu=psu),
        sysdesc=_dc_sysdesc(meter, scale))
    return PowerRun(sut, SingleStream(min_duration_s=61.0, min_queries=64),
                    clock=Clock(), seed=0).run()


def _fleet_point(n_replicas=2):
    """Replica fleet: synthetic admission queues, per-replica stacks
    under one derived PDU boundary."""
    from repro_torch.configs import get_config
    from repro_torch.core.loadgen import qid_of
    from repro_torch.core.power_model import SystemPowerModel
    from repro_torch.harness import (CallableSUT, PowerRun, ReplicatedSUT,
                                     Server, rail_domains, throughput_work)

    cfg = get_config("qwen3-1.7b")
    qps = QPS["r2"]

    def make_replica(i):
        meter = SystemPowerModel(common.SYSTEM, 1)

        def serve(arrivals):
            return [types.SimpleNamespace(
                rid=qid_of(s, j), arrival_s=a,
                first_token_s=a + 0.01, done_s=a + 0.05,
                output=[1, 2, 3, 4], energy_j=None)
                for j, (s, a) in enumerate(arrivals)]

        return CallableSUT(
            name=f"breakdown-replica{i}", serve_queue=serve,
            psu=meter.psu(),
            # replicas see an equal share of the offered load
            domains_factory=lambda o: rail_domains(
                meter, throughput_work(cfg, qps / n_replicas)),
            sysdesc=_dc_sysdesc(meter))

    sut = ReplicatedSUT([make_replica(i) for i in range(n_replicas)],
                        name=f"breakdown-r{n_replicas}")
    return PowerRun(sut, Server(target_qps=qps, latency_slo_s=1.0,
                                mode="queue", min_duration_s=61.0,
                                min_queries=64), seed=0).run()


def _row(point, r) -> str:
    if not r.passed:
        fails = ";".join(c.rule for c in r.report.failures())
        return f"power_breakdown_{point},0.0,ERROR:review-rejected({fails})"
    watts = r.per_domain_watts
    cols = ";".join(f"{k}={v:.4g}W" for k, v in sorted(watts.items()))
    sj = r.samples_per_joule
    return csv_row(
        f"power_breakdown_{point}", 0.0,
        f"{cols};total={r.summary.energy_j:.4g}J;"
        f"boundary={'+'.join(r.summary.boundary_nodes)};"
        f"samples_per_j={sj:.4g}")


def run(smoke: bool = False) -> dict:
    from repro_torch.core.power_model import SystemPowerModel
    from repro_torch.hw import EDGE_SYSTEM
    from repro_torch.power import GOLD_CURVE, PSUModel

    out = {"tiny": _tiny_point()}
    edge_meter = SystemPowerModel(EDGE_SYSTEM, 1)
    # the edge point documents a load-dependent PSU loss curve (80
    # PLUS-style sag) instead of the flat datacenter efficiency
    edge_psu = PSUModel(rated_watts=edge_meter.psu().rated_watts,
                        curve=GOLD_CURVE)
    out["edge"] = _issue_point("breakdown-edge", edge_meter,
                               QPS["edge"], psu=edge_psu, scale="edge")
    dc1 = SystemPowerModel(common.SYSTEM, 1)
    out["tp1"] = _issue_point("breakdown-tp1", dc1, QPS["tp1"])
    dc4 = SystemPowerModel(common.SYSTEM, 4)
    out["tp4"] = _issue_point("breakdown-tp4", dc4, QPS["tp4"],
                              n_accel_channels=4)
    out["r2"] = _fleet_point()
    return out


def csv(smoke: bool = False) -> list[str]:
    return [_row(point, r) for point, r in run(smoke).items()]


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    for row in csv(smoke=args.smoke):
        print(row)
