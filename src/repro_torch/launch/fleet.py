"""Fleet launcher: one autoscaled-fleet ``PowerRun`` over a synthetic
day (the port of the reference's ``launch/fleet.py``: the same flags
and the same printed table).

The fleet is modeled (``repro_torch.fleet``): replicas are ``ReplicaSpec``
operating points served in virtual time, so the run needs no
accelerator and finishes in seconds while exercising the full
measurement path — ``TraceServer`` admission schedule, per-replica
power domains under a derived pdu (compliance R11), SLO accounting,
and the lifecycle energy ledger (idle / cold-start / busy joules).
It runs no torch on any device, so, unlike the port's other entry
points, it takes no ``--device``.  The replica watts (90 W idle, 260 W
busy, 180 W cold start) are the modeled fleet's operating points, not
figures of any chip.

  PYTHONPATH=src python -m repro_torch.launch.fleet --trace diurnal \
      --policy target-util --replicas 4 --horizon 120

  # DVFS power cap + carbon-aware routing on a bursty day
  PYTHONPATH=src python -m repro_torch.launch.fleet --trace bursty \
      --policy slo-slack --router carbon --cap-w 200

``--static`` pins the fleet at ``--warm`` replicas (no controller) —
the over/under-provisioned anchors of
``repro_torch.benchmarks.fleet_sweep``'s Pareto table.
"""
from __future__ import annotations

import argparse

from repro_torch.core.loadgen import QuerySampleLibrary
from repro_torch.fleet import (POLICIES, ROUTERS, CarbonTrace, FleetController,
                         FleetSUT, ReplicaSpec, bursty_trace,
                         diurnal_trace, ramp_trace)
from repro_torch.harness import PowerRun
from repro_torch.harness.scenarios import TraceServer

OUT_TOKENS = 16


def _trace(args):
    if args.trace == "diurnal":
        return diurnal_trace(peak_qps=args.peak_qps,
                             trough_qps=args.trough_qps,
                             horizon_s=args.horizon,
                             period_s=args.horizon, seed=args.seed)
    if args.trace == "bursty":
        return bursty_trace(base_qps=args.trough_qps,
                            burst_qps=args.peak_qps,
                            burst_period_s=args.horizon / 6.0,
                            burst_duration_s=args.horizon / 18.0,
                            horizon_s=args.horizon, seed=args.seed)
    return ramp_trace(start_qps=args.trough_qps, end_qps=args.peak_qps,
                      horizon_s=args.horizon, seed=args.seed)


def _specs(args):
    return [ReplicaSpec(label=f"tp1-{i}", tokens_per_s=args.tokens_per_s,
                        prefill_s=0.05, n_slots=args.slots,
                        idle_w=90.0, busy_w=260.0, cold_start_s=2.0,
                        cold_start_w=180.0)
            for i in range(args.replicas)]


def _router_factory(args):
    if args.router == "carbon-aware":
        carbon = CarbonTrace(period_s=args.horizon)
        return lambda: ROUTERS["carbon-aware"](carbon=carbon)
    return lambda: ROUTERS[args.router]()


def main(argv=None):
    """Run one fleet PowerRun from CLI flags and print the ledger;
    returns the run's ``SubmissionResult``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default="diurnal",
                    choices=("diurnal", "bursty", "ramp"))
    ap.add_argument("--policy", default="target-util",
                    choices=sorted(POLICIES))
    ap.add_argument("--router", default="least-loaded",
                    choices=sorted(ROUTERS))
    ap.add_argument("--static", action="store_true",
                    help="no controller: pin the fleet at --warm")
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--warm", type=int, default=1,
                    help="replicas warm at t=0")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cap-w", type=float, default=None,
                    help="per-replica DVFS power cap (watts)")
    ap.add_argument("--horizon", type=float, default=120.0,
                    help="virtual day length in seconds")
    ap.add_argument("--peak-qps", type=float, default=2.0)
    ap.add_argument("--trough-qps", type=float, default=0.2)
    ap.add_argument("--tokens-per-s", type=float, default=200.0,
                    help="modeled full-occupancy decode rate")
    ap.add_argument("--ttft-slo", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    trace = _trace(args)
    make_controller = None
    if not args.static:
        make_controller = lambda: FleetController(  # noqa: E731
            POLICIES[args.policy](), min_replicas=1,
            max_replicas=args.replicas,
            cooldown_down_s=args.horizon / 12.0, down_ticks=3)
    sut = FleetSUT(_specs(args), name=f"fleet-{args.trace}",
                   initial_warm=min(args.warm, args.replicas),
                   make_controller=make_controller,
                   make_router=_router_factory(args),
                   control_interval_s=args.horizon / 240.0,
                   cap_w=args.cap_w, default_out_tokens=OUT_TOKENS)
    qsl = QuerySampleLibrary(
        4096, lambda i: {"index": i, "out_tokens": OUT_TOKENS})
    scn = TraceServer(trace=trace, latency_slo_s=4.0 * args.ttft_slo,
                      ttft_slo_s=args.ttft_slo)
    r = PowerRun(sut, scn, qsl=qsl,
                 sample_hz=max(4096.0 / trace.horizon_s, 1.0),
                 seed=args.seed).run()

    sim = sut.sim
    m = r.outcome.server
    ledger = sim.energy_ledger_j(r.outcome.result.duration_s)
    tokens = sim.total_tokens()
    print(r.render())
    print(f"  {args.trace} day: {trace.n_arrivals} arrivals over "
          f"{trace.horizon_s:.0f}s, "
          f"{'static' if args.static else args.policy} x "
          f"{args.replicas} replicas ({args.router} routing"
          + (f", cap {args.cap_w:.0f} W" if args.cap_w else "") + ")")
    print(f"  TTFT p99 {m.ttft_p(99) * 1e3:.0f} ms, tail attainment "
          f"{m.tail_attainment:.3f}, "
          f"{tokens / max(r.summary.energy_j, 1e-9):.3f} tok/J")
    print(f"  ledger: {ledger['total_j']:.0f} J = "
          f"busy {ledger['busy_j']:.0f} + idle {ledger['idle_j']:.0f} "
          f"+ cold-start {ledger['cold_start_j']:.0f} "
          f"({sim.cold_starts} starts); provisioned avg "
          f"{sim.provisioned_w_avg(r.outcome.result.duration_s):.0f} W"
          + (f"; {sim.controller.scale_events} scale events"
             if sim.controller else ""))
    return r


if __name__ == "__main__":
    main()
