"""24 h fleet Pareto sweep: SLO attainment vs J/token vs provisioned W
(the port of ``benchmarks/fleet_sweep.py``).

The paper's tables fix the system; this sweep fixes the *day* — a
seeded diurnal arrival trace (24 h compressed onto the test window,
arrival count conserved) — and walks the provisioning strategies a
fleet operator actually chooses between:

- **static_min**    — 2 always-warm replicas: cheap to provision,
  backlog piles up through the midday peak (the under-provisioned
  Pareto anchor);
- **static_max**    — all 4 replicas always warm: best tails money can
  buy, but the overnight trough bills 4 idle floors (the
  over-provisioned anchor);
- **autoscaled**    — target-utilization controller with hysteresis
  scales 1..4 replicas across the day, paying modeled cold-start
  energy on every wake;
- **autoscaled_capped** — autoscaling plus a per-replica DVFS power
  cap: superlinear power-vs-frequency means the capped fleet trades a
  little headroom for a better J/token;
- **autoscaled_crash**  — the autoscaled fleet with a ``ReplicaCrash``
  mid-peak (controller re-scales around the corpse; informational);
- **hetero_carbon** — a heterogeneous fleet (tp1 / tp4 / speculative
  operating points) with carbon-aware routing against a diurnal
  gCO2/kWh grid trace, reporting emitted grams.

Every quantity is expressed in units of the *measured* warm decode
token time ``t_tok`` of the port's ``ContinuousBatchingEngine`` (min of
3), so the collision geometry — which arrivals queue behind which cold
starts — does not change with the machine's speed, while the reported
rates track it.  On the card (the default) ``t_tok`` is measured on the
full-width qwen3-1.7b with seeded bf16 weights, through the flash and
decode kernels; on the CPU (``device="cpu"``) on the reduced config.
That time, and the rates that follow from it, are the only numbers the
device gives this sweep.  The replica watts (``IDLE_W``, ``BUSY_W``,
``COLD_START_W``, ``CAP_W`` and the heterogeneous fleet's points) are
the modeled fleet's operating points, equal to the reference's, not
figures of any chip; the fleet itself is simulated in virtual time and
sleeps through none of it.

Acceptance (each raises ``RuntimeError``): the autoscaled fleet beats
static max-N on fleet J/token at equal-or-better TTFT tail-SLO
attainment (``autoscaled.speedup > 1``), the capped replicas never
exceed the cap, the pdu register equals the sum of the replica walls
(compliance R11), and the exact replica ledger agrees with the sampled
pdu within 2 %.  ``calibration`` also names the device.

  PYTHONPATH=src python -m repro_torch.benchmarks.fleet_sweep \\
      [--device cpu] [--smoke]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

OUT_TOKENS = 16                # decoded tokens per request
SLOTS = 4                      # decode slots per baseline replica
PREFILL_TOKS = 20.0            # prefill cost in token-times
# one request occupies a slot for prefill + (n-1) slot-cadence tokens
T_REQ_TOKS = PREFILL_TOKS + (OUT_TOKENS - 1) * SLOTS
HORIZON_UNITS = 180.0          # virtual day length, in request-times
PEAK_RPU = 10.0                # midday arrivals per request-time
TROUGH_RPU = 1.0               # overnight arrivals per request-time
N_REPLICAS = 4
IDLE_W, BUSY_W = 90.0, 260.0     # the modeled replica's operating
                                 # points, not any chip's figures
COLD_START_UNITS = 1.5         # spin-up, in request-times
COLD_START_W = 180.0
CAP_W = 200.0                  # DVFS cap for the capped config
TTFT_SLO_UNITS = 2.0           # TTFT SLO, in request-times
TPOT_SLO_TOKS = 6.0            # TPOT SLO, in token-times
LATENCY_SLO_UNITS = 8.0        # loose end-to-end p99 bound
TARGET_UTIL = 0.55
CONTROL_UNITS = 0.5            # controller tick, in request-times
COOLDOWN_DOWN_UNITS = 10.0
DOWN_TICKS = 3
CRASH_AT_UNITS = 95.0          # mid-peak (peak is mid-day = unit 90)
SEED = 0
DAY_S = 86_400.0


def _model(dev):
    """The calibration model: full-width qwen3-1.7b on the card,
    reduced on the CPU; seeded weights."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import build_model

    cfg = get_config("qwen3-1.7b")
    if dev.type != "cuda":
        cfg = reduce_config(cfg)
    model = build_model(cfg, dev)
    return cfg, model, model.init(0)


def _measure_t_tok(device, smoke: bool) -> float:
    """Warm decode seconds per token of the port's continuous-batching
    engine at full occupancy (min of 3; each serve ends on the host
    read of its last chunk) — the calibration unit every fleet rate and
    SLO is expressed in."""
    from repro_torch import resolve_device
    from repro_torch.serving import ContinuousBatchingEngine, Request

    dev = resolve_device(device)
    cfg, model, params = _model(dev)
    engine = ContinuousBatchingEngine(model, params, max_len=48,
                                      n_slots=SLOTS, chunk_steps=4,
                                      device=dev)

    def batch(j):
        rng = np.random.default_rng(7_000 + j)
        return [Request(rid=10 ** 6 + 10 * j + k,
                        prompt=rng.integers(0, cfg.vocab_size, 8),
                        max_new_tokens=OUT_TOKENS)
                for k in range(SLOTS)]

    engine.serve(batch(0), honor_arrivals=False)      # warm-up
    ts = []
    for j in range(1, 4):
        t0 = time.perf_counter()
        engine.serve(batch(j), honor_arrivals=False)
        ts.append(time.perf_counter() - t0)
    return float(min(ts)) / (SLOTS * OUT_TOKENS)


def _specs(rate_tokens_per_s: float, t_tok_s: float):
    """The homogeneous 4-replica fleet, calibrated to machine speed."""
    from repro_torch.fleet import ReplicaSpec

    unit_s = T_REQ_TOKS * t_tok_s
    return [ReplicaSpec(label=f"tp1-{i}",
                        tokens_per_s=rate_tokens_per_s,
                        prefill_s=PREFILL_TOKS * t_tok_s,
                        n_slots=SLOTS, idle_w=IDLE_W, busy_w=BUSY_W,
                        cold_start_s=COLD_START_UNITS * unit_s,
                        cold_start_w=COLD_START_W)
            for i in range(N_REPLICAS)]


def _hetero_specs(rate_tokens_per_s: float, t_tok_s: float):
    """tp1 / tp4 / speculative operating points: same model, different
    watts-per-token — the router's choice is what the config measures."""
    from repro_torch.fleet import ReplicaSpec

    unit_s = T_REQ_TOKS * t_tok_s
    base = dict(prefill_s=PREFILL_TOKS * t_tok_s,
                cold_start_s=COLD_START_UNITS * unit_s,
                cold_start_w=COLD_START_W)
    r = rate_tokens_per_s
    return [
        ReplicaSpec(label="tp1-a", tokens_per_s=r, n_slots=SLOTS,
                    idle_w=IDLE_W, busy_w=BUSY_W, tp=1, **base),
        ReplicaSpec(label="tp1-b", tokens_per_s=r, n_slots=SLOTS,
                    idle_w=IDLE_W, busy_w=BUSY_W, tp=1, **base),
        # tp4: 3.6x the rate for ~2.9x the dynamic draw — the
        # efficient big box (145 vs 170 mJ/token per unit rate)
        ReplicaSpec(label="tp4", tokens_per_s=3.6 * r,
                    n_slots=2 * SLOTS, idle_w=300.0, busy_w=820.0,
                    tp=4, cold_start_w=500.0,
                    prefill_s=PREFILL_TOKS * t_tok_s / 2.0,
                    cold_start_s=COLD_START_UNITS * unit_s),
        # speculative decode: 1.8x rate at modest extra draw — the
        # cheapest marginal tokens in the fleet
        ReplicaSpec(label="spec", tokens_per_s=1.8 * r, n_slots=SLOTS,
                    idle_w=100.0, busy_w=300.0, tp=1, **base),
    ]


def _trace(smoke: bool, unit_s: float):
    """The diurnal day: generated over real 24 h seconds (two days in
    full mode) at machine-independent rates, then compressed onto the
    calibrated test window — arrival count conserved exactly."""
    from repro_torch.fleet import diurnal_trace

    n_days = 1 if smoke else 2
    units_per_day_s = HORIZON_UNITS / DAY_S
    tr = diurnal_trace(peak_qps=PEAK_RPU * units_per_day_s,
                       trough_qps=TROUGH_RPU * units_per_day_s,
                       horizon_s=n_days * DAY_S, period_s=DAY_S,
                       seed=SEED)
    return tr.compress(DAY_S / (HORIZON_UNITS * unit_s))


def _run_config(sut, trace, unit_s: float, t_tok_s: float,
                fault_plan=None) -> dict:
    """One PowerRun over the trace; returns the config's metric row."""
    from repro_torch.core.loadgen import QuerySampleLibrary
    from repro_torch.harness.power_run import PowerRun
    from repro_torch.harness.scenarios import TraceServer

    qsl = QuerySampleLibrary(
        4096, lambda i: {"index": i, "out_tokens": OUT_TOKENS})
    scn = TraceServer(trace=trace,
                      latency_slo_s=LATENCY_SLO_UNITS * unit_s,
                      ttft_slo_s=TTFT_SLO_UNITS * unit_s,
                      tpot_slo_s=TPOT_SLO_TOKS * t_tok_s,
                      fault_plan=fault_plan)
    sample_hz = max(8192.0 / (trace.horizon_s * 1.5), 1.0)
    sub = PowerRun(sut, scn, qsl=qsl, sample_hz=sample_hz, seed=SEED,
                   fault_plan=fault_plan).run()
    sim = sut.sim
    server = sub.outcome.server
    dur_s = sub.outcome.result.duration_s
    fleet_j = sub.per_domain_energy_j["pdu"]
    member_sum_j = sum(v for k, v in sub.per_domain_energy_j.items()
                       if k.endswith("/wall"))
    # R11 in metric form: the pdu register is the sum of the measured
    # replica feeds, exactly
    if abs(fleet_j - member_sum_j) > 1e-6 * max(fleet_j, 1.0):
        raise RuntimeError(
            f"{sut.name}: pdu {fleet_j} != sum of replica walls "
            f"{member_sum_j} — R11 broken")
    exact_j = sum(sim.replica_energy_j(dur_s))
    if abs(exact_j - fleet_j) > 0.02 * max(fleet_j, 1.0):
        raise RuntimeError(
            f"{sut.name}: exact replica ledger {exact_j} J vs measured "
            f"pdu {fleet_j} J drifted beyond sampling tolerance")
    tokens = sim.total_tokens()
    ledger = sim.energy_ledger_j(dur_s)
    controller = sim.controller
    return {
        "tokens_per_s": tokens / max(dur_s, 1e-9),
        "tok_per_j": tokens / max(fleet_j, 1e-12),
        "tail_attainment": server.tail_attainment,
        "avg_w": sub.summary.avg_watts,
        "provisioned_w_avg": sim.provisioned_w_avg(dur_s),
        "fleet_j": fleet_j,
        "idle_j": ledger["idle_j"],
        "cold_start_j": ledger["cold_start_j"],
        "cold_starts": sim.cold_starts,
        "scale_events": (controller.scale_events
                         if controller is not None else 0),
        "n_crashed": sim.n_crashed,
        "compliance_passed": float(sub.passed),
        "_peak_replica_w": max(max(r.trace.watts)
                               for r in sim.replicas),
        "_sub": sub,
    }


def _points(dev, smoke: bool) -> dict:
    import torch

    from repro_torch.faults import FaultPlan, ReplicaCrash
    from repro_torch.fleet import (CarbonAware, CarbonTrace,
                                   FleetController, FleetSUT,
                                   TargetUtilization)

    t_tok_s = _measure_t_tok(dev, smoke)
    unit_s = T_REQ_TOKS * t_tok_s
    rate = 1.0 / t_tok_s
    trace = _trace(smoke, unit_s)

    def controller_factory(slots_per_replica=SLOTS):
        return lambda: FleetController(
            TargetUtilization(target=TARGET_UTIL,
                              slots_per_replica=slots_per_replica),
            min_replicas=1, max_replicas=N_REPLICAS,
            cooldown_down_s=COOLDOWN_DOWN_UNITS * unit_s,
            down_ticks=DOWN_TICKS)

    def fleet(name, **kw):
        kw.setdefault("control_interval_s", CONTROL_UNITS * unit_s)
        kw.setdefault("default_out_tokens", OUT_TOKENS)
        return FleetSUT(_specs(rate, t_tok_s), name=name, **kw)

    crash_plan = FaultPlan([ReplicaCrash(
        replica=0, at_s=CRASH_AT_UNITS * unit_s)])
    carbon = CarbonTrace(period_s=HORIZON_UNITS * unit_s)
    configs = {
        "static_min": lambda: (fleet("fleet-static-min",
                                     initial_warm=2), None),
        "static_max": lambda: (fleet("fleet-static-max",
                                     initial_warm=N_REPLICAS), None),
        "autoscaled": lambda: (fleet(
            "fleet-autoscaled", initial_warm=1,
            make_controller=controller_factory()), None),
        "autoscaled_capped": lambda: (fleet(
            "fleet-autoscaled-capped", initial_warm=1,
            make_controller=controller_factory(),
            cap_w=CAP_W), None),
        "autoscaled_crash": lambda: (fleet(
            "fleet-autoscaled-crash", initial_warm=1,
            make_controller=controller_factory()), crash_plan),
        "hetero_carbon": lambda: (FleetSUT(
            _hetero_specs(rate, t_tok_s), name="fleet-hetero-carbon",
            initial_warm=1,
            make_controller=controller_factory(),
            make_router=lambda: CarbonAware(carbon=carbon),
            control_interval_s=CONTROL_UNITS * unit_s,
            default_out_tokens=OUT_TOKENS), None),
    }

    out: dict = {"calibration": {
        "tokens_per_s": rate, "t_tok_ms": t_tok_s * 1e3,
        "unit_ms": unit_s * 1e3,
        "n_arrivals": trace.n_arrivals,
        "horizon_s": trace.horizon_s,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else dev.type)}}
    for name, make in configs.items():
        sut, plan = make()
        row = _run_config(sut, trace, unit_s, t_tok_s, fault_plan=plan)
        sub = row.pop("_sub")
        peak_replica_w = row.pop("_peak_replica_w")
        if name == "autoscaled_capped":
            row["cap_w"] = CAP_W
            row["peak_replica_w"] = peak_replica_w
            if peak_replica_w > CAP_W + 1e-9:
                raise RuntimeError(
                    f"capped replica drew {peak_replica_w:.1f} W over "
                    f"the {CAP_W:.0f} W cap")
        if name == "hetero_carbon":
            times_s, watts = sub.power_samples()
            step_j = watts[:-1] * np.diff(times_s)
            row["emitted_gco2"] = carbon.emitted_gco2(
                step_j, times_s[:-1])
            row["gco2_per_kwh_avg"] = float(np.mean(
                carbon.intensity_gco2_per_kwh(times_s)))
        out[name] = row

    # the acceptance bar, gated as autoscaled.speedup: the autoscaled
    # fleet must beat always-warm max-N provisioning on J/token at
    # equal-or-better TTFT tail attainment over the same day
    auto, stat = out["autoscaled"], out["static_max"]
    speedup = auto["tok_per_j"] / stat["tok_per_j"]
    out["autoscaled"]["speedup"] = speedup
    if speedup <= 1.0:
        raise RuntimeError(
            f"autoscaled fleet J/token no better than static max-N "
            f"({auto['tok_per_j']:.4f} vs {stat['tok_per_j']:.4f} "
            f"tok/J)")
    if auto["tail_attainment"] < stat["tail_attainment"] - 1e-9:
        raise RuntimeError(
            f"autoscaled fleet lost tail attainment vs static max-N "
            f"({auto['tail_attainment']:.4f} < "
            f"{stat['tail_attainment']:.4f})")
    return out


def metrics(device="cuda", smoke: bool = False) -> dict:
    """The fleet Pareto sweep keyed as the reference's;
    ``calibration`` also names the device."""
    from repro_torch import resolve_device

    return _points(resolve_device(device), smoke)


def csv(device="cuda", smoke: bool = False) -> list[str]:
    points = metrics(device, smoke=smoke)
    rows = []
    cal = points.pop("calibration")
    rows.append(f"fleet_calibration,{cal['tokens_per_s']:.1f},"
                f"t_tok={cal['t_tok_ms']:.2f}ms;"
                f"arrivals={cal['n_arrivals']};"
                f"horizon={cal['horizon_s']:.1f}s")
    for name, p in points.items():
        derived = (f"{p['tokens_per_s']:.1f}toks/s;"
                   f"{p['tok_per_j']:.4f}tok/J;"
                   f"attain={p['tail_attainment']:.3f};"
                   f"prov={p['provisioned_w_avg']:.0f}W;"
                   f"idle={p['idle_j']:.0f}J;"
                   f"cold={p['cold_start_j']:.0f}J"
                   f"({p['cold_starts']}starts)")
        if "speedup" in p:
            derived += f";speedup={p['speedup']:.2f}x"
        if "peak_replica_w" in p:
            derived += (f";cap={p['cap_w']:.0f}W;"
                        f"peak={p['peak_replica_w']:.0f}W")
        if "emitted_gco2" in p:
            derived += f";co2={p['emitted_gco2']:.1f}g"
        if p["n_crashed"]:
            derived += f";crashed={p['n_crashed']}"
        rows.append(f"fleet_{name},{p['tok_per_j']:.4f},{derived}")
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
