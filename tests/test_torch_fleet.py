"""The port's modeled fleet (``repro_torch.fleet``, ``launch.fleet`` and
``benchmarks.fleet_sweep``) against the reference.

Three parts:

- the reference's own ``tests/test_fleet.py`` and
  ``tests/test_fleet_properties.py``, run against the port: each file's
  source with every ``repro.`` import pointed at ``repro_torch.``,
  executed as a module of its own here, each of its tests one case of a
  parametrized test;
- the two packages on the same seeded inputs, bit for bit (both are
  numpy): traces (arrivals, ``compress``, carbon intensity and grams),
  the DVFS and cap arithmetic, routers' choices and controllers'
  decision sequences, every ``FleetSim`` record and replica trace, and
  ``FleetSUT``'s per-domain energy under ``PowerRun``;
- the benchmark and the launcher: ``fleet_sweep.metrics`` with the
  calibration patched to one token time in both packages (every key
  equal, at a cut day so that the test stays short), the port's own
  calibration on the reduced model on the CPU, the geometry constants,
  and ``launch.fleet``'s printed table equal to the reference CLI's.
"""
import ast
import dataclasses
import inspect
import os
import sys
import types

import numpy as np
import pytest
import torch

import repro.core.loadgen as jloadgen
import repro.faults as jfaults
import repro.fleet as jf
import repro.harness as jh
import repro.launch.fleet as jlaunch
import repro_torch.core.loadgen as tloadgen
import repro_torch.faults as tfaults
import repro_torch.fleet as tf
import repro_torch.harness as th
import repro_torch.launch.fleet as tlaunch
from repro_torch.benchmarks import fleet_sweep as tsweep

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
from benchmarks import fleet_sweep as jsweep  # noqa: E402

torch.set_num_threads(1)

SIDES = {"ref": types.SimpleNamespace(f=jf, h=jh, q=jloadgen, x=jfaults),
         "port": types.SimpleNamespace(f=tf, h=th, q=tloadgen, x=tfaults)}


# --- the reference's tests, run against the port -------------------------

def _ported(name):
    """``tests/<name>.py`` with its ``repro.`` imports (module level and
    inside tests) pointed at ``repro_torch.``."""
    path = os.path.join(ROOT, "tests", f"{name}.py")
    with open(path) as f:
        src = f.read().replace("from repro.", "from repro_torch.")
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.ImportFrom):
            assert node.module.split(".")[0] != "repro", node.module
    mod = types.ModuleType(f"{name}_on_the_port")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


REF_MODULES = {name: _ported(name)
               for name in ("test_fleet", "test_fleet_properties")}


def _reference_tests():
    """Every test of the two files: ``(file, name)`` for a module-level
    function (hypothesis-widened ones included), ``(file,
    Class.method)`` for a test class's method."""
    out = []
    for file, mod in REF_MODULES.items():
        for key, obj in vars(mod).items():
            if key.startswith("test_") and callable(obj):
                out.append((file, key))
            elif key.startswith("Test") and isinstance(obj, type):
                out += [(file, f"{key}.{m}") for m in vars(obj)
                        if m.startswith("test_")]
    return sorted(out)


REF_TESTS = _reference_tests()


@pytest.mark.parametrize("file, name", REF_TESTS,
                         ids=[f"{f}::{n}" for f, n in REF_TESTS])
def test_reference_test_passes_on_the_port(file, name):
    mod = REF_MODULES[file]
    if "." in name:
        cls, method = name.split(".")
        getattr(getattr(mod, cls)(), method)()
    else:
        getattr(mod, name)()


def test_reference_tests_run_the_port():
    assert len(REF_TESTS) >= 40
    assert REF_MODULES["test_fleet"].FleetSUT is tf.FleetSUT
    assert REF_MODULES["test_fleet_properties"].diurnal_trace is (
        tf.diurnal_trace)
    assert set(tf.__all__) == set(jf.__all__)


# --- both packages on the same inputs ------------------------------------

TRACE_ARGS = {
    "diurnal": dict(peak_qps=0.08, trough_qps=0.01, horizon_s=2000.0,
                    period_s=2000.0),
    "bursty": dict(base_qps=0.02, burst_qps=0.1, burst_period_s=500.0,
                   burst_duration_s=100.0, horizon_s=2000.0),
    "ramp": dict(start_qps=0.01, end_qps=0.1, horizon_s=2000.0),
}


@pytest.mark.parametrize("kind", sorted(TRACE_ARGS))
@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_traces_are_the_reference_traces(kind, seed):
    got = {}
    for side, S in SIDES.items():
        tr = S.f.TRACES[kind](seed=seed, **TRACE_ARGS[kind])
        c = tr.compress(37.5)
        got[side] = (tr.arrivals_s, tr.horizon_s, tr.mean_qps,
                     tr.rate_qps(700.0, 200.0), c.arrivals_s, c.horizon_s)
    for a, b in zip(got["ref"], got["port"]):
        assert np.array_equal(a, b)
    assert len(got["port"][0]) > 10


@pytest.mark.parametrize("kw", [{}, dict(base_gco2_per_kwh=300.0,
                                        swing_gco2_per_kwh=120.0,
                                        period_s=500.0)],
                         ids=["default", "custom"])
def test_carbon_trace_is_the_reference_trace(kw):
    t = np.linspace(0.0, 3 * 86_400.0, 1001)
    energy = np.random.default_rng(3).uniform(0.0, 5e4, t.size)
    out = {}
    for side, S in SIDES.items():
        c = S.f.CarbonTrace(**kw)
        out[side] = (c.intensity_gco2_per_kwh(t),
                     c.intensity_gco2_per_kwh(1234.5),
                     c.emitted_gco2(energy, t))
    for a, b in zip(out["ref"], out["port"]):
        assert np.array_equal(a, b)


def _spec(S, **kw):
    base = dict(tokens_per_s=100.0, prefill_s=0.05, n_slots=4,
                idle_w=90.0, busy_w=260.0, cold_start_s=1.0,
                cold_start_w=180.0)
    base.update(kw)
    return S.f.ReplicaSpec(**base)


SPEC_KW = [{}, dict(tp=4, n_slots=8, idle_w=300.0, busy_w=820.0,
                    tokens_per_s=360.0, cold_start_w=500.0),
           dict(dvfs=None)]


@pytest.mark.parametrize("i", range(len(SPEC_KW)))
def test_dvfs_and_cap_arithmetic_are_the_reference(i):
    out = {}
    for side, S in SIDES.items():
        kw = dict(SPEC_KW[i])
        if "dvfs" in kw:
            kw["dvfs"] = S.f.DVFSCurve(min_freq=0.4, power_exp=2.2,
                                       throughput_exp=0.9)
        spec = _spec(S, **kw)
        curve = spec.dvfs
        freqs = [curve.min_freq, 0.55, 0.8, 1.0]
        caps = [None, spec.busy_w + 1.0, spec.busy_w, 0.5 * (
            spec.idle_w + spec.busy_w), spec.watts(spec.n_slots,
                                                  curve.min_freq)]
        out[side] = (
            [curve.throughput_scale(f) for f in freqs],
            [curve.power_scale(f) for f in freqs],
            [spec.tpot_s(f) for f in freqs],
            [spec.ttft_service_s(f) for f in freqs],
            [[spec.watts(n, f) for n in range(spec.n_slots + 1)]
             for f in freqs],
            [spec.peak_w(f) for f in freqs],
            [spec.j_per_token(f) for f in freqs],
            [spec.freq_for_cap_w(c) for c in caps])
    assert out["port"] == out["ref"]


def _views(S, specs, busy, freqs):
    return [S.f.ReplicaView(index=i, spec=s, busy_slots=b, freq=f)
            for i, (s, b, f) in enumerate(zip(specs, busy, freqs))]


@pytest.mark.parametrize("router", ["round-robin", "least-loaded",
                                    "energy-aware", "carbon-aware"])
def test_routers_choose_as_the_reference(router):
    rng = np.random.default_rng(11)
    draws = [(rng.integers(0, 9, 4), rng.uniform(0.4, 1.0, 4),
              float(rng.uniform(0.0, 2 * 86_400.0))) for _ in range(200)]
    out = {}
    for side, S in SIDES.items():
        specs = [_spec(S, **SPEC_KW[i % 2]) for i in range(4)]
        r = S.f.ROUTERS[router]()
        out[side] = [r.choose(_views(S, specs, np.minimum(
            busy, [s.n_slots for s in specs]), freqs), t)
            for busy, freqs, t in draws]
    assert out["port"] == out["ref"]
    assert len(set(out["port"]) - {None}) > 1


POLICY_KW = {"target-util": dict(target=0.55, slots_per_replica=4),
             "queue-depth": {}, "slo-slack": dict(slack=0.4)}


@pytest.mark.parametrize("policy", sorted(POLICY_KW))
def test_controllers_decide_as_the_reference(policy):
    rng = np.random.default_rng(5)
    obs = [dict(time_s=0.5 * k, queue_depth=int(rng.integers(0, 30)),
                inflight=int(rng.integers(0, 17)),
                n_warm=int(rng.integers(0, 5)),
                n_starting=int(rng.integers(0, 2)),
                slots_total=int(rng.integers(0, 17)),
                arrival_qps=float(rng.uniform(0.0, 20.0)),
                service_qps_per_replica=float(rng.uniform(0.5, 5.0)),
                ttft_slo_s=(None if k % 7 == 0 else 2.0))
           for k in range(300)]
    out = {}
    for side, S in SIDES.items():
        pol = S.f.POLICIES[policy](**POLICY_KW[policy])
        ctl = S.f.FleetController(pol, min_replicas=1, max_replicas=6,
                                  cooldown_up_s=1.0, cooldown_down_s=5.0,
                                  down_ticks=3)
        seen = [S.f.Observation(**o) for o in obs]
        out[side] = ([pol.desired_replicas(o) for o in seen],
                     [ctl.decide(o) for o in seen], ctl.scale_events,
                     [o.utilization for o in seen])
    assert out["port"] == out["ref"]
    assert out["port"][2] > 0


SIM_CASES = {
    "static": dict(initial_warm=2),
    "autoscaled": dict(initial_warm=1, controller="target-util"),
    "capped-energy": dict(initial_warm=1, controller="queue-depth",
                          cap_w=600.0, router="energy-aware"),
    "crash-carbon": dict(initial_warm=2, controller="slo-slack",
                         router="carbon-aware", crash=(0, 40.0)),
}


def _sim(S, case):
    kw = dict(SIM_CASES[case])
    ctl = kw.pop("controller", None)
    if ctl is not None:
        kw["controller"] = S.f.FleetController(
            S.f.POLICIES[ctl](), min_replicas=1, max_replicas=4,
            cooldown_down_s=10.0, down_ticks=3)
    router = kw.pop("router", None)
    if router == "carbon-aware":
        kw["router"] = S.f.CarbonAware(carbon=S.f.CarbonTrace(
            period_s=120.0))
    elif router is not None:
        kw["router"] = S.f.ROUTERS[router]()
    crash = kw.pop("crash", None)
    if crash is not None:
        kw["fault_plan"] = S.x.FaultPlan([S.x.ReplicaCrash(
            replica=crash[0], at_s=crash[1])])
    specs = [_spec(S, **SPEC_KW[i % 2]) for i in range(4)]
    return S.f.FleetSim(specs, control_interval_s=0.5, **kw)


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_fleet_sim_records_are_the_reference_records(case):
    out = {}
    for side, S in SIDES.items():
        tr = S.f.diurnal_trace(peak_qps=8.0, trough_qps=0.5,
                               horizon_s=120.0, period_s=120.0, seed=7)
        queries = [({"qid": i, "out_tokens": 8 + i % 9}, float(t))
                   for i, t in enumerate(tr.arrivals_s)]
        sim = _sim(S, case)
        recs = sim.run(queries)
        out[side] = dict(
            records=[dataclasses.asdict(r) for r in recs],
            traces=[(r.trace.times_s, r.trace.watts)
                    for r in sim.replicas],
            energy=sim.replica_energy_j(), ledger=sim.energy_ledger_j(),
            provisioned=sim.provisioned_w_avg(), tokens=sim.total_tokens(),
            counts=(sim.cold_starts, sim.n_crashed, sim.n_requeued,
                    sim.end_s),
            scale_events=(sim.controller.scale_events
                          if sim.controller else None))
    assert out["port"] == out["ref"]
    assert len(out["port"]["records"]) > 100


def _fleet_sut(S, cap_w):
    specs = [_spec(S) for _ in range(3)]
    return S.f.FleetSUT(
        specs, name="fleet-test", initial_warm=1, cap_w=cap_w,
        make_controller=lambda: S.f.FleetController(
            S.f.TargetUtilization(target=0.5, slots_per_replica=4),
            min_replicas=1, max_replicas=3, cooldown_down_s=5.0,
            down_ticks=2),
        control_interval_s=0.5, default_out_tokens=12)


@pytest.mark.parametrize("cap_w", [None, 200.0])
def test_fleet_sut_power_run_is_the_reference_run(cap_w):
    out = {}
    for side, S in SIDES.items():
        sut = _fleet_sut(S, cap_w)
        trace = S.f.diurnal_trace(peak_qps=6.0, trough_qps=0.5,
                                  horizon_s=60.0, period_s=60.0, seed=2)
        qsl = S.q.QuerySampleLibrary(
            512, lambda i: {"index": i, "out_tokens": 12})
        scn = S.h.TraceServer(trace=trace, latency_slo_s=8.0,
                              ttft_slo_s=2.0)
        r = S.h.PowerRun(sut, scn, qsl=qsl, sample_hz=50.0, seed=0).run()
        out[side] = dict(
            per_domain=r.per_domain_energy_j, energy=r.summary.energy_j,
            watts=r.summary.avg_watts, passed=r.passed,
            checks=[(c.rule, c.passed, c.detail) for c in r.report.checks],
            replica_j=sut.replica_energy_j(r.outcome,
                                           np.linspace(0.0, 60.0, 601)),
            exact_j=sut.exact_replica_energy_j(),
            per_request=r.per_request_energy_j)
    assert out["port"] == out["ref"]
    assert out["port"]["passed"]
    dom = out["port"]["per_domain"]
    walls = sum(v for k, v in dom.items() if k.endswith("/wall"))
    assert dom["pdu"] == pytest.approx(walls, rel=1e-9)


# --- the benchmark and the launcher ---------------------------------------

T_TOK_S = 1e-3
# a cut day for the CPU (both packages alike): 60 request-times with the
# crash a third of the way in; every acceptance check still runs
CUT = dict(HORIZON_UNITS=60.0, CRASH_AT_UNITS=30.0)


def test_sweep_metrics_are_the_reference_metrics(monkeypatch):
    for mod in (jsweep, tsweep):
        for name, value in CUT.items():
            monkeypatch.setattr(mod, name, value)
    monkeypatch.setattr(jsweep, "_measure_t_tok", lambda smoke: T_TOK_S)
    monkeypatch.setattr(tsweep, "_measure_t_tok",
                        lambda device, smoke: T_TOK_S)
    ref = jsweep.metrics(smoke=True)
    port = tsweep.metrics(device="cpu", smoke=True)
    assert port["calibration"].pop("device") == "cpu"
    assert port == ref
    assert list(port) == ["calibration", "static_min", "static_max",
                          "autoscaled", "autoscaled_capped",
                          "autoscaled_crash", "hetero_carbon"]
    assert port["autoscaled"]["speedup"] > 1.0
    assert port["autoscaled_crash"]["n_crashed"] == 1
    assert port["autoscaled_capped"]["peak_replica_w"] <= tsweep.CAP_W
    for name in list(port)[1:]:
        assert port[name]["compliance_passed"] == 1.0


def test_sweep_csv_rows_are_the_reference_rows(monkeypatch):
    fixed = {"calibration": dict(tokens_per_s=1000.0, t_tok_ms=1.0,
                                 unit_ms=80.0, n_arrivals=5, horizon_s=2.0),
             "autoscaled": dict(tokens_per_s=3.0, tok_per_j=0.5,
                                tail_attainment=1.0, provisioned_w_avg=400.0,
                                idle_j=10.0, cold_start_j=3.0,
                                cold_starts=2, n_crashed=1, speedup=1.2,
                                cap_w=200.0, peak_replica_w=199.0,
                                emitted_gco2=0.4)}
    rows = {}
    for side, mod, fn in (("ref", jsweep, "_points"),
                          ("port", tsweep, "metrics")):
        monkeypatch.setattr(mod, fn, lambda *a, **k: {
            k2: dict(v) for k2, v in fixed.items()})
        rows[side] = mod.csv(smoke=True)
    assert rows["port"] == rows["ref"]
    assert [r.split(",")[0] for r in rows["port"]] == [
        "fleet_calibration", "fleet_autoscaled"]


def test_port_calibrates_on_the_reduced_model_on_the_cpu():
    t_tok = tsweep._measure_t_tok("cpu", smoke=True)
    assert 0.0 < t_tok < 1.0


def test_sweep_geometry_is_the_reference_geometry():
    names = ("OUT_TOKENS", "SLOTS", "PREFILL_TOKS", "T_REQ_TOKS",
             "HORIZON_UNITS", "PEAK_RPU", "TROUGH_RPU", "N_REPLICAS",
             "IDLE_W", "BUSY_W", "COLD_START_UNITS", "COLD_START_W",
             "CAP_W", "TTFT_SLO_UNITS", "TPOT_SLO_TOKS",
             "LATENCY_SLO_UNITS", "TARGET_UTIL", "CONTROL_UNITS",
             "COOLDOWN_DOWN_UNITS", "DOWN_TICKS", "CRASH_AT_UNITS", "SEED",
             "DAY_S")
    assert ({n: getattr(tsweep, n) for n in names}
            == {n: getattr(jsweep, n) for n in names})
    # the operating points of the modeled fleets are the reference's
    for fn in ("_specs", "_hetero_specs"):
        want = [dataclasses.asdict(s)
                for s in getattr(jsweep, fn)(500.0, 2e-3)]
        got = [dataclasses.asdict(s)
               for s in getattr(tsweep, fn)(500.0, 2e-3)]
        assert got == want


def test_sweep_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    assert inspect.signature(tsweep.metrics).parameters[
        "device"].default == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        tsweep.metrics()


@pytest.mark.parametrize("argv", [
    ["--horizon", "60"],
    ["--trace", "bursty", "--policy", "slo-slack", "--router",
     "carbon-aware", "--cap-w", "200", "--horizon", "60"],
    ["--trace", "ramp", "--static", "--warm", "2", "--router",
     "energy-aware", "--horizon", "40", "--seed", "3"],
], ids=["diurnal", "bursty-carbon-capped", "ramp-static"])
def test_launcher_prints_the_reference_table(argv, capsys):
    jlaunch.main(argv)
    want = capsys.readouterr().out
    r = tlaunch.main(argv)
    assert capsys.readouterr().out == want
    assert r.passed and "ACCEPTED" in want
