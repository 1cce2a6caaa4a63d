"""The port's fault injection (``repro_torch.faults``), the meter stack's
degradation loop, ``PowerRun(fault_plan=...)`` and ``ReplicatedSUT``
against the reference.

Three parts:

- the reference's own ``tests/test_faults.py`` classes, run against the
  port: the file's source with every ``repro.`` import pointed at
  ``repro_torch.``, executed as a module of its own here;
- the two packages on the same inputs: equal plan draws and bursts,
  equal injected traces, equal stack output and ``ChannelHealth`` under
  ``MeterStack.measure(injector=, retry=)``, and equal ``PowerRun``
  results under each fault family, bit for bit (both are numpy);
- ``ReplicatedSUT`` over two reduced qwen3-1.7b ``ContinuousBatchingSUT``
  replicas on bridged float32 weights (``from_jax``) in each package,
  each serve on its own virtual clock, with a replica crashing
  mid-serve: the same completions, stamps and tokens on both sides;
  and the port's refusal of replicas that carry a measured meter.
"""
import ast
import dataclasses
import os
import sys
import threading
import types

import jax
import numpy as np
import pytest
import torch

import repro.core.compliance as jcomp
import repro.faults as jf
import repro.harness as jh
import repro.power as jpow
import repro_torch.core.compliance as tcomp
import repro_torch.faults as tf
import repro_torch.harness as th
import repro_torch.power as tpow
from repro import configs as jcfg
from repro.core.loadgen import ShedPolicy as JShed
from repro.core.loadgen import qid_of
from repro.models import build_model as jax_build_model
from repro.models.param import init_params as jax_init_params
from repro.serving import ContinuousBatchingEngine as JaxCBE
from repro.serving import Request as JaxRequest
from repro_torch import configs as tcfg
from repro_torch.core.loadgen import ShedPolicy as TShed
from repro_torch.kernels import count_launch
from repro_torch.models import build_model
from repro_torch.models.param import from_jax
from repro_torch.serving import ContinuousBatchingEngine, Request

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
REF_TESTS = os.path.join(ROOT, "tests", "test_faults.py")

# package modules by side
SIDES = {"ref": types.SimpleNamespace(f=jf, h=jh, p=jpow, c=jcomp,
                                      shed=JShed),
         "port": types.SimpleNamespace(f=tf, h=th, p=tpow, c=tcomp,
                                       shed=TShed)}


# --- the reference's classes, run against the port -----------------------

def _ported_reference_tests():
    """``tests/test_faults.py`` with its ``repro.`` imports pointed at
    ``repro_torch.`` (the module-level ones and the two inside tests)."""
    with open(REF_TESTS) as f:
        src = f.read()
    ported = src.replace("from repro.", "from repro_torch.")
    for node in ast.walk(ast.parse(ported)):
        if isinstance(node, ast.ImportFrom):
            assert node.module.split(".")[0] != "repro", node.module
    mod = types.ModuleType("test_faults_on_the_port")
    mod.__file__ = REF_TESTS
    exec(compile(ported, REF_TESTS, "exec"), mod.__dict__)
    return mod


_REF = _ported_reference_tests()
TestFaultPlanOnThePort = _REF.TestFaultPlan
TestMeterDegradationOnThePort = _REF.TestMeterDegradation
TestFleetFaultsOnThePort = _REF.TestFleetFaults
TestQueueConservationOnThePort = _REF.TestQueueConservation
TestRetryAndWatchdogOnThePort = _REF.TestRetryAndWatchdog
TestShedPolicyOnThePort = _REF.TestShedPolicy
TestHardenedNumericsOnThePort = _REF.TestHardenedNumerics
TestSummaryCoverageOnThePort = _REF.TestSummaryCoverage


def test_every_reference_class_runs_on_the_port():
    ref = {k for k, v in vars(_REF).items()
           if k.startswith("Test") and isinstance(v, type)}
    here = {k[:-len("OnThePort")] for k in globals()
            if k.endswith("OnThePort")}
    assert ref == here
    assert _REF.PowerRun is th.PowerRun and _REF.FaultPlan is tf.FaultPlan


# --- both packages on the same inputs ------------------------------------

def _const(w):
    return lambda t: np.full_like(np.asarray(t, float), float(w))


EDGE = dict(scale="edge", max_system_watts=60, idle_system_watts=8)


def _rail_sut(side, issue_s=0.05):
    S = SIDES[side]
    psu = S.p.PSUModel(rated_watts=60.0, efficiency=0.9)
    rails = [S.p.PowerDomain("accelerator", _const(9.0)),
             S.p.PowerDomain("host", _const(9.0))]
    wall = S.p.PowerDomain("wall", psu.wall_source([r.source for r in rails]),
                           boundary=True)
    return S.h.CallableSUT(name="faulted-sut", issue=lambda s: issue_s,
                           psu=psu, domains_factory=lambda o: rails + [wall],
                           sysdesc=S.c.SystemDescription(**EDGE))


def _replica(side, i):
    S = SIDES[side]

    def serve(arrivals):
        return [types.SimpleNamespace(
            rid=qid_of(s, j), arrival_s=a, first_token_s=a + 0.01 * (1 + j % 3),
            done_s=a + 0.05 + 0.02 * (j % 4), output=[1] * (2 + j % 3),
            energy_j=None) for j, (s, a) in enumerate(arrivals)]

    psu = S.p.PSUModel(rated_watts=60.0, efficiency=0.9)
    rails = [S.p.PowerDomain("accelerator", _const(8.0 + i)),
             S.p.PowerDomain("host", _const(5.0))]
    wall = S.p.PowerDomain("wall", psu.wall_source([r.source for r in rails]),
                           boundary=True)
    return S.h.CallableSUT(name=f"rep{i}", serve_queue=serve, psu=psu,
                           domains_factory=lambda o: rails + [wall],
                           sysdesc=S.c.SystemDescription(**EDGE))


def _faults(side, names):
    """Fault specs in ``side``'s package from (class name, args, kw)."""
    return [getattr(SIDES[side].f, n)(*a, **kw) for n, a, kw in names]


@pytest.mark.parametrize("key", [("overload", 0), ("dropout", "wall", 0, 0, 0),
                                 ("dropout", "r1/wall", 2, 1, 3), (7,)])
def test_plan_draws_are_the_reference_draws(key):
    draws = {side: SIDES[side].f.FaultPlan([], seed=11).rng(*key).random(16)
             for side in SIDES}
    assert np.array_equal(draws["port"], draws["ref"])


def test_burst_arrivals_are_the_reference_arrivals():
    spec = [("QueueOverload", (), dict(at_s=3.0, duration_s=4.0, qps=30.0)),
            ("QueueOverload", (), dict(at_s=20.0, duration_s=2.0, qps=90.0))]
    out = {side: SIDES[side].f.FaultPlan(_faults(side, spec),
                                         seed=4).burst_arrivals()
           for side in SIDES}
    assert len(out["port"]) > 100
    assert np.array_equal(out["port"], out["ref"])


INJECTED = [
    [("MeterDropout", ("wall", 1.0, 2.0), {})],
    [("MeterDropout", ("wall", 0.5, 3.0), dict(drop_fraction=0.4))],
    [("RangeOverload", ("wall", 1.5, 1.0), dict(factor=5.0))],
    [("ClockSkew", ("wall", 2.0), dict(skew_ms=120.0))],
    [("MeterDropout", ("wall", 0.2, 1.0), dict(drop_fraction=0.7)),
     ("RangeOverload", ("wall", 2.5, 0.5), dict(transient=True)),
     ("ClockSkew", ("wall", 3.0), {}), ("ClockSkew", ("host", 0.0), {})],
]


@pytest.mark.parametrize("spec", INJECTED)
@pytest.mark.parametrize("retry", [0, 1])
def test_injected_traces_are_the_reference_traces(spec, retry):
    rel_s = np.arange(0.0, 4.0, 0.01)
    w = 20.0 + 3.0 * np.sin(rel_s * 7.0)
    meter = types.SimpleNamespace(
        name="wall", analyzer=types.SimpleNamespace(fixed_range=60.0))
    out = {side: SIDES[side].f.FaultInjector(
        SIDES[side].f.FaultPlan(_faults(side, spec), seed=9)).apply(
            meter, rel_s, w, retry=retry) for side in SIDES}
    for a, b in zip(out["port"], out["ref"]):
        assert np.array_equal(a, b)


def _stack(side):
    S = SIDES[side]
    psu = S.p.PSUModel(rated_watts=100.0, efficiency=0.9)
    rails = [S.p.PowerDomain("accelerator", _const(20.0)),
             S.p.PowerDomain("host", _const(10.0))]
    wall = S.p.PowerDomain("wall", psu.wall_source([r.source for r in rails]),
                           boundary=True)
    st = S.p.build_stack(rails + [wall], S.c.SystemDescription(
        scale="edge", max_system_watts=100, idle_system_watts=5),
        seed=0, name="t", psu=psu)
    st.range_probe(5.0)
    return st


STACK_FAULTS = [
    [("MeterDropout", ("wall", 10.0, 20.0), {})],
    [("MeterDropout", ("accelerator", 4.0, 30.0), dict(drop_fraction=0.5))],
    [("RangeOverload", ("wall", 20.0, 10.0), dict(factor=4.0))],
    [("RangeOverload", ("accelerator", 30.0, 5.0), dict(factor=50.0))],
    [("ClockSkew", ("wall", 30.0), dict(skew_ms=300.0))],
    [("MeterDropout", ("wall", 10.0, 20.0), {}),
     ("RangeOverload", ("host", 12.0, 9.0), dict(factor=30.0,
                                                  transient=True))],
]


@pytest.mark.parametrize("spec", STACK_FAULTS)
@pytest.mark.parametrize("hardened", [False, True])
def test_stack_degradation_is_the_reference_degradation(spec, hardened):
    out, health, ranges = {}, {}, {}
    for side in SIDES:
        S = SIDES[side]
        st = _stack(side)
        out[side] = st.measure(
            65.0, injector=S.f.FaultInjector(S.f.FaultPlan(
                _faults(side, spec), seed=3)),
            retry=S.f.RetryPolicy() if hardened else None)
        health[side] = {k: dataclasses.asdict(v)
                        for k, v in st.health.items()}
        ranges[side] = [m.analyzer.fixed_range for m in st.meters
                        if m.analyzer is not None]
    assert health["port"] == health["ref"]
    assert ranges["port"] == ranges["ref"]
    assert set(out["port"]) == set(out["ref"])
    for name in out["ref"]:
        for a, b in zip(out["port"][name], out["ref"][name]):
            assert np.array_equal(a, b)
    degraded = [h for h in health["port"].values()
                if h != dataclasses.asdict(tf.ChannelHealth())]
    assert degraded


def _fleet(side, hardened):
    S = SIDES[side]
    return S.h.ReplicatedSUT([_replica(side, i) for i in range(2)],
                             name="fleet",
                             retry=S.f.RetryPolicy() if hardened else None)


# (fault specs, served by the fleet?) per fault family: the metering
# faults on one system's wall, the serving faults on a two-replica fleet
FAMILIES = {
    "meter_dropout": ([("MeterDropout", ("wall", 5.0, 20.0), {})], False),
    "range_overload": ([("RangeOverload", ("wall", 10.0, 8.0),
                         dict(factor=6.0, transient=True))], False),
    "clock_skew": ([("ClockSkew", ("wall", 30.0), dict(skew_ms=300.0))],
                   False),
    "replica_crash": ([("ReplicaCrash", (1,), dict(at_s=20.0))], True),
    "replica_hang": ([("ReplicaHang", (0,), dict(at_s=10.0,
                                                 duration_s=5.0))], True),
    "queue_overload": ([("QueueOverload", (), dict(at_s=15.0, duration_s=5.0,
                                                   qps=50.0))], True),
}


def _power_run(side, family, hardened):
    S = SIDES[side]
    spec, fleet = FAMILIES[family]
    plan = S.f.FaultPlan(_faults(side, spec), seed=11)
    if fleet:
        sut = _fleet(side, hardened)
        scenario = S.h.Server(
            target_qps=4.0, latency_slo_s=2.0, mode="queue",
            min_duration_s=61.0, deadline_s=1.0,
            shed=S.shed(max_queue=16) if hardened else None)
    else:
        sut = _rail_sut(side)
        scenario = S.h.SingleStream(min_duration_s=61.0)
    kw = dict(meter_retry=S.f.RetryPolicy(),
              retry_policy=S.f.RetryPolicy(max_attempts=2)) if hardened else {}
    return sut, S.h.PowerRun(sut, scenario, seed=0, fault_plan=plan,
                             **kw).run()


def _summary(sut, r):
    t, w = r.power_samples()
    out = dict(summary=dataclasses.asdict(r.summary),
               checks=[(c.rule, c.passed, c.detail) for c in r.report.checks],
               health={k: dataclasses.asdict(v)
                       for k, v in r.channel_health.items()},
               domains=r.per_domain_energy_j, t=t.tolist(), w=w.tolist(),
               # every attempt's trail but its wall-clock seconds
               attempts=[{k: v for k, v in a.items() if k != "wall_s"}
                         for a in r.attempts], passed=r.passed)
    if r.outcome.server is not None:
        m = r.outcome.server
        out["server"] = (m.n_shed, m.n_timeout, m.n_admitted,
                         m.slo_attainment, m.total_tokens)
        out["completed"] = sorted((q.rid, q.first_token_s, q.done_s)
                                  for q in sut.completed)
        out["replica_j"] = sut.replica_energy_j(r.outcome, t)
        out["request_j"] = sorted(r.per_request_energy_j.items())
    return out


@pytest.mark.parametrize("hardened", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_power_run_under_each_fault_family_is_the_reference_run(family,
                                                                hardened):
    if family == "replica_crash" and not hardened:
        for side in SIDES:       # without retry a crash that loses
            with pytest.raises(RuntimeError, match="re-dispatch"):
                _power_run(side, family, hardened)      # queries raises
        return
    out = {side: _summary(*_power_run(side, family, hardened))
           for side in SIDES}
    assert out["port"] == out["ref"]


def test_replicated_sut_traces_are_the_reference_traces():
    """Crash-clamped replica traces, the PDU boundary derived from the
    replica walls, and ``replica_energy_j`` summing to the fleet's."""
    out = {}
    for side in SIDES:
        sut, r = _power_run(side, "replica_crash", True)
        t, _ = r.power_samples()
        grid = np.linspace(0.0, 70.0, 7001)
        doms = sut.domains(r.outcome)
        out[side] = dict(
            names=[(d.name, d.kind, d.boundary, d.derived_from)
                   for d in doms],
            traces=[d.source(grid).tolist() for d in doms
                    if d.source is not None],
            fleet=sut.power_source(r.outcome)(grid).tolist(),
            replica_j=sut.replica_energy_j(r.outcome, t),
            pdu=r.domain_samples("pdu")[1].tolist())
    assert out["port"] == out["ref"]
    names = [n for n, *_ in out["port"]["names"]]
    assert names[-1] == "pdu" and "r1/wall" in names
    # the crashed replica draws nothing from its crash on
    r1 = out["port"]["traces"][names.index("r1/wall")]
    assert r1[1999] > 0 and r1[2000:] == [0.0] * 5001     # t = 20.0 on


# --- ReplicatedSUT over engines ------------------------------------------

MAX_LEN = 64
N_QUERIES = 12


@pytest.fixture(scope="module")
def models():
    jc = jcfg.reduce_config(jcfg.get_config("qwen3-1.7b"))
    jm = jax_build_model(jc)
    jp = jax_init_params(jm.param_defs(), jax.random.PRNGKey(0))
    tm = build_model(tcfg.reduce_config(tcfg.get_config("qwen3-1.7b")),
                     "cpu")
    return jm, jp, tm, from_jax(jax.tree.map(np.asarray, jp), "cpu")


class Clocked:
    """An engine whose every ``serve`` runs on a virtual clock of its
    own (every ``now()`` read ticks 2 ms, ``sleep`` jumps ahead), so
    that stamps, and so which requests finish before a crash, are the
    same in both packages and on any machine."""

    def __init__(self, engine):
        self.engine = engine

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def serve(self, reqs, **kw):
        t = [0.0]

        def now():
            t[0] += 0.002
            return t[0]

        def sleep(dt):
            t[0] += max(0.0, dt)

        return self.engine.serve(reqs, now=now, sleep=sleep, **kw)


def _engine_fleet(models, side, crash_at=None, retry=True):
    jm, jp, tm, tp = models
    S = SIDES[side]
    cfg = jm.cfg if side == "ref" else tm.cfg
    Req = JaxRequest if side == "ref" else Request

    def make_request(i, s, a):
        rid = qid_of(s, i)
        rng = np.random.default_rng(500 + rid)
        return Req(rid=rid, prompt=rng.integers(0, 512, 6 + rid % 9),
                   max_new_tokens=3 + rid % 5, arrival_s=a)

    def engine():
        kw = dict(max_len=MAX_LEN, n_slots=2, chunk_steps=2)
        return Clocked(JaxCBE(jm, jp, **kw) if side == "ref" else
                       ContinuousBatchingEngine(tm, tp, device="cpu", **kw))

    reps = [S.h.ContinuousBatchingSUT(engine(), cfg, name=f"rep{i}",
                                      make_request=make_request)
            for i in range(2)]
    faults = ([] if crash_at is None
              else [S.f.ReplicaCrash(1, at_s=crash_at)])
    sut = S.h.ReplicatedSUT(reps, name="fleet",
                            retry=S.f.RetryPolicy() if retry else None)
    run = S.h.PowerRun(sut, S.h.Server(
        target_qps=40.0, latency_slo_s=30.0, mode="queue",
        min_duration_s=0.0, min_queries=N_QUERIES), seed=0,
        sample_hz=1000.0, fault_plan=S.f.FaultPlan(faults, seed=1))
    return sut, run


@pytest.fixture(scope="module")
def crash_at(models):
    """Halfway through replica 1's completions on a fault-free serve."""
    sut, run = _engine_fleet(models, "port")
    run.run()
    done = sorted(r.done_s for r in sut.replicas[1].completed)
    return (done[len(done) // 2 - 1] + done[len(done) // 2]) / 2


@pytest.fixture(scope="module")
def crashed_fleets(models, crash_at):
    at = crash_at
    out = {}
    for side in SIDES:
        sut, run = _engine_fleet(models, side, crash_at=at)
        out[side] = (sut, run.run(), at)
    return out


def test_engine_fleet_under_a_crash_is_the_jax_fleet(crashed_fleets):
    rec = {}
    for side, (sut, r, at) in crashed_fleets.items():
        assert r.passed, r.report.render()
        rec[side] = dict(
            completed=sorted((q.rid, tuple(int(x) for x in q.output),
                              q.arrival_s, q.first_token_s, q.done_s)
                             for q in sut.completed),
            by_replica=[sorted(q.rid for q in rep.completed)
                        for rep in sut.replicas],
            energy=r.per_domain_energy_j)
    assert rec["port"] == rec["ref"]
    sut, r, at = crashed_fleets["port"]
    rids = [q.rid for q in sut.completed]
    assert sorted(rids) == list(range(N_QUERIES))
    # replica 1 kept only what it finished before the crash; the rest of
    # its share was served again by replica 0, after the backoff
    kept = sut.replicas[1].completed
    assert kept and all(q.done_s < at for q in kept)
    moved = [q for q in sut.replicas[0].completed if q.rid % 2 == 1]
    assert moved and all(q.arrival_s >= at for q in moved)


def test_engine_fleet_crash_without_retry_raises(models, crash_at):
    for side in SIDES:
        _, run = _engine_fleet(models, side, crash_at=crash_at, retry=False)
        with pytest.raises(RuntimeError, match="re-dispatch"):
            run.run()


def test_replicas_with_a_measured_meter_are_refused(models):
    """The port's deliberate difference: on one card every replica's
    NVML trace is the whole card's, so a fleet of measured replicas
    would bill the card once per replica."""
    _, _, tm, tp = models
    eng = ContinuousBatchingEngine(tm, tp, max_len=MAX_LEN, n_slots=2,
                                   device="cpu")

    def rep(i, meter):
        return th.ContinuousBatchingSUT(
            eng, tm.cfg, name=f"rep{i}", energy_meter=meter,
            make_request=lambda i, s, a: None)

    with pytest.raises(ValueError, match=r"replica 1 \(rep1\).*measured"):
        th.ReplicatedSUT([rep(0, None), rep(1, lambda: None)])
    assert th.ReplicatedSUT([rep(0, None), rep(1, None)]).n_replicas == 2


def test_launch_counts_survive_replica_threads():
    """Replicas serve from threads of one process and share the kernel
    wrappers' launch counters: 8 threads counting at once, with thread
    switches as frequent as the interpreter allows, lose no count."""
    def wrapper():
        pass

    wrapper.launches = 0

    def count():
        for _ in range(20_000):
            count_launch(wrapper)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=count) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 8 * 20_000
