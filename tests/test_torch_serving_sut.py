"""The port's serving SUTs (``ServeEngineSUT``, ``ContinuousBatchingSUT``)
against the reference's, and their measured form on an injected energy
counter.

Without an energy meter the port's SUTs model their rails as the
reference's do, so on the same outcome and completed requests their
domain traces are equal, and a ``PowerRun`` over deterministic stub
engines (the same stamps on both sides, the fixed engine's latency
from a stepped ``time.perf_counter``) gives equal Joules, watts,
samples/J, per-request energy and compliance checks.  With a meter
(``repro_torch.power.nvml.EnergySampler`` over a synthetic counter) the
accelerator rail is the counter's, the host rail modeled and the wall
the PSU of both; the datacenter review passes.  The NVML binding itself
raises where the driver's library is absent: there is no fallback.
"""
import ctypes.util
import dataclasses
import functools
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.harness as jh
import repro.harness.sut as jsut
import repro_torch.core as tcore
import repro_torch.harness as th
import repro_torch.harness.sut as tsut
from repro import configs as jcfg
from repro.hw import EDGE_SYSTEM as J_EDGE
from repro.models import build_model as jax_build_model
from repro.models.param import init_params as jax_init_params
from repro.serving import ContinuousBatchingEngine as JaxCBE
from repro.serving import Request as JaxRequest
from repro_torch import configs as tcfg
from repro_torch.hw import DATACENTER_H100, EDGE_SYSTEM as T_EDGE
from repro_torch.models import build_model
from repro_torch.models.param import from_jax
from repro_torch.power import nvml
from repro_torch.power.nvml import NVML, EnergySampler, counter_period
from repro_torch.serving import ContinuousBatchingEngine, Request

torch.set_num_threads(1)

SIDES = {"ref": (jh, jsut, jcore, J_EDGE, jcfg, JaxRequest),
         "port": (th, tsut, tcore, T_EDGE, tcfg, Request)}
MIX = (4, 24, 8, 16)
GRID = np.linspace(-0.5, 6.0, 6501)


class SlotStub:
    """A deterministic stand-in for the slot engine: ``serve`` stamps
    each request from its arrival, rid and budget, as the SUT's
    contract asks (``first_token_s``/``done_s`` on the arrivals' clock,
    ``output``, and the counts the energy weights read)."""

    n_slots = 4

    def __init__(self, prefix_caching=False):
        self.prefix_caching = prefix_caching

    def serve(self, reqs, now=None):
        if now is not None:
            now()
        for r in reqs:
            r.first_token_s = r.arrival_s + 0.02 + 0.003 * (r.rid % 5)
            r.done_s = r.first_token_s + 0.011 * r.max_new_tokens
            r.output = [r.rid % 7] * r.max_new_tokens
            r.prefill_tokens = 16 - 4 * (r.rid % 3)
            r.draft_tokens = 3 * r.max_new_tokens
            r.verify_tokens = r.max_new_tokens + r.rid % 4
        return list(reqs)


class SteppedClock:
    """``time.perf_counter`` stand-in advanced only by the stub batch."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class BatchStub:
    """A deterministic stand-in for ``ServeEngine``: a batch of n takes
    0.01 + 0.002 n seconds on the stepped clock."""

    batch = 8

    def __init__(self, clock):
        self.clock = clock

    def run_batch(self, reqs, now=None):
        self.clock.t += 0.01 + 0.002 * len(reqs)
        return reqs


def _cfg(side):
    return SIDES[side][4].reduce_config(
        SIDES[side][4].get_config("qwen3-1.7b"))


def _make_request(side):
    Req = SIDES[side][5]

    def make(i, s, a):
        rid = s.get("qid", i)
        return Req(rid=rid, prompt=np.arange(8), max_new_tokens=MIX[rid % 4],
                   arrival_s=a)

    return make


def _continuous(side, variant):
    h = SIDES[side][0]
    kw = {}
    if variant == "draft":
        kw["draft"] = SIDES[side][4].reduce_config(
            SIDES[side][4].get_config("granite-3-2b"))
    return h.ContinuousBatchingSUT(
        SlotStub(prefix_caching=variant == "prefix"), _cfg(side),
        name="cb-stub", make_request=_make_request(side), **kw)


def _completed(side):
    Req = SIDES[side][5]
    reqs = []
    for i in range(9):
        r = Req(rid=i, prompt=np.arange(8), max_new_tokens=MIX[i % 4],
                arrival_s=0.37 * i)
        r.done_s = r.arrival_s + 0.9 + 0.05 * i if i != 4 else None
        reqs.append(r)
    return reqs


def _traces(doms):
    return [(d.name, d.kind, d.boundary, d.source(GRID)) for d in doms]


def _same(a, b):
    assert [x[:3] for x in a] == [y[:3] for y in b]
    for x, y in zip(a, b):
        assert np.array_equal(x[3], y[3]), x[0]


@pytest.mark.parametrize("qps", [0.5, 4.0, 37.0])
def test_modeled_domain_traces_equal_the_reference(qps):
    outcome = types.SimpleNamespace(result=types.SimpleNamespace(qps=qps))
    out = {}
    for side in SIDES:
        cb = _continuous(side, "plain")
        cb.completed = _completed(side)
        fixed = SIDES[side][0].ServeEngineSUT(
            BatchStub(SteppedClock()), _cfg(side), name="fixed-stub",
            make_requests=lambda s: s)
        out[side] = (_traces(cb.domains(outcome)),
                     _traces(fixed.domains(outcome)),
                     cb.power_source(outcome)(GRID),
                     fixed.power_source(outcome)(GRID),
                     dataclasses.asdict(cb._psu()),
                     dataclasses.asdict(cb.system_description()))
    for a, b in zip(out["ref"][:2], out["port"][:2]):
        _same(a, b)
    for a, b in zip(out["ref"][2:4], out["port"][2:4]):
        assert np.array_equal(a, b)
    assert out["ref"][4:] == out["port"][4:]
    names = [t[0] for t in out["port"][0]]
    assert names == ["accelerator", "dram", "host", "wall"]


@pytest.mark.parametrize("n_chips", [1, 8, 64, 512])
def test_system_peak_watts_equals_the_reference(n_chips):
    want = jsut._system_peak_watts(jcore.SystemPowerModel(J_EDGE, n_chips))
    got = tsut._system_peak_watts(tcore.SystemPowerModel(T_EDGE, n_chips))
    assert got == want


def _digest(r):
    res = r.outcome.result
    return dict(
        n_queries=res.n_queries, duration_s=res.duration_s, qps=res.qps,
        latencies=list(res.latencies_s), energy_j=r.summary.energy_j,
        avg_watts=r.summary.avg_watts, window_s=r.summary.window_s,
        per_node_j=r.summary.per_node_j,
        samples_per_joule=r.samples_per_joule, passed=r.report.passed,
        checks=[(c.rule, c.passed, c.detail) for c in r.report.checks],
        per_domain_watts=r.per_domain_watts,
        per_request=r.per_request_energy_j,
        per_request_domain=r.per_request_domain_energy_j)


@pytest.mark.parametrize("variant", ["plain", "draft", "prefix"])
def test_continuous_power_run_equals_the_reference(variant):
    out = {}
    for side in SIDES:
        h = SIDES[side][0]
        scenario = h.Server(target_qps=8.0, latency_slo_s=10.0,
                            mode="queue", min_duration_s=3.0,
                            min_queries=16)
        out[side] = _digest(h.PowerRun(_continuous(side, variant), scenario,
                                       seed=0).run())
    assert out["port"] == out["ref"]
    assert out["port"]["passed"], out["port"]["checks"]
    assert out["port"]["per_request"] and out["port"]["energy_j"] > 0


def _fixed_scenario(h, kind):
    return {"offline": lambda: h.Offline(batch=4, min_duration_s=2.0),
            "single": lambda: h.SingleStream(min_duration_s=1.0,
                                             min_queries=64),
            "multi": lambda: h.MultiStream(n_streams=4, min_duration_s=1.0,
                                           min_queries=64),
            "server": lambda: h.Server(target_qps=20.0, latency_slo_s=10.0,
                                       mode="sync", min_duration_s=2.0,
                                       min_queries=32)}[kind]()


@pytest.mark.parametrize("kind", ["offline", "single", "multi", "server"])
def test_fixed_power_run_equals_the_reference(kind, monkeypatch):
    out = {}
    for side in SIDES:
        h = SIDES[side][0]
        clock = SteppedClock()
        monkeypatch.setattr(time, "perf_counter", clock)
        sut = h.ServeEngineSUT(BatchStub(clock), _cfg(side),
                               name="fixed-stub", make_requests=lambda s: s)
        out[side] = _digest(h.PowerRun(sut, _fixed_scenario(h, kind),
                                       seed=0).run())
    assert out["port"] == out["ref"]
    assert out["port"]["passed"], out["port"]["checks"]


def test_continuous_sut_serves_the_reference_tokens_under_server():
    """The reduced qwen3-1.7b with bridged weights: both packages'
    ``ContinuousBatchingSUT`` under the queue-form ``Server`` emit the
    same tokens per request, and both reviews pass."""
    jc = jcfg.reduce_config(jcfg.get_config("qwen3-1.7b"))
    jm = jax_build_model(jc)
    jp = jax_init_params(jm.param_defs(), jax.random.PRNGKey(0))
    tm = build_model(tcfg.reduce_config(tcfg.get_config("qwen3-1.7b")),
                     "cpu")
    tp = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    budgets = (4, 7, 3, 6, 5, 2)
    engines = {"ref": JaxCBE(jm, jp, max_len=32, n_slots=2, chunk_steps=3),
               "port": ContinuousBatchingEngine(tm, tp, max_len=32,
                                                n_slots=2, chunk_steps=3,
                                                device="cpu")}
    out = {}
    for side, engine in engines.items():
        h, Req = SIDES[side][0], SIDES[side][5]

        def make(i, s, a, Req=Req):
            rid = s["qid"]
            return Req(rid=rid, prompt=(np.arange(8) * 5 + rid) % 512,
                       max_new_tokens=budgets[rid % len(budgets)],
                       arrival_s=a)

        engine.serve([make(0, {"qid": 99}, 0.0)], honor_arrivals=False)
        sut = h.ContinuousBatchingSUT(engine, jc if side == "ref" else
                                      _cfg("port"), make_request=make)
        r = h.PowerRun(sut, h.Server(target_qps=50.0, latency_slo_s=10.0,
                                     mode="queue", min_duration_s=0.0,
                                     min_queries=6), seed=0,
                       sample_hz=1000.0).run()
        assert r.passed, r.report.render()
        out[side] = {q.rid: list(map(int, q.output))
                     for q in sut.completed_requests()}
    assert out["port"] == out["ref"]
    assert sorted(out["port"]) == list(range(6))


class FakeCounter:
    """A cumulative counter in mJ that updates every ``step_s`` (like
    the card's), integrating a piecewise-linear energy profile of
    ``watts`` over ``edges`` seconds since it was made, on ``clock``
    (real time unless a ``VirtualClock`` is given)."""

    def __init__(self, watts=(180.0, 420.0, 95.0), edges=(0.06, 0.15),
                 step_s=0.004, clock=time.monotonic):
        self.watts, self.edges, self.step_s = watts, edges, step_s
        self.clock = clock
        self.t0 = clock()
        self.reads = 0

    def energy_mj(self, t):
        e, lo = 0.0, 0.0
        for w, hi in zip(self.watts, self.edges + (np.inf,)):
            e += w * max(0.0, min(t, hi) - lo)
            lo = hi
        return e * 1e3

    def __call__(self):
        self.reads += 1
        t = self.clock() - self.t0
        return int(self.energy_mj(t - t % self.step_s))


def _integral(src, t_s):
    """The exact integral of a trace constant between readings."""
    t = np.asarray(t_s)
    return float(np.sum(src((t[1:] + t[:-1]) / 2) * np.diff(t)))


@pytest.mark.parametrize("step_s", [0.0005, 0.004, 0.02])
def test_energy_sampler_trace_integrates_to_the_counter(step_s):
    counter = FakeCounter(step_s=step_s)
    with EnergySampler(counter, period_s=0.002) as s:
        time.sleep(0.25)
    assert s.n_samples >= 10 and not s._thread.is_alive()
    assert s.energy_j() == (s.mj[-1] - s.mj[0]) / 1e3
    assert 0.9 * counter.energy_mj(0.25) / 1e3 < s.energy_j()
    t0 = s.t_s[0] + 0.031
    src = s.source(t0)
    rel = np.asarray(s.t_s) - t0
    assert _integral(src, rel) == pytest.approx(s.energy_j(), rel=1e-9)
    # clamped outside the window: the first and last intervals' watts
    assert np.array_equal(src([rel[0] - 5.0, rel[0] - 1e-6]),
                          src([rel[0], rel[0]]))
    assert np.array_equal(src([rel[-1] + 1e-6, rel[-1] + 9.0]),
                          src([rel[-1], rel[-1]]))
    w = src(rel[:-1])
    assert w.min() >= 0 and w.max() < 2000


def test_energy_sampler_needs_a_window():
    s = EnergySampler(FakeCounter())
    with pytest.raises(RuntimeError, match="never started"):
        s.stop()
    s.start()
    with pytest.raises(RuntimeError, match="already started"):
        s.start()
    s.stop()
    with pytest.raises(ValueError, match="two readings"):
        EnergySampler(lambda: 5).source(0.0)


def test_counter_period_measures_the_update_step():
    counter = FakeCounter(watts=(300.0,), edges=(), step_s=0.01)
    assert counter_period(counter, seconds=0.2) == pytest.approx(0.01,
                                                                 abs=3e-3)
    with pytest.raises(RuntimeError, match="no period"):
        counter_period(lambda: 7, seconds=0.02)


class SleepySlots(SlotStub):
    """The slot stub on a ``VirtualClock``: ``serve`` advances the clock
    through its run, stamping requests on ``now`` from its first
    reading."""

    def __init__(self, clock):
        super().__init__()
        self.clock = clock

    def serve(self, reqs, now=time.monotonic):
        t0 = now()
        out = super().serve(reqs)
        self.clock.advance(max(r.done_s for r in out))
        assert now() - t0 >= max(r.done_s for r in out)
        return out


def _meter(clock=None):
    """A sampler factory over a stepped counter: on real time, or with
    ``clock`` (a ``VirtualClock``) a ``VirtualSampler`` that reads at
    each of its periods as the clock advances."""
    if clock is None:
        counter = FakeCounter(watts=(210.0, 480.0, 130.0),
                              edges=(0.2, 0.45), step_s=0.005)
        return functools.partial(EnergySampler, counter, period_s=0.002)
    counter = FakeCounter(watts=(210.0, 480.0, 130.0), edges=(0.2, 0.45),
                          step_s=0.005, clock=clock)
    return functools.partial(VirtualSampler, counter, period_s=0.002,
                             clock=clock)


def _check_measured(sut, r):
    names = [m.name for m in r.meter_stack]
    assert names == ["accelerator", "host", "wall"]       # no dram
    doms = {m.name: m.domain for m in r.meter_stack}
    t = np.linspace(-0.2, 1.5, 1701)
    psu = tcore.SystemPowerModel(DATACENTER_H100, 1).psu()
    assert np.array_equal(doms["wall"].source(t), psu.wall_watts(
        doms["accelerator"].source(t) + doms["host"].source(t)))
    assert doms["wall"].boundary and not doms["accelerator"].boundary
    desc = sut.system_description()
    assert desc.scale == "datacenter" and desc.telemetry_accuracy <= 0.05
    assert not desc.instrument_spec_approved and "nvml" in desc.instrument
    checks = {c.rule: c.passed for c in r.report.checks}
    assert checks["R4 instrument"] and checks["R6 estimation disclosure"]
    assert r.passed, r.report.render()
    acc = r.per_domain_energy_j["accelerator"]
    assert acc == pytest.approx(sut.trace.energy_j(), rel=0.15)


def test_measured_continuous_sut_reads_the_counter():
    clock = VirtualClock()
    sut = th.ContinuousBatchingSUT(
        SleepySlots(clock), _cfg("port"), name="measured-cb",
        make_request=_make_request("port"), energy_meter=_meter(clock))
    r = th.PowerRun(sut, th.Server(target_qps=40.0, latency_slo_s=10.0,
                                   mode="queue", min_duration_s=0.3,
                                   min_queries=8), seed=0).run()
    _check_measured(sut, r)
    assert len(sut.trace.segments) == 1
    assert r.per_request_energy_j and all(
        e > 0 for e in r.per_request_energy_j.values())


class SleepyBatches:
    """A fixed-batch stub whose batch takes 10 ms + 5 ms a request: on
    real time, or with ``clock`` (a ``VirtualClock``) by advancing it."""

    batch = 4

    def __init__(self, clock=None):
        self.clock = clock

    def run_batch(self, reqs, now=None):
        dt = 0.01 + 0.005 * len(reqs)
        if self.clock is None:
            time.sleep(dt)
        else:
            self.clock.advance(dt)
        return reqs


def test_measured_fixed_sut_splices_its_batches():
    clock = VirtualClock()
    sut = th.ServeEngineSUT(SleepyBatches(clock), _cfg("port"),
                            name="measured-fixed", make_requests=lambda s: s,
                            energy_meter=_meter(clock))
    r = th.PowerRun(sut, th.Offline(batch=4, min_duration_s=0.6),
                    seed=0).run()
    _check_measured(sut, r)
    starts = [s for s, *_ in sut.trace.segments]
    assert starts[0] == 0.0 and len(starts) == r.outcome.result.n_queries // 4
    assert starts[-1] < r.outcome.result.duration_s
    # the next run lays its batches from t = 0 again
    th.PowerRun(sut, th.Offline(batch=4, min_duration_s=0.1), seed=0).run()
    assert sut.trace.segments[0][0] == 0.0


def test_measured_fixed_sut_refuses_the_sync_server():
    """The synchronous Server's clock counts modeled queueing waits the
    card never ran: a measured fixed-batch run under it is refused."""
    sut = th.ServeEngineSUT(SleepyBatches(), _cfg("port"),
                            name="measured-fixed", make_requests=lambda s: s,
                            energy_meter=_meter())
    with pytest.raises(ValueError, match="synchronous Server"):
        th.PowerRun(sut, th.Server(target_qps=40.0, latency_slo_s=10.0,
                                   mode="sync", min_duration_s=0.1,
                                   min_queries=4), seed=0).run()


# The alignment gates of a measured serve, on a counter that steps every
# COUNTER_S and a draw that falls from 650 W to 90 W 0.15 s into the
# serve: the stack's accelerator Joules within ENERGY_ALIGN_TOL of the
# counter's delta, and the serve's window inside the sampler's readings
# to within one sampling period at each end.
COUNTER_S = 0.02
ENERGY_ALIGN_TOL = 0.03


class VirtualClock:
    """One clock for the counter, the sampler and the stub engine: it
    moves only when the stub ``advance``s it, and on the way every
    ``VirtualSampler`` started on it reads at each of its periods."""

    def __init__(self):
        self.t = 0.0
        self.samplers = []

    def __call__(self):
        return self.t

    def advance(self, dt):
        end = self.t + dt
        while True:
            due = [s for s in self.samplers if s.next_s <= end]
            if not due:
                break
            s = min(due, key=lambda s: s.next_s)
            self.t = s.next_s
            s._read()
            s.next_s = self.t + s.period_s
        self.t = end


class VirtualSampler(EnergySampler):
    """``EnergySampler`` on a ``VirtualClock``: its readings come at
    every period of the clock instead of from a thread's wake-ups, so a
    loaded machine cannot drift them."""

    def start(self):
        if self._thread is not None:
            raise RuntimeError("VirtualSampler.start: already started")
        self._read()
        self.next_s = self.clock() + self.period_s
        self.clock.samplers.append(self)
        self._thread = self.clock
        return self

    def stop(self):
        self.clock.samplers.remove(self)
        self._read()


class LateSlots(SlotStub):
    """The slot stub on a ``VirtualClock``: ``serve`` advances the clock
    through its run, stamping requests from its first ``now`` reading,
    with its t = 0 ``late_s`` after that reading."""

    def __init__(self, clock, late_s):
        super().__init__()
        self.clock, self.late_s = clock, late_s

    def serve(self, reqs, now):
        now()
        self.clock.advance(self.late_s)
        out = super().serve(reqs)
        self.clock.advance(max(r.done_s for r in out))
        return out


class ShiftedTrace(th.MeasuredTrace):
    """A measured trace read ``shift_s`` off the run's t = 0."""

    def __init__(self, energy_meter, shift_s):
        super().__init__(energy_meter)
        self.shift_s = shift_s

    def source(self):
        self._read = True
        return tsut.spliced_source([(start, s.source(t0 + self.shift_s))
                                    for start, s, t0 in self.segments])


def _stepped_serve(late_s=0.0, shift_s=None):
    """A measured serve on one ``VirtualClock``: the counter's steps,
    the sampler's readings and the stub's stamps all read it, so the
    gates see the alignment under test and no scheduling jitter."""
    clock = VirtualClock()
    counter = FakeCounter(watts=(650.0, 90.0), edges=(0.15,),
                          step_s=COUNTER_S, clock=clock)
    meter = functools.partial(VirtualSampler, counter,
                              period_s=COUNTER_S / 2, clock=clock)
    sut = th.ContinuousBatchingSUT(
        LateSlots(clock, late_s), _cfg("port"), name="measured-cb",
        make_request=_make_request("port"), energy_meter=meter)
    if shift_s is not None:
        sut.trace = ShiftedTrace(meter, shift_s)
    r = th.PowerRun(sut, th.Server(target_qps=40.0, latency_slo_s=10.0,
                                   mode="queue", min_duration_s=0.3,
                                   min_queries=8), seed=0).run()
    counter_j = sut.trace.energy_j()
    err = abs(r.per_domain_energy_j["accelerator"] - counter_j) / counter_j
    lead, tail = sut.trace.gaps_s(r.outcome.result.duration_s)
    return err, lead, tail


def test_alignment_gates_pass_an_aligned_serve():
    err, lead, tail = _stepped_serve()
    assert err <= ENERGY_ALIGN_TOL
    assert 0 <= lead <= COUNTER_S / 2 and 0 <= tail <= COUNTER_S / 2


@pytest.mark.parametrize("periods", [1, 3])
def test_alignment_gates_see_a_late_t0(periods):
    """An engine whose t = 0 comes a counter period or more after its
    first clock reading: its window ends that much before the sampler
    stops.  The energy gate alone can miss it (the stack loses the
    serve's last stretch, here at 90 W, which stays within the
    tolerance at one period); the window gate does not."""
    _, lead, tail = _stepped_serve(late_s=periods * COUNTER_S)
    assert 0 <= lead <= COUNTER_S / 2
    assert tail > COUNTER_S / 2


@pytest.mark.parametrize("periods", [-3, -1, 1, 3])
def test_energy_gate_sees_a_shifted_trace(periods):
    """A trace read a counter period or more off the run's t = 0
    integrates another stretch of a stepped draw: the stack misses the
    counter's delta by more than the tolerance."""
    err, _, _ = _stepped_serve(shift_s=periods * COUNTER_S)
    assert err > ENERGY_ALIGN_TOL


def test_spliced_source_reads_each_segment_from_its_start():
    src = tsut.spliced_source([(0.0, lambda t: 10 + t),
                               (1.0, lambda t: 100 + t)])
    assert np.array_equal(src([-1.0, 0.5, 1.0, 3.0]),
                          [9.0, 10.5, 100.0, 102.0])


def test_measured_trace_needs_a_run():
    trace = th.MeasuredTrace(_meter())
    with pytest.raises(RuntimeError, match="nothing was measured"):
        trace.source()
    with pytest.raises(RuntimeError, match="never read now"):
        trace.run(0.0, lambda now: None)


def test_nvml_raises_without_the_library(monkeypatch):
    """No fallback: a library that does not load raises, naming it."""
    monkeypatch.setattr(nvml, "LIBRARY", "libnvidia-ml-missing.so.1")
    with pytest.raises(RuntimeError, match="libnvidia-ml-missing.so.1"):
        NVML("cuda")


def test_nvml_raises_on_this_machine_without_the_driver():
    if ctypes.util.find_library("nvidia-ml"):
        pytest.skip("the NVIDIA driver's NVML library is installed here")
    with pytest.raises(RuntimeError, match="libnvidia-ml.so.1"):
        NVML("cuda")


def test_measured_sampler_thread_ends():
    before = threading.active_count()
    with EnergySampler(FakeCounter(), period_s=0.001):
        time.sleep(0.01)
    assert threading.active_count() == before


class _Ticks:
    """A clock that moves only when told to."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _Waits:
    """``EnergySampler._stop`` on a ``_Ticks`` clock: ``wait(timeout)``
    moves the clock by ``timeout`` and reports a stop after ``n``
    waits."""

    def __init__(self, clock, n):
        self.clock, self.n = clock, n

    def wait(self, timeout):
        self.clock.t += timeout
        self.n -= 1
        return self.n < 0


@pytest.mark.parametrize("stall_at", [None, 5], ids=["slow", "stalled"])
def test_energy_sampler_keeps_its_schedule_through_slow_reads(stall_at):
    """NVML's energy read takes milliseconds on an H100 (a mean of
    3.7-9.4 ms and up to 114 ms a read in ``chip_smoke.py``'s measured
    serves): a sampler that waited a whole period after each read fell
    behind by every read's time, reading up to a quarter fewer times
    than the window has periods.
    On the fixed schedule every reading lands on its period however
    long the reads take (here 0.4 of a period), and after a read that
    takes 2.5 periods one reading catches up and the rest return to the
    schedule."""
    period = 0.05
    clock = _Ticks()
    taken = []

    def reader():
        clock.t += period * (2.5 if len(taken) == stall_at else 0.4)
        taken.append(clock.t)
        return 1000.0 * len(taken)

    s = EnergySampler(reader, period_s=period, clock=clock)
    s._read()                           # start()'s first reading, t = 0
    s._stop = _Waits(clock, 20)
    s._run()
    t = np.asarray(s.t_s)
    on_grid = np.isclose(t / period, np.round(t / period))
    if stall_at is None:
        assert len(t) == 21
        assert np.allclose(t, period * np.arange(len(t)))
    else:
        # the stalled read ends 2.5 periods after it began: the next
        # reading comes at once, the one after on the schedule again
        assert on_grid[:stall_at + 1].all()
        assert not on_grid[stall_at + 1]
        assert on_grid[stall_at + 2:].all()
        assert s.gaps().max() == pytest.approx(2.5 * period)
    assert np.all(np.asarray(s.read_s) == pytest.approx(
        [0.4 * period if i != stall_at else 2.5 * period
         for i in range(len(t))]))


class _InFlight:
    """The sampler's thread, stubbed: ``join`` lands the reading it was
    taking when ``stop()`` came, begun before ``stop()`` and ended after
    ``stop()``'s own reading."""

    def __init__(self, sampler, clock):
        self.sampler, self.clock = sampler, clock

    def start(self):
        pass

    def join(self, timeout=None):
        s = self.sampler
        s._keep(s.stop_s - 0.01, 1e9, 0.2)

    def is_alive(self):
        return False


def test_energy_sampler_times_its_first_and_last_reading_around_the_work(
        monkeypatch):
    """Reads that take 3 periods: every reading is timed when its read
    begins, ``start()``'s and ``stop()``'s alike, and keeps the read's
    time, so the readings' bracket runs from ``start()``'s read's
    beginning to ``stop()``'s read's end and holds the counter's values
    (taken as each read returns) and the work between them (0.4 s): 3
    periods wider than the work at each end, which the alignment gate
    (one period) sees.  A reading the thread was still taking when
    ``stop()`` read is dropped."""
    period = 0.05
    clock = _Ticks()

    def reader():
        clock.t += 3 * period
        return 1000.0 * clock.t

    s = EnergySampler(reader, period_s=period, clock=clock)
    monkeypatch.setattr(nvml.threading, "Thread",
                        lambda **kw: _InFlight(s, clock))
    s.start()
    t0 = clock.t                        # the work begins
    clock.t += 0.4
    end = clock.t                       # and ends
    s.stop()
    assert s.t_s == pytest.approx([t0 - 3 * period, end])
    assert s.stop_s == end
    assert s.read_s == pytest.approx([3 * period, 3 * period])
    assert s.mj == [1000.0 * t0, 1000.0 * (end + 3 * period)]
    first, last = s.bracket()
    assert first == pytest.approx(t0 - 3 * period)
    assert last == pytest.approx(end + 3 * period)
    trace = tsut.MeasuredTrace(lambda: s)
    trace.segments.append((0.0, s, t0))
    lead, tail = trace.gaps_s(end - t0)
    assert lead == pytest.approx(3 * period)
    assert tail == pytest.approx(3 * period)
