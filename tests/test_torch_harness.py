"""The port's MLPerf Power harness against the reference's: the same
deterministic SUTs through ``PowerRun`` on both sides, seed 0.

The loadgen clock is virtual (each SUT reports its own latency) and the
analyzers' noise comes from numpy generators seeded the same way, and
the port's ``core``, ``power`` and ``harness`` modules are copies of
the reference's whose only edits are imports.  So queries, Joules,
watts, samples/J and every compliance check's outcome must be equal,
not merely close.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

import repro.core as jcore
import repro.harness as jh
import repro_torch.core as tcore
import repro_torch.harness as th
from repro.configs import get_config as jax_get_config
from repro.core.compliance import SystemDescription as JDesc
from repro.core.loadgen import run_single_stream as j_single
from repro.hw import EDGE_SYSTEM as J_EDGE
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.compliance import SystemDescription as TDesc
from repro_torch.core.loadgen import run_single_stream as t_single
from repro_torch.hw import EDGE_SYSTEM as T_EDGE
from repro_torch.models import tiny as ttiny

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
from benchmarks.tiny_edge_measured import (  # noqa: E402
    full_pipeline_compliance)

SIDES = {"ref": (jh, jcore, JDesc, J_EDGE, jax_get_config),
         "port": (th, tcore, TDesc, T_EDGE, torch_get_config)}

CFG = torch_get_config("tiny-kws")
MACS, SRAM = ttiny.macs(CFG), ttiny.sram_bytes(CFG)


def _edge(Desc, idle=8.0):
    return Desc(scale="edge", max_system_watts=60, idle_system_watts=idle)


def _tiny(side):
    h, *_ = SIDES[side]
    sut = h.TinySUT(lambda: None, macs=MACS, sram_bytes=SRAM,
                    period_s=0.1, name="tiny-kws")
    return sut, h.SingleStream(min_duration_s=2.0, min_queries=200)


def _single(side):
    h, _, Desc, *_ = SIDES[side]
    sut = h.CallableSUT(name="edge-synthetic", issue=lambda s: 0.01,
                        power=42.0, sysdesc=_edge(Desc))
    return sut, h.SingleStream(min_duration_s=66.0)


def _multi(side):
    h, _, Desc, *_ = SIDES[side]
    sut = h.CallableSUT(name="tiny-kws-burst",
                        issue_batch=lambda s: 0.002 + 1e-4 * len(s),
                        power=1.0, sysdesc=_edge(Desc, idle=0.5))
    return sut, h.MultiStream(n_streams=8, min_duration_s=0.5,
                              min_queries=64)


def _offline(side):
    """Rails (accelerator, dram, host) of the edge system under one
    PSU-derived wall, shaped by a throughput-fed work figure."""
    h, core, Desc, edge, get_config = SIDES[side]
    meter = core.SystemPowerModel(edge, 1)
    work = h.throughput_work(get_config("qwen3-1.7b"), 3.0)
    sut = h.CallableSUT(
        name="edge-rails", issue_batch=lambda s: 0.25,
        domains_factory=lambda outcome: h.rail_domains(meter, work),
        psu=meter.psu(), sysdesc=_edge(Desc, idle=1.0))
    return sut, h.Offline(batch=8, min_duration_s=61.0)


def _short(side):
    """A run that stops at a tenth of its declared minimum duration."""
    h, _, Desc, *_ = SIDES[side]
    single = {"ref": j_single, "port": t_single}[side]

    @dataclasses.dataclass
    class ShortStream(h.SingleStream):
        def run(self, sut, qsl, clock=None):
            res = single(sut.issue, qsl,
                         min_duration_s=self.min_duration_s / 10,
                         min_queries=self.min_queries,
                         clock=clock or h.scenarios.Clock())
            return h.ScenarioOutcome("SingleStream", res, res.n_queries)

    sut = h.CallableSUT(name="edge-short", issue=lambda s: 0.01,
                        power=20.0, sysdesc=_edge(Desc))
    return sut, ShortStream(min_duration_s=60.0, min_queries=8)


def _digest(r):
    res = r.outcome.result
    return dict(
        n_queries=res.n_queries, duration_s=res.duration_s, qps=res.qps,
        p90=res.p90, p99=res.p99, energy_j=r.summary.energy_j,
        avg_watts=r.summary.avg_watts, window_s=r.summary.window_s,
        per_node_j=r.summary.per_node_j,
        samples_per_joule=r.samples_per_joule, passed=r.report.passed,
        checks=[(c.rule, c.passed) for c in r.report.checks],
        scale=r.submission.scale, per_domain_watts=r.per_domain_watts)


@pytest.mark.parametrize("make", [_tiny, _single, _multi, _offline],
                         ids=["tiny", "single", "multi", "offline"])
def test_power_run_equals_the_reference(make):
    out = {}
    for side in SIDES:
        sut, scenario = make(side)
        out[side] = _digest(SIDES[side][0].PowerRun(sut, scenario,
                                                    seed=0).run())
    assert out["port"] == out["ref"]
    assert out["port"]["passed"], out["port"]["checks"]
    assert out["port"]["energy_j"] > 0


def test_too_short_a_run_fails_r1_on_both_sides():
    out = {}
    for side in SIDES:
        sut, scenario = _short(side)
        out[side] = _digest(SIDES[side][0].PowerRun(sut, scenario,
                                                    seed=0).run())
    assert out["port"] == out["ref"]
    failed = [rule for rule, ok in out["port"]["checks"] if not ok]
    assert not out["port"]["passed"]
    assert any(rule.startswith("R1") for rule in failed), failed


def test_full_pipeline_compliance_equals_the_reference():
    """``benchmarks/tiny_edge_measured.py:full_pipeline_compliance``'s
    synthetic edge run, through the port's harness."""
    ref = full_pipeline_compliance()
    sut, scenario = _single("port")
    r = th.PowerRun(sut, scenario, seed=0).run()
    assert r.samples_per_joule == ref["samples_per_joule"]
    assert r.passed == ref["review_passed"] is True


def test_io_manager_cross_check_equals_the_reference():
    out = {}
    for side in SIDES:
        core = SIDES[side][1]
        t, amps, pin = core.TinyPowerModel().waveform(
            MACS, SRAM, n_inferences=64, period_s=0.25, sample_hz=50_000)
        out[side] = (core.IOManager().energy_per_inference(t, amps, pin),
                     t, amps, pin)
    (e_ref, n_ref), *ref_wave = out["ref"]
    (e_port, n_port), *port_wave = out["port"]
    for a, b in zip(ref_wave, port_wave):
        assert np.array_equal(a, b)
    assert (e_port, n_port) == (e_ref, n_ref) and n_port == 64


def test_port_hw_holds_no_tpu_figures():
    """The port's chips are the edge SoC and its own H100 (data-sheet
    peaks); none of the reference's TPU chips or systems came along."""
    import repro_torch.hw as thw
    assert set(thw.CHIPS) == {"edge-soc", "h100-sxm"}
    assert set(thw.SYSTEMS) == {"edge", "datacenter-h100"}
    assert not [n for n in dir(thw) if "TPU" in n or "V5E" in n]
    assert not [n for n in list(thw.CHIPS) + list(thw.SYSTEMS)
                if "tpu" in n or "v5" in n or "v4" in n]
    h100 = thw.CHIPS["h100-sxm"]
    assert (h100.peak_flops_bf16, h100.peak_flops_int8, h100.hbm_bandwidth,
            h100.hbm_capacity, h100.peak_watts) == (989e12, 1979e12,
                                                    3.35e12, 80e9, 700.0)
    assert h100.ici_bandwidth * h100.ici_links == 900e9
    assert thw.SYSTEMS["datacenter-h100"].chip is h100
