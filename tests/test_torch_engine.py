"""The port's serving engines and launcher on the CPU against the JAX
reference (greedy, token-identical on the same weights), plus the
port's guards: no silent CPU default, refused options, and an import
guard that keeps JAX and the reference package out of the port."""
import ast
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import build_model as jax_build_model
from repro.models.param import init_params as jax_init_params
from repro.serving import ContinuousBatchingEngine as JaxCBE
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import attribute_request_energy as jax_attribute
from repro_torch import configs as tcfg
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models.param import from_jax
from repro_torch.serving import (ContinuousBatchingEngine, Request,
                                 ServeEngine, attribute_request_energy)

# tiny shapes: one intra-op thread each, so that pytest-xdist workers do
# not oversubscribe the CPU that timing-sensitive tests share
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _both(arch="qwen3-1.7b"):
    """JAX model (decode through the Pallas kernel, interpret mode) and
    the port's model on the same reduced config and weights."""
    jc = dataclasses.replace(jcfg.reduce_config(jcfg.get_config(arch)),
                             use_pallas=True, pallas_interpret=True)
    jm = jax_build_model(jc)
    jp = jax_init_params(jm.param_defs(), jax.random.PRNGKey(0))
    tm = build_model(tcfg.reduce_config(tcfg.get_config(arch)), "cpu")
    return jm, jp, tm, from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _requests(cls, budgets, prompt_len=8):
    return [cls(rid=i, prompt=np.arange(prompt_len) + 3 * i,
                max_new_tokens=b) for i, b in enumerate(budgets)]


def test_continuous_engine_token_identical_to_reference():
    """Mixed budgets incl. zero, 4 requests through 2 slots (mid-flight
    refill), chunk of 3: same tokens and same host syncs as JAX."""
    jm, jp, tm, tp = _both()
    budgets = [4, 7, 0, 6]
    jeng = JaxCBE(jm, jp, max_len=48, n_slots=2, chunk_steps=3)
    want = {r.rid: r.output for r in jeng.serve(
        _requests(JaxRequest, budgets), honor_arrivals=False)}
    teng = ContinuousBatchingEngine(tm, tp, max_len=48, n_slots=2,
                                    chunk_steps=3, device="cpu")
    done = teng.serve(_requests(Request, budgets), honor_arrivals=False)
    assert {r.rid: r.output for r in done} == want
    assert teng.host_syncs == jeng.host_syncs
    assert teng.decode_steps == teng.host_syncs * teng.chunk_steps
    for r in done:
        assert r.first_token_s is not None and r.done_s is not None
        assert len(r.output) == r.max_new_tokens


def test_continuous_engine_ragged_prompts_and_refill():
    """Prompts of different lengths in flight at once (ragged per-slot
    depths through the decode path), three slots, six requests."""
    jm, jp, tm, tp = _both("granite-3-2b")
    lens, budgets = [5, 13, 8, 3, 11, 9], [6, 3, 9, 5, 1, 7]

    def reqs(cls):
        return [cls(rid=i, prompt=(np.arange(n) * 7 + i) % 512,
                    max_new_tokens=b)
                for i, (n, b) in enumerate(zip(lens, budgets))]

    jeng = JaxCBE(jm, jp, max_len=32, n_slots=3, chunk_steps=4)
    want = {r.rid: r.output
            for r in jeng.serve(reqs(JaxRequest), honor_arrivals=False)}
    teng = ContinuousBatchingEngine(tm, tp, max_len=32, n_slots=3,
                                    chunk_steps=4, device="cpu")
    got = {r.rid: r.output
           for r in teng.serve(reqs(Request), honor_arrivals=False)}
    assert got == want
    assert teng.host_syncs == jeng.host_syncs


def test_serve_engine_token_identical_to_reference():
    jm, jp, tm, tp = _both()
    budgets = [5, 2, 6]
    want = [r.output for r in JaxServeEngine(
        jm, jp, max_len=32, batch_size=3).run_batch(
            _requests(JaxRequest, budgets))]
    got = [r.output for r in ServeEngine(
        tm, tp, max_len=32, batch_size=3, device="cpu").run_batch(
            _requests(Request, budgets))]
    assert got == want


def test_serve_engine_refuses_a_batch_past_max_len():
    """A fixed batch decodes at positions s .. s + max(budget) - 2, so s
    + budget may reach max_len + 1 and no further.  At that boundary the
    port's tokens are the reference's; one token more is refused before
    prefill, naming the request (past it the reference attends to rows
    it no longer writes)."""
    jm, jp, tm, tp = _both()
    budgets = [5, 3]                     # prompt 8: 8 + 5 = max_len + 1
    want = [r.output for r in JaxServeEngine(
        jm, jp, max_len=12, batch_size=2).run_batch(
            _requests(JaxRequest, budgets))]
    eng = ServeEngine(tm, tp, max_len=12, batch_size=2, device="cpu")
    got = [r.output for r in eng.run_batch(_requests(Request, budgets))]
    assert got == want
    assert [len(o) for o in got] == budgets
    reqs = _requests(Request, [5, 6])
    with pytest.raises(ValueError, match="request 1: prompt 8 \\+ budget 6"):
        eng.run_batch(reqs)
    assert all(r.first_token_s is None and r.output is None for r in reqs)


def test_engine_honors_arrivals_on_its_clock():
    """Requests admitted at their arrival times (fake clock): a request
    arriving after the first finished still completes, TTFT >= 0."""
    tm = build_model(tcfg.reduce_config(tcfg.get_config("yi-9b")), "cpu")
    tp = tm.init(seed=3)
    clock = [0.0]

    def now():
        clock[0] += 0.01
        return clock[0]

    def sleep(dt):
        clock[0] += dt

    reqs = [Request(rid=i, prompt=np.arange(6) + i, max_new_tokens=4,
                    arrival_s=a) for i, a in enumerate([0.0, 0.05, 3.0])]
    eng = ContinuousBatchingEngine(tm, tp, max_len=16, n_slots=2,
                                   chunk_steps=2, device="cpu")
    done = eng.serve(reqs, now=now, sleep=sleep)
    assert sorted(r.rid for r in done) == [0, 1, 2]
    for r in done:
        assert r.ttft_s() >= 0 and len(r.output) == 4


def test_request_energy_attribution_matches_reference():
    """Same spans and power samples -> the same joules per request, and
    the shares sum to the busy-interval energy."""
    spans = [(0, 0.0, 0.7), (1, 0.2, 0.5), (2, 0.4, None), (3, 1.5, 2.0)]
    t_s = np.linspace(0.0, 2.0, 21)
    watts = 100.0 + 10.0 * np.sin(t_s)

    def reqs(cls):
        return [cls(rid=i, prompt=np.arange(3), arrival_s=a, done_s=d)
                for i, a, d in spans]

    want = jax_attribute(reqs(JaxRequest), t_s, watts)
    got_reqs = reqs(Request)
    got = attribute_request_energy(got_reqs, t_s, watts)
    assert got.keys() == want.keys()
    for rid in want:
        assert got[rid] == pytest.approx(want[rid], rel=1e-12)
    assert [r.energy_j for r in got_reqs] == [got[i] for i, *_ in spans]
    busy = [i for i in range(20) if t_s[i] < 0.7 or 1.5 <= t_s[i] < 2.0]
    assert sum(got.values()) == pytest.approx(
        sum(watts[i] * (t_s[i + 1] - t_s[i]) for i in busy))


def test_launcher_runs_on_cpu():
    m = tserve.main(["--arch", "qwen3-1.7b", "--reduce", "--device", "cpu",
                     "--qps", "50", "--min-duration", "0.1",
                     "--new-tokens", "4", "--slots", "2"])
    assert m["requests"] >= 1 and m["tokens"] == 4 * m["requests"]
    assert m["ttft_p50_s"] >= 0
    m = tserve.main(["--arch", "granite-3-2b", "--reduce", "--device",
                     "cpu", "--engine", "fixed", "--qps", "50",
                     "--min-duration", "0.05", "--new-tokens", "3"])
    assert m["tokens"] == 3 * m["requests"]


@pytest.mark.parametrize("flag", [["--tp", "4"], ["--replicas", "2"]])
def test_launcher_refuses_unported_options(flag, capsys):
    """``--tp`` and ``--replicas`` each run (tests/test_torch_sharded.py);
    what stays unported of them is the two together (ROADMAP §A.8)."""
    other = ["--replicas", "2"] if flag[0] == "--tp" else ["--tp", "2"]
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "qwen3-1.7b", "--reduce", "--device", "cpu",
                     *flag, *other])
    assert "ROADMAP" in capsys.readouterr().err


def test_default_device_is_cuda_and_never_falls_back():
    """Without ``device`` every entry point asks for CUDA: with no GPU it
    raises; with one, a CPU model under the default engine device is a
    mismatch and raises too."""
    cfg = tcfg.reduce_config(tcfg.get_config("qwen3-1.7b"))
    tm = build_model(cfg, "cpu")
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="device"):
            ContinuousBatchingEngine(tm, tm.init(0))
        return
    for make in (lambda: build_model(cfg),
                 lambda: ContinuousBatchingEngine(tm, tm.init(0)),
                 lambda: ServeEngine(tm, tm.init(0))):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def _port_files():
    src = os.path.join(ROOT, "src", "repro_torch")
    for dirpath, _, names in os.walk(src):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_neither_jax_nor_the_reference_package():
    """AST guard over src/repro_torch/ and chip_smoke.py: neither JAX
    nor the reference package, nor the reference's top-level
    ``benchmarks``, ``examples`` and ``scripts``."""
    banned = ("jax", "jaxlib", "repro", "ml_dtypes", "benchmarks",
              "examples", "scripts")
    offenders, seen = [], set()
    for path in _port_files():
        seen.add(os.path.relpath(path, os.path.join(ROOT, "src")))
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if not node.level else []
            else:
                continue
            for m in mods:
                if m.split(".")[0] in banned:
                    offenders.append(f"{os.path.relpath(path, ROOT)}:"
                                     f"{node.lineno} imports {m}")
    assert len(seen) > 10
    assert {"repro_torch/serving/kv_pages.py",
            "repro_torch/serving/prefix_cache.py",
            "repro_torch/kernels/paged_decode_attention/ops.py",
            "repro_torch/kernels/paged_verify_attention/ops.py",
            "repro_torch/kernels/verify_attention/ops.py",
            "repro_torch/serving/speculative.py",
            "repro_torch/kernels/linear_scan/ops.py",
            "repro_torch/models/rwkv6.py",
            "repro_torch/models/mamba.py",
            "repro_torch/configs/jamba_v0_1_52b.py",
            "repro_torch/configs/phi_3_vision_4_2b.py",
            "repro_torch/configs/edge_vit.py",
            "repro_torch/models/tiny.py",
            "repro_torch/kernels/int8_matmul/ops.py",
            "repro_torch/benchmarks/quantization_efficiency.py",
            "repro_torch/launch/tiny_benchmark.py",
            "repro_torch/hw.py",
            *(f"repro_torch/core/{m}.py" for m in (
                "__init__", "mlperf_log", "loadgen", "analyzer", "director",
                "summarizer", "compliance", "power_model", "efficiency")),
            *(f"repro_torch/power/{m}.py" for m in (
                "__init__", "domains", "psu", "stack", "nvml")),
            "repro_torch/benchmarks/common.py",
            "repro_torch/benchmarks/serving_throughput.py",
            "repro_torch/benchmarks/slo_sweep.py",
            "repro_torch/serving/scheduler.py",
            *(f"repro_torch/faults/{m}.py" for m in (
                "__init__", "plan", "inject")),
            *(f"repro_torch/benchmarks/{m}.py" for m in (
                "resilience", "prefix_cache", "speculative_efficiency")),
            *(f"repro_torch/harness/{m}.py" for m in (
                "__init__", "scenarios", "power_run", "sut")),
            "repro_torch/serving/disagg.py",
            *(f"repro_torch/fleet/{m}.py" for m in (
                "__init__", "traces", "lifecycle", "routing", "controller",
                "simulator", "sut")),
            "repro_torch/launch/fleet.py",
            "repro_torch/benchmarks/fleet_sweep.py",
            *(f"repro_torch/parallel/{m}.py" for m in (
                "__init__", "sharding", "launch")),
            "repro_torch/serving/sharded.py",
            "repro_torch/benchmarks/scale_sweep.py",
            *(f"repro_torch/{m}.py" for m in (
                "optim/__init__", "optim/adamw", "optim/schedule",
                "train/__init__", "train/train_step", "data/__init__",
                "data/pipeline", "checkpoint/__init__", "checkpoint/manager",
                "checkpoint/supervisor", "parallel/pipeline", "launch/train",
                "launch/train_e2e")),
            *(f"repro_torch/launch/{m}.py" for m in (
                "mesh", "opcount", "specs", "roofline", "calibrate",
                "dryrun")),
            "repro_torch/kernels/work.py",
            *(f"repro_torch/benchmarks/{m}.py" for m in (
                "roofline_table", "energy_per_inference", "power_range",
                "accuracy_cost", "scaling_energy", "power_breakdown")),
            "repro_torch/launch/hillclimb.py",
            *(f"repro_torch/benchmarks/{m}.py" for m in (
                "sw_hw_optimizations", "efficiency_trends",
                "tiny_edge_measured", "run")),
            *(f"repro_torch/{m}.py" for m in (
                "examples/__init__", "examples/quickstart",
                "examples/serve_power", "scripts/__init__",
                "scripts/dev_smoke", "scripts/paged_smoke")),
            *(f"repro_torch/analysis/{m}.py" for m in (
                "__init__", "__main__", "contracts", "findings", "kernels",
                "launches", "purity", "runner", "units")),
            "repro_torch/kernels/geometry.py",
            os.path.join("..", "chip_smoke.py")} <= seen
    assert not offenders, offenders


def test_engines_reject_requests_that_do_not_fit():
    tm = build_model(tcfg.reduce_config(tcfg.get_config("qwen3-1.7b")),
                     "cpu")
    tp = tm.init(0)
    eng = ContinuousBatchingEngine(tm, tp, max_len=16, n_slots=1,
                                   device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.serve([Request(rid=0, prompt=np.arange(10), max_new_tokens=7)],
                  honor_arrivals=False)
    fixed = ServeEngine(tm, tp, max_len=16, batch_size=1, device="cpu")
    with pytest.raises(ValueError, match="batch size"):
        fixed.run_batch(_requests(Request, [2, 2]))
