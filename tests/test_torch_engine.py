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


@pytest.mark.parametrize("flag", [
    ["--speculative"], ["--kv-page-size", "16"], ["--prefix-cache"],
    ["--prefill-chunk", "32"], ["--preemption"], ["--tp", "4"],
    ["--replicas", "2"]])
def test_launcher_refuses_unported_options(flag, capsys):
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "qwen3-1.7b", "--reduce", "--device", "cpu",
                     *flag])
    assert "ROADMAP" in capsys.readouterr().err


@pytest.mark.parametrize("kw", [dict(spec_k=4), dict(kv_page_size=16),
                                dict(prefix_caching=True),
                                dict(prefill_chunk_tokens=32),
                                dict(scheduler=object())])
def test_engine_refuses_unported_options(kw):
    tm = build_model(tcfg.reduce_config(tcfg.get_config("qwen3-1.7b")),
                     "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContinuousBatchingEngine(tm, tm.init(0), device="cpu", **kw)


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
    """AST guard over src/repro_torch/ and chip_smoke.py."""
    banned = ("jax", "jaxlib", "repro", "ml_dtypes")
    offenders, n_files = [], 0
    for path in _port_files():
        n_files += 1
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
    assert n_files > 10
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
