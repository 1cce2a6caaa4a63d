"""The port's prefill/decode disaggregation (``PrefillWorker``,
``KVHandoff``, ``DisaggregatedEngine``, ``ContinuousBatchingEngine.
_install_slot`` and ``DisaggregatedSUT``) on the CPU against the JAX
reference.

Weights are the reference's seed-0 reduced qwen3-1.7b, bridged with
``from_jax`` (float32, the JAX package's jnp path), and for the
``test_moe_*`` cases reduced qwen3-moe-30b-a3b's, whose tokens are held
to the reference's disaggregated records only (expert capacity couples a
batch's slots, so the colocated engine's batches give other tokens).
Every serve that compares stamps runs both packages on one virtual clock
(every ``now()`` read ticks 2 ms, ``sleep`` jumps ahead) with the
prefill workers' threads run synchronously at ``start`` in both
packages, so the order of the clock's reads, and with it every stamp,
``host_syncs`` and ``decode_chunks``, is fixed; qwen3-1.7b's tokens are
then also held to the port's colocated paged engine, and, with real
worker threads, once more (tokens do not depend on timing).  The test of a
raising worker runs the port alone: the reference's decode loop would
wait for it forever.
"""
import queue
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

import repro.harness as jh
import repro.serving.disagg as jdisagg
import repro_torch.harness as th
import repro_torch.serving.disagg as tdisagg
from repro import configs as jcfg
from repro.hw import EDGE_SYSTEM as J_EDGE
from repro.models import build_model as jax_build_model
from repro.models.param import init_params as jax_init_params
from repro.serving import ContinuousBatchingEngine as JaxCBE
from repro.serving import DisaggregatedEngine as JaxDE
from repro.serving import PrefillWorker as JaxPW
from repro.serving import Request as JaxRequest
from repro_torch import configs as tcfg
from repro_torch.hw import EDGE_SYSTEM as T_EDGE
from repro_torch.models import build_model
from repro_torch.models.param import from_jax
from repro_torch.serving import (ContinuousBatchingEngine,
                                 DisaggregatedEngine, KVHandoff,
                                 PrefillWorker, Request)

torch.set_num_threads(1)

PAGE = 8
# the f32 tolerance of the repo's kernel tests (tests/test_kernels.py:16)
F32 = dict(rtol=1e-4, atol=1e-4)


def _bridged(arch):
    """The same reduced config, model and seed-0 weights in both
    packages."""
    jc = jcfg.reduce_config(jcfg.get_config(arch))
    assert not jc.use_pallas                # the reference's jnp path
    jm = jax_build_model(jc)
    jp = jax_init_params(jm.param_defs(), jax.random.PRNGKey(0))
    tm = build_model(tcfg.reduce_config(tcfg.get_config(arch)), "cpu")
    return jm, jp, tm, from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def models():
    return _bridged("qwen3-1.7b")


@pytest.fixture(scope="module")
def moe_models():
    """Reduced qwen3-moe-30b-a3b: expert capacity follows a call's rows,
    so a disaggregated serve's tokens part from the colocated engine's
    wherever their batches differ (ROADMAP §C: an MoE layer couples
    slots), in the reference as in the port.  Its tests hold the port to
    the reference's own disaggregated records instead."""
    return _bridged("qwen3-moe-30b-a3b")


def _clock():
    t = [0.0]

    def now():
        t[0] += 0.002
        return t[0]

    def sleep(dt):
        t[0] += max(0.0, dt)

    return now, sleep


class _SyncThread:
    """A ``threading.Thread`` stand-in that runs its target at
    ``start``: the workers' shares drain before the decode loop begins,
    in both packages alike."""

    def __init__(self, target, args=(), kwargs=None, daemon=None):
        self.target, self.args, self.kwargs = target, args, kwargs or {}

    def start(self):
        self.target(*self.args, **self.kwargs)

    def join(self, timeout=None):
        pass


@pytest.fixture
def sync_threads(monkeypatch):
    ns = types.SimpleNamespace(Thread=_SyncThread, Event=threading.Event)
    for mod in (jdisagg, tdisagg):
        monkeypatch.setattr(mod, "threading", ns)


def _req(cls, rid, n_prompt, budget, arrival_s=0.0, priority=0):
    rng = np.random.default_rng(3_000 + rid)
    return cls(rid=rid, prompt=rng.integers(0, 512, n_prompt),
               max_new_tokens=budget, arrival_s=arrival_s,
               priority=priority)


# prompts within and across page boundaries, budgets 1 (retires at
# install) to 9; staggered arrivals
MIX = ((5, 5), (16, 9), (21, 3), (8, 1), (30, 7), (3, 6), (17, 4))


def _reqs(cls, arrivals=True):
    return [_req(cls, i, n, b, arrival_s=0.004 * i if arrivals else 0.0)
            for i, (n, b) in enumerate(MIX)]


KW = dict(max_len=48, n_slots=3, chunk_steps=2, kv_page_size=PAGE)


def _jax_disagg(models, n_workers=2, **kw):
    jm, jp, _, _ = models
    dec = JaxCBE(jm, jp, **{**KW, **kw})
    return JaxDE([JaxPW(jm, jp, page_size=PAGE) for _ in range(n_workers)],
                 dec)


def _port_disagg(models, n_workers=2, **kw):
    _, _, tm, tp = models
    dec = ContinuousBatchingEngine(tm, tp, device="cpu", **{**KW, **kw})
    return DisaggregatedEngine(
        [PrefillWorker(tm, tp, page_size=PAGE, device="cpu")
         for _ in range(n_workers)], dec)


def _record(done):
    return {r.rid: (tuple(r.output), r.prefill_start_s, r.first_token_s,
                    r.done_s, r.prefill_tokens) for r in done}


def _tokens(done):
    return {r.rid: tuple(r.output) for r in done}


def _colocated(models, requests, **kw):
    _, _, tm, tp = models
    eng = ContinuousBatchingEngine(tm, tp, device="cpu", **{**KW, **kw})
    return _tokens(eng.serve(requests, honor_arrivals=False))


# --- PrefillWorker --------------------------------------------------------

@pytest.mark.parametrize("n_prompt", [3, 8, 21])
def test_prefill_worker_is_the_reference_worker(models, n_prompt):
    _same_worker(models, n_prompt)


@pytest.mark.parametrize("n_prompt", [3, 8, 21])
def test_moe_prefill_worker_is_the_reference_worker(moe_models, n_prompt):
    _same_worker(moe_models, n_prompt)


def _same_worker(models, n_prompt):
    """The port's handoff blocks within f32 1e-4 of the reference
    worker's, its first token, counts and stamps equal."""
    jm, jp, tm, tp = models
    jr, tr = _req(JaxRequest, 0, n_prompt, 4), _req(Request, 0, n_prompt, 4)
    now, _ = _clock()
    jh_ = JaxPW(jm, jp, page_size=PAGE).prefill(jr, 0.0, now)
    now, _ = _clock()
    worker = PrefillWorker(tm, tp, page_size=PAGE, device="cpu")
    got = worker.prefill(tr, 0.0, now)
    assert isinstance(got, KVHandoff)
    nb = -(-n_prompt // PAGE)
    for name, t in got.blocks.items():
        want = np.asarray(jh_.blocks["blocks"][name])
        assert t.shape == want.shape == (tm.cfg.n_layers, nb, PAGE,
                                         tm.cfg.n_kv_heads,
                                         tm.cfg.head_dim)
        np.testing.assert_allclose(t.numpy(), want, **F32)
    assert sorted(got.blocks) == sorted(jh_.blocks["blocks"])
    assert (got.tok0, got.n_tokens) == (jh_.tok0, jh_.n_tokens)
    assert tr.output == jr.output == [got.tok0]
    assert (tr.prefill_start_s, tr.first_token_s) == (
        jr.prefill_start_s, jr.first_token_s)
    assert 0 < tr.prefill_start_s < tr.first_token_s
    assert tr.prefill_tokens == worker.prefill_tokens == n_prompt


def test_prefill_worker_refuses_what_it_cannot_honour(models):
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="page_size > 0"):
        PrefillWorker(tm, tp, page_size=0, device="cpu")
    with pytest.raises(NotImplementedError, match="§A.8"):
        PrefillWorker(tm, tp, page_size=PAGE, rules={"tp": 2},
                      device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            PrefillWorker(tm, tp, page_size=PAGE)


def test_install_slot_is_the_paged_prefill_without_compute(models):
    """A handoff installed into a slot leaves the pool, table row,
    position, token and budget exactly as the paged prefill into the
    same slot and pages does."""
    _, _, tm, tp = models
    a = ContinuousBatchingEngine(tm, tp, device="cpu", **KW)
    b = ContinuousBatchingEngine(tm, tp, device="cpu", **KW)
    r = _req(Request, 0, 21, 6)
    pages = [7, 3, 11, 5]
    prompt = torch.as_tensor(r.prompt, dtype=torch.long)[None]
    a.state, tok0 = a._prefill_slot(a.params, a.state, prompt, 1, 6, pages)
    h = PrefillWorker(tm, tp, page_size=PAGE, device="cpu").prefill(r, 0.0)
    b.state = b._install_slot(b.state, h.blocks, h.tok0, 1, pages, 21, 6)
    assert int(tok0) == h.tok0
    for name, pool in a.state["cache"]["layers"]["blocks"].items():
        assert torch.equal(pool, b.state["cache"]["layers"]["blocks"][name])
    for key in ("pages", "pos"):
        assert torch.equal(a.state["cache"][key], b.state["cache"][key])
    for key in ("tok", "remaining"):
        assert torch.equal(a.state[key], b.state[key])


# --- DisaggregatedEngine.serve --------------------------------------------

@pytest.mark.parametrize("arrivals", [False, True],
                         ids=["offline", "arrivals"])
def test_serve_is_the_reference_serve(models, sync_threads, arrivals):
    got = _same_serve(models, arrivals)
    assert _tokens(got) == _colocated(models, _reqs(Request))
    assert all(len(r.output) == r.max_new_tokens for r in got)


@pytest.mark.parametrize("arrivals", [False, True],
                         ids=["offline", "arrivals"])
def test_moe_serve_is_the_reference_serve(moe_models, sync_threads,
                                          arrivals):
    """Reduced qwen3-moe-30b-a3b on the virtual clock: the reference's
    disaggregated records (tokens, stamps, prefill tokens), host reads,
    decode chunks and worker accounting; every budget reached."""
    got = _same_serve(moe_models, arrivals)
    assert all(len(r.output) == r.max_new_tokens for r in got)


def _same_serve(models, arrivals):
    """Serve ``MIX`` through both packages' disaggregated engines (two
    synchronous workers, the 2 ms virtual clock) and hold the port's
    records and accounting to the reference's; returns the port's
    requests."""
    jde, tde = _jax_disagg(models), _port_disagg(models)
    now, sleep = _clock()
    want = jde.serve(_reqs(JaxRequest, arrivals), now=now, sleep=sleep,
                     honor_arrivals=arrivals)
    now, sleep = _clock()
    got = tde.serve(_reqs(Request, arrivals), now=now, sleep=sleep,
                    honor_arrivals=arrivals)
    assert _record(got) == _record(want)
    assert [r.rid for r in got] == [r.rid for r in want]
    assert tde.engine.host_syncs == jde.engine.host_syncs > 0
    assert (tde.engine.sched_stats["decode_chunks"]
            == jde.engine.sched_stats["decode_chunks"]
            == tde.engine.host_syncs)
    assert tde.engine.decode_steps == (KW["chunk_steps"]
                                       * tde.engine.host_syncs)
    assert [w.prefill_tokens for w in tde.workers] == [
        w.prefill_tokens for w in jde.workers]
    return got


@pytest.mark.parametrize("n_workers", [1, 2, 3])
def test_threaded_serve_is_the_colocated_serve(models, n_workers):
    """Real worker threads on the wall clock: timing moves the stamps,
    never the tokens."""
    tde = _port_disagg(models, n_workers=n_workers)
    got = tde.serve(_reqs(Request))
    assert _tokens(got) == _colocated(models, _reqs(Request))
    for r in got:
        assert r.prefill_start_s <= r.first_token_s <= r.done_s
        assert r.first_token_s - r.arrival_s >= 0.0
    assert tde.engine.host_syncs == tde.engine.sched_stats["decode_chunks"]


def test_pool_pressure_defers_an_install_until_a_slot_retires(
        models, sync_threads, monkeypatch):
    """A pool of 6 usable pages holds one 30 + 7-token request (5 pages)
    at a time: the next handoff waits until that slot retires, and the
    tokens are the reference's and the colocated engine's."""
    reqs = _pressed(models, monkeypatch)
    assert _tokens(reqs) == _colocated(
        models, [_req(Request, i, n, b) for i, (n, b) in enumerate(PRESSED)])


def test_moe_pool_pressure_defers_an_install_until_a_slot_retires(
        moe_models, sync_threads, monkeypatch):
    """The same pool pressure on reduced qwen3-moe-30b-a3b: the
    reference's installs, deferrals and records."""
    reqs = _pressed(moe_models, monkeypatch)
    assert all(len(r.output) == r.max_new_tokens for r in reqs)


# prompts and budgets of the pool-pressure serve
PRESSED = [(30, 7), (29, 5), (33, 3)]


def _pressed(models, monkeypatch):
    """``PRESSED`` through both packages behind a 7-page pool: the same
    install attempts (a deferred one, then its install) and records;
    returns the port's requests."""
    installs = {}
    for side, mod in (("ref", jdisagg), ("port", tdisagg)):
        install = mod.DisaggregatedEngine._install

        def logged(self, h, *a, _install=install, _side=side):
            ok = _install(self, h, *a)
            installs.setdefault(_side, []).append((h.request.rid, ok))
            return ok

        monkeypatch.setattr(mod.DisaggregatedEngine, "_install", logged)
    reqs = PRESSED
    jde = _jax_disagg(models, kv_pages=7)
    tde = _port_disagg(models, kv_pages=7)
    now, sleep = _clock()
    want = jde.serve([_req(JaxRequest, i, n, b) for i, (n, b)
                      in enumerate(reqs)], now=now, sleep=sleep,
                     honor_arrivals=False)
    now, sleep = _clock()
    got = tde.serve([_req(Request, i, n, b) for i, (n, b)
                     in enumerate(reqs)], now=now, sleep=sleep,
                    honor_arrivals=False)
    assert _record(got) == _record(want)
    assert installs["port"] == installs["ref"]
    assert (1, False) in installs["port"] and (1, True) in installs["port"]
    return got


def test_a_request_that_can_never_fit_raises(models, sync_threads):
    msgs = []
    for make, cls in ((_jax_disagg, JaxRequest), (_port_disagg, Request)):
        de = make(models)
        # a pool of 4 usable pages behind the engine: a 30 + 7-token
        # request needs 5, even with every slot free
        de.engine.page_pool = type(de.engine.page_pool)(5, PAGE)
        with pytest.raises(RuntimeError) as e:
            de.serve([_req(cls, 0, 30, 7)], honor_arrivals=False)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == (
        "request 0 needs more KV pages than the decode pool can ever free "
        "(4 usable pages)")


def test_a_request_past_max_len_raises_value_error(models):
    tde = _port_disagg(models)
    with pytest.raises(ValueError, match=r"request 4: prompt 44 \+ budget "
                                         r"8 tokens exceed max_len 48"):
        tde.serve([_req(Request, 4, 44, 8)], honor_arrivals=False)


def _stub(page_size=4, kvh=2, paged=True, speculative=False):
    cfg = types.SimpleNamespace(n_kv_heads=kvh)
    return types.SimpleNamespace(page_size=page_size, paged=paged,
                                 speculative=speculative,
                                 model=types.SimpleNamespace(cfg=cfg))


@pytest.mark.parametrize("workers, decode, match", [
    ([], _stub(), "needs >= 1 prefill worker"),
    ([_stub()], _stub(paged=False), "must be paged"),
    ([_stub()], _stub(speculative=True), "does not run speculatively"),
    ([_stub(), _stub(page_size=8)], _stub(), "prefill page_size 8 != "
                                             "decode page_size 4"),
    ([_stub(kvh=4)], _stub(), "prefill n_kv_heads 4 != decode n_kv_heads 2"),
], ids=["no-workers", "unpaged", "speculative", "page-size", "kv-heads"])
def test_constructor_refusals_are_the_reference_refusals(workers, decode,
                                                          match):
    msgs = []
    for cls in (JaxDE, DisaggregatedEngine):
        with pytest.raises(ValueError, match=match) as e:
            cls(workers, decode)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_disagg_prefill_share_serves_priority_first():
    """The port of the reference's test: a worker draining its share
    prefills an arrived high-priority short before an earlier-arrived
    best-effort long (no preemption of an in-flight prefill; ties stay
    FIFO)."""
    order = []
    t = [0.0]

    def now():
        return t[0]

    def sleep(dt):
        t[0] += max(0.0, dt)

    worker = types.SimpleNamespace(
        page_size=4,
        model=types.SimpleNamespace(cfg=types.SimpleNamespace(n_kv_heads=2)),
        prefill=lambda r, t0, now_: (order.append(r.rid),
                                     t.__setitem__(0, t[0] + 0.01),
                                     r)[-1])
    deng = DisaggregatedEngine([worker], _stub())
    share = [Request(rid=0, prompt=np.arange(8), max_new_tokens=2,
                     arrival_s=0.0, priority=0),
             Request(rid=1, prompt=np.arange(8), max_new_tokens=2,
                     arrival_s=0.001, priority=0),
             Request(rid=2, prompt=np.arange(8), max_new_tokens=2,
                     arrival_s=0.002, priority=1, deadline_s=0.05)]
    out: queue.Queue = queue.Queue()
    deng._prefill_share(worker, share, out, 0.0, now, sleep, True)
    assert order == [0, 2, 1]
    assert out.qsize() == 3


class _Failing(PrefillWorker):
    """A worker whose ``fail_at``-th prefill raises."""

    def __init__(self, *a, fail_at, **kw):
        super().__init__(*a, **kw)
        self.fail_at, self.calls = fail_at, 0

    def prefill(self, r, t0_s, now=time.monotonic):
        self.calls += 1
        if self.calls == self.fail_at:
            raise RuntimeError(f"prefill of request {r.rid} failed")
        return super().prefill(r, t0_s, now)


@pytest.mark.parametrize("fail_at, arrivals", [(1, False), (2, True)],
                         ids=["first-prefill-offline",
                              "second-prefill-arrivals"])
def test_a_raising_worker_ends_serve_with_its_error(models, fail_at,
                                                    arrivals):
    """The decode loop waits on the handoff queue; a worker that dies
    hands it its error, and ``serve`` raises it within a time limit (the
    reference's loop would block forever, so it is not run here)."""
    _, _, tm, tp = models
    dec = ContinuousBatchingEngine(tm, tp, device="cpu", **KW)
    workers = [PrefillWorker(tm, tp, page_size=PAGE, device="cpu"),
               _Failing(tm, tp, page_size=PAGE, device="cpu",
                        fail_at=fail_at)]
    tde = DisaggregatedEngine(workers, dec)
    out = {}

    def run():
        try:
            tde.serve(_reqs(Request, arrivals), honor_arrivals=arrivals)
        except BaseException as e:        # noqa: BLE001 -- inspected below
            out["error"] = e

    t0 = time.perf_counter()
    runner = threading.Thread(target=run, daemon=True)
    runner.start()
    runner.join(timeout=60.0)
    assert not runner.is_alive(), "serve hung on a dead prefill worker"
    assert time.perf_counter() - t0 < 60.0
    assert isinstance(out.get("error"), RuntimeError)
    assert "prefill of request" in str(out["error"])


# --- DisaggregatedSUT -----------------------------------------------------

SIDES = {"ref": (jh, J_EDGE, jcfg, JaxRequest),
         "port": (th, T_EDGE, tcfg, Request)}


class _StubDisagg:
    """A deterministic stand-in for ``DisaggregatedEngine``: two workers,
    a 4-slot decode engine, stamps from each request's arrival and rid
    (``prefill_start_s`` included)."""

    def __init__(self):
        self.workers = [object(), object()]
        self.engine = types.SimpleNamespace(n_slots=4, sched_stats={})

    def serve(self, reqs):
        for r in reqs:
            r.prefill_start_s = r.arrival_s + 0.004 * (r.rid % 3)
            r.first_token_s = r.prefill_start_s + 0.03 + 0.002 * (r.rid % 5)
            r.done_s = r.first_token_s + 0.012 * r.max_new_tokens
            r.output = [r.rid % 7] * r.max_new_tokens
            r.prefill_tokens = 16 + 8 * (r.rid % 4)
        return list(reqs)


def _sut(side, **kw):
    h, system, cfgs, Req = SIDES[side]

    def make(i, s, a):
        rid = s.get("qid", i)
        return Req(rid=rid, prompt=np.arange(8),
                   max_new_tokens=(4, 12, 6, 9)[rid % 4], arrival_s=a)

    return h.DisaggregatedSUT(
        _StubDisagg(), cfgs.reduce_config(cfgs.get_config("qwen3-1.7b")),
        name="disagg-stub", make_request=make, system=system, **kw)


@pytest.mark.parametrize("qps", [4.0, 16.0])
def test_sut_energy_is_the_reference_energy(qps):
    out = {}
    for side in SIDES:
        h = SIDES[side][0]
        scenario = h.Server(target_qps=qps, latency_slo_s=10.0, mode="queue",
                            min_duration_s=3.0, min_queries=16)
        r = h.PowerRun(_sut(side), scenario, seed=0).run()
        out[side] = dict(
            per_domain=r.per_domain_energy_j, energy=r.summary.energy_j,
            watts=r.summary.avg_watts, passed=r.passed,
            checks=[(c.rule, c.passed, c.detail) for c in r.report.checks],
            per_request=r.per_request_energy_j,
            per_request_domain=r.per_request_domain_energy_j)
    assert out["port"] == out["ref"]
    assert out["port"]["passed"], out["port"]["checks"]
    dom = out["port"]["per_domain"]
    # one accelerator channel per prefill worker, one for the decode
    # engine; each fleet's wall under the derived pdu
    assert list(dom) == [
        "prefill/accelerator/0", "prefill/accelerator/1", "prefill/dram",
        "prefill/host", "prefill/wall", "decode/accelerator", "decode/dram",
        "decode/host", "decode/wall", "pdu"]
    assert dom["pdu"] == pytest.approx(dom["prefill/wall"]
                                       + dom["decode/wall"], rel=1e-9)


def test_sut_refuses_a_measured_meter():
    with pytest.raises(ValueError, match="'disagg-stub'.*measured "
                                         "energy_meter is refused"):
        _sut("port", energy_meter=lambda: None)
    assert th.DisaggregatedSUT is th.sut.DisaggregatedSUT
