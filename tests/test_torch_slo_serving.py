"""The port's SLO-aware serving on the CPU against the JAX reference:
the ``Scheduler`` policy, the engine's knob checks, chunked prefill
(prompts that cross chunk boundaries: sub-chunk, an exact multiple and
not a multiple; with prefix hits), preemption with park and resume in
the reference's geometry, chunked prefill under speculative decoding,
the guard that a non-final chunk reads nothing back to the host and
writes only the engine's own pool, the guard that a frozen slot writes
only the garbage page, the launcher's ``--prefill-chunk`` and
``--preemption`` under ``PowerRun``, and ``slo_sweep``'s structure.

Both engines run under one virtual clock (every ``now()`` read ticks
it), so that tokens, ``sched_stats`` and every request's stamps must be
equal; no test asserts a wall-clock ordering.  Weights are bridged from
the JAX model (``from_jax``, float32, reduced qwen3-1.7b on the JAX
package's jnp path, as in ``test_torch_paged.py``).
"""
import copy
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import build_model as jax_build_model
from repro.models.param import init_params as jax_init_params
from repro.serving import ContinuousBatchingEngine as JaxCBE
from repro.serving import Request as JaxRequest
from repro.serving import Scheduler as JaxScheduler
from repro.serving import truncate_draft as jax_truncate
from repro_torch import configs as tcfg
from repro_torch.benchmarks import slo_sweep as tsweep
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models.param import from_jax
from repro_torch.serving import (GARBAGE_PAGE, ContinuousBatchingEngine,
                                 Request, Scheduler, truncate_draft)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
from benchmarks import slo_sweep as jsweep  # noqa: E402

# tiny shapes: one intra-op thread each, so that pytest-xdist workers do
# not oversubscribe the CPU that timing-sensitive tests share
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    """The same reduced config, model and weights in both packages."""
    jc = jcfg.reduce_config(jcfg.get_config("qwen3-1.7b"))
    assert not jc.use_pallas                # the reference's jnp path
    jm = jax_build_model(jc)
    jp = jax_init_params(jm.param_defs(), jax.random.PRNGKey(0))
    tm = build_model(tcfg.reduce_config(tcfg.get_config("qwen3-1.7b")),
                     "cpu")
    return jm, jp, tm, from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _req(cls, rid, n_prompt, budget, arrival_s=0.0, priority=0,
         deadline_s=None, prompt=None):
    rng = np.random.default_rng(1_000 + rid)
    return cls(rid=rid, prompt=(rng.integers(0, 512, n_prompt)
                                if prompt is None else prompt),
               max_new_tokens=budget, arrival_s=arrival_s,
               priority=priority, deadline_s=deadline_s)


def _clock():
    """The reference test's virtual clock: every read ticks 2 ms, so
    arrivals trigger while slots decode; ``sleep`` jumps ahead."""
    t = [0.0]

    def now():
        t[0] += 0.002
        return t[0]

    def sleep(dt):
        t[0] += max(0.0, dt)

    return now, sleep


def _jax_engine(models, preemption=None, **kw):
    jm, jp, _, _ = models
    if preemption is not None:
        kw["scheduler"] = JaxScheduler(preemption=preemption)
    return JaxCBE(jm, jp, **kw)


def _port_engine(models, preemption=None, **kw):
    _, _, tm, tp = models
    if preemption is not None:
        kw["scheduler"] = Scheduler(preemption=preemption)
    return ContinuousBatchingEngine(tm, tp, device="cpu", **kw)


def _engines(models, **kw):
    """The JAX and the port engine on the same weights and knobs
    (``Scheduler`` in each package's own copy)."""
    return _jax_engine(models, **kw), _port_engine(models, **kw)


def _record(done):
    return {r.rid: (tuple(r.output), r.first_token_s, r.done_s,
                    r.preemptions, r.cached_tokens, r.prefill_tokens)
            for r in done}


def _tokens(done):
    return {r.rid: tuple(r.output) for r in done}


def _serve_clocked(eng, requests):
    now, sleep = _clock()
    return eng.serve(requests, now=now, sleep=sleep)


# --- Scheduler: the port's copy against the reference -------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scheduler_order_and_victims_match_reference(seed):
    """Seeded request sets (priorities 0-2, deadlines or none, tied
    arrivals): the same admission order at several clock readings and
    the same victim for every candidate, with and without preemption."""
    rng = np.random.default_rng(seed)
    n = 12
    spec = [(int(rng.integers(0, 3)),
             None if rng.random() < 0.3 else float(rng.uniform(0, 2)),
             float(rng.integers(0, 4)) * 0.1) for _ in range(n)]

    def reqs(cls):
        return [cls(rid=i, prompt=np.arange(4), priority=p, deadline_s=d,
                    arrival_s=a) for i, (p, d, a) in enumerate(spec)]

    jr, tr = reqs(JaxRequest), reqs(Request)
    for now_s in (0.0, 0.7, 3.0):
        assert ([r.rid for r in Scheduler().order(tr, now_s)]
                == [r.rid for r in JaxScheduler().order(jr, now_s)])
    running = list(range(0, n, 2))
    for preempt in (False, True):
        js, ts = JaxScheduler(preempt), Scheduler(preempt)
        for c in range(1, n, 2):
            assert ts.pick_victim([(b, tr[b]) for b in running], tr[c]) \
                == js.pick_victim([(b, jr[b]) for b in running], jr[c])
    assert Scheduler.slack_s(tr[0], 1.0) == JaxScheduler.slack_s(jr[0], 1.0)


@pytest.mark.parametrize("kw", [
    dict(prefill_chunk_tokens=8),                        # needs paging
    dict(kv_page_size=8, preemption=True),               # needs prefix
], ids=["chunked-without-paging", "preemption-without-prefix-cache"])
def test_engine_validates_slo_knobs(models, kw):
    """Both packages refuse the same knob combinations."""
    for make in (_jax_engine, _port_engine):
        with pytest.raises(ValueError, match="requires"):
            make(models, max_len=32, n_slots=2, **kw)


# --- chunked prefill ----------------------------------------------------

def _bimodal(cls):
    """A 512-token long (8 chunks of 64), four 16-token shorts (under a
    chunk) arriving while it fills, a 64-token prompt (one whole chunk)
    and a 72-token one (a chunk and 8)."""
    return ([_req(cls, 0, 512, 4)]
            + [_req(cls, 1 + i, 16, 4, arrival_s=0.01 + 0.012 * i)
               for i in range(4)]
            + [_req(cls, 5, 72, 4, arrival_s=0.03),
               _req(cls, 6, 64, 4, arrival_s=0.036)])


def _shared(cls):
    """Prompts behind one 160-token prefix (2.5 chunks): hits start
    chunking at the cached 160."""
    rng = np.random.default_rng(9)
    system = rng.integers(0, 512, 160)
    return [_req(cls, i, 0, 5, arrival_s=0.004 * i,
                 prompt=np.concatenate([system, rng.integers(0, 512, t)]))
            for i, t in enumerate((40, 3, 90, 17))]


TRACES = {
    "bimodal": (_bimodal, dict(max_len=576, n_slots=4, chunk_steps=2,
                               kv_page_size=16, kv_pages=150)),
    "shared-prefix": (_shared, dict(max_len=288, n_slots=2, chunk_steps=2,
                                    kv_page_size=16, prefix_caching=True)),
}


@pytest.fixture(scope="module")
def chunked_runs(models):
    """Each trace through the JAX and the port chunked engine (chunks
    of 64) under one virtual clock, and through the port's monolithic
    engine offline."""
    runs = {}
    for name, (trace, kw) in TRACES.items():
        jeng, teng = _engines(models, prefill_chunk_tokens=64, **kw)
        want = _serve_clocked(jeng, trace(JaxRequest))
        got = _serve_clocked(teng, trace(Request))
        _, mono = _engines(models, **kw)
        runs[name] = dict(
            want=want, got=got, jeng=jeng, teng=teng,
            mono=mono.serve(trace(Request), honor_arrivals=False))
    return runs


@pytest.mark.parametrize("trace", list(TRACES))
def test_chunked_prefill_matches_reference(chunked_runs, trace):
    """Tokens, stamps, per-request prefix accounting, ``sched_stats``,
    ``prefix_stats`` and host syncs equal the JAX chunked engine's."""
    run = chunked_runs[trace]
    jeng, teng = run["jeng"], run["teng"]
    assert _record(run["got"]) == _record(run["want"])
    assert teng.sched_stats == jeng.sched_stats
    assert teng.prefix_stats == jeng.prefix_stats
    assert teng.host_syncs == jeng.host_syncs
    st = teng.sched_stats
    assert st["prefill_chunks"] >= 8 and st["interleaved_chunks"] >= 1
    assert st["decode_chunks"] == teng.host_syncs
    assert st["preemptions"] == st["resumes"] == 0
    if trace == "shared-prefix":
        # the second prompt arrives while the first still fills (its
        # blocks are interned at the final chunk): it misses
        assert teng.prefix_stats["hits"] == 2
    # every slot retired: only the prefix cache's own pages stay
    cached = teng.prefix_cache.n_nodes if teng.prefix_cache else 0
    assert teng.page_pool.used_pages() == cached


@pytest.mark.parametrize("trace", list(TRACES))
def test_chunked_prefill_emits_the_monolithic_tokens(chunked_runs, trace):
    """In float32 the chunked engine emits the whole-prompt prefill's
    tokens for every request."""
    run = chunked_runs[trace]
    assert _tokens(run["got"]) == _tokens(run["mono"])


class _HostRead(AssertionError):
    pass


def test_non_final_chunk_makes_no_host_read_and_writes_the_pool(models,
                                                               monkeypatch):
    """Inside ``_prefill_chunk`` every tensor-to-host conversion raises,
    and the chunk writes the engine's own pool tensors in place (same
    objects, same storage) -- no copy of the pool; the serve still
    emits the monolithic engine's tokens."""
    _, _, tm, tp = models
    kw = dict(max_len=160, n_slots=3, chunk_steps=2, kv_page_size=8,
              device="cpu")
    eng = ContinuousBatchingEngine(tm, tp, prefill_chunk_tokens=16, **kw)
    inner = eng._prefill_chunk
    names = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
             "__float__", "__index__")
    seen = []

    def raiser(name):
        def f(*args, **kwargs):
            raise _HostRead(f"Tensor.{name} inside _prefill_chunk")
        return f

    def guarded(params, state, chunk, table, start):
        pools = state["cache"]["layers"]["blocks"]
        before = {k: (t, t.data_ptr(), t.clone()) for k, t in pools.items()}
        with monkeypatch.context() as m:
            for name in names:
                m.setattr(torch.Tensor, name, raiser(name))
            out = inner(params, state, chunk, table, start)
        for k, (t, ptr, old) in before.items():
            now = out["cache"]["layers"]["blocks"][k]
            assert now is t and now.data_ptr() == ptr
            assert not torch.equal(now, old)          # written in place
        seen.append(start)
        return out

    monkeypatch.setattr(eng, "_prefill_chunk", guarded)
    reqs = [_req(Request, i, n, 5) for i, n in enumerate((70, 16, 33, 48))]
    got = eng.serve(copy.deepcopy(reqs), honor_arrivals=False)
    mono = ContinuousBatchingEngine(tm, tp, **kw)
    assert _tokens(got) == _tokens(mono.serve(copy.deepcopy(reqs),
                                              honor_arrivals=False))
    # 70 = 4 x 16 + 6, 33 = 2 x 16 + 1, 48 = 2 x 16 + 16: eight
    # non-final chunks; each admission's final chunk is the extend
    assert sorted(seen) == [0, 0, 0, 16, 16, 16, 32, 48]
    assert eng.sched_stats["prefill_chunks"] == len(seen) + len(reqs)


# --- preemption: park, resume -------------------------------------------

def _contended(cls):
    """The reference test's trace: two best-effort 12-token prompts fill
    the 8 usable pages; a priority-1 4-token short arrives at 10 ms and
    must park one of them."""
    return [_req(cls, 0, 12, 4, arrival_s=0.0, priority=0),
            _req(cls, 1, 12, 4, arrival_s=0.0, priority=0),
            _req(cls, 2, 4, 4, arrival_s=0.01, priority=1, deadline_s=0.05)]


PREEMPT_KW = dict(max_len=16, n_slots=3, chunk_steps=2, kv_page_size=4,
                  kv_pages=9, prefix_caching=True, preemption=True)


@pytest.mark.parametrize("chunk", [0, 4], ids=["whole", "chunked"])
def test_preempt_park_resume_matches_reference(models, chunk):
    """The reference's geometry (max_len 16, 3 slots, pages of 4, 9
    pages), whole-prompt and chunked prefill: the same tokens, stamps,
    ``sched_stats``, ``prefix_stats``, preemptions per request and
    parked rids as the JAX engine, and the tokens of an uncontended
    run."""
    jeng, teng = _engines(models, prefill_chunk_tokens=chunk, **PREEMPT_KW)
    want = _serve_clocked(jeng, _contended(JaxRequest))
    got = _serve_clocked(teng, _contended(Request))
    assert _record(got) == _record(want)
    assert teng.sched_stats == jeng.sched_stats
    assert teng.prefix_stats == jeng.prefix_stats
    assert teng.sched_stats["preemptions"] >= 1
    assert teng.sched_stats["resumes"] >= 1
    assert sorted(r.rid for r in got) == [0, 1, 2]
    parked = [r for r in got if r.preemptions > 0]
    assert parked and all(r.priority == 0 for r in parked)
    assert ({r.rid for r in parked}
            == {r.rid for r in want if r.preemptions > 0})
    ref = _port_engine(models, max_len=16, n_slots=3, chunk_steps=2,
                       kv_page_size=4, kv_pages=33)
    assert _tokens(got) == _tokens(ref.serve(_contended(Request),
                                             honor_arrivals=False))


@pytest.mark.parametrize("chunk", [0, 4], ids=["whole", "chunked"])
def test_frozen_slots_write_only_the_garbage_page(models, monkeypatch,
                                                  chunk):
    """Around every decode chunk of the contended run: the pool pages
    that changed are the garbage page or pages in the table row of a
    slot that was decoding.  A parked, filling or retired slot keeps
    being stepped by the frozen loop; its row points at the garbage
    page, so its writes never reach a page the pool handed out again
    (``cache_update_window``'s clamp keeps deep positions in range)."""
    _, teng = _engines(models, prefill_chunk_tokens=chunk, **PREEMPT_KW)
    inner = teng._decode_chunk
    checked = []

    def watched(params, state):
        cache = state["cache"]
        pools = [t.clone() for t in cache["layers"]["blocks"].values()]
        table = cache["pages"].clone()
        active = (state["remaining"] > 0).clone()
        out = inner(params, state)
        changed = set()
        for old, new in zip(pools, cache["layers"]["blocks"].values()):
            diff = (old != new).flatten(2).any(-1).any(0)   # (n_pages,)
            changed |= set(torch.nonzero(diff).flatten().tolist())
        allowed = {GARBAGE_PAGE} | set(table[active].flatten().tolist())
        assert changed <= allowed, (changed, allowed)
        checked.append((active.tolist(), sorted(changed)))
        return out

    monkeypatch.setattr(teng, "_decode_chunk", watched)
    got = _serve_clocked(teng, _contended(Request))
    assert teng.sched_stats["preemptions"] >= 1
    assert len(checked) == teng.sched_stats["decode_chunks"] > 0
    # a frozen slot stepped beside active ones in at least one chunk
    assert any(not all(a) for a, _ in checked)
    assert sorted(r.rid for r in got) == [0, 1, 2]


# --- speculative decoding with chunked prefill ----------------------------

def test_speculative_chunked_prefill_matches_reference(models):
    """k = 3 with each package's 2-layer truncated draft, chunks of 8
    over 8-row pages: the same tokens, ``spec_stats``, ``sched_stats``
    and per-request draft/verify/prefill counts as the JAX engine, and
    plain greedy's tokens.  The draft prefills the full prompt at the
    final chunk; the target computes only the chunks."""
    jm, jp, tm, tp = models
    jdm, jdp = jax_truncate(jm, jp, 2)
    tdm, tdp = truncate_draft(tm, tp, 2)
    kw = dict(max_len=64, n_slots=3, chunk_steps=2, kv_page_size=8,
              prefill_chunk_tokens=8)
    jeng = JaxCBE(jm, jp, draft_model=jdm, draft_params=jdp, spec_k=3, **kw)
    teng = ContinuousBatchingEngine(tm, tp, draft_model=tdm,
                                    draft_params=tdp, spec_k=3,
                                    device="cpu", **kw)

    def reqs(cls):
        return [_req(cls, i, n, b, arrival_s=0.003 * i)
                for i, (n, b) in enumerate(((5, 5), (16, 9), (21, 3),
                                            (30, 7), (8, 1), (17, 6)))]

    want = _serve_clocked(jeng, reqs(JaxRequest))
    got = _serve_clocked(teng, reqs(Request))
    assert _record(got) == _record(want)
    for a, b in zip(sorted(got, key=lambda r: r.rid),
                    sorted(want, key=lambda r: r.rid)):
        assert (a.draft_tokens, a.verify_tokens) == (b.draft_tokens,
                                                     b.verify_tokens)
    assert teng.spec_stats == jeng.spec_stats
    assert teng.sched_stats == jeng.sched_stats
    assert teng.spec_stats["draft_prefill_tokens"] == 5 + 16 + 21 + 30 + 8 + 17
    assert teng.sched_stats["prefill_chunks"] > len(got)
    plain = ContinuousBatchingEngine(tm, tp, max_len=64, n_slots=3,
                                     chunk_steps=2, device="cpu")
    assert _tokens(got) == _tokens(plain.serve(reqs(Request),
                                               honor_arrivals=False))


# --- the launcher ---------------------------------------------------------

# 2 s: at the edge analyzer's 10 Hz a shorter window can deliver under
# the 95 % of its samples that R12 asks for (n = int(window x 10))
LAUNCH = ["--arch", "qwen3-1.7b", "--reduce", "--device", "cpu",
          "--min-duration", "2", "--new-tokens", "4", "--qps", "16"]


@pytest.mark.parametrize("flags", [
    ["--kv-page-size", "8", "--prefill-chunk", "8"],
    ["--kv-page-size", "8", "--prefix-cache", "--preemption"],
], ids=["prefill-chunk", "prefix-cache-preemption"])
def test_launcher_slo_options_pass_review_on_cpu(flags, capsys):
    m = tserve.main(LAUNCH + flags)
    out = capsys.readouterr().out
    assert m["review_passed"] is True
    assert m["requests"] >= 1 and m["tokens"] == 4 * m["requests"]
    assert "paged_verify_attention" in out
    if "--prefill-chunk" in flags:
        # 16-token prompts in chunks of 8: two chunks per admission
        assert "scheduler: 0 preemptions, 0 resumes," in out
        assert f"{2 * m['requests']} prefill chunks" in out


@pytest.mark.parametrize("flags, needs", [
    (["--prefill-chunk", "8"], "--kv-page-size"),
    (["--kv-page-size", "8", "--preemption"], "--prefix-cache"),
], ids=["prefill-chunk-without-paging", "preemption-without-prefix-cache"])
def test_launcher_refuses_slo_options_it_cannot_honour(flags, needs, capsys):
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "qwen3-1.7b", "--reduce", "--device", "cpu",
                     *flags])
    assert needs in capsys.readouterr().err


# --- slo_sweep ------------------------------------------------------------

# the sweep's geometry cut for the CPU (both packages alike): the keys and
# rows do not depend on it
SMALL = dict(LONG_LEN=48, SHORT_LEN=8, MAX_LEN=64, PAGE_SIZE=8, KV_PAGES=15,
             SLOTS=4, PREFILL_CHUNK=16)


@pytest.fixture(scope="module")
def sweeps():
    with pytest.MonkeyPatch.context() as m:
        for mod in (jsweep, tsweep):
            for name, value in SMALL.items():
                m.setattr(mod, name, value)
        return {"ref": jsweep.metrics(smoke=True),
                "port": tsweep.metrics(device="cpu", smoke=True)}


def test_sweep_keys_are_the_reference_keys_less_disaggregated(sweeps):
    ref, port = sweeps["ref"], sweeps["port"]
    assert set(port) == set(ref) - {"disaggregated"}
    for name in port:
        assert set(ref[name]) <= set(port[name])
    assert port["calibration"]["device"] == "cpu"
    for name in ("monolithic", "chunked", "chunked_preempt"):
        assert port[name]["review_passed"] is True
        assert port[name]["tokens_per_s"] > 0
        assert "accelerator_j" not in port[name]      # modeled on the CPU
    assert port["chunked_preempt"]["speedup"] > 0


def test_sweep_csv_rows_are_the_reference_rows(sweeps, monkeypatch):
    rows = {}
    # the reference's csv calls its _points, the port's its metrics
    for side, mod, fn in (("ref", jsweep, "_points"),
                          ("port", tsweep, "metrics")):
        monkeypatch.setattr(mod, fn, lambda *a, _m=sweeps[side], **k:
                            copy.deepcopy(_m))
        rows[side] = [r.split(",")[0] for r in mod.csv(smoke=True)]
    assert rows["port"] == [r for r in rows["ref"]
                            if r != "slo_disaggregated"] == [
        "slo_calibration", "slo_monolithic", "slo_chunked",
        "slo_chunked_preempt"]


def test_sweep_geometry_is_the_reference_geometry():
    names = ("LONG_LEN", "SHORT_LEN", "MAX_LEN", "PAGE_SIZE", "SLOTS",
             "KV_PAGES", "CHUNK_STEPS", "PREFILL_CHUNK", "NEW_TOKENS",
             "LONG_PERIOD", "LONG_SLOTS", "SLO_FRAC", "TPOT_FRAC",
             "ATTAIN_BAR", "GRID_X", "GRID_X_FULL", "MID", "SEED")
    assert ({n: getattr(tsweep, n) for n in names}
            == {n: getattr(jsweep, n) for n in names})


def test_sweep_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        tsweep.metrics()
