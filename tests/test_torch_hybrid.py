"""The port's hybrid family (jamba-v0.1-52b: superblocks of 8 sublayers,
GQA at sublayer 4 and a Mamba mixer at the other 7, a softmax-routed
MoE FFN on even layers and a dense SwiGLU on odd ones) on the CPU
against the JAX reference: the ``superblocks`` parameter and cache
trees, prefill logits and every cache leaf, decode steps, at the
reduced config (one superblock) and at 16 layers (two); the slot
engine token for token, at 4 and 8 slots, offline and on one virtual
clock with every slot draining mid-chunk before later arrivals refill
some; no host read inside a chunk; ``ServeEngine``; the refusals of
paged KV (and so prefix caching, chunked prefill and disaggregation)
and of speculative verify, each beside the reference's own; and the
launcher under PowerRun.

Reduced configs, float32, weights through ``from_jax``.  Tolerance:
float32 1e-4 (tests/test_kernels.py).
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import build_model as jax_build_model
from repro.models.param import init_params as jax_init_params
from repro.serving import ContinuousBatchingEngine as JaxCBE
from repro.serving import DisaggregatedEngine as JaxDE
from repro.serving import PrefillWorker as JaxPW
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch import configs as tcfg
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models.param import from_jax, tree_map
from repro_torch.serving import (ContinuousBatchingEngine,
                                 DisaggregatedEngine, PrefillWorker,
                                 Request, ServeEngine)

# tiny shapes: one intra-op thread each, so that pytest-xdist workers do
# not oversubscribe the CPU that timing-sensitive tests share
torch.set_num_threads(1)

ARCH = "jamba-v0.1-52b"
TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 32
KINDS = ["l0_mamba_moe", "l1_mamba_dense", "l2_mamba_moe",
         "l3_mamba_dense", "l4_attn_moe", "l5_mamba_dense",
         "l6_mamba_moe", "l7_mamba_dense"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _pair(n_layers):
    """The reduced jamba config at ``n_layers``, model and weights in
    both packages."""
    jc = dataclasses.replace(jcfg.reduce_config(jcfg.get_config(ARCH)),
                             n_layers=n_layers)
    tc = dataclasses.replace(tcfg.reduce_config(tcfg.get_config(ARCH)),
                             n_layers=n_layers)
    jm = jax_build_model(jc)
    jp = jax.jit(lambda key: jax_init_params(jm.param_defs(), key))(
        jax.random.PRNGKey(0))
    tm = build_model(tc, "cpu")
    return jm, jp, tm, from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def models():
    return _pair(8)


@pytest.fixture(scope="module", params=[8, 16], ids=["1-superblock",
                                                     "2-superblocks"])
def depths(request, models):
    return models if request.param == 8 else _pair(16)


def test_configs_and_layer_kinds_are_the_reference_ones(models):
    """Full and reduced configs field for field; the layer kinds of the
    whole 32-layer stack (attention at 4 mod 8, MoE on even layers)."""
    jm, _, tm, _ = models
    full = tcfg.get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jcfg.get_config(ARCH))
    assert tm.cfg.n_layers == 8
    assert tm._layer_kinds() == jm._layer_kinds()
    assert [f"l{j}_{k}" for j, k in enumerate(tm._layer_kinds())] == KINDS
    assert build_model(full, "cpu")._layer_kinds() == \
        jax_build_model(jcfg.get_config(ARCH))._layer_kinds()


def test_param_and_cache_trees_are_the_reference_trees(depths):
    """``from_jax`` of the reference tree gives the port's own
    ``param_defs`` tree (keys, shapes, dtypes): ``superblocks`` with one
    stack per sublayer and a leading superblock axis; ``cache_specs``
    equals the reference's, per-slot and scalar ``pos``."""
    jm, _, tm, tp = depths
    n_super = tm.cfg.n_layers // 8
    defs = tree_map(lambda d: (d.shape, d.dtype), tm.param_defs())
    got = tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp)
    assert got == defs
    assert sorted(tp) == ["embed", "final_norm", "lm_head", "superblocks"]
    assert sorted(tp["superblocks"]) == KINDS
    assert tp["superblocks"]["l0_mamba_moe"]["mamba"]["A_log"].shape[0] \
        == n_super
    for per_slot in (False, True):
        want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                            jm.cache_specs(3, 24, per_slot))
        have = tree_map(lambda s: (tuple(s[0]), str(s[1])[6:]),
                        tm.cache_specs(3, 24, per_slot))
        assert have == want


def _leaves_close(tc, jc):
    for key in KINDS:
        for name, leaf in tc["superblocks"][key].items():
            _close(leaf, jc["superblocks"][key][name])
    assert sorted(tc["superblocks"]["l4_attn_moe"]) == ["k", "v"]
    assert sorted(tc["superblocks"]["l0_mamba_moe"]) == ["conv", "h"]


@pytest.mark.parametrize("s", [1, 2, 11])
def test_prefill_logits_and_every_cache_leaf_match_reference(depths, s):
    """Prefill of 2 prompts of ``s`` tokens into 24 rows: logits, and
    every leaf of every sublayer's cache (K/V padded with zeros; each
    Mamba sublayer's h and conv rows, zeros first for a 1- or 2-token
    prompt)."""
    jm, jp, tm, tp = depths
    toks = np.random.default_rng(s).integers(0, 512, (2, s)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill, static_argnames="max_len")(
        jp, {"tokens": jnp.asarray(toks)}, max_len=24)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                        max_len=24)
    _close(tl, jl)
    _leaves_close(tc["layers"], jc["layers"])
    assert int(tc["pos"]) == s


def test_decode_steps_match_reference(depths):
    """Four ragged per-slot decode steps after an 11-token prefill:
    logits and every cache leaf after each step (the Mamba state carried
    in place, K/V written at each slot's depth)."""
    jm, jp, tm, tp = depths
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, (2, 11)).astype(np.int32)
    _, jc = jax.jit(jm.prefill, static_argnames="max_len")(
        jp, {"tokens": jnp.asarray(toks)}, max_len=24)
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                       max_len=24)
    jc = dict(jc, pos=jnp.asarray([11, 6], jnp.int32))
    tc = dict(tc, pos=torch.tensor([11, 6], dtype=torch.int32))
    step = jax.jit(jm.decode_step)
    for _ in range(4):
        nxt = rng.integers(0, 512, (2, 1)).astype(np.int32)
        jl, jc = step(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt).long())
        _close(tl, jl)
        _leaves_close(tc["layers"], jc["layers"])
        assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()


# --- the engines -----------------------------------------------------------

BUDGETS = [9, 3, 12, 7, 6, 10, 4, 8, 2, 11, 5]
LENS = [12, 1, 2, 12, 2, 12, 1, 12, 12, 2, 12]


def _requests(cls):
    """A zero-budget prompt of ``MAX_LEN`` tokens first (retired at
    admission), then 11 prompts of 1-12 tokens with budgets that end
    mid-chunk."""
    rng = np.random.default_rng(4)
    reqs = [cls(rid=0, prompt=rng.integers(0, 512, MAX_LEN),
                max_new_tokens=0)]
    return reqs + [cls(rid=i, prompt=rng.integers(0, 512, n),
                       max_new_tokens=b)
                   for i, (n, b) in enumerate(zip(LENS, BUDGETS), 1)]


def _outputs(eng, requests):
    done = eng.serve(copy.deepcopy(requests), honor_arrivals=False)
    return {r.rid: r.output for r in done}


@pytest.mark.parametrize("n_slots", [4, 8])
def test_engine_token_identical_to_reference(models, n_slots):
    """Contiguous slot engine, offline, chunks of 4: the JAX engine's
    tokens and host copies."""
    jm, jp, tm, tp = models
    kw = dict(max_len=MAX_LEN, n_slots=n_slots, chunk_steps=4)
    jeng = JaxCBE(jm, jp, **kw)
    want = _outputs(jeng, _requests(JaxRequest))
    teng = ContinuousBatchingEngine(tm, tp, device="cpu", **kw)
    assert _outputs(teng, _requests(Request)) == want
    assert teng.host_syncs == jeng.host_syncs
    assert [len(want[i]) for i in range(1, 12)] == BUDGETS


def _clock():
    """A virtual clock: every read ticks 2 ms; ``sleep`` jumps ahead."""
    t = [0.0]

    def now():
        t[0] += 0.002
        return t[0]

    def sleep(dt):
        t[0] += max(0.0, dt)

    return now, sleep


def _waves(cls, n_slots):
    """Three waves, each admitted at once and draining mid-chunk (chunks
    of 4): a full wave of budgets 2-3 at t = 0, three requests at 1 s
    (budgets 9, 6, 3), and one at 2 s (budget 7) beside a zero-budget
    prompt."""
    rng = np.random.default_rng(8)
    plan = ([(0.0, 2 + i % 2) for i in range(n_slots)]
            + [(1.0, 9), (1.0, 6), (1.0, 3), (2.0, 0), (2.0, 7)])
    return [cls(rid=i, prompt=rng.integers(0, 512, 3 + 2 * (i % 4)),
                max_new_tokens=b, arrival_s=a)
            for i, (a, b) in enumerate(plan)]


def _clocked_serve(eng, requests):
    now, sleep = _clock()
    done = eng.serve(copy.deepcopy(requests), now=now, sleep=sleep)
    return {r.rid: (r.output, r.first_token_s, r.done_s) for r in done}


@pytest.mark.parametrize("n_slots", [4, 8])
def test_slots_drained_mid_chunk_then_refilled(models, n_slots):
    """Every slot drains in the middle of a chunk, then later arrivals
    refill the lowest slots while the others stay frozen.  The port runs
    every chunk to its end, where the reference's loop stops once no
    slot is live, so the frozen slots' Mamba states part from the
    reference's (shown on the last drain's state) -- yet tokens, stamps
    on one virtual clock and host copies are the JAX engine's: a frozen
    slot reaches a live one only through expert capacity, which goes to
    the lower slot first, and admission takes the lowest free slot, so
    no slot whose state parted sits below a live one (ROADMAP §C)."""
    jm, jp, tm, tp = models
    kw = dict(max_len=MAX_LEN, n_slots=n_slots, chunk_steps=4)
    jeng = JaxCBE(jm, jp, **kw)
    want = _clocked_serve(jeng, _waves(JaxRequest, n_slots))
    teng = ContinuousBatchingEngine(tm, tp, device="cpu", **kw)
    assert _clocked_serve(teng, _waves(Request, n_slots)) == want
    assert teng.host_syncs == jeng.host_syncs
    h = "superblocks", "l0_mamba_moe", "h"
    got, ref = teng.state["cache"]["layers"], jeng.state["cache"]["layers"]
    for k in h:
        got, ref = got[k], ref[k]
    parted = [not np.allclose(_np(got[:, b]), _np(ref[:, b]), **TOL)
              for b in range(n_slots)]
    assert any(parted)


class _HostRead(AssertionError):
    pass


def test_chunk_makes_no_host_read(models, monkeypatch):
    """Nothing inside a decode chunk reads a tensor back to the host:
    every tensor-to-Python conversion raises while it runs, and the
    tokens are an unguarded engine's."""
    _, _, tm, tp = models
    kw = dict(max_len=MAX_LEN, n_slots=4, chunk_steps=2, device="cpu")
    eng = ContinuousBatchingEngine(tm, tp, **kw)
    inner = eng._decode_chunk
    names = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
             "__float__", "__index__")

    def raiser(name):
        def f(*args, **kw):
            raise _HostRead(f"Tensor.{name} inside _decode_chunk")
        return f

    def guarded(*args):
        with monkeypatch.context() as m:
            for name in names:
                m.setattr(torch.Tensor, name, raiser(name))
            return inner(*args)

    monkeypatch.setattr(eng, "_decode_chunk", guarded)
    reqs = _requests(Request)[1:7]
    got = _outputs(eng, reqs)
    assert got == _outputs(ContinuousBatchingEngine(tm, tp, **kw), reqs)
    assert eng.host_syncs > 1


def test_serve_engine_token_identical_to_reference(models):
    """``ServeEngine.run_batch``: one prefill of three 7-token prompts,
    then lock-step decode."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, 7) for _ in range(3)]

    def reqs(cls):
        return [cls(rid=i, prompt=p, max_new_tokens=b)
                for i, (p, b) in enumerate(zip(prompts, [9, 3, 12]))]

    want = [r.output for r in JaxServeEngine(
        jm, jp, max_len=MAX_LEN, batch_size=3).run_batch(reqs(JaxRequest))]
    got = [r.output for r in ServeEngine(
        tm, tp, max_len=MAX_LEN, batch_size=3,
        device="cpu").run_batch(reqs(Request))]
    assert got == want and [len(o) for o in got] == [9, 3, 12]


@pytest.mark.parametrize("mode", ["paged", "prefix", "chunked"])
def test_paged_modes_are_refused_as_in_the_reference(models, mode):
    """A Mamba sublayer has no page-table path: the paged engine, with
    prefix caching or chunked prefill too, raises
    ``NotImplementedError`` at construction in both packages."""
    jm, jp, tm, tp = models
    kw = dict(max_len=MAX_LEN, n_slots=2, kv_page_size=8)
    kw.update({"paged": {}, "prefix": dict(prefix_caching=True),
               "chunked": dict(prefill_chunk_tokens=4)}[mode])
    with pytest.raises(NotImplementedError, match="paged KV"):
        JaxCBE(jm, jp, **kw)
    with pytest.raises(NotImplementedError, match="paged KV"):
        ContinuousBatchingEngine(tm, tp, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="paged KV"):
        jm.init_paged_cache(2, 9, 8, 4)
    with pytest.raises(NotImplementedError, match="paged KV"):
        tm.init_paged_cache(2, 9, 8, 4)


def test_verify_and_speculative_are_refused_as_in_the_reference(models):
    """No multi-token verify path through a Mamba state: ``verify_step``
    raises in both packages; the port refuses a speculative engine at
    construction, the reference at its first verify."""
    jm, jp, tm, tp = models
    jc = jm.init_cache(1, 16, per_slot_pos=True)
    with pytest.raises(NotImplementedError, match="verify"):
        jm.verify_step(jp, jc, jnp.zeros((1, 3), jnp.int32))
    tc = tm.init_cache(1, 16, per_slot_pos=True)
    with pytest.raises(NotImplementedError, match="verify"):
        tm.verify_step(tp, tc, torch.zeros((1, 3), dtype=torch.long))
    kw = dict(max_len=MAX_LEN, n_slots=2, spec_k=2)
    with pytest.raises(NotImplementedError, match="verify"):
        ContinuousBatchingEngine(tm, tp, device="cpu", draft_model=tm,
                                 draft_params=tp, **kw)
    jeng = JaxCBE(jm, jp, draft_model=jm, draft_params=jp, **kw)
    with pytest.raises(NotImplementedError, match="verify"):
        jeng.serve([JaxRequest(rid=0, prompt=np.arange(5),
                               max_new_tokens=4)], honor_arrivals=False)


def test_disaggregation_is_refused_as_in_the_reference(models):
    """Disaggregated decode installs handoffs into a paged engine, which
    a hybrid stack cannot have (above); given the contiguous engine
    instead, ``DisaggregatedEngine`` refuses it in both packages."""
    jm, jp, tm, tp = models
    kw = dict(max_len=MAX_LEN, n_slots=2)
    with pytest.raises(ValueError, match="must be paged"):
        JaxDE([JaxPW(jm, jp, page_size=8)], JaxCBE(jm, jp, **kw))
    with pytest.raises(ValueError, match="must be paged"):
        DisaggregatedEngine(
            [PrefillWorker(tm, tp, page_size=8, device="cpu")],
            ContinuousBatchingEngine(tm, tp, device="cpu", **kw))


def test_launcher_serves_jamba_on_cpu(capsys):
    """``launch.serve --arch jamba-v0.1-52b`` (its choices are
    ``list_archs()``) under PowerRun's Server, reduced, on the CPU: the
    review ACCEPTS."""
    m = tserve.main(["--arch", ARCH, "--reduce", "--device", "cpu",
                     "--qps", "16", "--min-duration", "2",
                     "--new-tokens", "3", "--slots", "4"])
    out = capsys.readouterr().out
    assert m["review_passed"], out
    assert m["requests"] >= 1 and m["tokens"] == 3 * m["requests"]
