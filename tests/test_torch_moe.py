"""The port's MoE family (qwen3-moe-30b-a3b) on the CPU against the JAX
reference: routing (softmax and sigmoid, exact ties), the sort-based
capacity dispatch with drops, the MoE layer with and without a shared
expert, the model's prefill/decode/verify logits and caches, and the
engines -- greedy, token-identical to the JAX ``ContinuousBatchingEngine``
contiguous, paged, paged with prefix caching, with chunked prefill and
speculative (a qwen3-1.7b draft), at 4 and at 8 slots, and to its
``ServeEngine`` -- with no host read inside a chunk, and the launcher.

An MoE layer's expert capacity follows the number of rows in its call,
so a slot's tokens depend on what the other rows of the batch hold,
retired and never-used slots included: every request set here has
slots retiring in the middle of a chunk and slots left empty across
chunks, and one zero-budget prompt of exactly ``max_len`` tokens (a
retired slot whose frozen decode writes fall past the cache).  Parity
is per mode, port against reference.

Reduced configs, float32, weights through ``from_jax``, references on
the jnp path (``use_pallas=False``).  Tolerance: float32 1e-4
(tests/test_torch_model.py).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.models.param import init_params as jax_init_params
from repro.serving import ContinuousBatchingEngine as JaxCBE
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import truncate_draft as jax_truncate
from repro_torch import configs as tcfg
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models.param import from_jax
from repro_torch.serving import (ContinuousBatchingEngine, Request,
                                 ServeEngine, truncate_draft)

# tiny shapes: one intra-op thread each, so that pytest-xdist workers do
# not oversubscribe the CPU that timing-sensitive tests share
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "qwen3-moe-30b-a3b"
MAX_LEN = 32
SPEC_K = 4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _pair(arch, key=0):
    """The same reduced config, model and weights in both packages."""
    jc = jcfg.reduce_config(jcfg.get_config(arch))
    jm = jax_build_model(jc)
    jp = jax.jit(lambda k: jax_init_params(jm.param_defs(), k))(
        jax.random.PRNGKey(key))
    tm = build_model(tcfg.reduce_config(tcfg.get_config(arch)), "cpu")
    return jm, jp, tm, from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def models():
    return _pair(ARCH)


@pytest.fixture(scope="module")
def drafts():
    """A reduced qwen3-1.7b (the same vocabulary) as the draft, its own
    weights."""
    return _pair("qwen3-1.7b", key=1)


# --- layer functions -----------------------------------------------------

@pytest.mark.parametrize("router_type", ["softmax", "sigmoid"])
def test_route_matches_reference_with_exact_ties(router_type):
    """Top-k gates, experts and aux.  Router columns 1 = 4 and 2 = 6
    give every row exact score ties, which ``jax.lax.top_k`` breaks
    toward the lower expert; rows of zeros tie all experts."""
    mo = tcfg.reduce_config(tcfg.get_config(ARCH)).moe
    rng = np.random.default_rng(0)
    w = rng.standard_normal((16, mo.n_experts)).astype(np.float32)
    w[:, 4], w[:, 6] = w[:, 1], w[:, 2]
    x = rng.standard_normal((12, 16)).astype(np.float32)
    x[3] = 0.0
    want = jax.jit(JL._route, static_argnums=(2, 3))(
        jnp.asarray(x), jnp.asarray(w), mo, router_type)
    got = TL._route(torch.from_numpy(x), torch.from_numpy(w), mo,
                    router_type)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), **TOL)
    np.testing.assert_allclose(_np(got[2]), _np(want[2]), **TOL)
    assert (got[1][3] == torch.arange(mo.top_k)).all()   # all tied
    for row in got[1].tolist():      # a tied twin only after its lower one
        assert (4 not in row or 1 in row) and (6 not in row or 2 in row)


@pytest.mark.parametrize("capacity", [1, 2, 40])
def test_moe_local_matches_reference_with_drops(capacity):
    """Capacity 1 and 2 drop most assignments of 20 tokens x top-2 over
    8 experts (demand 5 a expert); 40 drops none."""
    rng = np.random.default_rng(1)
    n, d, f, e, k = 20, 16, 24, 8, 2
    x = rng.standard_normal((n, d)).astype(np.float32)
    topi = np.stack([rng.permutation(e)[:k] for _ in range(n)]).astype(
        np.int32)
    topv = rng.random((n, k)).astype(np.float32)
    wg, wu = (rng.standard_normal((e, d, f)).astype(np.float32) * 0.3
              for _ in range(2))
    wd = rng.standard_normal((e, f, d)).astype(np.float32) * 0.3
    args = (x, topv, topi, wg, wu, wd)
    want = jax.jit(JL._moe_local, static_argnums=6)(
        *map(jnp.asarray, args), capacity)
    got = TL._moe_local(*(torch.from_numpy(a) for a in args), capacity)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    counts = np.bincount(topi.reshape(-1), minlength=e)
    assert (counts > capacity).any() == (capacity < 40)


@pytest.mark.parametrize("arch,router_type", [
    (ARCH, "softmax"), ("deepseek-v3-671b", "sigmoid")])
@pytest.mark.parametrize("fn", ["moe_ffn", "moe_decode"])
def test_moe_layer_matches_reference(arch, router_type, fn):
    """The MoE layer over a (B, S, d) batch (prefill's shape) and a
    (B, 1, d) one (decode's): qwen3-moe's softmax router, and
    DeepSeek-V3's sigmoid router with the shared expert."""
    cfg = jcfg.reduce_config(jcfg.get_config(arch))
    jmoe = jax_init_params(JL.moe_defs(cfg), jax.random.PRNGKey(5))
    tmoe = from_jax(jax.tree.map(np.asarray, jmoe), "cpu")
    assert ("shared" in tmoe) == (arch != ARCH)
    rng = np.random.default_rng(2)
    for shape in ((2, 7), (8, 1)):
        x = rng.standard_normal((*shape, cfg.d_model)).astype(np.float32)
        wy, waux = jax.jit(getattr(JL, fn), static_argnums=(2, 3))(
            jnp.asarray(x), jmoe, cfg, router_type)
        gy, gaux = getattr(TL, fn)(torch.from_numpy(x), tmoe, cfg,
                                   router_type)
        np.testing.assert_allclose(_np(gy), _np(wy), **TOL)
        np.testing.assert_allclose(_np(gaux), _np(waux), **TOL)


def test_prefill_decode_and_verify_match_reference(models):
    """Prefill (logits and every K/V leaf), a ragged per-slot decode step
    and a 5-token verify window (logits and K/V), within 1e-4."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (3, 11)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill, static_argnames="max_len")(
        jp, {"tokens": jnp.asarray(toks)}, max_len=24)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                        max_len=24)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for name, leaf in tc["layers"]["blocks"].items():
        np.testing.assert_allclose(_np(leaf),
                                   _np(jc["layers"]["blocks"][name]), **TOL)
    ragged = np.array([11, 7, 9], np.int32)
    jc = dict(jc, pos=jnp.asarray(ragged))
    tc = dict(tc, pos=torch.from_numpy(ragged))
    nxt = rng.integers(0, 512, (3, 1)).astype(np.int32)
    jl, jc = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(nxt))
    tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt).long())
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    window = rng.integers(0, 512, (3, 5)).astype(np.int32)
    jl, jc = jax.jit(jm.verify_step)(jp, jc, jnp.asarray(window))
    tl, tc = tm.verify_step(tp, tc, torch.from_numpy(window).long())
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for name, leaf in tc["layers"]["blocks"].items():
        np.testing.assert_allclose(_np(leaf),
                                   _np(jc["layers"]["blocks"][name]), **TOL)


# --- the engines -----------------------------------------------------------

BUDGETS = [9, 3, 12, 7, 6, 10, 4, 8, 2, 11, 5]


def _requests(cls, long_len=MAX_LEN):
    """A zero-budget prompt of ``long_len`` tokens first (retired at
    admission), then 11 prompts of 12 tokens, the first six sharing an
    8-token prefix (one page), with budgets that end mid-chunk."""
    rng = np.random.default_rng(4)
    shared = rng.integers(0, 512, 8)
    reqs = [cls(rid=0, prompt=rng.integers(0, 512, long_len),
                max_new_tokens=0)]
    for i, b in enumerate(BUDGETS, 1):
        head = shared if i <= 6 else rng.integers(0, 512, 8)
        reqs.append(cls(rid=i, prompt=np.concatenate(
            [head, rng.integers(0, 512, 4)]), max_new_tokens=b))
    return reqs


def _outputs(eng, requests):
    done = eng.serve(copy.deepcopy(requests), honor_arrivals=False)
    return {r.rid: r.output for r in done}


MODES = {"contiguous": {},
         "paged": dict(kv_page_size=8),
         "prefix": dict(kv_page_size=8, prefix_caching=True),
         "chunked": dict(kv_page_size=8, prefill_chunk_tokens=4)}


@pytest.mark.parametrize("n_slots", [4, 8])
@pytest.mark.parametrize("mode", MODES)
def test_engine_token_identical_to_reference(models, mode, n_slots):
    """Each mode's tokens equal the JAX engine's in the same mode, with
    the same host copies; prefix caching hits five of the six shared
    prompts in both."""
    jm, jp, tm, tp = models
    kw = dict(max_len=MAX_LEN, n_slots=n_slots, chunk_steps=4,
              **MODES[mode])
    jeng = JaxCBE(jm, jp, **kw)
    want = _outputs(jeng, _requests(JaxRequest))
    teng = ContinuousBatchingEngine(tm, tp, device="cpu", **kw)
    assert _outputs(teng, _requests(Request)) == want
    assert teng.host_syncs == jeng.host_syncs
    assert [len(want[i]) for i in range(1, 12)] == BUDGETS
    assert teng.prefix_stats == jeng.prefix_stats
    if mode == "prefix":
        assert teng.prefix_stats["hits"] == 5


@pytest.mark.parametrize("n_slots", [4, 8])
def test_speculative_engine_token_identical_to_reference(models, drafts,
                                                         n_slots):
    """k = 4 with a qwen3-1.7b draft (the target has no truncated draft:
    both packages refuse one): the tokens, ``spec_stats`` and host
    copies of the JAX engine.  The zero-budget prompt sits at
    ``max_len - k``, so its frozen windows run past the cache."""
    jm, jp, tm, tp = models
    jdm, jdp, tdm, tdp = drafts
    kw = dict(max_len=MAX_LEN, n_slots=n_slots, chunk_steps=2,
              spec_k=SPEC_K)
    jeng = JaxCBE(jm, jp, draft_model=jdm, draft_params=jdp, **kw)
    reqs = _requests(JaxRequest, MAX_LEN - SPEC_K)
    want = _outputs(jeng, reqs)
    teng = ContinuousBatchingEngine(tm, tp, draft_model=tdm,
                                    draft_params=tdp, device="cpu", **kw)
    assert _outputs(teng, _requests(Request, MAX_LEN - SPEC_K)) == want
    assert teng.spec_stats == jeng.spec_stats
    assert teng.host_syncs == jeng.host_syncs
    with pytest.raises(ValueError, match="dense"):
        jax_truncate(jm, jp, 2)
    with pytest.raises(ValueError, match="dense"):
        truncate_draft(tm, tp, 2)


def test_serve_engine_token_identical_to_reference(models):
    """``ServeEngine.run_batch``: one prefill of the batch (the capacity
    of its B * S rows), then lock-step decode of B rows."""
    jm, jp, tm, tp = models
    reqs = _requests(Request)[1:4]
    want = [r.output for r in JaxServeEngine(jm, jp, max_len=MAX_LEN,
                                             batch_size=3).run_batch(
        _requests(JaxRequest)[1:4])]
    got = [r.output for r in ServeEngine(tm, tp, max_len=MAX_LEN,
                                         batch_size=3,
                                         device="cpu").run_batch(reqs)]
    assert got == want and [len(o) for o in got] == BUDGETS[:3]


class _HostRead(AssertionError):
    pass


@pytest.mark.parametrize("chunk", ["_spec_chunk", "_decode_chunk"])
def test_chunk_makes_no_host_read(models, drafts, monkeypatch, chunk):
    """With an MoE target nothing inside a chunk reads a tensor back to
    the host (the expert counts come from ``scatter_add_``, not
    ``bincount``): every tensor-to-Python conversion raises while the
    chunk runs, and the tokens are an unguarded engine's."""
    _, _, tm, tp = models
    _, _, tdm, tdp = drafts
    spec = (dict(draft_model=tdm, draft_params=tdp, spec_k=SPEC_K)
            if chunk == "_spec_chunk" else {})
    kw = dict(max_len=MAX_LEN, n_slots=4, chunk_steps=2, device="cpu",
              **spec)
    eng = ContinuousBatchingEngine(tm, tp, **kw)
    inner = getattr(eng, chunk)
    names = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
             "__float__", "__index__")

    def raiser(name):
        def f(*args, **kw):
            raise _HostRead(f"Tensor.{name} inside {chunk}")
        return f

    def guarded(*args):
        with monkeypatch.context() as m:
            for name in names:
                m.setattr(torch.Tensor, name, raiser(name))
            return inner(*args)

    monkeypatch.setattr(eng, chunk, guarded)
    reqs = _requests(Request, MAX_LEN - SPEC_K)[1:7]
    got = _outputs(eng, reqs)
    assert got == _outputs(ContinuousBatchingEngine(tm, tp, **kw), reqs)
    assert eng.host_syncs > 1


def test_launcher_serves_moe_on_cpu():
    """``launch.serve --arch qwen3-moe-30b-a3b`` (its choices are
    ``list_archs()``) under PowerRun, reduced, on the CPU."""
    m = tserve.main(["--arch", ARCH, "--reduce", "--device", "cpu",
                     "--qps", "50", "--min-duration", "0.1",
                     "--new-tokens", "4", "--slots", "4"])
    assert m["requests"] >= 1 and m["tokens"] == 4 * m["requests"]
