"""The port's vlm family (phi-3-vision-4.2b and edge-vit: a dense GQA
backbone behind a ``patch_proj`` prefix of stubbed patch embeddings) on
the CPU against the JAX reference: configs, the parameter tree leaf for
leaf, prefill logits and K/V rows with ``patch_embeds`` and ``pos`` =
patches + prompt, decode steps after it; ``ServeEngine.run_batch`` with
patch embeddings as ``extra_inputs`` and its refusal one row past
``max_len + 1``; the slot engine text-only, contiguous and speculative
(k = 3, the target's first 2 layers as draft), each token-identical to
the JAX engine on bridged weights, at the reduced config (D 32, G 2)
and at D 96, G 1 (phi-3-vision's head); paged KV (and so prefix caching
and chunked prefill) and disaggregation refused beside the reference's
own refusal (its ``paged_cache_specs`` takes the dense and moe families
only); the launcher.  ``LM(tp_group=...)``'s refusal of a vlm is in
tests/test_torch_model.py.

Reduced configs, float32, weights through ``from_jax``, patch embeddings
float32 from a numpy seed (as the reference's ``data/pipeline.py``
draws them).  Tolerance: float32 1e-4 (tests/test_kernels.py:16).
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
from repro.serving import truncate_draft as jax_truncate
from repro_torch import configs as tcfg
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models.param import from_jax, tree_map
from repro_torch.serving import (ContinuousBatchingEngine,
                                 DisaggregatedEngine, PrefillWorker, Request,
                                 ServeEngine, truncate_draft)

# tiny shapes: one intra-op thread each, so that pytest-xdist workers do
# not oversubscribe the CPU that timing-sensitive tests share
torch.set_num_threads(1)

ARCHS = ["phi-3-vision-4.2b", "edge-vit"]
TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 40
N_PATCHES = 16          # the reduced configs' patches
SPEC_K = 3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _pair(arch, **overrides):
    """The reduced config of ``arch`` (with ``overrides``), model and
    weights in both packages."""
    jc = dataclasses.replace(jcfg.reduce_config(jcfg.get_config(arch)),
                             **overrides)
    tc = dataclasses.replace(tcfg.reduce_config(tcfg.get_config(arch)),
                             **overrides)
    jm = jax_build_model(jc)
    jp = jax.jit(lambda key: jax_init_params(jm.param_defs(), key))(
        jax.random.PRNGKey(0))
    tm = build_model(tc, "cpu")
    return jm, jp, tm, from_jax(jax.tree.map(np.asarray, jp), "cpu")


# the reduced config runs D 32, G 2; phi-3-vision's own head is D 96, G 1
SHAPES = {"reduced": {}, "d96-g1": dict(d_head=96, n_kv_heads=4)}


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _pair(request.param)


@pytest.fixture(scope="module", params=list(SHAPES))
def phi(request):
    """phi-3-vision at the reduced config and at D 96, G 1."""
    return _pair(ARCHS[0], **SHAPES[request.param])


def _patches(seed, b, cfg):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.vlm.n_patches, cfg.vlm.patch_embed_dim or cfg.d_model)
    ).astype(np.float32)


def test_configs_and_parameter_tree_are_the_reference_ones(models):
    """Full and reduced configs field for field (16 patches reduced);
    ``from_jax`` of the reference tree gives the port's own
    ``param_defs`` tree, ``patch_proj`` (d_model, d_model) among its
    leaves; every layer an ``attn_dense`` block."""
    jm, _, tm, tp = models
    name = tm.cfg.name
    assert dataclasses.asdict(tcfg.get_config(name)) == dataclasses.asdict(
        jcfg.get_config(name))
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert tm.cfg.vlm.n_patches == N_PATCHES
    defs = tree_map(lambda d: (d.shape, d.dtype), tm.param_defs())
    got = tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp)
    assert got == defs
    assert sorted(tp) == ["blocks", "embed", "final_norm", "lm_head",
                          "patch_proj"]
    assert tuple(tp["patch_proj"].shape) == (tm.cfg.d_model,) * 2
    assert tm._layer_kinds() == jm._layer_kinds() == ["attn_dense"] * 4


@pytest.mark.parametrize("s", [1, 7])
def test_prefill_with_patches_matches_reference(models, s):
    """Prefill of 2 prompts of ``s`` tokens behind 16 patch embeddings
    into 40 rows: logits, every K/V row (patches first, zeros past them)
    and ``pos`` = 16 + s; without patches the same tokens alone."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(s)
    toks = rng.integers(0, 512, (2, s)).astype(np.int32)
    pe = _patches(s, 2, tm.cfg)
    prefill = jax.jit(jm.prefill, static_argnames="max_len")
    for patches in (True, False):
        jin = {"tokens": jnp.asarray(toks)}
        tin = {"tokens": torch.from_numpy(toks).long()}
        if patches:
            jin["patch_embeds"] = jnp.asarray(pe)
            tin["patch_embeds"] = torch.from_numpy(pe)
        jl, jc = prefill(jp, jin, max_len=MAX_LEN)
        tl, tc = tm.prefill(tp, tin, max_len=MAX_LEN)
        _close(tl, jl)
        for name in ("k", "v"):
            _close(tc["layers"]["blocks"][name], jc["layers"]["blocks"][name])
        assert int(tc["pos"]) == int(jc["pos"]) == s + N_PATCHES * patches


def test_decode_steps_after_patches_match_reference(models):
    """Three decode steps after a patch-prefixed prefill of 5 tokens
    (the tokens alone are embedded): logits, K/V and ``pos`` after each."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (2, 5)).astype(np.int32)
    pe = _patches(3, 2, tm.cfg)
    _, jc = jax.jit(jm.prefill, static_argnames="max_len")(
        jp, {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(pe)},
        max_len=MAX_LEN)
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                            "patch_embeds": torch.from_numpy(pe)},
                       max_len=MAX_LEN)
    step = jax.jit(jm.decode_step)
    for _ in range(3):
        nxt = rng.integers(0, 512, (2, 1)).astype(np.int32)
        jl, jc = step(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt).long())
        _close(tl, jl)
        for name in ("k", "v"):
            _close(tc["layers"]["blocks"][name], jc["layers"]["blocks"][name])
        assert int(tc["pos"]) == int(jc["pos"])


# --- the engines -----------------------------------------------------------

BUDGETS = [9, 3, 12, 7, 6, 10, 4, 8, 2, 11, 5]


def _requests(cls, long_len=MAX_LEN):
    """Text only: a zero-budget prompt of ``long_len`` tokens first
    (retired at admission), then 11 prompts of 12 tokens with budgets
    that end mid-chunk."""
    rng = np.random.default_rng(4)
    reqs = [cls(rid=0, prompt=rng.integers(0, 512, long_len),
                max_new_tokens=0)]
    return reqs + [cls(rid=i, prompt=rng.integers(0, 512, 12),
                       max_new_tokens=b)
                   for i, b in enumerate(BUDGETS, 1)]


def _outputs(eng, requests):
    done = eng.serve(copy.deepcopy(requests), honor_arrivals=False)
    return {r.rid: r.output for r in done}


@pytest.mark.parametrize("n_slots", [4, 8])
def test_slot_engine_text_only_token_identical_to_reference(phi, n_slots):
    """Text-only traffic through the contiguous slot engine
    (``patch_proj`` unused, as in the reference's engine): the JAX
    engine's tokens and host copies, chunks of 4."""
    jm, jp, tm, tp = phi
    kw = dict(max_len=MAX_LEN, n_slots=n_slots, chunk_steps=4)
    jeng = JaxCBE(jm, jp, **kw)
    want = _outputs(jeng, _requests(JaxRequest))
    teng = ContinuousBatchingEngine(tm, tp, device="cpu", **kw)
    assert _outputs(teng, _requests(Request)) == want
    assert teng.host_syncs == jeng.host_syncs
    assert [len(want[i]) for i in range(1, 12)] == BUDGETS


@pytest.mark.parametrize("mode", ["paged", "prefix", "chunked"])
def test_paged_modes_are_refused_as_in_the_reference(phi, mode):
    """The reference's paged KV takes the dense and moe families only (a
    vlm's prefill may put patch rows before the tokens a prefix cache
    keys on): the paged engine, with prefix caching or chunked prefill
    too, raises ``NotImplementedError`` at construction in both
    packages, and so does the paged cache."""
    jm, jp, tm, tp = phi
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


def test_disaggregation_is_refused_as_in_the_reference(phi):
    """Disaggregated decode installs handoffs into a paged engine, which
    a vlm cannot have (above); given the contiguous engine instead,
    ``DisaggregatedEngine`` refuses it in both packages."""
    jm, jp, tm, tp = phi
    kw = dict(max_len=MAX_LEN, n_slots=2)
    with pytest.raises(ValueError, match="must be paged"):
        JaxDE([JaxPW(jm, jp, page_size=8)], JaxCBE(jm, jp, **kw))
    with pytest.raises(ValueError, match="must be paged"):
        DisaggregatedEngine(
            [PrefillWorker(tm, tp, page_size=8, device="cpu")],
            ContinuousBatchingEngine(tm, tp, device="cpu", **kw))


def _draft(jm, jp, tm, tp, n_layers=2):
    """The target's first ``n_layers`` blocks as a separate draft model in
    both packages (``truncate_draft`` takes a dense family only, in both:
    a vlm's is built by hand, sharing embedding, norm and head)."""
    jdm = jax_build_model(dataclasses.replace(jm.cfg, n_layers=n_layers))
    jdp = dict(jp, blocks=jax.tree.map(lambda a: a[:n_layers], jp["blocks"]))
    tdm = build_model(dataclasses.replace(tm.cfg, n_layers=n_layers), "cpu")
    tdp = dict(tp, blocks=tree_map(lambda a: a[:n_layers], tp["blocks"]))
    return jdm, jdp, tdm, tdp


def test_speculative_engine_token_identical_to_reference(phi):
    """k = 3 with the target's first 2 layers as draft: tokens,
    ``spec_stats`` and host copies of the JAX engine; the zero-budget
    prompt sits at ``max_len - k``, so its frozen windows run past the
    cache."""
    jm, jp, tm, tp = phi
    jdm, jdp, tdm, tdp = _draft(jm, jp, tm, tp)
    kw = dict(max_len=MAX_LEN, n_slots=4, chunk_steps=2, spec_k=SPEC_K)
    jeng = JaxCBE(jm, jp, draft_model=jdm, draft_params=jdp, **kw)
    want = _outputs(jeng, _requests(JaxRequest, MAX_LEN - SPEC_K))
    teng = ContinuousBatchingEngine(tm, tp, draft_model=tdm,
                                    draft_params=tdp, device="cpu", **kw)
    assert _outputs(teng, _requests(Request, MAX_LEN - SPEC_K)) == want
    assert teng.spec_stats == jeng.spec_stats
    assert teng.host_syncs == jeng.host_syncs
    with pytest.raises(ValueError, match="dense"):
        jax_truncate(jm, jp, 2)
    with pytest.raises(ValueError, match="dense"):
        truncate_draft(tm, tp, 2)


def _batch(cls, prompt_len, budgets):
    rng = np.random.default_rng(6)
    return [cls(rid=i, prompt=rng.integers(0, 512, prompt_len),
                max_new_tokens=b) for i, b in enumerate(budgets)]


def test_serve_engine_with_patches_token_identical_to_reference(phi):
    """``ServeEngine.run_batch`` with 16 patch embeddings a request as
    ``extra_inputs``: one prefill of patches + 7-token prompts, then
    lock-step decode: the JAX engine's tokens."""
    jm, jp, tm, tp = phi
    pe = _patches(7, 3, tm.cfg)
    budgets = [9, 3, 12]
    want = [r.output for r in JaxServeEngine(
        jm, jp, max_len=MAX_LEN, batch_size=3).run_batch(
            _batch(JaxRequest, 7, budgets),
            extra_inputs={"patch_embeds": jnp.asarray(pe)})]
    got = [r.output for r in ServeEngine(
        tm, tp, max_len=MAX_LEN, batch_size=3, device="cpu").run_batch(
            _batch(Request, 7, budgets),
            extra_inputs={"patch_embeds": torch.from_numpy(pe)})]
    assert got == want and [len(o) for o in got] == budgets


def test_serve_engine_refuses_one_row_past_max_len(phi):
    """Behind 16 patch rows a batch decodes at positions 16 + s .. 16 + s
    + max(budget) - 2, so 16 + s + budget may reach max_len + 1 and no
    further: at that boundary the tokens are the reference's; one more is
    refused before prefill, naming the request and both counts."""
    jm, jp, tm, tp = phi
    pe = _patches(8, 2, tm.cfg)
    budgets = [MAX_LEN + 1 - N_PATCHES - 8, 3]      # 16 + 8 + 17 = 41
    want = [r.output for r in JaxServeEngine(
        jm, jp, max_len=MAX_LEN, batch_size=2).run_batch(
            _batch(JaxRequest, 8, budgets),
            extra_inputs={"patch_embeds": jnp.asarray(pe)})]
    eng = ServeEngine(tm, tp, max_len=MAX_LEN, batch_size=2, device="cpu")
    extra = {"patch_embeds": torch.from_numpy(pe)}
    got = [r.output for r in eng.run_batch(_batch(Request, 8, budgets),
                                           extra_inputs=extra)]
    assert got == want and [len(o) for o in got] == budgets
    reqs = _batch(Request, 8, [3, budgets[0] + 1])
    with pytest.raises(ValueError, match=r"request 1: 16 patch rows \+ "
                                         r"prompt 8 \+ budget 18 tokens "
                                         r"exceed max_len 40 \+ 1"):
        eng.run_batch(reqs, extra_inputs=extra)
    assert all(r.first_token_s is None and r.output is None for r in reqs)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_vlm_text_only_on_cpu(arch):
    """``launch.serve --arch <vlm>`` (its choices are ``list_archs()``)
    under PowerRun's Server, reduced, on the CPU: text-only through the
    slot engine; the review ACCEPTS."""
    assert arch in tcfg.list_archs()
    m = tserve.main(["--arch", arch, "--reduce", "--device", "cpu",
                     "--qps", "16", "--min-duration", "2",
                     "--new-tokens", "3", "--slots", "4"])
    assert m["review_passed"]
    assert m["requests"] >= 1 and m["tokens"] == 3 * m["requests"]
