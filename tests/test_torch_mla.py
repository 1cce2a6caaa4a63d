"""The port's MLA-MoE family (deepseek-v3-671b) on the CPU against the
JAX reference: every absorbed-MLA function (projections, attention over
the latent cache, causal and by per-slot or scalar depth, the query
chunking, prefill and decode with the latent cache write), the
``mla_moe`` parameter tree (two stacks and the MTP subtree), the
model's prefill/decode logits and latent caches, the contiguous engine
(greedy, token-identical), the paged KV and verify paths refused as
the reference refuses them, and a 1,100-token prefill, which the port
runs where the reference's query chunking raises (ROADMAP §C).

Reduced configs, float32, weights through ``from_jax``.  Tolerance:
float32 1e-4 (tests/test_torch_model.py).
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
from repro_torch import configs as tcfg
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models.param import from_jax, tree_map
from repro_torch.serving import ContinuousBatchingEngine, Request

# tiny shapes: one intra-op thread each, so that pytest-xdist workers do
# not oversubscribe the CPU that timing-sensitive tests share
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "deepseek-v3-671b"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def models():
    jc = jcfg.reduce_config(jcfg.get_config(ARCH))
    jm = jax_build_model(jc)
    jp = jax.jit(lambda key: jax_init_params(jm.param_defs(), key))(
        jax.random.PRNGKey(0))
    tm = build_model(tcfg.reduce_config(tcfg.get_config(ARCH)), "cpu")
    return jm, jp, tm, from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_mla_functions_match_reference():
    """``_mla_qc``, ``_mla_attend`` (causal; per-slot and scalar depth),
    ``_mla_attend_chunk``, ``_mla_ol_chunked`` (one chunk and two),
    ``mla_prefill`` and ``mla_decode`` (per-slot and scalar ``pos``, the
    latent cache written in place, a row past the cache dropped)."""
    cfg = jcfg.reduce_config(jcfg.get_config(ARCH))
    jp = jax_init_params(JL.mla_defs(cfg), jax.random.PRNGKey(1))
    tp = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = jax.jit(JL._mla_qc, static_argnums=2)(jx, jp, cfg, jnp.arange(8))
    got = TL._mla_qc(tx, tp, cfg, torch.arange(8))
    for g, w in zip(got, want, strict=True):
        _close(g, w)
    jq, tq = want, tuple(torch.from_numpy(np.array(w)) for w in want)
    attend = jax.jit(JL._mla_attend, static_argnums=4,
                     static_argnames="causal")
    _close(TL._mla_attend(*tq, cfg, causal=True),
           attend(*jq, cfg, causal=True))
    for pos in (np.array([3, 7], np.int32), np.int32(5)):
        _close(TL._mla_attend(*tq, cfg, causal=False,
                              pos=torch.tensor(pos)),
               attend(*jq, cfg, causal=False, pos=jnp.asarray(pos)))
    part = [t[:, 4:] for t in tq[:2]] + list(tq[2:])
    jpart = [t[:, 4:] for t in jq[:2]] + list(jq[2:])
    _close(TL._mla_attend_chunk(*part, cfg, 4),
           jax.jit(JL._mla_attend_chunk, static_argnums=(4, 5))(
               *jpart, cfg, 4))
    for q_chunk in (8, 4):
        _close(TL._mla_ol_chunked(*tq, cfg, q_chunk),
               jax.jit(JL._mla_ol_chunked, static_argnums=(4, 5))(
                   *jq, cfg, q_chunk))
    wo, (wc, wk) = jax.jit(JL.mla_prefill, static_argnums=2)(jx, jp, cfg)
    o, (c, k) = TL.mla_prefill(tx, tp, cfg)
    for g, w in ((o, wo), (c, wc), (k, wk)):
        _close(g, w)
    # decode against a 9-row latent cache: slot 1 at the last row, then
    # a row past it (written nowhere); and a scalar depth
    m = cfg.mla
    cache = {"c_kv": rng.standard_normal((2, 9, m.kv_lora_rank)),
             "k_rope": rng.standard_normal((2, 9, m.qk_rope_head_dim))}
    cache = {n: a.astype(np.float32) for n, a in cache.items()}
    decode = jax.jit(JL.mla_decode, static_argnums=2)
    for pos in (np.array([4, 8], np.int32), np.array([2, 9], np.int32),
                np.int32(6)):
        wo, wc = decode(jx[:, :1], jp, cfg, tree_map(jnp.asarray, cache),
                        jnp.asarray(pos))
        tc = tree_map(lambda a: torch.from_numpy(a.copy()), cache)
        _close(TL.mla_decode(tx[:, :1], tp, cfg, tc, torch.tensor(pos)),
               wo)
        for name in cache:
            _close(tc[name], wc[name])


def test_param_tree_is_the_reference_tree(models):
    """``from_jax`` of the reference tree gives the port's own
    ``param_defs`` tree: ``dense_blocks`` (first_k_dense ``mla_dense``
    layers, FFN of ``d_ff_dense``), ``moe_blocks`` (``mla_moe`` layers
    with the float32 router and the shared expert) and ``mtp``."""
    _, _, tm, tp = models
    defs = tree_map(lambda d: (d.shape, d.dtype), tm.param_defs())
    got = tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp)
    assert got == defs
    assert sorted(tp) == ["dense_blocks", "embed", "final_norm", "lm_head",
                          "moe_blocks", "mtp"]
    assert tp["moe_blocks"]["moe"]["router"].dtype == torch.float32
    assert "shared" in tp["moe_blocks"]["moe"]
    assert tp["dense_blocks"]["ffn"]["w_up"].shape[-1] == \
        tm.cfg.moe.d_ff_dense


def test_prefill_and_decode_match_reference(models):
    """Prefill logits and every latent leaf of both stacks, then a
    ragged per-slot decode step, within 1e-4."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, (2, 11)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill, static_argnames="max_len")(
        jp, {"tokens": jnp.asarray(toks)}, max_len=24)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                        max_len=24)
    _close(tl, jl)
    assert sorted(tc["layers"]) == ["dense_blocks", "moe_blocks"]
    for group, leaves in tc["layers"].items():
        assert sorted(leaves) == ["c_kv", "k_rope"]
        for name, leaf in leaves.items():
            _close(leaf, jc["layers"][group][name])
    ragged = np.array([11, 6], np.int32)
    nxt = rng.integers(0, 512, (2, 1)).astype(np.int32)
    jl, _ = jax.jit(jm.decode_step)(jp, dict(jc, pos=jnp.asarray(ragged)),
                                    jnp.asarray(nxt))
    tl, _ = tm.decode_step(tp, dict(tc, pos=torch.from_numpy(ragged)),
                           torch.from_numpy(nxt).long())
    _close(tl, jl)


def _requests(cls, max_len):
    rng = np.random.default_rng(3)
    reqs = [cls(rid=0, prompt=rng.integers(0, 512, max_len),
                max_new_tokens=0)]
    return reqs + [cls(rid=i, prompt=rng.integers(0, 512, 8),
                       max_new_tokens=b)
                   for i, b in enumerate([9, 3, 12, 7, 6, 10, 4], 1)]


def test_contiguous_engine_token_identical_to_reference(models):
    """Four slots, chunks of 4, budgets ending mid-chunk and a
    zero-budget prompt of exactly ``max_len``: the JAX engine's tokens
    and host copies."""
    jm, jp, tm, tp = models
    kw = dict(max_len=32, n_slots=4, chunk_steps=4)
    jeng = JaxCBE(jm, jp, **kw)
    want = {r.rid: r.output for r in jeng.serve(
        _requests(JaxRequest, 32), honor_arrivals=False)}
    teng = ContinuousBatchingEngine(tm, tp, device="cpu", **kw)
    got = {r.rid: r.output for r in teng.serve(
        _requests(Request, 32), honor_arrivals=False)}
    assert got == want
    assert teng.host_syncs == jeng.host_syncs


def test_paged_and_verify_are_refused_as_in_the_reference(models):
    """An MLA stack has no page-table path and no multi-token verify
    path: the paged engine and ``verify_step`` raise
    ``NotImplementedError`` in both packages, and the port refuses a
    speculative engine at construction."""
    jm, jp, tm, tp = models
    with pytest.raises(NotImplementedError, match="paged KV"):
        JaxCBE(jm, jp, max_len=32, n_slots=2, kv_page_size=8)
    with pytest.raises(NotImplementedError, match="paged KV"):
        ContinuousBatchingEngine(tm, tp, max_len=32, n_slots=2,
                                 kv_page_size=8, device="cpu")
    jc = jm.init_cache(1, 16, per_slot_pos=True)
    with pytest.raises(NotImplementedError, match="verify"):
        jm.verify_step(jp, jc, jnp.zeros((1, 3), jnp.int32))
    tc = tm.init_cache(1, 16, per_slot_pos=True)
    with pytest.raises(NotImplementedError, match="verify"):
        tm.verify_step(tp, tc, torch.zeros((1, 3), dtype=torch.long))
    with pytest.raises(NotImplementedError, match="verify"):
        ContinuousBatchingEngine(tm, tp, max_len=32, n_slots=2,
                                 device="cpu", spec_k=2, draft_model=tm,
                                 draft_params=tp)


def test_long_prefill_runs_where_the_reference_raises(models, monkeypatch):
    """A 1,100-token prompt: the reference's query chunking reshapes by
    1,100 // 1,024 chunks and raises; the port takes the 76-row tail as
    a chunk of its own.  Its logits and latent rows equal the
    reference's with that chunking replaced by one causal pass over all
    queries (the reference's own ``_mla_attend``)."""
    jm, jp, tm, tp = models
    toks = np.random.default_rng(4).integers(0, 512, (1, 1100))
    jtoks = {"tokens": jnp.asarray(toks, jnp.int32)}
    with pytest.raises(TypeError):
        jm.prefill(jp, jtoks, max_len=1100)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                        max_len=1100)
    with monkeypatch.context() as m:
        m.setattr(JL, "_mla_ol_chunked",
                  lambda qa, qr, c, k, cfg, q_chunk=1024: JL._mla_attend(
                      qa, qr, c, k, cfg, causal=True))
        jl, jc = jax.jit(jm.prefill, static_argnames="max_len")(
            jp, jtoks, max_len=1100)
    _close(tl, jl)
    _close(tc["layers"]["moe_blocks"]["c_kv"],
           jc["layers"]["moe_blocks"]["c_kv"])
