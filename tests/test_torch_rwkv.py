"""The port's rwkv6 family on the CPU against the JAX reference: config
and parameter tree, the weight bridge, each RWKV-6 function, the state
handed from prefill to decode, and the serving engines token for token
on the same weights (float32, reduced config: 4 layers, width 128, 4
heads of 32 padded to 16); and the reference's refusals of verify and
paged KV for a recurrent state."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import build_model as jax_build_model
from repro.models import rwkv6 as JR
from repro.models.param import init_params as jax_init_params
from repro.serving import ContinuousBatchingEngine as JaxCBE
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch import configs as tcfg
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models import rwkv6 as TR
from repro_torch.models.param import from_jax, tree_leaves, tree_map
from repro_torch.serving import (ContinuousBatchingEngine, Request,
                                 ServeEngine)

# tiny shapes: one intra-op thread each, so that pytest-xdist workers do
# not oversubscribe the CPU that timing-sensitive tests share
torch.set_num_threads(1)

ARCH = "rwkv6-3b"
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _models(**overrides):
    """The same reduced rwkv6 config, model and weights in both
    packages."""
    jc = jcfg.reduce_config(jcfg.get_config(ARCH))
    tc = tcfg.reduce_config(tcfg.get_config(ARCH))
    if overrides:
        jc = dataclasses.replace(jc, **overrides)
        tc = dataclasses.replace(tc, **overrides)
    jm = jax_build_model(jc)
    jp = jax_init_params(jm.param_defs(), jax.random.PRNGKey(0))
    tm = build_model(tc, "cpu")
    return jm, jp, tm, from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def models():
    return _models()


def test_config_and_param_tree_match_reference():
    """Full and reduced configs equal the reference's; the parameter
    trees have the same leaves, shapes and dtypes (48 padded heads of
    64 at full width, 16 of 32 reduced), and full width holds 3.284 B
    parameters."""
    for cut in (lambda c: c, tcfg.reduce_config):
        cfg = cut(tcfg.get_config(ARCH))
        jc = (jcfg.reduce_config if cut is tcfg.reduce_config
              else (lambda c: c))(jcfg.get_config(ARCH))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jc)
        assert TR.padded_heads(cfg) == JR.padded_heads(jc)
        tdefs = build_model(cfg, "cpu").param_defs()
        jdefs = jax_build_model(jc).param_defs()
        got = tree_map(lambda d: (d.shape, d.dtype), tdefs)
        want = jax.tree.map(lambda d: (d.shape, d.dtype), jdefs,
                            is_leaf=lambda x: hasattr(x, "init"))
        assert got == want
    full = tcfg.get_config(ARCH)
    assert TR.padded_heads(full) == 48 and full.head_dim == 64
    n = sum(math.prod(d.shape) for d in tree_leaves(
        build_model(full, "cpu").param_defs()))
    assert n == 3_284_126_208


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_jax_round_trip_is_bit_exact_on_the_rwkv_tree(dtype):
    jm, jp, tm, tp = _models(dtype=dtype)
    jleaves, tleaves = jax.tree.leaves(jp), tree_leaves(tp)
    assert len(jleaves) == len(tleaves)
    for a, t in zip(jleaves, tleaves):
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
    defs = tree_map(lambda d: (d.shape, d.dtype), tm.param_defs())
    assert tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp) == defs


def test_rwkv_functions_match_reference(models):
    """``_group_norm``, ``time_mix`` (output and final state),
    ``time_mix_decode`` (output and the state it leaves, updated in
    place) and ``channel_mix`` (sequence and carried row), on layer 1's
    weights, within 1e-4."""
    jm, jp, tm, tp = models
    cfg = tm.cfg
    hp = TR.padded_heads(cfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((hp * cfg.head_dim,)).astype(np.float32)
    xg = rng.standard_normal((2, 9, hp * cfg.head_dim)).astype(np.float32)
    np.testing.assert_allclose(
        _np(TR._group_norm(torch.from_numpy(xg), torch.from_numpy(w), hp)),
        _np(JR._group_norm(jnp.asarray(xg), jnp.asarray(w), hp)), **TOL)

    jt = jax.tree.map(lambda a: a[1], jp["blocks"]["time"])
    tt = tree_map(lambda a: a[1], tp["blocks"]["time"])
    jch = jax.tree.map(lambda a: a[1], jp["blocks"]["chan"])
    tch = tree_map(lambda a: a[1], tp["blocks"]["chan"])
    xt = torch.from_numpy(x)
    want, want_s = JR.time_mix(jnp.asarray(x), jt, jm.cfg, return_state=True)
    got, got_s = TR.time_mix(xt, tt, cfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(got_s), _np(want_s), **TOL)

    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    xp = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    S = np.asarray(want_s)
    want, wst = JR.time_mix_decode(jnp.asarray(x1), jt, jm.cfg,
                                   {"S": jnp.asarray(S),
                                    "x_prev": jnp.asarray(xp)})
    st = torch.from_numpy(S.copy())
    got, gst = TR.time_mix_decode(torch.from_numpy(x1), tt, cfg,
                                  {"S": st, "x_prev": torch.from_numpy(xp)})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert gst["S"] is st
    np.testing.assert_allclose(_np(st), _np(wst["S"]), **TOL)
    np.testing.assert_array_equal(_np(gst["x_prev"]), x1)

    np.testing.assert_allclose(
        _np(TR.channel_mix(xt, tch)),
        _np(JR.channel_mix(jnp.asarray(x), jch)), **TOL)
    np.testing.assert_allclose(
        _np(TR.channel_mix(torch.from_numpy(x1), tch, torch.from_numpy(xp))),
        _np(JR.channel_mix(jnp.asarray(x1), jch, jnp.asarray(xp))), **TOL)


@pytest.mark.parametrize("n", [17, 300])
def test_prefill_state_hands_off_to_decode(models, n):
    """prefill(prompt + 8 tokens) against prefill(prompt) and 8
    ``decode_step``s: the state, ``x_prev_t`` (ln1 output) and
    ``x_prev_c`` (ln2 output) carry every later token.  At 17 tokens
    the reference runs both ways too; at 300 it cannot prefill (its
    chunk does not divide the prompt) and the port's padded tail
    serves."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(n)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, n + 8))
    full, fc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    lg, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :n])})
    steps = []
    for j in range(n, n + 8):
        lg, cache = tm.decode_step(tp, cache,
                                   torch.from_numpy(toks[:, j:j + 1]))
        steps.append(lg)
    np.testing.assert_allclose(_np(steps[-1]), _np(full), **TOL)
    for name, leaf in cache["layers"]["blocks"].items():
        np.testing.assert_allclose(_np(leaf),
                                   _np(fc["layers"]["blocks"][name]), **TOL)
    if n + 8 <= 256:
        jl, _ = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
        np.testing.assert_allclose(_np(full), _np(jl), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_handoff_error_is_rounding_as_in_the_reference(dtype):
    """At rwkv6-3b's depth of 32 layers (reduced width) the random-weight
    stack amplifies rounding: prefill(prompt + 8) and prefill(prompt) +
    8 decode steps part by ~1e-4 of max |logit| in float32 and by ~0.1
    in bfloat16, in the reference as in the port.  The port's gap stays
    within 3x the reference's own, and in float32 within 1e-3: the
    margin of ``chip_smoke.py``'s float32 handoff check, which bf16
    rounding would swamp."""
    jm, jp, tm, tp = _models(n_layers=32, dtype=dtype)
    n = 40
    toks = np.random.default_rng(0).integers(0, 512, (1, n + 8))

    def rel(a, b):
        a, b = _np(a), _np(b)
        return float(np.abs(a - b).max() / np.abs(b).max())

    full, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    lg, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :n])})
    for j in range(n, n + 8):
        lg, cache = tm.decode_step(tp, cache,
                                   torch.from_numpy(toks[:, j:j + 1]))
    port = rel(lg, full)
    jt = jnp.asarray(toks.astype(np.int32))
    jfull, _ = jax.jit(jm.prefill)(jp, {"tokens": jt})
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jt[:, :n]})
    decode = jax.jit(jm.decode_step)
    for j in range(n, n + 8):
        jl, jc = decode(jp, jc, jt[:, j:j + 1])
    ref = rel(jl, jfull)
    assert port <= 3 * ref, (port, ref)
    if dtype == "float32":
        assert max(port, ref) <= 1e-3, (port, ref)


def _reqs(cls, lens, budgets):
    return [cls(rid=i, prompt=(np.arange(n) * 7 + 3 * i) % 512,
                max_new_tokens=b)
            for i, (n, b) in enumerate(zip(lens, budgets))]


def test_continuous_engine_token_identical_to_reference(models):
    """Ragged prompts of 1-256 tokens and one of 512 through 3 slots
    (mid-flight refills of the recurrent state), budgets including 0 and
    1, chunk of 3: the same tokens and host syncs as the JAX engine."""
    jm, jp, tm, tp = models
    lens = [1, 37, 256, 512, 100, 9, 64]
    budgets = [5, 0, 1, 7, 4, 6, 3]
    jeng = JaxCBE(jm, jp, max_len=528, n_slots=3, chunk_steps=3)
    want = {r.rid: r.output for r in jeng.serve(
        _reqs(JaxRequest, lens, budgets), honor_arrivals=False)}
    teng = ContinuousBatchingEngine(tm, tp, max_len=528, n_slots=3,
                                    chunk_steps=3, device="cpu")
    done = teng.serve(_reqs(Request, lens, budgets), honor_arrivals=False)
    assert {r.rid: r.output for r in done} == want
    assert teng.host_syncs == jeng.host_syncs
    assert teng.decode_steps == teng.host_syncs * teng.chunk_steps
    for r in done:
        assert len(r.output) == r.max_new_tokens


def test_serve_engine_token_identical_to_reference(models):
    jm, jp, tm, tp = models
    lens, budgets = [11, 11, 11], [5, 2, 6]
    want = [r.output for r in JaxServeEngine(
        jm, jp, max_len=32, batch_size=3).run_batch(
            _reqs(JaxRequest, lens, budgets))]
    got = [r.output for r in ServeEngine(
        tm, tp, max_len=32, batch_size=3, device="cpu").run_batch(
            _reqs(Request, lens, budgets))]
    assert got == want


def test_verify_and_paged_cache_raise_as_in_the_reference(models):
    """A recurrent state has no multi-token verify and no page table:
    both packages raise ``NotImplementedError``."""
    jm, jp, tm, tp = models
    with pytest.raises(NotImplementedError):
        jm.verify_step(jp, jm.init_cache(2, 16, per_slot_pos=True),
                       jnp.zeros((2, 3), jnp.int32))
    with pytest.raises(NotImplementedError):
        jm.init_paged_cache(2, 9, 8, 4)
    with pytest.raises(NotImplementedError):
        tm.verify_step(tp, tm.init_cache(2, 16, per_slot_pos=True),
                       torch.zeros((2, 3), dtype=torch.long))
    with pytest.raises(NotImplementedError):
        tm.init_paged_cache(2, 9, 8, 4)


@pytest.mark.parametrize("kw", [
    dict(kv_page_size=8),
    dict(kv_page_size=8, prefix_caching=True),
    dict(spec_k=2, draft=True),
])
def test_engine_refuses_paged_prefix_and_speculative_modes(models, kw):
    """Refused when the engine is built, before it serves anything."""
    jm, jp, tm, tp = models
    kw = dict(kw)
    if kw.pop("draft", False):
        kw.update(draft_model=tm, draft_params=tp)
    with pytest.raises(NotImplementedError, match="rwkv"):
        ContinuousBatchingEngine(tm, tp, max_len=32, n_slots=2,
                                 device="cpu", **kw)


def test_kernels_flag_off_is_the_same_model_on_cpu(models):
    """``kernels=False`` calls the plain scan directly; on the CPU the
    wrapper routes to it too, so the logits are identical."""
    jm, jp, tm, tp = models
    plain = build_model(tm.cfg, "cpu", kernels=False)
    toks = torch.arange(300)[None] % 512
    a, ca = tm.prefill(tp, {"tokens": toks})
    b, cb = plain.prefill(tp, {"tokens": toks})
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    nxt = torch.tensor([[5]])
    torch.testing.assert_close(tm.decode_step(tp, ca, nxt)[0],
                               plain.decode_step(tp, cb, nxt)[0],
                               rtol=0, atol=0)


def test_launcher_serves_rwkv_on_cpu():
    m = tserve.main(["--arch", ARCH, "--reduce", "--device", "cpu",
                     "--qps", "20", "--min-duration", "0.5"])
    assert m["requests"] >= 1 and m["tokens"] == 8 * m["requests"]
