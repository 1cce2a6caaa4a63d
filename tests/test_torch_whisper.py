"""The port's whisper-small encoder-decoder on the CPU against the JAX
reference (``repro/models/encdec.py``) on the same weights and inputs:
the weight bridge, the position table, the encoder, prefill (logits and
every cache leaf), decode steps, and the fixed-batch ``ServeEngine``
with frames passed as ``extra_inputs``.  float32 at ``reduce_config``
size (2 encoder layers over 64 frames, 2 decoder layers), within 1e-4,
the tolerance of the port's other model tests."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import build_model as jax_build_model
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models.param import init_params as jax_init_params
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch import configs as tcfg
from repro_torch.models import build_model
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.param import from_jax, tree_leaves, tree_map
from repro_torch.serving import (ContinuousBatchingEngine, Request,
                                 ServeEngine)

# tiny shapes: one intra-op thread each, so that pytest-xdist workers do
# not oversubscribe the CPU that timing-sensitive tests share
torch.set_num_threads(1)

ARCH = "whisper-small"
TOL = dict(rtol=1e-4, atol=1e-4)


def _models(dtype="float32", **jax_overrides):
    """The same reduced config, model and weights in both packages."""
    jc = dataclasses.replace(jcfg.reduce_config(jcfg.get_config(ARCH)),
                             dtype=dtype, **jax_overrides)
    tc = dataclasses.replace(tcfg.reduce_config(tcfg.get_config(ARCH)),
                             dtype=dtype)
    jm = jax_build_model(jc)
    jp = jax_init_params(jm.param_defs(), jax.random.PRNGKey(0))
    tm = build_model(tc, "cpu")
    return jm, jp, tm, from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _frames(cfg, b, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encdec.enc_len, cfg.d_model)).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def test_build_model_gives_encdec_lm():
    cfg = tcfg.reduce_config(tcfg.get_config(ARCH))
    assert isinstance(build_model(cfg, "cpu"), EncDecLM)
    assert cfg.encdec.enc_layers == 2 and cfg.encdec.enc_len == 64


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_jax_round_trip_is_bit_exact(dtype):
    """Every leaf of the whisper tree (encoder and decoder stacks, the
    bias-free cross-attention) arrives with the reference's shape and
    bits, and the tree is the port's own ``param_defs`` tree."""
    jm, jp, tm, tp = _models(dtype)
    jleaves, tleaves = jax.tree.leaves(jp), tree_leaves(tp)
    assert len(jleaves) == len(tleaves)
    for a, t in zip(jleaves, tleaves):
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape
        if dtype == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
    defs = tree_map(lambda d: (d.shape, d.dtype), tm.param_defs())
    got = tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp)
    assert got == defs
    assert sorted(tp["dec_blocks"]) == sorted(jp["dec_blocks"])
    assert "xattn" in tp["dec_blocks"] and "ln_x" in tp["dec_blocks"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sinusoid_matches_reference(dtype):
    """Built in float32 and cast once, as the reference builds it.  In
    float32 the two agree within 1e-4: XLA's and torch's ``pow`` part in
    the last bit for a few frequencies, and at position 447 one float32
    ulp of the angle is 3e-5.  In bf16 the table is the float32 table
    cast once, bit for bit, so it meets the reference's except where
    that last bit straddles a bf16 rounding boundary: one bf16 step, in
    under 0.1% of the entries."""
    want = _np(JE.sinusoid(448, 768, getattr(jnp, dtype)))
    got = TE.sinusoid(448, 768, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (448, 768)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, **TOL)
        return
    assert torch.equal(got, TE.sinusoid(448, 768, torch.float32).to(
        torch.bfloat16))
    diff = np.abs(_np(got) - want)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                   - 7)
    assert (diff <= step).all()
    assert (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("cross", [False, True])
def test_gqa_defs_match_reference(cross):
    """A cross-attention block leaves out the qkv bias, as in the
    reference (checked on a config that has one)."""
    jc = dataclasses.replace(jcfg.reduce_config(jcfg.get_config(ARCH)),
                             qkv_bias=True)
    tc = dataclasses.replace(tcfg.reduce_config(tcfg.get_config(ARCH)),
                             qkv_bias=True)
    want = JL.gqa_defs(jc, cross=cross)
    got = TL.gqa_defs(tc, cross=cross)
    assert {k: tuple(d) for k, d in got.items()} == \
        {k: tuple(d) for k, d in want.items()}
    assert ("bq" in got) is not cross


@pytest.mark.parametrize("causal,use_rope", [(False, False), (True, True)],
                         ids=["encoder", "causal-rope"])
def test_gqa_attention_matches_reference(causal, use_rope):
    """Full-sequence attention at a ragged length, through the plain
    flash version with a small q chunk (the reference pads the last
    chunk, the port slices it)."""
    jm, jp, tm, tp = _models()
    jc = dataclasses.replace(jm.cfg, attn_chunk=16)
    tc = dataclasses.replace(tm.cfg, attn_chunk=16)
    attn = tree_map(lambda a: a[1], jax.tree.map(np.asarray,
                                                 jp["enc_blocks"]["attn"]))
    x = np.random.default_rng(6).standard_normal(
        (2, 37, jc.d_model)).astype(np.float32)
    want = JL.gqa_attention(jnp.asarray(x), tree_map(jnp.asarray, attn), jc,
                            causal=causal, use_rope=use_rope)
    for kernels in (True, False):
        got = TL.gqa_attention(torch.from_numpy(x),
                               tree_map(torch.tensor, attn), tc,
                               causal=causal, use_rope=use_rope,
                               kernels=kernels)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_encode_matches_reference():
    jm, jp, tm, tp = _models()
    f = _frames(tm.cfg, 2)
    want = jax.jit(jm.encode)(jp, jnp.asarray(f))
    got = tm.encode(tp, torch.from_numpy(f))
    assert got.shape == (2, 64, tm.cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_prefill_and_8_decode_steps_match_reference():
    """Prefill logits and every cache leaf (self K/V padded with zeros,
    cross K/V, pos), then 8 teacher-forced decode steps' logits and
    self K/V, within 1e-4."""
    jm, jp, tm, tp = _models()
    rng = np.random.default_rng(1)
    f = _frames(tm.cfg, 2, seed=2)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 4)).astype(np.int32)
    max_len = 16
    jl, jc = jax.jit(jm.prefill, static_argnames="max_len")(
        jp, {"frames": jnp.asarray(f), "tokens": jnp.asarray(toks)},
        max_len=max_len)
    tl, tc = tm.prefill(tp, {"frames": torch.from_numpy(f),
                             "tokens": torch.from_numpy(toks).long()},
                        max_len=max_len)
    assert tl.shape == (2, 1, tm.vp)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert sorted(tc) == sorted(jc)
    specs = jm.cache_specs(2, max_len)
    for name, t in tm.init_cache(2, max_len).items():
        assert (tuple(t.shape), str(t.dtype)[6:]) == \
            (specs[name].shape, str(specs[name].dtype)), name
    for name in tc:
        assert tuple(tc[name].shape) == jc[name].shape, name
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **TOL)
    decode = jax.jit(jm.decode_step)
    forced = rng.integers(0, tm.cfg.vocab_size, (2, 8)).astype(np.int32)
    for j in range(8):
        nxt = forced[:, j:j + 1]
        jl, jc = decode(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt).long())
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for name in ("self_k", "self_v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == 4 + 8


def _serve_requests(cls, budgets, vocab):
    rng = np.random.default_rng(3)
    return [cls(rid=i, prompt=rng.integers(0, vocab, 4), max_new_tokens=b)
            for i, b in enumerate(budgets)]


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["jnp", "pallas_interpret"])
def test_serve_engine_token_identical_to_reference(use_pallas):
    """``ServeEngine.run_batch(extra_inputs={"frames": ...})`` emits the
    JAX engine's greedy tokens, with the reference decoding through its
    jnp attention or through its Pallas decode kernel (interpret)."""
    over = dict(use_pallas=True, pallas_interpret=True) if use_pallas \
        else {}
    jm, jp, tm, tp = _models(**over)
    budgets = [6, 3, 6]
    f = _frames(tm.cfg, 3, seed=4)
    jeng = JaxServeEngine(jm, jp, max_len=24, batch_size=3)
    jreqs = jeng.run_batch(_serve_requests(JaxRequest, budgets, 512),
                           extra_inputs={"frames": jnp.asarray(f)})
    teng = ServeEngine(tm, tp, max_len=24, batch_size=3, device="cpu")
    treqs = teng.run_batch(_serve_requests(Request, budgets, 512),
                           extra_inputs={"frames": torch.from_numpy(f)})
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [len(r.output) for r in treqs] == budgets
    assert teng.tokens_per_request(treqs) == \
        jeng.tokens_per_request(jreqs) == sum(budgets)


def test_serve_engine_refuses_a_batch_past_max_len():
    """4-token prompts behind max_len 8: a budget of 5 decodes up to the
    cache's last row and emits the JAX engine's tokens; a budget of 6
    would reach past it (on a card, past the position table) and is
    refused before prefill, naming the request."""
    jm, jp, tm, tp = _models()
    budgets = [5, 2, 5]
    f = _frames(tm.cfg, 3, seed=6)
    jreqs = JaxServeEngine(jm, jp, max_len=8, batch_size=3).run_batch(
        _serve_requests(JaxRequest, budgets, 512),
        extra_inputs={"frames": jnp.asarray(f)})
    eng = ServeEngine(tm, tp, max_len=8, batch_size=3, device="cpu")
    treqs = eng.run_batch(_serve_requests(Request, budgets, 512),
                          extra_inputs={"frames": torch.from_numpy(f)})
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [len(r.output) for r in treqs] == budgets
    with pytest.raises(ValueError, match="request 2: prompt 4 \\+ budget 6"):
        eng.run_batch(_serve_requests(Request, [5, 2, 6], 512),
                      extra_inputs={"frames": torch.from_numpy(f)})


def test_kernels_flag_off_is_the_same_model_on_cpu():
    """``kernels=False`` calls the plain versions directly; on the CPU
    the wrappers route to them too, so the logits are identical."""
    jm, jp, tm, tp = _models()
    plain = build_model(tm.cfg, "cpu", kernels=False)
    inputs = {"frames": torch.from_numpy(_frames(tm.cfg, 2, seed=5)),
              "tokens": torch.arange(8).reshape(2, 4)}
    a, ca = tm.prefill(tp, inputs, max_len=8)
    b, cb = plain.prefill(tp, inputs, max_len=8)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    nxt = torch.tensor([[5], [9]])
    torch.testing.assert_close(tm.decode_step(tp, ca, nxt)[0],
                               plain.decode_step(tp, cb, nxt)[0],
                               rtol=0, atol=0)


def test_continuous_engine_tokens_per_request_matches_reference():
    """The slot engine's ``tokens_per_request`` (a dense model: the slot
    engine has no encoder-decoder path) counts what the reference's
    does on the same finished requests."""
    from repro.serving import ContinuousBatchingEngine as JaxCBE
    cfg = tcfg.reduce_config(tcfg.get_config("qwen3-1.7b"))
    tm = build_model(cfg, "cpu")
    eng = ContinuousBatchingEngine(tm, tm.init(seed=0), max_len=24,
                                   n_slots=2, chunk_steps=2, device="cpu")
    done = eng.serve(_serve_requests(Request, [3, 0, 5], 512),
                     honor_arrivals=False)
    assert eng.tokens_per_request(done) == 8
    assert JaxCBE.tokens_per_request(None, done) == 8


def test_refusals():
    """Missing frames and the slot engine each raise with a clear
    message; frames on another device or not a tensor are refused by
    the engine; training runs (it raised before it was ported) and
    matches the reference's loss."""
    jm, jp, tm, tp = _models()
    with pytest.raises(ValueError, match="frames"):
        tm.prefill(tp, {"tokens": torch.zeros((1, 4), dtype=torch.long)})
    # train mode: the loss against the reference's on the same weights
    # and batch (1e-5 relative; gradients in tests/test_torch_train_lm.py)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (2, 9))
    frames = rng.standard_normal((2, 64, 128)).astype(np.float32)
    batch = {"frames": frames, "tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    jl, jmet = jm.train_loss(jp, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    tl, tmet = tm.train_loss(tp, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert set(tmet) == set(jmet) == {"ce", "aux"}
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    with pytest.raises(NotImplementedError, match="ServeEngine"):
        ContinuousBatchingEngine(tm, tp, max_len=16, device="cpu")
    eng = ServeEngine(tm, tp, max_len=16, batch_size=1, device="cpu")
    req = [Request(rid=0, prompt=np.arange(4), max_new_tokens=2)]
    with pytest.raises(ValueError, match="frames"):
        eng.run_batch(req, extra_inputs={
            "frames": torch.zeros((1, 64, 128), device="meta")})
    with pytest.raises(TypeError, match="frames"):
        eng.run_batch(req, extra_inputs={
            "frames": np.zeros((1, 64, 128), np.float32)})
