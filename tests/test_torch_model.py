"""The port's dense LM on the CPU against the JAX reference: configs,
the weight bridge, each layer function, and the model's prefill/decode
logits on the same weights (float32, reduced configs, within 1e-4)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.models.param import init_params as jax_init_params
from repro_torch import configs as tcfg
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models.param import from_jax, tree_leaves, tree_map

# tiny shapes: one intra-op thread each, so that pytest-xdist workers do
# not oversubscribe the CPU that timing-sensitive tests share
torch.set_num_threads(1)

DENSE = ["qwen3-1.7b", "qwen2.5-3b", "granite-3-2b", "yi-9b"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _models(arch, **overrides):
    """The same reduced config, model and weights in both packages."""
    jc = jcfg.reduce_config(jcfg.get_config(arch))
    tc = tcfg.reduce_config(tcfg.get_config(arch))
    if overrides:
        jc = dataclasses.replace(jc, **overrides)
        tc = dataclasses.replace(tc, **overrides)
    jm = jax_build_model(jc)
    jp = jax_init_params(jm.param_defs(), jax.random.PRNGKey(0))
    tm = build_model(tc, "cpu")
    return jm, jp, tm, from_jax(_np_tree(jp), "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", DENSE)
def test_configs_match_reference(arch):
    full = tcfg.get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jcfg.get_config(arch))
    assert dataclasses.asdict(tcfg.reduce_config(full)) == \
        dataclasses.asdict(jcfg.reduce_config(jcfg.get_config(arch)))
    assert full.head_dim == jcfg.get_config(arch).head_dim


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "rwkv6-3b",
                                  "whisper-small"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP §A.11"):
        tcfg.get_config(arch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_jax_round_trip_is_bit_exact(dtype):
    """Every leaf arrives with the reference's shape and bits, and the
    tree is the port's own ``param_defs`` tree."""
    jm, jp, tm, tp = _models("qwen3-1.7b", dtype=dtype)
    jleaves, tleaves = jax.tree.leaves(jp), tree_leaves(tp)
    assert len(jleaves) == len(tleaves)
    for a, t in zip(jleaves, tleaves):
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape
        assert str(t.dtype) == f"torch.{dtype}"
        if dtype == "bfloat16":
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(), a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
    defs = tree_map(lambda d: (d.shape, d.dtype), tm.param_defs())
    got = tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp)
    assert got == defs


def test_rmsnorm_rope_ffn_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32)
    np.testing.assert_allclose(
        _np(TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)),
        _np(JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6)), **TOL)
    # rope: sequence positions, a scalar decode position broadcast to a
    # (1,) vector, and per-slot (B, 1) decode positions
    for pos in (np.arange(5), np.array([41]), np.array([[7], [130]])):
        xs = x[:, :pos.shape[-1]]
        np.testing.assert_allclose(
            _np(TL.rope(torch.from_numpy(xs), torch.from_numpy(pos), 1e6)),
            _np(JL.rope(jnp.asarray(xs), jnp.asarray(pos), 1e6)), **TOL)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.1
         for k, s in (("w_gate", (32, 64)), ("w_up", (32, 64)),
                      ("w_down", (64, 32)))}
    h = x[:, :, 0]
    np.testing.assert_allclose(
        _np(TL.ffn(torch.from_numpy(h), tree_map(torch.from_numpy, p))),
        _np(JL.ffn(jnp.asarray(h), tree_map(jnp.asarray, p))), **TOL)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2.5-3b"])
def test_proj_qkv_matches_reference(arch):
    """qk_norm (qwen3) and qkv_bias (qwen2.5), with non-zero biases."""
    jm, jp, tm, tp = _models(arch)
    attn = tree_map(lambda a: a[1], _np_tree(jp["blocks"]["attn"]))
    rng = np.random.default_rng(1)
    for k in ("bq", "bk", "bv"):
        if k in attn:
            attn[k] = rng.standard_normal(attn[k].shape).astype(np.float32)
    x = rng.standard_normal((2, 6, jm.cfg.d_model)).astype(np.float32)
    want = JL._proj_qkv(jnp.asarray(x), tree_map(jnp.asarray, attn), jm.cfg)
    got = TL._proj_qkv(torch.from_numpy(x), tree_map(torch.tensor, attn),
                       tm.cfg)
    for w, g in zip(want, got):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_cache_update_matches_reference():
    rng = np.random.default_rng(2)
    cache = rng.standard_normal((3, 16, 2, 8)).astype(np.float32)
    new = rng.standard_normal((3, 1, 2, 8)).astype(np.float32)
    for pos in (np.array([0, 15, 7], np.int32), np.int32(9)):
        want = JL.cache_update(jnp.asarray(cache), jnp.asarray(new),
                               jnp.asarray(pos))
        got = TL.cache_update(torch.from_numpy(cache.copy()),
                              torch.from_numpy(new), torch.tensor(pos))
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_logits_match_reference(arch):
    """Prefill, a scalar-pos decode step, then a ragged per-slot decode
    step (the continuous-batching layout), all within 1e-4."""
    jm, jp, tm, tp = _models(arch)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jm.cfg.vocab_size, (2, 11)).astype(np.int32)
    max_len = 24
    jl, jc = jax.jit(jm.prefill, static_argnames="max_len")(
        jp, {"tokens": jnp.asarray(toks)}, max_len=max_len)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                        max_len=max_len)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(_np(tc["layers"]["blocks"]["k"]),
                               _np(jc["layers"]["blocks"]["k"]), **TOL)
    decode = jax.jit(jm.decode_step)
    nxt = rng.integers(0, jm.cfg.vocab_size, (2, 1)).astype(np.int32)
    jl, jc = decode(jp, jc, jnp.asarray(nxt))
    tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt).long())
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    # per-slot positions: slot 1 steps back three rows (ragged depths)
    ragged = np.array([12, 9], np.int32)
    jc = dict(jc, pos=jnp.asarray(ragged))
    tc = dict(tc, pos=torch.from_numpy(ragged))
    jl, jc = decode(jp, jc, jnp.asarray(nxt))
    tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt).long())
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_array_equal(_np(tc["pos"]), _np(jc["pos"]))


def test_greedy_decode_32_steps_token_identical():
    jm, jp, tm, tp = _models("qwen3-1.7b")
    toks = np.random.default_rng(4).integers(0, 512, (2, 7)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill, static_argnames="max_len")(
        jp, {"tokens": jnp.asarray(toks)}, max_len=40)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                        max_len=40)
    decode = jax.jit(jm.decode_step)
    jt, tt = [], []
    for _ in range(32):
        jn = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
        tn = torch.argmax(tl[:, -1], -1)[:, None]
        jt.append(np.asarray(jn)[:, 0].tolist())
        tt.append(tn[:, 0].tolist())
        jl, jc = decode(jp, jc, jn)
        tl, tc = tm.decode_step(tp, tc, tn)
    assert tt == jt


def test_kernels_flag_off_is_the_same_model_on_cpu():
    """``kernels=False`` calls the plain versions directly; on the CPU
    the wrappers route to them too, so the logits are identical."""
    jm, jp, tm, tp = _models("granite-3-2b")
    plain = build_model(tm.cfg, "cpu", kernels=False)
    toks = torch.arange(9)[None] % 512
    a, ca = tm.prefill(tp, {"tokens": toks}, max_len=16)
    b, cb = plain.prefill(tp, {"tokens": toks}, max_len=16)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    nxt = torch.tensor([[5]])
    torch.testing.assert_close(tm.decode_step(tp, ca, nxt)[0],
                               plain.decode_step(tp, cb, nxt)[0],
                               rtol=0, atol=0)
