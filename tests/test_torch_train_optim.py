"""The port's AdamW (float32 and int8 moments), warmup-cosine schedule,
global-norm clip and synthetic data pipeline on the CPU against the JAX
reference.

The optimizer runs on the reference's own gradients of reduced
granite-3-2b (as numpy), so that both packages update the same numbers:
at step 1 an update is lr · g / (|g| + eps) ≈ ±lr, so a gradient near
zero whose sign parted between two packages' backward passes at float32
noise would move a weight by 2 lr; on identical gradients it cannot.
Tolerances: float32 parameters and moments within 1e-6 (one float32
ulp at |x| ~ 1 is 1.2e-7; the bias corrections' pow may differ by an
ulp between XLA and PyTorch), int8 moments equal but at rounding ties,
the bf16 sqrt-space v within one ulp (2^-7 relative); the schedule
within 1e-7 of its peak; the tokens bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduce_config as jred
from repro.data import SyntheticTokens as JaxTokens
from repro.data import pack_documents as jax_pack
from repro.models import build_model as jax_build_model
from repro.models.param import init_params as jax_init_params
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import global_norm as jax_global_norm
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine
from repro_torch import configs as tcfg
from repro_torch.data import SyntheticTokens, batch_for_shape, pack_documents
from repro_torch.models.param import from_jax, tree_leaves
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, global_norm)
from repro_torch.optim.adamw import _dq8, _q8
from repro_torch.optim.schedule import warmup_cosine

torch.set_num_threads(1)

F32_TOL = 1e-6


@pytest.fixture(scope="module")
def ref_grads():
    """Reduced granite-3-2b's parameters and three batches' reference
    gradients, as numpy."""
    cfg = jred(jget("granite-3-2b"))
    model = jax_build_model(cfg)
    params = jax_init_params(model.param_defs(), jax.random.PRNGKey(0))
    grad = jax.jit(jax.grad(lambda p, b: model.train_loss(p, b)[0]))
    gen = JaxTokens(cfg.vocab_size, 32, 4)
    grads = [jax.tree.map(np.asarray, grad(params, gen.batch(s)))
             for s in range(3)]
    return jax.tree.map(np.asarray, params), grads


def _t(tree):
    return from_jax(tree, "cpu")


def _close(got, want, tol=F32_TOL):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], tol)
        return
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("lr", [1e-3, "schedule"])
def test_adamw_f32_matches_the_reference_on_its_gradients(ref_grads, lr):
    """Three steps (clip, bias correction, weight decay) from zero
    moments: parameters, m and v within 1e-6, norms within 1e-6
    relative; the lr a Python float or the schedule's 0-d tensor."""
    params_np, grads = ref_grads
    jcfg_, tcfg_ = JaxAdamWConfig(), AdamWConfig()
    jp, js = params_np, jax_adamw_init(params_np, jcfg_)
    tp, ts = _t(params_np), adamw_init(_t(params_np), tcfg_)
    for i, g in enumerate(grads):
        if lr == "schedule":
            jlr = jax_warmup_cosine(js.step, peak_lr=1e-3, warmup=1,
                                    total=3)
            tlr = warmup_cosine(ts.step, peak_lr=1e-3, warmup=1, total=3)
        else:
            jlr = tlr = lr
        jp, js, jn = jax_adamw_update(jp, g, js, jlr, jcfg_)
        tp, ts, tn = adamw_update(tp, _t(g), ts, tlr, tcfg_)
        assert abs(float(tn) - float(jn)) <= F32_TOL * float(jn)
        assert int(ts.step) == int(js.step) == i + 1
        _close(tp, jax.tree.map(np.asarray, jp))
        _close(ts.m, jax.tree.map(np.asarray, js.m))
        _close(ts.v, jax.tree.map(np.asarray, js.v))
    assert ts.m_scale is None and ts.v_scale is None


def test_adamw_int8_moments_match_the_reference(ref_grads):
    """``quant_moments``, three steps, each from the reference's own
    previous state (a moment that parted at a tie would otherwise carry
    its one-unit difference, and through a row's max its scale's, into
    every later step): int8 m equal but where m / scale sits within 1e-3
    of a rounding tie, and there within one (float32 noise between the
    packages decides such a rounding; the reference's own jitted and
    eager updates part at such entries too); the per-row scales within
    1e-6, the bf16 sqrt-space v within an ulp, parameters within 1e-6."""
    from repro.optim import OptState as JaxOptState
    from repro_torch.optim import OptState
    params_np, grads = ref_grads
    jcfg_, tcfg_ = (JaxAdamWConfig(quant_moments=True),
                    AdamWConfig(quant_moments=True))
    jp, js = params_np, jax_adamw_init(params_np, jcfg_)
    parted = total = 0
    for g in grads:
        js = JaxOptState(*(jax.tree.map(np.asarray, x) for x in js))
        tp = _t(jax.tree.map(np.asarray, jp))
        ts = OptState(torch.tensor(int(js.step), dtype=torch.int32),
                      _t(js.m), _t(js.v), _t(js.m_scale), None)
        tg = _t(g)
        clip = torch.clamp(1.0 / (global_norm(tg) + 1e-9), max=1.0)
        jp, js, _ = jax_adamw_update(jp, g, js, 1e-3, jcfg_)
        tp, ts2, _ = adamw_update(tp, tg, ts, 1e-3, tcfg_)
        before = [0.9 * _dq8(q, sc) + 0.1 * (x * clip) for q, sc, x in zip(
            tree_leaves(ts.m), tree_leaves(ts.m_scale), tree_leaves(tg))]
        for got, want, m, sc in zip(
                tree_leaves(ts2.m), jax.tree.leaves(js.m), before,
                tree_leaves(ts2.m_scale)):
            assert got.dtype == torch.int8
            diff = got.numpy().astype(int) - np.asarray(want).astype(int)
            assert np.abs(diff).max() <= 1
            frac = (m / sc).abs().numpy() % 1.0
            assert (np.abs(frac[diff != 0] - 0.5) < 1e-3).all()
            parted += int((diff != 0).sum())
            total += diff.size
        _close(ts2.m_scale, jax.tree.map(np.asarray, js.m_scale))
        for got, want in zip(tree_leaves(ts2.v),
                             jax.tree.leaves(jax.tree.map(np.asarray, js.v))):
            assert got.dtype == torch.bfloat16
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=2 ** -7, atol=0)
        _close(tp, jax.tree.map(np.asarray, jp))
        assert ts2.v_scale is None
    assert parted <= 1e-5 * total


def test_q8_rounds_half_to_even_as_jnp():
    """x / scale at exact halves rounds to even in both packages."""
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5, -2.5]],
                 np.float32)
    from repro.optim.adamw import _q8 as jq8
    jq, js = jq8(jnp.asarray(x))
    tq, ts = _q8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(_dq8(tq, ts).numpy(),
                                  np.asarray(jq, np.float32) * np.asarray(js))


def test_global_norm_and_clip_match_the_reference(ref_grads):
    params_np, grads = ref_grads
    g = grads[0]
    assert abs(float(global_norm(_t(g))) - float(jax_global_norm(g))) \
        <= F32_TOL * float(jax_global_norm(g))
    for max_norm in (0.5, 1e6):
        jc, jn = jax_clip(g, max_norm)
        tc, tn = clip_by_global_norm(_t(g), max_norm)
        _close(tc, jax.tree.map(np.asarray, jc))


@pytest.mark.parametrize("step", [0, 1, 10, 55, 100, 150])
def test_warmup_cosine_matches_the_reference(step):
    """At 0, inside warmup, at warmup's end, mid-cosine, at total and
    beyond it: within 1e-7 of the peak, as a float32 0-d tensor."""
    kw = dict(peak_lr=3e-4, warmup=10, total=100)
    want = float(jax_warmup_cosine(jnp.asarray(step, jnp.int32), **kw))
    got = warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert abs(float(got) - want) <= 1e-7 * 3e-4


@pytest.mark.parametrize("seed,step,host_id,n_hosts", [
    (0, 0, 0, 1), (0, 7, 0, 1), (3, 2, 1, 2), (11, 40, 3, 4)])
def test_synthetic_tokens_are_the_references_bit_for_bit(seed, step,
                                                         host_id, n_hosts):
    kw = dict(vocab_size=1000, seq_len=33, global_batch=8, seed=seed,
              host_id=host_id, n_hosts=n_hosts)
    want = JaxTokens(**kw).batch(step)
    got = SyntheticTokens(**kw, device="cpu").batch(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_synthetic_tokens_iterate_by_step():
    gen = SyntheticTokens(100, 8, 2, seed=5, device="cpu")
    it = iter(gen)
    for s in range(3):
        b = next(it)
        assert torch.equal(b["tokens"], gen.batch(s)["tokens"])


@pytest.mark.parametrize("lens,seq_len", [((5, 3, 9), 4), ((1,), 8),
                                          ((), 4), ((2, 2, 2, 2), 3)])
def test_pack_documents_matches_the_reference(lens, seq_len):
    """Rows equal; a nonempty stream shorter than one row raises in both
    (the reference reshapes it into a whole row), an empty one gives a
    row of padding."""
    rng = np.random.default_rng(len(lens))
    docs = [rng.integers(1, 50, n) for n in lens]
    if 0 < sum(lens) + len(lens) < seq_len:
        for fn in (pack_documents, jax_pack):
            with pytest.raises(ValueError):
                fn(docs, seq_len, eos=99)
        return
    np.testing.assert_array_equal(pack_documents(docs, seq_len, eos=99),
                                  jax_pack(docs, seq_len, eos=99))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "phi-3-vision-4.2b",
                                  "whisper-small"])
def test_batch_for_shape_shapes_and_dtypes(arch):
    """Tokens bit for bit as the reference's; patch embeddings and
    frames of its shapes and dtypes (drawn by a torch.Generator where
    the reference draws from jax.random), the same for one seed and
    step."""
    from repro.configs.base import ShapeConfig as JShape
    from repro.data import batch_for_shape as jax_bfs
    from repro_torch.configs.base import ShapeConfig
    cfg = tcfg.reduce_config(tcfg.get_config(arch))
    want = jax_bfs(jred(jget(arch)), JShape("t", 40, 2, "train"), step=3,
                   seed=1)
    got = batch_for_shape(cfg, ShapeConfig("t", 40, 2, "train"), step=3,
                          seed=1, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    again = batch_for_shape(cfg, ShapeConfig("t", 40, 2, "train"), step=3,
                            seed=1, device="cpu")
    for k in got:
        assert torch.equal(got[k], again[k])
