"""Train mode of the port's dense, vlm, encdec and tiny models on the
CPU against the JAX reference: ``train_loss`` and every gradient leaf
on bridged weights, remat on and off, the cross entropy's padded
vocabulary and ``loss_mask``, and the options the hillclimb turns.

Reduced configs, float32, weights through ``from_jax``, batches (tokens,
labels, patch embeddings, frames, MFCC) from a numpy seed.  Tolerances:
loss and metrics within 1e-5 relative (one float32 cross entropy of ~6
nats; only summation orders differ), every gradient leaf within 1e-4 x
its reference's max |g| (backward sums over the batch and sequence in a
different order; the kernel tests' float32 tolerance, tests/
test_kernels.py:16).  The moe, mla_moe, hybrid and rwkv families are in
tests/test_torch_train_families.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import build_model as jax_build_model
from repro.models.lm import _ce_loss as jax_ce_loss
from repro.models.param import init_params as jax_init_params
from repro_torch import configs as tcfg
from repro_torch.models import build_model
from repro_torch.models.lm import _ce_loss
from repro_torch.models.param import from_jax
from repro_torch.train.train_step import _value_and_grad

# tiny shapes: one intra-op thread each, so that pytest-xdist workers do
# not oversubscribe the CPU that timing-sensitive tests share
torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
ARCHS = ["granite-3-2b", "qwen2.5-3b", "qwen3-1.7b", "yi-9b",
         "phi-3-vision-4.2b", "edge-vit", "whisper-small", "tiny-kws"]


def batch_np(cfg, b=2, s=32, seed=0, mask=False):
    """A numpy batch of the family's inputs: tokens and labels (a VLM's
    cut to make room for its patches, which come first), frames, MFCC;
    with ``mask`` a 0/1 ``loss_mask``."""
    rng = np.random.default_rng(seed)
    if cfg.family == "tiny":
        return {"mfcc": rng.standard_normal((b, 49, 10)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size,
                                       (b,)).astype(np.int32)}
    out, st = {}, s
    if cfg.vlm is not None:
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.vlm.n_patches, cfg.vlm.patch_embed_dim or cfg.d_model)
        ).astype(np.float32)
        st = s - cfg.vlm.n_patches
    toks = rng.integers(0, cfg.vocab_size, (b, st + 1))
    out["tokens"] = toks[:, :-1].astype(np.int32)
    out["labels"] = toks[:, 1:].astype(np.int32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, cfg.encdec.enc_len, cfg.d_model)).astype(np.float32)
    if mask:
        out["loss_mask"] = (rng.random((b, st)) < 0.7).astype(np.float32)
    return out


def reference(arch, bn, **overrides):
    """(loss, metrics, grads as numpy, numpy params) of the JAX model's
    jitted ``value_and_grad`` of ``train_loss`` at PRNGKey(0)."""
    cfg = dataclasses.replace(jcfg.reduce_config(jcfg.get_config(arch)),
                              **overrides)
    model = jax_build_model(cfg)
    params = jax_init_params(model.param_defs(), jax.random.PRNGKey(0))
    f = jax.jit(jax.value_and_grad(model.train_loss, has_aux=True))
    (loss, metrics), grads = f(params, {k: jnp.asarray(v)
                                        for k, v in bn.items()})
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads),
            jax.tree.map(np.asarray, params))


def port(arch, params_np, bn, **overrides):
    """(loss, metrics, grads) of the port's ``train_loss`` on the same
    weights and batch."""
    cfg = dataclasses.replace(tcfg.reduce_config(tcfg.get_config(arch)),
                              **overrides)
    model = build_model(cfg, "cpu")
    (loss, metrics), grads = _value_and_grad(
        model, from_jax(params_np, "cpu"),
        {k: torch.from_numpy(v) for k, v in bn.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def assert_grads_close(got, want, path=""):
    """Same tree; every leaf within GRAD_TOL x its reference's max |g|
    (exactly 0 where the reference's is 0)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_grads_close(got[k], want[k], f"{path}/{k}")
        return
    g = got.detach().float().numpy()
    assert g.shape == want.shape, path
    scale = float(np.abs(want).max())
    err = float(np.abs(g - want).max())
    assert err <= GRAD_TOL * scale, (path, err, scale)


def assert_loss_close(got, want):
    loss, metrics = got
    ref_loss, ref_metrics = want
    assert abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss)
    assert set(metrics) == set(ref_metrics)
    for k, v in ref_metrics.items():
        assert abs(metrics[k] - v) <= LOSS_RTOL * max(abs(v), 1e-6), k


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_the_reference(arch):
    cfg = tcfg.reduce_config(tcfg.get_config(arch))
    bn = batch_np(cfg)
    loss, metrics, grads, params_np = reference(arch, bn)
    tl, tm, tg = port(arch, params_np, bn)
    assert_loss_close((tl, tm), (loss, metrics))
    assert_grads_close(tg, grads)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "whisper-small"])
def test_remat_gives_the_same_gradients(arch):
    """``cfg.remat`` recomputes each layer in backward: the loss and
    every gradient bit for bit as without it (the same ops again)."""
    cfg = tcfg.reduce_config(tcfg.get_config(arch))
    bn = batch_np(cfg)
    _, _, _, params_np = reference(arch, bn)
    off = port(arch, params_np, bn, remat=False)
    on = port(arch, params_np, bn, remat=True)
    assert on[0] == off[0]
    flat_on = _leaves(on[2])
    flat_off = _leaves(off[2])
    assert len(flat_on) == len(flat_off)
    for a, b in zip(flat_on, flat_off):
        assert torch.equal(a, b)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_loss_mask_weights_the_cross_entropy():
    """``loss_mask`` weights: sum(ce w) / max(sum w, 1), as the
    reference; loss and gradients on a masked batch."""
    arch = "qwen3-1.7b"
    cfg = tcfg.reduce_config(tcfg.get_config(arch))
    bn = batch_np(cfg, mask=True)
    loss, metrics, grads, params_np = reference(arch, bn)
    tl, tm, tg = port(arch, params_np, bn)
    assert_loss_close((tl, tm), (loss, metrics))
    assert_grads_close(tg, grads)


@pytest.mark.parametrize("weights", [None, "some", "none"])
def test_ce_loss_masks_the_padded_vocabulary(weights):
    """Padded columns (vocab 500 of 2,048) get ``MASK_VALUE`` even where
    their logits are the largest; a mask of all zeros gives 0, as the
    reference's max(sum w, 1)."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 2048)).astype(np.float32)
    logits[..., 500:] += 50.0
    labels = rng.integers(0, 500, (2, 5)).astype(np.int32)
    w = {None: None, "some": (rng.random((2, 5)) < 0.5).astype(np.float32),
         "none": np.zeros((2, 5), np.float32)}[weights]
    want = float(jax_ce_loss(jnp.asarray(logits), jnp.asarray(labels), 500,
                             2048, None if w is None else jnp.asarray(w)))
    got = float(_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                         500, 2048, None if w is None else torch.from_numpy(w)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


@pytest.mark.parametrize("option", [dict(causal_skip=True),
                                    dict(attn_bf16_scores=True),
                                    dict(remat=True, remat_policy="dots")])
def test_hillclimb_options_train_like_the_reference(option):
    """The options train mode refused until the hillclimb ported them
    raise no more: each trains, and its loss equals the reference's
    (1e-5 relative in float32, 1e-3 with bf16 scores; gradients in
    tests/test_torch_hillclimb.py).  An unknown remat policy still
    raises."""
    arch = "qwen3-1.7b"
    cfg = dataclasses.replace(tcfg.reduce_config(tcfg.get_config(arch)),
                              **option)
    bn = batch_np(cfg)
    want, _, _, params = reference(arch, bn, **option)
    got, _, _ = port(arch, params, bn, **option)
    tol = 1e-3 if option.get("attn_bf16_scores") else LOSS_RTOL
    assert abs(got - want) <= tol * abs(want)
    bad = build_model(dataclasses.replace(cfg, remat=True,
                                          remat_policy="everything"), "cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        bad.train_loss(bad.init(0), {k: torch.from_numpy(v)
                                     for k, v in bn.items()})


def test_train_loss_ignores_the_kernels_setting():
    """``train_loss`` reads no ``self.kernels``: a ``kernels=True`` model
    (the default) and a ``kernels=False`` one give equal loss and
    gradients.  On the CPU both reach the plain versions anyway; that a
    CUDA kernel is never reached under autograd is held by the
    wrappers' refusal (``tests/test_torch_autograd_safety.py``)."""
    cfg = tcfg.reduce_config(tcfg.get_config("qwen3-1.7b"))
    bn = {k: torch.from_numpy(v) for k, v in batch_np(cfg).items()}
    a = build_model(cfg, "cpu")
    b = build_model(cfg, "cpu", kernels=False)
    params = a.init(0)
    (la, _), ga = _value_and_grad(a, params, bn)
    (lb, _), gb = _value_and_grad(b, params, bn)
    assert torch.equal(la, lb)
    for x, y in zip(_leaves(ga), _leaves(gb)):
        assert torch.equal(x, y)
