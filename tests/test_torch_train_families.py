"""Train mode of the port's moe, mla_moe (with DeepSeek's MTP loss),
hybrid and rwkv families on the CPU against the JAX reference:
``train_loss``, its metrics (``ce``, ``aux``, ``mtp``) and every
gradient leaf on bridged weights; remat on and off, a hybrid's
superblock remat and its ``sublayer_remat``; the MoE aux averaged as
the reference averages it; dropped tokens' gradients.

Tolerances as in tests/test_torch_train_lm.py (loss 1e-5 relative,
each gradient leaf 1e-4 x its reference's max |g|).  jamba's reference
gradient takes ~10 s to compile.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.train.train_step import _value_and_grad

from test_torch_train_lm import (_leaves, assert_grads_close,
                                 assert_loss_close, batch_np, port,
                                 reference)

torch.set_num_threads(1)

ARCHS = ["qwen3-moe-30b-a3b", "deepseek-v3-671b", "jamba-v0.1-52b",
         "rwkv6-3b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_the_reference(arch):
    cfg = tcfg.reduce_config(tcfg.get_config(arch))
    bn = batch_np(cfg, mask=arch == "qwen3-moe-30b-a3b")
    loss, metrics, grads, params_np = reference(arch, bn)
    tl, tm, tg = port(arch, params_np, bn)
    assert_loss_close((tl, tm), (loss, metrics))
    assert_grads_close(tg, grads)
    if cfg.moe is not None:
        assert metrics["aux"] > 0
    if cfg.mtp:
        assert "mtp" in tm


@pytest.mark.parametrize("arch,overrides", [
    ("qwen3-moe-30b-a3b", {}),
    ("deepseek-v3-671b", {}),
    ("rwkv6-3b", {}),
    ("jamba-v0.1-52b", {}),
    ("jamba-v0.1-52b", dict(sublayer_remat=True)),
])
def test_remat_gives_the_same_gradients(arch, overrides):
    """Remat (a hybrid's whole superblock, or each sublayer under
    ``sublayer_remat``) recomputes in backward: loss and every gradient
    bit for bit as without it."""
    cfg = dataclasses.replace(tcfg.reduce_config(tcfg.get_config(arch)),
                              **overrides)
    model = build_model(cfg, "cpu")
    params = model.init(0)
    bn = {k: torch.from_numpy(v) for k, v in batch_np(cfg).items()}
    (l_off, m_off), g_off = _value_and_grad(model, params, bn)
    on = build_model(dataclasses.replace(cfg, remat=True), "cpu")
    (l_on, m_on), g_on = _value_and_grad(on, params, bn)
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(m_on[k], m_off[k]) for k in m_off)
    for a, b in zip(_leaves(g_on), _leaves(g_off)):
        assert torch.equal(a, b)


def test_hybrid_aux_is_the_mean_over_superblocks_of_sum_over_period():
    """jamba's aux: per superblock the sum of its sublayers' aux (dense
    sublayers 0) over the period, then the mean over superblocks; the
    mla_moe aux is its MoE stack's mean alone."""
    cfg = tcfg.reduce_config(tcfg.get_config("jamba-v0.1-52b"))
    model = build_model(cfg, "cpu")
    params = model.init(0)
    bn = {k: torch.from_numpy(v) for k, v in batch_np(cfg).items()}
    seen = []
    real = L.moe_ffn

    def spy(*a, **k):
        y, aux = real(*a, **k)
        seen.append(float(aux))
        return y, aux

    L.moe_ffn = spy
    try:
        with torch.no_grad():
            _, metrics = model.train_loss(params, bn)
    finally:
        L.moe_ffn = real
    period = cfg.hybrid.attn_period
    n_moe = sum(k.endswith("_moe") for k in model._layer_kinds()[:period])
    assert len(seen) == n_moe * (cfg.n_layers // period)
    want = np.mean([sum(seen[i:i + n_moe]) / period
                    for i in range(0, len(seen), n_moe)])
    assert abs(float(metrics["aux"]) - want) <= 1e-6


def test_dropped_tokens_get_only_the_shared_experts_gradient():
    """A token all of whose assignments drop (capacity 1) gets exactly
    the shared expert's input gradient, as in the reference: the spare
    dispatch row its rows were written to passes none back, and its
    gate weights multiply zero outputs, so the router passes none
    either."""
    cfg = tcfg.reduce_config(tcfg.get_config("deepseek-v3-671b"))
    model = build_model(cfg, "cpu")
    p = model.init(0)["moe_blocks"]
    p = {k: (v[0] if not isinstance(v, dict) else
             {kk: vv[0] for kk, vv in v.items()}) for k, v in
         p["moe"].items()}
    mo = dataclasses.replace(cfg.moe, capacity_factor=1e-9)
    cfg1 = dataclasses.replace(cfg, moe=mo)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, 6, cfg.d_model, generator=gen, requires_grad=True)
    y, _ = L.moe_ffn(x, p, cfg1, "sigmoid")
    (gx,) = torch.autograd.grad(y.sum(), x)
    x2 = x.detach().requires_grad_()
    (gs,) = torch.autograd.grad(L.ffn(x2, p["shared"]).sum(), x2)
    topv, topi, _ = L._route(x.detach().reshape(-1, cfg.d_model),
                             p["router"], mo, "sigmoid")
    kept = torch.zeros(6, dtype=torch.bool)
    flat = topi.reshape(-1)
    for e in flat.unique():        # capacity 1: each expert's first row
        kept[int((flat == e).nonzero()[0]) // mo.top_k] = True
    dropped = ~kept
    assert dropped.any()
    torch.testing.assert_close(gx[0, dropped], gs[0, dropped], rtol=0,
                               atol=0)
