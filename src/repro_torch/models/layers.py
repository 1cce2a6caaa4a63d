"""Transformer layers of the dense decoder (PyTorch port).

The dense subset of the reference ``models/layers.py``: norms, RoPE,
GQA prefill/decode with the KV-cache write, and the SwiGLU FFN.  The
reference's ``shard``/``tp_psum`` are identities at TP = 1 and are
dropped.  Attention goes through the kernel wrappers when ``kernels``
is set (CPU tensors still take the plain version inside them) and
straight to the plain versions otherwise.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_plain,
)
from repro_torch.kernels.flash_attention.ops import (
    flash_attention, flash_attention_plain,
)
from repro_torch.models.param import ParamDef

VOCAB_PAD = 2048


def pad_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


# ----------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------
def rmsnorm_def(d: int, dtype: str) -> ParamDef:
    return ParamDef((d,), ("embed",), "ones", dtype)


def rmsnorm(x, w, eps: float = 1e-6):
    """Computed in float32 and cast back, as the reference does."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------
def rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (S,) or (B, S).  Angles in float32;
    the result is cast back to x's dtype."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq                  # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if ang.ndim == 2:                                          # (S, half)
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:                                                      # (B, S, half)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# KV cache write
# ----------------------------------------------------------------------
def cache_update(cache, new, pos):
    """Write ``new`` (B, 1, KVH, D) into ``cache`` (B, S, KVH, D) at
    ``pos``, in place (the reference's one-hot update rebuilds the
    cache; its jit donates the buffer, so this is the same state
    change).  ``pos`` is a scalar or a per-slot (B,) tensor.

    Per-slot positions are clamped to S - 1: only a slot the engine has
    already retired can sit at S (a zero-budget prompt of exactly
    ``max_len`` tokens), where the reference's one-hot writes nothing;
    its row is garbage either way and is rewritten at the next prefill.
    """
    new = new[:, 0].to(cache.dtype)
    pos = torch.as_tensor(pos, device=cache.device)
    if pos.ndim == 1:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache.index_put_((rows, pos.long().clamp(max=cache.shape[1] - 1)),
                         new)
    else:
        cache.index_copy_(1, pos.long().reshape(1), new[:, None])
    return cache


# ----------------------------------------------------------------------
# GQA attention block
# ----------------------------------------------------------------------
def gqa_defs(cfg) -> dict:
    d, dh = cfg.d_model, cfg.head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    dt = cfg.dtype
    defs = {
        "wq": ParamDef((d, h * dh), ("fsdp", "heads_flat"), "normal", dt),
        "wk": ParamDef((d, kvh * dh), ("fsdp", "kv_flat"), "normal", dt),
        "wv": ParamDef((d, kvh * dh), ("fsdp", "kv_flat"), "normal", dt),
        "wo": ParamDef((h * dh, d), ("heads_flat", "fsdp"), "normal", dt,
                       1.0 / math.sqrt(h * dh * max(1, 2 * cfg.n_layers))),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h * dh,), ("heads_flat",), "zeros", dt)
        defs["bk"] = ParamDef((kvh * dh,), ("kv_flat",), "zeros", dt)
        defs["bv"] = ParamDef((kvh * dh,), ("kv_flat",), "zeros", dt)
    if cfg.qk_norm:
        defs["q_norm"] = rmsnorm_def(dh, dt)
        defs["k_norm"] = rmsnorm_def(dh, dt)
    return defs


def _proj_qkv(x, p, cfg):
    b, s, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, kvh, dh)
    v = v.reshape(b, s, kvh, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def gqa_prefill(x, p, cfg, *, kernels: bool = True):
    """Prefill from position 0, returning the output and the K/V to
    cache (post-RoPE)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _proj_qkv(x, p, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if kernels:
        o = flash_attention(q, k, v, causal=True)
    else:
        o = flash_attention_plain(q, k, v, causal=True, chunk=cfg.attn_chunk)
    o = o.reshape(b, s, -1) @ p["wo"]
    return o, (k, v)


def gqa_decode(x, p, cfg, cache, pos, *, kernels: bool = True):
    """One-token decode against ``cache`` = dict(k, v), each
    (B, S, KVH, D), updated in place.  ``pos`` is a scalar or a
    per-slot (B,) tensor: every row ropes, caches and attends at its own
    depth (the ragged decode of the continuous-batching engine)."""
    b = x.shape[0]
    q, k, v = _proj_qkv(x, p, cfg)
    pos = torch.as_tensor(pos, device=x.device)
    poss = pos[:, None] if pos.ndim == 1 else pos.reshape(1)
    q = rope(q, poss, cfg.rope_theta)
    k = rope(k, poss, cfg.rope_theta)
    k_cache = cache_update(cache["k"], k, pos)
    v_cache = cache_update(cache["v"], v, pos)
    if kernels:
        o = decode_attention(q, k_cache, v_cache, pos)
    else:
        o = decode_attention_plain(q, k_cache, v_cache, pos)
    return o.reshape(b, 1, -1) @ p["wo"]


# ----------------------------------------------------------------------
# Dense FFN (SwiGLU)
# ----------------------------------------------------------------------
def ffn_defs(cfg) -> dict:
    d, dt, f = cfg.d_model, cfg.dtype, cfg.d_ff
    return {
        "w_gate": ParamDef((d, f), ("fsdp", "d_ff"), "normal", dt),
        "w_up": ParamDef((d, f), ("fsdp", "d_ff"), "normal", dt),
        "w_down": ParamDef((f, d), ("d_ff", "fsdp"), "normal", dt,
                           1.0 / math.sqrt(f * max(1, 2 * cfg.n_layers))),
    }


def ffn(x, p):
    """SwiGLU FFN."""
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]
