"""Transformer layers of the dense decoder (PyTorch port).

The dense subset of the reference ``models/layers.py``: norms, RoPE,
GQA prefill/decode with the KV-cache write, the paged-KV decode and
verify paths, and the SwiGLU FFN.  The reference's ``shard``/``tp_psum``
are identities at TP = 1 and are dropped.  Attention goes through the kernel wrappers when ``kernels``
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
from repro_torch.kernels.paged_decode_attention.ops import (
    paged_decode_attention, paged_view,
)
from repro_torch.kernels.paged_verify_attention.ops import (
    paged_verify_attention, verify_attention_plain,
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
def cache_update_window(cache, new, pos):
    """Write ``new`` (B, T, KVH, D) at rows ``[pos, pos + T)`` of
    ``cache`` (B, S, KVH, D), in place (the reference's one-hot update
    rebuilds the cache; its jit donates the buffer, so this is the same
    state change).  ``pos`` is a scalar or a per-slot (B,) tensor:
    every slot writes its own contiguous window.

    Rows past S - 1 are clamped to S - 1, where the reference's one-hot
    writes nothing: only a slot the engine has already retired can sit
    that deep (a zero-budget prompt of exactly ``max_len`` tokens), its
    row is garbage either way and is rewritten at the next prefill.
    The clamp keeps the write free of a host sync.
    """
    b, t = new.shape[:2]
    pos = torch.as_tensor(pos, device=cache.device).long()
    if pos.ndim == 0:
        pos = pos.expand(b)
    rows = pos[:, None] + torch.arange(t, device=cache.device)[None, :]
    slots = torch.arange(b, device=cache.device)[:, None].expand(b, t)
    cache.index_put_((slots, rows.clamp(max=cache.shape[1] - 1)),
                     new.to(cache.dtype))
    return cache


def cache_update(cache, new, pos):
    """Write ``new`` (B, 1, KVH, D) into ``cache`` (B, S, KVH, D) at
    ``pos``, a scalar or a per-slot (B,) tensor, in place: the T = 1
    case of ``cache_update_window``."""
    return cache_update_window(cache, new, pos)


def paged_dest(pages, pos, t: int, page_size: int):
    """Physical (page, offset) index tensors, each (B, T), of logical
    rows ``[pos, pos + T)`` of every slot through the page table
    ``pages`` (B, NB).  Rows whose logical block falls off the table
    clamp to the slot's last table entry: retired slots' tables are
    reset to the reserved garbage page 0, so their frozen in-chunk
    writes can never corrupt a reallocated page.  The model computes
    it once per step and shares it across layers and K/V."""
    b = pages.shape[0]
    pos = torch.as_tensor(pos, device=pages.device).long()
    if pos.ndim == 0:
        pos = pos.expand(b)
    rows = pos[:, None] + torch.arange(t, device=pages.device)[None, :]
    blk = (rows // page_size).clamp(max=pages.shape[1] - 1)
    return torch.gather(pages.long(), 1, blk), rows % page_size


def paged_insert_window(pool, new, pages, pos, dest=None):
    """Scatter ``new`` (B, T, KVH, D) into ``pool`` (P, page_size, KVH,
    D) at logical rows ``[pos, pos + T)`` of each slot, resolved through
    the page table ``pages`` (B, NB), in place (the reference's scatter
    rebuilds the pool; its jit donates the buffer, so this is the same
    state change).  The paged analogue of ``cache_update_window``; a
    window may span a page boundary, and rows off the table clamp as
    ``paged_dest`` says.  ``dest`` is that index when the caller has
    it already."""
    if dest is None:
        dest = paged_dest(pages, pos, new.shape[1], pool.shape[1])
    pool.index_put_(dest, new.to(pool.dtype))
    return pool


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


def gqa_decode_paged(x, p, cfg, cache, pos, pages, *, kernels: bool = True,
                     dest=None):
    """One-token decode against a paged KV pool.

    ``cache`` = dict(k, v) with pool leaves (P, page_size, KVH, D)
    shared by all slots, written in place; ``pages`` (B, NB) is the
    per-slot page table and ``pos`` the per-slot depth vector (``dest``:
    its ``paged_dest``, when the caller has it).  The gather/scatter
    indirection preserves the contiguous layout's values bit for bit,
    so greedy output is token-identical to ``gqa_decode`` for any page
    permutation."""
    b = x.shape[0]
    q, k, v = _proj_qkv(x, p, cfg)
    pos = torch.as_tensor(pos, device=x.device)
    poss = pos[:, None] if pos.ndim == 1 else pos.reshape(1)
    q = rope(q, poss, cfg.rope_theta)
    k = rope(k, poss, cfg.rope_theta)
    if dest is None:
        dest = paged_dest(pages, pos, 1, cache["k"].shape[1])
    k_pool = paged_insert_window(cache["k"], k, pages, pos, dest)
    v_pool = paged_insert_window(cache["v"], v, pages, pos, dest)
    if kernels:
        o = paged_decode_attention(q, k_pool, v_pool, pages, pos)
    else:
        o = decode_attention_plain(q, paged_view(k_pool, pages),
                                   paged_view(v_pool, pages), pos)
    return o.reshape(b, 1, -1) @ p["wo"]


def gqa_verify_paged(x, p, cfg, cache, pos, pages, *, kernels: bool = True,
                     dest=None):
    """Multi-token window against a paged KV pool (the suffix prefill
    of a prefix-cache hit, and the speculative verify window).

    x: (B, T, d); window rows ``[pos, pos + T)`` rope at their absolute
    positions, scatter through the page table (a window may span page
    boundaries; ``dest`` as in ``gqa_decode_paged``) and attend
    causally within the window, to the full prefix below it."""
    b, t, _ = x.shape
    q, k, v = _proj_qkv(x, p, cfg)
    pos = torch.as_tensor(pos, device=x.device)
    if pos.ndim == 0:
        pos = pos.expand(b)
    positions = pos[:, None] + torch.arange(t, device=x.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if dest is None:
        dest = paged_dest(pages, pos, t, cache["k"].shape[1])
    k_pool = paged_insert_window(cache["k"], k, pages, pos, dest)
    v_pool = paged_insert_window(cache["v"], v, pages, pos, dest)
    if kernels:
        o = paged_verify_attention(q, k_pool, v_pool, pages, pos)
    else:
        o = verify_attention_plain(q, paged_view(k_pool, pages),
                                   paged_view(v_pool, pages), pos)
    return o.reshape(b, t, -1) @ p["wo"]


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
