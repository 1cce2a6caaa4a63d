"""Transformer layers of the decoders and the encoder-decoder (PyTorch
port).

The reference ``models/layers.py``: norms, RoPE, full-sequence GQA
attention (an encoder's bidirectional; training's on the plain path),
GQA prefill/decode/verify with the KV-cache write, the paged-KV decode
and verify paths, absorbed MLA (DeepSeek's latent attention) with its
latent cache and without it (training), the SwiGLU FFN and the
sort-based, capacity-limited MoE layer on its local path, and for
sharded training the tensor-parallel attention and FFN and the
expert-parallel MoE layer (``gqa_attention_tp``, ``mla_attention_tp``,
``ffn_tp``, ``moe_ffn_ep``).  The reference's ``shard`` is an identity
outside a mesh and is dropped; its ``tp_psum`` after each row-parallel
projection is ``LM``'s all-reduce over its ``tp_group``
(``models/lm.py``).
Attention goes through the kernel wrappers when ``kernels`` is set (CPU
tensors still take the plain version inside them) and straight to the
plain versions otherwise.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

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
    paged_verify_attention,
)
from repro_torch.kernels.verify_attention.ops import (
    verify_attention, verify_attention_plain,
)
from repro_torch.models.param import ParamDef

VOCAB_PAD = 2048


def pad_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


# ----------------------------------------------------------------------
# Training helpers
# ----------------------------------------------------------------------
# the products ``remat_policy="dots"`` saves: 2-D matrix products, the
# reference's dots with no batch dimensions (x @ W; the attention
# einsums and batched expert GEMMs reach ``bmm`` and are recomputed)
SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    policy = torch.utils.checkpoint.CheckpointPolicy
    return (policy.MUST_SAVE if op in SAVED_PRODUCTS
            else policy.PREFER_RECOMPUTE)


def maybe_remat(fn, enabled: bool, policy: str = "nothing"):
    """``fn`` recomputed in backward when ``enabled``, else ``fn``
    itself.  ``policy`` is the reference's ``remat_policy``:
    ``"nothing"`` (``jax.checkpoint_policies.nothing_saveable``) keeps
    only the inputs; ``"dots"`` (``dots_with_no_batch_dims_saveable``)
    also keeps the outputs of ``SAVED_PRODUCTS`` and recomputes the
    rest, through ``torch.utils.checkpoint``'s selective contexts."""
    if not enabled:
        return fn
    if policy not in ("nothing", "dots"):
        raise ValueError(f"remat_policy {policy!r}: 'nothing' or 'dots'")
    context_fn = torch.utils.checkpoint.noop_context_fn
    if policy == "dots":
        context_fn = functools.partial(
            torch.utils.checkpoint.create_selective_checkpoint_contexts,
            _save_products)

    def rematted(*args):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, context_fn=context_fn)

    return rematted


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
    """Write ``new`` (B, T, ...) at rows ``[pos, pos + T)`` of ``cache``
    (B, S, ...), in place (the reference's one-hot update rebuilds the
    cache; its jit donates the buffer, so this is the same state
    change).  ``pos`` is a scalar or a per-slot (B,) tensor: every slot
    writes its own contiguous window.  The trailing dims are K/V's
    (KVH, D) or an MLA latent's (R,).

    Rows past S - 1 are written nowhere, as the reference's one-hot
    writes them (only a slot the engine has retired can sit that deep,
    and an MoE layer lets its row reach the others through expert
    capacity).  Without a host sync: they aim at row S - 1 with the
    value that row ends up holding, so duplicate writes agree.
    """
    b, t = new.shape[:2]
    s = cache.shape[1]
    dev = cache.device
    new = new.to(cache.dtype)
    pos = torch.as_tensor(pos, device=dev).long()
    if pos.ndim == 0:
        pos = pos.expand(b)
    rows = pos[:, None] + torch.arange(t, device=dev)[None, :]
    slots = torch.arange(b, device=dev)[:, None].expand(b, t)
    tail = (1,) * (new.ndim - 2)
    if t == 1:
        last = cache[:, s - 1:s]
    else:
        # row S - 1's final value: the window's, where it reaches it
        at = (s - 1 - pos).clamp(0, t - 1)
        last = torch.where((pos < s).view(b, 1, *tail),
                           new[slots[:, 0], at][:, None], cache[:, s - 1:s])
    vals = torch.where((rows < s).view(b, t, *tail), new, last)
    cache.index_put_((slots, rows.clamp(max=s - 1)), vals)
    return cache


def cache_update(cache, new, pos):
    """Write ``new`` (B, 1, ...) into ``cache`` (B, S, ...) at ``pos``, a
    scalar or a per-slot (B,) tensor, in place: the T = 1 case of
    ``cache_update_window``."""
    return cache_update_window(cache, new, pos)


def paged_dest(pages, pos, t: int, page_size: int):
    """Where logical rows ``[pos, pos + T)`` of every slot land through
    the page table ``pages`` (B, NB): (page, offset), each (B, T), and
    ``last`` (B * T,), for each write the index of the last write to
    the same place.  Rows whose logical block falls off the table clamp
    to the slot's last table entry: retired slots' tables are reset to
    the reserved garbage page 0, so their frozen in-chunk writes can
    never corrupt a reallocated page.  Several frozen slots may write
    one garbage row; the reference's scatter keeps the last of them,
    and ``paged_insert_window`` writes that one's value for each, so
    that the garbage a retired slot reads back (which reaches live
    slots through MoE capacity) is the same on every device and run.
    The model computes it once per step and shares it across layers
    and K/V."""
    b = pages.shape[0]
    pos = torch.as_tensor(pos, device=pages.device).long()
    if pos.ndim == 0:
        pos = pos.expand(b)
    rows = pos[:, None] + torch.arange(t, device=pages.device)[None, :]
    blk = (rows // page_size).clamp(max=pages.shape[1] - 1)
    page, off = torch.gather(pages.long(), 1, blk), rows % page_size
    key = (page * page_size + off).flatten()
    idx = torch.arange(key.numel(), device=pages.device)
    last = torch.where(key[:, None] == key[None, :], idx[None, :],
                       -1).amax(1)
    return page, off, last


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
    page, off, last = dest
    vals = new.to(pool.dtype).flatten(0, 1)[last].view(new.shape)
    pool.index_put_((page, off), vals)
    return pool


# ----------------------------------------------------------------------
# GQA attention block
# ----------------------------------------------------------------------
def gqa_defs(cfg, *, cross: bool = False) -> dict:
    """Attention weights; ``cross`` (a decoder's cross-attention) leaves
    out the qkv bias, as the reference does."""
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
    if cfg.qkv_bias and not cross:
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


def _full_attention(x, p, cfg, *, causal: bool, use_rope: bool,
                    kernels: bool):
    """Attention over the whole of x from position 0; returns the
    output and the K/V it attended (post-RoPE)."""
    b, s, _ = x.shape
    q, k, v = _proj_qkv(x, p, cfg)
    if use_rope:
        positions = torch.arange(s, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if kernels:
        o = flash_attention(q, k, v, causal=causal)
    else:
        o = flash_attention_plain(q, k, v, causal=causal,
                                  chunk=cfg.attn_chunk,
                                  triangular=cfg.causal_skip,
                                  bf16_scores=cfg.attn_bf16_scores)
    return o.reshape(b, s, -1) @ p["wo"], k, v


def gqa_attention(x, p, cfg, *, causal: bool = True, use_rope: bool = True,
                  kernels: bool = True):
    """Full-sequence attention (whisper's encoder runs it bidirectional
    and without RoPE); the reference's ``layers.py:gqa_attention``.
    x: (B, S, d) -> (B, S, d)."""
    return _full_attention(x, p, cfg, causal=causal, use_rope=use_rope,
                           kernels=kernels)[0]


def gqa_prefill(x, p, cfg, *, kernels: bool = True):
    """Prefill from position 0, returning the output and the K/V to
    cache (post-RoPE)."""
    o, k, v = _full_attention(x, p, cfg, causal=True, use_rope=True,
                              kernels=kernels)
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


def gqa_verify(x, p, cfg, cache, pos, *, kernels: bool = True):
    """Multi-token verify (speculative decoding): score a T-token window
    per slot in one forward against ``cache`` = dict(k, v), each
    (B, S, KVH, D), updated in place.

    x: (B, T, d); ``pos`` is a scalar or per-slot (B,) window start.
    Token ``t`` ropes and caches at position ``pos + t`` and attends
    causally within the window, to the committed prefix below it.
    Rejected tokens need no rollback: attention masks by position, and
    the next window starts at the accepted frontier and overwrites the
    stale rows.  T = 1 reduces to ``gqa_decode``."""
    b, t, _ = x.shape
    q, k, v = _proj_qkv(x, p, cfg)
    pos = torch.as_tensor(pos, device=x.device)
    if pos.ndim == 0:
        pos = pos.expand(b)
    positions = pos[:, None] + torch.arange(t, device=x.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    k_cache = cache_update_window(cache["k"], k, pos)
    v_cache = cache_update_window(cache["v"], v, pos)
    if kernels:
        o = verify_attention(q, k_cache, v_cache, pos)
    else:
        o = verify_attention_plain(q, k_cache, v_cache, pos)
    return o.reshape(b, t, -1) @ p["wo"]


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
def ffn_defs(cfg, d_ff: Optional[int] = None) -> dict:
    """SwiGLU weights of width ``d_ff`` (default ``cfg.d_ff``)."""
    d, dt, f = cfg.d_model, cfg.dtype, d_ff or cfg.d_ff
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


# ----------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention), absorbed formulation
# ----------------------------------------------------------------------
MASK_VALUE = -1e30


def mla_defs(cfg) -> dict:
    m, d, h, dt = cfg.mla, cfg.d_model, cfg.n_heads, cfg.dtype
    qk = m.qk_nope_head_dim
    return {
        "wq_a": ParamDef((d, m.q_lora_rank), ("fsdp", None), "normal", dt),
        "q_a_norm": rmsnorm_def(m.q_lora_rank, dt),
        "wq_b": ParamDef((m.q_lora_rank, h, qk + m.qk_rope_head_dim),
                         (None, "heads", None), "normal", dt),
        "wkv_a": ParamDef((d, m.kv_lora_rank + m.qk_rope_head_dim),
                          ("fsdp", None), "normal", dt),
        "kv_a_norm": rmsnorm_def(m.kv_lora_rank, dt),
        "wk_b": ParamDef((h, m.kv_lora_rank, qk), ("heads", None, None),
                         "normal", dt),
        "wv_b": ParamDef((h, m.kv_lora_rank, m.v_head_dim),
                         ("heads", None, None), "normal", dt),
        "wo": ParamDef((h * m.v_head_dim, d), ("heads_flat", "fsdp"),
                       "normal", dt,
                       1.0 / math.sqrt(h * m.v_head_dim * 2 * cfg.n_layers)),
    }


def _mla_qc(x, p, cfg, positions, group=None):
    """Project to the absorbed query (B, S, H, R), its RoPE part (B, S,
    H, P), and the latent KV: c_kv (B, S, R) and k_rope (B, S, P).
    ``group``: the heads of ``p`` are one rank's share (``mla_attention_tp``);
    the query latent, ``c_kv`` and ``k_rope``, computed whole on every
    rank, then enter its heads through ``copy_to``."""
    m = cfg.mla
    b, s, _ = x.shape
    qa = rmsnorm(x @ p["wq_a"], p["q_a_norm"], cfg.norm_eps)
    kv = x @ p["wkv_a"]
    c_kv = rmsnorm(kv[..., :m.kv_lora_rank], p["kv_a_norm"], cfg.norm_eps)
    k_rope = rope(kv[..., m.kv_lora_rank:][:, :, None, :], positions,
                  cfg.rope_theta)[:, :, 0, :]
    if group is not None:
        from repro_torch.parallel.collectives import copy_to
        qa, c_kv, k_rope = (copy_to(t, group) for t in (qa, c_kv, k_rope))
    q = (qa @ p["wq_b"].flatten(1)).view(b, s, *p["wq_b"].shape[1:])
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    # absorb W_uk into q: q' = q_nope @ W_uk^T -> (B, S, H, kv_rank)
    q_abs = torch.einsum("bshd,hrd->bshr", q_nope, p["wk_b"])
    return q_abs, q_rope, c_kv, k_rope


def _mla_scores(q_abs, q_rope, c_kv, k_rope, cfg):
    """float32 scores (B, H, Sq, S) = q_abs . c_kv + q_rope . k_rope,
    scaled."""
    m = cfg.mla
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    sc = torch.einsum("bqhr,bsr->bhqs", q_abs.float(), c_kv.float())
    sc = sc + torch.einsum("bqhp,bsp->bhqs", q_rope.float(), k_rope.float())
    return sc * scale


def _mla_out(sc, c_kv, dtype):
    """Softmax over the keys, then the output latent (B, Sq, H, R)."""
    pr = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqs,bsr->bqhr", pr, c_kv.float()).to(dtype)


def _mla_attend(q_abs, q_rope, c_kv, k_rope, cfg, *, causal, pos=None):
    """Absorbed attention over the latent cache (reference
    ``_mla_attend``): q_abs (B, Sq, H, R), q_rope (B, Sq, H, P), c_kv
    (B, S, R), k_rope (B, S, P).  ``causal``: query i sees keys <= i
    (or <= ``pos`` for every query); otherwise a scalar or per-slot (B,)
    ``pos`` masks the keys past it.  Returns the output latent o_l =
    softmax(scores) @ c_kv, to be un-absorbed by W_uv."""
    sq, s = q_abs.shape[1], c_kv.shape[1]
    dev = q_abs.device
    sc = _mla_scores(q_abs, q_rope, c_kv, k_rope, cfg)
    kv_pos = torch.arange(s, device=dev)
    if causal:
        q_pos = (torch.arange(sq, device=dev) if pos is None
                 else torch.as_tensor(pos, device=dev).expand(sq))
        sc = torch.where((kv_pos[None, :] <= q_pos[:, None])[None, None],
                         sc, MASK_VALUE)
    elif pos is not None:
        pos = torch.as_tensor(pos, device=dev)
        if pos.ndim == 1:                       # per-slot depths (B,)
            msk = kv_pos[None, :] <= pos[:, None]
            sc = torch.where(msk[:, None, None, :], sc, MASK_VALUE)
        else:
            sc = torch.where((kv_pos <= pos)[None, None, None], sc,
                             MASK_VALUE)
    return _mla_out(sc, c_kv, q_abs.dtype)


def _mla_attend_chunk(q_abs, q_rope, c_kv, k_rope, cfg, offset: int):
    """Causal output latent of a query chunk at absolute positions
    ``[offset, offset + Cq)`` over the whole latent cache."""
    cq, s = q_abs.shape[1], c_kv.shape[1]
    dev = q_abs.device
    sc = _mla_scores(q_abs, q_rope, c_kv, k_rope, cfg)
    msk = (torch.arange(s, device=dev)[None, :]
           <= (offset + torch.arange(cq, device=dev))[:, None])
    sc = torch.where(msk[None, None], sc, MASK_VALUE)
    return _mla_out(sc, c_kv, q_abs.dtype)


def _mla_ol_chunked(q_abs, q_rope, c_kv, k_rope, cfg, q_chunk: int = 1024):
    """Causal absorbed-MLA output latent, chunked over the queries
    (flash-style: no S x S score tensor past ``q_chunk`` rows).  The
    last chunk takes whatever rows are left, so any length runs; the
    reference reshapes by ``S // q_chunk`` and raises unless a prompt
    longer than ``q_chunk`` is a multiple of it (ROADMAP §C)."""
    s = q_abs.shape[1]
    if s <= q_chunk:
        return _mla_attend(q_abs, q_rope, c_kv, k_rope, cfg, causal=True)
    return torch.cat([
        _mla_attend_chunk(q_abs[:, i:i + q_chunk], q_rope[:, i:i + q_chunk],
                          c_kv, k_rope, cfg, i)
        for i in range(0, s, q_chunk)], dim=1)


def _mla_o(o_l, p):
    """Un-absorb the output latent (B, Sq, H, R) by W_uv and project
    out: (B, Sq, d)."""
    b, sq = o_l.shape[:2]
    o = torch.einsum("bqhr,hrd->bqhd", o_l, p["wv_b"])
    return o.reshape(b, sq, -1) @ p["wo"]


def mla_prefill(x, p, cfg):
    """MLA over a whole prompt from position 0: the output and the
    latent cache rows (c_kv (B, S, R), k_rope (B, S, P)) to keep."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    q_abs, q_rope, c_kv, k_rope = _mla_qc(x, p, cfg, positions)
    o_l = _mla_ol_chunked(q_abs, q_rope, c_kv, k_rope, cfg)
    return _mla_o(o_l, p), (c_kv, k_rope)


def mla_attention(x, p, cfg):
    """Training MLA (reference ``mla_attention``): the prefill's
    attention, chunked over ``_mla_ol_chunked``'s queries, without the
    cache."""
    return mla_prefill(x, p, cfg)[0]


def mla_decode(x, p, cfg, cache, pos):
    """One-token MLA decode against ``cache`` = dict(c_kv (B, S, R),
    k_rope (B, S, P)), written in place at ``pos`` (a scalar or a
    per-slot (B,) tensor) by ``cache_update``, which drops rows past the
    cache as the reference's one-hot does."""
    pos = torch.as_tensor(pos, device=x.device)
    positions = pos[:, None] if pos.ndim == 1 else pos.reshape(1)
    q_abs, q_rope, c_new, kr_new = _mla_qc(x, p, cfg, positions)
    ckv = cache_update(cache["c_kv"], c_new, pos)
    krp = cache_update(cache["k_rope"], kr_new, pos)
    o_l = _mla_attend(q_abs, q_rope, ckv, krp, cfg, causal=False, pos=pos)
    return _mla_o(o_l, p)


# ----------------------------------------------------------------------
# Mixture of Experts: sort-based capacity dispatch, local path
# ----------------------------------------------------------------------
def moe_defs(cfg) -> dict:
    """Router (float32), the experts' stacked SwiGLU weights and, with
    ``n_shared``, one always-on shared SwiGLU of ``n_shared`` experts'
    width."""
    mo, d, dt = cfg.moe, cfg.d_model, cfg.dtype
    e, f = mo.n_experts, mo.d_expert
    scale_down = 1.0 / math.sqrt(f * max(1, 2 * cfg.n_layers))
    defs = {
        "router": ParamDef((d, e), (None, "experts"), "normal", "float32"),
        "w_gate": ParamDef((e, d, f), ("experts", "fsdp", "d_expert"),
                           "normal", dt),
        "w_up": ParamDef((e, d, f), ("experts", "fsdp", "d_expert"),
                         "normal", dt),
        "w_down": ParamDef((e, f, d), ("experts", "d_expert", "fsdp"),
                           "normal", dt, scale_down),
    }
    if mo.n_shared:
        sf = mo.d_expert * mo.n_shared
        defs["shared"] = {
            "w_gate": ParamDef((d, sf), ("fsdp", "d_ff"), "normal", dt),
            "w_up": ParamDef((d, sf), ("fsdp", "d_ff"), "normal", dt),
            "w_down": ParamDef((sf, d), ("d_ff", "fsdp"), "normal", dt,
                               scale_down),
        }
    return defs


def _top_k(scores, k: int):
    """The k largest scores of each row and their indices, the lower
    index first on a tie (as ``jax.lax.top_k``; ``torch.topk`` does not
    promise an order among ties): a stable descending sort."""
    v, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _route(x2d, router_w, mo, router_type):
    """Top-k routing of (N, d) tokens: (topv (N, k) renormalised gate
    weights, topi (N, k) experts, aux).  ``softmax`` (qwen3-moe) takes
    the top k of the softmax; ``sigmoid`` (DeepSeek-V3) of the sigmoid
    scores.  ``aux`` is the Switch load-balance loss, computed as the
    reference does; serving ignores it."""
    logits = x2d.float() @ router_w.float()
    if router_type == "sigmoid":
        scores = torch.sigmoid(logits)
        topv, topi = _top_k(scores, mo.top_k)
        probs = scores / (scores.sum(-1, keepdim=True) + 1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        topv, topi = _top_k(probs, mo.top_k)
    topv = topv / (topv.sum(-1, keepdim=True) + 1e-9)
    e = router_w.shape[-1]
    assign = F.one_hot(topi[..., 0], e).float()
    aux = e * torch.mean(assign.mean(0) * probs.mean(0))
    return topv, topi, aux


def _capacity(n_tokens: int, mo) -> int:
    """Rows each expert takes from a call of ``n_tokens`` tokens: the
    reference's, so a call's batch shape decides which assignments
    drop."""
    return max(1, int(math.ceil(n_tokens * mo.top_k / mo.n_experts
                                * mo.capacity_factor)))


def _dispatch(x2d, topi, e: int, capacity: int):
    """The (N, k) assignments sorted by expert (stably: by token within
    an expert), each expert's first ``capacity`` rows gathered into an
    (E, capacity, d) buffer and the rest dropped (GShard).  Returns the
    buffer and (order, slot, keep) for ``_combine``."""
    n, k = topi.shape
    dev = x2d.device
    flat_e = topi.reshape(-1).long()
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(n * k, device=dev) - starts[se]
    keep = pos_in_e < capacity
    slot = torch.where(keep, se * capacity + pos_in_e, e * capacity)
    buf = torch.zeros((e * capacity + 1, x2d.shape[1]), dtype=x2d.dtype,
                      device=dev)
    buf[slot] = x2d[order // k]
    return buf[:-1].view(e, capacity, -1), (order, slot, keep)


def _combine(out, topv, route, dtype):
    """Each token's kept expert outputs (rows of ``out``, (E * capacity,
    d)) weighted by its gates and summed in float32, in assignment
    order; dropped assignments add 0."""
    order, slot, keep = route
    n, k = topv.shape
    y_sorted = torch.where(keep[:, None],
                           out[slot.clamp(max=out.shape[0] - 1)], 0.0)
    w_sorted = topv.reshape(-1)[order].to(y_sorted.dtype)
    contrib = y_sorted * w_sorted[:, None]
    # back to assignment order: token t's k outputs at rows t*k .. t*k+k-1
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n * k, device=order.device)
    return contrib[inv].view(n, k, -1).float().sum(1).to(dtype)


def _experts(buf, wg, wu, wd):
    """The experts' SwiGLU as batched GEMMs: (E, C, d) -> (E, C, d)."""
    return torch.bmm(F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu), wd)


def _moe_local(x2d, topv, topi, wg, wu, wd, capacity: int):
    """Sort-based, capacity-limited expert compute (reference
    ``_moe_local``): the (N, k) assignments are sorted by expert
    (stably: by token within an expert), each expert takes its first
    ``capacity`` rows into an (E, capacity, d) buffer and the rest drop
    (GShard), the experts run as batched GEMMs, and each token sums its
    kept outputs weighted by its gates.

    No host read: expert counts come from ``scatter_add_`` (not
    ``bincount``, which reads its maximum back on CUDA).  The dispatch
    writes dropped rows to one spare buffer row; the combine gathers
    each token's k outputs back in assignment order and sums them in
    float32, where the reference scatter-adds (an atomic, run-dependent
    sum in bf16 on a GPU)."""
    buf, route = _dispatch(x2d, topi, wg.shape[0], capacity)
    out = _experts(buf, wg, wu, wd)
    return _combine(out.view(-1, out.shape[-1]), topv, route, x2d.dtype)


def moe_ffn(x, p, cfg, router_type="softmax"):
    """MoE layer over (B, S, d), all B * S tokens routed in one call
    (so the capacity follows the call's shape), plus the shared expert
    where the config has one.  Returns (y, aux)."""
    mo = cfg.moe
    b, s, d = x.shape
    x2d = x.reshape(-1, d)
    topv, topi, aux = _route(x2d, p["router"], mo, router_type)
    y = _moe_local(x2d, topv, topi, p["w_gate"], p["w_up"], p["w_down"],
                   _capacity(x2d.shape[0], mo)).view(b, s, d)
    if mo.n_shared:
        y = y + ffn(x, p["shared"])
    return y, aux


def moe_decode(x, p, cfg, router_type="softmax"):
    """Decode-time MoE (reference ``moe_decode``): on one device the same
    local path as ``moe_ffn``."""
    return moe_ffn(x, p, cfg, router_type)


# ----------------------------------------------------------------------
# Sharded training: tensor and expert parallelism over a model group
# ----------------------------------------------------------------------
# The reference trains under GSPMD rules (``make_rules(cfg, mesh,
# "train")``) and ``_moe_shard_map``; the port runs one process a device
# (``parallel.grid.Grid``).  Activations outside the MoE layer stay whole
# on every rank of a data row (replicated over the model group): each
# rank's weights are its blocks of the rules' layout, FSDP dims already
# gathered (``parallel.sharding.gather_fsdp``), and the Megatron pair
# (``parallel.collectives.copy_to`` / ``reduce_from``) opens and closes
# each column/row-parallel region.  A replicated weight used for a part
# of the computation on each rank (the q/k norms; K/V projections whose
# heads do not divide the model axis; the router) goes through
# ``copy_to`` too, so its gradient is summed over the group.
def kv_window(index: int, h_local: int, group: int) -> tuple[int, int]:
    """The KV heads [lo, hi) that query heads [index * h_local, (index +
    1) * h_local) attend under GQA groups of ``group`` query heads.
    Raises where the local heads do not map onto whole KV heads or one
    KV head's part."""
    if h_local % group and group % h_local:
        raise NotImplementedError(
            f"{h_local} query heads a rank across GQA groups of {group}")
    lo = index * h_local // group
    return lo, (index * h_local + h_local - 1) // group + 1


def gqa_attention_tp(x, p, cfg, grid, *, causal: bool = True,
                     use_rope: bool = True):
    """Training attention on this rank's query heads (causal with RoPE,
    or, for whisper's encoder, bidirectional without): x (B, S, d)
    replicated over the model group of ``grid`` (a
    ``parallel.grid.Grid``) -> this rank's partial output, summed over
    the group (replicated).  The K/V heads are split like the query
    heads, or, where the rules left them whole (``p["wk"]`` holds all
    of them on a model axis above 1), each rank projects all of them
    and attends with its query heads' own."""
    from repro_torch.parallel.collectives import copy_to, reduce_from
    b, s, _ = x.shape
    dh = cfg.head_dim
    group, size = grid.model_group, grid.model
    h = cfg.n_heads // size
    x = copy_to(x, group)
    kv_rep = kv_replicated(p["wk"], cfg, size)
    w = {n: (copy_to(p[n], group) if kv_rep and n in
             ("wk", "wv", "bk", "bv") else p[n]) for n in p}
    q, k, v = x @ w["wq"], x @ w["wk"], x @ w["wv"]
    if "bq" in w:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, -1, dh)
    v = v.reshape(b, s, -1, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, copy_to(w["q_norm"], group), cfg.norm_eps)
        k = rmsnorm(k, copy_to(w["k_norm"], group), cfg.norm_eps)
    if kv_rep:
        lo, hi = kv_window(grid.index("model"), h,
                           cfg.n_heads // cfg.n_kv_heads)
        k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    if use_rope:
        positions = torch.arange(s, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = flash_attention_plain(q, k, v, causal=causal, chunk=cfg.attn_chunk,
                              triangular=cfg.causal_skip,
                              bf16_scores=cfg.attn_bf16_scores)
    return reduce_from(o.reshape(b, s, -1) @ w["wo"], group)


def kv_replicated(wk, cfg, size: int) -> bool:
    """Whether a K (or V) projection ``wk`` holds every KV head on a
    model axis of ``size`` above 1: the rules left ``kv_flat`` whole."""
    return size > 1 and wk.shape[-1] == cfg.n_kv_heads * cfg.head_dim


def mla_attention_tp(x, p, cfg, grid):
    """Training MLA on this rank's heads (``wq_b``, ``wk_b`` and ``wv_b``
    split by heads, ``wo`` by rows): x (B, S, d) replicated over the
    model group of ``grid``.  The query latent and the shared latent KV
    (``c_kv``, ``k_rope``) are computed whole on every rank from the
    replicated ``wq_a``/``wkv_a`` and their norms, and enter the rank's
    heads through ``copy_to`` (``_mla_qc``); the output is summed over
    the group.  The reference's ``mla_attention``, query chunks of
    1,024 rows with the port's ragged tail."""
    from repro_torch.parallel.collectives import reduce_from
    positions = torch.arange(x.shape[1], device=x.device)
    q_abs, q_rope, c_kv, k_rope = _mla_qc(x, p, cfg, positions,
                                          grid.model_group)
    o_l = _mla_ol_chunked(q_abs, q_rope, c_kv, k_rope, cfg)
    return reduce_from(_mla_o(o_l, p), grid.model_group)


def ffn_tp(x, p, group):
    """SwiGLU with gate/up column-split and down row-split over
    ``group``: replicated x -> replicated output."""
    from repro_torch.parallel.collectives import copy_to, reduce_from
    return reduce_from(ffn(copy_to(x, group), p), group)


def moe_ffn_ep(x, p, cfg, router_type, grid):
    """The MoE layer under expert parallelism, as the reference's
    ``_moe_shard_map``: x (B, S, d), this data row's tokens, replicated
    over the model group of ``grid`` (a ``parallel.grid.Grid``).  Each rank
    takes its block of the sequence (the reference's ``seq_sp``), routes
    its ``n`` tokens against the whole router (all-gathered from its
    expert-split layout), fills an (E, capacity(n), d) buffer, sends
    expert block j to rank j (all_to_all), runs its E / size experts on
    the size * capacity rows it received, sends them back and combines;
    the sequence is then all-gathered.  Capacity per shard decides
    which tokens drop, so the result is the sharded reference's, not
    the one-device layer's.  Returns (y replicated, aux): ``aux`` the
    rank's load-balance loss averaged over the model group (the
    reference's ``pmean`` over the expert axis).  The shared expert, if
    any, is the caller's."""
    from repro_torch.parallel.collectives import (all_to_all, gather,
                                                  gather_rep, reduce_from,
                                                  split)
    group, size = grid.model_group, grid.model
    mo = cfg.moe
    b, s, d = x.shape
    if s % size:
        raise ValueError(f"sequence of {s} does not split over the model "
                         f"axis ({size})")
    xs = split(x, 1, group)
    router = gather(p["router"], 1, group)
    x2d = xs.reshape(-1, d)
    n = x2d.shape[0]
    topv, topi, aux = _route(x2d, router, mo, router_type)
    cap = _capacity(n, mo)
    e, el = mo.n_experts, p["w_gate"].shape[0]
    buf, route = _dispatch(x2d, topi, e, cap)
    # block j of dim 0 goes to rank j: (size, E / size, cap, d)
    recv = all_to_all(buf.view(size, el, cap, d), group)
    recv = recv.transpose(0, 1).reshape(el, size * cap, d)
    out = _experts(recv, p["w_gate"], p["w_up"], p["w_down"])
    back = all_to_all(out.view(el, size, cap, d).transpose(0, 1),
                      group)
    y = _combine(back.reshape(e * cap, d), topv, route, x2d.dtype)
    y = gather_rep(y.view(b, s // size, d), 1, group)
    return y, reduce_from(aux, group) / size
