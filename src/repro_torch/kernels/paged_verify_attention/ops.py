"""Paged verify attention: the CUDA kernel's wrapper and its plain
versions.

``paged_verify_attention`` is the model-layout entry point of a T-token
window through the page table: the suffix prefill of a prefix-cache hit
(and, with speculative decoding, the verify window).  A CPU tensor goes
to ``paged_verify_attention_plain`` (the reference's jnp path: gather
through the page table, then ``verify_attention_jnp``); a CUDA tensor
launches the hand-written kernel in ``csrc/paged_verify_attention.cu``
or raises.  ``paged_verify_attention.launches`` counts kernel launches.

Replaces ``src/repro/kernels/decode_attention/decode_attention.py:
paged_verify_attention_kernel`` (wrapper ``ops.py:
paged_verify_attention``).  The kernel tiles the window's T * G query
rows over CTAs where the reference holds them in one block, and reads
the pool and q in the model's layouts through strides.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ops import MASK_VALUE
from repro_torch.kernels.paged_decode_attention.ops import (
    check_paged_args, paged_view,
)


def verify_attention_plain(q, k_cache, v_cache, pos):
    """Multi-token attention against a KV cache, the copy of
    ``models/layers.py:verify_attention_jnp``.

    q: (B, T, H, D); caches: (B, S, KVH, D); pos: scalar or per-slot
    (B,) window start.  Query token ``t`` of slot ``b`` attends to
    cache positions ``<= pos_b + t``: causal within the window, full
    prefix below it.  T = 1 reduces to ``decode_attention_plain``."""
    b, t, h, d = q.shape
    skv, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, t, kvh, g, d)
    s = torch.einsum("bthgd,bkhd->bthgk", qg.float(),
                     k_cache.float()) * scale
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    if pos.ndim == 0:
        pos = pos.expand(b)
    kv_pos = torch.arange(skv, device=q.device)
    q_pos = pos[:, None] + torch.arange(t, device=q.device)[None, :]
    mask = kv_pos[None, None, :] <= q_pos[:, :, None]         # (B, T, S)
    s = torch.where(mask[:, :, None, None, :], s, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bthgk,bkhd->bthgd", p, v_cache.float())
    return o.reshape(b, t, h, d).to(q.dtype)


def paged_verify_attention_plain(q, k_pool, v_pool, pages, pos):
    """q: (B, T, H, D); pools: (P, page_size, KVH, D); pages: (B, NB);
    pos: () or (B,) window starts.  Returns (B, T, H, D)."""
    return verify_attention_plain(q, paged_view(k_pool, pages),
                                  paged_view(v_pool, pages), pos)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib():
    lib = build.library("paged_verify_attention")
    fn = lib.paged_verify_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([_P] * 6 + [_I] * 7 + [_L] * 12
                       + [ctypes.c_float, _I, _P])
        fn.restype = _I
    return fn


def paged_verify_attention(q, k_pool, v_pool, pages, pos):
    """q: (B, T, H, D); pools: (P, page_size, KVH, D); pages: (B, NB)
    int; pos: () or (B,) int window starts.  Returns (B, T, H, D).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (D in {64, 128}, float32 or bfloat16, any T >= 1) or raise."""
    if q.device.type == "cpu":
        return paged_verify_attention_plain(q, k_pool, v_pool, pages, pos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_verify_attention: no path for {q.device}")
    pages, pos = check_paged_args("paged_verify_attention", q, k_pool,
                                  v_pool, pages, pos)
    if q.stride(-1) != 1:
        q = q.contiguous()
    b, t, h, d = q.shape
    _, ps, kvh, _ = k_pool.shape
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    err = _lib()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), pages.data_ptr(),
        pos.data_ptr(), o.data_ptr(), b, t, h, kvh, d, pages.shape[1], ps,
        *q.stride()[:3], *k_pool.stride()[:3], *v_pool.stride()[:3],
        *o.stride()[:3], 1.0 / math.sqrt(d), build.dtype_code(q),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_verify_attention")
    paged_verify_attention.launches += 1
    return o


paged_verify_attention.launches = 0
