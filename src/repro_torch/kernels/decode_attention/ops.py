"""Decode attention: the CUDA kernel's wrapper and its plain versions.

``decode_attention`` is the model-layout entry point.  A CPU tensor
goes to ``decode_attention_plain`` (the copy of the reference's
``decode_attention_jnp``); a CUDA tensor launches the hand-written
kernel in ``csrc/decode_attention.cu`` or raises -- there is no
fall-back.  ``decode_attention.launches`` counts kernel launches.

Replaces ``src/repro/kernels/decode_attention/decode_attention.py:
decode_attention_kernel`` (wrapper ``ops.py:decode_attention``).  The
kernel reads K/V in the cache's own (B, S, KVH, D) layout through
strides, where the reference wrapper transposes the cache to
(B*KVH, S, D) first; see the source for its bound and design.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

MASK_VALUE = -1e30


def decode_attention_ref(q, k, v, pos):
    """Kernel-layout oracle, the copy of ``ref.py:decode_attention_ref``.

    q: (BH, G, D); k, v: (BH, S, D); attends to positions <= pos, a
    scalar or a per-row (BH,) vector."""
    d = q.shape[-1]
    s = torch.einsum("bgd,bkd->bgk", q.float(), k.float()) / math.sqrt(d)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    if pos.ndim == 1:
        mask = kv_pos[None, :] <= pos[:, None]          # (BH, S)
        s = torch.where(mask[:, None, :], s, MASK_VALUE)
    else:
        s = torch.where((kv_pos <= pos)[None, None], s, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgk,bkd->bgd", p, v.float())
    return o.to(q.dtype)


def decode_attention_plain(q, k_cache, v_cache, pos):
    """Model-layout plain version, the copy of
    ``models/layers.py:decode_attention_jnp``.

    q: (B, 1, H, D); caches: (B, S, KVH, D); pos: scalar current index
    or a per-slot (B,) vector.  Returns (B, 1, H, D)."""
    b, _, h, d = q.shape
    skv, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, kvh, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float()) * scale
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    kv_pos = torch.arange(skv, device=q.device)
    if pos.ndim == 1:
        mask = kv_pos[None, :] <= pos[:, None]              # (B, S)
        s = torch.where(mask[:, None, None, :], s, MASK_VALUE)
    else:
        s = torch.where((kv_pos <= pos)[None, None, None, :], s, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(b, 1, h, d).to(q.dtype)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib():
    lib = build.library("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _L, _L, _L, _L, _L, _L, _I, ctypes.c_float, _I, _P]
        fn.restype = _I
    return fn


def decode_attention(q, k_cache, v_cache, pos):
    """q: (B, 1, H, D); caches: (B, S, KVH, D); pos: () or (B,) int.
    Returns (B, 1, H, D).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (G in {1, 2, 4, 8}, D in {64, 128},
    float32 or bfloat16) or raise."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no path for {q.device}")
    b, t, h, d = q.shape
    _, s, kvh, dk = k_cache.shape
    if (t != 1 or dk != d or v_cache.shape != k_cache.shape
            or k_cache.shape[0] != b or h % kvh):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError("decode_attention: q, k, v dtypes differ")
    for x in (k_cache, v_cache):
        if x.device != q.device or x.stride(-1) != 1:
            raise ValueError("decode_attention: caches must be on q's "
                             "device with unit stride on D")
    pos = torch.as_tensor(pos, device=q.device)
    if pos.dtype != torch.int32:
        pos = pos.to(torch.int32)
    if pos.ndim not in (0, 1) or (pos.ndim == 1 and pos.shape[0] != b):
        raise ValueError(f"decode_attention: pos shape {tuple(pos.shape)}")
    q = q.contiguous()
    o = torch.empty_like(q)
    err = _lib()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        pos.data_ptr(), o.data_ptr(), b, s, kvh, h // kvh, d,
        *k_cache.stride()[:3], *v_cache.stride()[:3],
        pos.stride(0) if pos.ndim else 0, 1.0 / math.sqrt(d),
        build.dtype_code(q), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "decode_attention")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
