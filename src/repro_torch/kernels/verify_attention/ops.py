"""Verify attention: the CUDA kernel's wrapper and its plain version.

``verify_attention`` is the model-layout entry point of a T-token window
against a contiguous KV cache: the target's verify step in speculative
decoding.  A CPU tensor goes to ``verify_attention_plain`` (the copy of
the reference's ``verify_attention_jnp``); a CUDA tensor launches the
hand-written kernel in ``csrc/verify_attention.cu`` or raises -- there
is no fall-back.  ``verify_attention.launches`` counts kernel launches.

Replaces ``src/repro/kernels/decode_attention/decode_attention.py:
verify_attention_kernel`` (wrapper ``ops.py:verify_attention``).  The
kernel reads the cache in its (B, S, KVH, D) layout through strides,
where the reference wrapper transposes it to (B*KVH, S, D) and pads S
first, and it runs the paged verify kernel's tile loop and row map: on
the card the two agree bit for bit on the same values.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ops import MASK_VALUE


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


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib():
    lib = build.library("verify_attention")
    fn = lib.verify_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([_P] * 5 + [_I] * 6 + [_L] * 12
                       + [ctypes.c_float, _I, _P])
        fn.restype = _I
    return fn


def verify_attention(q, k_cache, v_cache, pos):
    """q: (B, T, H, D); caches: (B, S, KVH, D); pos: () or (B,) int
    window starts.  Returns (B, T, H, D).  CPU tensors take the plain
    version; CUDA tensors launch the kernel (D in {64, 128}, float32 or
    bfloat16, any T >= 1 and G = H / KVH) or raise."""
    if q.device.type == "cpu":
        return verify_attention_plain(q, k_cache, v_cache, pos)
    if q.device.type != "cuda":
        raise ValueError(f"verify_attention: no path for {q.device}")
    b, t, h, d = q.shape
    _, s, kvh, dk = k_cache.shape
    if (dk != d or v_cache.shape != k_cache.shape
            or k_cache.shape[0] != b or h % kvh):
        raise ValueError(f"verify_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError("verify_attention: q, k, v dtypes differ")
    for x in (k_cache, v_cache):
        if x.device != q.device or x.stride(-1) != 1:
            raise ValueError("verify_attention: caches must be on q's "
                             "device with unit stride on D")
    pos = torch.as_tensor(pos, device=q.device)
    if pos.ndim not in (0, 1) or (pos.ndim == 1 and pos.shape[0] != b):
        raise ValueError(f"verify_attention: pos shape {tuple(pos.shape)}")
    pos = pos.to(torch.int32).expand(b).contiguous()
    if q.stride(-1) != 1:
        q = q.contiguous()
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    err = _lib()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        o.data_ptr(), b, t, s, h, kvh, d, *q.stride()[:3],
        *k_cache.stride()[:3], *v_cache.stride()[:3], *o.stride()[:3],
        1.0 / math.sqrt(d), build.dtype_code(q),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "verify_attention")
    verify_attention.launches += 1
    return o


verify_attention.launches = 0
