"""Flash attention, causal or bidirectional: the CUDA kernel's wrapper
and its plain versions.

``flash_attention`` is the model-layout entry point that the prefill
(causal), whisper's encoder and its cross-attention (bidirectional,
Sq != Skv there) use.
A CPU tensor goes to ``flash_attention_plain`` (the copy of the
reference's ``flash_attention_jnp``); a CUDA tensor launches the
hand-written kernel in ``csrc/flash_attention.cu`` or raises.
``flash_attention.launches`` counts kernel launches.

Replaces ``src/repro/kernels/flash_attention/flash_attention.py:
flash_attention_kernel`` (wrapper ``ops.py:flash_attention``) in both
forms of its ``causal`` switch.  The reference model runs its prefill,
encoder and cross-attention through the jnp ``flash_attention_jnp``;
the port runs this kernel there instead, held against that function.
The kernel masks the ragged tail itself, so unlike the reference
wrapper this one pads nothing, and it takes whisper's 1,500 keys in the
bidirectional form, where the reference wrapper asserts
``causal or Skv % block_k == 0``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

MASK_VALUE = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Kernel-layout oracle, the copy of ``ref.py:flash_attention_ref``.

    q: (BH, G, Sq, D); k, v: (BH, Skv, D) -- plain softmax attention."""
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bgqd,bkd->bgqk", q.float(), k.float()) * scale
    if causal:
        mask = (torch.arange(skv, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = torch.where(mask[None, None], s, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgqk,bkd->bgqd", p, v.float())
    return o.to(q.dtype)


def _attend_block(q, k, v, bias, scale):
    """One (q-chunk x full-KV) attention with f32 softmax.

    q: (B, Cq, H, D); k, v: (B, S, KVH, D); bias broadcastable to
    (B, H, Cq, S)."""
    b, cq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, cq, kvh, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    s = s.reshape(b, h, cq, k.shape[1]) + bias
    p = torch.softmax(s, dim=-1)
    p = p.reshape(b, kvh, g, cq, k.shape[1])
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, cq, h, d).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal: bool, chunk: int = 1024):
    """Model-layout plain version, the copy of
    ``models/layers.py:flash_attention_jnp`` (q and KV both from
    position 0): a loop over q chunks of ``chunk`` rows, full KV per
    chunk, so no S x S matrix is formed.

    q: (B, Sq, H, D); k, v: (B, Skv, KVH, D)."""
    sq, d = q.shape[1], q.shape[3]
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    kv_pos = torch.arange(skv, device=q.device)

    def bias_for(q_pos):
        if causal:
            m = kv_pos[None, :] <= q_pos[:, None]
        else:
            m = torch.ones((len(q_pos), skv), dtype=torch.bool,
                           device=q.device)
        return torch.where(m, 0.0, MASK_VALUE)[None, None]   # (1,1,Cq,S)

    if sq <= chunk:
        return _attend_block(q, k, v,
                             bias_for(torch.arange(sq, device=q.device)),
                             scale)
    outs = []
    for i in range(-(-sq // chunk)):
        qi = q[:, i * chunk:(i + 1) * chunk]
        pos = i * chunk + torch.arange(qi.shape[1], device=q.device)
        outs.append(_attend_block(qi, k, v, bias_for(pos), scale))
    return torch.cat(outs, dim=1)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib():
    lib = build.library("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([_P] * 4 + [_I] * 6 + [_L] * 12
                       + [ctypes.c_float, _I, _I, _P])
        fn.restype = _I
    return fn


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, Sq, H, D); k, v: (B, Skv, KVH, D) with H % KVH == 0 and
    Skv >= 1; both sequences start at position 0.  ``causal`` lets query
    row i see keys j <= i; otherwise every row sees all Skv keys.
    Returns (B, Sq, H, D).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (D in {64, 128}, float32 or bfloat16) or
    raise."""
    if k.shape[1] < 1:
        raise ValueError("flash_attention: no keys (Skv = 0)")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no path for {q.device}")
    b, sq, h, d = q.shape
    _, skv, kvh, dk = k.shape
    if (dk != d or v.shape != k.shape or k.shape[0] != b or h % kvh):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k, v dtypes differ")
    for x in (q, k, v):
        if x.device != q.device or x.stride(-1) != 1:
            raise ValueError("flash_attention: q, k, v must share a "
                             "device and have unit stride on D")
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    err = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, sq, skv, h, kvh, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        1.0 / math.sqrt(d), int(causal), build.dtype_code(q),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
