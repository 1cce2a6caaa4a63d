"""Decode attention: the CUDA kernels' wrapper and its plain versions.

``decode_attention`` is the model-layout entry point.  A CPU tensor
goes to ``decode_attention_plain`` (the copy of the reference's
``decode_attention_jnp``); a CUDA tensor launches one of the
hand-written routes of ``csrc/decode_attention.cu`` or raises -- there
is no fall-back.  ``plan`` picks the route by dtype:

* bfloat16: the split-KV kernel (``csrc/decode_split.cuh``) and its
  log-sum-exp merge (``csrc/split_merge.cuh``), a grid of (slot x KV
  head, split) CTAs whose layout is flash's ``_splits`` over (B * KVH,
  S, SM count), never over ``pos``; its plain version is flash's
  ``flash_attention_split_plain`` at Sq = 1 with ``offsets=pos``;
* float32: the CUDA-core loop (``csrc/decode_body.cuh``), one CTA per
  (slot, KV head).

``decode_attention.launches`` counts calls that launched a kernel (one
per call, although the split route runs two grids).

Replaces ``src/repro/kernels/decode_attention/decode_attention.py:
decode_attention_kernel`` (wrapper ``ops.py:decode_attention``).  The
kernels read K/V in the cache's own (B, S, KVH, D) layout through
strides, where the reference wrapper transposes the cache to
(B*KVH, S, D) first; see the sources for their bound and design.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, count_launch
from repro_torch.kernels.flash_attention.ops import (
    _check_aligned, _sm_count, _splits,
)

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
GROUPS = (1, 2, 4, 8)       # G = H / KVH the kernels are built for


@functools.lru_cache(maxsize=None)
def plan(name: str, h: int, kvh: int, d: int, dtype, capacity: int,
         n_sets: int, n_sm: int) -> tuple[str, int, int]:
    """(route, split count, keys per split) of a call of ``name``
    (either decode kernel): ``"split"`` for bfloat16, with the layout
    flash's ``_splits`` gives for ``n_sets`` = B * KVH over ``capacity``
    keys (S, or a pool's NB * page_size) on ``n_sm`` SMs; ``"loop"``
    (0, 0) for float32.  Shapes only: two calls with equal shapes take
    the same route and split identically, whatever their positions.
    Raises on what no kernel takes."""
    if d not in (64, 128):
        raise ValueError(f"{name}: D = {d} not in (64, 128)")
    if h % kvh or h // kvh not in GROUPS:
        raise ValueError(f"{name}: G = H / KVH = {h} / {kvh} not in "
                         f"{GROUPS}")
    if dtype == torch.float32:
        return "loop", 0, 0
    if dtype != torch.bfloat16:
        raise TypeError(f"{name} takes float32 or bfloat16, got {dtype}")
    return ("split", *_splits(n_sets, capacity, n_sm))


def scratch(n_rows: int, d: int, device) -> tuple[torch.Tensor, int, int]:
    """One float32 buffer for the split route's partials of ``n_rows``
    (set, split, head) rows: o_part (n_rows, D), then ml_part (n_rows,
    2).  Returns it (keep it until the launch is queued) and the two
    pointers."""
    buf = torch.empty(n_rows * (d + 2), dtype=torch.float32, device=device)
    return buf, buf.data_ptr(), buf.data_ptr() + n_rows * d * 4


def _entry(name: str, split: bool, n_ptr: int, n_int: int, n_after: int):
    """The C entry point ``<name>_launch`` (``<name>_split_launch`` for
    the split route) with its argument types: ``n_ptr`` tensors ending
    in o (then o_part and ml_part), ``n_int`` sizes, 6 K/V strides,
    ``n_after`` ints (the contiguous kernel's pos stride), the split
    count and keys per split, scale, dtype, stream."""
    fn = getattr(build.library(name),
                 f"{name}_split_launch" if split else f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = ([_P] * (n_ptr + 2 * split) + [_I] * n_int
                       + [_L] * 6 + [_I] * (n_after + 2 * split)
                       + [ctypes.c_float, _I, _P])
        fn.restype = _I
    return fn


def launch(name: str, q, kvh: int, capacity: int, kv, ptrs, sizes,
           after=()):
    """Launch decode kernel ``name`` (``decode_attention`` or
    ``paged_decode_attention``) on q (B, 1, H, D) and return o: the
    route and split layout of ``plan`` over ``capacity`` keys, on the
    split route the 16-byte row alignment of q and the K/V tensors
    ``kv`` checked and float32 scratch allocated.  ``ptrs``: the
    pointers between q and o in the C signature (``pos`` among them:
    never read here); ``sizes``: its ints and six K/V strides;
    ``after``: its ints after them.  Raises where no route takes the
    call or a launch fails."""
    b, _, h, d = q.shape
    route, n_split, per = plan(name, h, kvh, d, q.dtype, capacity, b * kvh,
                               _sm_count(q.device.index))
    split = route == "split"
    q = q.contiguous()
    if split:
        _check_aligned(q, *kv, name=name)
    o = torch.empty_like(q)
    head = [q.data_ptr(), *ptrs, o.data_ptr()]
    fn = _entry(name, split, len(head), len(sizes) - 6, len(after))
    if split:
        buf, o_part, ml_part = scratch(b * n_split * h, d, q.device)
        head += [o_part, ml_part]
        after = (*after, n_split, per)
    err = fn(*head, *sizes, *after, 1.0 / math.sqrt(d), build.dtype_code(q),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, name)
    return o


def decode_attention(q, k_cache, v_cache, pos):
    """q: (B, 1, H, D); caches: (B, S, KVH, D); pos: () or (B,) int.
    Returns (B, 1, H, D).  CPU tensors take the plain version; CUDA
    tensors (G in {1, 2, 4, 8}, D in {64, 128}, float32 or bfloat16;
    in bfloat16 every row start 16-byte aligned) launch the route
    ``plan`` names or raise."""
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
    o = launch("decode_attention", q, kvh, s, (k_cache, v_cache),
               (k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr()),
               (b, s, kvh, h // kvh, d, *k_cache.stride()[:3],
                *v_cache.stride()[:3]),
               after=(pos.stride(0) if pos.ndim else 0,))
    count_launch(decode_attention)
    return o


decode_attention.launches = 0
