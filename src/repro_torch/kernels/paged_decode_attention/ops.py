"""Paged decode attention: the CUDA kernels' wrapper and its plain
version.

``paged_decode_attention`` is the model-layout entry point of the paged
engine's decode step.  A CPU tensor goes to
``paged_decode_attention_plain`` (the reference's jnp path: gather the
slot-contiguous view through the page table, then
``decode_attention_jnp``); a CUDA tensor launches one of the
hand-written routes of ``csrc/paged_decode_attention.cu`` or raises --
there is no fall-back.  The route and split layout are decode's
``plan`` over the pool's capacity NB * page_size: bfloat16 the split-KV
kernel and its merge, float32 the CUDA-core loop.
``paged_decode_attention.launches`` counts calls that launched a kernel
(one per call on either route).

Replaces ``src/repro/kernels/decode_attention/decode_attention.py:
paged_decode_attention_kernel`` (wrapper ``ops.py:
paged_decode_attention``).  The kernels read the pool in the model's
(P, page_size, KVH, D) layout through strides, where the reference
wrapper transposes the whole pool to (KVH, P, page_size, D) first, and
they share their bodies with ``decode_attention``: on the card the two
agree bit for bit on the same values and equal capacity.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import count_launch
from repro_torch.kernels.decode_attention.ops import (
    decode_attention_plain, launch,
)


def paged_view(pool, pages):
    """Gather a slot-contiguous view of a paged KV pool (the copy of
    ``models/layers.py:paged_view``).

    pool: (P, page_size, KVH, D) physical pages; pages: (B, NB) int
    page table.  Returns (B, NB * page_size, KVH, D): logical row ``j``
    of slot ``b`` is ``pool[pages[b, j // ps], j % ps]``, so for any
    permutation of physical pages the view equals the contiguous cache
    at every position the attention reads."""
    b, nb = pages.shape
    g = pool[pages.long()]                     # (B, NB, ps, KVH, D)
    return g.reshape(b, nb * pool.shape[1], *pool.shape[2:])


def paged_decode_attention_plain(q, k_pool, v_pool, pages, pos):
    """q: (B, 1, H, D); pools: (P, page_size, KVH, D); pages: (B, NB);
    pos: () or (B,).  Returns (B, 1, H, D)."""
    return decode_attention_plain(q, paged_view(k_pool, pages),
                                  paged_view(v_pool, pages), pos)


def check_paged_args(name, q, k_pool, v_pool, pages, pos):
    """Validate a paged kernel call and return (pages, pos) as
    contiguous int32 tensors on q's device, ``pos`` broadcast to (B,)."""
    b, _, h, d = q.shape
    _, ps, kvh, dk = k_pool.shape
    if (dk != d or v_pool.shape != k_pool.shape or h % kvh
            or pages.ndim != 2 or pages.shape[0] != b):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k_pool.shape)}, v {tuple(v_pool.shape)}, "
                         f"pages {tuple(pages.shape)}")
    if not (q.dtype == k_pool.dtype == v_pool.dtype):
        raise TypeError(f"{name}: q, k, v dtypes differ")
    for x in (k_pool, v_pool, pages):
        if x.device != q.device:
            raise ValueError(f"{name}: pools and pages must be on "
                             f"q's device")
    if k_pool.stride(-1) != 1 or v_pool.stride(-1) != 1:
        raise ValueError(f"{name}: pools need unit stride on D")
    pos = torch.as_tensor(pos, device=q.device)
    if pos.ndim not in (0, 1) or (pos.ndim == 1 and pos.shape[0] != b):
        raise ValueError(f"{name}: pos shape {tuple(pos.shape)}")
    pos = pos.to(torch.int32).expand(b).contiguous()
    return pages.to(torch.int32).contiguous(), pos


def paged_decode_attention(q, k_pool, v_pool, pages, pos):
    """q: (B, 1, H, D); pools: (P, page_size, KVH, D); pages: (B, NB)
    int; pos: () or (B,) int.  Returns (B, 1, H, D).  CPU tensors take
    the plain version; CUDA tensors (G in {1, 2, 4, 8}, D in {64, 128},
    float32 or bfloat16; in bfloat16 every row start 16-byte aligned)
    launch the route ``plan`` names or raise."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, pages, pos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no path for {q.device}")
    if q.shape[1] != 1:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} is "
                         f"not one token")
    pages, pos = check_paged_args("paged_decode_attention", q, k_pool,
                                  v_pool, pages, pos)
    b, _, h, d = q.shape
    _, ps, kvh, _ = k_pool.shape
    nb = pages.shape[1]
    o = launch("paged_decode_attention", q, kvh, nb * ps, (k_pool, v_pool),
               (k_pool.data_ptr(), v_pool.data_ptr(), pages.data_ptr(),
                pos.data_ptr()),
               (b, kvh, h // kvh, d, nb, ps, *k_pool.stride()[:3],
                *v_pool.stride()[:3]))
    count_launch(paged_decode_attention)
    return o


paged_decode_attention.launches = 0
