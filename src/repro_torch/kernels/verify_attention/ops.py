"""Verify attention: the CUDA kernel's wrapper and its plain version.

``verify_attention`` is the model-layout entry point of a T-token window
against a contiguous KV cache: the target's verify step in speculative
decoding.  A CPU tensor goes to ``verify_attention_plain`` (the copy of
the reference's ``verify_attention_jnp``); a CUDA tensor launches one of
the hand-written routes of ``csrc/verify_attention.cu`` or raises --
there is no fall-back.  Flash's ``launch``, which the paged verify
and flash wrappers call too, picks the route with ``_route`` (dtype,
and the T * G window rows that share a KV head):

* bfloat16, T * G <= 16 (the speculative window, T 5 at G 2): the
  split-KV kernel and its log-sum-exp merge, the splits laid out from
  (B * KVH, S, SM count) alone, never from ``pos``;
* bfloat16, T * G > 16: the tensor-core tile kernel;
* float32: the CUDA-core tile loop.

``verify_attention.launches`` counts calls that launched a kernel (one
per call, although the split route runs two grids).

Replaces ``src/repro/kernels/decode_attention/decode_attention.py:
verify_attention_kernel`` (wrapper ``ops.py:verify_attention``).  The
kernel reads the cache in its (B, S, KVH, D) layout through strides,
where the reference wrapper transposes it to (B*KVH, S, D) and pads S
first, and it runs the paged verify kernel's code on every route with
only the address map different: on the card the two agree bit for bit
on the same values.
"""
from __future__ import annotations

import math

import torch

from repro_torch.analysis.contracts import (Buffer, KernelContract,
                                            planned)
from repro_torch.kernels import (count_launch, geometry, plain_route,
                                 refuse_grad, work)
from repro_torch.kernels.decode_attention.ops import MASK_VALUE
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS, launch, plan


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


def verify_attention(q, k_cache, v_cache, pos):
    """q: (B, T, H, D); caches: (B, S, KVH, D); pos: () or (B,) int
    window starts.  Returns (B, T, H, D).  CPU tensors take the plain
    version; CUDA tensors (D in {64, 96, 128}, float32 or bfloat16, any T >=
    1 and G = H / KVH, every row start 16-byte aligned) launch the route
    ``_route`` names -- the split-KV kernel, the tensor-core tile kernel
    or the float32 tile loop -- or raise.  Meta tensors take the plain
    version too.  The call's work goes to an active counter
    (``work.verify``)."""
    return work.call("verify_attention", _verify_attention,
                     (q, k_cache, v_cache, pos),
                     lambda: work.verify(q, k_cache, pos),
                     lambda: torch.empty_like(q))


def _verify_attention(q, k_cache, v_cache, pos):
    if plain_route(q):
        return verify_attention_plain(q, k_cache, v_cache, pos)
    refuse_grad("verify_attention", q, k_cache, v_cache)
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
    o = launch(
        "verify_attention", q, kvh, s, (k_cache, v_cache),
        (k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr()),
        (b, t, s, h, kvh, d),
        (*k_cache.stride()[:3], *v_cache.stride()[:3]))
    count_launch(verify_attention)
    return o


verify_attention.launches = 0


# --- launch contract (repro_torch.analysis) --------------------------------

def window_cases(small: dict, main: dict) -> tuple:
    """Each route at D 64/96/128 and G 1/2/4/8 on a small ragged cache
    (``small``: its size keys): bf16 T 2 (the split route), bf16 T 37
    (the tile route: T * G > 16 at every G, a ragged q-tile) and float32
    T 37 (the loop, a ragged row tile); then the main paths (``main``:
    2,048 rows): qwen3-1.7b's speculative window (T 5, G 2: split) and a
    prefix hit's suffix (T 200: tile), qwen3-moe's window (T 5, G 8:
    tile), phi-3-vision's (T 5, D 96, G 1: split)."""
    grid = tuple({"b": 2, "t": t, "h": 2 * g, "kvh": 2, "d": d,
                  "dtype": dt, **small}
                 for dt, t in (("bfloat16", 2), ("bfloat16", 37),
                               ("float32", 37))
                 for d in HEAD_DIMS for g in geometry.GROUPS)
    return grid + tuple({"b": 8, "t": t, "h": h, "kvh": kvh, "d": d,
                         **main}
                        for t, h, kvh, d in ((5, 16, 8, 128),
                                             (200, 16, 8, 128),
                                             (5, 32, 4, 128),
                                             (5, 32, 32, 96)))


def _verify_contract(case):
    b, t, s = case["b"], case["t"], case["s"]
    h, kvh, d = case["h"], case["kvh"], case["d"]
    dt = case.get("dtype", "bfloat16")
    route, n_split, per = planned(
        plan, "verify_attention", t, h, kvh, d, getattr(torch, dt), s,
        b * kvh, case.get("n_sm", geometry.N_SM))
    return geometry.window_instance(
        route, n_split, per, b, t, h, kvh, d, dt, "ContiguousCache",
        (b, s, kvh, d), (Buffer("pos", (b,), "int32", "input"),))


CONTRACTS = (
    KernelContract(
        name="verify_attention",
        build=_verify_contract,
        cases=(
            # the reference contract's cases (its block_k is Pallas's)
            {"b": 8, "t": 4, "s": 4096, "h": 16, "kvh": 4, "d": 128},
            {"b": 2, "t": 8, "s": 512, "h": 8, "kvh": 2, "d": 64,
             "block_k": 128},
            *window_cases({"s": 300}, {"s": 2048}),
        ),
        dtype_groups=(("q", "k", "v", "o"), ("o_part", "ml_part")),
    ),
)
