"""Paged verify attention: the CUDA kernel's wrapper and its plain
versions.

``paged_verify_attention`` is the model-layout entry point of a T-token
window through the page table: the suffix prefill of a prefix-cache hit
(and, with speculative decoding, the verify window).  A CPU tensor goes
to ``paged_verify_attention_plain`` (the reference's jnp path: gather
through the page table, then ``verify_attention_plain``, the copy of
``verify_attention_jnp``, re-exported here); a CUDA tensor launches one
of the hand-written routes of ``csrc/paged_verify_attention.cu`` through
flash's ``launch``, as the contiguous verify wrapper does (the same
route rule and, for equal capacity NB * page_size = S, the same split
layout), or raises: a prefix hit's suffix (T 200 at G 2) takes the
tensor-core tile kernel, the paged speculative window (T 5) the
split-KV kernel, float32 the CUDA-core tile loop.  ``paged_verify_attention.launches`` counts
calls that launched a kernel.

Replaces ``src/repro/kernels/decode_attention/decode_attention.py:
paged_verify_attention_kernel`` (wrapper ``ops.py:
paged_verify_attention``).  The kernel tiles the window's query rows
over CTAs (or, on the split route, the keys) where the reference holds
the rows in one block, and reads the pool and q in the model's layouts
through strides.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.contracts import (Buffer, KernelContract,
                                            planned)
from repro_torch.kernels import (count_launch, geometry, plain_route,
                                 refuse_grad, work)
from repro_torch.kernels.flash_attention.ops import launch, plan
from repro_torch.kernels.paged_decode_attention.ops import (
    check_paged_args, paged_view,
)
from repro_torch.kernels.verify_attention.ops import (
    verify_attention_plain, window_cases,
)


def paged_verify_attention_plain(q, k_pool, v_pool, pages, pos):
    """q: (B, T, H, D); pools: (P, page_size, KVH, D); pages: (B, NB);
    pos: () or (B,) window starts.  Returns (B, T, H, D)."""
    return verify_attention_plain(q, paged_view(k_pool, pages),
                                  paged_view(v_pool, pages), pos)


def paged_verify_attention(q, k_pool, v_pool, pages, pos):
    """q: (B, T, H, D); pools: (P, page_size, KVH, D); pages: (B, NB)
    int; pos: () or (B,) int window starts.  Returns (B, T, H, D).
    CPU tensors take the plain version; CUDA tensors (D in {64, 96, 128},
    float32 or bfloat16, any T >= 1, every row start 16-byte aligned)
    launch the route ``_route`` names or raise.  Meta tensors take the
    plain version too.  The call's work goes to an active counter
    (``work.paged_verify``)."""
    return work.call("paged_verify_attention", _paged_verify_attention,
                     (q, k_pool, v_pool, pages, pos),
                     lambda: work.paged_verify(q, k_pool, pages, pos),
                     lambda: torch.empty_like(q))


def _paged_verify_attention(q, k_pool, v_pool, pages, pos):
    if plain_route(q):
        return paged_verify_attention_plain(q, k_pool, v_pool, pages, pos)
    refuse_grad("paged_verify_attention", q, k_pool, v_pool)
    if q.device.type != "cuda":
        raise ValueError(f"paged_verify_attention: no path for {q.device}")
    pages, pos = check_paged_args("paged_verify_attention", q, k_pool,
                                  v_pool, pages, pos)
    if q.stride(-1) != 1:
        q = q.contiguous()
    b, t, h, d = q.shape
    _, ps, kvh, _ = k_pool.shape
    nb = pages.shape[1]
    o = launch(
        "paged_verify_attention", q, kvh, nb * ps, (k_pool, v_pool),
        (k_pool.data_ptr(), v_pool.data_ptr(), pages.data_ptr(),
         pos.data_ptr()),
        (b, t, h, kvh, d, nb, ps),
        (*k_pool.stride()[:3], *v_pool.stride()[:3]))
    count_launch(paged_verify_attention)
    return o


paged_verify_attention.launches = 0


# --- launch contract (repro_torch.analysis) --------------------------------

def _paged_verify_contract(case):
    b, t, nb, ps = case["b"], case["t"], case["nb"], case["page_size"]
    h, kvh, d = case["h"], case["kvh"], case["d"]
    dt = case.get("dtype", "bfloat16")
    route, n_split, per = planned(
        plan, "paged_verify_attention", t, h, kvh, d, getattr(torch, dt),
        nb * ps, b * kvh, case.get("n_sm", geometry.N_SM))
    return geometry.window_instance(
        route, n_split, per, b, t, h, kvh, d, dt, "PagedCache",
        (case["n_pages"], ps, kvh, d),
        (Buffer("pages", (b, nb), "int32", "input"),
         Buffer("pos", (b,), "int32", "input")))


CONTRACTS = (
    KernelContract(
        name="paged_verify_attention",
        build=_paged_verify_contract,
        cases=(
            # the reference contract's cases
            {"b": 8, "t": 4, "nb": 32, "page_size": 128, "n_pages": 257,
             "h": 16, "kvh": 4, "d": 128},
            {"b": 2, "t": 8, "nb": 8, "page_size": 128, "n_pages": 17,
             "h": 8, "kvh": 2, "d": 64},
            # slo_sweep's chunk shapes: T 64 and T 8 over 13 pages of 64
            {"b": 1, "t": 64, "nb": 13, "page_size": 64, "n_pages": 27,
             "h": 16, "kvh": 8, "d": 128},
            {"b": 1, "t": 8, "nb": 13, "page_size": 64, "n_pages": 27,
             "h": 16, "kvh": 8, "d": 128},
            *window_cases({"nb": 5, "page_size": 60, "n_pages": 11},
                          {"nb": 16, "page_size": 128, "n_pages": 129}),
        ),
        dtype_groups=(("q", "k", "v", "o"), ("o_part", "ml_part")),
    ),
)
